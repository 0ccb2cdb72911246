"""The port's DSL front end against the JAX package, in this process:
graph capture (``tests/test_graph_item.py``), every optimizer
(``tests/test_optimizers.py``; one case per optimizer: the same
regression trained by both packages), the device resolver
(``tests/test_device_resolver.py``), lifted ops, and the features of the
JAX package this slice leaves out, which must raise naming their
ROADMAP.md item. Tolerance: 1e-5 on f32 values unless a case says
otherwise.
"""
import numpy as np
import pytest
import torch

import autodist_tpu as jad
import autodist_tpu_torch as ad
import torch_dsl_cases as cases
from autodist_tpu_torch.frontend import graph as fe
from autodist_tpu_torch.frontend import optimizers as opts
from autodist_tpu_torch.graph_item import GraphItem
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.runtime.device_resolver import DeviceResolver

OPTIMIZER_CASES = [
    ('SGD', {'learning_rate': 0.1}),
    ('SGD', {'learning_rate': 0.1, 'momentum': 0.9}),
    ('SGD', {'learning_rate': 0.1, 'momentum': 0.9, 'nesterov': True}),
    ('Momentum', {'learning_rate': 0.1}),
    ('Adam', {'learning_rate': 0.05}),
    ('Adam', {'learning_rate': 0.05, 'beta_1': 0.8}),
    ('AdamW', {'learning_rate': 0.05, 'weight_decay': 0.01}),
    ('LazyAdam', {'learning_rate': 0.05}),
    ('LazyMomentum', {'learning_rate': 0.05}),
    ('Adagrad', {'learning_rate': 0.1}),
    ('RMSProp', {'learning_rate': 0.01}),
    ('RMSProp', {'learning_rate': 0.01, 'momentum': 0.9}),
    ('Adadelta', {'learning_rate': 1.0}),
    ('Adamax', {'learning_rate': 0.02}),
    ('LAMB', {'learning_rate': 0.01}),
    ('LAMB', {'learning_rate': 0.01, 'weight_decay': 0.01}),
    ('Nadam', {'learning_rate': 0.05}),
    ('Ftrl', {'learning_rate': 0.5}),
    ('Ftrl', {'learning_rate': 0.5, 'l1_regularization_strength': 0.01}),
]
IDS = ['%s-%d' % (n, i) for i, (n, _) in enumerate(OPTIMIZER_CASES)]


def _spec(n=1):
    return {'nodes': [{'address': 'localhost', 'gpus': list(range(n)),
                       'chief': True, 'network_bandwidth': 100}]}


def _jax(builder=None):
    from autodist_tpu import autodist as jad_mod
    jad_mod._DEFAULT_AUTODIST.clear()
    return jad.AutoDist(resource_info=_spec(),
                        strategy_builder=builder or jad.AllReduce())


def _train(pkg, autodist, opt_name, kwargs, steps=6):
    """A regression with an embedding table (so the lazy optimizers
    take their row-lazy path): losses and variables after ``steps``."""
    rng = np.random.RandomState(0)
    xs = rng.randn(32, 4).astype(np.float32)
    ids = rng.randint(0, 10, (32,)).astype(np.int32)
    ys = (xs @ np.array([1.0, -2.0, 3.0, 0.5], np.float32) +
          0.1 * ids).astype(np.float32)
    with autodist.scope():
        W = pkg.Variable(rng.randn(4).astype(np.float32) * 0.1, name='W')
        E = pkg.Variable(rng.randn(16, 2).astype(np.float32) * 0.1,
                         name='E')
        x = pkg.placeholder(shape=[None, 4], dtype=np.float32, name='x')
        i = pkg.placeholder(shape=[None], dtype=np.int32, name='i')
        y = pkg.placeholder(shape=[None], dtype=np.float32, name='y')
        pred = pkg.ops.squeeze(pkg.ops.matmul(
            x, pkg.ops.reshape(W, (4, 1))), axis=1) + pkg.ops.reduce_sum(
                pkg.ops.embedding_lookup(E, i), axis=1)
        loss = pkg.ops.reduce_mean(pkg.ops.square(pred - y))
        train_op = getattr(pkg.optimizers, opt_name)(**kwargs).minimize(loss)
        sess = autodist.create_distributed_session()
        losses = [float(sess.run([loss, train_op], {x: xs, i: ids, y: ys})[0])
                  for _ in range(steps)]
        return losses, [np.asarray(v) for v in sess.run([W, E])]


@pytest.mark.parametrize('opt_name,kwargs', OPTIMIZER_CASES, ids=IDS)
def test_optimizer_matches_jax(opt_name, kwargs):
    want = _train(jad, _jax(), opt_name, kwargs)
    got = _train(ad, cases.fresh(ad.AllReduce()), opt_name, kwargs)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
    assert got[0][-1] < got[0][0]


def test_ftrl_first_step_matches_hand_math():
    with fe.Graph():
        opt = opts.Ftrl(0.1, initial_accumulator_value=0.1)
    w = torch.zeros(2)
    g = torch.tensor([1.0, -2.0])
    update, _ = opt.update(g, opt.init_leaf(w), w)
    expected = -g.numpy() * 0.1 / np.sqrt(0.1 + g.numpy() ** 2)
    np.testing.assert_allclose((w + update).numpy(), expected, rtol=1e-6)


def test_ftrl_l1_zeroes_small_weights():
    with fe.Graph():
        opt = opts.Ftrl(0.1, l1_regularization_strength=10.0)
    w = torch.tensor([0.5])
    update, _ = opt.update(torch.tensor([0.01]), opt.init_leaf(w), w)
    assert float((w + update)[0]) == 0.0


# -- capture -------------------------------------------------------------------
@pytest.mark.parametrize('opt_name,kwargs', OPTIMIZER_CASES, ids=IDS)
def test_optimizer_capture_matches_jax(opt_name, kwargs):
    """Every optimizer records its grad -> target pair and its
    constructor spec, the same metadata as the JAX package's."""
    from autodist_tpu.frontend import graph as jfe
    from autodist_tpu.graph_item import GraphItem as JGraphItem
    meta = {}
    for pkg, fe_mod, gi_cls in ((jad, jfe, JGraphItem),
                                (ad, fe, GraphItem)):
        gi = gi_cls(graph=fe_mod.Graph())
        with gi.graph:
            w = pkg.Variable(np.ones((4,), np.float32), name='w')
            x = pkg.placeholder(shape=[None, 4], name='x')
            loss = pkg.ops.reduce_mean(pkg.ops.square(x @ w.read()))
            train_op = getattr(pkg.optimizers, opt_name)(
                **kwargs).minimize(loss)
        gi.prepare()
        assert len(gi.grad_target_pairs) == 1
        (_, target), = gi.grad_target_pairs.items()
        assert target is w
        assert isinstance(train_op, fe_mod.ApplyGradients)
        meta[pkg] = gi.to_dict()
    for m in meta.values():
        m.pop('grad_target_pairs')   # node names carry a node counter
    assert meta[ad] == meta[jad]


def test_default_graph_scoping():
    g1, g2 = fe.Graph(), fe.Graph()
    with g1:
        ad.Variable(1.0, name='a')
        with g2:
            ad.Variable(2.0, name='b')
        ad.Variable(3.0, name='c')
    assert set(g1.variables) == {'a', 'c'}
    assert set(g2.variables) == {'b'}


def test_duplicate_variable_name_rejected():
    with fe.Graph():
        ad.Variable(1.0, name='v')
        with pytest.raises(ValueError):
            ad.Variable(2.0, name='v')


def test_metadata_roundtrip_and_sparse_detection():
    gi = GraphItem(graph=fe.Graph())
    with gi.graph:
        w = ad.Variable(np.zeros((3, 2), np.float32), name='w')
        e = ad.Variable(np.zeros((5, 2), np.float32), name='emb')
        d = ad.Variable(np.zeros((5, 2), np.float32), name='dense')
        idx = ad.placeholder(shape=[None], dtype=np.int32)
        loss = ad.ops.reduce_mean(
            ad.ops.embedding_lookup(e, idx) @ w.read().T)
        opts.SGD(0.1).minimize(loss, [w, e])
    gi.prepare()
    meta = GraphItem.metadata_from_serialized(gi.serialize())
    names = {v['name']: v for v in meta['variables']}
    assert names['emb']['sparse_read'] is True
    assert names['w']['sparse_read'] is False
    assert names['w']['shape'] == [3, 2]
    assert meta['optimizers'][0]['class'] == 'SGD'
    assert gi.is_sparse('emb') and not gi.is_sparse('dense')


# -- ops -----------------------------------------------------------------------
def test_avg_pool_same_excludes_padding():
    x = np.arange(9, dtype=np.float32).reshape(1, 3, 3, 1)
    with fe.Graph():
        node = ad.ops.avg_pool(ad.ops.constant(x), size=2, strides=2,
                               padding='SAME')
        got = fe.evaluate(node, fe.Env({}, {})).numpy()
    want = np.array([[[2.0], [3.5]], [[6.5], [8.0]]], np.float32)[None]
    np.testing.assert_allclose(got, want)


def test_ops_match_jax():
    """Each exported op on the same inputs in both packages."""
    from autodist_tpu.frontend import graph as jfe
    rng = np.random.RandomState(1)
    a = rng.randn(2, 5, 6, 3).astype(np.float32)
    f = rng.randn(3, 3, 3, 4).astype(np.float32)
    m = rng.randn(4, 6).astype(np.float32)
    lab = rng.randint(0, 6, (4,)).astype(np.int32)
    probs = np.abs(m) / np.abs(m).sum(-1, keepdims=True)

    def program(pkg):
        o = pkg.ops
        c = o.constant
        return [
            o.conv2d(c(a), c(f), strides=2), o.conv2d(c(a), c(f),
                                                      padding='VALID'),
            o.max_pool(c(a), 2, padding='SAME'), o.avg_pool(c(a), 3, 2),
            o.softmax(c(m)), o.relu(c(m)), o.sigmoid(c(m)), o.tanh(c(m)),
            o.abs(c(m)), o.exp(c(m)), o.log(o.abs(c(m))),
            o.sqrt(o.abs(c(m))), o.square(c(m)), o.reduce_max(c(m), 1),
            o.reduce_sum(c(m), 0), o.reduce_mean(c(lab)), o.argmax(c(m)),
            o.transpose(c(a), (0, 3, 1, 2)), o.transpose(c(m)),
            o.concat([c(m), c(m)], 1), o.stack([c(m), c(m)]),
            o.one_hot(c(lab), 6), o.squeeze(o.expand_dims(c(m), 0)),
            o.cast(c(m), np.int32), c(m)[1:3, ::2], c(m).T, -c(m) ** 2,
            o.gather(c(m), c(lab[:2]), axis=1),
            o.sigmoid_cross_entropy_with_logits(c(probs), c(m)),
            o.sparse_softmax_cross_entropy_with_logits(c(lab), c(m)),
            o.softmax_cross_entropy_with_logits(c(probs), c(m)),
            o.cond(c(True), lambda v: v * 2, lambda v: v, [c(m)]),
        ]

    with jfe.Graph():
        want = [np.asarray(jfe.evaluate(n, jfe.Env({}, {})))
                for n in program(jad)]
    with fe.Graph():
        got = [fe.evaluate(n, fe.Env({}, {})) for n in program(ad)]
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.numpy() if torch.is_tensor(g) else np.asarray(g)
        assert g.shape == w.shape, (i, g.shape, w.shape)
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5,
                                   err_msg='op %d' % i)


# -- device resolution -----------------------------------------------------------
def two_node_spec():
    return ResourceSpec(resource_info={'nodes': [
        {'address': '10.20.41.0', 'gpus': [0, 1], 'chief': True},
        {'address': '10.20.41.1', 'gpus': [0, 1]},
    ]})


def test_chief_first_task_numbering():
    spec = ResourceSpec(resource_info={'nodes': [
        {'address': '10.20.41.0', 'gpus': [0]},
        {'address': '10.20.41.1', 'gpus': [0], 'chief': True},
    ]})
    r = DeviceResolver(spec, world_size=2, device_type='cpu')
    assert r('10.20.41.1:GPU:0') == '/job:worker/task:0/device:GPU:0'
    assert r('10.20.41.0:GPU:0') == '/job:worker/task:1/device:GPU:0'
    assert r.resolve('10.20.41.0:GPU:0').rank == 1


def test_canonical_strings_match_jax():
    from autodist_tpu.resource_spec import ResourceSpec as JSpec
    from autodist_tpu.runtime.device_resolver import DeviceResolver as JRes
    info = {'nodes': [{'address': '10.20.41.0', 'gpus': [0, 1],
                       'chief': True},
                      {'address': '10.20.41.1', 'gpus': [0, 1]}]}
    r = DeviceResolver(ResourceSpec(resource_info=info), 4, 'cpu')
    jr = JRes(JSpec(resource_info=info))
    for s in ('10.20.41.0:GPU:1', '10.20.41.1:CPU:0', '10.9.9.9:GPU:0',
              '10.20.41.1:GPU:1', '/job:worker/task:1/device:GPU:0'):
        assert r(s) == jr(s), s
    canon = r('10.20.41.0:GPU:1')
    assert r.resolve(canon).canonical == canon


def test_ranks_follow_nodes_chief_first():
    """One process per device: a node's ranks follow its device list,
    nodes chief first; a rank the run does not have resolves to None."""
    r = DeviceResolver(two_node_spec(), world_size=4, device_type='cpu')
    assert [r.resolve(s).rank for s in (
        '10.20.41.0:GPU:0', '10.20.41.0:GPU:1', '10.20.41.1:GPU:0',
        '10.20.41.1:GPU:1')] == [0, 1, 2, 3]
    assert r.ranks_per_node() == [2, 2]
    small = DeviceResolver(two_node_spec(), world_size=2, device_type='cpu')
    assert small.resolve('10.20.41.1:GPU:0').rank is None
    spec8 = DeviceResolver(ResourceSpec(resource_info=_spec(8)), 8, 'cpu')
    assert [spec8.resolve('localhost:GPU:%d' % i).rank
            for i in (6, 4, 2, 0)] == [6, 4, 2, 0]


def test_compiler_resolves_strategy_devices():
    from autodist_tpu_torch.strategy.base import (PSSynchronizer, Strategy,
                                                  StrategyCompiler,
                                                  StrategyNode)
    s = Strategy()
    s.graph_config.replicas = ['10.20.41.0:GPU:0', '10.20.41.1:GPU:0']
    s.node_config.append(StrategyNode(
        var_name='w', synchronizer=PSSynchronizer(
            reduction_destination='10.20.41.0:CPU:0')))

    class GI:
        trainable_var_op_to_var = {'w': None}

    compiled = StrategyCompiler(GI()).set_device_resolver(
        DeviceResolver(two_node_spec(), 4, 'cpu')).compile(s)
    assert compiled.graph_config.replicas == [
        '/job:worker/task:0/device:GPU:0',
        '/job:worker/task:1/device:GPU:0']
    assert compiled.node_config[0].synchronizer.reduction_destination == \
        '/job:worker/task:0/device:CPU:0'


# -- the entry points and what this slice leaves out --------------------------------
def test_autodist_defaults_to_the_card():
    from autodist_tpu_torch import autodist as ad_mod
    ad_mod._DEFAULT_AUTODIST.clear()
    if torch.cuda.is_available():
        assert ad.AutoDist(resource_info=_spec())._device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            ad.AutoDist(resource_info=_spec())
    ad_mod._DEFAULT_AUTODIST.clear()


def test_ssh_coordinator_launch_raises_naming_its_queue_item():
    autodist = cases.fresh(ad.AllReduce())
    autodist._resource_spec = two_node_spec()
    autodist._cluster._resource_spec = autodist._resource_spec
    autodist._ext_launched = False
    with autodist.scope():
        ad.Variable(1.0, name='v')
        with pytest.raises(NotImplementedError,
                           match='ROADMAP.md Queue 1: Loose-mode PS plane'):
            autodist.create_distributed_session()


def test_saver_and_autostrategy_raise_naming_their_queue_items():
    """Saver is ported (tests/test_torch_checkpoint.py): it builds and
    registers itself on the default graph, as the JAX Saver does. So is
    AutoStrategy (tests/test_torch_simulator.py): it builds, and builds a
    strategy priced by the simulator."""
    from autodist_tpu_torch.checkpoint.saver import Saver
    from autodist_tpu_torch.frontend import graph as fe
    from autodist_tpu_torch.strategy import AutoStrategy
    saver = Saver()
    graph = fe.get_default_graph()
    assert saver in graph.savers
    graph.savers.remove(saver)
    builder = AutoStrategy()
    assert builder.last_ranked == [] and builder.last_infeasible == []
    loss, W, b = cases.cs.run_linear_regression(cases.fresh(builder))
    assert abs(b - cases.cs.EXPECTED_B) <= 1e-5
    assert builder.last_ranked and \
        builder.last_ranked[0].strategy.cost['rank'] == 0


def test_relaxed_consistency_on_one_process_is_lock_step():
    """One process: a staleness-bounded PS strategy runs lock-step, a
    valid schedule of the bound, as in the JAX package's one program."""
    loss, W, b = cases.cs.run_linear_regression(
        cases.fresh(ad.PS(staleness=2)))
    assert abs(b - cases.cs.EXPECTED_B) <= 1e-5


def test_run_options_trace_writes_a_chrome_trace(tmp_path):
    from autodist_tpu_torch.runtime.session import RunOptions
    autodist = cases.fresh(ad.AllReduce())
    with autodist.scope():
        W = ad.Variable(1.0, name='W')
        train_op = ad.optimizers.SGD(0.1).minimize(ad.ops.square(W.read()))
        sess = autodist.create_distributed_session()
        sess.run(train_op, options=RunOptions(RunOptions.FULL_TRACE,
                                              str(tmp_path)))
    assert sess.step_count == 1 and len(sess.step_wall_series) == 1
    assert [p.name for p in tmp_path.iterdir()] == ['step_0_rank_0.json']
    assert abs(float(sess.get_variable_value(W)) - 0.8) < 1e-6
