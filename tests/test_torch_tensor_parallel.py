"""Tensor and expert parallelism of the port against the JAX package, on
the CPU.

Every port case runs in one gloo group of 4 processes
(``torch_dsl_worlds.run_group``), the port's programs in the jax-free
``tests/torch_tp_cases.py`` and ``torch_trainer_cases.train``; the JAX
``Trainer`` runs at the same ``ParallelSpec`` on the CPU devices
``tests/conftest.py`` sets up.

- Function level, over a group of 4: ``mesh.copy_to`` (identity forward,
  its backward the sum of the ranks' cotangents) and
  ``mesh.reduce_from`` (the sum forward, the cotangent passed back
  unchanged), exactly; ``core.sharded_embedding_lookup`` and
  ``transformer.vocab_parallel_nll`` against ``F.embedding`` and
  ``logsumexp - gold`` on the whole [24, 8] table and [2, 6, 24] logits,
  values and gradients within 1e-6.
- Trainer level: ``TransformerConfig.tiny`` in f32 from the JAX init,
  3 steps on batch 4 x 32 with the uneven mask, against the JAX
  ``Trainer`` at the same spec: tp 2 (dp 2) and tp 4 under sgd(0.1) and
  adam(1e-2); tp 2 x sp 2 under ring and under Ulysses; tp 2 with
  zero 3 at dp 2, and with grad_accum 2 and remat='full'; ``evaluate``
  after the tp 2 sgd steps; the untied head and ``loss_chunk=16`` at
  tp 2; the MoE
  model (4 experts, aux weight 1.0) at ep 2 (dp 2), ep 2 x tp 2 and
  ep 4; and ``dcn_dp=2`` at dp 4. Losses within 1e-5 relative; params
  within 2e-6 under sgd(0.1), an update linear in the gradient, so this
  holds every gradient, the router's under ep too; within 1e-3 under
  adam(1e-2) (``tests/test_torch_seq_parallel.py`` states why).
- Layout: the rank grid orders its ranks as the JAX mesh orders its
  devices, and each group holds the ranks that share the other
  coordinates; ``live_mesh_axis`` binds as the JAX one. ``init(params=JAX
  tree)`` then ``get_params`` is the input bit for bit at tp 2 and tp 4,
  and each rank's qkv kernel is its heads' block of the ``[dim, 3, h,
  d]`` view.
- Checkpoints: a port ``save_state`` at tp 2, dp 2 (after 2 adam(1e-3)
  steps) is restored by the JAX trainer at dp 1 and by the port at tp 1:
  the restored leaves are the saved bits, and the next step agrees with
  the port's (losses 1e-5 relative, params 1e-4, a tenth of the lr).
- Refusals: a vocab that tp does not divide raises ``ValueError`` in
  both packages (the JAX ``Trainer`` at its ``init``); ``dcn_dp`` that
  does not divide dp raises the JAX text.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torch_grid_cases as grid
import torch_tp_cases as tp_cases
import torch_trainer_cases as cases
from autodist_tpu.api import Trainer as JTrainer
from autodist_tpu.checkpoint.saver import CheckpointManager as JManager
from autodist_tpu.checkpoint.saver import _leaf_paths as j_leaf_paths
from autodist_tpu.models.transformer import TransformerConfig as JConfig
from autodist_tpu.models.transformer import TransformerLM as JLM
from autodist_tpu.parallel.axes import ParallelSpec as JSpec
from torch_dsl_worlds import run_group

LOSS = dict(rtol=1e-5, atol=0)
PARAMS = {'sgd': dict(atol=2e-6, rtol=0), 'adam': dict(atol=1e-3, rtol=0),
          'ckpt': dict(atol=1e-4, rtol=0)}
OPTS = {'sgd': ('sgd', 0.1), 'adam': ('adam', 1e-2),
        'ckpt': ('adam', 1e-3)}
FN_TOL = 1e-6

# key -> (model kind, spec, optimizer)
TRAINER_CASES = {
    'tp2_%s' % opt: ('lm', dict(tp=2, dp=2), opt) for opt in OPTS
    if opt != 'ckpt'}
TRAINER_CASES.update({
    'tp4_%s' % opt: ('lm', dict(tp=4, dp=1), opt) for opt in OPTS
    if opt != 'ckpt'})
TRAINER_CASES.update({
    'tp2_sp2_ring_sgd': ('lm', dict(tp=2, sp=2, dp=1), 'sgd'),
    'tp2_sp2_ulysses_sgd': ('lm', dict(tp=2, sp=2, dp=1,
                                       sp_mode='ulysses'), 'sgd'),
    'tp2_zero3_dp2_sgd': ('lm', dict(tp=2, dp=2, zero=3), 'sgd'),
    'tp2_accum_remat_sgd': ('lm', dict(tp=2, dp=2, grad_accum=2,
                                       remat='full'), 'sgd'),
    'tp2_untied_sgd': ('lm_untied', dict(tp=2, dp=2), 'sgd'),
    'tp2_loss_chunk_sgd': ('lm_chunk', dict(tp=2, dp=2), 'sgd'),
    'moe_ep2_sgd': ('moe', dict(ep=2, dp=2), 'sgd'),
    'moe_ep2_tp2_sgd': ('moe', dict(ep=2, tp=2, dp=1), 'sgd'),
    'moe_ep4_sgd': ('moe', dict(ep=4, dp=1), 'sgd'),
    'dcn_dp2_dp4_sgd': ('lm', dict(dp=4, dcn_dp=2), 'sgd'),
})
ROUND_TRIPS = {'tp2': dict(tp=2, dp=2), 'tp4': dict(tp=4, dp=1)}
EVAL_CASE = 'tp2_sgd'    # also runs ``evaluate`` after its steps
# (dp, sp, ep, tp) grids of 4 ranks whose layout is checked
GRIDS = [(1, 1, 2, 2), (2, 1, 1, 2), (1, 2, 1, 2), (2, 2, 1, 1)]


def _init(kind):
    return jax.tree.map(np.asarray, JLM(JConfig.tiny(
        dtype=jnp.float32, **cases.lm_config(kind))).init(
            jax.random.PRNGKey(0)))


def _jax_trainer(kind, spec, opt):
    jm = JLM(JConfig.tiny(dtype=jnp.float32, **cases.lm_config(kind)))
    name, lr = OPTS[opt]
    return JTrainer(jm, getattr(optax, name)(lr), spec=JSpec(**spec))


def _jax_steps(jtr, init, batches):
    state = jtr.init(jax.random.PRNGKey(0), params=init)
    losses = []
    for b in batches:
        state, m = jtr.step(state, b)
        losses.append(float(m['loss']))
    return state, losses


def _jax_leaves(state):
    flat, _ = j_leaf_paths(state)
    return {n: np.asarray(v) for n, v in flat}


@pytest.fixture(scope='module')
def world4(tmp_path_factory):
    """Every port case in one gloo group of 4, beside the JAX values."""
    kinds = {kind for kind, _, _ in TRAINER_CASES.values()}
    inits = {kind: _init(kind) for kind in kinds}
    batches = [cases.lm_batch(mask='uneven')] * 3
    runs = [('operators', 'torch_tp_cases:operators', {}),
            ('lookup_nll', 'torch_tp_cases:lookup_and_nll', {}),
            ('vocab250', 'torch_tp_cases:indivisible_vocab', {})]
    runs += [('grid_%d%d%d%d' % g, 'torch_tp_cases:grid_layout',
              dict(zip(('dp', 'sp', 'ep', 'tp'), g))) for g in GRIDS]
    runs.append(('grid_dcn', 'torch_tp_cases:grid_layout',
                 dict(dp=4, sp=1, ep=1, tp=1, dcn_dp=2)))
    want = {}
    for key, (kind, spec, opt) in TRAINER_CASES.items():
        evals = [cases.lm_batch(seed=7, mask='uneven')] \
            if key == EVAL_CASE else None
        runs.append((key, 'torch_trainer_cases:train', dict(
            kind=kind, init=inits[kind], batches=batches, opt=OPTS[opt],
            spec=spec, eval_batches=evals)))
        jtr = _jax_trainer(kind, spec, opt)
        state, losses = _jax_steps(jtr, inits[kind], batches)
        want[key] = (losses, cases.flat(jtr.get_params(state)))
        if evals:
            want['eval'] = jtr.evaluate(state, evals)
    for key, spec in ROUND_TRIPS.items():
        runs.append(('trip_' + key, 'torch_tp_cases:round_trip', dict(
            init=inits['lm'], spec=spec)))
    # a port checkpoint at tp 2, dp 2, restored by JAX at dp 1 and by the
    # port at tp 1
    ckpt = [cases.lm_batch(seed=i) for i in range(3)]
    port_dir = str(tmp_path_factory.mktemp('port_tp2'))
    runs.append(('save', 'torch_grid_cases:save_then_step', dict(
        init=inits['lm'], batches=ckpt, path=port_dir, opt=OPTS['ckpt'],
        spec=dict(tp=2, dp=2))))
    got = run_group(4, runs)
    jtr = _jax_trainer('lm', dict(dp=1), 'ckpt')
    template = jtr.init(jax.random.PRNGKey(1), params=jax.tree.map(
        np.zeros_like, inits['lm']))
    jstate, step = jtr.restore_state(JManager(port_dir), template)
    restored = _jax_leaves(jstate)
    jstate, m = jtr.step(jstate, ckpt[-1])
    want['save_jax'] = (restored, step, float(m['loss']),
                        cases.flat(jtr.get_params(jstate)))
    want['save_port'] = grid.restore_then_step(
        0, 1, path=port_dir, batch=ckpt[-1], opt=OPTS['ckpt'], spec={})
    want['inits'] = inits
    return got, want


@pytest.mark.parametrize('sizes', GRIDS, ids=lambda g: 'dp%d_sp%d_ep%d_tp%d'
                         % g)
def test_rank_grid_lays_the_jax_mesh_order_out(world4, sizes):
    """r = (((d·sp + s)·ep + e)·tp + t), as the JAX mesh of (data, pipe,
    seq, expert, model) orders its devices, and each group holds the
    ranks that share the other coordinates."""
    got, _ = world4
    dp, sp, ep, tp = sizes
    mesh = JSpec(dp=dp, sp=sp, ep=ep, tp=tp).build_mesh(jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    for r, rank in enumerate(got['grid_%d%d%d%d' % sizes]):
        d, p, s, e, t = rank['coords']
        assert ids[d, p, s, e, t] == r
        assert rank['shape'] == dict(mesh.shape)

        def along(*axes):
            idx = [d, p, s, e, t]
            out = []
            for i in np.ndindex(ids.shape):
                if all(i[a] == idx[a] for a in range(5) if a not in axes):
                    out.append(int(ids[i]))
            return sorted(out)
        assert rank['groups']['data'] == along(0)
        assert rank['groups']['seq'] == along(2)
        assert rank['groups']['expert'] == along(3)
        assert rank['groups']['model'] == along(4)
        assert rank['groups']['batch'] == along(0, 2)
        assert rank['expert_model'] == along(3, 4)


def test_live_mesh_axis_reads_the_step_grid():
    """The port's ``live_mesh_axis`` binds as the JAX one under a
    ``sharding_ctx`` of the same sizes, and is None outside a step."""
    from autodist_tpu.parallel.axes import live_mesh_axis as j_live
    from autodist_tpu.parallel.axes import sharding_ctx
    from autodist_tpu_torch.models.core import model_mode
    from autodist_tpu_torch.parallel.axes import DEFAULT_RULES
    from autodist_tpu_torch.parallel.axes import live_mesh_axis

    class Grid:
        shape = None
    rules = [list(r) for r in DEFAULT_RULES]
    assert live_mesh_axis('heads') is None
    for sizes in GRIDS:
        mesh = JSpec(dp=sizes[0], sp=sizes[1], ep=sizes[2],
                     tp=sizes[3]).build_mesh(jax.devices()[:4])
        Grid.shape = dict(mesh.shape)
        with model_mode(mesh=Grid(), rules=rules), \
                sharding_ctx(mesh, rules):
            for logical in ('heads', 'mlp', 'vocab', 'expert', 'embed',
                            'batch', 'seq', 'stage'):
                assert live_mesh_axis(logical) == j_live(logical), \
                    (sizes, logical)


def test_megatron_operators_over_a_group_of_4(world4):
    got, _ = world4
    ranks = got['operators']
    rngs = [np.random.RandomState(r) for r in range(4)]
    xs, ws = zip(*[[rng.randn(3, 5).astype(np.float32) for _ in range(2)]
                   for rng in rngs])
    for r, rank in enumerate(ranks):
        out, grad = rank['copy']
        np.testing.assert_array_equal(out, xs[r])
        np.testing.assert_allclose(grad, sum(ws), rtol=0, atol=FN_TOL)
        out, grad = rank['reduce']
        np.testing.assert_allclose(out, sum(xs), rtol=0, atol=FN_TOL)
        np.testing.assert_array_equal(grad, ws[r])


def test_sharded_lookup_and_vocab_parallel_nll_match_unsharded(world4):
    got, _ = world4
    ranks = got['lookup_nll']
    want = tp_cases.unsharded()
    for r, rank in enumerate(ranks):
        for key in ('rows', 'nll'):
            np.testing.assert_allclose(rank[key], want[key], rtol=0,
                                       atol=FN_TOL, err_msg=key)
    table_grad = np.concatenate([r['table_grad'] for r in ranks], axis=0)
    logits_grad = np.concatenate([r['logits_grad'] for r in ranks], axis=2)
    np.testing.assert_allclose(table_grad, want['table_grad'], rtol=0,
                               atol=FN_TOL)
    np.testing.assert_allclose(logits_grad, want['logits_grad'], rtol=0,
                               atol=FN_TOL)


@pytest.mark.parametrize('key', list(TRAINER_CASES))
def test_trainer_matches_jax_trainer(world4, key):
    got, want = world4
    losses, params = want[key]
    opt = TRAINER_CASES[key][2]
    for r, rank in enumerate(got[key]):
        np.testing.assert_allclose(rank['losses'], losses, err_msg=str(r),
                                   **LOSS)
        assert rank['params'].keys() == params.keys()
        for k in params:
            np.testing.assert_allclose(rank['params'][k], params[k],
                                       err_msg='%s rank %d' % (k, r),
                                       **PARAMS[opt])
    if key == EVAL_CASE:
        for rank in got[key]:
            np.testing.assert_allclose(rank['eval'], want['eval'], **LOSS)
    if TRAINER_CASES[key][0] == 'moe':
        # the router's gradient moved it (sgd holds it to 2e-6 above)
        router = 'blocks/mlp/router/kernel'
        assert np.max(np.abs(params[router] - cases.flat(
            want['inits']['moe'])[router])) > 1e-4


@pytest.mark.parametrize('key', list(ROUND_TRIPS))
def test_jax_params_round_trip_bitwise_with_the_qkv_view(world4, key):
    got, want = world4
    init = cases.flat(want['inits']['lm'])
    tp = ROUND_TRIPS[key]['tp']
    qkv = init['blocks/attn/qkv/kernel']           # [L, dim, 3 h d]
    layers, dim = qkv.shape[:2]
    heads = JConfig.tiny().n_heads
    view = qkv.reshape(layers, dim, 3, heads, -1)
    for r, rank in enumerate(got['trip_' + key]):
        assert rank['params'].keys() == init.keys()
        for k in init:
            np.testing.assert_array_equal(rank['params'][k], init[k],
                                          err_msg='%s rank %d' % (k, r))
        t, n = rank['model_index'], heads // tp
        block = view[:, :, :, t * n:(t + 1) * n].reshape(layers, dim, -1)
        np.testing.assert_array_equal(rank['qkv'], block)
        assert rank['groups']['blocks/attn/qkv/kernel'] == {'model': 3}
        assert rank['groups']['embed/table'] == {'model': 0}
        assert rank['groups']['ln_f/scale'] == {}


def test_port_tp2_checkpoint_restores_in_jax_and_in_the_port_at_tp1(world4):
    got, want = world4
    rank0 = got['save'][0]
    restored, step, loss, params = want['save_jax']
    assert step == 2
    assert restored.keys() == rank0['tree'].keys()
    for k in restored:
        np.testing.assert_array_equal(restored[k], rank0['tree'][k],
                                      err_msg=k)
    port = want['save_port']
    assert port['step'] == 2
    for k in rank0['tree']:
        np.testing.assert_array_equal(port['tree'][k], rank0['tree'][k],
                                      err_msg=k)
    for other in (loss, port['loss']):
        np.testing.assert_allclose(rank0['loss'], other, **LOSS)
    for k in params:
        for other in (params[k], port['params'][k]):
            np.testing.assert_allclose(rank0['params'][k], other,
                                       err_msg=k, **PARAMS['ckpt'])


def test_indivisible_vocab_raises_in_both_packages(world4):
    """A vocab that tp does not divide: the JAX ``Trainer`` raises
    ``ValueError`` at ``init``, the port's when it lays the table out."""
    got, _ = world4
    jtr = JTrainer(JLM(JConfig.tiny(vocab=250, dtype=jnp.float32)),
                   optax.sgd(0.1), spec=JSpec(tp=4, dp=1))
    with pytest.raises(ValueError):
        jtr.init(jax.random.PRNGKey(0))
    for rank in got['vocab250']:
        assert rank['raised'] == 'ValueError'
        assert 'embed/table' in rank['message']


def test_dcn_dp_lays_the_data_axis_in_contiguous_blocks(world4):
    """At dp 4, dcn_dp 2 the data axis is two blocks of two, the node
    groups the two-level schedules take (``data_axis_node_groups``), and
    the ranks keep the JAX mesh's order (its emulation of slices is
    row-major)."""
    got, _ = world4
    mesh = JSpec(dp=4, dcn_dp=2).build_mesh(jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(mesh.devices).reshape(-1)
    for r, rank in enumerate(got['grid_dcn']):
        assert rank['node_groups'] == [[0, 1], [2, 3]]
        assert ids[rank['coords'][0]] == r
        assert rank['groups']['data'] == [0, 1, 2, 3]


def test_dcn_dp_must_divide_dp_and_match_the_nodes():
    from autodist_tpu_torch.parallel.mesh import RankGrid
    with pytest.raises(ValueError, match=r'dcn_dp=3 must divide the data '
                       r'axis \(4\)'):
        RankGrid(4, 1, 0, dcn_dp=3)
    with pytest.raises(ValueError, match='dcn_dp=2 but the 4 devices span '
                       '1 slices'):
        RankGrid(4, 1, 0, dcn_dp=2, ranks_per_node=[4])
