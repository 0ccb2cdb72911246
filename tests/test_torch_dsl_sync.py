"""Gradient synchronization of the port's DSL path over a gloo group of
2 processes (4 for the two-level schedules), against the JAX package
where the JAX tests compare numbers: bucketing
(``tests/test_bucketing.py``), the schedule IR's lowering identity
(``tests/test_schedule_ir.py``), the compressors
(``tests/test_compressor.py``), weight-update sharding
(``tests/test_weight_update_sharding.py``) and the sparse (ids, rows)
path (``tests/integration/test_sparse_embedding.py``).

All the world-2 cases run in one spawned group
(``torch_dsl_worlds.run_group``). Tolerances: bitwise where the JAX
tests demand it (bucketed against per-variable reduction; the IR
against the collectives it lowers to; the sharded update on
representable sums), 1e-5 on f32 values against the JAX package, 1e-6
for the re-association of random sums, and the int8 wire's
quantization bound (5 % of the largest sum).
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import autodist_tpu as jad
import torch_dsl_cases as cases
from torch_dsl_worlds import run_group

HERE = os.path.dirname(os.path.abspath(__file__))


def _load(relpath, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def world2():
    return run_group(2, [
        ('bucket', 'torch_dsl_cases:bucket_cases', {}),
        ('trained', 'torch_dsl_cases:trained_bitwise', {}),
        ('ir', 'torch_dsl_cases:ir_lowering', {}),
        ('comp', 'torch_dsl_cases:compressor_cases', {}),
        ('wus', 'torch_dsl_cases:wus_cases', {}),
        ('sparse', 'torch_dsl_cases:sparse_cases', {}),
    ])


@pytest.fixture(scope='module')
def world4():
    """The two-level cases, in one gloo group of 4 processes whose node
    groups are [[0, 1], [2, 3]]."""
    return run_group(4, [
        ('two_level', 'torch_dsl_cases:two_level_lowering', {}),
        ('choice', 'torch_dsl_cases:hierarchical_choice',
         {'env': {'AUTODIST_HIERARCHY_NODES': 2}}),
    ])


def _spec(n):
    return {'nodes': [{'address': 'localhost', 'gpus': list(range(n)),
                       'chief': True, 'network_bandwidth': 100}]}


def _jax(builder, n):
    from autodist_tpu import autodist as jad_mod
    jad_mod._DEFAULT_AUTODIST.clear()
    return jad.AutoDist(resource_info=_spec(n), strategy_builder=builder)


# -- bucketing ----------------------------------------------------------------
def test_one_collective_per_bucket_not_one_mega_bucket(world2):
    for vals, stats, calls, _ in [r['per_bucket'] for r in world2['bucket']]:
        assert calls == [200, 200, 200], calls
        assert [b['vars'] for b in stats] == [2, 2, 2]
        assert all(b['bytes'] == 800 for b in stats)
        assert stats[0]['members'][0] == 'v05'
        assert stats[-1]['members'][-1] == 'v00'


def test_bucket_records_match_jax_emission(world2, monkeypatch):
    """The same six gradients under the same cap: the JAX package's
    emission records (members, bytes, entry ids) over 2 replicas."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from autodist_tpu.frontend import graph as jfe
    from autodist_tpu.parallel.axes import shard_map_compat
    from autodist_tpu.parallel.plan import ExecutionPlan
    from autodist_tpu.resource_spec import ResourceSpec
    from autodist_tpu.strategy import AllReduce
    from autodist_tpu.strategy.adapter import (FunctionalModel,
                                               PytreeGraphItem)
    monkeypatch.setenv('AUTODIST_BUCKET_BYTES', '1000')
    gi = PytreeGraphItem(FunctionalModel(
        lambda rng: {'v%02d' % i: jnp.zeros((100,)) for i in range(6)},
        lambda p, b: 0.0))
    strategy = AllReduce(chunk_size=128).build(
        gi, ResourceSpec(resource_info=_spec(2)))
    mesh = Mesh(np.asarray(jax.devices()[:2]), ('data',))
    plan = ExecutionPlan(strategy, gi, mesh)
    sources = list(gi.trainable_var_op_to_var.values())
    jax.jit(shard_map_compat(
        lambda *gs: tuple(o[None] for o in plan.sync_gradients(
            sources, [g[0] for g in gs], jfe.Env({}, {}))),
        mesh, tuple(P('data') for _ in sources),
        tuple(P('data') for _ in sources)))(
        *[jnp.ones((2, 100)) for _ in sources])
    keys = ('kind', 'members', 'bytes', 'vars', 'entry_id')
    want = [{k: e[k] for k in keys} for e in plan.last_bucket_stats]
    for r in world2['bucket']:
        got = [{k: e[k] for k in keys} for e in r['per_bucket'][1]]
        assert got == want


def test_grad_larger_than_cap_gets_own_bucket(world2):
    for _, stats, calls, _ in [r['oversized'] for r in world2['bucket']]:
        assert calls == [50, 1000, 100], calls
        assert [b['members'] for b in stats] == \
            [['v02'], ['v01'], ['v00']]


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('compressor',
                         ['NoneCompressor', 'HorovodCompressor'])
def test_bucketed_equals_per_variable_reduction(world2, dtype, compressor):
    for r in world2['bucket']:
        bucketed = r['eq/%s/%s/600' % (dtype, compressor)]
        pervar = r['eq/%s/%s/1' % (dtype, compressor)]
        assert any(b['vars'] > 1 for b in bucketed[1])
        assert all(b['vars'] == 1 for b in pervar[1])
        for b, p in zip(bucketed[0], pervar[0]):
            np.testing.assert_array_equal(b, p)


def test_bucketed_mean_is_correct(world2):
    shapes = [(32,), (16, 4)]
    want = [np.mean([cases._rank_grads(shapes, r, 2, torch.float32)[i]
                     .numpy() for r in range(2)], axis=0)
            for i in range(len(shapes))]
    outs = [r['mean'][0] for r in world2['bucket']]
    for i, w in enumerate(want):
        np.testing.assert_allclose(outs[0][i], w, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(outs[1][i], outs[0][i])


def test_static_schedule_agrees_with_emission(world2):
    for r in world2['bucket']:
        _, stats, _, static = r['per_bucket']
        assert [(e['members'], e['bytes'], e['entry_id'])
                for e in static] == [(e['members'], e['bytes'],
                                      e['entry_id']) for e in stats]


def test_capped_zero_reduce_scatter_exact(world2):
    for r in world2['bucket']:
        capped, whole = r['zero_capped'], r['zero_whole']
        scat = [b for b in capped[1] if b['kind'] == 'psum_scatter']
        assert len(scat) == 4 and sum(b['bytes'] for b in scat) == 1024
        assert len([b for b in whole[1]
                    if b['kind'] == 'psum_scatter']) == 1
        np.testing.assert_array_equal(capped[0][0], whole[0][0])
        assert capped[0][0].shape == (8, 16)


def test_bucketed_training_bitwise_equal_to_per_variable(world2):
    """The CNN and the LSTM (c6) trained at world 2: default bucket cap
    and AUTODIST_BUCKET_BYTES=1 give the same bits."""
    for r in world2['trained']:
        for a, b in zip(r['default'][0] + r['default'][1],
                        r['1'][0] + r['1'][1]):
            np.testing.assert_array_equal(a, b)


# -- schedule IR -------------------------------------------------------------
def test_ir_lowering_bit_identical_to_the_collectives(world2):
    for r in world2['ir']:
        assert 'generic/flat/psum' in r
        for label, (ir, hand, errors) in r.items():
            assert errors == [], label
            assert float(np.abs(ir - hand).max()) == 0.0, label


def test_two_level_lowering_raises_naming_its_queue_item(world4):
    """A two-level IR program executes (the 'hier' lowering, over the
    node and cross-node subgroups) and equals the flat program on the
    same rows: bitwise, the rows being integer-valued."""
    for ir, flat, tag, findings in world4['two_level']:
        assert findings == [] and tag == 'hier'
        assert np.array_equal(ir, flat)


def test_hierarchical_choice_raises_naming_its_queue_item(world4):
    """A multi-node group whose cost model picks the two-level schedule
    syncs over the node groups [[0, 1], [2, 3]] (never a quiet flat
    fallback), and its gradients equal the flat plan's."""
    for res in world4['choice']:
        groups, hiers, synced = res['always']
        assert groups == [[0, 1], [2, 3]]
        assert hiers and all(h == 2 for h in hiers)
        flat_groups, flat_hiers, flat = res['never']
        assert flat_groups == groups and all(h == 0 for h in flat_hiers)
        for a, b in zip(synced, flat):
            assert np.array_equal(a, b)


# -- compressors -------------------------------------------------------------
def test_int8_ring_matches_sum(world2):
    for r in world2['comp']:
        got, want = r['int8_ring']
        tol = 0.05 * float(np.abs(want).max())
        assert float(np.abs(got - want).max()) < tol


def test_int8_ring_matches_jax_ring(world2):
    """Each rank's sum equals the JAX package's ``int8_ring_all_reduce``
    at 2 devices on the same rows: the same quantizer, hops and
    all-gather, so they differ by f32 rounding at most."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    from autodist_tpu.parallel.axes import shard_map_compat
    from autodist_tpu.parallel.compressor import int8_ring_all_reduce
    x = np.random.RandomState(0).randn(2, 1000).astype('f4')
    mesh = Mesh(np.array(jax.devices()[:2]), ('data',))
    want = np.asarray(jax.jit(shard_map_compat(
        lambda v: int8_ring_all_reduce(v, 'data'), mesh, P('data'),
        P('data')))(x))
    scale = float(np.abs(want).max())
    for rank, r in enumerate(world2['comp']):
        got, _ = r['int8_ring']
        np.testing.assert_allclose(got, want[rank], rtol=0,
                                   atol=1e-6 * scale)


def test_int8_compressor_training_converges(world2):
    true_w = np.array([1.0, -2.0, 3.0, 0.5], np.float32)
    residuals = []
    for r in world2['comp']:
        losses, w, res = r['int8_training']
        assert losses[-1] < losses[0] * 0.05, losses[:3] + losses[-3:]
        assert np.allclose(w, true_w, atol=0.15), w
        assert res.shape == (4,)
        residuals.append(res)
    assert not np.array_equal(*residuals)   # per-replica error feedback


def test_int8_small_tensor_bypasses_quantization():
    from autodist_tpu_torch.parallel.compressor import Int8RingCompressor
    comp = Int8RingCompressor('v')
    out = comp.reduce(torch.tensor([1.234567]), None, lambda g: g * 2.0)
    assert float(out[0]) == pytest.approx(2.469134, abs=1e-6)
    assert comp.init_state(np.zeros(3, 'f4')) == {}


def test_block_quantizer_matches_jax():
    from autodist_tpu.parallel import compressor as jcomp
    from autodist_tpu_torch.parallel import compressor as tcomp
    x = np.random.RandomState(3).randn(1000).astype('f4') * 3
    want = np.asarray(jcomp.block_roundtrip(x, block=256))
    got = tcomp.block_roundtrip(torch.from_numpy(x), block=256).numpy()
    scale = np.abs(x).max() / 127
    np.testing.assert_allclose(got, want, atol=1e-6 * scale + 1e-7)


def test_powersgd_matches_jax(world2):
    """PowerSGD (rank 2, error feedback) on the 12 x 1 regression over 2
    replicas: the JAX package's W after 3 steps."""
    from autodist_tpu.strategy import AllReduce
    autodist = _jax(AllReduce(compressor='PowerSGDCompressor'), 2)
    np.random.seed(7)
    X = np.random.randn(64, 12).astype(np.float32)
    y = np.random.randn(64, 1).astype(np.float32)
    with autodist.scope():
        xp = jad.placeholder(shape=[None, 12], dtype=np.float32, name='x')
        yp = jad.placeholder(shape=[None, 1], dtype=np.float32, name='y')
        W = jad.Variable(np.linspace(-1, 1, 12)[:, None].astype(np.float32),
                         name='W')
        loss = jad.ops.reduce_mean(jad.ops.square(jad.ops.matmul(xp, W) -
                                                  yp))
        train_op = jad.optimizers.Adam(0.05).minimize(loss, [W])
        sess = autodist.create_distributed_session()
        for _ in range(3):
            sess.run(train_op, {xp: X, yp: y})
        want = np.asarray(sess.get_variable_value(W))
    for r in world2['comp']:
        np.testing.assert_allclose(r['powersgd'], want, atol=1e-5)


# -- weight-update sharding --------------------------------------------------
def test_sharded_update_bit_identical_on_representable_sums(world2):
    for r in world2['wus']:
        base_v, base_s, _, _ = r['int_base']
        wus_v, wus_s, geometry, _ = r['int_wus']
        assert all(g[0] for g in geometry.values())
        for name in base_v:
            assert np.array_equal(base_v[name], wus_v[name]), name
            for a, b in zip(base_s[name], wus_s[name]):
                assert np.array_equal(a, b), name


def test_sharded_update_within_ulps_random_data_and_jax(world2):
    """Replicated vs sharded within re-association; both against the
    JAX package's replicated run of the same program."""
    jax_wus = _load('test_weight_update_sharding.py', 'jax_wus_tests')
    from autodist_tpu.strategy import AllReduce
    want, _, _ = jax_wus._train(AllReduce(),
                                lambda: jad.optimizers.Adam(0.05),
                                cases.WUS_SHAPES, steps=4)
    for r in world2['wus']:
        base_v, base_s, _, _ = r['rand_base']
        wus_v, wus_s, _, _ = r['rand_wus']
        for name in base_v:
            np.testing.assert_allclose(base_v[name], wus_v[name],
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(wus_v[name], want[name], atol=1e-5)
            for a, b in zip(base_s[name], wus_s[name]):
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_uneven_padded_shard_shapes(world2):
    """35, 7 and 3 elements over 2 replicas pad by 1 each; the padded
    tail never leaks into real elements."""
    for r in world2['wus']:
        base_v = r['uneven_base'][0]
        wus_v, _, geometry, shard_shapes = r['uneven_wus']
        assert {n: g[1] for n, g in geometry.items()} == \
            {'W': 1, 'V': 1, 'b': 1}
        for name in base_v:
            assert np.array_equal(base_v[name], wus_v[name]), name


def test_slots_stored_as_flat_shards(world2):
    for r in world2['wus']:
        _, _, geometry, shard_shapes = r['rand_wus']
        for name, (sharded, _, padded) in geometry.items():
            assert sharded
            assert shard_shapes[name] == [(padded // 2,)] * 2   # mu, nu


def test_lamb_fused_shard_update_matches_replicated(world2):
    for r in world2['wus']:
        base_v, wus_v = r['lamb_base'][0], r['lamb_wus'][0]
        for name in base_v:
            np.testing.assert_allclose(base_v[name], wus_v[name],
                                       rtol=1e-5, atol=1e-6)


# -- sparse embeddings -------------------------------------------------------
@pytest.fixture(scope='module')
def sparse_truth():
    jax_sparse = _load('integration/test_sparse_embedding.py', 'jax_sparse')
    from autodist_tpu.strategy import AllReduce
    table, w = jax_sparse.run_embedding_model(_jax(AllReduce(), 1))
    return np.asarray(table), np.asarray(w)


@pytest.mark.parametrize('name', cases.SPARSE_STRATEGIES)
def test_c2_sparse_numeric_parity(world2, sparse_truth, name):
    table_ref, w_ref = sparse_truth
    for r in world2['sparse']:
        table, w = r[name][:2]
        np.testing.assert_allclose(table, table_ref, atol=1e-5)
        np.testing.assert_allclose(w, w_ref, atol=1e-5)


def test_sparse_wire_engages(world2):
    """At two replicas the table ships as (ids, rows): no recorded
    collective carries it, while the dense weight takes its bucket."""
    for r in world2['sparse']:
        _, _, synced, members = r['AllReduce']
        assert synced == {'emb': True, 'w': False}
        assert members == ['w']
        _, _, synced, members = r['PartitionedPS']
        assert synced['emb'] and 'emb' not in members


def test_dense_use_disables_sparse_wire(world2):
    """A looked-up table with a dense consumer too takes the dense sync
    (the sparse wire would drop its mass outside the batch) and matches
    the JAX package's single-device run."""
    from autodist_tpu.strategy import AllReduce
    autodist = _jax(AllReduce(), 1)
    rng = np.random.RandomState(11)
    table_init = rng.randn(64, 4).astype(np.float32)
    ids_b = rng.randint(0, 64, size=16).astype(np.int32)
    with autodist.scope():
        ids = jad.placeholder(shape=[None], dtype=np.int32, name='ids')
        emb = jad.Variable(table_init, name='emb')
        loss = jad.ops.reduce_mean(jad.ops.embedding_lookup(emb, ids)) + \
            0.01 * jad.ops.reduce_sum(jad.ops.square(emb.read()))
        train_op = jad.optimizers.SGD(0.1).minimize(loss, [emb])
        sess = autodist.create_distributed_session()
        sess.run(train_op, {ids: ids_b})
        want = np.asarray(sess.get_variable_value('emb'))
    for r in world2['sparse']:
        table, synced, members = r['dense_use']
        assert not synced and members == ['emb']
        np.testing.assert_allclose(table, want, atol=1e-5)


@pytest.mark.parametrize('opt', ['LazyAdam', 'LazyMomentum'])
def test_lazy_optimizers_touch_only_looked_up_rows(world2, opt):
    """Rows no replica looked up keep their bits; the rest move, as the
    JAX package's lazy optimizer moves them (1 device)."""
    autodist = _jax(jad.AllReduce(), 1)
    table_init, _, all_ids = cases.lazy_rows(0, 1, opt)
    rng = np.random.RandomState(5)
    rng.randn(cases.VOCAB, cases.DIM)
    ids_b = [rng.randint(0, cases.VOCAB, size=cases.EMB_BATCH).astype(
        np.int32) for _ in range(2)]
    with autodist.scope():
        ids = jad.placeholder(shape=[None], dtype=np.int32, name='ids')
        emb = jad.Variable(table_init, name='emb')
        loss = jad.ops.reduce_mean(jad.ops.square(
            jad.ops.embedding_lookup(emb, ids) - 1.0))
        train_op = getattr(jad.optimizers, opt)(0.1).minimize(loss)
        sess = autodist.create_distributed_session()
        for b in ids_b:
            sess.run(train_op, {ids: b})
        want = np.asarray(sess.get_variable_value('emb'))
    untouched = np.setdiff1d(np.arange(cases.VOCAB), all_ids)
    for r in world2['sparse']:
        before, after, seen = r['lazy_' + opt[4:].lower()]
        np.testing.assert_array_equal(seen, all_ids)
        np.testing.assert_array_equal(after[untouched], before[untouched])
        assert not np.array_equal(after[all_ids], before[all_ids])
        np.testing.assert_allclose(after, want, atol=1e-5)
