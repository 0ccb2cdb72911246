"""The port's row-sparse PS plane against ``tests/test_sparse_ps.py``:
BSADD / BGETROWS through the port's client, the session's sparsity
classification and its threshold, the port's lazy optimizers, and the
loose embedding run end to end — sparse equal to dense bit for bit, and
the port's final table equal to the JAX session's.
"""
import os
import time
from contextlib import contextmanager
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from autodist_tpu_torch.runtime import coord_client as pcc
from autodist_tpu_torch.runtime.loose_session import LooseSession
from autodist_tpu_torch.utils.loose_harness import start_service, stop_service


@pytest.fixture(scope='module')
def coord_port():
    port, proc = start_service()
    yield port
    stop_service(port, proc)


@pytest.fixture()
def coord(coord_port):
    return lambda **kw: pcc.CoordClient(('127.0.0.1', coord_port), **kw)


# -- protocol: BSADD / BGETROWS ---------------------------------------------
@pytest.mark.parametrize('wire', ['f32', 'bf16'])
@pytest.mark.parametrize('chunked', [False, True])
def test_bsadd_matches_dense_badd(coord, monkeypatch, wire, chunked):
    if chunked:
        monkeypatch.setenv('AUTODIST_PS_CHUNK_BYTES', '256')
    c = coord()
    rng = np.random.RandomState(3)
    table = rng.randn(64, 8).astype(np.float32)
    idx = rng.permutation(64)[:24].astype(np.int32)
    rows = rng.randn(24, 8).astype(np.float32)
    dense = np.zeros((64, 8), np.float32)
    dense[idx] = rows
    ks, kd = 'sp/%s%d/s' % (wire, chunked), 'sp/%s%d/d' % (wire, chunked)
    c.vset(ks, table)
    c.vset(kd, table)
    assert c.vsadd(ks, idx, rows, wire=wire) == 1
    c.vadd(kd, dense, wire=wire)
    np.testing.assert_array_equal(c.vget(ks, shape=(64, 8)),
                                  c.vget(kd, shape=(64, 8)))


def test_bsadd_duplicate_indices_accumulate(coord):
    c = coord()
    c.vset('dup/t', np.zeros((8, 4), np.float32))
    c.vsadd('dup/t', np.array([3, 3, 3, 5], np.int32),
            np.ones((4, 4), np.float32))
    got = c.vget('dup/t', shape=(8, 4))
    np.testing.assert_array_equal(got[3], np.full(4, 3.0, np.float32))
    np.testing.assert_array_equal(got[5], np.ones(4, np.float32))
    assert got[[0, 1, 2, 4, 6, 7]].sum() == 0.0


@pytest.mark.parametrize('wire', ['f32', 'bf16'])
def test_bgetrows_matches_full_bget(coord, wire):
    c = coord()
    table = np.random.RandomState(4).randn(32, 6).astype(np.float32)
    c.vset('gr/t', table)
    idx = np.array([0, 31, 7, 7, 13], np.int32)
    np.testing.assert_array_equal(
        c.vgetrows('gr/t', idx, 6, wire=wire),
        c.vget('gr/t', shape=(32, 6), wire=wire)[idx])
    assert c.vgetrows('gr/absent', [0], 6) is None


def test_bsadd_requires_existing_tensor_and_valid_rows(coord):
    c = coord()
    with pytest.raises(OSError, match='no tensor'):
        c.vsadd('spnone/t', [0], np.ones((1, 4), np.float32))
    c.vset('spbad/t', np.zeros((4, 4), np.float32))
    with pytest.raises(OSError, match='bad row index'):
        c.vsadd('spbad/t', [4], np.ones((1, 4), np.float32))
    with pytest.raises(OSError, match='bad row index'):
        c.vgetrows('spbad/t', [99], 4)


def test_bgetrows_oversized_reply_refused(coord):
    c = coord()
    c.vset('cap/t', np.zeros((8, 4), np.float32))
    idx = np.ascontiguousarray(np.zeros(1000, np.int32))
    assert c._rpc('BGETROWS cap/t 1000 16000000 f32',
                  memoryview(idx).cast('B')) == 'ERR reply too large'
    assert c.vgetrows('cap/t', [1, 2], 4).shape == (2, 4)


def test_fence_rejects_zombie_bsadd(coord):
    c, other = coord(), coord()
    c.vset('fz/t', np.zeros((8, 4), np.float32))
    c.fence('fence/spz', c.incr('fence/spz', 0))
    other.incr('fence/spz', 1)
    with pytest.raises(pcc.FencedWriteError):
        c.vsadd('fz/t', [1], np.ones((1, 4), np.float32))
    np.testing.assert_array_equal(other.vget('fz/t', shape=(8, 4)),
                                  np.zeros((8, 4), np.float32))


def test_disconnect_aborts_bsadd_chunk_sequence(coord, monkeypatch):
    monkeypatch.setattr(pcc.CoordClient, 'STALL_TIMEOUT_S', 0.3)
    w, reader = coord(), coord()
    w.vset('dcs/t', np.zeros((16, 4), np.float32))
    idx = np.ascontiguousarray(np.array([2], np.int32))
    row = np.ones((1, 4), np.float32)
    assert w._rpc('BSADD dcs/t 1 16 f32 0 2',
                  [memoryview(idx).cast('B'),
                   memoryview(row.reshape(-1)).cast('B')]).startswith('VAL')
    w.close()
    deadline = time.time() + 5.0
    while True:
        try:
            got = reader.vget('dcs/t', shape=(16, 4))
            break
        except OSError:
            if time.time() > deadline:
                raise
            time.sleep(0.05)
    np.testing.assert_array_equal(got[2], np.ones(4, np.float32))


# -- the session's classification ------------------------------------------
def _classify(sparse_vars, deltas):
    return LooseSession._classify_push(
        SimpleNamespace(_sparse_vars=set(sparse_vars)), deltas)


def test_classify_push_threshold_crossover(monkeypatch):
    few = np.zeros((10, 4), np.float32)
    few[[1, 5, 7]] = 1.0
    many = np.zeros((10, 4), np.float32)
    many[:6] = 1.0
    zero_skip, sparse = _classify({'E'}, {'E': few})
    assert not zero_skip and list(sparse['E']) == [1, 5, 7]
    zero_skip, sparse = _classify({'E'}, {'E': many})
    assert not zero_skip and not sparse
    zero_skip, sparse = _classify({'E'},
                                  {'E': np.zeros((10, 4), np.float32)})
    assert zero_skip == {'E'} and not sparse
    zero_skip, sparse = _classify(set(), {'W': few})
    assert not zero_skip and not sparse
    monkeypatch.setenv('AUTODIST_SPARSE_PUSH_MAX_FRAC', '0.7')
    assert list(_classify({'E'}, {'E': many})[1]['E']) == list(range(6))
    monkeypatch.setenv('AUTODIST_SPARSE_PUSH_MAX_FRAC', '0')
    assert not _classify({'E'}, {'E': few})[1]


def test_sparse_push_frac_env_validated(monkeypatch):
    from autodist_tpu_torch.const import ENV
    monkeypatch.setenv('AUTODIST_SPARSE_PUSH_MAX_FRAC', '1.5')
    with pytest.raises(ValueError, match='AUTODIST_SPARSE_PUSH_MAX_FRAC'):
        ENV.AUTODIST_SPARSE_PUSH_MAX_FRAC.val


# -- lazy optimizers ----------------------------------------------------------
def _lazy_step(opt, w, state, g):
    return opt._lazy_row_update(torch.from_numpy(g), state,
                                torch.from_numpy(w))


def test_lazy_adam_keeps_untouched_rows_bit_stable():
    import autodist_tpu_torch as ad
    from autodist_tpu_torch.frontend import graph as fe
    w0 = np.random.RandomState(0).randn(6, 3).astype(np.float32)
    with fe.Graph():
        lazy = ad.optimizers.LazyAdam(0.1)
    state = lazy.init_leaf(torch.from_numpy(w0))
    g1 = np.zeros((6, 3), np.float32)
    g1[2] = 1.0
    w1, state = _lazy_step(lazy, w0, state, g1)
    w1 = w1.numpy()
    assert np.array_equal(w1[[0, 1, 3, 4, 5]], w0[[0, 1, 3, 4, 5]])
    assert not np.array_equal(w1[2], w0[2])
    g2 = np.zeros((6, 3), np.float32)
    g2[4] = -0.5
    w2, state = _lazy_step(lazy, w1, state, g2)
    w2 = w2.numpy()
    assert np.array_equal(w2[2], w1[2])
    assert not np.array_equal(w2[4], w1[4])


def test_lazy_momentum_row_stability():
    import autodist_tpu_torch as ad
    from autodist_tpu_torch.frontend import graph as fe
    w0 = np.ones((4, 2), np.float32)
    with fe.Graph():
        opt = ad.optimizers.LazyMomentum(0.1, momentum=0.9)
    state = opt.init_leaf(torch.from_numpy(w0))
    g = np.zeros((4, 2), np.float32)
    g[1] = 2.0
    w1, state = _lazy_step(opt, w0, state, g)
    w1 = w1.numpy()
    assert np.array_equal(w1[[0, 2, 3]], w0[[0, 2, 3]])
    w2, _ = _lazy_step(opt, w1, state, np.zeros((4, 2), np.float32))
    assert np.array_equal(w2.numpy(), w1)


# -- end to end ---------------------------------------------------------------
@contextmanager
def _env(**kw):
    saved = {k: os.environ.get(k) for k in kw}
    os.environ.update({k: str(v) for k, v in kw.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _loose_embedding_run(ad, harness, port, max_frac, steps=3, vocab=96,
                         dim=8, **kw):
    with _env(AUTODIST_SPARSE_PUSH_MAX_FRAC=max_frac), \
            harness(port, depth=1) as sees_one:
        autodist = ad.AutoDist(
            resource_info={'nodes': [
                {'address': 'localhost', 'gpus': [0], 'chief': True,
                 'network_bandwidth': 100}]},
            strategy_builder=ad.strategy.PS(staleness=2,
                                            local_proxy_variable=True),
            **kw)
        rng = np.random.RandomState(0)
        E0 = rng.randn(vocab, dim).astype(np.float32)
        U0 = rng.randn(4, 2).astype(np.float32)
        ids = np.array([5, 5, 11, 60], np.int32)
        with autodist.scope():
            x = ad.placeholder(shape=[None], dtype=np.int32, name='ids')
            E = ad.Variable(E0, name='E')
            U = ad.Variable(U0, name='U')   # unused: zero gradients
            loss = ad.ops.reduce_mean(ad.ops.square(
                ad.ops.embedding_lookup(E, x)))
            train_op = ad.optimizers.LazyAdam(0.05).minimize(loss, [E, U])
            autodist._build()
            ns = autodist._transformed[0].id
            sees_one()
            sess = autodist.create_distributed_session()
            for _ in range(steps):
                sess.run(train_op, {x: ids})
            stats = sess.ps_stats
            final = sess.get_variable_value('E')
            pushes = pcc.CoordClient(('127.0.0.1', port)).vstat(
                '%s/var/U' % ns)
            sess.close()
    return final, stats, E0, pushes


def test_session_sparse_plane_matches_dense_and_jax(coord_port):
    import autodist_tpu as jad
    import autodist_tpu_torch as ad
    from autodist_tpu.utils.loose_harness import \
        single_process_loose_env as jax_harness
    from autodist_tpu_torch.utils.loose_harness import \
        single_process_loose_env as harness
    dense_final, dense_stats, E0, _ = _loose_embedding_run(
        ad, harness, coord_port, 0.0, device='cpu')
    final, stats, _, upushes = _loose_embedding_run(
        ad, harness, coord_port, 0.5, device='cpu')
    jfinal, jstats, _, _ = _loose_embedding_run(jad, jax_harness,
                                                coord_port, 0.5)
    assert np.array_equal(dense_final, final)
    ss = stats['sparse']
    assert ss == jstats['sparse']
    assert ss['sparse_pushes'] == 3 and ss['rows_pushed'] == 9
    assert ss['zero_push_skips'] == 3 and ss['dense_bytes_avoided'] > 0
    assert stats['bytes'] < dense_stats['bytes']
    assert stats['bytes'] == jstats['bytes']
    assert dense_stats['sparse']['sparse_pushes'] == 0
    assert upushes is not None and upushes['pushes'] == 0
    untouched = np.setdiff1d(np.arange(96), [5, 11, 60])
    np.testing.assert_array_equal(final[untouched], E0[untouched])
    np.testing.assert_allclose(final, jfinal, rtol=1e-6, atol=1e-7)


def test_ps_sparse_report_ratios():
    from autodist_tpu_torch.utils.profiling import (format_ps_sparse,
                                                    ps_sparse_report)
    stats = {'bytes': 1000,
             'sparse': {'sparse_pushes': 3, 'rows_pushed': 9,
                        'dense_bytes_avoided': 9000,
                        'zero_push_skips': 1, 'row_refreshes': 2,
                        'rows_refreshed': 6, 'full_refreshes': 1}}
    rep = ps_sparse_report(stats)
    assert abs(rep['avoided_frac'] - 0.9) < 1e-9
    assert 'sparse pushes 3' in format_ps_sparse(rep)
    assert ps_sparse_report({}) == {} and ps_sparse_report({'bytes': 5}) \
        == {}
    assert format_ps_sparse({}) == '(no sparse-plane counters)'
