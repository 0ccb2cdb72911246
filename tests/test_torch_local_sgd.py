"""Local SGD on the port's loose plane, against ``tests/test_local_sgd.py``
's session cases: H local steps a sync round, the pull at a window's
start, one window delta pushed a round, a partial window dropped at
close, ``AUTODIST_LOCAL_STEPS`` over the strategy — and the port's
window trajectory equal to the JAX session's on the same inputs.
"""
from contextlib import contextmanager

import numpy as np
import pytest

from autodist_tpu_torch.runtime import coord_client as pcc
from autodist_tpu_torch.utils.loose_harness import start_service, stop_service

RESOURCE = {'nodes': [{'address': 'localhost', 'gpus': [0], 'chief': True,
                       'network_bandwidth': 100}]}


@pytest.fixture(scope='module')
def coord():
    port, proc = start_service()
    yield port
    stop_service(port, proc)


@contextmanager
def _loose_session(coord_port, h, depth=1, dim=48, seed=0, jax=False):
    """A single-process loose session at window ``h``: (sess, train_op,
    x, W0, feed)."""
    if jax:
        import autodist_tpu as ad
        from autodist_tpu.utils.loose_harness import \
            single_process_loose_env
        builder, kw = ad.strategy.PS, {}
    else:
        import autodist_tpu_torch as ad
        from autodist_tpu_torch.utils.loose_harness import \
            single_process_loose_env
        builder, kw = ad.PS, {'device': 'cpu'}
    with single_process_loose_env(coord_port, depth) as session_sees_one:
        autodist = ad.AutoDist(
            resource_info=RESOURCE,
            strategy_builder=builder(staleness=2, local_steps=h), **kw)
        rng = np.random.RandomState(seed)
        W0 = rng.randn(dim, 3).astype(np.float32)
        feed = rng.randn(8, dim).astype(np.float32)
        with autodist.scope():
            x = ad.placeholder(shape=[None, dim], dtype=np.float32,
                               name='x')
            W = ad.Variable(W0, name='W')
            loss = ad.ops.reduce_mean(ad.ops.square(ad.ops.matmul(x, W)))
            train_op = ad.optimizers.SGD(0.1).minimize(loss, [W])
            autodist._build()
            session_sees_one()
            sess = autodist.create_distributed_session()
            try:
                yield sess, train_op, x, W0, feed
            finally:
                sess.close()


def _serial_ground_truth(W0, feed, steps, lr=0.1):
    W = W0.astype(np.float32).copy()
    denom = np.float32(feed.shape[0] * W0.shape[1])
    for _ in range(steps):
        g = (np.float32(2.0) / denom) * (feed.T @ (feed @ W))
        W = W - np.float32(lr) * g
    return W


def test_h1_sync_rounds_equal_train_steps(coord):
    with _loose_session(coord, h=1) as (sess, train_op, x, W0, feed):
        for _ in range(5):
            sess.run(train_op, {x: feed})
        got = sess.get_variable_value('W')
        pipe = sess.ps_stats['pipeline']
    assert pipe['local_steps'] == 1 and pipe['train_steps'] == 5
    assert pipe['sync_rounds'] == pipe['train_steps']
    np.testing.assert_allclose(got, _serial_ground_truth(W0, feed, 5),
                               rtol=2e-4, atol=2e-5)


def test_window_round_accounting(coord):
    with _loose_session(coord, h=4) as (sess, train_op, x, W0, feed):
        for _ in range(8):
            sess.run(train_op, {x: feed})
        pipe = sess.ps_stats['pipeline']
    assert pipe['local_steps'] == 4 and pipe['train_steps'] == 8
    assert pipe['sync_rounds'] == 2
    assert pipe['pull_s'] > 0 and pipe['push_s'] > 0


@pytest.mark.parametrize('depth', [1, 2])
def test_window_delta_telescopes_to_serial_and_matches_jax(coord, depth):
    finals = {}
    for h, jax in ((1, False), (4, False), (4, True)):
        with _loose_session(coord, h=h, depth=depth, seed=7, jax=jax) as (
                sess, train_op, x, W0, feed):
            for _ in range(8):
                sess.run(train_op, {x: feed})
            finals[h, jax] = sess.get_variable_value('W')
    np.testing.assert_allclose(finals[4, False], finals[1, False],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(finals[4, False],
                               _serial_ground_truth(W0, feed, 8),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(finals[4, False], finals[4, True],
                               rtol=1e-6, atol=1e-6)


def test_partial_window_is_dropped_at_close(coord):
    with _loose_session(coord, h=4) as (sess, train_op, x, W0, feed):
        for _ in range(6):
            sess.run(train_op, {x: feed})
        got = sess.get_variable_value('W')
        stats = sess.ps_stats
    assert stats['pipeline']['sync_rounds'] == 1
    np.testing.assert_allclose(got, _serial_ground_truth(W0, feed, 4),
                               rtol=2e-4, atol=2e-5)


def test_env_window_overrides_strategy(coord, monkeypatch):
    monkeypatch.setenv('AUTODIST_LOCAL_STEPS', '2')
    with _loose_session(coord, h=1) as (sess, train_op, x, W0, feed):
        assert sess._local_steps == 2
        for _ in range(4):
            sess.run(train_op, {x: feed})
        pipe = sess.ps_stats['pipeline']
    assert pipe['sync_rounds'] == 2 and pipe['local_steps'] == 2


def test_window_average_scales_by_the_workers(coord, monkeypatch):
    """With ``AUTODIST_LOCAL_SGD_AVERAGE`` on (the default) a window's
    delta is scaled by 1/W before it is pushed: at W = 1 that is the
    delta itself; the scale reaches the push through ``scale``."""
    from autodist_tpu_torch.runtime import loose_session
    scales = []
    real = loose_session.LooseSession._push_ps_deltas

    def spy(self, pulled, afters, shared_push=None, scale=None):
        scales.append(scale)
        return real(self, pulled, afters, shared_push, scale)

    monkeypatch.setattr(loose_session.LooseSession, '_push_ps_deltas', spy)
    with _loose_session(coord, h=2) as (sess, train_op, x, W0, feed):
        for _ in range(4):
            sess.run(train_op, {x: feed})
    assert scales == [1.0, 1.0]
    scales.clear()
    monkeypatch.setenv('AUTODIST_LOCAL_SGD_AVERAGE', '0')
    with _loose_session(coord, h=2) as (sess, train_op, x, W0, feed):
        for _ in range(2):
            sess.run(train_op, {x: feed})
    assert scales == [None]
