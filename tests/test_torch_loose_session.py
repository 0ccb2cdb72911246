"""The port's loose session against the JAX one (``tests/test_async_ps.py``
's session half).

The same program (one SGD step of mean((x W)^2)), W0 and feed from
``np.random.RandomState`` run through a JAX loose session and a port
loose session (``device='cpu'``), each in one process through its
package's ``single_process_loose_env``, at pipeline depths 1 and 2, on
the f32, bf16 and i8 wires. After 5 steps W and the i8 error-feedback
residual agree within 1e-6 relative, and on the f32 wire both track the
serial numpy ground truth (rtol 2e-4, as the JAX test holds). The
residual, a difference of values of W's size, is held to 1e-6 of W's
scale (one ulp of W between XLA's and PyTorch's f32 arithmetic is a
few parts in 1e4 of the residual itself). One coord
service serves the module; every session has its own namespace (its
strategy id).
"""
import threading
import time
from contextlib import contextmanager

import numpy as np
import pytest

from autodist_tpu_torch.runtime import coord_client as pcc
from autodist_tpu_torch.utils.loose_harness import start_service, stop_service

RESOURCE = {'nodes': [{'address': 'localhost', 'gpus': [0], 'chief': True,
                       'network_bandwidth': 100}]}
STEPS = 5


@pytest.fixture(scope='module')
def coord_port():
    port, proc = start_service()
    yield port
    stop_service(port, proc)


def _program(ad, W0, dim, opt=None):
    x = ad.placeholder(shape=[None, dim], dtype=np.float32, name='x')
    W = ad.Variable(W0, name='W')
    loss = ad.ops.reduce_mean(ad.ops.square(ad.ops.matmul(x, W)))
    opt = opt or ad.optimizers.SGD(0.1)
    return x, loss, opt.minimize(loss, [W])


def _exact_program(ad, W0, dim):
    """sum(W * c) under SGD(0.125): the gradient is c itself and a step
    rounds once (0.125 is a power of two), so both packages compute the
    same bits."""
    c = ad.placeholder(shape=[dim, 3], dtype=np.float32, name='c')
    W = ad.Variable(W0, name='W')
    loss = ad.ops.reduce_sum(W * c)
    return c, loss, ad.optimizers.SGD(0.125).minimize(loss, [W])


def _inputs(seed, dim, exact):
    """W0 and the feed: W [dim, 3] ~ N(0, 1) and x [8, dim] for
    :func:`_program`; for :func:`_exact_program` W ~ 1e-3 N(0, 1), near
    the residual's scale, and c [dim, 3] ~ N(0, 1)."""
    rng = np.random.RandomState(seed)
    W0 = rng.randn(dim, 3).astype(np.float32)
    if exact:
        return W0 * np.float32(1e-3), rng.randn(dim, 3).astype(np.float32)
    return W0, rng.randn(8, dim).astype(np.float32)


@contextmanager
def port_session(port, depth, staleness=2, dim=48, seed=0, builder=None,
                 exact=False):
    """(sess, train_op, x, loss, W0, feed) of a port loose session."""
    import autodist_tpu_torch as ad
    from autodist_tpu_torch.utils.loose_harness import \
        single_process_loose_env
    with single_process_loose_env(port, depth) as session_sees_one:
        autodist = ad.AutoDist(
            resource_info=RESOURCE, device='cpu',
            strategy_builder=builder or ad.PS(staleness=staleness))
        W0, feed = _inputs(seed, dim, exact)
        with autodist.scope():
            x, loss, train_op = (_exact_program if exact else _program)(
                ad, W0, dim)
            autodist._build()
            session_sees_one()
            sess = autodist.create_distributed_session()
            assert sess._pipeline_depth == min(depth, 2)
            try:
                yield sess, train_op, x, loss, W0, feed
            finally:
                sess.close()


@contextmanager
def jax_session(port, depth, staleness=2, dim=48, seed=0, exact=False):
    import autodist_tpu as jad
    from autodist_tpu.utils.loose_harness import single_process_loose_env
    with single_process_loose_env(port, depth) as session_sees_one:
        autodist = jad.AutoDist(
            resource_info=RESOURCE,
            strategy_builder=jad.strategy.PS(staleness=staleness))
        W0, feed = _inputs(seed, dim, exact)
        with autodist.scope():
            x, loss, train_op = (_exact_program if exact else _program)(
                jad, W0, dim)
            autodist._build()
            session_sees_one()
            sess = autodist.create_distributed_session()
            assert sess._loose
            try:
                yield sess, train_op, x, loss, W0, feed
            finally:
                sess.close()


def _serial_ground_truth(W0, feed, steps, lr=0.1):
    """pull -> local SGD step -> delta push by one worker, in numpy:
    the gradient of mean((xW)^2) is 2/(n*m) x^T (x W)."""
    W = W0.astype(np.float32).copy()
    denom = np.float32(feed.shape[0] * W0.shape[1])
    for _ in range(steps):
        g = (np.float32(2.0) / denom) * (feed.T @ (feed @ W))
        W = W - np.float32(lr) * g
    return W


def _train(session, port, depth, monkeypatch, wire, exact=False):
    monkeypatch.setenv('AUTODIST_PS_WIRE_DTYPE', wire)
    with session(port, depth, exact=exact) as (sess, train_op, x, loss, W0,
                                               feed):
        losses = []
        for _ in range(STEPS):
            losses.append(float(sess.run([loss, train_op], {x: feed})[0]))
        W = sess.get_variable_value('W')
        res = sess._push_residual.get('W')
        stats = sess.ps_stats
    return W0, feed, losses, W, res, stats


@pytest.mark.parametrize('wire', ['f32', 'bf16', 'i8'])
@pytest.mark.parametrize('depth', [1, 2])
def test_port_loose_session_matches_jax(coord_port, monkeypatch, depth,
                                        wire):
    W0, feed, losses, W, res, stats = _train(port_session, coord_port,
                                             depth, monkeypatch, wire)
    _, _, jlosses, jW, jres, jstats = _train(jax_session, coord_port,
                                             depth, monkeypatch, wire)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-6)
    np.testing.assert_allclose(W, jW, rtol=1e-6, atol=1e-6 *
                               np.abs(jW).max())
    if wire == 'i8':
        # the residual is a difference of W's (after - pulled, then
        # minus its quantized self): its error is W's, so it is held to
        # 1e-6 of W's scale — one ulp of |W| ~ 1 is ~5e-4 of a residual
        # of ~1e-4 (ROADMAP.md Queue 3)
        assert res is not None and jres is not None
        np.testing.assert_allclose(res, jres, rtol=0, atol=1e-6 *
                                   np.abs(jW).max())
    else:
        assert res is None and jres is None
    if wire == 'f32':
        want = _serial_ground_truth(W0, feed, STEPS)
        np.testing.assert_allclose(W, want, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(jW, want, rtol=2e-4, atol=2e-5)
    for key in ('push_bytes', 'pull_bytes', 'bytes'):
        assert stats[key] == jstats[key], key
    pipe = stats['pipeline']
    assert pipe['depth'] == depth and pipe['train_steps'] == STEPS
    assert pipe['pull_s'] > 0 and pipe['push_s'] > 0
    assert pipe['max_lag'] <= 2
    if depth == 1:
        assert pipe['overlap_frac'] == 0.0


@pytest.mark.parametrize('depth', [1, 2])
def test_i8_residual_matches_jax_within_1e6_of_itself(coord_port,
                                                      monkeypatch, depth):
    """Where both packages compute the same bits (``_exact_program``),
    the i8 error-feedback residual after 5 steps agrees with the JAX
    session's within 1e-6 of its own values, elementwise, and so do W
    and the losses."""
    _, _, losses, W, res, _ = _train(port_session, coord_port, depth,
                                     monkeypatch, 'i8', exact=True)
    _, _, jlosses, jW, jres, _ = _train(jax_session, coord_port, depth,
                                        monkeypatch, 'i8', exact=True)
    assert res is not None and jres is not None
    # every block's largest element goes through the wire exactly
    assert np.count_nonzero(jres) > jres.size // 2
    np.testing.assert_allclose(res, jres, rtol=1e-6, atol=0)
    np.testing.assert_allclose(W, jW, rtol=1e-6, atol=0)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-6)


def test_i8_residual_is_the_mass_the_wire_dropped(coord_port, monkeypatch):
    """The port's residual after a push equals compensated minus what
    the service stored of it, bit for bit (the JAX session's contract)."""
    monkeypatch.setenv('AUTODIST_PS_WIRE_DTYPE', 'i8')
    with port_session(coord_port, 1) as (sess, train_op, x, _, W0, feed):
        sess.run(train_op, {x: feed})
        pulled = W0
        after = sess._local_value('W')
        stored = sess.get_variable_value('W')
        compensated = after - pulled
        np.testing.assert_array_equal(
            sess._push_residual['W'],
            compensated - pcc.wire_roundtrip(compensated, 'i8'))
        np.testing.assert_array_equal(
            stored, pulled + pcc.wire_roundtrip(compensated, 'i8'))


def test_depth2_bit_identical_to_depth1(coord_port):
    finals, losses = {}, {}
    for depth in (1, 2):
        with port_session(coord_port, depth, seed=7) as (
                sess, train_op, x, loss, W0, feed):
            losses[depth] = [sess.run([loss, train_op], {x: feed})[0]
                             for _ in range(6)]
            finals[depth] = sess.get_variable_value('W')
    np.testing.assert_array_equal(finals[1], finals[2])
    np.testing.assert_array_equal(losses[1], losses[2])


def test_depth2_push_precedes_publish_and_next_pull(coord_port,
                                                    monkeypatch):
    events = []
    lock = threading.Lock()
    real_vmadd = pcc.CoordClient.vmadd
    real_vmget = pcc.CoordClient.vmget
    real_publish = pcc.CoordClient.publish_step

    def log(tag):
        with lock:
            events.append(tag)

    def vmadd_logged(self, items, wire=None):
        out = real_vmadd(self, items, wire=wire)
        log('push')
        return out

    def vmget_logged(self, specs, dtype=np.float32, wire=None):
        log('pull')
        return real_vmget(self, specs, dtype=dtype, wire=wire)

    def publish_logged(self, worker, step, prefix='step/'):
        log('publish')
        return real_publish(self, worker, step, prefix=prefix)

    monkeypatch.setattr(pcc.CoordClient, 'vmadd', vmadd_logged)
    monkeypatch.setattr(pcc.CoordClient, 'vmget', vmget_logged)
    monkeypatch.setattr(pcc.CoordClient, 'publish_step', publish_logged)
    with port_session(coord_port, 2) as (sess, train_op, x, _, W0, feed):
        for _ in range(3):
            sess.run(train_op, {x: feed})
    assert events == ['pull'] + ['push', 'publish', 'pull'] * 3 + \
        ['publish']


def test_depth2_records_overlap(coord_port):
    from autodist_tpu_torch.utils.profiling import (format_ps_overlap,
                                                    ps_overlap_report,
                                                    ps_wire_report)
    with port_session(coord_port, 2, dim=256) as (
            sess, train_op, x, _, W0, feed):
        def host_tail():
            # long against the wire by construction: it lasts until the
            # background push and pull-ahead are done, however slowly a
            # loaded host schedules that thread
            while not sess._inflight.done():
                time.sleep(0.005)
            time.sleep(0.01)

        sess.run(train_op, {x: feed})
        for _ in range(4):
            host_tail()
            sess.run(train_op, {x: feed})
        host_tail()
        sess.get_variable_value('W')
        stats = sess.ps_stats
    rep = ps_overlap_report(stats)
    assert rep['depth'] == 2 and rep['train_steps'] == 5
    assert rep['overlap_frac'] > 0.0 and rep['hidden_wire_s'] > 0.0
    assert rep['wire_s'] >= rep['exposed_wire_s']
    assert 'overlap' in format_ps_overlap(rep)
    wire = ps_wire_report(stats)
    # 5 pushes and 5 pulls of W, f32 (the 6th pull, made ahead, is
    # counted when a run takes it or a load drops it)
    assert wire['push_bytes'] == wire['pull_bytes'] == 5 * 256 * 3 * 4


def test_depth2_background_push_error_surfaces(coord_port, monkeypatch):
    from autodist_tpu_torch.runtime import loose_session
    with port_session(coord_port, 2) as (sess, train_op, x, _, W0, feed):
        sess.run(train_op, {x: feed})
        sess.get_variable_value('W')
        real = loose_session.LooseSession._push_ps_deltas

        def boom(self, pulled, afters, shared_push=None, scale=None):
            raise OSError('injected push failure')

        monkeypatch.setattr(loose_session.LooseSession, '_push_ps_deltas',
                            boom)
        sess.run(train_op, {x: feed})
        with pytest.raises(OSError, match='injected push failure'):
            sess.run(train_op, {x: feed})
        monkeypatch.setattr(loose_session.LooseSession, '_push_ps_deltas',
                            real)


def test_get_variable_value_drains_pipeline(coord_port):
    with port_session(coord_port, 2, seed=11) as (
            sess, train_op, x, _, W0, feed):
        sess.run(train_op, {x: feed})
        w1 = sess.get_variable_value('W')
        np.testing.assert_allclose(w1, _serial_ground_truth(W0, feed, 1),
                                   rtol=2e-4, atol=2e-5)
        assert sess._stashed_prefetch is not None
        sess.run(train_op, {x: feed})
        np.testing.assert_allclose(sess.get_variable_value('W'),
                                   _serial_ground_truth(W0, feed, 2),
                                   rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize('policy', ['fail', 'exclude', 'restart'])
def test_membership_policy_health_matches_jax(coord_port, monkeypatch,
                                               policy):
    """Every peer-failure policy starts (none raises any more), and a
    port session's health record has the JAX session's keys and values
    after the same two steps alone; the report renders the policy."""
    from autodist_tpu_torch.utils.profiling import (format_health,
                                                    health_report)
    monkeypatch.setenv('AUTODIST_PEER_FAILURE_POLICY', policy)
    monkeypatch.setenv('AUTODIST_HEARTBEAT_TIMEOUT', '1')
    got = {}
    for name, session in (('port', port_session), ('jax', jax_session)):
        with session(coord_port, 2) as (sess, train_op, x, _, W0, feed):
            for _ in range(2):
                sess.run(train_op, {x: feed})
            got[name] = sess.health_stats
    port, jax = got['port'], got['jax']
    assert set(port) == set(jax)
    for key in ('policy', 'generation', 'epoch', 'world', 'num_workers',
                'active_workers', 'missed_beats', 'exclusions', 'rejoins',
                'joins', 'replans', 'excluded', 'rejoining', 'joining'):
        assert port[key] == jax[key], key
    assert port['policy'] == policy
    text = format_health(health_report(port))
    assert text.startswith('policy=%s generation=0 epoch=0' % policy)


def test_plan_loose_fields():
    """The gate and window fields of a loose plan (JAX ``plan.py``):
    the tightest sync staleness gates, an async-only strategy does not,
    and H clamps to 1 with a shared optimizer."""
    import autodist_tpu_torch as ad
    from autodist_tpu_torch.graph_item import GraphItem
    from autodist_tpu_torch.frontend import graph as fe
    from autodist_tpu_torch.parallel.mesh import ReplicaGroup
    from autodist_tpu_torch.parallel.plan import ExecutionPlan
    from autodist_tpu_torch.resource_spec import ResourceSpec

    def plan_of(builder, loose=True):
        gi = GraphItem(graph=fe.Graph())
        with gi.graph:
            x = ad.placeholder(shape=[None, 4], dtype=np.float32, name='x')
            W = ad.Variable(np.ones((4, 2), np.float32), name='W')
            ad.optimizers.SGD(0.1).minimize(
                ad.ops.reduce_mean(ad.ops.matmul(x, W)), [W])
        gi.prepare()
        s = builder.build(gi, ResourceSpec(resource_info=RESOURCE))
        return ExecutionPlan(s, gi, ReplicaGroup(1, 0, None, 'cpu'),
                             loose=loose)

    p = plan_of(ad.PS(staleness=3))
    assert p.loose and p.num_processes == 1
    assert p.gate_enabled and p.gate_staleness == 3 and p.local_steps == 1
    p = plan_of(ad.PS(sync=False))
    assert not p.gate_enabled
    assert plan_of(ad.PS(staleness=1, local_steps=4)).local_steps == 4
    assert plan_of(ad.PS(staleness=1, local_steps=4,
                         shared_optimizer=True)).local_steps == 1
    assert plan_of(ad.PS(staleness=1, local_steps=4),
                   loose=False).local_steps == 1


def test_auto_checkpoint_and_health(coord_port, monkeypatch, tmp_path):
    """The chief's auto-checkpoint every ``AUTODIST_AUTO_CHECKPOINT_EVERY``
    train steps holds its variable state, and ``health_stats`` reports
    the fail policy and this worker's generation."""
    from autodist_tpu_torch.checkpoint.saver import CheckpointManager
    from autodist_tpu_torch.runtime import loose_session
    monkeypatch.setenv('AUTODIST_AUTO_CHECKPOINT_EVERY', '2')
    monkeypatch.setattr(loose_session, 'DEFAULT_CHECKPOINT_DIR',
                        str(tmp_path))
    with port_session(coord_port, 1) as (sess, train_op, x, _, W0, feed):
        for _ in range(4):
            sess.run(train_op, {x: feed})
        W = sess._local_value('W')
        ns = sess._ns
        health = sess.health_stats
    assert health['policy'] == 'fail' and health['generation'] == 0
    assert health['auto_checkpoints'] == 2
    tree, step = CheckpointManager(str(tmp_path / 'auto' / ns)).restore()
    assert step == 4
    np.testing.assert_array_equal(tree['W'], W)
