"""The elastic-recovery chaos scenarios of ``tests/test_chaos_recovery.py``
against a PORT chief session (``autodist_tpu_torch``'s LooseSession on
the CPU).

Each scenario is the JAX test's: the real policy machinery (epoch-fenced
membership, generation fencing, restart waiting, live joins, the epoch
swap) and the real ``WorkerSupervisor`` loop, with the peer worker
simulated by a thread speaking the worker protocol and killed by a
seeded faultline plan, on a coord service of this module's own. In the
exclude scenario and the swap matrix the peer thread speaks the JAX
package's client (and its faultline, ``swap_keys`` and
``ack_staged_swaps``): the exclusion keys, the staged plans and the acks
of the two packages are one wire vocabulary. The swap cases also replay
the port chief's flight trace through the JAX package's swap-conformance
checker. W is held to the serial ground truth with the JAX test's
tolerance (rtol 2e-4, atol 2e-5); heartbeat timeouts are 1 s or less.
"""
import shutil
import threading
import time

import numpy as np
import pytest

pytestmark = [
    pytest.mark.chaos,
    pytest.mark.skipif(shutil.which('g++') is None,
                       reason='g++ unavailable'),
]

RESOURCE = {'nodes': [{'address': 'localhost', 'gpus': [0], 'chief': True,
                       'network_bandwidth': 100}]}


@pytest.fixture()
def service():
    from autodist_tpu_torch.utils.loose_harness import (start_service,
                                                        stop_service)
    port, proc = start_service()
    yield port
    stop_service(port, proc)


@pytest.fixture(autouse=True)
def _no_leaked_hook():
    yield
    from autodist_tpu.runtime.coord_client import CoordClient as JaxClient
    from autodist_tpu_torch.runtime.coord_client import CoordClient
    CoordClient.fault_hook = None
    JaxClient.fault_hook = None


def _client_mod(jax_client):
    if jax_client:
        from autodist_tpu.runtime import coord_client
    else:
        from autodist_tpu_torch.runtime import coord_client
    return coord_client


def _ground_truth(W0, feed, steps, lr=0.1):
    """The chief's serial trajectory (the simulated peers push no
    deltas, so this closed form IS the uninterrupted run): grad of
    mean((xW)^2) wrt W is 2/(n*m) * x^T (x W)."""
    W = W0.astype(np.float32).copy()
    denom = np.float32(feed.shape[0] * W0.shape[1])
    for _ in range(steps):
        g = (np.float32(2.0) / denom) * (feed.T @ (feed @ W))
        W = W - np.float32(lr) * g
    return W


class _ChiefHarness:
    """A port chief session beside thread-simulated peer workers: the
    2-worker loose-mode session on a private coord service."""

    def __init__(self, port, staleness=1, dim=48, seed=0):
        import autodist_tpu_torch as ad
        from autodist_tpu_torch.utils.loose_harness import \
            single_process_loose_env
        self._ctx = single_process_loose_env(port, depth=1)
        self._ctx.__enter__()
        self.autodist = ad.AutoDist(
            resource_info=RESOURCE, device='cpu',
            strategy_builder=ad.PS(staleness=staleness))
        rng = np.random.RandomState(seed)
        self.W0 = rng.randn(dim, 3).astype(np.float32)
        self.feed = rng.randn(8, dim).astype(np.float32)
        self.dim = dim
        self.graph = self.autodist.scope()
        self.graph.__enter__()
        self.x = ad.placeholder(shape=[None, dim], dtype=np.float32,
                                name='x')
        self.W = ad.Variable(self.W0, name='W')
        loss = ad.ops.reduce_mean(
            ad.ops.square(ad.ops.matmul(self.x, self.W)))
        self.train_op = ad.optimizers.SGD(0.1).minimize(loss, [self.W])
        self.autodist._build()   # 2 processes -> loose mode
        self.ns = self.autodist._transformed[0].id
        self.sess = None

    def create_session(self):
        self.sess = self.autodist.create_distributed_session()
        return self.sess

    def close(self):
        try:
            if self.sess is not None and not self.sess._closed:
                self.sess.close()
        finally:
            self.graph.__exit__(None, None, None)
            self._ctx.__exit__(None, None, None)


def _peer_loop(port, ns, worker, steps, stop_event=None,
               start_step=1, done_on_finish=True, interval=0.05,
               keep=None, jax_client=False):
    """One simulated worker incarnation: fence under the CURRENT
    generation, heartbeat, publish steps. Raises whatever the armed
    faultline injects (InjectedFault = this incarnation's death).
    With ``keep`` (a dict), the fenced client survives the death under
    ``keep['client']`` — the true zombie connection for post-death
    push assertions. ``jax_client`` speaks the JAX package's client."""
    c = _client_mod(jax_client).CoordClient(('127.0.0.1', port))
    if keep is not None:
        keep['client'] = c
    try:
        gen = c.incr('fence/%s/%s' % (ns, worker), 0)
        c.fence('fence/%s/%s' % (ns, worker), gen)
        c.heartbeat('%s/%s' % (ns, worker))
        if start_step == 1 and gen == 0:
            c.barrier('%s/session/init' % ns, 2, timeout_s=60.0)
        for s in range(start_step, steps + 1):
            c.heartbeat('%s/%s' % (ns, worker))
            c.publish_step(worker, s, prefix='%s/step/' % ns)
            if stop_event is not None and stop_event.wait(interval):
                return gen
            elif stop_event is None:
                time.sleep(interval)
        if done_on_finish:
            c.set('done/%s/%s' % (ns, worker), '1')
            c.publish_step(worker, 1 << 30, prefix='%s/step/' % ns)
        return gen
    finally:
        if keep is None:
            c.close()


def test_exclude_policy_survivor_finishes_and_zombie_is_fenced(
        service, monkeypatch):
    """under policy=exclude a peer
    killed mid-run by a seeded faultline plan is declared dead, fenced
    and excluded; the surviving chief's gate re-bounds to the shrunk
    membership and training runs to completion on the ground-truth
    trajectory; the zombie's post-death push is rejected by generation
    fencing; health_report records every event."""
    from autodist_tpu.runtime.coord_client import (CoordClient,
                                                   FencedWriteError)
    from autodist_tpu.utils.faultline import (FaultLine, FaultPlan,
                                              InjectedFault)
    from autodist_tpu_torch.utils.profiling import health_report
    monkeypatch.setenv('AUTODIST_PEER_FAILURE_POLICY', 'exclude')
    monkeypatch.setenv('AUTODIST_HEARTBEAT_TIMEOUT', '1.0')
    steps, kill_at = 6, 2
    h = _ChiefHarness(service)
    try:
        plan = FaultPlan([{'kind': 'kill_worker', 'worker': 'p1',
                           'step': kill_at + 1, 'mode': 'raise'}],
                         seed=4)
        died = {}
        kept = {}

        def peer():
            try:
                _peer_loop(service, h.ns, 'p1', steps, keep=kept,
                           jax_client=True)
            except InjectedFault as e:
                died['err'] = str(e)   # crash: no done marker, silence

        t = threading.Thread(target=peer, daemon=True)
        with FaultLine(plan, worker='p1') as fl:
            t.start()
            sess = h.create_session()
            for _ in range(steps):
                sess.run(h.train_op, {h.x: h.feed})
            w_final = sess.get_variable_value('W')
            t.join(timeout=10.0)
            # the TRUE zombie connection (fenced at generation 0 before
            # the death): its post-death push is rejected
            with pytest.raises(FencedWriteError):
                kept['client'].vadd('%s/var/W' % h.ns,
                                    np.ones((h.dim, 3), np.float32))
            # and a stale binary cannot even re-bind the old generation
            late = CoordClient(('127.0.0.1', service))
            with pytest.raises(FencedWriteError):
                late.fence('fence/%s/p1' % h.ns, 0)
            late.close()
            kept['client'].close()
            rep = health_report(sess.health_stats, faultline=fl)
        assert died, 'faultline never killed the peer'
        assert [e['kind'] for e in fl.events] == ['kill_worker']
        # the peer died at kill_at (its publish of kill_at+1 was the
        # kill point), the gate re-bounded, and the chief finished all
        # steps on the uninterrupted trajectory
        np.testing.assert_allclose(
            w_final, _ground_truth(h.W0, h.feed, steps),
            rtol=2e-4, atol=2e-5)
        assert rep['policy'] == 'exclude'
        assert rep['missed_beats'] >= 1
        assert rep['epoch'] == 1 and rep['epoch_bumps'] >= 1
        assert rep['exclusions'] == [{'worker': 'p1', 'epoch': 1}]
        assert rep['active_workers'] == 1 and rep['num_workers'] == 2
        assert rep['injected_faults'] == [
            {'kind': 'kill_worker', 'line': fl.events[0]['line']}]
        # the excluder really bumped the zombie's fence generation
        c = CoordClient(('127.0.0.1', service))
        assert c.incr('fence/%s/p1' % h.ns, 0) >= 1
        c.close()
    finally:
        h.close()


def test_exclude_bounded_by_min_workers(service, monkeypatch):
    """AUTODIST_MIN_WORKERS floors the shrink: excluding the only peer
    of a 2-worker run under MIN_WORKERS=2 fails instead."""
    monkeypatch.setenv('AUTODIST_PEER_FAILURE_POLICY', 'exclude')
    monkeypatch.setenv('AUTODIST_MIN_WORKERS', '2')
    monkeypatch.setenv('AUTODIST_HEARTBEAT_TIMEOUT', '1.0')
    steps, kill_at = 6, 1
    h = _ChiefHarness(service)
    try:
        stop = threading.Event()
        t = threading.Thread(
            target=_peer_loop,
            args=(service, h.ns, 'p1', kill_at, stop),
            kwargs={'done_on_finish': False}, daemon=True)
        t.start()
        sess = h.create_session()
        with pytest.raises(RuntimeError, match='AUTODIST_MIN_WORKERS'):
            for _ in range(steps):
                sess.run(h.train_op, {h.x: h.feed})
        stop.set()
        t.join(timeout=10.0)
    finally:
        h.close()


def test_restart_policy_reborn_worker_rejoins(service, monkeypatch):
    """under policy=restart the REAL
    WorkerSupervisor detects the death, fences the dead generation
    after a capped backoff and respawns; the reborn incarnation rejoins
    under the fresh generation at the published step; the blocked chief
    resumes, finishes on the uninterrupted trajectory, and records the
    rejoin + recovery wall time."""
    from autodist_tpu_torch.runtime.coord_client import CoordClient
    from autodist_tpu_torch.runtime.coordinator import WorkerSupervisor
    from autodist_tpu_torch.utils.faultline import (FaultLine, FaultPlan,
                                              InjectedFault)
    from autodist_tpu_torch.utils.profiling import health_report
    monkeypatch.setenv('AUTODIST_PEER_FAILURE_POLICY', 'restart')
    monkeypatch.setenv('AUTODIST_HEARTBEAT_TIMEOUT', '1.0')
    steps, kill_at = 6, 2
    h = _ChiefHarness(service)
    give_up = []
    sup = None
    try:
        plan = FaultPlan([{'kind': 'kill_worker', 'worker': 'p1',
                           'step': kill_at + 1, 'mode': 'raise'}],
                         seed=9)

        class _ThreadProc:
            """Popen-shaped wrapper over one peer incarnation."""

            def __init__(self):
                self._rc = None
                self._t = threading.Thread(target=self._run,
                                           daemon=True)
                self._t.start()

            def _run(self):
                try:
                    from autodist_tpu_torch.runtime.coord_client import \
                        CoordClient as _C
                    probe = _C(('127.0.0.1', service))
                    start = probe.incr('%s/step/p1' % h.ns, 0) + 1
                    probe.close()
                    _peer_loop(service, h.ns, 'p1', steps,
                               start_step=start)
                    self._rc = 0
                except InjectedFault:
                    self._rc = 137     # the crash
                except BaseException:  # noqa: BLE001 - rc drives loop
                    self._rc = 1

            def wait(self):
                self._t.join()
                return self._rc

            def poll(self):
                return None if self._t.is_alive() else self._rc

            def terminate(self):
                pass

        def fence_p1():
            c = CoordClient(('127.0.0.1', service))
            c.incr('fence/%s/p1' % h.ns, 1)
            c.close()

        def backoff_until_detected(_):
            # deterministic ordering for the assertion below: the
            # supervisor's (injectable) backoff returns only once the
            # blocked chief has DETECTED the death, so the rejoin +
            # recovery-wall-time bookkeeping is always exercised —
            # real deployments get the same interleaving from real
            # backoff seconds vs the heartbeat window
            deadline = time.time() + 60.0
            while time.time() < deadline:
                if h.sess is not None and h.sess._dead_since:
                    time.sleep(0.3)
                    return
                time.sleep(0.05)
            raise AssertionError('chief never detected the death')

        with FaultLine(plan, worker='p1') as fl:
            sup = WorkerSupervisor(
                'sim-p1', _ThreadProc, policy='restart',
                max_restarts=2, fence=fence_p1,
                on_give_up=give_up.append,
                sleep=backoff_until_detected).start()
            sess = h.create_session()
            for _ in range(steps):
                sess.run(h.train_op, {h.x: h.feed})
            w_final = sess.get_variable_value('W')
            rep = health_report(sess.health_stats, faultline=fl)
        sup.join(timeout=30.0)
        assert not give_up, 'supervisor gave up: %s' % give_up
        assert sup.restarts == 1
        assert [e['kind'] for e in fl.events] == ['kill_worker']
        # the reborn incarnation joined under generation 1 and finished
        c = CoordClient(('127.0.0.1', service))
        assert c.incr('fence/%s/p1' % h.ns, 0) == 1
        assert c.get('done/%s/p1' % h.ns) == '1'
        c.close()
        # final state matches the uninterrupted trajectory
        np.testing.assert_allclose(
            w_final, _ground_truth(h.W0, h.feed, steps),
            rtol=2e-4, atol=2e-5)
        assert rep['policy'] == 'restart'
        assert rep['missed_beats'] >= 1
        assert rep['rejoins'] == ['p1']
        assert rep['restarts_observed'] == 1
        assert len(rep['recovery_wall_s']) == 1
        assert rep['max_recovery_wall_s'] > 0.0
    finally:
        if sup is not None:
            sup.terminate()
        h.close()


def test_live_join_grows_membership_mid_run(service, monkeypatch):
    """a third worker live-JOINs a
    running 2-worker namespace through the real admit handshake; the
    chief's per-slice gate membership picks the grown world up WITHOUT
    a restart, training finishes on the ground-truth trajectory, and
    the chief records the observed join, the epoch bump and the
    simulator's predicted-vs-kept re-rank decision."""
    from autodist_tpu_torch.runtime.coord_client import CoordClient
    from autodist_tpu_torch.runtime.loose_session import admit_worker
    from autodist_tpu_torch.utils.profiling import health_report
    monkeypatch.setenv('AUTODIST_PEER_FAILURE_POLICY', 'exclude')
    monkeypatch.setenv('AUTODIST_HEARTBEAT_TIMEOUT', '2.0')
    steps = 6
    h = _ChiefHarness(service)
    try:
        stop = threading.Event()
        t_peer = threading.Thread(
            target=_peer_loop, args=(service, h.ns, 'p1', steps),
            kwargs={'interval': 0.05}, daemon=True)
        admitted = threading.Event()
        admit_rec = {}

        def joiner():
            c = CoordClient(('127.0.0.1', service))
            admit_rec.update(admit_worker(c, h.ns))
            admitted.set()
            me = admit_rec['worker']
            last = admit_rec['adopted_step']
            while not stop.wait(0.05):
                if last >= steps:
                    break
                last += 1
                c.heartbeat('%s/%s' % (h.ns, me))
                c.publish_step(me, last, prefix='%s/step/' % h.ns)
            c.set('done/%s/%s' % (h.ns, me), '1')
            c.publish_step(me, 1 << 30, prefix='%s/step/' % h.ns)
            c.close()

        t_peer.start()
        sess = h.create_session()
        for _ in range(2):
            sess.run(h.train_op, {h.x: h.feed})
        t_join = threading.Thread(target=joiner, daemon=True)
        t_join.start()
        assert admitted.wait(30.0), 'joiner never admitted'
        for _ in range(steps - 2):
            sess.run(h.train_op, {h.x: h.feed})
        w_final = sess.get_variable_value('W')
        rep = health_report(sess.health_stats)
        stop.set()
        t_peer.join(timeout=15.0)
        t_join.join(timeout=15.0)
        # the admit handshake issued the next ordinal and adopted the
        # live step floor (>= 1: both members had published)
        assert admit_rec['worker'] == 'p2'
        assert admit_rec['world'] == 3
        assert admit_rec['adopted_step'] >= 1
        assert admit_rec['admit_wall_s'] > 0.0
        # the chief adopted the grown membership mid-run
        assert rep['world'] == 3 and rep['active_workers'] == 3
        assert rep['joins'] == [{'worker': 'p2', 'epoch': 1}]
        assert rep['epoch'] >= 1 and rep['epoch_bumps'] >= 1
        # the chief re-ranked strategies for the new world size and
        # recorded predicted-vs-kept (execution keeps the plan until
        # live resharding exists)
        assert len(rep['replans']) == 1
        replan = rep['replans'][0]
        assert replan.get('error') is None, replan
        assert replan['world'] == 3 and replan['migrated'] is False
        assert replan['predicted']
        # simulated workers push no deltas: the trajectory is untouched
        np.testing.assert_allclose(
            w_final, _ground_truth(h.W0, h.feed, steps),
            rtol=2e-4, atol=2e-5)
    finally:
        h.close()


def test_join_killed_mid_admit_ghost_is_excluded(service, monkeypatch):
    """a worker killed MID-ADMIT (after the slot
    claim and epoch bump, before its step adoption) leaves survivors
    unblocked and membership consistent: the ghost is a VISIBLE member
    with no step counter and no beat, so it blocks at most one gate
    window before the never-beat rule declares it dead and the exclude
    path fences + releases its slot; a second worker joins cleanly and
    the run finishes on the ground-truth trajectory."""
    from autodist_tpu_torch.runtime.coord_client import CoordClient
    from autodist_tpu_torch.runtime.loose_session import admit_worker
    from autodist_tpu_torch.utils.faultline import (FaultLine, FaultPlan,
                                              InjectedFault)
    from autodist_tpu_torch.utils.profiling import health_report
    monkeypatch.setenv('AUTODIST_PEER_FAILURE_POLICY', 'exclude')
    monkeypatch.setenv('AUTODIST_HEARTBEAT_TIMEOUT', '1.0')
    steps = 6
    h = _ChiefHarness(service)
    try:
        stop = threading.Event()
        t_peer = threading.Thread(
            target=_peer_loop, args=(service, h.ns, 'p1', steps),
            kwargs={'interval': 0.05}, daemon=True)
        ghost_died = threading.Event()
        admitted = threading.Event()

        # fires once, on the FIRST step/p2 frame — the ghost joiner's
        # step adoption; the chief's later release of the same counter
        # passes through (the fault is spent)
        plan = FaultPlan([{'kind': 'join_kill', 'mode': 'raise',
                           'match': '%s/step/p2' % h.ns}])

        def ghost_joiner():
            c = CoordClient(('127.0.0.1', service))
            try:
                admit_worker(c, h.ns)
            except InjectedFault:
                ghost_died.set()     # claimed p2, published nothing
            finally:
                c.close()

        def live_joiner():
            ghost_died.wait(30.0)
            c = CoordClient(('127.0.0.1', service))
            admit = admit_worker(c, h.ns)
            admitted.set()
            me = admit['worker']
            last = admit['adopted_step']
            while not stop.wait(0.05):
                if last >= steps:
                    break
                last += 1
                c.heartbeat('%s/%s' % (h.ns, me))
                c.publish_step(me, last, prefix='%s/step/' % h.ns)
            c.set('done/%s/%s' % (h.ns, me), '1')
            c.publish_step(me, 1 << 30, prefix='%s/step/' % h.ns)
            c.close()

        t_peer.start()
        with FaultLine(plan) as fl:
            sess = h.create_session()
            for _ in range(2):
                sess.run(h.train_op, {h.x: h.feed})
            t_ghost = threading.Thread(target=ghost_joiner, daemon=True)
            t_live = threading.Thread(target=live_joiner, daemon=True)
            t_ghost.start()
            t_live.start()
            assert admitted.wait(30.0), 'live joiner never admitted'
            for _ in range(steps - 2):
                sess.run(h.train_op, {h.x: h.feed})
            w_final = sess.get_variable_value('W')
            rep = health_report(sess.health_stats, faultline=fl)
        stop.set()
        for t in (t_peer, t_ghost, t_live):
            t.join(timeout=15.0)
        assert ghost_died.is_set()
        assert rep['injected_join_faults'] == 1
        # the live joiner took the NEXT ordinal (the ghost's leaked)
        assert rep['world'] == 4
        # the ghost was declared dead by the never-beat rule and
        # excluded (its exclusion epoch depends on whether the second
        # join landed first); the live membership is chief + p1 + p3
        assert [e['worker'] for e in rep['exclusions']] == ['p2']
        assert rep['active_workers'] == 3
        assert sorted(j['worker'] for j in rep['joins']) == ['p2', 'p3']
        # and the math never noticed any of it
        np.testing.assert_allclose(
            w_final, _ground_truth(h.W0, h.feed, steps),
            rtol=2e-4, atol=2e-5)
    finally:
        h.close()


def test_real_session_live_joins(service, monkeypatch):
    """A REAL session created with AUTODIST_ELASTIC_JOIN=1 joins a
    running namespace end-to-end: claims the next slot, rewrites its
    identity env, skips the init barrier, pulls CURRENT params from the
    PS instead of re-seeding, adopts the published step floor, and can
    immediately train a gated step."""
    from autodist_tpu_torch.runtime.coord_client import CoordClient
    monkeypatch.setenv('AUTODIST_WORKER', '127.0.0.1')   # non-chief
    monkeypatch.setenv('AUTODIST_HEARTBEAT_TIMEOUT', '0')
    monkeypatch.setenv('AUTODIST_ELASTIC_JOIN', '1')
    h = _ChiefHarness(service)
    try:
        # a live 2-worker cohort: seeded + trained vars, published
        # steps, completed init rendezvous, seeded world counter
        c = CoordClient(('127.0.0.1', service))
        trained = np.full((h.dim, 3), 7.0, np.float32)
        c.vset('%s/var/W' % h.ns, trained)
        c.publish_step('p0', 4, prefix='%s/step/' % h.ns)
        c.publish_step('p1', 5, prefix='%s/step/' % h.ns)
        c.incr('%s/join/world' % h.ns, 2)
        c.set('%s/session/init-done' % h.ns, '1')
        monkeypatch.setenv('AUTODIST_PROCESS_ID', '7')   # advisory only
        sess = h.create_session()            # must NOT hang on barrier
        hs = sess.health_stats
        assert hs['joining'] and not hs['rejoining']
        # the claim decides identity, not the spawner's env
        assert sess._worker_name == 'p2'
        assert hs['world'] == 3 and hs['active_workers'] == 3
        assert hs['admitted']['admit_wall_s'] > 0.0
        # adopted the floor of the live members' published steps
        assert sess.step_count == 4
        assert c.incr('%s/step/p2' % h.ns, 0) == 4
        # pulled the trained params, not its init values
        np.testing.assert_array_equal(
            np.asarray(sess._local_value('W'), np.float32), trained)
        # and the epoch bump is observable to survivors
        assert c.incr('%s/epoch' % h.ns, 0) == 1
        # a gated train step runs immediately: step 5 needs
        # min(4, 5, 4) >= 5 - staleness(1) = 4
        sess.run(h.train_op, {h.x: h.feed})
        assert sess.step_count == 5
        c.close()
    finally:
        h.close()


def test_fresh_cohort_resets_stale_elastic_state(service, monkeypatch):
    """A reused service holding a crashed previous run's elastic state
    (inflated join/world counter, stale session/init-done marker) must
    not leak phantom members into a fresh run: a fresh cohort member
    never adopts world growth at init (no join can legitimately
    precede its rendezvous), and the chief deletes the stale marker
    and forces the counter back to the launch quorum before the
    barrier."""
    from autodist_tpu_torch.runtime.coord_client import CoordClient
    from autodist_tpu_torch.runtime.loose_session import LooseSession as Session
    monkeypatch.setenv('AUTODIST_HEARTBEAT_TIMEOUT', '0')
    h = _ChiefHarness(service)
    try:
        c = CoordClient(('127.0.0.1', service))
        c.incr('%s/join/world' % h.ns, 5)      # crashed-run leftovers
        c.set('%s/session/init-done' % h.ns, 'stale')
        # a fresh (non-rejoining) member racing ahead of the chief's
        # reset: its init-time refresh must NOT adopt the stale growth
        stub = Session.__new__(Session)
        stub._coord = c
        stub._ns = h.ns
        stub._worker_name = 'p1'
        stub._num_workers = 2
        stub._world = 2
        stub._is_chief = False
        stub._excluded = set()
        stub._epoch_seen = 0
        stub._health = {'joins': [], 'replans': []}
        stub._refresh_membership(adopt_growth=False)
        assert stub._world == 2 and stub._health['joins'] == []
        # the real chief then resets counter + marker at session init
        stop = threading.Event()
        t = threading.Thread(
            target=_peer_loop, args=(service, h.ns, 'p1', 1, stop),
            kwargs={'done_on_finish': False}, daemon=True)
        t.start()
        sess = h.create_session()
        assert c.incr('%s/join/world' % h.ns, 0) == 2
        assert c.get('%s/session/init-done' % h.ns) == '1'
        assert sess._world == 2
        stop.set()
        t.join(timeout=10.0)
        c.close()
    finally:
        h.close()


def test_join_refused_past_max_workers(service, monkeypatch):
    """AUTODIST_MAX_WORKERS ceilings the admit claim: a join that would
    grow membership past it is refused before anything is claimed."""
    from autodist_tpu_torch.runtime.coord_client import CoordClient
    from autodist_tpu_torch.runtime.loose_session import admit_worker
    monkeypatch.setenv('AUTODIST_MAX_WORKERS', '2')
    c = CoordClient(('127.0.0.1', service))
    ns = 'nsmax'
    c.set(ns + '/session/init-done', '1')
    c.incr(ns + '/join/world', 2)
    with pytest.raises(RuntimeError, match='AUTODIST_MAX_WORKERS'):
        admit_worker(c, ns)
    assert c.incr(ns + '/join/world', 0) == 2   # nothing claimed
    c.close()


def test_raced_over_cap_claim_is_retired_as_excluded(service,
                                                     monkeypatch):
    """The cap pre-check and the slot claim are separate RPCs: when a
    concurrent join races a claim past AUTODIST_MAX_WORKERS, the
    over-cap claim cannot be rolled back (ordinals are never
    re-issued) — it is retired as excluded + released, so any survivor
    that ever sees the slot skips it without a heartbeat window and
    live membership never exceeds the cap."""
    from autodist_tpu_torch.runtime.coord_client import (CLEAN_CLOSE_STEP,
                                                   CoordClient)
    from autodist_tpu_torch.runtime.loose_session import admit_worker
    monkeypatch.setenv('AUTODIST_MAX_WORKERS', '3')
    ns = 'nsrace'
    real = CoordClient(('127.0.0.1', service))
    real.set(ns + '/session/init-done', '1')
    real.incr(ns + '/join/world', 3)        # already AT the cap

    class RacyClient:
        """Delegating client whose first world read is one claim stale
        — the exact window between another joiner's claim and ours."""

        def __init__(self):
            self._stale = True

        def __getattr__(self, name):
            return getattr(real, name)

        def incr(self, key, delta=1):
            if delta == 0 and key.endswith('join/world') and \
                    self._stale:
                self._stale = False
                return real.incr(key, 0) - 1
            return real.incr(key, delta)

    with pytest.raises(RuntimeError, match='raced this claim'):
        admit_worker(RacyClient(), ns)
    # the over-cap slot (p3) is pre-retired: excluded marker set and
    # step counter released at the clean-close sentinel
    assert real.incr('excluded/%s/p3' % ns, 0) == 1
    assert real.incr(ns + '/step/p3', 0) == CLEAN_CLOSE_STEP
    # and it never became observable membership: no epoch bump
    assert real.incr(ns + '/epoch', 0) == 0
    real.close()


def test_session_rejoins_at_published_step(service, monkeypatch):
    """A REAL session created as a replacement (generation already
    bumped) rejoins: skips the init barrier, adopts the published step,
    and pulls the CURRENT params from the PS instead of re-seeding —
    the chief-side view of the same contract is exercised above."""
    from autodist_tpu_torch.runtime.coord_client import CoordClient
    monkeypatch.setenv('AUTODIST_WORKER', '127.0.0.1')   # non-chief
    monkeypatch.setenv('AUTODIST_HEARTBEAT_TIMEOUT', '0')
    h = _ChiefHarness(service)
    try:
        # the chief (a prior incarnation's world): seeded vars, a
        # published step, and a bumped generation for p0... here the
        # REPLACEMENT under test is the non-chief worker p1
        c = CoordClient(('127.0.0.1', service))
        trained = np.full((h.dim, 3), 7.0, np.float32)
        c.vset('%s/var/W' % h.ns, trained)
        c.publish_step('p1', 4, prefix='%s/step/' % h.ns)
        c.incr('fence/%s/p1' % h.ns, 1)     # p1 died once
        # the original cohort's init rendezvous completed (the marker
        # the chief publishes after the barrier): only then may a
        # replacement skip the barrier
        c.set('%s/session/init-done' % h.ns, '1')
        monkeypatch.setenv('AUTODIST_PROCESS_ID', '1')
        sess = h.create_session()           # must NOT hang on barrier
        assert sess._rejoining
        assert sess._generation == 1
        assert sess.step_count == 4
        hs = sess.health_stats
        assert hs['rejoining'] and hs['generation'] == 1
        # pulled the trained params, not its init values
        np.testing.assert_array_equal(
            np.asarray(sess._local_value('W'), np.float32), trained)
        c.close()
    finally:
        h.close()


def test_prebarrier_replacement_fills_barrier_slot(service,
                                                   monkeypatch):
    """A replacement for a worker that died BEFORE its cohort's init
    rendezvous completed (no init-done marker yet) must JOIN the
    barrier — filling the dead worker's slot so the cohort is not
    stranded waiting for a party that no longer exists."""
    import queue

    from autodist_tpu_torch.runtime.coord_client import CoordClient
    monkeypatch.setenv('AUTODIST_WORKER', '127.0.0.1')   # non-chief
    monkeypatch.setenv('AUTODIST_HEARTBEAT_TIMEOUT', '0')
    h = _ChiefHarness(service)
    try:
        c = CoordClient(('127.0.0.1', service))
        # p1's first incarnation crashed pre-barrier; it was fenced
        c.incr('fence/%s/p1' % h.ns, 1)
        # the chief seeded vars and is STILL blocked in the barrier
        seed = np.full((h.dim, 3), 3.0, np.float32)
        c.vset('%s/var/W' % h.ns, seed)
        errs = queue.Queue()

        def blocked_chief():
            p = CoordClient(('127.0.0.1', service))
            try:
                p.barrier('%s/session/init' % h.ns, 2, timeout_s=30.0)
            except Exception as e:  # noqa: BLE001 - reported below
                errs.put(e)
            finally:
                p.close()

        t = threading.Thread(target=blocked_chief, daemon=True)
        t.start()
        monkeypatch.setenv('AUTODIST_PROCESS_ID', '1')
        sess = h.create_session()     # joins the barrier (no marker)
        t.join(timeout=30.0)
        assert not t.is_alive(), 'cohort still stranded in the barrier'
        assert errs.empty(), errs.get()
        assert sess._rejoining and sess._generation == 1
        # and it still pulled the seeded params instead of re-seeding
        np.testing.assert_array_equal(
            np.asarray(sess._local_value('W'), np.float32), seed)
        c.close()
    finally:
        h.close()


# ---------------------------------------------------------------------------
# The epoch-swap handshake chaos matrix.
# The strategy-distribution epoch's stage -> ack-quorum -> arm ->
# boundary-apply handshake under a peer death at EVERY stage: the
# faultline kills the simulated peer at an exact protocol point, and
# the surviving chief must still converge on exactly one applied
# generation (quorum re-evaluation over live membership degrades the
# dead peer through exclude/fence).
# ---------------------------------------------------------------------------

#: The death-sentinel step the swap peer publishes to trigger its armed
#: kill_worker fault: the faultline intercepts the publish ON THE WIRE
#: (the sentinel never lands on the counter) and raises InjectedFault,
#: so the death happens at an exact handshake point rather than
#: "roughly when a sleep elapses". Below CLEAN_CLOSE_STEP so the hook
#: does not mistake it for a release.
_SWAP_DIE_STEP = 4096


def _since_run_start(events):
    """The tail of the PROCESS-WIDE flight ring belonging to the
    current session (everything after its ``run_start``): assertions
    about "this run's" swap events must not see a previous test's."""
    for i in range(len(events) - 1, -1, -1):
        if events[i].get('kind') == 'run_start':
            return events[i:]
    return events


def _swap_peer_loop(port, ns, die_at, out, stop, interval=0.03,
                    deadline_s=40.0, jax_client=True):
    """Swap-aware simulated peer: the normal worker protocol (fence,
    heartbeat, init barrier, step publishes) plus one epoch-swap
    handshake poll per step (loose_harness.ack_staged_swaps). ``die_at``
    names the handshake point at which this incarnation publishes the
    faultline's death sentinel (None = survive to a clean close):

    - ``'stage'``   on first observing a staged plan — it never acks,
                    so the quorum only fills once the death is
                    excluded out of the live membership;
    - ``'ack'``     the moment its own ack has landed;
    - ``'arm'``     on first observing the armed boundary, before its
                    counter reaches it;
    - ``'midswap'`` after publishing PAST the boundary (the chief may
                    be mid-apply when the silence starts).
    """
    if jax_client:
        from autodist_tpu.runtime import swap_keys
        from autodist_tpu.utils.loose_harness import ack_staged_swaps
    else:
        from autodist_tpu_torch.runtime import swap_keys
        from autodist_tpu_torch.utils.loose_harness import \
            ack_staged_swaps
    c = _client_mod(jax_client).CoordClient(('127.0.0.1', port))
    try:
        gen = c.incr('fence/%s/p1' % ns, 0)
        c.fence('fence/%s/p1' % ns, gen)
        c.heartbeat('%s/p1' % ns)
        c.barrier('%s/session/init' % ns, 2, timeout_s=60.0)
        seen = set()
        s = 0
        deadline = time.time() + deadline_s
        while time.time() < deadline and not stop.is_set():
            c.heartbeat('%s/p1' % ns)
            s += 1
            c.publish_step('p1', s, prefix='%s/step/' % ns)

            def die(point):
                out['died'] = {'at': point, 'step': s}
                c.publish_step('p1', _SWAP_DIE_STEP,
                               prefix='%s/step/' % ns)

            g = swap_keys.current_gen(c, ns)
            staged = bool(g) and \
                swap_keys.read_plan(c, ns, g) is not None
            if die_at == 'stage' and staged:
                die('stage')
            g, b = ack_staged_swaps(c, ns, 1, seen)
            if die_at == 'ack' and g in seen:
                die('ack')
            if die_at == 'arm' and b:
                die('arm')
            if die_at == 'midswap' and b and s >= b:
                die('midswap')
            out['step'] = s
            time.sleep(interval)
        if die_at is None:
            c.set('done/%s/p1' % ns, '1')
            c.publish_step('p1', 1 << 30, prefix='%s/step/' % ns)
    finally:
        c.close()


@pytest.mark.parametrize('die_at', ['stage', 'ack', 'arm', 'midswap'])
def test_swap_peer_killed_at_each_handshake_stage(service, monkeypatch,
                                                  die_at):
    """The swap matrix: a peer killed by a seeded faultline at
    each of the four handshake stages. The survivors converge on
    exactly ONE generation (staged once, armed once, applied at or
    after the boundary, never cancelled), the chief's trajectory stays
    the serial ground truth (a same-strategy swap moves values, never
    recomputes them), and the chief's own flight trace replays clean
    through the swap-conformance invariants."""
    from autodist_tpu.analysis import swap_conformance as jax_swapc
    from autodist_tpu_torch.analysis import swap_conformance
    from autodist_tpu.runtime import swap_keys
    from autodist_tpu.runtime.coord_client import CoordClient
    from autodist_tpu.utils.faultline import (FaultLine, FaultPlan,
                                              InjectedFault)
    monkeypatch.setenv('AUTODIST_PEER_FAILURE_POLICY', 'exclude')
    monkeypatch.setenv('AUTODIST_HEARTBEAT_TIMEOUT', '1.0')
    monkeypatch.setenv('AUTODIST_EXECUTE_REPLAN', '1')
    monkeypatch.setenv('AUTODIST_SWAP_ACK_TIMEOUT_S', '20')
    monkeypatch.setenv('AUTODIST_SWAP_MAX_RETRIES', '0')
    h = _ChiefHarness(service)
    try:
        plan = FaultPlan([{'kind': 'kill_worker', 'worker': 'p1',
                           'step': _SWAP_DIE_STEP, 'mode': 'raise'}],
                         seed=19)
        out = {}
        stop = threading.Event()

        def peer():
            try:
                _swap_peer_loop(service, h.ns, die_at, out, stop)
            except InjectedFault as e:
                out['fault'] = str(e)   # death: no done marker, silence

        t = threading.Thread(target=peer, daemon=True)
        with FaultLine(plan, worker='p1') as fl:
            t.start()
            sess = h.create_session()
            for _ in range(2):
                sess.run(h.train_op, {h.x: h.feed})
            entry = sess.request_strategy_swap(sess._plan.strategy)
            trained = 2
            deadline = time.time() + 60.0
            while time.time() < deadline and trained < 80:
                sess.run(h.train_op, {h.x: h.feed})
                trained += 1
                if entry.get('migrated') or \
                        entry.get('migration_error') or \
                        entry.get('migration_skipped'):
                    break
            w_final = sess.get_variable_value('W')
            events = _since_run_start(list(sess._flight.events()))
            # the peer publishes on its own clock: a chief that applied
            # early gives it time to reach its death point
            deadline = time.time() + 20.0
            while not out.get('fault') and time.time() < deadline:
                time.sleep(0.02)
        stop.set()
        t.join(timeout=10.0)
        assert out.get('fault'), 'faultline never killed the peer'
        assert out['died']['at'] == die_at
        assert [e['kind'] for e in fl.events] == ['kill_worker']
        # the handshake completed on the first staged generation
        assert entry.get('migrated') is True, entry
        swap = entry['swap']
        assert swap['gen'] == 1 and swap['attempts'] == 1
        assert swap['boundary'] >= 1
        assert 'swap_cancels' not in entry
        # bit-exact survivor trajectory: the swap moved state, the
        # dead peer pushed no deltas, so the chief's walk IS serial
        np.testing.assert_allclose(
            w_final, _ground_truth(h.W0, h.feed, trained),
            rtol=2e-4, atol=2e-5)
        # one generation end to end: staged once, armed once, applied
        # at/after the boundary, never cancelled
        swaps = [e for e in events if e['kind'].startswith('swap_')]
        assert [e['gen'] for e in swaps
                if e['kind'] == 'swap_stage'] == [1]
        assert [e['gen'] for e in swaps
                if e['kind'] == 'swap_arm'] == [1]
        applies = [e for e in swaps if e['kind'] == 'swap_apply']
        assert [e['gen'] for e in applies] == [1]
        assert applies[0]['step'] >= swap['boundary']
        assert not [e for e in swaps if e['kind'] == 'swap_cancel']
        # the chief's live trace conforms to the verified model
        assert swap_conformance.check_swap_events(events) == [] == \
            jax_swapc.check_swap_events(events)
        # and the wire agrees: one staged generation, still visible
        c = CoordClient(('127.0.0.1', service))
        assert swap_keys.current_gen(c, h.ns) == 1
        assert swap_keys.read_plan(c, h.ns, 1) is not None
        c.close()
    finally:
        h.close()


def test_swap_nack_cancels_cleanly(service, monkeypatch):
    """Any NACK cancels the stage: the generation's subtree is deleted
    (plan, acks, armed marker), the audit entry records the per-worker
    reason, no boundary is ever armed, and the cohort trains on under
    the old plan along the unchanged trajectory."""
    from autodist_tpu.analysis import swap_conformance as jax_swapc
    from autodist_tpu_torch.analysis import swap_conformance
    from autodist_tpu_torch.runtime import swap_keys
    from autodist_tpu_torch.runtime.coord_client import CoordClient
    monkeypatch.setenv('AUTODIST_HEARTBEAT_TIMEOUT', '0')
    monkeypatch.setenv('AUTODIST_EXECUTE_REPLAN', '1')
    monkeypatch.setenv('AUTODIST_SWAP_ACK_TIMEOUT_S', '20')
    monkeypatch.setenv('AUTODIST_SWAP_MAX_RETRIES', '0')
    h = _ChiefHarness(service)
    try:
        stop = threading.Event()

        def peer():
            c = CoordClient(('127.0.0.1', service))
            try:
                gen = c.incr('fence/%s/p1' % h.ns, 0)
                c.fence('fence/%s/p1' % h.ns, gen)
                c.heartbeat('%s/p1' % h.ns)
                c.barrier('%s/session/init' % h.ns, 2, timeout_s=60.0)
                s = 0
                nacked = False
                deadline = time.time() + 40.0
                while time.time() < deadline and not stop.is_set():
                    c.heartbeat('%s/p1' % h.ns)
                    s += 1
                    c.publish_step('p1', s, prefix='%s/step/' % h.ns)
                    g = swap_keys.current_gen(c, h.ns)
                    if g and not nacked and \
                            swap_keys.read_plan(c, h.ns, g) is not None:
                        swap_keys.write_nack(c, h.ns, g, 1,
                                             'validator says no')
                        nacked = True
                    time.sleep(0.03)
                c.set('done/%s/p1' % h.ns, '1')
                c.publish_step('p1', 1 << 30, prefix='%s/step/' % h.ns)
            finally:
                c.close()

        t = threading.Thread(target=peer, daemon=True)
        t.start()
        sess = h.create_session()
        steps = 4
        for _ in range(steps):
            sess.run(h.train_op, {h.x: h.feed})
        entry = sess.request_strategy_swap(sess._plan.strategy)
        deadline = time.time() + 30.0
        while time.time() < deadline and \
                not entry.get('migration_skipped'):
            time.sleep(0.05)
        stop.set()
        t.join(timeout=10.0)
        assert 'handshake failed' in entry.get('migration_skipped', ''), \
            entry
        assert entry['swap_cancels'] == [
            {'gen': 1, 'reason': 'nack',
             'nacks': {'p1': 'validator says no'}}]
        assert 'swap' not in entry and entry['migrated'] is False
        # the stage was withdrawn cleanly: subtree gone, counter kept
        c = CoordClient(('127.0.0.1', service))
        assert swap_keys.current_gen(c, h.ns) == 1
        assert swap_keys.read_plan(c, h.ns, 1) is None
        assert swap_keys.read_boundary(c, h.ns, 1) == 0
        c.close()
        # never armed, never applied — and the trace conforms
        events = _since_run_start(list(sess._flight.events()))
        kinds = [e['kind'] for e in events
                 if e['kind'].startswith('swap_')]
        assert 'swap_stage' in kinds and 'swap_cancel' in kinds
        assert 'swap_arm' not in kinds and 'swap_apply' not in kinds
        assert swap_conformance.check_swap_events(events) == [] == \
            jax_swapc.check_swap_events(events)
        # the old plan still trains, on the unchanged trajectory
        for _ in range(2):
            sess.run(h.train_op, {h.x: h.feed})
        np.testing.assert_allclose(
            sess.get_variable_value('W'),
            _ground_truth(h.W0, h.feed, steps + 2),
            rtol=2e-4, atol=2e-5)
    finally:
        h.close()


def test_swap_ack_timeout_cancels_and_retries(service, monkeypatch):
    """The bounded ack window: a live peer that speaks no swap
    protocol (never acks, never dies — so exclusion cannot shrink the
    quorum) forces an ack_timeout cancel; the chief retries with
    backoff under AUTODIST_SWAP_MAX_RETRIES, each retry staging a NEW
    generation, then degrades to an audit-only entry with every staged
    subtree withdrawn."""
    from autodist_tpu_torch.runtime import swap_keys
    from autodist_tpu_torch.runtime.coord_client import CoordClient
    monkeypatch.setenv('AUTODIST_HEARTBEAT_TIMEOUT', '0')
    monkeypatch.setenv('AUTODIST_EXECUTE_REPLAN', '1')
    monkeypatch.setenv('AUTODIST_SWAP_ACK_TIMEOUT_S', '0.4')
    monkeypatch.setenv('AUTODIST_SWAP_RETRY_BACKOFF_S', '0.1')
    monkeypatch.setenv('AUTODIST_SWAP_MAX_RETRIES', '1')
    h = _ChiefHarness(service)
    try:
        stop = threading.Event()
        t = threading.Thread(
            target=_peer_loop,
            args=(service, h.ns, 'p1', 10 ** 6, stop),
            kwargs={'done_on_finish': False}, daemon=True)
        t.start()
        sess = h.create_session()
        sess.run(h.train_op, {h.x: h.feed})
        entry = sess.request_strategy_swap(sess._plan.strategy)
        deadline = time.time() + 30.0
        while time.time() < deadline and \
                not entry.get('migration_skipped'):
            time.sleep(0.05)
        stop.set()
        t.join(timeout=10.0)
        assert entry.get('migration_skipped', '').endswith(
            'ack_timeout'), entry
        assert [c['gen'] for c in entry['swap_cancels']] == [1, 2]
        assert all(c['reason'] == 'ack_timeout' and not c['nacks']
                   for c in entry['swap_cancels'])
        c = CoordClient(('127.0.0.1', service))
        assert swap_keys.current_gen(c, h.ns) == 2
        assert swap_keys.read_plan(c, h.ns, 1) is None
        assert swap_keys.read_plan(c, h.ns, 2) is None
        c.close()
    finally:
        h.close()


def test_swap_delayed_ack_frame_still_converges(service, monkeypatch):
    """The delay half of the matrix: a faultline delay_conn holds the
    peer's ack SET on the wire; the ack lands late but inside the
    bounded ack window, so the handshake completes on the FIRST
    attempt — slow is not dead. The run-end purge then clears every
    swap key (a restarted run starts from generation zero)."""
    from autodist_tpu_torch.runtime import swap_keys
    from autodist_tpu_torch.runtime.coord_client import CoordClient
    from autodist_tpu_torch.utils.faultline import FaultLine, FaultPlan
    monkeypatch.setenv('AUTODIST_HEARTBEAT_TIMEOUT', '0')
    monkeypatch.setenv('AUTODIST_EXECUTE_REPLAN', '1')
    monkeypatch.setenv('AUTODIST_SWAP_ACK_TIMEOUT_S', '20')
    monkeypatch.setenv('AUTODIST_SWAP_MAX_RETRIES', '0')
    h = _ChiefHarness(service)
    try:
        plan = FaultPlan([{'kind': 'delay_conn',
                           'match': 'SET %s/swap/1/ack/1' % h.ns,
                           'at': 1, 'seconds': 1.0}], seed=19)
        out = {}
        stop = threading.Event()
        t = threading.Thread(
            target=_swap_peer_loop,
            args=(service, h.ns, None, out, stop),
            kwargs={'jax_client': False}, daemon=True)
        with FaultLine(plan, worker='p1') as fl:
            t.start()
            sess = h.create_session()
            for _ in range(2):
                sess.run(h.train_op, {h.x: h.feed})
            entry = sess.request_strategy_swap(sess._plan.strategy)
            trained = 2
            deadline = time.time() + 60.0
            while time.time() < deadline and trained < 80:
                sess.run(h.train_op, {h.x: h.feed})
                trained += 1
                if entry.get('migrated') or \
                        entry.get('migration_error') or \
                        entry.get('migration_skipped'):
                    break
        assert [e['kind'] for e in fl.events] == ['delay_conn']
        assert entry.get('migrated') is True, entry
        assert entry['swap']['gen'] == 1
        assert entry['swap']['attempts'] == 1
        assert 'swap_cancels' not in entry
        stop.set()
        t.join(timeout=10.0)
        # run-end hygiene: close purges the whole swap namespace
        sess.close()
        c = CoordClient(('127.0.0.1', service))
        assert swap_keys.current_gen(c, h.ns) == 0
        assert swap_keys.read_plan(c, h.ns, 1) is None
        c.close()
    finally:
        h.close()


def test_restarted_run_never_sees_stale_staged_plan(service,
                                                    monkeypatch):
    """A crashed prior run's staged plan, armed boundary and
    generation counter are swept by session init (swap_keys.purge_all
    before the init rendezvous): the new cohort starts from generation
    zero and can never validate — let alone apply — the dead run's
    plan against its own step floors."""
    from autodist_tpu_torch.runtime import swap_keys
    from autodist_tpu_torch.runtime.coord_client import CoordClient
    monkeypatch.setenv('AUTODIST_HEARTBEAT_TIMEOUT', '0')
    h = _ChiefHarness(service)
    try:
        c = CoordClient(('127.0.0.1', service))
        # the dead run's leftovers, staged in the SAME namespace
        swap_keys.stage_plan(c, h.ns, 3, 2, {'poison': True})
        swap_keys.arm(c, h.ns, 3, 7)
        assert swap_keys.current_gen(c, h.ns) == 3
        stop = threading.Event()
        t = threading.Thread(
            target=_peer_loop, args=(service, h.ns, 'p1', 3, stop),
            kwargs={'done_on_finish': False}, daemon=True)
        t.start()
        h.create_session()
        assert swap_keys.current_gen(c, h.ns) == 0
        assert swap_keys.read_plan(c, h.ns, 3) is None
        assert swap_keys.read_boundary(c, h.ns, 3) == 0
        stop.set()
        t.join(timeout=10.0)
        c.close()
    finally:
        h.close()
