"""The loose-mode session: the relaxed-consistency PS plane.

The counterpart of the loose half of ``autodist_tpu/runtime/session.py``
(reference between-graph execution with staleness-mode accumulators,
``ps_synchronizer.py:387-458``). Every worker is a process of its own
that runs the lock-step :class:`~autodist_tpu_torch.runtime.session.
Session`'s eager step on its own device with a replica group of one;
the variables are authoritative on the native coord service (or the
``AUTODIST_PS_ENDPOINTS`` it places them on). Around each train step the
worker

1. joins its in-flight background push (pipeline depth 2),
2. waits at the staleness gate until every worker has completed at
   least ``step - staleness`` steps (JAX ``session.py:2557-2700``),
3. pulls the variables (or takes the pull the pipeline made ahead),
4. runs the step, and
5. pushes ``new - pulled`` deltas (dense ``BADD``, row-sparse ``BSADD``
   for embedding tables whose step touched few rows, raw gradients
   through ``BSTEP`` for a PS-resident optimizer), then publishes its
   step counter.

On the card the pulled host arrays reach the device through pinned
memory (``non_blocking``), and the updated state comes back the same
way; the copies back are complete (a recorded event, synchronized)
before any host code reads them. Every torch call stays on the calling
thread: the pipeline's background thread moves bytes with sockets and
numpy only.

Around that loop sits the membership half of the plane (JAX
``session.py:103-290``, ``866-1894``): the elastic admit of a joiner
(:func:`admit_worker`) and of a non-voting serving reader
(:func:`admit_reader`); the rejoin of a supervised replacement under its
fresh fencing generation; the three peer-failure policies (``fail``
raises, ``exclude`` fences the dead worker's generation and shrinks the
gate, ``restart`` waits for the supervised replacement); snapshot parity
around every push-and-publish round, which a serving reader pins; and
the strategy re-plan, whose epoch swap stages a new plan, collects the
live peers' acks, arms a commit boundary and has every member apply it
there (the chief re-keys the PS copies whose geometry changed). Control
events go to the process's flight recorder
(:mod:`autodist_tpu_torch.telemetry.flight`).

With ``AUTODIST_TELEMETRY`` on, every worker pushes its drained span
records (``staleness_gate``, ``pull_vars``, ``push_deltas``,
``pipeline_wait``, ``step`` and the per-RPC spans) to the run's
``telemetry/`` namespace every ``AUTODIST_TELEMETRY_PUSH_EVERY`` train
steps on a background lane (JAX ``session.py:2072-2172``). The chief
runs the :class:`~autodist_tpu_torch.telemetry.monitor.CohortMonitor`
over them (straggler verdicts, the ``perf`` section of
:attr:`LooseSession.health_stats`, and the link constants its re-rank
prices with), exports the cohort's Chrome trace at close, and purges the
namespace at init and at close.
"""
import os
import threading
import time
import zlib

import numpy as np
import torch

from autodist_tpu_torch.const import DEFAULT_CHECKPOINT_DIR, ENV
from autodist_tpu_torch.frontend import graph as fe
from autodist_tpu_torch.runtime import coord_client as cc
from autodist_tpu_torch.runtime import swap_keys
from autodist_tpu_torch.runtime.cluster import (is_local_address,
                                               world_and_rank)
from autodist_tpu_torch.runtime.session import Session, to_numpy
from autodist_tpu_torch.telemetry import aggregate as _aggregate
from autodist_tpu_torch.telemetry import flight as _flight
from autodist_tpu_torch.utils import logging


#: the longest the depth-2 pipeline waits for the next step's staleness
#: bound before it pulls ahead anyway (``LooseSession._prefetch_gate``)
_PREFETCH_GATE_S = 2.0


def _close_quietly(client):
    if client is not None:
        try:
            client.close()
        except OSError:
            pass


def assign_ps_endpoints(var_plans, endpoints):
    """Map each variable to PS endpoint indices, one per shard (JAX
    ``session.py:52``).

    Placement follows the strategy's per-shard ``reduction_destination``
    (reference ps_lb_strategy.py:64-83, partitioned_ps_strategy.py:
    89-96): endpoints on the destination's host first (several on one
    host spread by the destination's ordinal), a destination on an
    unknown host by its ordinal among the sorted distinct destinations,
    a variable without one by a stable hash. Returns ``{var name:
    [endpoint index per shard]}``; a pure function, so every process
    places alike."""
    n = len(endpoints)
    hosts = [h for h, _ in endpoints]
    all_dests = set()
    for p in var_plans.values():
        if not p.is_ps:
            continue
        for s in getattr(p, 'all_syncs', [p.sync]):
            d = getattr(s, 'reduction_destination', '')
            if d:
                all_dests.add(d)
    dest_ord = {d: i for i, d in enumerate(sorted(all_dests))}

    def resolve(label, sync, is_ps):
        dest = getattr(sync, 'reduction_destination', '') if is_ps else ''
        if dest:
            dhost = dest.split(':', 1)[0]
            cands = [i for i, h in enumerate(hosts) if h == dhost]
            if cands:
                return cands[dest_ord[dest] % len(cands)]
            return dest_ord[dest] % n
        return zlib.crc32(label.encode()) % n

    out = {}
    for name, p in var_plans.items():
        syncs = list(getattr(p, 'all_syncs', [p.sync]))
        nshards = getattr(p, 'num_shards', 1)
        if nshards > 1 and len(syncs) == nshards:
            out[name] = [resolve('%s/shard%d' % (name, i), s, p.is_ps)
                         for i, s in enumerate(syncs)]
        else:
            out[name] = [resolve(name, p.sync, p.is_ps)]
    return out


def live_members_on_plane(coord, ns):
    """THE live-membership definition for namespace ``ns`` — claimed
    ordinals minus excluded slots — as ``(live, world, excluded)``.
    :func:`admit_worker`'s cap check and the coordinator's scale-up
    clamp (the JAX ``Coordinator._live_world_estimate``) both ride this one
    implementation: if the definition ever changes (e.g. counting
    done/ markers), they must move together or the clamp and the
    authoritative admit-time refusal silently disagree."""
    world = coord.incr('%s/join/world' % ns, 0)
    excluded = sum(
        1 for i in range(world)
        if coord.incr('excluded/%s/p%d' % (ns, i), 0) > 0)
    return world - excluded, world, excluded


def admit_worker(coord, ns, max_workers=None, wait_init_s=120.0,
                 launch_workers=None):
    """The live scale-UP admit handshake: join worker ``coord`` into the
    RUNNING loose-mode namespace ``ns`` (the exclusion path makes workers
    *leaving* survivable; this makes joining possible).

    One protocol, one place: the loose session joins through it when
    ``AUTODIST_ELASTIC_JOIN`` is set, and the chaos tests drive it with
    a raw client — the handshake must not be
    re-implemented per caller or the fault-injection coverage
    (``faultline``'s ``join_*`` kinds) stops meaning anything.

    Ordering is the contract (each step's placement matters):

    1. wait for ``<ns>/session/init-done`` — a join is only legal
       against a cohort whose init rendezvous completed (the world
       counter is only guaranteed seeded after it, and the chief clears
       stale markers before it).
    2. claim a worker slot: an atomic ``INCR`` of ``<ns>/join/world``
       (the same counter the launch cohort seeded to its quorum — no
       new service atomic needed). Refused when the claim would exceed
       ``AUTODIST_MAX_WORKERS``.
    3. bind the slot's fence generation BEFORE any namespace write, so
       every admit-path write is already fenceable: a joiner declared
       dead mid-admit is rejected exactly like any other zombie.
    4. compute the adopted step FLOOR: the min of live members'
       published steps (``cc.CLEAN_CLOSE_STEP`` releases and never-
       published zeros skipped) — the one value that neither blocks the
       cohort's staleness gates (a join at step 0 would stall everyone
       at ``floor + staleness``) nor claims progress ahead of any peer.
    5. bump ``<ns>/epoch`` — MEMBERSHIP BECOMES VISIBLE FIRST, then
       the floor is published and the heartbeat baseline laid down.
       This order is the one whose failure window SELF-HEALS: a joiner
       dying after the bump is a visible member with no step/beat,
       which the never-beat rule declares dead and the exclude path
       releases within one heartbeat window. The reverse order
       (step counter before membership) leaves an INVISIBLE frozen
       counter inside the gate's prefix-min that no survivor can ever
       exclude — a permanent cohort stall with no recovery path.

    Returns ``{'worker_id', 'worker', 'world', 'generation',
    'adopted_step', 'epoch', 'admit_wall_s'}``.
    """
    if max_workers is None:
        max_workers = ENV.AUTODIST_MAX_WORKERS.val
    t0 = time.monotonic()
    coord.wait_key('%s/session/init-done' % ns, timeout_s=wait_init_s)
    world_key = '%s/join/world' % ns
    # the cap bounds LIVE membership, not cumulative ordinals: the
    # monotone counter never decrements, so dead (excluded) workers
    # must hand their headroom back or a long-running job with churn
    # would ratchet itself below the ceiling it is allowed to refill.
    # (One serial INCR per ordinal: at the default 64-worker cap this
    # is a handful of round-trips paid once per admit, not per step.)
    live, before, excluded_n = live_members_on_plane(coord, ns)
    if launch_workers and before < launch_workers:
        raise RuntimeError(
            'cannot join namespace %s: its world counter (%d) is below '
            'the launch quorum (%d) — the cohort never seeded it (a '
            'stale init-done marker on a reused service, or not an '
            'elastic-capable run)' % (ns, before, launch_workers))
    if live >= max_workers:
        raise RuntimeError(
            'cannot join namespace %s: live membership (%d of %d '
            'claimed slots) is already at AUTODIST_MAX_WORKERS=%d'
            % (ns, live, before, max_workers))
    world = coord.incr(world_key, 1)
    worker_id = world - 1
    worker = 'p%d' % worker_id
    flight = _flight.recorder()
    flight.record('admit_claim', worker=worker, world=world, ns=ns)
    if world - excluded_n > max_workers:
        # the cap read above and the claim are separate RPCs, so two
        # concurrent joiners can both pass the pre-check; the LAST
        # claim lands over the cap. The claim cannot be rolled back
        # (the monotone counter never re-issues ordinals — a decrement
        # would hand the next joiner a colliding slot), so retire the
        # slot as already-excluded + released: any survivor that ever
        # sees it skips it without paying a heartbeat window, and the
        # live membership never exceeds the cap.
        coord.incr('excluded/%s/%s' % (ns, worker), 1)
        coord.publish_step(worker, cc.CLEAN_CLOSE_STEP,
                           prefix='%s/step/' % ns)
        flight.record('admit_cap_retire', worker=worker, world=world)
        raise RuntimeError(
            'cannot join namespace %s: a concurrent join raced this '
            'claim past AUTODIST_MAX_WORKERS=%d (slot %s retired as '
            'excluded)' % (ns, max_workers, worker))
    # fence binding precedes every namespace write below; generation>0
    # means this SLOT was admitted before and its holder declared dead
    # (slots are never re-issued by the monotone world counter, so that
    # only happens to a supervised re-admit of this same joiner).
    fence_key = 'fence/%s/%s' % (ns, worker)
    generation = coord.incr(fence_key, 0)
    coord.fence(fence_key, generation)
    flight.record('admit_fence_bind', worker=worker,
                  generation=generation)
    floor = None
    for i in range(worker_id):
        step = coord.incr('%s/step/p%d' % (ns, i), 0)
        if step == 0 or step >= cc.CLEAN_CLOSE_STEP:
            # never-published (a half-admitted ghost, or a cohort still
            # at step 0 — then every member reads 0 and the floor
            # degrades to 0 anyway) or a departed worker's release
            continue
        floor = step if floor is None else min(floor, step)
    # a crashed-but-not-yet-excluded peer can still be in this min, but
    # the staleness gate bounds how stale: every live counter (and so
    # any recent corpse's) is within gate_staleness of the cohort's
    # front, so adopting it costs the joiner at most `staleness` extra
    # catch-up steps — never a cohort stall
    floor = floor or 0
    # epoch bump BEFORE the step publish (see step 5 above): every
    # post-claim death must leave a VISIBLE member the exclusion
    # machinery can clean up, never an invisible counter it cannot
    epoch = coord.incr('%s/epoch' % ns, 1)
    flight.record('admit_epoch_bump', worker=worker, epoch=epoch)
    coord.publish_step(worker, floor, prefix='%s/step/' % ns)
    flight.record('admit_floor_publish', worker=worker, floor=floor)
    coord.heartbeat('%s/%s' % (ns, worker))
    wall = time.monotonic() - t0
    logging.info(
        'admitted %s into %s at epoch %d: world %d -> %d, adopted step '
        'floor %d, generation %d (%.3fs)', worker, ns, epoch, before,
        world, floor, generation, wall)
    return {'worker_id': worker_id, 'worker': worker, 'world': world,
            'generation': generation, 'adopted_step': floor,
            'epoch': epoch, 'admit_wall_s': wall}


def admit_reader(coord, ns, wait_init_s=120.0):
    """Admit a NON-VOTING serving replica into namespace ``ns`` — the
    reader half of :func:`admit_worker`, deliberately missing every
    step that makes a worker count:

    - no fence bind: readers never take writer generations (a
      read-only data connection cannot even issue FENCE —
      :class:`~autodist_tpu_torch.runtime.coord_client.ReadOnlyViolation`);
    - no ``join/world`` claim, no epoch bump, no step publish: the
      reader must be invisible to :func:`live_members_on_plane`, the
      staleness gates and every exclusion/quorum path — a reader dying
      mid-pull must cost the training cohort NOTHING, not even one
      heartbeat window of exclusion work.

    Readers claim ordinals on their own ``<ns>/serve/world`` counter
    (same monotone-claim idiom, disjoint key) and heartbeat under
    ``hb/serve/<ns>/r<i>`` — a SERVE-prefixed liveness plane the
    training cohort never scans. ``coord`` must be a WRITABLE control
    connection (the claim and beats are INCRs); the replica's bulk
    data pulls ride a separate read-only connection.

    Returns ``{'reader_id', 'reader', 'serve_world', 'admit_wall_s'}``.
    """
    t0 = time.monotonic()
    # same legality condition as a worker join: the world/step keys a
    # reader is about to poll are only guaranteed seeded (and stale
    # markers cleared) after the cohort's init rendezvous
    coord.wait_key('%s/session/init-done' % ns, timeout_s=wait_init_s)
    serve_world = coord.incr('%s/serve/world' % ns, 1)
    reader_id = serve_world - 1
    reader = 'r%d' % reader_id
    coord.heartbeat('serve/%s/%s' % (ns, reader))
    _flight.recorder().record('serve_admit', reader=reader, ns=ns,
                                 serve_world=serve_world)
    wall = time.monotonic() - t0
    logging.info('admitted serving replica %s into %s (serve world %d, '
                 'non-voting, %.3fs)', reader, ns, serve_world, wall)
    return {'reader_id': reader_id, 'reader': reader,
            'serve_world': serve_world, 'admit_wall_s': wall}


class LooseSession(Session):
    """A worker of the loose PS plane (see the module docstring).

    Args:
        graph_item: the captured program.
        plan: its :class:`ExecutionPlan`, built with ``loose=True``.
        coord: this process's :class:`~autodist_tpu_torch.runtime.
            coord_client.CoordClient` to the coord service.
        resource_spec: the run's :class:`ResourceSpec`, which the
            chief's re-rank for a grown world prices against (None:
            the re-rank is recorded as skipped).
    """

    def __init__(self, graph_item, plan, coord, resource_spec=None):
        if coord is None:
            raise RuntimeError('loose multi-process mode needs a coord '
                               'service client')
        self._coord = coord
        # the membership code below (a rejoin's re-rank) reads these
        # before the base session binds them
        self._graph_item = graph_item
        self._plan = plan
        self._resource_spec = resource_spec
        # coord keys live under the strategy id: a reused service never
        # serves a previous run's variables or counters
        self._ns = plan.strategy.id
        # the run boundary first: the admit below records flight events
        self._flight = _flight.recorder()
        self._flight.set_context(ns=self._ns)
        self._flight.record('run_start', ns=self._ns)
        # elastic scale-up: a joiner's identity is the slot the admit
        # claims (the launcher's process id is advisory); the identity
        # env is rewritten to it, so everything downstream agrees
        self._joining = False
        self._admit = None
        if ENV.AUTODIST_ELASTIC_JOIN.val:
            self._admit = admit_worker(
                coord, self._ns,
                launch_workers=ENV.AUTODIST_NUM_PROCESSES.val)
            os.environ[ENV.AUTODIST_PROCESS_ID.name] = \
                str(self._admit['worker_id'])
            os.environ[ENV.AUTODIST_NUM_PROCESSES.name] = \
                str(self._admit['world'])
            self._joining = True
        # the run's processes: a group formed by the caller, else the
        # launcher's AUTODIST_PROCESS_ID / AUTODIST_NUM_PROCESSES
        self._num_workers, self._rank = world_and_rank()
        self._worker_name = 'p%d' % self._rank
        self._flight.set_context(worker=self._worker_name)
        # a joiner is never the chief: the chief seeded the PS and owns
        # the cohort rendezvous
        self._is_chief = self._rank == 0 and not self._joining
        self._round_count = 0   # completed local-SGD sync rounds
        # -- elastic recovery (epoch-fenced membership) -----------------
        self._policy = ENV.AUTODIST_PEER_FAILURE_POLICY.val
        self._min_workers = ENV.AUTODIST_MIN_WORKERS.val
        self._excluded = set()      # peer keys dropped from membership
        self._dead_since = {}       # restart policy: key -> detect time
        # live world size: the launch quorum grown by admitted joiners
        # (the <ns>/join/world counter); gate party counts, the
        # AUTODIST_MIN_WORKERS floor, pipeline floors and the close()
        # purge quorum all re-evaluate against it
        self._world = self._num_workers
        self._health = {'policy': self._policy, 'missed_beats': 0,
                        'epoch_bumps': 0, 'exclusions': [],
                        'rejoins': [], 'recovery_wall_s': [],
                        'joins': [], 'replans': [],
                        'auto_checkpoints': 0}
        if self._joining:
            self._health['admitted'] = dict(self._admit)
        # executed re-plans: the re-rank thread stages a migration, the
        # step thread applies it at a step boundary; _pending_swap is
        # the staged epoch-swap generation this member validated (with
        # its commit boundary once armed). All under _replan_lock.
        self._replan_lock = threading.Lock()
        self._pending_replan = None
        self._pending_swap = None
        self._swap_gen_seen = 0
        self._swap_applied_gen = 0
        self._replan_threads = []
        # every write rides connections bound to this worker's fencing
        # generation; the fence and excluded counters live outside the
        # run namespace, so the run-end purge never unfences a zombie
        self._fence_key = 'fence/%s' % self._key(self._worker_name)
        self._generation = coord.incr(self._fence_key, 0)
        coord.fence(self._fence_key, self._generation)
        self._flight.set_context(generation=self._generation)
        self._flight.record('fence_bind', worker=self._worker_name,
                            generation=self._generation)
        # generation > 0: a previous incarnation was declared dead and
        # this process is its supervised replacement — it REJOINS (no
        # init barrier, params from the PS, resumes at its published
        # step); a joiner claims a fresh slot (generation 0) instead
        self._rejoining = self._generation > 0 and not self._joining
        if self._is_chief and not self._rejoining:
            # a reused service may hold a crashed previous run's
            # init-done marker and staged swap plans: clear them before
            # the rendezvous, and force the elastic world counter back
            # to the launch quorum (admits wait for init-done)
            coord.delete(self._key('session/init-done'))
            # a crashed previous run's span batches: left in place, the
            # per-worker batch counters would hand this run's collector
            # sequence numbers that decode to the dead run's spans
            coord.delete_namespace(self._key('telemetry/'))
            swap_keys.purge_all(coord, self._ns)
            cur = coord.incr(self._key('join/world'), 0)
            if cur != self._num_workers:
                coord.incr(self._key('join/world'),
                           self._num_workers - cur)
        self._epoch_seen = coord.incr(self._key('epoch'), 0)
        self._hb_peers = []
        self._refresh_membership(
            adopt_growth=self._rejoining or self._joining)
        resume = None
        if self._rejoining:
            resume = coord.incr(self._key('step/') + self._worker_name, 0)
            logging.info(
                'rejoining as %s under generation %d at published step '
                '%d (membership epoch %d)', self._worker_name,
                self._generation, resume, self._epoch_seen)
        elif self._joining:
            # the admit handshake already published this floor
            resume = self._admit['adopted_step']
        self._auto_ckpt = None
        self._auto_ckpt_every = ENV.AUTODIST_AUTO_CHECKPOINT_EVERY.val
        if self._is_chief and self._auto_ckpt_every:
            from autodist_tpu_torch.checkpoint.saver import \
                CheckpointManager
            self._auto_ckpt = CheckpointManager(
                os.path.join(DEFAULT_CHECKPOINT_DIR, 'auto', self._ns),
                max_to_keep=2, async_save=True)
        self._set_plan_sets(plan)
        self._proxy_cache = {}
        self._proxy_hits = 0
        self._shared_warned = set()
        self._shared_pushes = 0
        self._shared_spec = []
        self._sparse_stats = {
            'sparse_pushes': 0, 'rows_pushed': 0,
            'dense_bytes_avoided': 0, 'zero_push_skips': 0,
            'row_refreshes': 0, 'rows_refreshed': 0,
            'full_refreshes': 0}
        self._sparse_refresh_count = {}
        self._ps_bytes = self._ps_push_bytes = self._ps_pull_bytes = 0
        self._ps_ep_bytes = []
        self._ps_seconds = 0.0
        # i8 push: the mass the last push's quantization dropped, per
        # variable, added back into the next delta (error feedback)
        self._push_residual = {}
        self._stats_lock = threading.Lock()
        self._ps_phase = {'pull_s': 0.0, 'push_s': 0.0, 'step_s': 0.0,
                          'exposed_wait_s': 0.0, 'gate_s': 0.0,
                          'max_lag': 0, 'train_steps': 0,
                          'sync_rounds': 0, 'discarded_prefetches': 0}
        self._local_steps = max(1, plan.local_steps)
        self._window_base = None
        self._pipe = None
        self._inflight = None
        self._inflight_step = 0      # the train step the job pushes
        self._stashed_prefetch = None
        self._init_ps_endpoints(plan)
        depth = ENV.AUTODIST_PS_PIPELINE_DEPTH.val
        if depth > 2:
            logging.warning(
                'AUTODIST_PS_PIPELINE_DEPTH=%d clamps to 2: a pull must '
                'follow the previous push of the same variable '
                '(read-your-writes), so at most one step is in flight',
                depth)
            depth = 2
        self._pipeline_depth = depth
        if depth > 1:
            # the pipeline thread publishes through its own connection
            # (a CoordClient socket is not thread-safe)
            self._pipe = cc.TransferPool(
                [lambda: self._fenced_connect(coord.address)])
        super().__init__(graph_item, plan)
        if resume is not None:
            # under a local-SGD window the published counters hold sync
            # rounds: a (re)joiner resumes at that round's first step
            if self._local_steps > 1:
                self._round_count = resume
                resume *= self._local_steps
            self._step_count = resume
        self._hb_seen = {}
        self._rebuild_hb_peers()    # over the LIVE world
        self._hb_stop = None
        self._hb_thread = None
        # armed whenever heartbeats are on, even alone at launch: a
        # cohort can grow, and a joiner judges this process by its beat
        if ENV.AUTODIST_HEARTBEAT_TIMEOUT.val:
            self._start_heartbeats()
        self._init_telemetry_plane()

    def _init_telemetry_plane(self):
        """The span push's background lane (made at the first push), the
        chief's :class:`CohortMonitor` (JAX ``session.py:524-551``: only
        the chief sees the whole cohort's spans, and with telemetry off
        nobody pushes any) and, under ``AUTODIST_ROOFLINE``, this
        worker's :class:`RooflineTracker` (``:553-590``), whose records
        reach the monitor (the chief's directly, the others' as
        ``roofline`` events in their span batches)."""
        self._tel_pipe = None
        self._tel_push_handle = None
        self._tel_carry = []         # records of a step still pushing
        self._tel_pushed_bytes = 0
        self.trace_path = None      # the chief's exported cohort trace
        self._monitor = None
        self._recalibrate_every = ENV.AUTODIST_RECALIBRATE_EVERY.val
        self._last_recalibrate_step = 0
        if self._is_chief and self._tel.enabled and \
                ENV.AUTODIST_STRAGGLER_POLICY.val != 'off':
            from autodist_tpu_torch.telemetry.monitor import CohortMonitor
            self._monitor = CohortMonitor(
                client=self._coord, ns=self._ns,
                workers=lambda: ['p%d' % i for i in self._live_members()],
                flight=self._flight,
                # our own batches are tapped at drain time, never
                # fetched back off the wire
                local_worker=self._worker_name)
        self._roofline_tracker = None
        self._roofline_costs = {}
        self._last_step_cost = None
        self._last_exec_wall = 0.0
        if ENV.AUTODIST_ROOFLINE.val:
            from autodist_tpu_torch.telemetry.roofline import \
                RooflineTracker
            if self._resource_spec is not None:
                peak_flops, peak_hbm = self._resource_spec.topology.peaks()
            else:
                forced = ENV.AUTODIST_ROOFLINE_PEAKS.val
                peak_flops = forced.get('flops')
                peak_hbm = forced.get('hbm_gbps')
                peak_hbm = peak_hbm * 1e9 if peak_hbm else None
            self._roofline_tracker = RooflineTracker(
                peak_flops=peak_flops, peak_hbm_bps=peak_hbm,
                tel=self._tel, flight=self._flight,
                worker=self._worker_name)

    def _set_plan_sets(self, plan):
        """The variable sets a plan decides: proxy variables (reference
        proxy_variable.py:46-190, a worker-local cache serves the
        pre-step read, refreshed from the PS after each push), the
        PS-resident optimizer's (reference partitioner.py:570-573) and
        the row-sparse plane's (sparse-read 2-D PS variables, split on
        axis 0 when partitioned)."""
        syncs = {name: p.all_syncs for name, p in plan.var_plans.items()
                 if p.is_ps}
        self._proxy_vars = {name for name, ss in syncs.items() if any(
            getattr(s, 'local_replication', False) for s in ss)}
        self._shared_opt_vars = {name for name, ss in syncs.items() if any(
            getattr(s, 'shared_optimizer', False) for s in ss)}
        self._sparse_vars = {
            name for name, p in plan.var_plans.items()
            if p.is_ps and getattr(p.var, 'sparse_read', False)
            and len(p.var.shape) == 2
            and (p.num_shards <= 1 or p.partition_axis == 0)}

    # -- identity and membership -------------------------------------------
    def _key(self, suffix):
        return '%s/%s' % (self._ns, suffix)

    @property
    def _span_worker(self):
        # every loose worker's replica group is its own, of rank 0
        return self._worker_name

    def peer_step(self, process_id):
        """Another worker's published completed-step counter (0 if none)."""
        return self._coord.incr(self._key('step/') + 'p%d' % process_id, 0)

    def _active_workers(self):
        """Current gate membership size (self-inclusive): the live
        world minus excluded peers, re-evaluated per gate slice, so
        both shrinks and grows reach a blocked waiter mid-wait."""
        return self._world - len(self._excluded)

    def _live_members(self):
        """Worker ordinals currently in the membership — the set gate
        bounds and pipeline peer floors range over."""
        return [i for i in range(self._world)
                if self._key('p%d' % i) not in self._excluded]

    def _snap_round_open(self, client, worker):
        """Flip this worker's snapshot-parity counter
        (``<ns>/snap/<worker>``) to ODD before the sync round's first
        push frame: a serving reader pins all live writers' parities
        even, pulls, and re-reads, so a round open or completed in
        between invalidates its pull. A stale odd counter left by a
        crashed predecessor of this slot is normalized with a second
        bump: an open always ENDS odd."""
        if client.incr(self._key('snap/%s' % worker), 1) & 1 == 0:
            client.incr(self._key('snap/%s' % worker), 1)

    def _snap_round_close(self, client, worker):
        """EVEN after push + publish: the round's deltas are landed and
        counted, so a reader pinning now gets a consistent set."""
        if client.incr(self._key('snap/%s' % worker), 1) & 1:
            client.incr(self._key('snap/%s' % worker), 1)

    def _rebuild_hb_peers(self):
        self._hb_peers = [self._key('p%d' % i)
                          for i in range(self._world) if i != self._rank]

    def _refresh_membership(self, adopt_growth=True):
        """Adopt membership changes recorded on the control plane, in
        both directions (JAX ``session.py:905-987``). Grows: the
        ``join/world`` counter advanced by admitted joiners; the
        heartbeat peers and, on the chief, the strategy re-rank follow.
        Shrinks: per-worker excluded markers (atomic counters, so two
        survivors excluding two peers never lose each other's update).

        ``adopt_growth=False`` is a fresh cohort member's init call: a
        reused service may hold a crashed run's larger counter, and no
        join can precede this run's rendezvous, so it starts at the
        launch quorum and learns real growth from epoch bumps."""
        world = self._coord.incr(self._key('join/world'), 0)
        if adopt_growth and world > self._world:
            fresh = 0
            for i in range(self._world, world):
                wkey = self._key('p%d' % i)
                if self._coord.incr('excluded/%s' % wkey, 0) > 0:
                    # a slot retired at admit time (raced past the cap)
                    # or already excluded: never a live join
                    self._excluded.add(wkey)
                    continue
                fresh += 1
                self._health['joins'].append(
                    {'worker': 'p%d' % i, 'epoch': self._epoch_seen})
            if fresh:
                logging.info(
                    'membership grew: %d worker(s) joined at epoch %d '
                    '(world %d -> %d)', fresh, self._epoch_seen,
                    self._world, world)
            self._world = world
            self._rebuild_hb_peers()
            if self._is_chief and fresh:
                # off the gate's critical path (this runs inside the
                # gate's failure check): the re-rank rides a daemon
                # thread, which health_stats joins before reporting
                t = threading.Thread(
                    target=self._replan_for_world, args=(world,),
                    daemon=True, name='autodist-replan')
                self._replan_threads.append(t)
                t.start()
        for i in range(self._world):
            wkey = self._key('p%d' % i)
            if wkey in self._excluded:
                continue
            if self._coord.incr('excluded/%s' % wkey, 0) > 0:
                self._excluded.add(wkey)
        if self._key(self._worker_name) in self._excluded:
            self._flight.record('self_excluded',
                                worker=self._worker_name,
                                epoch=self._epoch_seen)
            self._flight.dump('self_excluded')
            raise RuntimeError(
                'this worker (%s) was declared dead and excluded from '
                'the run at epoch %d; its writes are fenced — exiting '
                'instead of training into rejected pushes'
                % (self._worker_name, self._epoch_seen))

    def _start_heartbeats(self):
        """A background beater on its own connection: a long step or a
        data stall on this side must not read as death to the peers
        (JAX ``session.py:730-812``); a fenced rejection stops it."""
        timeout = ENV.AUTODIST_HEARTBEAT_TIMEOUT.val
        interval = min(timeout / 4.0, 10.0)
        stop = self._hb_stop = threading.Event()
        me = self._key(self._worker_name)
        addr = self._coord.address

        def beat_loop():
            client = None
            try:
                while not stop.is_set():
                    try:
                        if client is None:
                            client = cc.connect_with_retry(
                                addr, deadline_s=interval,
                                op_timeout=min(10.0, interval))
                            client.fence(self._fence_key, self._generation)
                        client.heartbeat(me)
                    except cc.FencedWriteError:
                        logging.warning('heartbeat thread: this worker '
                                        'was fenced; beats stop here')
                        break
                    except (OSError, RuntimeError):
                        # reconnect on the next beat
                        _close_quietly(client)
                        client = None
                    stop.wait(interval)
            finally:
                _close_quietly(client)

        self._hb_thread = threading.Thread(
            target=beat_loop, daemon=True, name='autodist-heartbeat')
        self._hb_thread.start()

    def _exclude_peer(self, wkey, timeout):
        """Epoch-fenced exclusion of a dead peer (JAX
        ``session.py:1738-1799``). The zombie's writer generation is
        fenced FIRST, on every service it can write to, before the
        exclusion is observable anywhere. Then exactly one survivor
        wins the atomic claim: it releases the dead worker's step
        counter with the ``1 << 30`` sentinel a clean close publishes
        (deleting it would let a delta-0 read resurrect it at zero and
        wedge every gate) and bumps the membership epoch, which the
        other survivors adopt on their next liveness check."""
        w = wkey.rsplit('/', 1)[-1]
        if self._active_workers() - 1 < self._min_workers:
            raise RuntimeError(
                'worker %s missed heartbeats for > %.0fs but excluding '
                'it would leave %d live workers, below '
                'AUTODIST_MIN_WORKERS=%d — failing instead of shrinking'
                % (w, timeout, self._active_workers() - 1,
                   self._min_workers))
        fkey = 'fence/%s' % wkey
        self._pool.run([(ep, lambda c, k=fkey: c.incr(k, 1))
                        for ep in range(len(self._pool))])
        if tuple(self._coord.address) not in \
                [tuple(a) for a in self._ps_addrs]:
            self._coord.incr(fkey, 1)
        self._flight.record('fence_bump', worker=w, by=self._worker_name)
        claim = self._coord.incr('excluded/%s' % wkey, 1)
        self._flight.record('exclude_claim', worker=w, claim=claim,
                            by=self._worker_name)
        if claim == 1:
            self._coord.publish_step(w, cc.CLEAN_CLOSE_STEP,
                                     prefix=self._key('step/'))
            self._flight.record('release', worker=w, by=self._worker_name)
            self._epoch_seen = self._coord.incr(self._key('epoch'), 1)
            self._flight.record('epoch_bump', epoch=self._epoch_seen,
                                by=self._worker_name)
            self._health['epoch_bumps'] += 1
            logging.warning(
                'declared peer %s dead (no heartbeat for > %.0fs): '
                'generation fenced, excluded from membership — epoch '
                '%d, %d active workers remain', w, timeout,
                self._epoch_seen, self._active_workers() - 1)
        else:
            # another survivor won the claim; adopt its epoch
            self._epoch_seen = self._coord.incr(self._key('epoch'), 0)
        self._excluded.add(wkey)
        self._health['exclusions'].append(
            {'worker': w, 'epoch': self._epoch_seen})
        self._flight.dump('exclusion:%s' % w)

    def _check_peers_alive(self):
        """Liveness and the recovery policy, judged between gate slices
        (JAX ``session.py:1801-1893``). Membership changes are adopted
        first (exclusions other survivors fenced in, and joins), even
        with heartbeats off; the epoch-swap poll rides along. Then a
        peer whose beat counter has not moved for
        ``AUTODIST_HEARTBEAT_TIMEOUT`` seconds on this process's clock,
        and that did not close cleanly, is dead: ``fail`` raises,
        ``exclude`` shrinks the membership, ``restart`` waits (a truthy
        return re-arms the gate's window) for the supervised
        replacement, up to ``AUTODIST_RESTART_WAIT_S``."""
        epoch = self._coord.incr(self._key('epoch'), 0)
        if epoch != self._epoch_seen:
            self._health['epoch_bumps'] += epoch - self._epoch_seen
            self._epoch_seen = epoch
            self._refresh_membership()
            self._flight.record('epoch_adopt', epoch=epoch,
                                worker=self._worker_name)
            logging.warning('membership epoch advanced to %d: %d '
                            'active workers', epoch,
                            self._active_workers())
        self._poll_swap_stage()
        timeout = ENV.AUTODIST_HEARTBEAT_TIMEOUT.val
        if not timeout:
            return None
        self._coord.heartbeat(self._key(self._worker_name))
        peers = [w for w in self._hb_peers if w not in self._excluded]
        dead = self._coord.dead_workers(peers, timeout, self._hb_seen)
        # a peer that closed cleanly stops beating but is not a crash
        dead = [w for w in dead if self._coord.get('done/%s' % w) is None]
        # restart: a peer beating again after a declared death is its
        # reborn incarnation — record the recovery wall time
        for w in list(self._dead_since):
            if w not in dead:
                wall = time.time() - self._dead_since.pop(w)
                self._health['rejoins'].append(w.rsplit('/', 1)[-1])
                self._health['recovery_wall_s'].append(round(wall, 3))
                logging.info('peer %s is heartbeating again %.1fs after '
                             'its death was detected', w, wall)
        if not dead:
            return None
        self._health['missed_beats'] += \
            sum(1 for w in dead if w not in self._dead_since)
        if self._policy == 'exclude':
            for w in dead:
                self._exclude_peer(w, timeout)
            return None
        if self._policy == 'restart':
            now = time.time()
            wait_cap = ENV.AUTODIST_RESTART_WAIT_S.val
            for w in dead:
                short = w.rsplit('/', 1)[-1]
                if self._coord.get(
                        self._key('failed/%s' % short)) is not None:
                    raise RuntimeError(
                        'worker %s exhausted its supervised restarts '
                        '(AUTODIST_MAX_WORKER_RESTARTS) and was marked '
                        'permanently failed — aborting' % short)
                if w not in self._dead_since:
                    self._dead_since[w] = now
                    logging.warning(
                        'peer %s missed heartbeats for > %.0fs; '
                        'policy=restart: waiting for its supervised '
                        'replacement', w, timeout)
                elif now - self._dead_since[w] > wait_cap:
                    raise RuntimeError(
                        'worker %s has been dead for %.0fs with no '
                        'supervised replacement and no failed marker '
                        '(AUTODIST_RESTART_WAIT_S=%.0f) — aborting'
                        % (short, now - self._dead_since[w], wait_cap))
            return True
        raise RuntimeError(
            'worker(s) %s missed heartbeats for > %.0fs while this '
            'process waited on the staleness gate — failing fast '
            'instead of hanging' % (sorted(dead), timeout))

    # -- endpoints and placement ------------------------------------------
    def _init_ps_endpoints(self, plan):
        """One :class:`TransferPool` worker (its own connection) per
        endpoint; without ``AUTODIST_PS_ENDPOINTS`` the variables live on
        the coord service itself (JAX ``session.py:1895-1935``)."""
        eps = cc.ps_endpoints()
        self._ps_index = {}
        if eps:
            self._ps_addrs = [
                ('127.0.0.1' if is_local_address(host) else host, port)
                for host, port in eps]
            self._ps_index = assign_ps_endpoints(plan.var_plans, eps)
        else:
            self._ps_addrs = [tuple(self._coord.address)]
        self._pool = cc.TransferPool(
            [lambda addr=addr: self._fenced_connect(addr)
             for addr in self._ps_addrs])

    def _fenced_connect(self, addr):
        client = cc.connect_with_retry(addr)
        client.fence(self._fence_key, self._generation)
        return client

    def _shard_info(self, name):
        """(part_config or None, per-shard key suffixes): a partitioned
        variable lives as one tensor per shard, ``var/<name>/shard<i>``."""
        p = self._plan.var_plans.get(name)
        nshards = p.num_shards if p is not None else 1
        if nshards > 1:
            return (p.part_config,
                    ['var/%s/shard%d' % (name, i) for i in range(nshards)])
        return None, ['var/%s' % name]

    def _shard_endpoints(self, name, nshards):
        idxs = self._ps_index.get(name)
        if idxs is None:
            idxs = [zlib.crc32(name.encode()) % len(self._ps_addrs)]
            self._ps_index[name] = idxs
        if len(idxs) < nshards:
            idxs = [idxs[i % len(idxs)] for i in range(nshards)]
        return idxs

    def _transfer_groups(self, names):
        """``{endpoint: [(key suffix, name, shard, part_config)]}`` and
        the per-name shard counts."""
        groups = {}
        shard_counts = {}
        for name in names:
            pc, keys = self._shard_info(name)
            idxs = self._shard_endpoints(name, len(keys))
            shard_counts[name] = len(keys)
            for i, (key, ep) in enumerate(zip(keys, idxs)):
                groups.setdefault(ep, []).append((key, name, i, pc))
        return groups, shard_counts

    def _var(self, name):
        return self._graph_item.graph.variables[name]

    def _merged(self, name, parts):
        pc, _ = self._shard_info(name)
        if pc is None:
            return parts[0]
        return None if any(p is None for p in parts) else pc.merge(parts)

    def _wire_nbytes(self, n_elems, push=False):
        """Wire bytes of ``n_elems`` floats in one direction (i8 is a
        push-only wire: pulls ride f32)."""
        wire = cc._wire_dtype() if push else cc._pull_wire()
        return cc.wire_nbytes(n_elems, wire)

    def _account_ep_bytes(self, name):
        """Add one whole-variable pull to its endpoints' byte counts;
        the caller holds ``_stats_lock``."""
        if not self._ps_ep_bytes:
            self._ps_ep_bytes = [0] * len(self._ps_addrs)
        var = self._var(name)
        pc, keys = self._shard_info(name)
        sizes = [int(np.prod(s)) for s in (
            [var.shape] if pc is None else pc.shard_shapes(var.shape))]
        for ep, n in zip(self._shard_endpoints(name, len(keys)), sizes):
            self._ps_ep_bytes[ep] += self._wire_nbytes(n)

    # -- host <-> device ----------------------------------------------------
    def _to_device(self, name, host):
        """A pulled host value as this worker's variable state: through
        pinned memory on the card (the pinned block is not reused until
        its copy has run), a copy on the CPU."""
        dtype = self._var_state[name].dtype
        t = torch.from_numpy(np.ascontiguousarray(host))
        if self._device.type == 'cuda':
            return t.pin_memory().to(self._device, dtype=dtype,
                                     non_blocking=True)
        return t.to(dtype=dtype, copy=True)

    def _to_host(self, tensors):
        """``{name: tensor}`` -> ``{name: float32 host array}``. On the
        card every copy lands in pinned memory, and an event recorded
        after the last one is synchronized before this returns."""
        if self._device.type != 'cuda':
            return {n: t.detach().to(torch.float32).numpy().copy()
                    for n, t in tensors.items()}
        staged = {}
        for n, t in tensors.items():
            buf = torch.empty(tuple(t.shape), dtype=torch.float32,
                              pin_memory=True)
            buf.copy_(t.detach(), non_blocking=True)
            staged[n] = buf
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self._device))
        done.synchronize()
        return {n: b.numpy() for n, b in staged.items()}

    # -- state ------------------------------------------------------------
    def _init_state(self):
        """The chief seeds the PS copies; every worker beats once and
        meets the others at the init barrier; the others then start from
        what the PS serves (JAX ``session.py:2261-2320``). A replacement
        never re-seeds and skips the barrier its cohort already passed
        (it fills the dead worker's slot when the cohort has not); a
        joiner's admit already waited for the rendezvous."""
        variables = self._graph_item.graph.variables
        if self._is_chief and not self._rejoining:
            self._store_var_parts({name: v.init_value
                                   for name, v in variables.items()})
        # heartbeat baseline before the barrier: a missing one reads as
        # dead once any gate runs
        self._coord.heartbeat(self._key(self._worker_name))
        if not (self._rejoining or self._joining):
            self._coord.barrier(self._key('session/init'),
                                self._num_workers, timeout_s=120.0)
            if self._is_chief:
                self._coord.set(self._key('session/init-done'), '1')
        elif self._coord.get(self._key('session/init-done')) is None:
            # the prior incarnation died before its cohort's rendezvous
            # completed: fill its barrier slot
            self._coord.barrier(self._key('session/init'),
                                self._num_workers, timeout_s=120.0)
        if not self._is_chief or self._rejoining:
            served, _ = self._fetch_var_parts(list(variables))
            for name, parts in served.items():
                var = variables[name]
                var.init_value = self._merged(name, parts).astype(
                    np.asarray(var.init_value).dtype)
        super()._init_state()

    def _local_value(self, name):
        return to_numpy(self._var_state[name])

    # -- the step -----------------------------------------------------------
    def _extra_fetches(self, norm):
        """The synced gradients of shared-optimizer variables, pushed
        raw (``BSTEP`` applies the update with PS-resident slots)."""
        self._shared_spec, extra = [], []
        if self._shared_opt_vars:
            self._shared_spec, extra = self._shared_push_spec(norm)
        return extra

    def _before_step(self, is_train):
        """Join the pipeline, gate, pull (JAX ``session.py:2560-2650``).
        Under a local-SGD window only a window's first train step syncs;
        the steps after it, and fetch-only runs inside the window, run
        on the local state. Returns the pulled host values."""
        h = self._local_steps
        sync_run = h == 1 or (is_train and self._step_count % h == 0)
        if not sync_run:
            return None
        # join first: its error surfaces here, and our own counter and
        # pushes are current before the gate and the pull
        prefetch = self._join_pipeline()
        self._coord.heartbeat(self._key(self._worker_name))
        if is_train and self._plan.gate_enabled:
            gate_at = self._step_count + 1 if h == 1 \
                else self._round_count + 1
            staleness = self._plan.gate_staleness
            t0 = time.perf_counter()
            with self._tel.span('staleness_gate', step=gate_at,
                                worker=self._worker_name):
                # membership is a callable: a shrink or a grow while
                # blocked here re-bounds the wait
                self._coord.staleness_gate(
                    gate_at, staleness, self._active_workers,
                    prefix=self._key('step/'),
                    failure_check=self._check_peers_alive)
            waited = time.perf_counter() - t0
            lag = gate_at - min(self.peer_step(i)
                                for i in self._live_members())
            with self._stats_lock:
                self._ps_phase['gate_s'] += waited
                self._ps_phase['max_lag'] = max(self._ps_phase['max_lag'],
                                                lag)
            # a pull taken while a peer was below the bound the gate just
            # guaranteed may lack its pushes: refetch
            if prefetch is not None and \
                    prefetch['peer_floor'] < gate_at - staleness:
                self._account_prefetch_discard(prefetch)
                prefetch = None
        pulled = self._pull_ps_vars(prefetch, train=is_train)
        if h > 1:
            # the base the whole window's delta is computed against
            self._window_base = pulled
        return pulled

    def _after_step(self, outs, pulled):
        """Push the step's updates (every step, or at a window's end)."""
        with self._stats_lock:
            self._ps_phase['train_steps'] += 1
        if self._local_steps == 1:
            self._dispatch_push(outs, pulled)
        elif self._step_count % self._local_steps == 0:
            base, self._window_base = self._window_base, None
            self._dispatch_push(outs, base)
        if self._auto_ckpt is not None and \
                self._step_count % self._auto_ckpt_every == 0:
            self._auto_checkpoint()

    def _step(self, fetch_nodes, feeds):
        t0 = time.perf_counter()
        if self._roofline_tracker is None:
            outs = super()._step(fetch_nodes, feeds)
        else:
            outs = self._costed_step(fetch_nodes, feeds)
        self._last_exec_wall = time.perf_counter() - t0
        with self._stats_lock:
            self._ps_phase['step_s'] += self._last_exec_wall
        return outs

    def _costed_step(self, fetch_nodes, feeds):
        """The step, counted by ``roofline.cost_of`` the first time a
        program (these fetches at these feed shapes) runs: that call
        takes the step under the counters, the later ones reuse the
        count (JAX ``session.py:2624-2659`` counts once per compile)."""
        key = (tuple(id(n) for n in fetch_nodes),
               tuple(sorted((id(ph), tuple(v.shape), str(v.dtype))
                            for ph, v in feeds.items())))
        if key in self._roofline_costs:
            self._last_step_cost = self._roofline_costs[key]
            return Session._step(self, fetch_nodes, feeds)
        from autodist_tpu_torch.telemetry import roofline as _roofline
        box = []
        self._last_step_cost = self._roofline_costs[key] = \
            _roofline.cost_of(lambda: box.append(
                Session._step(self, fetch_nodes, feeds)))
        return box[0]

    # -- run: the swap boundary and the zombie dump ----------------------
    def run(self, fetches, feed_dict=None, options=None):
        """:meth:`Session.run`; a ``FencedWriteError`` surfacing here
        means this process is a zombie, and the flight recorder dumps
        before the error propagates. An executed train step feeds the
        roofline tracker and the chief's monitor (JAX
        ``session.py:2436-2452``)."""
        before = self._step_count
        try:
            results = super().run(fetches, feed_dict, options)
        except cc.FencedWriteError:
            self._flight.record('fenced_write_error',
                                worker=self._worker_name,
                                step=self._step_count)
            self._flight.dump('fenced_write_error')
            raise
        if self._step_count > before:
            wall = self._step_walls[-1]
            if self._roofline_tracker is not None:
                # the wall beyond the step's own execution is the gate,
                # pull and push wire time: the regime's comms share
                comms = max(0.0, wall - self._last_exec_wall) \
                    if self._last_exec_wall else None
                rec = self._roofline_tracker.observe_step(
                    self._step_count, wall, cost=self._last_step_cost,
                    comms_s=comms)
                if rec is not None and self._monitor is not None:
                    self._monitor.observe_roofline(self._worker_name, rec)
            if self._monitor is not None:
                self._monitor.observe_step(self._worker_name,
                                           self._step_count, wall)
            # after the step's own span, before the chief's poll: the
            # chief's monitor then holds every phase of its recent steps
            self._maybe_push_telemetry(self._coord, self._step_count)
            if self._monitor is not None:
                self._maybe_poll_monitor()
        return results

    @property
    def monitor(self):
        """The chief's :class:`~autodist_tpu_torch.telemetry.monitor.
        CohortMonitor` (None off-chief, with telemetry off, or under
        ``AUTODIST_STRAGGLER_POLICY=off``). Its :meth:`metrics` is the
        ``metrics_source`` of ``Coordinator.autoscaler``."""
        return self._monitor

    def _maybe_poll_monitor(self):
        """The chief's monitor cadence (JAX ``session.py:2466-2497``):
        poll the cohort's new span batches every
        ``AUTODIST_TELEMETRY_PUSH_EVERY`` steps (batches land on that
        cadence) and refit the link constants every
        ``AUTODIST_RECALIBRATE_EVERY`` steps. Never fatal."""
        mon = self._monitor
        every = max(1, ENV.AUTODIST_TELEMETRY_PUSH_EVERY.val or 8)
        if self._step_count % every:
            return
        try:
            mon.poll()
            if self._recalibrate_every and \
                    self._step_count - self._last_recalibrate_step >= \
                    self._recalibrate_every:
                from autodist_tpu_torch.simulator.cost_model import \
                    CostModelParams
                rs = self._resource_spec
                base = CostModelParams.from_topology(rs.topology) \
                    if rs is not None else CostModelParams()
                cross = rs.topology.multi_node if rs is not None \
                    else False
                if mon.recalibrate(base, num_replicas=max(2, self._world),
                                   cross_node=cross,
                                   step=self._step_count) is not None:
                    self._last_recalibrate_step = self._step_count
        except Exception as e:  # noqa: BLE001 - advisory plane
            logging.warning('cohort monitor poll at step %d failed: '
                            '%s: %s', self._step_count,
                            type(e).__name__, e)

    def _run_fetches(self, fetches, feed_dict=None, options=None):
        """A staged re-plan, and an armed epoch swap whose boundary this
        run reaches, apply before anything touches the plan."""
        if self._closed:
            raise RuntimeError('Session is closed')
        if self._pending_replan is not None:
            self._apply_pending_replan()
        self._poll_swap_stage()
        self._apply_pending_swap()
        return super()._run_fetches(fetches, feed_dict, options)

    # -- re-plan and the epoch swap ----------------------------------------
    def _replan_for_world(self, world):
        """On a grow, re-rank strategies for the new world with the
        simulator (the port's ``AutoStrategy``) and record the
        predicted-vs-kept decision (JAX ``session.py:988-1064``). With
        ``AUTODIST_EXECUTE_REPLAN`` a migratable re-plan (the PS family,
        the relaxed flags kept) is staged through the epoch swap. Once
        the chief's monitor has refit the link constants from live
        traffic, the re-rank prices with those (``cost_constants:
        'measured'``, with the ``cost_alpha_beta`` it used), else with
        the analytic ones. Never fatal."""
        entry = {'world': world,
                 'kept': dict(getattr(self._plan.strategy, 'cost', None)
                              or {}).get('builder', ''),
                 'migrated': False}
        try:
            rs = self._resource_spec
            if rs is None:
                entry['skipped'] = 'no resource spec on the session'
            else:
                from autodist_tpu_torch.strategy.builders import \
                    AutoStrategy
                params = self._monitor.calibrated_params() \
                    if self._monitor is not None else None
                entry['cost_constants'] = \
                    'measured' if params is not None else 'analytic'
                if params is not None:
                    a, b = params.link(cross_node=rs.topology.multi_node)
                    entry['cost_alpha_beta'] = {
                        'alpha_s': a, 'beta_s_per_byte': b}
                auto = AutoStrategy(num_replicas=world, cost_params=params)
                best = auto.build(self._graph_item, rs)
                cost = dict(getattr(best, 'cost', None) or {})
                entry['predicted'] = cost.get('builder', '')
                entry['predicted_step_time_s'] = \
                    cost.get('predicted_step_time_s')
                entry['kept_predicted_step_time_s'] = next(
                    (c.report.predicted_step_time_s
                     for c in auto.last_ranked
                     if c.name == entry['kept'] and c.report is not None),
                    None)
                execute = ENV.AUTODIST_EXECUTE_REPLAN.val
                logging.info(
                    're-ranked strategies for world=%d: predicted best '
                    '%s (%.4gs/step), kept %s%s', world,
                    entry['predicted'],
                    entry['predicted_step_time_s'] or float('nan'),
                    entry['kept'] or '(hand-picked)',
                    ' — staging the migration' if execute else
                    ' (AUTODIST_EXECUTE_REPLAN off: audit only)')
                if execute:
                    mig = self._build_migratable_strategy(world, rs,
                                                          params=params)
                    if mig is None:
                        entry['migration_skipped'] = \
                            'no PS-family candidate for this strategy'
                    else:
                        entry['migration_staged'] = dict(
                            getattr(mig, 'cost', None) or {}) \
                            .get('builder', '')
                        self._flight.record(
                            'replan_staged', world=world,
                            builder=entry['migration_staged'])
                        self._stage_swap(mig, world, entry)
        except Exception as e:  # noqa: BLE001 - advisory, never fatal
            entry['error'] = '%s: %s' % (type(e).__name__, e)
            logging.warning('strategy re-rank for world=%d failed: %s',
                            world, entry['error'])
        self._health['replans'].append(entry)

    def _build_migratable_strategy(self, world, rs, params=None):
        """The best strategy this live session can migrate to: the PS
        family with the current strategy's relaxed flags kept (sync,
        staleness, shared_optimizer, proxy), so the re-plan stays loose.
        Re-keyed shards are legal: the epoch swap applies the plan at
        one boundary on every member. None when the strategy carries no
        PS sync or no candidate ranks."""
        from autodist_tpu_torch.simulator import search
        from autodist_tpu_torch.strategy import builders as b
        from autodist_tpu_torch.strategy.base import PSSynchronizer
        flags = None
        for node in self._plan.strategy.node_config:
            for sync in [node.synchronizer] + list(node.part_config):
                if isinstance(sync, PSSynchronizer):
                    flags = {'sync': sync.sync,
                             'staleness': sync.staleness,
                             'shared_optimizer': sync.shared_optimizer,
                             'local_proxy_variable':
                                 sync.local_replication}
                    break
            if flags is not None:
                break
        if flags is None:
            return None
        cands = [
            ('PS', lambda: b.PS(**flags)),
            ('PSLoadBalancing', lambda: b.PSLoadBalancing(**flags)),
            ('PartitionedPS', lambda: b.PartitionedPS(**flags)),
            ('UnevenPartitionedPS',
             lambda: b.UnevenPartitionedPS(**flags)),
        ]
        feasible, _ = search.rank(self._graph_item, rs, candidates=cands,
                                  params=params, num_replicas=world)
        if feasible:
            return feasible[0].strategy
        logging.info('executed re-plan: no PS-family candidate ranked '
                     'for world=%d; keeping the current plan', world)
        return None

    def _apply_pending_replan(self):
        with self._replan_lock:
            pending, self._pending_replan = self._pending_replan, None
        if pending is not None:
            self._execute_replan(**pending)

    @staticmethod
    def _ps_geometry(plan, name):
        """A variable's data-plane key layout under ``plan``."""
        p = plan.var_plans.get(name)
        nshards = getattr(p, 'num_shards', 1) if p is not None else 1
        if nshards > 1:
            return ['var/%s/shard%d' % (name, i) for i in range(nshards)]
        return ['var/%s' % name]

    def _new_plan(self, strategy):
        """``strategy`` pruned to this graph and its loose
        :class:`ExecutionPlan` on this worker's replica group."""
        from autodist_tpu_torch.parallel.plan import ExecutionPlan
        from autodist_tpu_torch.strategy.base import StrategyCompiler
        compiled = StrategyCompiler(self._graph_item).prune(strategy)
        return compiled, ExecutionPlan(
            compiled, self._graph_item, self._plan.group,
            topology=self._plan.topology, loose=True)

    def _validate_swap_strategy(self, strategy, world):
        """Can THIS member execute ``strategy`` live? Builds its plan as
        :meth:`_execute_replan` will at apply time, so a failure shows
        at ack time, where a NACK still cancels the swap cleanly; a
        plan that flips any variable's update-sharding is refused."""
        compiled, new_plan = self._new_plan(strategy)
        wus_moved = self._wus_moved(new_plan)
        if wus_moved:
            raise RuntimeError(
                'weight-update-sharding layout changes for %s — flat '
                'slot shards need their own conversion pass'
                % sorted(wus_moved)[:4])
        return compiled, new_plan

    def _wus_moved(self, new_plan):
        return [name for name in self._graph_item.graph.variables
                if getattr(self._plan.var_plans.get(name),
                           'update_sharded', False) !=
                getattr(new_plan.var_plans.get(name),
                        'update_sharded', False)]

    def _live_ack_peers(self, client):
        """The peers whose ACK the staged plan needs now: the live
        membership (re-read every poll) minus this worker and minus
        peers that closed cleanly."""
        out = []
        for i in self._live_members():
            if i == self._rank:
                continue
            w = 'p%d' % i
            if client.get('done/%s' % self._key(w)) is not None:
                continue
            if client.incr(self._key('step/') + w, 0) >= \
                    cc.CLEAN_CLOSE_STEP:
                continue
            out.append(i)
        return out

    def request_strategy_swap(self, strategy, world=None):
        """Trigger a cohort-wide migration to ``strategy`` (a built
        Strategy): the epoch-swap handshake runs on a background thread
        and this returns the audit entry, which gains ``swap`` once the
        boundary is armed and ``migration`` once applied here."""
        world = world if world is not None else self._world
        entry = {'world': world,
                 'kept': dict(getattr(self._plan.strategy, 'cost',
                                      None) or {}).get('builder', ''),
                 'migrated': False, 'requested': True}
        self._health['replans'].append(entry)
        t = threading.Thread(
            target=self._stage_swap, args=(strategy, world, entry),
            daemon=True, name='autodist-swap-stage')
        self._replan_threads.append(t)
        t.start()
        return entry

    def _stage_swap(self, strategy, world, entry):
        """Chief half of the epoch swap (JAX ``session.py:1230-1339``):
        stage -> the ack quorum over LIVE membership -> arm the commit
        boundary. A NACK or an ack timeout cancels the stage and retries
        after ``AUTODIST_SWAP_RETRY_BACKOFF_S``, at most
        ``AUTODIST_SWAP_MAX_RETRIES`` times, then degrades to an audit
        entry. Runs on a background thread with its own fenced
        connection, and touches the control plane only. Never fatal."""
        ack_timeout = ENV.AUTODIST_SWAP_ACK_TIMEOUT_S.val
        backoff = ENV.AUTODIST_SWAP_RETRY_BACKOFF_S.val
        max_retries = ENV.AUTODIST_SWAP_MAX_RETRIES.val
        builder = dict(getattr(strategy, 'cost', None)
                       or {}).get('builder', '')
        client = None
        try:
            # a chief that arms a plan it later refuses forks the cohort
            self._validate_swap_strategy(strategy, world)
            client = self._fenced_connect(self._coord.address)
            for attempt in range(max_retries + 1):
                gen = swap_keys.current_gen(client, self._ns) + 1
                swap_keys.stage_plan(client, self._ns, gen, world,
                                     strategy)
                self._flight.record('swap_stage', gen=gen, world=world,
                                    builder=builder)
                logging.info(
                    'epoch swap gen %d staged for world=%d (%s); '
                    'waiting for the peer ack quorum', gen, world,
                    builder or 'hand-staged')
                deadline = time.time() + ack_timeout
                quorum, nacks = False, {}
                while time.time() < deadline:
                    peers = self._live_ack_peers(client)
                    acked, nacks = swap_keys.read_acks(
                        client, self._ns, gen, peers)
                    if nacks:
                        break
                    if len(acked) == len(peers):
                        quorum = True
                        break
                    time.sleep(0.05)
                if not quorum:
                    reason = 'nack' if nacks else 'ack_timeout'
                    swap_keys.cancel(client, self._ns, gen)
                    self._flight.record(
                        'swap_cancel', gen=gen, reason=reason,
                        detail=str(sorted(nacks.items()))[:256])
                    entry.setdefault('swap_cancels', []).append(
                        {'gen': gen, 'reason': reason,
                         'nacks': {('p%d' % w): r
                                   for w, r in nacks.items()}})
                    logging.warning(
                        'epoch swap gen %d cancelled (%s%s)%s', gen,
                        reason, ': %s' % nacks if nacks else '',
                        '; retrying after %.1fs' % backoff
                        if attempt < max_retries else '')
                    if attempt < max_retries:
                        time.sleep(backoff)
                        continue
                    entry['migration_skipped'] = (
                        'epoch-swap handshake failed after %d '
                        'attempt(s): %s' % (attempt + 1, reason))
                    return
                # the boundary floors: the LIVE members' published
                # counters (rounds under a local-SGD window)
                floors = []
                for i in self._live_members():
                    f = client.incr(self._key('step/') + 'p%d' % i, 0)
                    if f < cc.CLEAN_CLOSE_STEP:
                        floors.append(f)
                if not floors:
                    floors = [self._step_count if self._local_steps == 1
                              else self._round_count]
                boundary = swap_keys.compute_boundary(
                    floors, self._plan.gate_staleness)
                swap_keys.arm(client, self._ns, gen, boundary)
                self._flight.record('swap_arm', gen=gen,
                                    boundary=boundary, floor=min(floors))
                with self._replan_lock:
                    self._pending_swap = {
                        'gen': gen, 'strategy': strategy,
                        'world': world, 'boundary': boundary,
                        'entry': entry}
                entry['swap'] = {'gen': gen, 'boundary': boundary,
                                 'attempts': attempt + 1}
                logging.info(
                    'epoch swap gen %d armed: boundary step %d (floor %d '
                    '+ staleness %d + 2)', gen, boundary, min(floors),
                    self._plan.gate_staleness)
                return
        except Exception as e:  # noqa: BLE001 - advisory, never fatal
            entry['migration_skipped'] = \
                'epoch-swap staging failed: %s: %s' \
                % (type(e).__name__, e)
            logging.warning('epoch-swap staging for world=%d failed: %s',
                            world, entry['migration_skipped'])
        finally:
            _close_quietly(client)

    def _poll_swap_stage(self):
        """Member half of the handshake, on every run start and every
        gate slice (JAX ``session.py:1341-1399``): validate and ACK (or
        NACK) a newly staged generation, and pick up its armed
        boundary. One counter read on the fast path; never raises."""
        if not ENV.AUTODIST_EXECUTE_REPLAN.val:
            return
        try:
            gen = swap_keys.current_gen(self._coord, self._ns)
            if gen <= 0:
                return
            with self._replan_lock:
                pending = self._pending_swap
                if pending is not None and pending['gen'] < gen:
                    # superseded: cancelled and re-staged by the chief
                    self._pending_swap = pending = None
            if not self._is_chief and gen > self._swap_gen_seen and \
                    gen > self._swap_applied_gen:
                self._swap_gen_seen = gen
                staged = swap_keys.read_plan(self._coord, self._ns, gen)
                if staged is None:
                    return   # cancelled between counter and plan read
                _, world, strategy = staged
                try:
                    self._validate_swap_strategy(strategy, world)
                except Exception as e:  # noqa: BLE001 - NACK carries it
                    reason = '%s: %s' % (type(e).__name__, e)
                    swap_keys.write_nack(self._coord, self._ns, gen,
                                         self._rank, reason)
                    self._flight.record('swap_nack', gen=gen,
                                        worker=self._worker_name,
                                        reason=reason[:256])
                    logging.warning('epoch swap gen %d NACKed: %s', gen,
                                    reason)
                    return
                swap_keys.write_ack(self._coord, self._ns, gen,
                                    self._rank)
                self._flight.record('swap_ack', gen=gen,
                                    worker=self._worker_name)
                with self._replan_lock:
                    self._pending_swap = pending = {
                        'gen': gen, 'strategy': strategy,
                        'world': world, 'boundary': 0, 'entry': None}
            if pending is not None and not pending['boundary']:
                b = swap_keys.read_boundary(self._coord, self._ns,
                                            pending['gen'])
                if b:
                    with self._replan_lock:
                        pending['boundary'] = b
        except Exception as e:  # noqa: BLE001 - the poll must not fail
            logging.debug('epoch-swap poll failed: %s: %s',
                          type(e).__name__, e)

    def _apply_pending_swap(self):
        """Apply an armed swap at the start of step B (sync round B
        under a local-SGD window). A member whose counter resumed past
        the boundary (a supervised restart) applies on its first run."""
        with self._replan_lock:
            pending = self._pending_swap
            if pending is None or not pending.get('boundary'):
                return
            h = self._local_steps
            nxt = self._step_count + 1 if h == 1 \
                else self._round_count + 1
            if nxt < pending['boundary'] or \
                    (h > 1 and self._step_count % h != 0):
                return
            self._pending_swap = None
        entry = pending.get('entry')
        if entry is None:
            # non-chief members audit the swap too
            entry = {'world': pending['world'],
                     'kept': dict(getattr(self._plan.strategy, 'cost',
                                          None) or {}).get('builder', ''),
                     'migrated': False,
                     'swap': {'gen': pending['gen'],
                              'boundary': pending['boundary']}}
            self._health['replans'].append(entry)
        self._execute_replan(pending['strategy'], pending['world'],
                             entry, swap=pending)

    def _await_published(self, floor):
        """Block until every live member has published ``floor`` or more
        (a staleness gate at staleness 0), adopting exclusions and joins
        and applying the peer-failure policy meanwhile."""
        self._coord.staleness_gate(
            floor, 0, self._active_workers, prefix=self._key('step/'),
            failure_check=self._check_peers_alive)

    def _refuse_replan(self, entry, world, reason, detail):
        entry['migration_skipped'] = detail
        logging.warning('executed re-plan for world=%d refused: %s',
                        world, detail)
        self._flight.record('replan_refused', world=world, reason=reason)
        self._flight.dump('replan_refusal')

    def _execute_replan(self, strategy, world, entry, swap=None):
        """Migrate this session's live state to ``strategy`` at a step
        boundary (JAX ``session.py:1433-1736``): build the new plan on
        this worker's group, move every variable and every optimizer
        slot shaped like it (LazyAdam's moments among them) through
        :mod:`~autodist_tpu_torch.parallel.reshard` (values moved,
        never recomputed), re-init compressor aux state whose contract
        changed, and swap the plan.

        Without ``swap`` the data plane is untouched, so a plan that
        re-keys a variable or moves it between PS endpoints is refused.
        With ``swap`` (an armed epoch swap) re-keying is legal: the
        chief copies the authoritative PS values of every re-keyed
        variable from the old keys to the new ones (``BSET``) and
        publishes a ready marker the others wait on before their first
        pull under the new plan; the whole apply is bracketed by
        snapshot parity, so no serving reader accepts a pull that
        straddles it. The chief copies only once every live member has
        published the step before the boundary, so no member's push of
        an earlier step lands on the old keys after the copy. Everything
        fallible runs before the swap; a failure keeps the old plan — except past an armed boundary,
        where the other members are applying this plan and training on
        against the old keys would fork the model, so it re-raises."""
        from autodist_tpu_torch.parallel import reshard as reshard_mod
        t0 = time.perf_counter()
        old_plan = self._plan
        try:
            compiled, new_plan = self._new_plan(strategy)
            # a mid-flight background push/pull rides the old placement
            if self._pipe is not None:
                pre = self._join_pipeline()
                if pre is not None:
                    self._account_prefetch_discard(pre)
            variables = list(self._graph_item.graph.variables)
            moved_geom = [name for name in variables
                          if self._ps_geometry(old_plan, name) !=
                          self._ps_geometry(new_plan, name)]
            if moved_geom and swap is None:
                return self._refuse_replan(
                    entry, world, 'shard_geometry',
                    'shard geometry changes for %s — re-keying a live '
                    'data plane needs cohort-wide propagation'
                    % sorted(moved_geom)[:4])
            wus_moved = self._wus_moved(new_plan)
            if wus_moved:
                return self._refuse_replan(
                    entry, world, 'weight_update_sharding',
                    'weight-update-sharding layout changes for %s — '
                    'flat slot shards need their own conversion pass'
                    % sorted(wus_moved)[:4])
            ops = reshard_mod.plan_reshard(old_plan, new_plan)
            fns = {op.var_name: reshard_mod.reshard_fn(op, old_plan,
                                                       new_plan)
                   for op in ops}
            new_vars = {name: fns[name](t) if name in fns else t
                        for name, t in self._var_state.items()}
            new_opt = {}
            for uid, by_var in self._opt_state.items():
                new_by_var = {}
                for vname, leafstate in by_var.items():
                    fn = fns.get(vname)
                    phys = old_plan.padded_shape(vname)
                    new_by_var[vname] = {
                        k: fn(leaf) if fn is not None and phys is not None
                        and torch.is_tensor(leaf)
                        and tuple(leaf.shape) == tuple(phys) else leaf
                        for k, leaf in leafstate.items()}
                new_opt[uid] = new_by_var
            # compressor aux state: carried where its keys and shapes
            # hold, re-initialized elsewhere (one step of error
            # feedback at worst, the bound of a worker restart)
            new_aux = {}
            for name, vplan in new_plan.var_plans.items():
                aux = vplan.compressor.init_state(
                    np.asarray(vplan.var.init_value))
                if not aux:
                    continue
                key = 'compressor/%s' % name
                old = self._aux_state.get(key)
                if old is not None and set(old) == set(aux) and all(
                        tuple(old[k].shape) == tuple(v.shape)
                        for k, v in aux.items()):
                    new_aux[key] = old
                else:
                    new_aux[key] = {k: v.to(self._device)
                                    for k, v in aux.items()}
            new_ps_index = self._ps_index
            moved_eps = []
            eps = cc.ps_endpoints()
            if eps:
                new_ps_index = assign_ps_endpoints(new_plan.var_plans, eps)
                moved_eps = [name for name in variables
                             if self._ps_index.get(name) is not None
                             and new_ps_index.get(name) !=
                             self._ps_index.get(name)]
                if moved_eps and swap is None:
                    return self._refuse_replan(
                        entry, world, 'endpoint_placement',
                        'endpoint placement moves for %s — needs '
                        'cohort-wide propagation' % sorted(moved_eps)[:4])
            # ---- swap (everything above was built on the side) ----
            rekeyed = sorted(set(moved_geom) | set(moved_eps)) \
                if swap is not None else []
            auth = {}
            if swap is not None:
                self._snap_round_open(self._coord, self._worker_name)
            if rekeyed and self._is_chief:
                # the authoritative values are the PS copies under the
                # OLD keys, read before the plan flips _shard_info, and
                # only once every live member's pushes of the steps
                # before the boundary have landed there (a member may
                # still be up to `staleness` steps behind: its late push
                # would land on keys nobody reads again)
                self._await_published(
                    (self._step_count if self._local_steps == 1
                     else self._round_count))
                parts, _ = self._fetch_var_parts(rekeyed)
                for name in rekeyed:
                    got = parts.get(name, [None])
                    if any(p is None for p in got):
                        # never stored: the local copy is the best value
                        auth[name] = self._local_value(name)
                    else:
                        auth[name] = self._merged(name, got)
            self._plan = new_plan
            self._var_state = new_vars
            self._opt_state = new_opt
            self._aux_state = new_aux
            self._proxy_cache = {}
            self._set_plan_sets(new_plan)
            self._ps_index = new_ps_index
            if swap is not None:
                try:
                    if self._is_chief:
                        if auth:
                            # BSET resets each new key wholesale; the old
                            # keys become inert (a zombie's old-plan
                            # pushes land where nobody reads)
                            self._store_var_parts(auth)
                        swap_keys.mark_ready(self._coord, self._ns,
                                             swap['gen'])
                    elif rekeyed:
                        # the first new-plan pull must not race the
                        # chief's re-key
                        swap_keys.wait_ready(
                            self._coord, self._ns, swap['gen'],
                            ENV.AUTODIST_SWAP_ACK_TIMEOUT_S.val)
                finally:
                    self._snap_round_close(self._coord,
                                           self._worker_name)
                self._swap_applied_gen = swap['gen']
                self._flight.record(
                    'swap_apply', gen=swap['gen'],
                    worker=self._worker_name, boundary=swap['boundary'],
                    step=self._step_count + 1 if self._local_steps == 1
                    else self._round_count + 1)
            entry['migrated'] = True
            entry['migration'] = {
                'world': world,
                'builder': dict(getattr(strategy, 'cost', None)
                                or {}).get('builder', ''),
                'strategy_id': compiled.id,
                'reshard': reshard_mod.summarize(ops),
                'rekeyed_vars': len(rekeyed),
                # bytes the re-key wrote under the new keys
                'rekey_ps_bytes': int(sum(
                    np.asarray(v).nbytes for v in auth.values())),
                'wall_s': round(time.perf_counter() - t0, 4)}
            self._flight.record(
                'replan_swap', world=world,
                builder=entry['migration']['builder'],
                wall_s=entry['migration']['wall_s'])
            self._tel.record_span('replan_swap', t0,
                                  time.perf_counter() - t0, world=world,
                                  worker=self._worker_name)
            logging.info(
                'executed re-plan for world=%d: migrated to %s in %.3fs '
                '(%s)', world,
                entry['migration']['builder'] or compiled.id,
                entry['migration']['wall_s'],
                entry['migration']['reshard'])
        except Exception as e:  # noqa: BLE001 - keep the old plan
            entry['migration_error'] = '%s: %s' % (type(e).__name__, e)
            self._plan = old_plan
            logging.warning(
                'executed re-plan for world=%d failed (%s); keeping the '
                'current plan', world, entry['migration_error'])
            self._flight.record('replan_failed', world=world,
                                error=entry['migration_error'])
            self._flight.dump('replan_failure')
            if swap is not None:
                raise
        return None

    # -- the pipeline -------------------------------------------------------
    def _join_pipeline(self):
        """Join the in-flight push job (depth 2) and return its prefetch
        record; its error re-raises here. The time blocked is wire time
        the pipeline did not hide (``overlap_frac``)."""
        job = self._inflight
        if job is None:
            stash, self._stashed_prefetch = self._stashed_prefetch, None
            return stash
        self._inflight = None
        t0 = time.perf_counter()
        record = None
        try:
            record = job.result()
            return record
        finally:
            t1 = time.perf_counter()
            blocked = t1 - t0
            with self._stats_lock:
                self._ps_phase['exposed_wait_s'] += blocked
            # the wait's share that the job spent pushing or at the next
            # step's gate is charged to those spans (push_deltas,
            # staleness_gate): the pipeline's own is the rest (publish,
            # the pull-ahead), so a slow push reads as push
            rec = record or {}
            charged = max(0.0, min(t1, rec.get('push_end', t0)) - t0)
            if rec.get('gate'):
                g0, g1 = rec['gate']
                charged += max(0.0, min(t1, g1) - max(t0, g0))
            own = max(0.0, blocked - charged)
            self._tel.record_span('pipeline_wait', t1 - own, own,
                                  step=self._step_count + 1,
                                  worker=self._worker_name,
                                  blocked_s=blocked)

    def _drain_pipeline(self, keep_prefetch=False):
        """Join any in-flight work before a user-facing read or write; a
        read keeps the prefetch for the next run, a load discards it."""
        record = self._join_pipeline()
        if record is not None and not keep_prefetch:
            self._account_prefetch_discard(record)
            record = None
        self._stashed_prefetch = record if keep_prefetch else None

    def _dispatch_push(self, outs, pulled):
        """Ship the step's updates, then publish (JAX
        ``session.py:2762-2853``). The updated state and the shared
        gradients come to the host here, on the calling thread. Depth 1
        pushes and publishes in line; depth 2 hands push, publish and
        the next step's pull-ahead to the pipeline thread. Either way
        push precedes publish (the gate counts only landed steps) and
        the next pull (read-your-writes). Under a local-SGD window a
        dispatch is a sync round, and with ``AUTODIST_LOCAL_SGD_AVERAGE``
        each window delta is scaled by 1/W so the PS lands the mean."""
        h = self._local_steps
        scale = None
        if h > 1:
            self._round_count += 1
            step = self._round_count
            if ENV.AUTODIST_LOCAL_SGD_AVERAGE.val:
                scale = 1.0 / max(1, len(self._live_members()))
        else:
            step = self._step_count
        tstep = self._step_count
        shared_names = {name for name, *_ in self._shared_spec}
        tensors = {name: self._var_state[name] for name in pulled
                   if name not in shared_names}
        for name, idx, _, _ in self._shared_spec:
            tensors['grad:' + name] = outs[idx]
        host = self._to_host(tensors)
        afters = {name: host[name] for name in pulled
                  if name not in shared_names}
        shared = {name: (host['grad:' + name], rule, params)
                  for name, _, rule, params in self._shared_spec}
        worker, prefix = self._worker_name, self._key('step/')
        with self._stats_lock:
            self._ps_phase['sync_rounds'] += 1
        if self._pipe is None:
            t0 = time.perf_counter()
            self._snap_round_open(self._coord, worker)
            self._push_ps_deltas(pulled, afters, shared, scale=scale)
            self._coord.publish_step(worker, step, prefix=prefix)
            self._snap_round_close(self._coord, worker)
            self._flight.record('step_publish', worker=worker, step=step)
            with self._stats_lock:
                self._ps_phase['exposed_wait_s'] += \
                    time.perf_counter() - t0
            return
        # the LIVE membership (joins in, exclusions out): the floor must
        # range over every worker the next gate counts
        members = self._live_members()
        bound = step + 1 - self._plan.gate_staleness \
            if self._plan.gate_enabled and len(members) > 1 else 0

        def job(client):
            # the round is bracketed by snapshot parity, so a serving
            # reader never accepts a pull that straddles it
            self._snap_round_open(client, worker)
            self._push_ps_deltas(pulled, afters, shared, scale=scale)
            push_end = time.perf_counter()
            client.publish_step(worker, step, prefix=prefix)
            self._snap_round_close(client, worker)
            self._flight.record('step_publish', worker=worker, step=step)
            gate = self._prefetch_gate(client, prefix, bound, len(members),
                                       step + 1)
            # a peer's counter moves only after its push landed, so the
            # pull below sees every push published by now: run() drops
            # the prefetch when this floor is below the next gate's bound
            floor = step if len(members) <= 1 else min(
                client.incr(prefix + 'p%d' % i, 0) for i in members)
            names = self._pull_to_fetch()
            parts, wire_s = self._fetch_var_parts(names)
            return {'names': names, 'parts': parts, 'wire_s': wire_s,
                    'peer_floor': floor, 'push_end': push_end,
                    'gate': gate}

        self._inflight_step = tstep
        self._inflight = self._pipe.submit(0, job)

    def _prefetch_gate(self, client, prefix, bound, parties, gate_at):
        """The next step's staleness bound, waited for on the pipeline
        thread before the pull-ahead: a pull taken while a lagging peer
        is below the bound is dropped and taken again at the step (127
        MB on NCF), so the pipeline waits for the bound first, at most
        ``_PREFETCH_GATE_S``; past that it pulls ahead anyway, and the
        step's own gate judges the peer (dead-peer policies stay on the
        step's thread). The wait is the gate's: it is recorded as a
        ``staleness_gate`` span of the step it gates. Returns its
        (start, end), or None when there was no bound to wait for."""
        if bound <= 0:
            return None
        t0 = time.perf_counter()
        try:
            client.min_wait(prefix, bound, parties, _PREFETCH_GATE_S)
        except TimeoutError:
            pass
        t1 = time.perf_counter()
        with self._stats_lock:
            self._ps_phase['gate_s'] += t1 - t0
        self._tel.record_span('staleness_gate', t0, t1 - t0, step=gate_at,
                              worker=self._worker_name, prefetch=True)
        return t0, t1

    def _pull_to_fetch(self):
        """The variables a pull fetches (warm proxies are served from
        their cache)."""
        return [name for name in self._graph_item.graph.variables
                if not (name in self._proxy_vars and
                        name in self._proxy_cache)]

    def _fetch_var_parts(self, names):
        """One pipelined ``vmget`` per endpoint, endpoints in parallel:
        ``({name: [per-shard host array]}, wall seconds)``."""
        groups, shard_counts = self._transfer_groups(names)
        results = {name: [None] * c for name, c in shard_counts.items()}
        t0 = time.perf_counter()

        def fetch_group(units):
            def go(client):
                specs = []
                for key, name, i, pc in units:
                    shape = self._var(name).shape
                    specs.append((self._key(key), shape if pc is None
                                  else pc.shard_shapes(shape)[i]))
                arrs = client.vmget(specs)
                return [(name, i, a) for (_, name, i, _), a
                        in zip(units, arrs)]
            return go

        for got in self._pool.run([(ep, fetch_group(units))
                                   for ep, units in groups.items()]):
            for name, i, a in got:
                results[name][i] = a
        return results, time.perf_counter() - t0

    def _store_var_parts(self, values):
        """One pipelined ``vmset`` per endpoint of ``{name: whole host
        value}`` (shards split here)."""
        groups, _ = self._transfer_groups(list(values))

        def store_group(units):
            def go(client):
                items = []
                for key, name, i, pc in units:
                    val = np.asarray(values[name])
                    if pc is not None:
                        val = pc.split(val)[i]
                    items.append((self._key(key), val))
                client.vmset(items)
            return go

        self._pool.run([(ep, store_group(units))
                        for ep, units in groups.items()])

    def _account_prefetch_discard(self, prefetch):
        """A dropped pull-ahead still moved its bytes: count them (and
        the discard), but keep its seconds out of the per-step pull."""
        n_elems = sum(int(np.prod(self._var(n).shape))
                      for n in prefetch['names'])
        with self._stats_lock:
            for name in prefetch['names']:
                self._account_ep_bytes(name)
            self._ps_seconds += prefetch['wire_s']
            self._ps_bytes += self._wire_nbytes(n_elems)
            self._ps_pull_bytes += self._wire_nbytes(n_elems)
            self._ps_phase['discarded_prefetches'] += 1

    def _pull_ps_vars(self, prefetch=None, train=True):
        """Refresh the variable state from the PS, or from the
        pipeline's pull-ahead; returns the pulled host values (the base
        of the deltas). Fetch-only runs count their bytes but stay out
        of the per-train-step phases."""
        t_fn = time.perf_counter()
        to_fetch = self._pull_to_fetch()
        wire_s = exposed_s = 0.0
        if prefetch is not None and prefetch['names'] == to_fetch:
            fetched, wire_s = prefetch['parts'], prefetch['wire_s']
        else:
            fetched, wire_s = self._fetch_var_parts(to_fetch)
            exposed_s = wire_s
        pulled = {}
        n_elems = 0
        with self._stats_lock:
            for name in fetched:
                self._account_ep_bytes(name)
        for name, var in self._graph_item.graph.variables.items():
            if name in fetched:
                served = self._merged(name, fetched[name])
                n_elems += int(np.prod(var.shape))
                served = served.astype(np.asarray(var.init_value).dtype)
            else:
                served = self._proxy_cache[name]
                self._proxy_hits += 1
            pulled[name] = served
            self._var_state[name] = self._to_device(name, served)
        with self._stats_lock:
            self._ps_seconds += wire_s
            self._ps_bytes += self._wire_nbytes(n_elems)
            self._ps_pull_bytes += self._wire_nbytes(n_elems)
            if train:
                self._ps_phase['pull_s'] += wire_s
                self._ps_phase['exposed_wait_s'] += exposed_s
        self._tel.record_span(
            'pull_vars', t_fn, time.perf_counter() - t_fn,
            step=self._step_count + 1, worker=self._worker_name,
            prefetched=exposed_s == 0.0 and wire_s > 0.0)
        return pulled

    def _shared_push_spec(self, norm):
        """``[(var, fetch index, rule, params)]`` for the shared-optimizer
        pushes of the fetched train ops, and the gradient nodes to fetch
        for them. An optimizer without a PS-side rule keeps its slots on
        the worker (noted once)."""
        spec, extra = [], []
        node_pos = {id(f): i for i, f in enumerate(norm)}
        for f in norm:
            if not isinstance(f, fe.ApplyGradients):
                continue
            params = getattr(f.optimizer, 'ps_step_params', None)
            for gnode, var in f.grads_and_vars:
                if var.name not in self._shared_opt_vars:
                    continue
                if params is None:
                    if var.name not in self._shared_warned:
                        self._shared_warned.add(var.name)
                        logging.warning(
                            'shared_optimizer requested for %s but '
                            'optimizer %s has no PS-side update rule '
                            '(sgd/momentum/adam/adagrad with scalar '
                            'hyperparameters); its slots stay '
                            'worker-local', var.name, f.optimizer.name)
                    continue
                idx = node_pos.get(id(gnode))
                if idx is None:
                    idx = len(norm) + len(extra)
                    node_pos[id(gnode)] = idx
                    extra.append(gnode)
                spec.append((var.name, idx, params['rule'],
                             params['params']))
        return spec, extra

    def _classify_push(self, deltas):
        """(all-zero deltas to skip, {sparse var: touched rows}) — a
        sparse-read table ships only its touched rows when they are at
        most ``AUTODIST_SPARSE_PUSH_MAX_FRAC`` of it. Lossless: an
        untouched row's delta is exactly zero."""
        frac = ENV.AUTODIST_SPARSE_PUSH_MAX_FRAC.val
        zero_skip = set()
        sparse_rows = {}
        for name, delta in deltas.items():
            if frac and name in self._sparse_vars:
                touched = np.flatnonzero(
                    np.any(delta != 0, axis=1)).astype(np.int32)
                if touched.size == 0:
                    zero_skip.add(name)
                elif touched.size <= frac * delta.shape[0]:
                    sparse_rows[name] = touched
                continue
            if not delta.any():
                zero_skip.add(name)
        return zero_skip, sparse_rows

    def _shard_row_starts(self, name, pc):
        rows = [int(s[0]) for s in pc.shard_shapes(self._var(name).shape)]
        return list(np.cumsum([0] + rows))

    def _push_ps_deltas(self, pulled, afters, shared_push=None,
                        scale=None):
        """Push every variable's update (JAX ``session.py:3067-3280``):
        ``afters - pulled`` deltas (``BADD`` commutes, so concurrent
        workers' updates add up like the reference's apply-per-push
        accumulators), only the touched rows of a sparse table
        (``BSADD``), nothing for an all-zero delta, and the raw gradient
        of a shared-optimizer variable (``BSTEP``). A partitioned
        variable pushes each shard to its own endpoint; endpoints push
        in parallel. On the i8 wire each push carries error feedback:
        the residual the last push dropped is added back first, and the
        new residual is ``compensated - wire_roundtrip(compensated)``,
        the mass the service did not receive. ``scale`` (local-SGD
        averaging) multiplies the deltas before all of that. Runs on the
        pipeline thread at depth 2: numpy and sockets only."""
        t0 = time.perf_counter()
        shared_push = dict(shared_push or {})
        push_wire = cc._wire_dtype()
        lossy = push_wire == 'i8'
        deltas = {name: after - np.asarray(pulled[name], dtype=np.float32)
                  for name, after in afters.items()}
        if scale is not None and scale != 1.0:
            deltas = {name: d * np.float32(scale)
                      for name, d in deltas.items()}
        if lossy:
            for name in list(deltas):
                res = self._push_residual.get(name)
                if res is not None:
                    deltas[name] = deltas[name] + res
            for name, (g, rule, params) in list(shared_push.items()):
                res = self._push_residual.get(name)
                if res is not None:
                    shared_push[name] = (g + res, rule, params)
        zero_skip, sparse_rows = self._classify_push(deltas)
        groups, _ = self._transfer_groups(list(pulled))
        ep_jobs = {}
        ep_bytes = [0] * len(self._ps_addrs)
        wire_bytes = rows_pushed = bytes_avoided = 0
        res_parts = {}   # name -> [per-shard residual] (dense pushes)
        new_res = {}     # name -> whole residual (sparse pushes)

        def dense_residual(name, i, sent):
            parts = res_parts.setdefault(
                name, [None] * len(self._shard_info(name)[1]))
            parts[i] = sent - cc.wire_roundtrip(sent, push_wire)

        for ep, units in groups.items():
            job = ep_jobs.setdefault(ep, {'steps': [], 'adds': [],
                                          'sadds': []})
            for key, name, i, pc in units:
                if name in shared_push:
                    g, rule, params = shared_push[name]
                    if pc is not None:
                        g = pc.split(g)[i]
                    job['steps'].append((self._key(key), g, rule, params))
                    nb = self._wire_nbytes(g.size, push=True)
                    if lossy:
                        dense_residual(name, i, g)
                elif name in zero_skip:
                    full = deltas[name] if pc is None else \
                        pc.split(deltas[name])[i]
                    bytes_avoided += self._wire_nbytes(full.size,
                                                       push=True)
                    continue
                elif name in sparse_rows:
                    delta, idx = deltas[name], sparse_rows[name]
                    if pc is None:
                        lo, hi = 0, delta.shape[0]
                        sel = local = idx
                    else:
                        starts = self._shard_row_starts(name, pc)
                        lo, hi = starts[i], starts[i + 1]
                        sel = idx[(idx >= lo) & (idx < hi)]
                        if sel.size == 0:
                            bytes_avoided += self._wire_nbytes(
                                (hi - lo) * delta.shape[1], push=True)
                            continue
                        local = (sel - lo).astype(np.int32)
                    rows = delta[sel]
                    job['sadds'].append((self._key(key), local, rows))
                    nb = local.size * 4 + self._wire_nbytes(rows.size,
                                                            push=True)
                    bytes_avoided += self._wire_nbytes(
                        (hi - lo) * delta.shape[1], push=True) - nb
                    rows_pushed += local.size
                    if lossy:
                        res = new_res.setdefault(name,
                                                 np.zeros_like(delta))
                        res[sel] = rows - cc.rows_roundtrip(rows,
                                                            push_wire)
                else:
                    delta = deltas[name]
                    if pc is not None:
                        delta = pc.split(delta)[i]
                    job['adds'].append((self._key(key), delta))
                    nb = self._wire_nbytes(delta.size, push=True)
                    if lossy:
                        dense_residual(name, i, delta)
                wire_bytes += nb
                ep_bytes[ep] += nb
        if lossy:
            for name in zero_skip:
                self._push_residual.pop(name, None)
            for name, parts in res_parts.items():
                new_res[name] = self._merged(name, parts)
            for name, res in new_res.items():
                if np.any(res):
                    self._push_residual[name] = res
                else:
                    self._push_residual.pop(name, None)

        def push_group(job):
            def go(client):
                for key, g, rule, params in job['steps']:
                    client.vstep(key, g, rule, params)
                if job['adds']:
                    client.vmadd(job['adds'])
                if job['sadds']:
                    client.vmsadd(job['sadds'])
            return go

        self._pool.run([(ep, push_group(job))
                        for ep, job in ep_jobs.items()])
        self._shared_pushes += sum(1 for n in pulled if n in shared_push)
        push_only_bytes = wire_bytes
        refresh_bytes, refresh_ep = self._refresh_proxies(zero_skip,
                                                          sparse_rows)
        for ep, nb in refresh_ep.items():
            ep_bytes[ep] += nb
        push_s = time.perf_counter() - t0
        with self._stats_lock:
            if not self._ps_ep_bytes:
                self._ps_ep_bytes = [0] * len(self._ps_addrs)
            for ep, nb in enumerate(ep_bytes):
                self._ps_ep_bytes[ep] += nb
            self._ps_seconds += push_s
            self._ps_bytes += push_only_bytes + refresh_bytes
            # the proxy refresh is read traffic riding the push phase
            self._ps_push_bytes += push_only_bytes
            self._ps_pull_bytes += refresh_bytes
            self._ps_phase['push_s'] += push_s
            ss = self._sparse_stats
            ss['sparse_pushes'] += len(sparse_rows)
            ss['rows_pushed'] += rows_pushed
            ss['zero_push_skips'] += len(zero_skip)
            ss['dense_bytes_avoided'] += bytes_avoided
        self._tel.record_span(
            'push_deltas', t0, push_s, step=self._step_count,
            worker=self._worker_name, bytes=push_only_bytes,
            sparse=len(sparse_rows), zero_skips=len(zero_skip))
        return push_s

    def _refresh_proxies(self, zero_skip, sparse_rows):
        """The post-push proxy refresh (reference proxy_variable.py:
        163-190): a warm unpartitioned sparse table refreshes only its
        pushed rows (``BGETROWS``), with a full refresh every
        ``AUTODIST_SPARSE_FULL_REFRESH_EVERY`` so other workers' rows
        arrive; everything else refreshes whole. Returns (wire bytes,
        {endpoint: bytes})."""
        if not self._proxy_vars:
            return 0, {}
        refresh_every = ENV.AUTODIST_SPARSE_FULL_REFRESH_EVERY.val
        full_names = []
        row_specs = {}
        for name in sorted(self._proxy_vars):
            pc, _ = self._shard_info(name)
            sparse_capable = (pc is None and name in self._proxy_cache
                              and name in self._sparse_vars)
            rowset = sparse_rows.get(name)
            if rowset is None and sparse_capable and name in zero_skip:
                rowset = np.empty(0, np.int32)
            if rowset is None or not sparse_capable:
                full_names.append(name)
                continue
            cnt = self._sparse_refresh_count.get(name, 0) + 1
            if refresh_every and cnt >= refresh_every:
                self._sparse_refresh_count[name] = 0
                full_names.append(name)
            else:
                self._sparse_refresh_count[name] = cnt
                if rowset.size:
                    row_specs[name] = rowset
        wire = 0
        ep_bytes = {}
        full_refreshes = 0
        if full_names:
            refreshed, _ = self._fetch_var_parts(full_names)
            for name, parts in refreshed.items():
                served = self._merged(name, parts)
                if served is None:
                    continue
                self._proxy_cache[name] = served.astype(
                    np.asarray(self._var(name).init_value).dtype)
                wire += self._wire_nbytes(served.size)
                if name in self._sparse_vars:
                    full_refreshes += 1
                pc, _ = self._shard_info(name)
                sizes = [served.size] if pc is None else \
                    [p.size for p in parts]
                for ep, n in zip(self._shard_endpoints(name, len(parts)),
                                 sizes):
                    ep_bytes[ep] = ep_bytes.get(ep, 0) + \
                        self._wire_nbytes(n)
        if row_specs:
            by_ep = {}
            for name, idx in row_specs.items():
                _, keys = self._shard_info(name)
                ep = self._shard_endpoints(name, 1)[0]
                by_ep.setdefault(ep, []).append(
                    (name, self._key(keys[0]), idx,
                     int(self._var(name).shape[1])))

            def fetch_rows(specs):
                def go(client):
                    arrs = client.vmgetrows(
                        [(key, idx, ncols) for _, key, idx, ncols in specs])
                    return [(name, idx, a) for (name, _, idx, _), a
                            in zip(specs, arrs)]
                return go

            for got in self._pool.run([(ep, fetch_rows(specs))
                                       for ep, specs in by_ep.items()]):
                for name, idx, arr in got:
                    if arr is None:
                        continue
                    cache = self._proxy_cache[name]
                    cache[idx] = arr.astype(cache.dtype)
                    nb = idx.size * 4 + self._wire_nbytes(arr.size)
                    wire += nb
                    ep = self._shard_endpoints(name, 1)[0]
                    ep_bytes[ep] = ep_bytes.get(ep, 0) + nb
        with self._stats_lock:
            self._sparse_stats['row_refreshes'] += len(row_specs)
            self._sparse_stats['rows_refreshed'] += \
                sum(i.size for i in row_specs.values())
            self._sparse_stats['full_refreshes'] += full_refreshes
        return wire, ep_bytes

    # -- reports ------------------------------------------------------------
    def _auto_checkpoint(self):
        """The chief's periodic snapshot of its variable state (never
        fatal: the backstop must not kill the run it protects)."""
        try:
            self._auto_ckpt.save(self._step_count, {
                name: self._local_value(name)
                for name in self._graph_item.graph.variables})
            self._health['auto_checkpoints'] += 1
        except Exception as e:  # noqa: BLE001 - backstop, not the run
            logging.warning('auto-checkpoint at step %d failed: %s: %s',
                            self._step_count, type(e).__name__, e)

    @property
    def health_stats(self):
        """Elastic-recovery observability (JAX ``session.py:2026-2059``,
        read by :func:`~autodist_tpu_torch.utils.profiling.
        health_report`): the policy, this worker's generation, the
        membership epoch, missed beats, exclusions, rejoins with their
        recovery wall times, joins, this worker's admit record when it
        joined, the re-rank and swap decisions and the auto-checkpoints.
        Re-ranks still running on their threads are joined first."""
        for t in self._replan_threads:
            if t.is_alive():
                t.join(timeout=60.0)
        out = dict(self._health)
        out.update(
            epoch=self._epoch_seen,
            generation=self._generation,
            rejoining=self._rejoining,
            joining=self._joining,
            num_workers=self._num_workers,
            world=self._world,
            active_workers=self._active_workers(),
            excluded=sorted(w.rsplit('/', 1)[-1]
                            for w in self._excluded))
        if self._monitor is not None:
            # rolling cohort stats, active verdicts, the slowdown /
            # recovered audit and the recalibrations; health_report and
            # format_health render it
            out['perf'] = self._monitor.snapshot()
        return out

    # -- the telemetry plane ----------------------------------------------
    def _join_tel_push(self):
        """Join the previous background span push (pushes stay FIFO on
        the lane); its error is logged, never raised."""
        handle, self._tel_push_handle = self._tel_push_handle, None
        if handle is None:
            return
        try:
            handle.result()
        except Exception as e:  # noqa: BLE001 - advisory plane
            logging.warning('background telemetry batch push failed: '
                            '%s: %s', type(e).__name__, e)

    def _push_batch(self, client, records):
        nbytes = _aggregate.push_records(client, self._ns,
                                         self._worker_name, records)
        with self._stats_lock:
            self._tel_pushed_bytes += nbytes
        return nbytes

    def _maybe_push_telemetry(self, client, step, final=False):
        """Push this worker's drained span records to ``<ns>/telemetry/``
        every ``AUTODIST_TELEMETRY_PUSH_EVERY`` train steps (JAX
        ``session.py:2085-2129``), from the step's thread once the step
        is recorded. A batch carries whole steps: the records of a step
        whose push is still in flight (depth 2) wait for the next batch
        with that push's span, since the monitor derives a step's
        compute share from its phases in one batch (the JAX package
        pushes from the pipeline thread, which can split a step).
        Steady-state pushes ride a background lane (one
        :class:`TransferPool` worker with its own fenced connection): a
        batch never belongs on the step's critical path. ``final=True``
        (the close-time flush) joins the lane and pushes everything on
        the caller's client, so nothing is in flight when the chief
        collects and purges. The chief's own records go straight to its
        monitor as they are drained (never fetched back). Never
        fatal."""
        if not self._tel.enabled:
            return
        every = ENV.AUTODIST_TELEMETRY_PUSH_EVERY.val
        if not final and (not every or step % every):
            return
        try:
            drained = self._tel.drain_spans()
            if self._monitor is not None and drained:
                self._monitor.ingest_local(drained)
            records, self._tel_carry = self._tel_carry + drained, []
            if final:
                self._join_tel_push()
                self._push_batch(client, records)
                return
            if self._inflight is not None:
                pushing = self._inflight_step
                self._tel_carry = [
                    r for r in records
                    if (r.get('tags') or {}).get('step', 0) >= pushing]
                records = [
                    r for r in records
                    if (r.get('tags') or {}).get('step', 0) < pushing]
            if not records:
                return
            if self._tel_pipe is None:
                addr = self._coord.address
                self._tel_pipe = cc.TransferPool(
                    [lambda: self._fenced_connect(addr)])
            self._join_tel_push()
            self._tel_push_handle = self._tel_pipe.submit(
                0, lambda c: self._push_batch(c, records))
        except Exception as e:  # noqa: BLE001 - advisory plane
            logging.warning('telemetry batch push failed at step %d: '
                            '%s: %s', step, type(e).__name__, e)

    @property
    def telemetry_pushed_bytes(self):
        """Wire bytes of the span batches this worker pushed so far."""
        with self._stats_lock:
            return self._tel_pushed_bytes

    def cohort_telemetry(self):
        """Every member's pushed span batches off the run's telemetry
        namespace, each record tagged with its worker and sorted on the
        shared wall axis (JAX ``session.py:2131-2141``); ``[]`` when
        nothing was pushed."""
        members = ['p%d' % i for i in range(self._world)]
        return _aggregate.collect_records(self._coord, self._ns, members)

    def export_chrome_trace(self, path=None):
        """Write the cohort's timeline as Chrome ``trace_event`` JSON
        (JAX ``session.py:2143-2172``), this worker's undrained spans
        and its flight events included. Returns the path, or None when
        there was nothing to export."""
        import json
        records = self.cohort_telemetry()
        for rec in self._tel.drain_spans():
            rec.setdefault('worker', self._worker_name)
            records.append(rec)
        if not records:
            return None
        records.sort(key=lambda r: r.get('t0', 0.0))
        # control-plane instants go on THIS process's row: ring events
        # name their subject (an excluded peer), not the actor
        trace = _aggregate.chrome_trace(
            records,
            flight_events=[dict(e, worker_self=self._worker_name)
                           for e in self._flight.events()])
        if path is None:
            path = os.path.join(_flight.telemetry_dir(),
                                'trace-%s.json' % self._ns)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, 'w') as f:
            json.dump(trace, f)
        logging.info('telemetry: wrote cohort Chrome trace (%d events) '
                     'to %s', len(trace['traceEvents']), path)
        self.trace_path = path
        return path

    @property
    def ps_stats(self):
        """Wire accounting (JAX ``session.py:2177-2225``): bytes and
        seconds moved, the push / pull split, bytes per endpoint, the
        row-sparse counters and the pipeline's phases per sync round —
        pull, step, push, the wire seconds left exposed, their
        ``overlap_frac``, the seconds spent at the staleness gate and
        the largest lag it let through."""
        with self._stats_lock:
            ph = dict(self._ps_phase)
            out = {'bytes': self._ps_bytes, 'seconds': self._ps_seconds,
                   'push_bytes': self._ps_push_bytes,
                   'pull_bytes': self._ps_pull_bytes,
                   'bytes_per_endpoint': list(self._ps_ep_bytes),
                   'mb_per_s': (self._ps_bytes / 1e6 / self._ps_seconds
                                if self._ps_seconds else 0.0),
                   'sparse': dict(self._sparse_stats)}
        steps = max(1, ph['train_steps'])
        rounds = max(1, ph['sync_rounds']) if ph['sync_rounds'] else steps
        wire = ph['pull_s'] + ph['push_s']
        out['pipeline'] = {
            'depth': self._pipeline_depth,
            'train_steps': ph['train_steps'],
            'sync_rounds': ph['sync_rounds'],
            'local_steps': self._local_steps,
            'discarded_prefetches': ph['discarded_prefetches'],
            'pull_s': ph['pull_s'] / rounds,
            'step_s': ph['step_s'] / steps,
            'push_s': ph['push_s'] / rounds,
            'exposed_wait_s': ph['exposed_wait_s'] / rounds,
            'gate_s': ph['gate_s'],
            'max_lag': ph['max_lag'],
            'overlap_frac': max(0.0, min(
                1.0, 1.0 - ph['exposed_wait_s'] / wire))
            if wire > 0 else 0.0,
        }
        return out

    # -- lifecycle ---------------------------------------------------------
    def close(self):
        """Land the last push, release the peers (a done marker and the
        ``CLEAN_CLOSE_STEP`` counter, so a gate waiting on this worker
        opens), and let the last worker out of the active membership
        purge the run's namespace from every endpoint. A failed last
        push re-raises after that."""
        if self._hb_stop is not None:
            self._hb_stop.set()
            if self._hb_thread is not None and self._hb_thread.is_alive():
                self._hb_thread.join(timeout=15.0)
        drain_err = None
        if not self._closed:
            try:
                self._drain_pipeline()
            except Exception as e:  # noqa: BLE001 - re-raised below
                drain_err = e
                logging.error('final background PS push failed in '
                              'close(): %s: %s', type(e).__name__, e)
            if self._tel.enabled:
                # the last span batch, the monitor's last verdicts and
                # the chief's cohort trace, all before the purges below
                try:
                    self._maybe_push_telemetry(self._coord,
                                               self._step_count,
                                               final=True)
                    if self._monitor is not None:
                        self._monitor.poll()
                    if self._is_chief:
                        self.export_chrome_trace()
                except Exception as e:  # noqa: BLE001 - advisory
                    logging.warning('telemetry flush/export in close() '
                                    'failed: %s: %s', type(e).__name__, e)
            if self._is_chief:
                # the telemetry namespace (batches and their counters)
                # and staged swap plans must not outlive the run, even
                # when the purge quorum below is never reached: a reused
                # service would replay them into the next run
                for purge in (
                        lambda: self._coord.delete_namespace(
                            self._key('telemetry/')),
                        lambda: swap_keys.purge_all(self._coord,
                                                    self._ns)):
                    try:
                        purge()
                    except Exception:  # noqa: BLE001 - service gone
                        pass
            self._flight.record('close', worker=self._worker_name,
                                step=self._step_count,
                                clean=drain_err is None)
            if drain_err is not None:
                self._flight.dump('unclean_close')
            try:
                self._coord.set('done/%s' % self._key(self._worker_name),
                                '1')
                self._coord.publish_step(self._worker_name,
                                         cc.CLEAN_CLOSE_STEP,
                                         prefix=self._key('step/'))
                # the last worker out purges; excluded (fenced) peers
                # never count in, so the quorum is the ACTIVE membership,
                # adopted first (this worker may have finished before
                # an excluder's epoch bump)
                epoch = self._coord.incr(self._key('epoch'), 0)
                if epoch != self._epoch_seen:
                    self._epoch_seen = epoch
                    self._refresh_membership()
                closed = self._coord.incr(self._key('closed'), 1)
                if closed >= self._active_workers():
                    self._pool.run(
                        [(ep, lambda c: c.delete_namespace(self._ns + '/'))
                         for ep in range(len(self._pool))])
                    if tuple(self._coord.address) not in \
                            [tuple(a) for a in self._ps_addrs]:
                        self._coord.delete_namespace(self._ns + '/')
                    for prefix in ('hb/%s/' % self._ns,
                                   'done/%s/' % self._ns):
                        self._coord.delete_namespace(prefix)
            except Exception:  # noqa: BLE001 - the service may be gone
                pass
        super().close()
        for pool in (self._pipe, self._tel_pipe, self._pool):
            if pool is not None:
                pool.close()
        if self._auto_ckpt is not None:
            try:
                self._auto_ckpt.wait_until_finished()
            except Exception as e:  # noqa: BLE001 - backstop teardown
                logging.warning('auto-checkpoint drain failed in '
                                'close(): %s: %s', type(e).__name__, e)
        if drain_err is not None:
            raise drain_err

    def get_variable_value(self, var):
        """The authoritative value, read from the PS after this worker's
        own in-flight push has landed (the prefetch stays valid)."""
        name = var.name if isinstance(var, fe.Variable) else var
        self._drain_pipeline(keep_prefetch=True)
        parts = self._fetch_var_parts([name])[0][name]
        return self._merged(name, parts).astype(
            np.asarray(self._var(name).init_value).dtype)

    def load_variable_value(self, var, value):
        """Set this worker's copy (the chief also stores it on the PS);
        an in-flight push and the prefetch are superseded."""
        name = var.name if isinstance(var, fe.Variable) else var
        self._drain_pipeline()
        super().load_variable_value(name, value)
        if self._is_chief:
            self._store_var_parts({name: np.asarray(value)})
