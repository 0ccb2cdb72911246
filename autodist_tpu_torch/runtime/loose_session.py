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

What is not here yet (ROADMAP.md Queue 1, "Loose-mode PS plane", its
second half): the elastic join and admit, membership with the
``exclude`` and ``restart`` peer-failure policies, replanning and
epoch swaps, serving readers, the telemetry push and the cohort
monitor.
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
from autodist_tpu_torch.runtime.cluster import (is_local_address,
                                               world_and_rank)
from autodist_tpu_torch.runtime.session import Session, to_numpy
from autodist_tpu_torch.utils import logging

SECOND_HALF = "ROADMAP.md Queue 1: Loose-mode PS plane, its second half"


def _close_quietly(client):
    if client is not None:
        try:
            client.close()
        except OSError:
            pass


def check_policy():
    """Refuse a peer-failure policy this half of the plane has no
    machinery for, before anything is brought up: only ``fail``."""
    policy = ENV.AUTODIST_PEER_FAILURE_POLICY.val
    if policy != 'fail':
        raise NotImplementedError(
            'AUTODIST_PEER_FAILURE_POLICY=%s: membership changes '
            '(exclusion and supervised restart) are not ported yet (%s); '
            'use fail' % (policy, SECOND_HALF))
    return policy


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


class LooseSession(Session):
    """A worker of the loose PS plane (see the module docstring).

    Args:
        graph_item: the captured program.
        plan: its :class:`ExecutionPlan`, built with ``loose=True``.
        coord: this process's :class:`~autodist_tpu_torch.runtime.
            coord_client.CoordClient` to the coord service.
    """

    def __init__(self, graph_item, plan, coord):
        if coord is None:
            raise RuntimeError('loose multi-process mode needs a coord '
                               'service client')
        policy = check_policy()
        self._coord = coord
        # coord keys live under the strategy id: a reused service never
        # serves a previous run's variables or counters
        self._ns = plan.strategy.id
        # the run's processes: a group formed by the caller, else the
        # launcher's AUTODIST_PROCESS_ID / AUTODIST_NUM_PROCESSES
        self._num_workers, rank = world_and_rank()
        self._worker_name = 'p%d' % rank
        self._is_chief = rank == 0
        self._round_count = 0   # completed local-SGD sync rounds
        # every write rides connections bound to this worker's fencing
        # generation (the counter lives outside the run namespace)
        self._fence_key = 'fence/%s' % self._key(self._worker_name)
        self._generation = coord.incr(self._fence_key, 0)
        if self._generation:
            raise NotImplementedError(
                'worker %s of run %s was declared dead before: rejoining '
                'as its replacement is not ported yet (%s)'
                % (self._worker_name, self._ns, SECOND_HALF))
        coord.fence(self._fence_key, self._generation)
        self._health = {'policy': policy, 'missed_beats': 0,
                        'auto_checkpoints': 0}
        self._auto_ckpt = None
        self._auto_ckpt_every = ENV.AUTODIST_AUTO_CHECKPOINT_EVERY.val
        if self._is_chief and self._auto_ckpt_every:
            from autodist_tpu_torch.checkpoint.saver import \
                CheckpointManager
            self._auto_ckpt = CheckpointManager(
                os.path.join(DEFAULT_CHECKPOINT_DIR, 'auto', self._ns),
                max_to_keep=2, async_save=True)
        syncs = {name: p.all_syncs for name, p in plan.var_plans.items()
                 if p.is_ps}
        # proxy variables (reference proxy_variable.py:46-190): a
        # worker-local cache serves the pre-step read, refreshed from
        # the PS after each push
        self._proxy_vars = {name for name, ss in syncs.items() if any(
            getattr(s, 'local_replication', False) for s in ss)}
        self._proxy_cache = {}
        self._proxy_hits = 0
        # PS-resident optimizer (reference partitioner.py:570-573)
        self._shared_opt_vars = {name for name, ss in syncs.items() if any(
            getattr(s, 'shared_optimizer', False) for s in ss)}
        self._shared_warned = set()
        self._shared_pushes = 0
        self._shared_spec = []
        # the row-sparse plane: sparse-read 2-D PS variables (split on
        # axis 0 when partitioned)
        self._sparse_vars = {
            name for name, p in plan.var_plans.items()
            if p.is_ps and getattr(p.var, 'sparse_read', False)
            and len(p.var.shape) == 2
            and (p.num_shards <= 1 or p.partition_axis == 0)}
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
        self._hb_seen = {}
        self._hb_peers = [self._key('p%d' % i)
                          for i in range(self._num_workers)
                          if 'p%d' % i != self._worker_name]
        self._hb_stop = None
        self._hb_thread = None
        if ENV.AUTODIST_HEARTBEAT_TIMEOUT.val:
            self._start_heartbeats()

    # -- identity and liveness --------------------------------------------
    def _key(self, suffix):
        return '%s/%s' % (self._ns, suffix)

    def peer_step(self, process_id):
        """Another worker's published completed-step counter (0 if none)."""
        return self._coord.incr(self._key('step/') + 'p%d' % process_id, 0)

    def _live_members(self):
        return list(range(self._num_workers))

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

    def _check_peers_alive(self):
        """Judged between gate slices (JAX ``session.py:1801-1893``, the
        ``fail`` policy): a peer whose beat counter has not moved for
        ``AUTODIST_HEARTBEAT_TIMEOUT`` seconds on this process's clock,
        and that did not close cleanly, raises."""
        timeout = ENV.AUTODIST_HEARTBEAT_TIMEOUT.val
        if not timeout:
            return None
        self._coord.heartbeat(self._key(self._worker_name))
        dead = self._coord.dead_workers(self._hb_peers, timeout,
                                        self._hb_seen)
        dead = [w for w in dead if self._coord.get('done/%s' % w) is None]
        if not dead:
            return None
        self._health['missed_beats'] += len(dead)
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
        what the PS serves (JAX ``session.py:2261-2320``)."""
        variables = self._graph_item.graph.variables
        if self._is_chief:
            self._store_var_parts({name: v.init_value
                                   for name, v in variables.items()})
        self._coord.heartbeat(self._key(self._worker_name))
        self._coord.barrier(self._key('session/init'), self._num_workers,
                            timeout_s=120.0)
        if self._is_chief:
            self._coord.set(self._key('session/init-done'), '1')
        else:
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
                self._coord.staleness_gate(
                    gate_at, staleness, self._num_workers,
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
        outs = super()._step(fetch_nodes, feeds)
        with self._stats_lock:
            self._ps_phase['step_s'] += time.perf_counter() - t0
        return outs

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
        try:
            return job.result()
        finally:
            blocked = time.perf_counter() - t0
            with self._stats_lock:
                self._ps_phase['exposed_wait_s'] += blocked
            self._tel.record_span('pipeline_wait', t0, blocked,
                                  step=self._step_count + 1,
                                  worker=self._worker_name)

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
                scale = 1.0 / max(1, self._num_workers)
        else:
            step = self._step_count
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
            self._push_ps_deltas(pulled, afters, shared, scale=scale)
            self._coord.publish_step(worker, step, prefix=prefix)
            with self._stats_lock:
                self._ps_phase['exposed_wait_s'] += \
                    time.perf_counter() - t0
            return
        members = self._live_members()

        def job(client):
            self._push_ps_deltas(pulled, afters, shared, scale=scale)
            client.publish_step(worker, step, prefix=prefix)
            # a peer's counter moves only after its push landed, so the
            # pull below sees every push published by now: run() drops
            # the prefetch when this floor is below the next gate's bound
            floor = step if len(members) <= 1 else min(
                client.incr(prefix + 'p%d' % i, 0) for i in members)
            names = self._pull_to_fetch()
            parts, wire_s = self._fetch_var_parts(names)
            return {'names': names, 'parts': parts, 'wire_s': wire_s,
                    'peer_floor': floor}

        self._inflight = self._pipe.submit(0, job)

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
        """The liveness half of the JAX report: the policy, this
        worker's generation, the workers, the peers found dead and the
        auto-checkpoints taken."""
        return dict(self._health, generation=self._generation,
                    num_workers=self._num_workers)

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
        opens), and let the last worker out purge the run's namespace
        from every endpoint. A failed last push re-raises after that."""
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
            try:
                self._coord.set('done/%s' % self._key(self._worker_name),
                                '1')
                self._coord.publish_step(self._worker_name,
                                         cc.CLEAN_CLOSE_STEP,
                                         prefix=self._key('step/'))
                closed = self._coord.incr(self._key('closed'), 1)
                if closed >= self._num_workers:
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
        for pool in (self._pipe, self._pool):
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
