"""``ServingReplica`` — a ``Session``-less read-only client of the
live training namespace (the counterpart of
``autodist_tpu/serving/replica.py``). Its accepted dense snapshot is
held as tensors on the replica's device (the card unless the caller
passes ``device='cpu'``), and :meth:`ServingReplica.forward` runs a
torch function on them; row lookups return host arrays.

Two connections, two planes:

- ``_data`` — a READ-ONLY :class:`CoordClient` (``read_only=True``):
  every snapshot pull, row fetch and counter read rides it, and any
  mutating verb would raise ``ReadOnlyViolation`` locally. Never
  fence-bound: readers must never take writer generations.
- ``_ctl`` — a normal control connection for the reader's OWN keys
  only (the ``serve/world`` admit claim and ``hb/serve/...``
  heartbeats), all under serve-prefixed names the training cohort
  never scans.

Epoch-consistent dense snapshots (the seqlock protocol, trainer half
in ``LooseSession._snap_round_open/_close``):

1. PIN — read live membership (``join/world`` minus ``excluded/``
   markers), every live writer's ``<ns>/snap/p<i>`` parity counter and
   the published floor. Any ODD parity = a sync round is mid-flight;
   this attempt is abandoned before a byte of tensor data moves.
2. PULL — one batched ``vmget`` over every dense (variable, shard)
   unit. Each tensor is individually torn-read-safe on its own; the
   seqlock adds the CROSS-tensor guarantee.
3. REVALIDATE — re-read membership and parities. Accept iff both are
   unchanged: no writer opened OR completed a sync round during the
   pull, so every tensor read belongs to the same published step (the
   floor, re-read now, which the unchanged parities prove equal to
   the pinned one). On mismatch, retry from 1 — the PREVIOUS snapshot
   stays servable throughout, so a hot write phase degrades freshness,
   never availability.

A writer that crashed mid-round leaves its parity odd until the
cohort's exclusion machinery retires it; the replica keeps serving
the last accepted snapshot and its staleness grows — the documented
trade: a reader NEVER blocks training, so
training's failure handling bounds the reader's staleness, not the
reverse.
"""
import threading
import time

import numpy as np
import torch

from autodist_tpu_torch.const import ENV
from autodist_tpu_torch.runtime.coord_client import (CLEAN_CLOSE_STEP,
                                               connect_with_retry,
                                               wire_nbytes)
from autodist_tpu_torch.serving.row_cache import RowCache
from autodist_tpu_torch.telemetry import core as _telemetry
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.utils.device import resolve_device


def _percentile(samples, q):
    """Nearest-rank percentile of an unsorted sample list (0 when
    empty) — avoids numpy interpolation-surface churn for what is a
    stats readout, not math."""
    if not samples:
        return 0.0
    s = sorted(samples)
    k = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
    return s[k]


class SnapshotView:
    """One accepted epoch-consistent dense snapshot: ``values`` maps
    variable name -> tensor on the replica's device (shards
    concatenated on axis 0, the plane's row-sharding convention), all
    mutually consistent at published step ``step``."""

    def __init__(self, step, values, members, wire_bytes_):
        self.step = step
        self.values = values
        self.members = members
        self.wire_bytes = wire_bytes_
        self.pulled_at = time.monotonic()

    def __repr__(self):
        return ('SnapshotView(step=%d, vars=%d, members=%s)'
                % (self.step, len(self.values), self.members))


class ServingReplica:
    """One read-only serving replica of namespace ``ns``.

    ``dense_vars`` maps variable name -> shape for the whole-model
    snapshot plane; ``shard_parts`` optionally overrides a name's
    storage layout with explicit ``[(key_suffix, shape), ...]`` units
    (the trainer's ``_shard_info`` layout for PS-sharded variables).
    ``sparse_vars`` maps table name -> (rows, ncols) for the row-cache
    plane. Variables in neither map are simply not served — a replica
    serves the projection of the model its queries need. ``device``
    holds the dense snapshot (default: the card).
    """

    def __init__(self, ns, dense_vars=None, sparse_vars=None,
                 address=None, name=None, staleness_bound=None,
                 snapshot_retries=None, poll_s=None, wire=None,
                 row_cache=None, shard_parts=None, device=None):
        self._ns = ns
        self.device = resolve_device(device)
        self.name = name or 'replica'
        self._address = address
        self._dense = dict(dense_vars or {})
        self._sparse = {t: (int(r), int(c))
                        for t, (r, c) in (sparse_vars or {}).items()}
        self._parts = dict(shard_parts or {})
        self.staleness_bound = (
            ENV.AUTODIST_SERVE_STALENESS_BOUND.val
            if staleness_bound is None else int(staleness_bound))
        self.snapshot_retries = (
            ENV.AUTODIST_SERVE_SNAPSHOT_RETRIES.val
            if snapshot_retries is None else int(snapshot_retries))
        self.poll_s = (ENV.AUTODIST_SERVE_POLL_S.val
                       if poll_s is None else float(poll_s))
        self._wire = wire if wire is not None \
            else (ENV.AUTODIST_SERVE_WIRE.val or None)
        self.row_cache = row_cache or RowCache()
        self._data = None
        self._ctl = None
        self._admit = None
        # one lock serializes the data connection: the fleet's refresh
        # loop and query callers share one socket per replica, and two
        # interleaved pipelined reads would corrupt both reply streams
        self._lock = threading.Lock()
        self.snapshot = None
        self._tel = _telemetry.get()
        # serve accounting (serve_stats): lookups, recent per-lookup
        # walls (bounded — percentiles need samples, not history),
        # snapshot protocol outcomes, wire bytes, staleness trace
        self._lookup_ms = []
        self._lookup_ms_cap = 4096
        self._t_first_lookup = None
        self._t_last_lookup = None
        self.lookups = 0
        self.rows_served = 0
        self.wire_bytes = 0
        self.snapshot_pulls = 0
        self.snapshot_retries_used = 0
        self.snapshot_rejects = 0
        self.staleness_steps = 0
        self.staleness_max_steps = 0
        self.staleness_violations = 0
        self.mixed_version_reads = 0

    # -- membership / connection ------------------------------------------
    def connect(self, deadline_s=30.0):
        """Dial the coord service: the read-only data connection plus
        the serve-plane control connection, then the NON-VOTING admit
        (``admit_reader`` — no fence, no join/world claim, no step
        publish)."""
        from autodist_tpu_torch.runtime.loose_session import admit_reader
        self._data = connect_with_retry(self._address,
                                        deadline_s=deadline_s,
                                        read_only=True)
        self._ctl = connect_with_retry(self._address,
                                       deadline_s=deadline_s)
        self._admit = admit_reader(self._ctl, self._ns,
                                   wait_init_s=deadline_s)
        self.name = self._admit['reader']
        return self

    def close(self):
        # under the data lock: a refresh/lookup in flight on another
        # thread finishes against live sockets, and its NEXT call sees
        # the None guard instead of a half-torn client
        with self._lock:
            for c in (self._data, self._ctl):
                if c is not None:
                    try:
                        c.close()
                    except OSError:
                        pass
            self._data = self._ctl = None

    def beat(self):
        """Serve-plane heartbeat (``hb/serve/<ns>/<reader>``) — a
        liveness signal for fleet supervision, on a prefix the
        training cohort never scans."""
        if self._ctl is not None and self._admit is not None:
            self._ctl.heartbeat('serve/%s/%s'
                                % (self._ns, self._admit['reader']))

    def _key(self, suffix):
        return '%s/%s' % (self._ns, suffix)

    def live_writers(self):
        """Live WRITER ordinals: claimed ``join/world`` slots minus
        ``excluded/`` markers — the same definition as
        ``live_members_on_plane``, via delta-0 counter reads the
        read-only connection is allowed."""
        world = self._data.incr(self._key('join/world'), 0)
        return [i for i in range(world)
                if self._data.incr('excluded/%s/p%d'
                                   % (self._ns, i), 0) == 0]

    def published_floor(self, members=None):
        """Min published step over live writers (never-published zeros
        and ``CLEAN_CLOSE_STEP`` releases skipped, like the trainer's
        own floor scans)."""
        members = self.live_writers() if members is None else members
        floor = None
        for i in members:
            step = self._data.incr(self._key('step/p%d' % i), 0)
            if step == 0 or step >= CLEAN_CLOSE_STEP:
                continue
            floor = step if floor is None else min(floor, step)
        return floor or 0

    def _snap_parities(self, members):
        return [self._data.incr(self._key('snap/p%d' % i), 0)
                for i in members]

    # -- dense snapshot plane ---------------------------------------------
    def _dense_specs(self):
        """Every (key, shape) unit of the dense snapshot, honoring
        explicit shard layouts."""
        specs = []
        layout = []
        for nm in sorted(self._dense):
            parts = self._parts.get(nm) or [('var/%s' % nm,
                                             self._dense[nm])]
            layout.append((nm, len(parts)))
            for suffix, shape in parts:
                specs.append((self._key(suffix), tuple(shape)))
        return specs, layout

    def refresh(self):
        """One snapshot poll: pull a fresh epoch-consistent dense
        snapshot if one is ready, else keep serving the current one.
        Returns True when a NEW snapshot was accepted. Every retry
        path leaves ``self.snapshot`` untouched."""
        if not self._dense:
            # row-cache-only replicas still track staleness for stats
            with self._lock:
                self._require_connected()
                self._note_staleness(self.published_floor())
            return False
        specs, layout = self._dense_specs()
        with self._tel.span('serve/refresh', replica=self.name), \
                self._lock:
            # under the lock: a close() on another thread lands either
            # before this check or after this refresh
            self._require_connected()
            staleness_noted = False
            for attempt in range(self.snapshot_retries):
                members = self.live_writers()
                parities = self._snap_parities(members)
                if any(p & 1 for p in parities):
                    # a sync round is mid-flight: abandon before any
                    # tensor byte moves — this poll's pull would be
                    # invalidated at revalidate anyway. Still grade
                    # staleness against the published floor: a writer
                    # crashed mid-round (parity stuck odd) is exactly
                    # when the replica falls behind, and the exhausted
                    # path below would otherwise never account it.
                    if not staleness_noted:
                        self._note_staleness(self.published_floor(members))
                        staleness_noted = True
                    self.snapshot_retries_used += 1
                    time.sleep(0.005 * (attempt + 1))
                    continue
                floor = self.published_floor(members)
                if self.snapshot is not None and \
                        floor <= self.snapshot.step:
                    self._note_staleness(floor)
                    return False
                arrs = self._data.vmget(specs, wire=self._wire)
                if any(a is None for a in arrs):
                    # the namespace has no full model yet (cohort
                    # still initializing): nothing to serve
                    self.snapshot_rejects += 1
                    return False
                if self.live_writers() != members or \
                        self._snap_parities(members) != parities:
                    # a writer opened/completed a round (or membership
                    # moved) during the pull: the set may mix steps —
                    # discard and retry; the old snapshot stays up
                    self.snapshot_retries_used += 1
                    continue
                values = {}
                i = 0
                for nm, nparts in layout:
                    parts = [np.asarray(arrs[i + k])
                             for k in range(nparts)]
                    i += nparts
                    host = (parts[0] if nparts == 1
                            else np.concatenate(parts, axis=0))
                    if not (host.flags.writeable and
                            host.flags.c_contiguous):
                        host = np.array(host)   # a decoded wire buffer
                    values[nm] = torch.from_numpy(host).to(self.device)
                pulled = sum(
                    wire_nbytes(int(np.prod(shape)) if shape else 1,
                                self._wire)
                    for _, shape in specs)
                self.snapshot = SnapshotView(floor, values, members,
                                             pulled)
                self.wire_bytes += pulled
                self.snapshot_pulls += 1
                # an accepted dense bump flushes the sparse cache:
                # rows cached against the previous step next to new
                # dense weights would be a mixed-version serve
                self.row_cache.invalidate_all()
                self._note_staleness(floor)
                self._tel.count('serve/snapshot_pulls')
                self._tel.gauge('serve/snapshot_step', floor)
                return True
        self.snapshot_rejects += 1
        logging.debug('%s: snapshot pull kept losing to writers after '
                      '%d attempts; serving the previous snapshot',
                      self.name, self.snapshot_retries)
        return False

    def _require_connected(self):
        """Closed (or never connected): the connection error the serve
        loop already logs and retries on. The caller holds the lock."""
        if self._data is None:
            raise OSError('%s: not connected' % self.name)

    def _note_staleness(self, floor):
        if self.snapshot is None:
            return
        stale = max(0, floor - self.snapshot.step)
        self.staleness_steps = stale
        self.staleness_max_steps = max(self.staleness_max_steps, stale)
        if stale > self.staleness_bound:
            self.staleness_violations += 1
        self._tel.gauge('serve/staleness_steps', stale)

    # -- query plane -------------------------------------------------------
    def lookup(self, table, indices):
        """Serve embedding rows of sparse ``table``: row cache first,
        one batched ``vmgetrows`` for the misses. Returns a
        ``[len(indices), ncols]`` float32 array."""
        t0 = time.perf_counter()
        rows, ncols = self._sparse[table]
        idx = np.asarray(indices, dtype=np.int32).reshape(-1)
        out = np.empty((idx.size, ncols), dtype=np.float32)
        with self._lock:
            self._require_connected()
            return self._lookup_locked(table, idx, ncols, out, t0)

    def _lookup_locked(self, table, idx, ncols, out, t0):
        missing = []
        for j, r in enumerate(idx):
            cached = self.row_cache.get(table, int(r))
            if cached is None:
                missing.append(j)
            else:
                out[j] = cached
        if missing:
            want = np.unique(idx[missing])
            fetched = self._data.vmgetrows(
                [(self._key('var/%s' % table), want, ncols)],
                wire=self._wire)[0]
            if fetched is None:
                raise KeyError('sparse table %r is not on the plane '
                               '(key %s)' % (table,
                                             self._key('var/%s' % table)))
            by_row = {int(r): fetched[k] for k, r in enumerate(want)}
            for r, vec in by_row.items():
                self.row_cache.put(table, r, vec)
            for j in missing:
                out[j] = by_row[int(idx[j])]
            self.wire_bytes += wire_nbytes(int(want.size) * ncols,
                                           self._wire)
        wall_ms = 1e3 * (time.perf_counter() - t0)
        self.lookups += 1
        self.rows_served += idx.size
        now = time.monotonic()
        if self._t_first_lookup is None:
            self._t_first_lookup = now
        self._t_last_lookup = now
        if len(self._lookup_ms) >= self._lookup_ms_cap:
            # keep the newest window: percentiles should describe the
            # current regime, not the cold start
            self._lookup_ms = self._lookup_ms[self._lookup_ms_cap // 2:]
        self._lookup_ms.append(wall_ms)
        self._tel.observe('serve/lookup_ms', wall_ms)
        return out

    def forward(self, fn, *args, **kwargs):
        """Run a caller torch function against the pinned dense
        snapshot: ``fn(values, *args, **kwargs)`` where ``values`` is
        the snapshot's name -> tensor dict on the replica's device, under
        ``torch.no_grad``. Raises until the first snapshot lands — a
        replica must never silently serve from nothing."""
        snap = self.snapshot
        if snap is None:
            raise RuntimeError(
                '%s: no dense snapshot accepted yet (cohort still '
                'initializing, or refresh() never ran)' % self.name)
        with torch.no_grad():
            return fn(snap.values, *args, **kwargs)

    # -- stats -------------------------------------------------------------
    def serve_stats(self):
        span = ((self._t_last_lookup - self._t_first_lookup)
                if self._t_first_lookup is not None and
                self._t_last_lookup > self._t_first_lookup else 0.0)
        return {
            'replica': self.name,
            'lookups': self.lookups,
            'rows_served': self.rows_served,
            'qps': (self.lookups / span) if span else 0.0,
            'lookup_p50_ms': _percentile(self._lookup_ms, 50),
            'lookup_p99_ms': _percentile(self._lookup_ms, 99),
            'snapshot_step': self.snapshot.step if self.snapshot
            else -1,
            'snapshot_pulls': self.snapshot_pulls,
            'snapshot_retries': self.snapshot_retries_used,
            'snapshot_rejects': self.snapshot_rejects,
            'staleness_steps': self.staleness_steps,
            'staleness_max_steps': self.staleness_max_steps,
            'staleness_bound_steps': self.staleness_bound,
            'staleness_violations': self.staleness_violations,
            'mixed_version_reads': self.mixed_version_reads,
            'row_cache_hit_rate': self.row_cache.hit_rate,
            'row_cache': self.row_cache.stats(),
            'wire_bytes': self.wire_bytes,
        }
