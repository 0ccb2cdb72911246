"""Online performance sentry: live straggler detection with phase
attribution and continuous cost-model recalibration (the counterpart of
``autodist_tpu/telemetry/monitor.py``; framework-neutral, so copied).

The chief-side :class:`CohortMonitor` streams the span batches the loose
session pushes (:mod:`autodist_tpu_torch.telemetry.aggregate`) and turns
them into decisions:

- **rolling robust statistics** (median/MAD) of per-worker step wall
  and per-phase splits (gate-wait / pull / compute / push / pipeline,
  the spans the loose session records), warm-up steps excluded from
  every baseline (a slow first step, allocator warm-up or a kernel build
  must not read as straggling);
- **straggler verdicts with phase attribution**: the detection
  statistic is per-worker WORK time (step wall minus gate-wait); under
  a bounded-staleness gate one slow worker inflates every wall within a
  staleness window, so wall-only detection would accuse the whole
  cohort or nobody. A work-slow worker is a culprit, attributed to the
  phase carrying its excess ("86% of the excess is push => link or
  host"); a wall-slow-but-work-fast worker is an ``upstream_victim``
  (its excess is gate-wait: it waits on the culprit) and is never an
  exclude candidate;
- **slowdown / recovered flight events**: every verdict transition
  lands in the crash flight recorder ring, so a crash dump carries the
  perf context leading up to it;
- **continuous recalibration**: every data-plane RPC span is a link
  sample (``t ~ alpha + B * beta``, the point-to-point cost shape
  ``calibrate.fit_alpha_beta`` inverts), so the monitor refits the cost
  model's link constants from live traffic on the
  ``AUTODIST_RECALIBRATE_EVERY`` cadence and hands measured, not
  analytic, constants to the chief's ``_replan_for_world`` re-rank.
  ``recalibrate_from_timeline`` accepts a profiler trace's collective
  timeline (``utils/profiling``) for the per-tier fit.

Detection is observability, never actuation: the
``AUTODIST_STRAGGLER_POLICY`` knob stops at ``advise`` (verdicts surface
in ``health_report``'s perf section with an ``exclude_candidate`` flag);
the peer-failure policy stays the sole actuator.
"""
import statistics
import threading
import time
from collections import OrderedDict, deque

from autodist_tpu_torch.const import ENV
from autodist_tpu_torch.utils import logging

#: span name -> phase column: the monitor's verdicts read phases through
#: :func:`phase_splits` (the JAX package's ``tools/trace_view.py --json``
#: reads the same mapping), so a renamed session span breaks one shared
#: test instead of silently desynchronizing the consumers.
PHASE_OF = {
    'staleness_gate': 'gate',
    'pull_vars': 'pull',
    'push_deltas': 'push',
    'pipeline_wait': 'pipeline',
}

#: the derived columns, in render order ('step' is the whole wall)
PHASES = ('gate', 'pull', 'push', 'pipeline', 'compute')

#: classification per dominant excess phase. 'host_compute' is the
#: host-side default; when the worker's roofline observatory
#: (telemetry/roofline.py) has reported a device regime for it, the
#: verdict refines to 'compute_bound' / 'memory_bound' — the
#: device-plane attribution the runbook's MFU section keys on.
_CLASSIFY = {
    'gate': 'upstream_victim',      # waiting on someone else's step
    'pull': 'link_or_host',
    'push': 'link_or_host',
    'pipeline': 'link_or_host',
    'compute': 'host_compute',
}

#: roofline regime -> refined compute-phase classification
_REGIME_CLASSIFY = {'compute': 'compute_bound',
                    'memory': 'memory_bound'}


def _median(vals):
    return statistics.median(vals) if vals else 0.0


def phase_splits(records):
    """Cohort span records -> ``{worker: {step: {phase: seconds}}}``.

    One entry per (worker, step) carrying the ``step`` wall plus the
    gate / pull / push / pipeline phase durations and the derived
    ``compute`` remainder (``step`` minus the measured phases, clamped
    at zero — at pipeline depth 2 the push overlaps the next step's
    window, so the subtraction is a uniform approximation across
    workers, which is all the cross-worker EXCESS comparison needs).
    Records without a ``step`` tag or a duration are skipped.
    """
    out = {}
    for rec in records:
        tags = rec.get('tags') or {}
        if 'step' not in tags or 'dur' not in rec:
            continue
        name = rec.get('name')
        phase = 'step' if name == 'step' else PHASE_OF.get(name)
        if phase is None:
            continue
        worker = rec.get('worker') or tags.get('worker') or 'p0'
        try:
            step = int(tags['step'])
        except (TypeError, ValueError):
            continue
        d = out.setdefault(worker, {}).setdefault(step, {})
        d[phase] = d.get(phase, 0.0) + float(rec['dur'])
    for steps in out.values():
        for d in steps.values():
            if 'step' in d:
                d['compute'] = max(
                    0.0, d['step'] - sum(d.get(p, 0.0) for p in
                                         ('gate', 'pull', 'push',
                                          'pipeline')))
    return out


def phase_medians(records, warmup_steps=0):
    """Per-worker per-phase medians over cohort span records:
    ``{worker: {'steps': n, 'step': med, 'gate': med, ...}}`` — the
    aggregate columns a trace viewer renders and the
    baseline table the monitor's attribution compares against. Steps
    at or below ``warmup_steps`` are excluded (compile noise)."""
    out = {}
    for worker, steps in phase_splits(records).items():
        rows = {st: d for st, d in steps.items() if st > warmup_steps}
        if not rows:
            continue
        agg = {'steps': len(rows)}
        for phase in ('step',) + PHASES:
            vals = [d[phase] for d in rows.values() if phase in d]
            if vals:
                agg[phase] = round(_median(vals), 6)
        out[worker] = agg
    return out


class CohortMonitor:
    """Streaming consumer of the cohort's span batches: rolling robust
    per-worker statistics, straggler verdicts with phase attribution,
    slowdown/recovered flight events, the autoscale step-time signal,
    and continuous α-β recalibration.

    Chief-side in production (:attr:`LooseSession.monitor`); also
    usable offline — :meth:`ingest` takes any record list, and
    ``client``/``ns``/``workers``
    are only needed for :meth:`poll`'s live incremental collection.

    Args:
        client: a :class:`CoordClient` for live polling (optional).
        ns: the run namespace live batches are pushed under.
        workers: worker-name list, or a zero-arg callable returning the
            LIVE membership (exclusions drop out of baselines).
        window: rolling-stat sample bound per worker
            (``AUTODIST_MONITOR_WINDOW``).
        detect_samples: how many most-recent samples the detection
            median uses — small so a straggler surfaces within a few
            steps of onset instead of half a window later.
        warmup_steps: steps at or below this id never enter baselines
            (warm-up: a slow first step must not read as
            straggling).
        mad_threshold: culprit gate, in scaled MADs of the other
            workers' work times (only applied when >= 3 workers give
            the MAD meaning).
        min_ratio: culprit/victim gate as a ratio over the median of
            the OTHER workers (leave-one-out — the straggler must not
            drag its own baseline).
        min_excess_s: absolute excess floor; microsecond jitter on a
            microsecond baseline is not a slowdown.
        confirmations: consecutive detection rounds before a verdict
            ISSUES (anti-flap hysteresis): one noisy window — a
            post-compile step, a GC pause — must not fire a slowdown
            event that recovers on the next poll. Costs at most
            ``confirmations`` poll rounds of latency, well inside the
            5-step detection budget.
        policy: ``off`` | ``warn`` | ``advise``
            (``AUTODIST_STRAGGLER_POLICY``); ``off`` keeps statistics
            but issues no verdicts, ``advise`` marks non-victim
            culprits ``exclude_candidate`` in the snapshot. Detection
            never actuates either way.
        flight: the :class:`FlightRecorder` verdict transitions land
            in (default: the process singleton).
    """

    def __init__(self, client=None, ns=None, workers=None, window=None,
                 detect_samples=5, warmup_steps=2, mad_threshold=3.0,
                 min_ratio=1.5, min_excess_s=1e-3, min_samples=3,
                 confirmations=2, policy=None, flight=None,
                 local_worker=None):
        self._client = client
        self._ns = ns
        self._workers = workers
        self.window = int(window or ENV.AUTODIST_MONITOR_WINDOW.val)
        self.detect_samples = max(1, int(detect_samples))
        self.warmup_steps = int(warmup_steps)
        self.mad_threshold = float(mad_threshold)
        self.min_ratio = float(min_ratio)
        self.min_excess_s = float(min_excess_s)
        self.min_samples = max(1, int(min_samples))
        self.confirmations = max(1, int(confirmations))
        self.policy = policy if policy is not None else \
            ENV.AUTODIST_STRAGGLER_POLICY.val
        if flight is None:
            from autodist_tpu_torch.telemetry import flight as _flight
            flight = _flight.recorder()
        self._flight = flight
        # the local worker's batches are TAPPED at drain time
        # (:meth:`ingest_local`) instead of fetched back off the wire:
        # the chief's own batches are the cohort's biggest, and
        # re-reading + JSON-decoding them every poll was the poll
        # cost's bulk. Poll skips this worker in the wire collection.
        self.local_worker = local_worker
        self._pending_local = deque(maxlen=16384)
        self._lock = threading.Lock()
        # per-worker bounded {step: seconds} maps — keyed by step so a
        # record seen twice (the chief observes its own step locally
        # AND pushes it to the wire) can never double-count
        self._walls = {}     # worker -> OrderedDict[step -> wall]
        self._phases = {}    # worker -> OrderedDict[step -> {phase: s}]
        # worker -> latest roofline record (regime, mfu, hbm_frac):
        # fed by observe_roofline (the chief's own tracker) and by
        # 'roofline' telemetry events riding the span batches (every
        # other worker's) — refines host_compute verdicts into
        # compute_bound / memory_bound
        self._roofline = {}
        self._cursor = {}    # worker -> last consumed batch seq
        self._active = {}    # worker -> live verdict dict
        self._pending = {}   # worker -> consecutive detection count
        # bounded like every other telemetry buffer (a flapping
        # borderline worker on a week-long run must not grow the
        # transition audit — and the snapshot that serializes it —
        # without bound)
        self.events = deque(maxlen=256)
        self._link_samples = deque(maxlen=max(64, 8 * self.window))
        self._params = None              # latest refit CostModelParams
        self.recalibrations = deque(maxlen=128)  # the drift trajectory
        self.last_step = 0
        self.polls = 0
        self.poll_s = 0.0                # monitor overhead accounting
        self.records_ingested = 0

    # -- ingestion ---------------------------------------------------------
    def _bounded(self, table, worker):
        d = table.setdefault(worker, OrderedDict())
        while len(d) > self.window:
            d.popitem(last=False)
        return d

    def observe_step(self, worker, step, wall):
        """Record one locally-measured step wall (the chief's own steps
        — its batches land on the wire too, but only on the push
        cadence; local observation keeps its baseline current)."""
        if step <= self.warmup_steps:
            return
        with self._lock:
            self._bounded(self._walls, worker)[int(step)] = float(wall)
            self.last_step = max(self.last_step, int(step))

    def reset_baselines(self):
        """Drop every rolling window, pending confirmation, active
        verdict and per-worker roofline regime — the batch cursor,
        link samples, recalibration state and event audit survive.
        Operators call this after a known disturbance (a replan swap,
        a membership change, a checkpoint restore) so pre-disturbance
        samples cannot seed false verdicts — or steer a
        compute/memory-bound refinement with the OLD program's regime
        — against the new steady state."""
        with self._lock:
            self._walls.clear()
            self._phases.clear()
            self._pending.clear()
            self._active.clear()
            self._roofline.clear()

    def observe_roofline(self, worker, record):
        """Record a worker's latest roofline sample
        (``RooflineTracker.observe_step``'s record): its regime
        refines that worker's compute-phase straggler verdicts into
        compute_bound / memory_bound. The chief calls this for its
        own tracker; remote workers' samples arrive as ``roofline``
        telemetry events through :meth:`ingest`."""
        if not record:
            return
        with self._lock:
            self._roofline[worker] = dict(record)

    def ingest(self, records):
        """Feed cohort span records (the ``telemetry.aggregate``
        schema): step walls and phase splits enter the rolling windows
        (warm-up steps excluded), every data-plane RPC span becomes a
        link sample for :meth:`recalibrate`, and ``roofline`` events
        update the per-worker device-regime table."""
        if not records:
            return
        splits = phase_splits(records)
        with self._lock:
            self.records_ingested += len(records)
            for rec in records:
                if rec.get('name') != 'roofline':
                    continue
                tags = rec.get('tags') or {}
                worker = rec.get('worker') or tags.get('worker')
                if worker:
                    self._roofline[worker] = dict(tags)
            for worker, steps in splits.items():
                walls = self._bounded(self._walls, worker)
                phases = self._bounded(self._phases, worker)
                for step, d in sorted(steps.items()):
                    if step <= self.warmup_steps:
                        continue
                    if 'step' in d:
                        walls[step] = d['step']
                    phases[step] = dict(phases.get(step, {}), **d)
                    self.last_step = max(self.last_step, step)
            for rec in records:
                if rec.get('name') not in ('rpc', 'rpc_batch'):
                    continue
                tags = rec.get('tags') or {}
                dur = rec.get('dur')
                frames = max(1, int(tags.get('frames', 1) or 1))
                if not dur or dur <= 0:
                    continue
                # one point-to-point transfer ≈ α + B·β: exactly the
                # 'collective-permute' cost shape the calibration
                # least-squares already inverts (group size 2 = one
                # hop). Batches amortize to per-frame samples.
                self._link_samples.append(
                    (float(tags.get('bytes', 0) or 0) / frames,
                     'collective-permute', float(dur) / frames, 2))

    def ingest_local(self, records):
        """Zero-wire tap for the local worker's just-drained batch:
        the session hands the records here at push time (they still go
        to the wire for the cohort trace), and :meth:`poll` ingests
        them without fetching + JSON-decoding them back — the local
        worker's batches are the biggest, and re-reading them was the
        poll cost's bulk. Thread-safe (the depth-2 pipeline thread
        pushes)."""
        if not records:
            return
        with self._lock:
            self._pending_local.extend(records)

    def poll(self):
        """Live incremental collection: fetch every batch pushed since
        the previous poll (per-worker cursor on the atomic batch
        counter — nothing is re-read; the local worker's batches come
        from the :meth:`ingest_local` tap instead of the wire), ingest
        it, refresh verdicts. Returns the new-record count. Wall time
        spent here accumulates on :attr:`poll_s` — the monitor's own
        overhead is part of the telemetry budget it polices."""
        if self._client is None or self._ns is None:
            raise RuntimeError('CohortMonitor.poll() needs client + ns '
                               '(offline use feeds ingest() directly)')
        t0 = time.perf_counter()
        workers = self._workers() if callable(self._workers) \
            else list(self._workers or [])
        # membership pruning: a worker gone from the LIVE list (an
        # exclusion) must not keep skewing baselines with its frozen
        # last samples — drop its windows and any open verdict
        # silently (its departure story is the exclusion machinery's,
        # not a 'recovered' transition)
        current = set(workers)
        with self._lock:
            for w in [w for w in self._walls if w not in current]:
                self._walls.pop(w, None)
                self._phases.pop(w, None)
                self._pending.pop(w, None)
                self._active.pop(w, None)
        with self._lock:
            local = list(self._pending_local)
            self._pending_local.clear()
        from autodist_tpu_torch.telemetry.aggregate import \
            collect_new_records
        records = collect_new_records(
            self._client, self._ns,
            [w for w in workers if w != self.local_worker],
            self._cursor)
        self.ingest(local)
        self.ingest(records)
        self.update_verdicts()
        self.polls += 1
        self.poll_s += time.perf_counter() - t0
        return len(records) + len(local)

    # -- rolling robust statistics ----------------------------------------
    def worker_stats(self):
        """Per-worker rolling statistics over the RECENT detection
        window (the last ``detect_samples`` steps): median wall,
        median WORK (wall minus gate-wait — the detection statistic),
        and per-phase medians from the same steps. Recent-window
        everywhere on purpose: the phase medians feed the verdict's
        attribution, and a full-window phase median would lag the wall
        statistic by half a window — a straggler detected 3 steps
        after onset would be attributed against mostly-healthy phase
        samples and land on the wrong phase. The full ``window`` is
        the retention bound (:meth:`snapshot` reports its size)."""
        with self._lock:
            walls = {w: dict(d) for w, d in self._walls.items()}
            phases = {w: dict(d) for w, d in self._phases.items()}
        out = {}
        for worker, d in walls.items():
            recent_steps = sorted(d)[-self.detect_samples:]
            recent_walls = [d[s] for s in recent_steps]
            ph = phases.get(worker, {})
            work = [max(0.0, d[s] - ph.get(s, {}).get('gate', 0.0))
                    for s in recent_steps]
            stat = {
                'samples': len(d),
                'last_step': max(d) if d else 0,
                'wall_s': _median(recent_walls),
                'work_s': _median(work),
                'phases': {},
            }
            for phase in PHASES:
                vals = [ph[s][phase] for s in recent_steps
                        if phase in ph.get(s, {})]
                if vals:
                    stat['phases'][phase] = _median(vals)
            out[worker] = stat
        return out

    def _attribute(self, worker, stats, phases=PHASES):
        """Excess decomposition for one worker vs the median of the
        OTHERS, per phase: shares, the dominant phase, and the
        classification the runbook keys on. ``phases`` narrows the
        decomposition — a WORK verdict attributes over the non-gate
        phases (its statistic already subtracted gate-wait; under a
        staleness gate the culprit's own gate time also inflates as
        the cohort convoys behind it, and letting that pollute the
        attribution would label every culprit a victim)."""
        mine = stats[worker]['phases']
        excess = {}
        for phase in phases:
            others = [s['phases'][phase]
                      for w, s in stats.items()
                      if w != worker and phase in s['phases']]
            if phase in mine and others:
                excess[phase] = max(0.0, mine[phase] - _median(others))
            elif phase in mine:
                excess[phase] = mine[phase]
        total = sum(excess.values())
        shares = {p: (v / total if total > 0 else 0.0)
                  for p, v in excess.items()}
        attributed = max(shares, key=shares.get) if shares else 'compute'
        return {
            'phase_excess_s': {p: round(v, 6)
                               for p, v in excess.items()},
            'phase_shares': {p: round(v, 4) for p, v in shares.items()},
            'attributed_phase': attributed,
            'classification': _CLASSIFY.get(attributed, 'link_or_host'),
        }

    def update_verdicts(self):
        """Recompute verdicts from the rolling statistics and record
        every transition (``slowdown`` on issue, ``recovered`` on
        clearance) into the flight recorder. Policy ``off`` clears and
        issues nothing; single-worker cohorts never self-accuse (there
        is no peer baseline to be slow against)."""
        if self.policy == 'off':
            return []
        stats = self.worker_stats()
        eligible = {w: s for w, s in stats.items()
                    if s['samples'] >= self.min_samples}
        verdicts = {}
        if len(eligible) >= 2:
            for worker, s in eligible.items():
                others = [o for w, o in eligible.items() if w != worker]
                v = self._judge(worker, s, others, stats)
                if v is not None:
                    verdicts[worker] = v
        # a victim presupposes a culprit: a worker whose excess is all
        # gate-wait with NO work-slow worker anywhere is waiting on
        # host tails / the input pipeline, not on a straggler — drop
        # victim (wall-statistic) verdicts in rounds where nobody is
        # actually work-slow, so an input-bound cohort never
        # self-accuses
        if not any(v['statistic'] == 'work' for v in verdicts.values()):
            verdicts = {}
        with self._lock:
            # hysteresis: a detection must repeat `confirmations`
            # consecutive rounds before it ISSUES — one noisy window
            # must not fire a slowdown that recovers next poll
            detected = set(verdicts)
            for worker in list(self._pending):
                if worker not in detected:
                    self._pending.pop(worker)
            confirmed = set(self._active)
            for worker in detected:
                if worker in self._active:
                    confirmed.add(worker)
                    continue
                n = self._pending.get(worker, 0) + 1
                self._pending[worker] = n
                if n >= self.confirmations:
                    confirmed.add(worker)
                    self._pending.pop(worker, None)
            verdicts = {w: v for w, v in verdicts.items()
                        if w in confirmed}
            now_slow = set(verdicts)
            was_slow = set(self._active)
            for worker in sorted(now_slow - was_slow):
                v = verdicts[worker]
                self._flight.record(
                    'slowdown', worker=worker, step=v['step'],
                    phase=v['attributed_phase'],
                    classification=v['classification'],
                    mad_score=v['mad_score'], ratio=v['ratio'])
                self.events.append(dict(v, kind='slowdown'))
                logging.warning(
                    'monitor: %s is slow at step %d — %.1fms vs cohort '
                    '%.1fms (%.1f MADs, ratio %.2f), %d%% of the '
                    'excess is %s ⇒ %s', worker, v['step'],
                    v['stat_s'] * 1e3, v['baseline_s'] * 1e3,
                    v['mad_score'], v['ratio'],
                    int(100 * v['phase_shares'].get(
                        v['attributed_phase'], 0.0)),
                    v['attributed_phase'], v['classification'])
            for worker in sorted(was_slow - now_slow):
                step = self.last_step
                self._flight.record('recovered', worker=worker,
                                    step=step)
                self.events.append({'kind': 'recovered',
                                    'worker': worker, 'step': step})
                logging.info('monitor: %s recovered by step %d',
                             worker, step)
                self._active.pop(worker, None)
            for worker, v in verdicts.items():
                self._active[worker] = v
            return list(self._active.values())

    def _judge(self, worker, s, others, stats):
        """One worker against the leave-one-out cohort baseline.
        Culprit: WORK time (wall minus gate-wait) beyond the ratio +
        MAD gates. Victim: wall slow but work fast — its excess is
        gate-wait, it is waiting on the culprit."""
        def gates(mine, baseline, devs):
            if baseline < 0 or mine - baseline < self.min_excess_s:
                return None, None
            ratio = mine / max(baseline, 1e-9)
            mad = 1.4826 * _median(devs) if len(devs) >= 2 else 0.0
            score = (mine - baseline) / mad if mad > 1e-12 \
                else float('inf')
            if ratio < self.min_ratio:
                return None, None
            if len(devs) >= 2 and score < self.mad_threshold:
                return None, None
            return ratio, score

        work_base = _median([o['work_s'] for o in others])
        work_devs = [abs(o['work_s'] - work_base) for o in others]
        ratio, score = gates(s['work_s'], work_base, work_devs)
        kind, stat, base = 'work', s['work_s'], work_base
        if ratio is None:
            wall_base = _median([o['wall_s'] for o in others])
            wall_devs = [abs(o['wall_s'] - wall_base) for o in others]
            ratio, score = gates(s['wall_s'], wall_base, wall_devs)
            if ratio is None:
                return None
            kind, stat, base = 'wall', s['wall_s'], wall_base
        att = self._attribute(
            worker, stats,
            phases=tuple(p for p in PHASES if p != 'gate')
            if kind == 'work' else PHASES)
        if kind == 'wall' and att['attributed_phase'] != 'gate':
            # wall-slow but neither work-slow nor gate-dominated:
            # coupled slowdown noise, not an accusable verdict
            return None
        verdict = {
            'worker': worker,
            'step': s['last_step'],
            'statistic': kind,
            'stat_s': round(stat, 6),
            'baseline_s': round(base, 6),
            'wall_s': round(s['wall_s'], 6),
            'work_s': round(s['work_s'], 6),
            'excess_s': round(stat - base, 6),
            'ratio': round(ratio, 3),
            'mad_score': round(min(score, 999.0), 2),
        }
        verdict.update(att)
        if kind == 'wall':
            verdict['classification'] = 'upstream_victim'
        elif verdict['classification'] == 'host_compute':
            # device-plane refinement: when the roofline observatory
            # has a regime for this worker, a compute-phase excess is
            # attributable to the device roofline (compute_bound /
            # memory_bound) instead of the host-side catch-all —
            # which knob acts on it differs (docs/design/roofline.md)
            roof = self._roofline.get(worker)
            regime = (roof or {}).get('roofline_regime') or \
                (roof or {}).get('regime')
            refined = _REGIME_CLASSIFY.get(regime)
            if refined:
                verdict['classification'] = refined
                verdict['roofline'] = {
                    'regime': regime,
                    'mfu': roof.get('mfu'),
                    'hbm_frac': roof.get('hbm_frac'),
                    'step': roof.get('step'),
                }
        verdict['exclude_candidate'] = bool(
            self.policy == 'advise' and
            verdict['classification'] != 'upstream_victim')
        return verdict

    def verdicts(self):
        """The currently-active verdicts (list of dicts)."""
        with self._lock:
            return [dict(v) for v in self._active.values()]

    # -- the closed loops --------------------------------------------------
    def metrics(self):
        """The autoscale policy's sampled metrics: ``step_time_s`` is
        the cohort median of per-worker recent median walls — the
        signal ``autoscale_policy(step_time_target_s=...)`` compares,
        wired via ``AutoscaleController(metrics_source=...)``."""
        stats = self.worker_stats()
        walls = [s['wall_s'] for s in stats.values() if s['samples']]
        if not walls:
            return {}
        return {'step_time_s': _median(walls),
                'straggler_verdicts': len(self._active)}

    def add_link_sample(self, nbytes, seconds, frames=1):
        """Record one measured point-to-point transfer (tests / custom
        feeds; live ingestion does this from RPC spans)."""
        frames = max(1, int(frames))
        with self._lock:
            self._link_samples.append(
                (float(nbytes) / frames, 'collective-permute',
                 float(seconds) / frames, 2))

    def recalibrate(self, base_params, num_replicas=2, cross_node=False,
                    step=None, min_link_samples=8):
        """Refit the link α-β from the accumulated live samples onto a
        copy of ``base_params`` (the tier ``cross_node`` selects — the
        same convention as ``calibrate.calibrate_from_timeline``).
        Returns the refit params (also kept as
        :meth:`calibrated_params`) or None when the fit is degenerate
        (too few samples, or all the same size), leaving the previous
        calibration in place. Every successful refit appends to
        :attr:`recalibrations` — the drift trajectory."""
        import dataclasses

        from autodist_tpu_torch.simulator import calibrate
        with self._lock:
            samples = list(self._link_samples)
        if len(samples) < min_link_samples:
            return None
        fit = calibrate.fit_alpha_beta(samples, max(2, num_replicas))
        if fit is None:
            logging.info('monitor: recalibration fit degenerate over '
                         '%d link samples; keeping previous constants',
                         len(samples))
            return None
        alpha, beta = fit
        if cross_node:
            params = dataclasses.replace(
                base_params, alpha_dcn_s=alpha,
                beta_dcn_s_per_byte=beta, calibrated=True)
        else:
            params = dataclasses.replace(
                base_params, alpha_ici_s=alpha,
                beta_ici_s_per_byte=beta, calibrated=True)
        a0, b0 = base_params.link(cross_node=cross_node)
        rec = {'step': step if step is not None else self.last_step,
               'tier': 'DCN' if cross_node else 'ICI',
               'alpha_s': round(alpha, 9),
               'beta_s_per_byte': beta,
               'samples': len(samples),
               'beta_vs_analytic': round(beta / b0, 4) if b0 else None,
               'alpha_vs_analytic': round(alpha / a0, 4) if a0 else None}
        with self._lock:
            self._params = params
            self.recalibrations.append(rec)
        logging.info(
            'monitor: recalibrated %s tier from %d live link samples: '
            'alpha=%.3gs beta=%.3gs/B (%.2fx analytic beta)',
            rec['tier'], rec['samples'], alpha, beta,
            rec['beta_vs_analytic'] or 0.0)
        return params

    def recalibrate_from_timeline(self, base_params, timeline,
                                  num_replicas, cross_node=False,
                                  devices_per_node=0, step=None):
        """Per-tier refit from a REAL collective timeline (a captured
        profiler trace) — ``calibrate.calibrate_from_timeline`` does
        the math; the monitor keeps the result + trajectory entry like
        :meth:`recalibrate`."""
        from autodist_tpu_torch.simulator import calibrate
        params = calibrate.calibrate_from_timeline(
            base_params, timeline, num_replicas,
            cross_node=cross_node, devices_per_node=devices_per_node)
        if not getattr(params, 'calibrated', False):
            return None
        with self._lock:
            self._params = params
            self.recalibrations.append({
                'step': step if step is not None else self.last_step,
                'tier': 'per-tier (timeline)',
                'alpha_s': params.alpha_dcn_s if cross_node
                else params.alpha_ici_s,
                'beta_s_per_byte': params.beta_dcn_s_per_byte
                if cross_node else params.beta_ici_s_per_byte,
                'samples': len(timeline or [])})
        return params

    def calibrated_params(self, default=None):
        """The latest refit :class:`CostModelParams` (``default`` when
        no refit has landed yet) — what ``_replan_for_world`` prices
        re-ranks with so growth re-plans use measured link constants."""
        with self._lock:
            return self._params if self._params is not None else default

    # -- reporting ---------------------------------------------------------
    def snapshot(self):
        """JSON-able state for ``health_report``'s perf section, BENCH
        records and the CLI: policy, per-worker rolling stats, active
        verdicts, the slowdown/recovered transition audit, the
        recalibration trajectory and the monitor's own overhead."""
        stats = self.worker_stats()
        workers = {}
        for worker, s in sorted(stats.items()):
            workers[worker] = {
                'samples': s['samples'],
                'last_step': s['last_step'],
                'wall_s': round(s['wall_s'], 6),
                'work_s': round(s['work_s'], 6),
                'phases': {p: round(v, 6)
                           for p, v in s['phases'].items()},
            }
        with self._lock:
            return {
                'policy': self.policy,
                'window': self.window,
                'warmup_steps': self.warmup_steps,
                'last_step': self.last_step,
                'workers': workers,
                'verdicts': [dict(v) for v in self._active.values()],
                'events': [dict(e) for e in self.events],
                'slowdowns': sum(1 for e in self.events
                                 if e['kind'] == 'slowdown'),
                'recoveries': sum(1 for e in self.events
                                  if e['kind'] == 'recovered'),
                'recalibrations': [dict(r)
                                   for r in self.recalibrations],
                'roofline': {w: dict(r)
                             for w, r in sorted(
                                 self._roofline.items())},
                'step_time_s': round(_median(
                    [s['wall_s'] for s in stats.values()]), 6)
                if stats else 0.0,
                'polls': self.polls,
                'poll_s': round(self.poll_s, 6),
                'records_ingested': self.records_ingested,
            }


def format_snapshot(snap):
    """Human-readable cohort table + verdicts (chief-side logging)."""
    if not snap or not snap.get('workers'):
        return '(no monitor samples)'
    lines = ['policy=%s window=%d last_step=%d  cohort step time '
             '%.1fms' % (snap.get('policy', '?'),
                         snap.get('window', 0),
                         snap.get('last_step', 0),
                         1e3 * snap.get('step_time_s', 0.0))]
    header = ('  %-6s %6s %9s %9s' % ('worker', 'steps', 'wall', 'work')
              + ''.join(' %9s' % p for p in PHASES))
    lines.append(header)
    for worker, s in snap['workers'].items():
        row = '  %-6s %6d %8.1fms %8.1fms' % (
            worker, s['samples'], 1e3 * s['wall_s'], 1e3 * s['work_s'])
        for p in PHASES:
            v = s['phases'].get(p)
            row += ' %8.1fms' % (1e3 * v) if v is not None \
                else ' %9s' % '-'
        lines.append(row)
    for v in snap.get('verdicts', []):
        lines.append(
            '  VERDICT %s: %s %.1fms vs %.1fms (%.1f MADs, ratio '
            '%.2f) — %d%% of excess in %s ⇒ %s%s'
            % (v['worker'], v['statistic'], 1e3 * v['stat_s'],
               1e3 * v['baseline_s'], v['mad_score'], v['ratio'],
               int(100 * v['phase_shares'].get(
                   v['attributed_phase'], 0.0)),
               v['attributed_phase'], v['classification'],
               ' [exclude candidate]' if v.get('exclude_candidate')
               else ''))
    if not snap.get('verdicts'):
        lines.append('  no active verdicts')
    for r in snap.get('recalibrations', []):
        lines.append(
            '  recalibrated %s @step %s: alpha=%.3gs beta=%.3gs/B '
            '(%s samples)' % (r.get('tier'), r.get('step'),
                              r.get('alpha_s', 0.0),
                              r.get('beta_s_per_byte', 0.0),
                              r.get('samples', '?')))
    return '\n'.join(lines)
