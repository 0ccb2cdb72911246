"""Device-plane roofline observatory: per-step MFU accounting, memory
high-water attribution and per-entry achieved-vs-predicted collective
drift.

The counterpart of ``autodist_tpu/telemetry/roofline.py``:

- **per-step MFU** (:func:`cost_of` + :func:`classify_regime` +
  :class:`RooflineTracker`): FLOPs and bytes accessed of one call of the
  step callable — counted by ``torch.utils.flop_counter.FlopCounterMode``
  and a byte counter (each operand of an operator read once, each result
  written once: XLA's ``cost_analysis`` convention), plus the work each
  hand-written kernel launch reports (``kernels/work.py``: the counters
  do not see a ``ctypes`` launch), cached per callable — divided by the
  measured step wall and the topology's peak table
  (:data:`autodist_tpu_torch.resource_spec.PEAKS_BY_KIND` /
  ``Topology.peaks()``) into an ``mfu`` + ``roofline_regime``
  (compute|memory|comms-bound) record;
- **memory high-water attribution** (:func:`memory_of` +
  :func:`memory_drift`): the CUDA caching allocator's statistics joined
  against ``cost_model.memory_footprint``'s layout-aware estimate — that
  estimate drives AutoStrategy's budget pruning, so drift here means
  WRONG PRUNING;
- **per-entry collective drift** (:func:`drift_table`): every traced
  bucket/chunk carries its ``static_collective_schedule`` entry id
  (``plan.assign_entry_ids``); the traced collective timeline
  (``profiling.collective_timeline``) is joined back to entries and
  reported as achieved bytes/s per link tier vs the α-β prediction — a
  per-entry drift table ``calibrate.calibrate_from_drift`` fits from.

Everything degrades explicitly, never silently: a CPU run gets
``mfu: None`` with a named reason (no meaningful peak) and
``memory_of`` None, a trace with no collectives gets ``achieved_s: None``
rows, and the module never raises mid-run for a missing backend feature.
"""
import math
import statistics
import threading
import weakref
from collections import deque

from autodist_tpu_torch.const import ENV
from autodist_tpu_torch.utils import logging

# -- step introspection (graceful None degradation) -----------------------

#: (callable, argument signature) key -> cached cost dict. Entries are
#: evicted by a weakref finalizer on the callable (a bound method's
#: owner); the cache is bounded in practice by the number of distinct
#: step callables and batch shapes a process measures.
_COST_CACHE = {}
_COST_LOCK = threading.Lock()

#: operators that move no data: views alias their input, and an empty
#: tensor's memory is not written
_NO_TRAFFIC = ('empty', 'empty_like', 'empty_strided', 'new_empty',
               'new_empty_strided')


def _tensor_bytes(tree):
    import torch
    from torch.utils._pytree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _byte_counter():
    """A dispatch mode summing each operator's operand and result bytes
    (views and allocations move none)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Bytes(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not (getattr(func, 'is_view', False) or
                    func.overloadpacket.__name__ in _NO_TRAFFIC):
                self.total += _tensor_bytes((args, kwargs)) + \
                    _tensor_bytes(out)
            return out
    return _Bytes()


def _signature(tree):
    """The shape and dtype of every tensor or array leaf of ``tree`` (the
    type of any other leaf): what a compilation would key a program on."""
    from torch.utils._pytree import tree_leaves
    return tuple((tuple(x.shape), str(x.dtype)) if hasattr(x, 'shape')
                 and hasattr(x, 'dtype') else type(x).__name__
                 for x in tree_leaves(tree))


def _cache_key(fn, args, kwargs):
    """(key, the object whose life bounds the entry): the callable
    together with its arguments' signature (:func:`_signature`). A bound
    method is made anew at every attribute access, so it is keyed by its
    owner and function."""
    sig = _signature((args, kwargs))
    owner = getattr(fn, '__self__', None)
    if owner is not None and hasattr(fn, '__func__'):
        return (id(owner), id(fn.__func__), sig), owner
    return (id(fn), None, sig), fn


def cost_of(fn, *args, **kwargs):
    """FLOPs + bytes accessed of one call of a step callable, cached per
    callable and argument signature (every tensor leaf's shape and
    dtype, as a compilation keys its program).

    The first call for ``fn`` at a signature RUNS ``fn(*args, **kwargs)``
    once (a
    training step takes its step: the caller pays for it) under
    ``FlopCounterMode`` and a byte counter, and adds the work every
    hand-written kernel launch inside reports (``kernels/work.py``). On
    the CPU the kernels' plain versions run as operators the counters
    see, and nothing is reported: each product is counted once either
    way. Returns ``{'flops': float|None, 'bytes_accessed':
    float|None, 'kernel_launches': int}``; None when nothing was
    counted, or when counting failed (the step's own exception
    propagates). Later calls with the same callable and signature hit
    the cache and run nothing.
    """
    key, owner = _cache_key(fn, args, kwargs)
    with _COST_LOCK:
        hit = _COST_CACHE.get(key)
    if hit is not None:
        return dict(hit)
    from torch.utils.flop_counter import FlopCounterMode

    from autodist_tpu_torch.kernels import work
    counter = _byte_counter()
    with work.recording() as launched, \
            FlopCounterMode(display=False) as flops, counter:
        fn(*args, **kwargs)
    total_flops = float(flops.get_total_flops() + launched['flops'])
    total_bytes = float(counter.total + launched['bytes'])
    out = {'flops': total_flops if total_flops > 0 else None,
           'bytes_accessed': total_bytes if total_bytes > 0 else None,
           'kernel_launches': launched['launches']}
    with _COST_LOCK:
        _COST_CACHE[key] = dict(out)
    try:
        weakref.finalize(owner, _COST_CACHE.pop, key, None)
    except TypeError:
        pass   # not weakref-able: entry stays, bounded by callables
    return out


def memory_of(device=None):
    """Per-device memory statistics of the run so far, or None off CUDA.

    Reads the CUDA caching allocator on ``device`` (default: the current
    CUDA device): ``argument_size_in_bytes`` the bytes allocated now (the
    resident state between steps — params, optimizer slots, gradients),
    ``temp_size_in_bytes`` the peak above that (the step's transients),
    and ``live_bytes`` the peak itself — the high-water mark the budget
    pruning's estimate must cover. The field names are the JAX
    package's (XLA ``CompiledMemoryStats``), so :func:`memory_drift`
    joins both the same way. Reset the peak
    (``torch.cuda.reset_peak_memory_stats``) before the steps it should
    cover.
    """
    import torch
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device('cuda', torch.cuda.current_device())
    device = torch.device(device)
    if device.type != 'cuda':
        return None
    peak = int(torch.cuda.max_memory_allocated(device))
    now = int(torch.cuda.memory_allocated(device))
    return {'argument_size_in_bytes': now,
            'temp_size_in_bytes': max(0, peak - now), 'live_bytes': peak}


# -- regime classification -------------------------------------------------

def classify_regime(flops, bytes_accessed, wall_s, peak_flops,
                    peak_hbm_bps, comms_s=None):
    """One step's roofline record.

    ``mfu`` = flops / peak_flops / wall (the model-FLOPs-utilization
    definition bench.py's headline uses); ``hbm_frac`` the analogous
    bytes-accessed / peak-HBM fraction; ``comms_frac`` = exposed comms
    seconds / wall when the caller measured them. ``roofline_regime``
    is the largest of the computable fractions — the bound the step is
    actually pressed against — and is None (with ``regime_reason``)
    when nothing is computable. ``mfu`` is an explicit None with
    ``mfu_null_reason`` naming the missing input (no counted flops, no
    peak for this device kind, zero wall) — a CPU record is well-formed,
    never a crash and never a number against an invented denominator.
    """
    rec = {'wall_s': round(float(wall_s), 6) if wall_s else 0.0,
           'flops': flops, 'bytes_accessed': bytes_accessed,
           'mfu': None, 'hbm_frac': None, 'comms_frac': None,
           'roofline_regime': None}
    fracs = {}
    if not wall_s or wall_s <= 0:
        rec['mfu_null_reason'] = 'no measured step wall'
        rec['regime_reason'] = 'no measured step wall'
        return rec
    if flops is None:
        rec['mfu_null_reason'] = 'cost_of() counted no flops'
    elif peak_flops is None:
        rec['mfu_null_reason'] = ('no peak-FLOPs table entry for this '
                                  'device kind (CPU)')
    else:
        rec['mfu'] = round(flops / peak_flops / wall_s, 6)
        fracs['compute'] = rec['mfu']
    if bytes_accessed is not None and peak_hbm_bps:
        rec['hbm_frac'] = round(
            bytes_accessed / peak_hbm_bps / wall_s, 6)
        fracs['memory'] = rec['hbm_frac']
    if comms_s is not None:
        rec['comms_frac'] = round(
            min(max(float(comms_s), 0.0), wall_s) / wall_s, 6)
        fracs['comms'] = rec['comms_frac']
    if fracs:
        rec['roofline_regime'] = max(fracs, key=fracs.get)
    else:
        rec['regime_reason'] = ('neither compute nor memory peak is '
                                'computable on this backend')
    return rec


class RooflineTracker:
    """Per-step MFU/regime accounting for one worker.

    Sampled every ``every`` executed train steps
    (``AUTODIST_ROOFLINE_EVERY``): each sample classifies the step
    against the peak table (:func:`classify_regime`), lands on the
    telemetry registry (``mfu`` / ``hbm_frac`` series, the
    ``roofline_regime`` gauge) and is checked against a rolling MFU
    baseline — a sample below ``regression_frac`` of the baseline
    median records an ``mfu_regression`` flight event, so a
    mid-run efficiency cliff is post-mortem evidence, not folklore.
    The cost count is the caller's (cached per callable via
    :func:`cost_of`); the per-sample work here is arithmetic plus one
    bounded-deque append. ``flight`` is a recorder with
    ``record(name, **fields)`` for the regression events (the JAX
    package's flight recorder, which the port does not have yet); None
    logs them only.
    """

    def __init__(self, peak_flops=None, peak_hbm_bps=None, every=None,
                 tel=None, flight=None, worker='p0',
                 regression_frac=0.8, baseline_window=16):
        self.peak_flops = peak_flops
        self.peak_hbm_bps = peak_hbm_bps
        self.every = max(1, int(every or ENV.AUTODIST_ROOFLINE_EVERY.val))
        if tel is None:
            from autodist_tpu_torch.telemetry import core as _core
            tel = _core.get()
        self._tel = tel
        self._flight = flight
        self.worker = worker
        self.regression_frac = float(regression_frac)
        self._baseline = deque(maxlen=max(4, int(baseline_window)))
        self.records = deque(maxlen=256)
        self.samples = 0
        self.regressions = 0

    def observe_step(self, step, wall_s, cost=None, comms_s=None):
        """Account one executed train step; returns the roofline
        record for sampled steps, None off-cadence. ``cost`` is
        :func:`cost_of`'s dict for the step callable (None = full
        degradation: the record still forms, ``mfu`` explains
        itself)."""
        if step % self.every:
            return None
        cost = cost or {'flops': None, 'bytes_accessed': None}
        rec = classify_regime(cost.get('flops'),
                              cost.get('bytes_accessed'), wall_s,
                              self.peak_flops, self.peak_hbm_bps,
                              comms_s=comms_s)
        rec['step'] = int(step)
        self.records.append(rec)
        self.samples += 1
        if self._tel.enabled:
            if rec['mfu'] is not None:
                self._tel.observe('mfu', rec['mfu'])
            if rec['hbm_frac'] is not None:
                self._tel.observe('hbm_frac', rec['hbm_frac'])
            if rec['roofline_regime']:
                self._tel.gauge('roofline_regime',
                                rec['roofline_regime'])
            self._tel.count('roofline/steps_sampled')
            # the cross-worker surface: the sample rides the span
            # batches as a point event, so the chief's CohortMonitor
            # learns every worker's regime (its compute/memory-bound
            # verdict refinement), not just its own
            self._tel.event('roofline', worker=self.worker,
                            step=int(step), mfu=rec['mfu'],
                            hbm_frac=rec['hbm_frac'],
                            comms_frac=rec['comms_frac'],
                            roofline_regime=rec['roofline_regime'])
        if rec['mfu'] is not None:
            if len(self._baseline) >= 4:
                base = statistics.median(self._baseline)
                if base > 0 and rec['mfu'] < self.regression_frac * base:
                    self.regressions += 1
                    if self._flight is not None:
                        self._flight.record(
                            'mfu_regression', worker=self.worker,
                            step=int(step), mfu=rec['mfu'],
                            baseline_mfu=round(base, 6),
                            regime=rec['roofline_regime'])
                    if self._tel.enabled:
                        self._tel.count('roofline/mfu_regressions')
                    logging.warning(
                        'roofline: MFU regression at step %d — %.1f%% '
                        'vs rolling baseline %.1f%% (regime %s)',
                        step, 100 * rec['mfu'], 100 * base,
                        rec['roofline_regime'])
            self._baseline.append(rec['mfu'])
        return rec

    def snapshot(self):
        """JSON-serializable summary: latest record, rolling MFU
        median, sample/regression counts."""
        mfus = [r['mfu'] for r in self.records if r['mfu'] is not None]
        last = dict(self.records[-1]) if self.records else None
        return {'samples': self.samples,
                'regressions': self.regressions,
                'every': self.every,
                'mfu_median': round(statistics.median(mfus), 6)
                if mfus else None,
                'last': last}


# -- HBM high-water attribution -------------------------------------------

def memory_drift(measured, estimate):
    """Join measured per-device memory against the cost model's
    layout-aware estimate, per variable class.

    ``measured`` is :func:`memory_of`'s dict (or None off CUDA);
    ``estimate`` is ``cost_model.memory_footprint``'s dict. The join
    maps the estimate's classes onto what the run allocates: resident
    state (params + optimizer slots) in the bytes allocated between
    steps, transients (grads + bucket staging) in the peak above them.
    ``drift_ratio`` is measured/estimated — above 1 the estimate is too
    low (budget pruning ADMITS configs that do not fit), below 1 too
    high (pruning REJECTS configs that do). Returns a well-formed record
    with ``available: False`` + a reason instead of raising when
    measurement is absent.
    """
    est = dict(estimate or {})
    est_state = est.get('params_bytes', 0) + est.get(
        'optimizer_bytes', 0)
    est_transient = est.get('grads_bytes', 0) + est.get(
        'bucket_staging_bytes', 0)
    out = {'available': bool(measured), 'estimated': est,
           'estimated_total_bytes': est.get(
               'total_bytes', est_state + est_transient)}
    if not measured:
        out['reason'] = ('no CUDA memory statistics on this device — '
                         'estimate unverified, not wrong')
        out['drift_ratio'] = None
        return out
    meas_state = measured.get('argument_size_in_bytes', 0)
    meas_transient = measured.get('temp_size_in_bytes', 0)
    meas_total = measured.get('live_bytes',
                              meas_state + meas_transient)

    def ratio(m, e):
        return round(m / e, 4) if e else None

    out['measured'] = dict(measured)
    out['measured_total_bytes'] = meas_total
    out['drift_ratio'] = ratio(meas_total,
                               out['estimated_total_bytes'])
    out['classes'] = {
        'state': {'measured_bytes': meas_state,
                  'estimated_bytes': est_state,
                  'drift_ratio': ratio(meas_state, est_state)},
        'transient': {'measured_bytes': meas_transient,
                      'estimated_bytes': est_transient,
                      'drift_ratio': ratio(meas_transient,
                                           est_transient)},
    }
    return out


# -- per-entry collective drift -------------------------------------------

#: schedule kind -> the HLO-style kind its flat lowering's timeline row
#: carries (``profiling.Collective.kind``)
_HLO_KIND = {'all_reduce': 'all-reduce',
             'psum_scatter': 'reduce-scatter',
             'all_gather': 'all-gather'}


def expected_subrows(entry, num_replicas, multi_node=False):
    """The timeline rows ONE schedule entry should produce:
    ``[(hlo_kind, result_bytes, tier, group_size, full_bytes)]``.

    ``result_bytes`` is what the collective's RESULT carries (the
    figure ``profiling.collective_timeline`` rows record — a
    reduce-scatter's result is the 1/g shard, an all-gather's the full
    buffer); ``full_bytes`` the entry's full wire buffer for
    that phase, which is what an α-β fit must invert through. Flat
    entries produce one row on the tier the mesh implies (a flat
    collective spans nodes by construction on a multi-node mesh);
    two-level (``hier``) entries produce their intra/inter phases on
    the ICI/DCN tiers explicitly — the entry-label advantage over the
    replica-groups heuristic. Returns ``[]`` for entries whose
    lowering is not joinable by shape (sparse kinds are
    data-dependent; the int8 ring rides per-hop send/recv pairs).
    """
    from autodist_tpu_torch.simulator.cost_model import wire_bytes
    n = max(1, int(num_replicas))
    kind = entry['kind']
    if kind not in _HLO_KIND:
        return []
    if entry.get('compressor') == 'Int8RingCompressor':
        return []
    wb = wire_bytes(entry['bytes'], entry.get('dtype'),
                    entry.get('compressor'))
    hier = int(entry.get('hier', 0))
    flat_tier = 'dcn' if multi_node else 'ici'
    if hier <= 1:
        if kind == 'all_reduce':
            return [('all-reduce', wb, flat_tier, n, wb)]
        if kind == 'psum_scatter':
            return [('reduce-scatter', wb // n, flat_tier, n, wb)]
        return [('all-gather', wb, flat_tier, n, wb)]
    k = hier
    g = max(1, n // k)
    chunk = wb // g
    if kind == 'all_reduce':
        # intra RS (result = 1/g shard) -> inter AR over one owner per
        # node (result = the chunk) -> intra AG (result = full buffer)
        return [('reduce-scatter', chunk, 'ici', g, wb),
                ('all-reduce', chunk, 'dcn', k, chunk),
                ('all-gather', wb, 'ici', g, wb)]
    if kind == 'psum_scatter':
        # intra RS then inter RS of the owned chunk
        return [('reduce-scatter', chunk, 'ici', g, wb),
                ('reduce-scatter', chunk // k, 'dcn', k, chunk)]
    # all_gather half: inter AG of this device's chunk, then intra AG
    return [('all-gather', chunk, 'dcn', k, chunk),
            ('all-gather', wb, 'ici', g, wb)]


def _timeline_rows(timeline):
    """Parsed ``(hlo_kind, result_bytes, seconds_per_occurrence)``
    rows from a ``profiling.collective_timeline`` list (async
    rows of an unknown kind dropped, like calibration)."""
    from autodist_tpu_torch.simulator.calibrate import _result_bytes_and_kind
    rows = []
    for name, ns, cnt in timeline or []:
        bk = _result_bytes_and_kind(name)
        if bk is None or not cnt or ns <= 0:
            continue
        rows.append((bk[1], bk[0], ns / 1e9 / cnt))
    return rows


def _subrow_link_model(hlo_kind, group, full_b, tier, params):
    """(wire bytes moved, predicted seconds) of ONE expected
    sub-collective under the BARE link model — the exact hop/byte
    multipliers ``calibrate._kind_factors`` gives ``fit_alpha_beta``
    (one source: a factor tweak landing in calibrate alone cannot
    silently diverge the tier view from the fit that consumes its
    samples). Deliberately α-β phases only, no HBM-pass terms: the
    tier aggregate grades the LINK constants the calibration refits,
    while the per-entry ``predicted_s`` column keeps the full
    ``cost_model.entry_time`` model (boundary/cast/quantize passes
    included)."""
    from autodist_tpu_torch.simulator.calibrate import _kind_factors
    m = max(2, int(group))
    hops, frac = _kind_factors(hlo_kind, m)
    alpha, beta = params.link(cross_node=(tier == 'dcn'))
    return frac * full_b, hops * alpha + frac * full_b * beta


def drift_table(schedule, timeline, num_replicas, params=None,
                multi_node=False, match_tolerance=4.0):
    """Join a traced collective timeline back to schedule entries —
    the per-entry achieved-vs-predicted drift table.

    Args:
        schedule: ``static_collective_schedule`` entries (with
            ``entry_id``; re-stamped here if absent).
        timeline: ``profiling.collective_timeline`` rows from the same
            run's trace (empty = every entry degrades to
            ``achieved_s: None``, explicitly).
        num_replicas, multi_node: the mesh shape the schedule ran on.
        params: :class:`CostModelParams` for the predicted column
            (analytic defaults when None).
        match_tolerance: max result-bytes ratio between a timeline row
            and the sub-row it may satisfy (greedy nearest-size match
            per HLO kind — bucket layouts differ by construction, so
            exact-size joins would be brittle across padding).

    Returns ``{'entries': [...], 'tiers': {...}, 'matched_rows',
    'unmatched_rows', 'worst_drift_ratio', 'num_replicas'}``. Each
    entry row carries ``entry_id`` (round-trips to the static
    schedule), predicted seconds (``cost_model.entry_time`` — the
    SAME pricing ``predict()`` sums), achieved seconds (None +
    ``note`` when unjoinable), ``drift_ratio`` = achieved/predicted,
    and the per-phase tier labels. ``tiers`` aggregates achieved vs
    predicted bytes/s per link class over the MATCHED sub-rows only
    (both sides of the ratio cover the same row set — a trace missing
    an entry must not skew the tier view) under the bare α-β link
    model (:func:`_subrow_link_model`, the same factors the
    calibration fit inverts); the per-entry ``predicted_s`` column
    keeps the full :func:`cost_model.entry_time` model. The
    ``samples`` are what ``calibrate.calibrate_from_drift`` fits.
    """
    from autodist_tpu_torch.parallel.plan import assign_entry_ids
    from autodist_tpu_torch.simulator.cost_model import (CostModelParams,
                                                   entry_time)
    if params is None:
        params = CostModelParams()
    n = max(1, int(num_replicas))
    schedule = [dict(e) for e in schedule]
    if any('entry_id' not in e for e in schedule):
        assign_entry_ids(schedule)
    rows = _timeline_rows(timeline)
    unmatched = [True] * len(rows)
    out_entries = []
    tier_acc = {'ici': {'wire_bytes': 0.0, 'seconds': 0.0,
                        'predicted_seconds': 0.0, 'rows': 0},
                'dcn': {'wire_bytes': 0.0, 'seconds': 0.0,
                        'predicted_seconds': 0.0, 'rows': 0}}
    samples = []   # entry-labeled (tier, full_bytes, hlo_kind, s, group)
    worst = None
    for e in schedule:
        predicted_s, wb = entry_time(e, n, params,
                                     cross_node=multi_node)
        row = {'entry_id': e['entry_id'], 'kind': e['kind'],
               'phase': e.get('phase'), 'vars': e.get('vars'),
               'bytes': e.get('bytes'), 'wire_bytes': wb,
               'hier': int(e.get('hier', 0)),
               'compressor': e.get('compressor'),
               'predicted_s': round(predicted_s, 9),
               'achieved_s': None, 'drift_ratio': None,
               'achieved_bytes_per_s': None, 'tiers': []}
        subrows = expected_subrows(e, n, multi_node=multi_node)
        if not subrows:
            row['note'] = ('not joinable by result shape (sparse '
                           'kinds are data-dependent; the int8 ring '
                           'rides per-hop send/recv pairs)')
            out_entries.append(row)
            continue
        achieved = 0.0
        moved = 0.0
        matched = 0
        for hlo_kind, result_b, tier, group, full_b in subrows:
            row['tiers'].append(tier)
            best, best_err = None, None
            for j, (rk, rb, _) in enumerate(rows):
                if not unmatched[j] or rk != hlo_kind or rb <= 0 \
                        or result_b <= 0:
                    continue
                err = abs(math.log(rb / result_b))
                if err <= math.log(match_tolerance) and \
                        (best is None or err < best_err):
                    best, best_err = j, err
            if best is None:
                continue
            unmatched[best] = False
            matched += 1
            t = rows[best][2]
            achieved += t
            frac_bytes, pred_t = _subrow_link_model(
                hlo_kind, group, full_b, tier, params)
            moved += frac_bytes
            # MATCHED sub-rows only, on both sides of the divide: a
            # partially-joined trace must compare achieved and
            # predicted over the same row set, or the tier ratio is
            # skewed by exactly the entries the trace missed
            acc = tier_acc[tier]
            acc['wire_bytes'] += frac_bytes
            acc['seconds'] += t
            acc['predicted_seconds'] += pred_t
            acc['rows'] += 1
            samples.append((tier, full_b, hlo_kind, t, group))
        if matched == len(subrows) and achieved > 0:
            row['achieved_s'] = round(achieved, 9)
            row['drift_ratio'] = round(achieved / predicted_s, 4) \
                if predicted_s > 0 else None
            row['achieved_bytes_per_s'] = round(moved / achieved, 1)
            if row['drift_ratio'] is not None and \
                    (worst is None or row['drift_ratio'] > worst):
                worst = row['drift_ratio']
        elif matched:
            row['note'] = ('partial join: %d of %d phases matched '
                           'in the trace' % (matched, len(subrows)))
        else:
            row['note'] = 'no matching timeline rows in the trace'
        out_entries.append(row)
    tiers = {}
    for tier, acc in tier_acc.items():
        if not acc['rows']:
            continue
        tiers[tier] = {
            'rows': acc['rows'],
            'wire_bytes': int(acc['wire_bytes']),
            'achieved_bytes_per_s': round(
                acc['wire_bytes'] / acc['seconds'], 1)
            if acc['seconds'] > 0 else None,
            'predicted_bytes_per_s': round(
                acc['wire_bytes'] / acc['predicted_seconds'], 1)
            if acc['predicted_seconds'] > 0 else None,
        }
    return {'entries': out_entries,
            'tiers': tiers,
            'samples': samples,
            'matched_rows': sum(1 for u in unmatched if not u),
            'unmatched_rows': sum(1 for u in unmatched if u),
            'worst_drift_ratio': worst,
            'num_replicas': n}


def format_drift_table(table, max_rows=20):
    """Human-readable rendering of :func:`drift_table`."""
    lines = ['%-44s %6s %12s %12s %8s' % ('entry', 'tier',
                                          'pred (us)', 'ach (us)',
                                          'drift')]
    lines.append('-' * len(lines[0]))
    for row in table['entries'][:max_rows]:
        ach = '%12.1f' % (row['achieved_s'] * 1e6) \
            if row['achieved_s'] is not None else '%12s' % '-'
        drift = '%8.2f' % row['drift_ratio'] \
            if row['drift_ratio'] is not None else '%8s' % '-'
        lines.append('%-44s %6s %12.1f %s %s'
                     % (row['entry_id'][:44],
                        '+'.join(sorted(set(row['tiers']))) or '-',
                        row['predicted_s'] * 1e6, ach, drift))
    extra = len(table['entries']) - max_rows
    if extra > 0:
        lines.append('  ... %d more entries' % extra)
    for tier, agg in sorted(table.get('tiers', {}).items()):
        lines.append(
            '%s: achieved %s vs predicted %s bytes/s over %d rows'
            % (tier.upper(),
               '%.3g' % agg['achieved_bytes_per_s']
               if agg['achieved_bytes_per_s'] else '-',
               '%.3g' % agg['predicted_bytes_per_s']
               if agg['predicted_bytes_per_s'] else '-', agg['rows']))
    if table.get('worst_drift_ratio') is not None:
        lines.append('worst per-entry drift: %.2fx'
                     % table['worst_drift_ratio'])
    return '\n'.join(lines)
