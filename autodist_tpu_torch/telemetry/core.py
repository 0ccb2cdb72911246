"""Low-overhead span / counter / gauge registry — the process-local
half of the telemetry plane.

The port's copy of the JAX package's ``telemetry/core.py``. It imports
no jax; unlike the JAX package's copy it imports torch, because a span
is also a ``torch.profiler`` range while a profiler records (below).

Every subsystem grew its own ad-hoc stats dict
(``ps_stats``, ``health_stats``, the bucket/overlap/sparse/health
reports in :mod:`autodist_tpu.utils.profiling`) — all worker-local,
none exportable, none captured when a run dies. This module is the
shared substrate they now feed: timed **spans** (``with tel.span(
'push_deltas', step=3):``), point **events**, monotonic **counters**,
last-value **gauges** and bounded numeric **series** (e.g. the uniform
per-step wall series ``Session.run`` records), all in one registry a
worker can snapshot (:meth:`Telemetry.metrics_snapshot`), batch-push
over the PS plane (:mod:`autodist_tpu.telemetry.aggregate`) and embed
in BENCH records.

A span has two gates, and is a no-op only when both are off:

- ``AUTODIST_TELEMETRY``: the span is recorded into this registry;
- a recording ``torch.profiler`` (``torch._C._autograd._profiler_enabled``):
  the span also opens a ``record_function`` range named
  ``autodist.<name>``, on the profiler's clock, so the device operations
  the host launched inside it can be set against it in the trace.

Cost contract (the tentpole's overhead budget):

- **disabled** (``AUTODIST_TELEMETRY`` unset, the default, and no
  profiler recording): zero-cost no-ops — ``span()`` returns one shared
  null context manager after one attribute check and one C call (no
  allocation, no clock read), and every other recording call returns
  after a single attribute check;
- **profiler recording**: a ``record_function`` range per span, entered
  and left (the profiler's own cost, a few us);
- **enabled**: one ``perf_counter`` pair + one bounded-deque append
  per span (~3 us measured); batch pushes ride the session's
  dedicated background lane, never the step's critical path. ≤ 2%
  step time on the CPU smoke, measured by ``bench.bench_telemetry``'s
  per-record decomposition (records/step x measured record cost +
  the on-path drain share of a push — the raw on-vs-off wall delta
  is recorded as context but is scheduler noise at ms-scale steps).

Buffers are bounded (``AUTODIST_TELEMETRY_MAX_SPANS``): telemetry must
never grow without bound on a long run — old spans fall off the front
once drained batches stop being pushed.

Thread safety: recording calls take a small lock (the session's
pipeline/heartbeat threads and ``TransferPool`` workers all record);
the lock is only reached when telemetry is enabled.
"""
import threading
import time
from collections import deque

from torch._C._autograd import _profiler_enabled
from torch.autograd.profiler import record_function

from autodist_tpu_torch.const import ENV

#: the prefix of a span's ``record_function`` range in a profiler trace
RANGE_PREFIX = 'autodist.'


class _NullSpan:
    """The disabled-path context manager: one shared instance, no
    state, so ``tel.span(...)`` costs an attribute check and a C call
    and nothing else when telemetry is off and no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span: a profiler range while it is open, where a
    profiler records; its duration recorded into the registry on exit,
    where telemetry is on."""

    __slots__ = ('_tel', 'name', 'tags', '_t0', '_range')

    def __init__(self, tel, name, tags, profiled):
        self._tel = tel if tel.enabled else None
        self.name = name
        self.tags = tags
        self._range = record_function(RANGE_PREFIX + name) \
            if profiled else None

    def __enter__(self):
        if self._range is not None:
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        if self._tel is not None:
            if exc_type is not None:
                self.tags['error'] = exc_type.__name__
            self._tel._record_span(self.name, self._t0, t1 - self._t0,
                                   self.tags)
        return False


class Telemetry:
    """The per-process telemetry registry.

    Use the module-level singleton (:func:`get`) — one registry per
    process is the point: the session's step loop, the coord client's
    RPCs and the plan's bucket emission all land in the same buffers,
    so one snapshot/batch covers the whole worker.
    """

    def __init__(self, enabled=None, max_spans=None):
        self.enabled = (ENV.AUTODIST_TELEMETRY.val
                        if enabled is None else bool(enabled))
        cap = (ENV.AUTODIST_TELEMETRY_MAX_SPANS.val
               if max_spans is None else int(max_spans))
        self._lock = threading.Lock()
        # wall anchor: span t0s are perf_counter offsets mapped onto
        # the wall clock ONCE here, so cross-worker aggregation can
        # place spans on a shared (wall) axis without per-span
        # time.time() calls on the hot path
        self._anchor_wall = time.time()
        self._anchor_perf = time.perf_counter()
        self._spans = deque(maxlen=cap)
        self._events = deque(maxlen=cap)
        # cumulative per-span-name aggregates: survive both the ring
        # bound and drain_spans (the periodic batch push), like the
        # series' count/total — the snapshot must describe the whole
        # run, not just the undrained tail
        self._span_agg = {}
        self.counters = {}
        self.gauges = {}
        self._series = {}
        self._series_cap = cap

    # -- recording ---------------------------------------------------------
    def span(self, name, **tags):
        """A timed context manager, and a ``record_function`` range
        ``autodist.<name>`` while a profiler records. Tags ride the
        registry's record verbatim (keep them small scalars: step=,
        worker=, cmd=, bytes=)."""
        profiled = _profiler_enabled()
        if not (self.enabled or profiled):
            return _NULL_SPAN
        return _Span(self, name, tags, profiled)

    def record_span(self, name, t0, dur, **tags):
        """Record an already-measured span (``t0`` a ``perf_counter``
        value, ``dur`` seconds) — for callers that only know after the
        fact whether the interval deserves a span (e.g. ``Session.run``
        tagging only executed train steps)."""
        if not self.enabled:
            return
        self._record_span(name, t0, dur, tags)

    def _record_span(self, name, t0, dur, tags):
        rec = {'name': name,
               't0': self._anchor_wall + (t0 - self._anchor_perf),
               'dur': dur}
        if tags:
            rec['tags'] = tags
        with self._lock:
            self._spans.append(rec)
            agg = self._span_agg.setdefault(
                name, {'count': 0, 'total_s': 0.0})
            agg['count'] += 1
            agg['total_s'] += dur

    def event(self, name, **tags):
        """A point (instant) event."""
        if not self.enabled:
            return
        rec = {'name': name, 't0': self._anchor_wall +
               (time.perf_counter() - self._anchor_perf)}
        if tags:
            rec['tags'] = tags
        with self._lock:
            self._events.append(rec)

    def count(self, name, delta=1):
        """Bump a monotonic counter."""
        if not self.enabled:
            return
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + delta

    def gauge(self, name, value):
        """Set a last-value gauge."""
        if not self.enabled:
            return
        with self._lock:
            self.gauges[name] = value

    def observe(self, name, value):
        """Append to a bounded numeric series (count/total survive the
        ring bound, so means stay exact over the whole run)."""
        if not self.enabled:
            return
        with self._lock:
            s = self._series.get(name)
            if s is None:
                s = self._series[name] = {
                    'values': deque(maxlen=self._series_cap),
                    'count': 0, 'total': 0.0}
            s['values'].append(value)
            s['count'] += 1
            s['total'] += value

    # -- reading -----------------------------------------------------------
    def series_values(self, name):
        """The retained values of one series (most recent
        ``AUTODIST_TELEMETRY_MAX_SPANS``), oldest first."""
        with self._lock:
            s = self._series.get(name)
            return list(s['values']) if s else []

    def drain_spans(self):
        """Pop every buffered span + event record (the batch the
        session pushes to the PS telemetry namespace)."""
        with self._lock:
            out = list(self._spans) + list(self._events)
            self._spans.clear()
            self._events.clear()
        return out

    def metrics_snapshot(self):
        """One JSON-serializable snapshot of the whole registry:
        counters, gauges, per-series stats and per-span-name
        aggregates. Embedded in every BENCH record
        (``bench.bench_telemetry``) and in the chief's cohort
        timeline."""
        with self._lock:
            by_name = {}
            for name, agg in self._span_agg.items():
                by_name[name] = {
                    'count': agg['count'],
                    'total_s': round(agg['total_s'], 6),
                    'mean_s': round(agg['total_s'] / agg['count'], 6)}
            series = {}
            for name, s in self._series.items():
                vals = list(s['values'])
                series[name] = {
                    'count': s['count'],
                    'total': round(s['total'], 6),
                    'mean': round(s['total'] / s['count'], 6)
                    if s['count'] else 0.0,
                    'last': vals[-1] if vals else None}
            return {'enabled': self.enabled,
                    'counters': dict(self.counters),
                    'gauges': dict(self.gauges),
                    'series': series,
                    'spans': by_name,
                    'buffered_spans': len(self._spans),
                    'buffered_events': len(self._events)}


_SINGLETON = None
_SINGLETON_LOCK = threading.Lock()


def get():
    """The process-wide registry (created on first use; the enabled
    flag is read from ``AUTODIST_TELEMETRY`` at creation — tests that
    flip the env call :func:`reset`)."""
    global _SINGLETON
    tel = _SINGLETON
    if tel is None:
        with _SINGLETON_LOCK:
            tel = _SINGLETON
            if tel is None:
                tel = _SINGLETON = Telemetry()
    return tel


def reset():
    """Drop the singleton so the next :func:`get` re-reads the env
    (test/bench A/B hook; production processes never need it)."""
    global _SINGLETON
    with _SINGLETON_LOCK:
        _SINGLETON = None
