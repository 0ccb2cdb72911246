"""Per-op profile aggregation over a captured trace.

The counterpart of the trace-reading half of
``autodist_tpu/utils/profiling.py``. The JAX package reads the
``.xplane.pb`` a ``jax.profiler`` trace writes; the port reads the
Chrome-trace JSON ``torch.profiler`` writes (``Trainer.profile`` leaves
``trace_dir/rank<r>.pt.trace.json``):

- :func:`per_op_breakdown` aggregates the device's kernels (every stream
  of the busiest device; on a trace with no device, the busiest host
  thread's top-level operators) into a per-op / per-category breakdown;
- :func:`collective_timeline` keeps the collectives, one row per
  collective of the step (with bucketed sync, one per bucket) as
  ``(descriptor, ns, count)`` — the JAX row shape, so the calibration
  fit downstream is the JAX code. The descriptor (:class:`Collective`)
  comes from the trace's collective records: NCCL's device kernels
  (``ncclDevKernel_*`` / ``ncclKernel_*``), whose args carry the
  collective's name, element counts, dtype, group size and ranks;
  without them (a CPU run over gloo) the host records,
  ``record_param_comms`` or the ``nccl:*`` / ``gloo:*`` annotations;
- :func:`bucket_report` joins an execution plan's emitted buckets with
  the trace's collective time; :func:`format_breakdown` renders a
  breakdown;
- the loose PS plane's reports read ``LooseSession.ps_stats``:
  :func:`ps_overlap_report` (the pipeline's hidden and exposed wire
  time), :func:`ps_sparse_report` (the row-sparse counters) and
  :func:`ps_wire_report` (bytes by direction and endpoint). The JAX
  module's ``health_*`` reports wait for the membership machinery
  (ROADMAP.md Queue 1, "Loose-mode PS plane", its second half).
"""
import glob
import gzip
import json
import os
import re
import statistics
from collections import defaultdict, namedtuple

from autodist_tpu_torch.utils import logging


class Collective(namedtuple('Collective', 'kind nbytes dtype ranks')):
    """One collective as a timeline row names it: the HLO-style ``kind``
    ('all-reduce', 'reduce-scatter', 'all-gather', 'all-to-all',
    'collective-permute'), its RESULT bytes (a reduce-scatter's shard,
    an all-gather's full buffer, as an HLO result shape counts them),
    the dtype name, and the group's global ranks (None for the default
    group, the whole world, as ``replica_groups={}`` marks a flat
    collective)."""


# -- reading a trace ----------------------------------------------------------

def _trace_files(trace_dir):
    """The traces under ``trace_dir``, oldest first."""
    files = [f for pat in ('*.pt.trace.json', '*.pt.trace.json.gz')
             for f in glob.glob(os.path.join(trace_dir, '**', pat),
                                recursive=True)]
    if not files and os.path.isdir(trace_dir):
        logging.warning('profiling: trace dir %s exists but holds no '
                        '*.pt.trace.json; returning empty breakdown',
                        trace_dir)
    return sorted(files, key=os.path.getmtime)


def _load(path):
    """(events, distributedInfo) of one trace file, or None (warned)
    when it does not parse."""
    try:
        opener = gzip.open if path.endswith('.gz') else open
        with opener(path, 'rt') as f:
            trace = json.load(f)
    except (OSError, ValueError) as e:
        # degrade, never raise: calibration and reports read traces
        # that may be partial
        logging.warning('profiling: cannot parse trace %s (%s: %s); '
                        'returning empty breakdown', path,
                        type(e).__name__, e)
        return None
    events = [e for e in trace.get('traceEvents', ())
              if e.get('ph') == 'X' and 'dur' in e]
    return events, trace.get('distributedInfo') or {}


_DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')


def _top_level(events):
    """The events of one thread that no other event of it contains."""
    out, end = [], None
    for e in sorted(events, key=lambda e: (e['ts'], -e['dur'])):
        if end is None or e['ts'] >= end:
            out.append(e)
            end = e['ts'] + e['dur']
    return out


def _timeline_events(events):
    """The busiest device's kernels (all its streams); on a trace with
    no device events, the busiest host thread's top-level operators — a
    coarse program-level view rather than a per-kernel one."""
    by_line = defaultdict(list)
    for e in events:
        if e.get('cat') in _DEVICE_CATS:
            by_line[('device', e.get('pid'))].append(e)
    if not by_line:
        for e in events:
            if e.get('cat') == 'cpu_op':
                by_line[('host', e.get('tid'))].append(e)
        by_line = {k: _top_level(v) for k, v in by_line.items()}
    if not by_line:
        return []
    return max(by_line.values(), key=lambda evs: sum(e['dur'] for e in evs))


_CATEGORY_RULES = (
    ('port-kernel', re.compile(r'::(fwd|dq|dkv|cb)_')),
    ('collective', re.compile(r'nccl|gloo:|c10d::|record_param_comms',
                              re.I)),
    ('convolution', re.compile(r'conv|cudnn|fprop|dgrad|wgrad', re.I)),
    ('gemm', re.compile(r'gemm|nvjet|cutlass|aten::(mm|addmm|bmm|matmul|'
                        r'linear)$', re.I)),
    ('copy', re.compile(r'copy|memcpy|memset', re.I)),
    ('optimizer', re.compile(r'multi_tensor_apply|foreach', re.I)),
    ('reduction', re.compile(r'reduce|aten::(sum|mean|amax|max)$', re.I)),
    ('elementwise', re.compile(r'elementwise', re.I)),
)


def _categorize(name):
    for cat, pat in _CATEGORY_RULES:
        if pat.search(name):
            return cat
    return 'other:' + name[:24]


def per_op_breakdown(trace_dir):
    """Aggregate a profiler trace into per-op and per-category times.

    Args:
        trace_dir: directory a ``torch.profiler`` Chrome trace was
            written to (searched recursively for ``*.pt.trace.json``;
            the newest is read).

    Returns dict with ``total_ns``, ``by_category`` ({name: ns}), and
    ``top_ops`` ([(kernel or op name, ns, count)] sorted by time). Empty
    when no trace or no timeline is found. Kernels of concurrent streams
    (the collectives' and the compute's) are summed, so ``total_ns`` may
    exceed the wall time they span.
    """
    files = _trace_files(trace_dir)
    loaded = _load(files[-1]) if files else None
    if loaded is None:
        return {}
    line = _timeline_events(loaded[0])
    if not line:
        logging.warning('profiling: trace in %s has no device or host '
                        'timeline; returning empty breakdown', trace_dir)
        return {}
    by_cat = defaultdict(int)
    by_op = defaultdict(lambda: [0, 0])
    for ev in line:
        ns = int(round(ev['dur'] * 1e3))
        by_cat[_categorize(ev['name'])] += ns
        slot = by_op[ev['name']]
        slot[0] += ns
        slot[1] += 1
    top = sorted(((name, ns, cnt) for name, (ns, cnt) in by_op.items()),
                 key=lambda t: -t[1])
    return {'total_ns': sum(by_cat.values()),
            'by_category': dict(sorted(by_cat.items(),
                                       key=lambda kv: -kv[1])),
            'top_ops': top}


def bucket_report(plan, trace_dir=None):
    """Per-bucket accounting for a bucketed-sync execution plan.

    ``plan.last_bucket_stats`` (recorded by
    ``ExecutionPlan.sync_gradients``) gives the byte layout: one entry
    per emitted collective with its kind, group, dtype and byte count.
    Bucket ``bytes`` are RAW tensor bytes; each entry additionally gets
    a ``wire_bytes`` field here (``cost_model.wire_bytes`` applied to
    its compressor/dtype) — under a compressed wire (bf16 cast, int8
    blocks) the raw figure overstates what actually moves by 2–4x. With
    ``trace_dir`` (a captured profile), the measured collective time is
    attached, so the overlap the bucketing exists for is auditable:
    total collective ns vs total step ns.

    Returns ``{'buckets': [...], 'num_buckets', 'total_bytes',
    'total_wire_bytes', 'max_bucket_bytes', 'collective_ns',
    'total_ns'}`` (the *_ns fields only when a trace is given and
    parseable).
    """
    from autodist_tpu_torch.simulator.cost_model import wire_bytes
    stats = [dict(b) for b in
             (getattr(plan, 'last_bucket_stats', []) or [])]
    for b in stats:
        b['wire_bytes'] = wire_bytes(b.get('bytes', 0), b.get('dtype'),
                                     b.get('compressor'))
    out = {
        'buckets': stats,
        'num_buckets': len(stats),
        'total_bytes': sum(b.get('bytes', 0) for b in stats),
        'total_wire_bytes': sum(b['wire_bytes'] for b in stats),
        'max_bucket_bytes': max([b.get('bytes', 0) for b in stats],
                                default=0),
    }
    if trace_dir:
        rep = per_op_breakdown(trace_dir)
        if rep:
            out['collective_ns'] = rep['by_category'].get('collective', 0)
            out['total_ns'] = rep['total_ns']
            if stats and not out['collective_ns']:
                logging.warning(
                    'profiling: bucket_report joined a trace with ZERO '
                    'collective time against a plan that emitted %d '
                    'bucket(s) — the trace did not capture the sync '
                    '(empty here is a mismatch, not overlap)', len(stats))
    return out


# -- the collective timeline --------------------------------------------------

_NCCL_KERNEL = re.compile(r'^nccl(Dev)?Kernel')

#: collective names (the records' ``Collective name``, or the ``nccl:`` /
#: ``gloo:`` annotation's suffix) -> the HLO kind the cost shapes use
_KIND_BY_NAME = (
    (re.compile(r'reduce_?scatter'), 'reduce-scatter'),
    (re.compile(r'all_?gather'), 'all-gather'),
    (re.compile(r'all_?reduce'), 'all-reduce'),
    (re.compile(r'all_?to_?all'), 'all-to-all'),
    (re.compile(r'send|recv'), 'collective-permute'),
)

#: bytes per element by the dtype names the records carry (ATen scalar
#: type names on the card, C++ type names in gloo's annotations)
_ITEMSIZE = (('bfloat16', 2), ('half', 2), ('double', 8), ('long', 8),
             ('int64', 8), ('float', 4), ('int', 4), ('char', 1),
             ('byte', 1), ('bool', 1))


def _kind(name):
    name = name.lower()
    for pat, kind in _KIND_BY_NAME:
        if pat.search(name):
            return kind
    return None


def _itemsize(dtype):
    d = str(dtype).lower()
    for key, size in _ITEMSIZE:
        if key in d:
            return size
    return 4


def _prod(dims):
    n = 1
    for d in dims:
        n *= int(d)
    return n


def _descriptor(ev, world):
    """The :class:`Collective` of one collective record, or None when it
    is not a collective the cost shapes know or runs over one rank (no
    link: nothing to calibrate)."""
    a = ev.get('args') or {}
    name = a.get('Collective name') or ev['name'].split(':', 1)[-1]
    kind = _kind(name)
    if kind is None:
        return None
    if 'Out msg nelems' in a:
        n_in, n_out = int(a['In msg nelems']), int(a['Out msg nelems'])
        size = int(a.get('Group size') or world)
        dtype = str(a.get('dtype', 'Float'))
        ranks = a.get('Process Group Ranks')
        ranks = None if a.get('Process Group Name') in (None, '0') or \
            not ranks else tuple(json.loads(ranks))
    else:
        # gloo's annotations carry the input's shape only (when the
        # profile recorded shapes), and run on the default group
        if not a.get('Input Dims'):
            return None
        dims = a['Input Dims'][0]
        dtype = str((a.get('Input type') or ['float'])[0])
        size, ranks = world, None
        n_in = _prod(dims)
        n_out = {'all-gather': n_in * size,
                 'reduce-scatter': n_in // max(1, size)}.get(kind, n_in)
    if size <= 1:
        return None
    n = max(n_in, n_out) if kind == 'collective-permute' else n_out
    return Collective(kind, n * _itemsize(dtype), dtype.lower(), ranks)


def _collective_records(events):
    """NCCL's device kernels when the trace has them (their durations
    are the transfers'); else the host records — ``record_param_comms``,
    or the ``nccl:*`` / ``gloo:*`` annotations (gloo runs a collective
    synchronously, so its span is the transfer)."""
    dev = [e for e in events if e.get('cat') == 'kernel' and
           _NCCL_KERNEL.match(e.get('name', ''))]
    if dev:
        return dev
    host = [e for e in events if e.get('name') == 'record_param_comms']
    if host:
        return host
    return [e for e in events if e.get('cat') == 'user_annotation' and
            e.get('name', '').startswith(('nccl:', 'gloo:'))]


def _period(seq):
    """The smallest p dividing len(seq) with seq[i] == seq[i % p]."""
    m = len(seq)
    for p in range(1, m + 1):
        if m % p == 0 and all(seq[i] == seq[i % p] for i in range(p, m)):
            return p
    return m


def _step_rows(events, world):
    """One trace's collectives folded by the step's period:
    ``[(Collective, median ns, count)]`` in step order."""
    seq = []
    for ev in sorted(_collective_records(events), key=lambda e: e['ts']):
        desc = _descriptor(ev, world)
        if desc is not None:
            seq.append((desc, ev['dur'] * 1e3))
    p = _period([d for d, _ in seq])
    return [(seq[k][0], statistics.median(ns for _, ns in seq[k::p]),
             len(seq) // p) for k in range(p)] if seq else []


def collective_timeline(trace_dir, expected_collectives=0):
    """Per-collective durations from a captured trace: one row per
    collective of the traced program — with bucketed gradient sync, one
    per bucket — as ``[(Collective, ns, count)]`` sorted by time.

    A profile of N steps repeats the step's sequence of collectives N
    times; the k-th collective of every step is one row, counted once a
    step, as an XLA trace has one row per collective instruction. Two
    buckets of one size stay two rows (the drift table joins each to its
    own schedule entry). A sequence that does not repeat gives a row to
    every collective.

    An eager collective's kernel also waits for the last rank to reach
    it, so a row's time is its transfer's as far as the traces show it:
    the MEDIAN of its occurrences (a step in which a host fell behind
    does not move it), and, where ``trace_dir`` holds several ranks'
    traces of the same steps (``Trainer.profile`` writes
    ``rank<r>.pt.trace.json`` for each), the least over the ranks — the
    rank that reached a collective last waited for no one. A row's
    ``ns`` is that time times its count; its descriptor is the newest
    trace's.

    ``expected_collectives`` disambiguates the silent-empty path: a run
    that EMITTED buckets whose trace parses to zero collective rows is a
    parsing/capture mismatch, not a no-collective program, and is
    logged loudly; 0 keeps the quiet degradation for callers with no
    static count (a one-rank run syncs nothing).
    """
    traces = [t for t in map(_load, _trace_files(trace_dir))
              if t is not None]
    if not traces and expected_collectives:
        logging.warning(
            'profiling: the plan emitted %d collective(s) but %s '
            'yielded NO parseable trace — a capture/parsing failure, '
            'not a no-collective run; calibration will keep analytic '
            'constants', expected_collectives, trace_dir)
    per_trace = [_step_rows(events, int(info.get('world_size') or 1))
                 for events, info in traces]
    rows = per_trace[-1] if per_trace else []
    # the other ranks' traces of the same program: same kinds, bytes and
    # counts at every position (their groups' ranks may differ)
    shape = [(d.kind, d.nbytes, c) for d, _, c in rows]
    same = [r for r in per_trace
            if [(d.kind, d.nbytes, c) for d, _, c in r] == shape]
    rows = sorted(((d, round(c * min(r[k][1] for r in same)), c)
                   for k, (d, _, c) in enumerate(rows)),
                  key=lambda t: -t[1])
    if traces and not rows and expected_collectives:
        logging.warning(
            'profiling: the plan emitted %d collective(s) but the trace '
            'in %s parsed to ZERO collective rows — check that the trace '
            'covered a synced step', expected_collectives, trace_dir)
    return rows


def ps_overlap_report(ps_stats):
    """Attribute the loose-mode PS data plane's wire time to the
    critical path vs the background pipeline.

    ``ps_stats`` is :attr:`LooseSession.ps_stats` (whose ``pipeline`` block
    carries the per-train-step phase averages). Wire seconds recorded
    by the transfer/pipeline threads count as *hidden* except for the
    portion the main thread measurably blocked on (joins of the
    background push and of the prefetched pull) — that exposed share is
    the only wire time a step actually pays, and ``overlap_frac`` is
    the hidden fraction. At depth 1 every wire second is exposed by
    construction (overlap_frac == 0).

    Returns ``{'depth', 'train_steps', 'pull_s', 'step_s', 'push_s',
    'wire_s', 'exposed_wire_s', 'hidden_wire_s', 'overlap_frac'}``
    (per-step seconds), or ``{}`` when the session never trained in
    loose mode.
    """
    pipe = (ps_stats or {}).get('pipeline') or {}
    if not pipe.get('train_steps'):
        # zero-train-step snapshot (eval-only session, or a report
        # taken before the first gated step landed): nothing to
        # attribute — and nothing to divide by
        return {}
    # every field defaulted: a partial stats payload degrades to zeros
    pull_s = pipe.get('pull_s', 0.0)
    push_s = pipe.get('push_s', 0.0)
    wire = pull_s + push_s
    exposed = min(pipe.get('exposed_wait_s', 0.0), wire)
    overlap = pipe.get('overlap_frac')
    if overlap is None:
        overlap = (1.0 - exposed / wire) if wire > 0 else 0.0
    return {
        'depth': pipe.get('depth', 1),
        'train_steps': pipe['train_steps'],
        'pull_s': pull_s,
        'step_s': pipe.get('step_s', 0.0),
        'push_s': push_s,
        'wire_s': wire,
        'exposed_wire_s': exposed,
        'hidden_wire_s': max(0.0, wire - exposed),
        'overlap_frac': overlap,
    }


def ps_sparse_report(ps_stats):
    """The row-sparse PS plane's counters plus derived ratios.

    ``ps_stats`` is :attr:`LooseSession.ps_stats`; its ``sparse`` block
    counts sparse pushes, rows pushed, dense bytes avoided, zero-push
    skips and row/full proxy refreshes.
    Adds ``avoided_frac`` — the fraction of would-have-been wire bytes
    the sparse plane (and the zero-delta skip) saved: avoided /
    (avoided + bytes actually moved). Returns ``{}`` when the session
    kept no sparse counters (non-loose, or pre-sparse-plane stats)."""
    sparse = dict((ps_stats or {}).get('sparse') or {})
    if not sparse:
        return {}
    moved = (ps_stats or {}).get('bytes', 0)
    avoided = sparse.get('dense_bytes_avoided', 0)
    sparse['avoided_frac'] = (
        avoided / float(avoided + moved) if avoided + moved else 0.0)
    return sparse


def format_ps_sparse(report):
    """Human-readable rendering of :func:`ps_sparse_report`."""
    if not report:
        return '(no sparse-plane counters)'
    return ('sparse pushes %d (%d rows)  zero-skips %d  refreshes '
            '%d row / %d full  avoided %.1f MB (%.0f%% of would-be '
            'wire)' % (report.get('sparse_pushes', 0),
                       report.get('rows_pushed', 0),
                       report.get('zero_push_skips', 0),
                       report.get('row_refreshes', 0),
                       report.get('full_refreshes', 0),
                       report.get('dense_bytes_avoided', 0) / 1e6,
                       100.0 * report.get('avoided_frac', 0.0)))


def ps_wire_report(ps_stats):
    """The PS plane's bytes by direction and endpoint: ``{'push_bytes',
    'pull_bytes', 'bytes_per_endpoint', 'seconds', 'mb_per_s'}``, plus
    ``push_pull_ratio``; ``{}`` without loose-mode traffic. The i8 wire
    shrinks pushes only, so comparisons of wires read ``push_bytes``."""
    stats = ps_stats or {}
    if not stats.get('bytes'):
        return {}
    push, pull = stats.get('push_bytes', 0), stats.get('pull_bytes', 0)
    return {'push_bytes': push, 'pull_bytes': pull,
            'bytes_per_endpoint': list(stats.get('bytes_per_endpoint', [])),
            'seconds': stats.get('seconds', 0.0),
            'mb_per_s': stats.get('mb_per_s', 0.0),
            'push_pull_ratio': push / float(pull) if pull else 0.0}


def format_ps_overlap(report):
    """Human-readable rendering of :func:`ps_overlap_report`."""
    if not report:
        return '(no loose-mode train steps)'
    return ('depth=%d steps=%d  per-step: pull %.1fms | step %.1fms | '
            'push %.1fms  wire %.1fms (%.1fms exposed)  overlap %.0f%%'
            % (report['depth'], report['train_steps'],
               report['pull_s'] * 1e3, report['step_s'] * 1e3,
               report['push_s'] * 1e3, report['wire_s'] * 1e3,
               report['exposed_wire_s'] * 1e3,
               100.0 * report['overlap_frac']))


def format_breakdown(report, top_n=10, name_width=100):
    """Human-readable rendering of :func:`per_op_breakdown`."""
    if not report:
        return '(no trace data)'
    total = max(report['total_ns'], 1)
    lines = ['total %.2f ms' % (total / 1e6)]
    for cat, ns in report['by_category'].items():
        lines.append('  %6.2f%% %10.2f ms  %s'
                     % (100.0 * ns / total, ns / 1e6, cat))
    lines.append('top ops:')
    for name, ns, cnt in report['top_ops'][:top_n]:
        lines.append('  %8.2f ms x%-4d %s'
                     % (ns / 1e6, cnt, name[:name_width]))
    return '\n'.join(lines)
