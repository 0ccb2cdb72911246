"""The traced steps of a run, reduced to what the metric readers read.

One rank's record (``reduce``):

- ``kernels``: ``[name, start_us, end_us, launched_at_us]`` of every
  device operation (kernels, copies, sets) inside the traced window;
  ``launched_at_us`` is the host time of its launch call (None where
  the trace links none);
- ``spans``: ``[name, start_us, end_us]`` of the benchmark's own
  ``record_function`` ranges (``perfbench.*``);
- ``window_us``: ``[start, end]`` of the traced window, from the first
  step's feed to the last step's loss read;
- ``steps``: the steps traced; ``flash_launches``: the program's
  launch counter (``fa.LAUNCHES``) over them, where it has one.

The classes of a kernel name are this file's own (the port's
``chip_smoke.KERNEL_CLASSES`` with LayerNorm, softmax and the loss'
kernels left to ``elementwise``), so a later change cannot move them.
"""
import bisect
import json
import os
import re
import tempfile

FLASH = re.compile(r'::(fwd|dq|dkv)_\w*kernel')
NCCL = re.compile(r'^nccl(Dev)?Kernel')
GEMM = re.compile(r'gemm|nvjet|cutlass|xmma', re.I)
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
RUNTIME_CATS = ('cuda_runtime', 'cuda_driver')
SPAN_PREFIX = 'perfbench.'


def kind(name):
    """'flash', 'nccl', 'gemm' or 'other' (every other kernel, copy and
    set)."""
    if FLASH.search(name):
        return 'flash'
    if NCCL.match(name):
        return 'nccl'
    if GEMM.search(name):
        return 'gemm'
    return 'other'


def flash_kernel(name):
    """'fwd', 'dq' or 'dkv' of a flash kernel's name."""
    return FLASH.search(name).group(1)


def export_events(prof):
    """The profiler's events as its chrome trace holds them, by way of a
    temporary file in ``TMPDIR`` that is removed at once."""
    fd, path = tempfile.mkstemp(suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)['traceEvents']
    finally:
        os.remove(path)


def reduce(events, steps, flash_launches=None):
    """One rank's record from chrome-trace events."""
    launched = {}
    spans, cpu = [], []
    for e in events:
        cat = e.get('cat')
        if e.get('ph') != 'X':
            continue
        if cat in RUNTIME_CATS and 'correlation' in e.get('args', {}):
            launched[e['args']['correlation']] = e['ts']
        elif cat == 'user_annotation' and \
                e['name'].startswith(SPAN_PREFIX):
            spans.append([e['name'], e['ts'], e['ts'] + e['dur']])
        elif cat == 'cpu_op':
            cpu.append((e['ts'], e['ts'] + e['dur'], e['name']))
    feeds = [s for s in spans if s[0] == SPAN_PREFIX + 'feed']
    reads = [s for s in spans if s[0] == SPAN_PREFIX + 'loss_read']
    window = [min(s[1] for s in feeds), max(s[2] for s in reads)]
    kernels = []
    for e in events:
        if e.get('ph') == 'X' and e.get('cat') in DEVICE_CATS:
            start, end = e['ts'], e['ts'] + e['dur']
            if end <= window[0] or start >= window[1]:
                continue
            kernels.append([e['name'], max(start, window[0]),
                            min(end, window[1]),
                            launched.get(e.get('args', {})
                                         .get('correlation'))])
    kernels.sort(key=lambda k: k[1])
    rec = {'kernels': kernels, 'spans': spans, 'window_us': window,
           'steps': steps, 'flash_launches': flash_launches}
    rec['idle_gaps'] = label_gaps(gaps(rec), spans, cpu)
    return rec


def union(intervals):
    """Merged [start, end] of intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def length(intervals):
    return sum(e - s for s, e in intervals)


def minus(a, b):
    """Length of the merged intervals ``a`` outside the merged ``b``."""
    out, j = 0.0, 0
    for s, e in a:
        cur = s
        while j < len(b) and b[j][1] <= cur:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                out += b[k][0] - cur
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            out += e - cur
    return out


def busy_us(rec):
    return length(union([k[1], k[2]] for k in rec['kernels']))


def gaps(rec):
    """The idle intervals of the window: between the union of device
    operations, and before the first and after the last."""
    lo, hi = rec['window_us']
    out, cur = [], lo
    for s, e in union([k[1], k[2]] for k in rec['kernels']):
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        out.append((cur, hi))
    return out


def _innermost(intervals, starts, t):
    """Name of the latest-starting interval (start, end, name) that holds
    time ``t``; intervals sorted by start."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - 400), -1):
        if intervals[j][1] >= t:
            return intervals[j][2]
    return None


def label_gaps(idle, spans, cpu):
    """{label: idle us}: each gap named by what the host was doing at its
    start, the benchmark's span and the innermost operator."""
    own = sorted((s[1], s[2], s[0][len(SPAN_PREFIX):]) for s in spans)
    cpu = sorted(cpu)
    own_starts = [s[0] for s in own]
    cpu_starts = [c[0] for c in cpu]
    out = {}
    for s, e in idle:
        span = _innermost(own, own_starts, s) or 'between_steps'
        op = _innermost(cpu, cpu_starts, s)
        label = span if op is None else '%s/%s' % (span, op)
        out[label] = out.get(label, 0.0) + (e - s)
    return out


def breakdown(rec, top=10):
    """The traced window's top device operations and idle gaps, in
    seconds, as the result line carries them."""
    ops = {}
    for name, s, e, _ in rec['kernels']:
        ops[name] = ops.get(name, 0.0) + (e - s)
    first = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(rec['idle_gaps'].items(), key=lambda kv: -kv[1])[:top]
    return {'device_ops': [[n, us / 1e6] for n, us in first],
            'idle_gaps': [[n, us / 1e6] for n, us in idle]}


def launched_in(k, rec, span):
    """Whether kernel ``k`` was launched inside one of the benchmark's
    ``perfbench.<span>`` ranges of rank record ``rec``."""
    t = k[3]
    if t is None:
        return False
    name = SPAN_PREFIX + span
    return any(s[1] <= t <= s[2] for s in rec['spans'] if s[0] == name)


def ms_per_step(rec, pick, with_rank=False, none_if_empty=False):
    """Device ms a step of the kernels ``pick`` keeps, averaged over the
    ranks; None where ``none_if_empty`` and no kernel was kept."""
    total, seen = 0.0, False
    for r in rec['ranks']:
        kept = [k for k in r['kernels']
                if (pick(k, r) if with_rank else pick(k))]
        seen = seen or bool(kept)
        total += sum(k[2] - k[1] for k in kept) / 1e3 / r['steps']
    if none_if_empty and not seen:
        return None
    return total / len(rec['ranks'])
