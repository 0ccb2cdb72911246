"""Cross-worker telemetry aggregation over the PS plane itself (the
counterpart of ``autodist_tpu/telemetry/aggregate.py``; framework-neutral,
so copied).

Workers batch-push their drained span/event records to a
``<ns>/telemetry/`` namespace on the coord service through the
existing tensor wire (``vset``/``vmget``, no new protocol command:
records serialize to JSON, the bytes ride a float32 tensor frame), and
the chief assembles a cohort-wide timeline it can export as Chrome
``trace_event`` JSON or summarize per step.

Wire format of one batch (the value under
``<ns>/telemetry/<worker>/b<seq>``), byte for byte the JAX package's, so
a worker of either package and a chief of the other read each other's
batches:

- float32[0] = the JSON byte length ``n`` as a little-endian u32
  REINTERPRETED as float32 (a float-valued length would silently lose
  integer precision past 2^24 bytes);
- float32[1:] = the UTF-8 JSON bytes of the record list, zero-padded
  to a multiple of 4 and reinterpreted as float32.

Pushes and fetches pin ``wire='f32'`` explicitly: the frame is raw
bytes wearing a float costume, and a lossy session-wide wire setting
(bf16/i8) would corrupt it.

A per-worker batch counter ``<ns>/telemetry/<worker>/batches`` makes
collection race-free without listing keys: the chief reads the counter
(delta-0 ``INCR``) and fetches ``b1..bN``. Keys live inside the run
namespace on purpose: the run-end purge cleans them up with everything
else, so the chief collects before bumping its ``closed`` counter.
"""
import json

import numpy as np

from autodist_tpu_torch.utils import logging


def encode_records(records):
    """Record list -> the float32 batch tensor described above."""
    import struct
    raw = json.dumps(records, separators=(',', ':')).encode('utf-8')
    pad = (-len(raw)) % 4
    buf = struct.pack('<I', len(raw)) + raw + b'\0' * pad
    return np.frombuffer(buf, dtype='<f4').copy()


def decode_records(arr):
    """The inverse of :func:`encode_records` (None/empty -> [])."""
    if arr is None or getattr(arr, 'size', 0) < 1:
        return []
    buf = np.ascontiguousarray(
        np.asarray(arr, dtype=np.float32)).tobytes()
    import struct
    n = struct.unpack('<I', buf[:4])[0]
    return json.loads(buf[4:4 + n].decode('utf-8'))


def push_records(client, ns, worker, records):
    """Push one batch of records for ``worker``; returns the wire
    bytes moved (0 when there was nothing to push)."""
    if not records:
        return 0
    enc = encode_records(records)
    seq = client.incr('%s/telemetry/%s/batches' % (ns, worker), 1)
    client.vset('%s/telemetry/%s/b%d' % (ns, worker, seq), enc,
                wire='f32')
    return int(enc.size * 4)


def collect_records(client, ns, workers):
    """Chief-side cohort collection: every pushed batch of every named
    worker, each record tagged with its ``worker``. Missing batches
    (a worker that never pushed, a partially-landed final batch) are
    skipped, never fatal — collection runs at close/bench time and
    must not take down the run it summarizes."""
    out = []
    for worker in workers:
        try:
            n = client.incr('%s/telemetry/%s/batches' % (ns, worker), 0)
            if not n:
                continue
            specs = [('%s/telemetry/%s/b%d' % (ns, worker, i), None)
                     for i in range(1, n + 1)]
            for arr in client.vmget(specs, wire='f32'):
                for rec in decode_records(arr):
                    rec.setdefault('worker', worker)
                    out.append(rec)
        except Exception as e:  # noqa: BLE001 - best-effort summary
            logging.warning(
                'telemetry collection for %s/%s failed: %s: %s', ns,
                worker, type(e).__name__, e)
    out.sort(key=lambda r: r.get('t0', 0.0))
    return out


def collect_new_records(client, ns, workers, cursor):
    """Incremental cohort collection for the online monitor: only the
    batches pushed SINCE the previous call, judged per worker against
    ``cursor`` (``{worker: last consumed batch seq}``, updated in
    place) — the chief polls every few steps, so re-reading the whole
    batch history each time would grow the poll cost linearly with run
    length. Never fatal; and unlike :func:`collect_records` (which
    re-reads the full range every call) a batch missing from the
    middle of the range is NOT skipped: ``push_records`` bumps the
    atomic counter BEFORE the tensor write lands, so a poll racing an
    in-flight push sees the seq but not yet the bytes — the cursor
    only advances past batches that actually decoded, and the
    consumed prefix stops at the first gap so the in-flight batch is
    retried next poll instead of dropped forever."""
    out = []
    for worker in workers:
        try:
            n = client.incr('%s/telemetry/%s/batches' % (ns, worker), 0)
            last = int(cursor.get(worker, 0))
            if n <= last:
                continue
            specs = [('%s/telemetry/%s/b%d' % (ns, worker, i), None)
                     for i in range(last + 1, n + 1)]
            consumed = last
            for seq, arr in zip(range(last + 1, n + 1),
                                client.vmget(specs, wire='f32')):
                if arr is None:
                    # counter-bumped but not yet written: stop the
                    # consumed prefix here; this and any later batch
                    # re-fetch next poll (ingestion is step-keyed, so
                    # nothing downstream double-counts either way)
                    break
                for rec in decode_records(arr):
                    rec.setdefault('worker', worker)
                    out.append(rec)
                consumed = seq
            cursor[worker] = consumed
        except Exception as e:  # noqa: BLE001 - best-effort stream
            logging.warning(
                'incremental telemetry collection for %s/%s failed: '
                '%s: %s', ns, worker, type(e).__name__, e)
    out.sort(key=lambda r: r.get('t0', 0.0))
    return out


def _worker_ordinal(worker):
    try:
        return int(str(worker).lstrip('p'))
    except ValueError:
        return abs(hash(worker)) % 10000


def chrome_trace(records, flight_events=None):
    """Cohort records -> Chrome ``trace_event`` JSON (the dict; dump
    with ``json.dump``). One trace *process* per worker (named via
    metadata events) so per-worker step spans line up as rows;
    durations become ``ph='X'`` complete events, point events
    ``ph='i'`` instants; tags (step=, cmd=, ...) ride ``args`` so the
    viewer's search finds spans by step id. ``flight_events`` (a
    flight-recorder ring) is attached as instant events on a
    ``control-plane`` thread."""
    # the zero origin comes from whatever events exist — a flight-
    # events-only trace (dump files fed to trace_view with no span
    # batches) must still start near t=0, not at the raw epoch
    stamps = [r['t0'] for r in records if r.get('t0') is not None]
    stamps += [e['wall'] for e in (flight_events or [])
               if e.get('wall') is not None]
    t_min = min(stamps) if stamps else 0.0
    events = []
    seen_pids = {}
    for rec in records:
        worker = rec.get('worker', 'p0')
        pid = _worker_ordinal(worker)
        if pid not in seen_pids:
            seen_pids[pid] = worker
            events.append({'name': 'process_name', 'ph': 'M',
                           'pid': pid, 'tid': 0,
                           'args': {'name': 'worker %s' % worker}})
        ev = {'name': rec.get('name', '?'),
              'pid': pid, 'tid': 0,
              'ts': (rec.get('t0', t_min) - t_min) * 1e6,
              'args': dict(rec.get('tags') or {})}
        if 'dur' in rec:
            ev['ph'] = 'X'
            ev['dur'] = rec['dur'] * 1e6
        else:
            ev['ph'] = 'i'
            ev['s'] = 't'
        events.append(ev)
    for e in (flight_events or []):
        events.append({
            'name': e.get('kind', '?'), 'ph': 'i', 's': 'p',
            'pid': _worker_ordinal(e.get('worker_self', 'p0')),
            'tid': 1,
            'ts': (e.get('wall', t_min) - t_min) * 1e6,
            'args': {k: v for k, v in e.items()
                     if k not in ('t', 'wall')}})
    return {'traceEvents': events, 'displayTimeUnit': 'ms'}


def step_timeline(records):
    """Cohort-wide per-step summary: ``{step: {worker: step span
    seconds}}`` over the ``step`` spans — the table the chief logs and
    BENCH embeds (per-worker step spans aligned on step ids)."""
    out = {}
    for rec in records:
        tags = rec.get('tags') or {}
        if rec.get('name') != 'step' or 'step' not in tags:
            continue
        out.setdefault(int(tags['step']), {})[
            rec.get('worker', 'p0')] = round(rec.get('dur', 0.0), 6)
    return out
