"""The crash flight recorder: an always-on bounded ring buffer of
control-plane events, dumped to disk on failure triggers (a copy of
``autodist_tpu/telemetry/flight.py``, which is framework-neutral).

Chaos flakes die exactly when the evidence is needed: the ad-hoc stats
dicts the run kept are gone with the process, and the coord service
only holds the *current* state, not the ordering that produced it. The
flight recorder keeps the last ``AUTODIST_FLIGHT_RECORDER_EVENTS``
control-plane events (fence binds, epoch bumps, step publishes,
exclusions, admit phases, replan stage/swap) in a ring buffer — cheap
enough to leave on unconditionally (one locked deque append per event;
these are control-plane RPCs, not per-tensor hot-path work) — and
writes the ring to a JSON dump when a failure trigger fires:

- a :class:`~autodist_tpu_torch.runtime.coord_client.FencedWriteError`
  surfacing in ``Session.run`` (this process is a zombie);
- a peer exclusion (``Session._exclude_peer`` — somebody died);
- an executed re-plan refusal or failure;
- an unclean ``Session.close()`` (a failed final push).

The dump has the JAX package's schema, so its post-hoc conformance
checker (``autodist_tpu/analysis/conformance.py``) reads a port
worker's dump as it reads its own.

Event schema (one dict per event)::

    {'seq': int,        # monotone per-process sequence number
     't': float,        # perf_counter at record time
     'wall': float,     # wall clock at record time
     'kind': str,       # e.g. 'step_publish', 'exclude_claim'
     ...kind fields}    # small scalars only (worker=, step=, epoch=)

The recorder never raises out of :meth:`record` or :meth:`dump`: a
broken disk must not take down the run the recorder exists to explain.
"""
import json
import os
import threading
import time
from collections import deque

from autodist_tpu_torch.const import DEFAULT_WORKING_DIR, ENV
from autodist_tpu_torch.utils import logging


def telemetry_dir():
    """Where dumps and trace exports land
    (``AUTODIST_TELEMETRY_DIR``, default under the working dir)."""
    return ENV.AUTODIST_TELEMETRY_DIR.val or \
        os.path.join(DEFAULT_WORKING_DIR, 'telemetry')


class FlightRecorder:
    """Bounded ring of control-plane events + the dump trigger."""

    def __init__(self, capacity=None):
        cap = (ENV.AUTODIST_FLIGHT_RECORDER_EVENTS.val
               if capacity is None else int(capacity))
        self._lock = threading.Lock()
        self._ring = deque(maxlen=cap)
        self._seq = 0
        self._dump_seq = 0
        self._ctx = {}           # ns/worker, set by the session
        self.last_dump_path = None
        self.dumps = []          # [(reason, path)] audit

    def set_context(self, **ctx):
        """Attach run identity (``ns=``, ``worker=``, ``generation=``)
        to future dumps — the session calls this once it knows who it
        is."""
        with self._lock:
            self._ctx.update({k: v for k, v in ctx.items()
                              if v is not None})

    def record(self, kind, **fields):
        """Append one control-plane event (never raises)."""
        try:
            with self._lock:
                self._seq += 1
                ev = {'seq': self._seq, 't': time.perf_counter(),
                      'wall': time.time(), 'kind': kind}
                ev.update(fields)
                self._ring.append(ev)
        except Exception:  # noqa: BLE001 - the recorder must not kill
            pass           # the run it observes

    def events(self):
        """A snapshot of the retained ring (oldest first)."""
        with self._lock:
            return [dict(ev) for ev in self._ring]

    def dump(self, reason, path=None):
        """Write the ring to a JSON dump; returns the path (or None on
        failure — logged, never raised). Each trigger writes its OWN
        file (sequence-stamped) so a later trigger cannot overwrite
        the first failure's evidence."""
        try:
            with self._lock:
                events = [dict(ev) for ev in self._ring]
                ctx = dict(self._ctx)
                self._dump_seq += 1
                seq = self._dump_seq
            if path is None:
                os.makedirs(telemetry_dir(), exist_ok=True)
                path = os.path.join(
                    telemetry_dir(), 'flightrec-%s-%s-%d-%d.json'
                    % (ctx.get('ns', 'run'), ctx.get('worker', 'p'),
                       os.getpid(), seq))
            payload = {'reason': reason, 'dumped_at': time.time(),
                       'pid': os.getpid(), 'context': ctx,
                       'events': events}
            tmp = path + '.tmp'
            with open(tmp, 'w') as f:
                json.dump(payload, f, indent=1)
            os.replace(tmp, path)
            with self._lock:
                self.last_dump_path = path
                self.dumps.append((reason, path))
            logging.warning(
                'flight recorder: dumped %d control-plane events to %s '
                '(trigger: %s)', len(events), path, reason)
            return path
        except Exception as e:  # noqa: BLE001 - never kill the run
            logging.warning('flight recorder dump failed (%s): %s: %s',
                            reason, type(e).__name__, e)
            return None


def load_dump(path):
    """Read a dump back: ``(events, meta)`` — the conformance checker's
    input format. Raises ``ValueError`` for JSON that is not a dump
    (e.g. a span-record batch list fed to ``--conformance``), so CLI
    callers report it as a finding instead of dying on an
    AttributeError."""
    with open(path) as f:
        payload = json.load(f)
    if not isinstance(payload, dict) or 'events' not in payload:
        raise ValueError(
            'not a flight-recorder dump (expected a JSON object with '
            "an 'events' list; got %s)" % type(payload).__name__)
    events = payload.get('events', [])
    meta = {k: v for k, v in payload.items() if k != 'events'}
    return events, meta


_RECORDER = None
_RECORDER_LOCK = threading.Lock()


def recorder():
    """The process-wide flight recorder (always on)."""
    global _RECORDER
    rec = _RECORDER
    if rec is None:
        with _RECORDER_LOCK:
            rec = _RECORDER
            if rec is None:
                rec = _RECORDER = FlightRecorder()
    return rec


def reset():
    """Drop the singleton (test isolation hook)."""
    global _RECORDER
    with _RECORDER_LOCK:
        _RECORDER = None
