"""Deterministic fault injection for the loose-mode control/data plane
(a copy of ``autodist_tpu/utils/faultline.py``, framework-neutral).

The recovery machinery (epoch-fenced membership, peer-failure policies,
supervised restarts — see docs/design/fault-tolerance.md) is only
trustworthy if every failure mode it claims to survive can be produced
ON DEMAND, identically, in CI. This module is that producer: a
:class:`FaultPlan` is a seeded, serializable schedule of faults, and a
:class:`FaultLine` arms one plan in one process through the
:class:`~autodist_tpu_torch.runtime.coord_client.CoordClient` send hook —
every request frame headed for the wire passes through it, so faults
fire at exact, reproducible protocol points rather than "roughly when a
sleep elapses".

Fault kinds (each a dict in ``FaultPlan.faults``):

- ``kill_worker`` ``{worker, step, mode: exit|raise, exit_code}`` —
  the process dies the moment worker ``worker``'s published step
  counter would reach ``step`` (watched on the wire: the ``INCR`` of
  ``step/<worker>``). ``exit`` is a real crash (``os._exit``, no
  cleanup, no done marker — what the liveness layer must detect);
  ``raise`` throws :class:`InjectedFault` for in-process tests. The
  step's delta push has already landed when the publish fires, so the
  semantics are "crashed after pushing step k, before publishing it".
- ``drop_conn`` ``{match, at}`` — the ``at``-th frame containing
  ``match`` raises ``OSError`` instead of being sent.
- ``close_conn`` ``{match, at}`` — same, but the socket is closed
  first (the peer observes EOF, not just a failed caller).
- ``delay_conn`` ``{match, at, seconds}`` — the matching frame is
  delayed (slow-network emulation).
- ``torn_frame`` ``{match, at}`` — a matching whole-tensor BSET/BADD
  is rewritten as the FIRST CHUNK of a larger write whose continuation
  never comes, and the connection is dead afterwards: the
  died-mid-chunked-push signature readers must surface as a
  stalled-odd-version error instead of returning torn data.
- ``stalled_writer`` ``{match, at, seconds}`` — a CONTINUATION chunk
  (a ranged B* frame with offset > 0) is held for ``seconds`` before
  sending: readers see odd version parity that eventually resolves —
  the slow-but-alive writer the stall-timeout logic must NOT kill.
- ``join_drop`` / ``join_delay`` / ``join_kill`` ``{at, seconds,
  mode}`` — the admit-handshake faults (live scale-up,
  ``runtime/loose_session.py admit_worker``): the ``at``-th frame of THIS
  process's join handshake (default match ``join/`` — the world-claim
  INCRs; override ``match`` to target the step adoption or the epoch
  bump) is dropped (OSError), delayed, or is the process's death point
  (``exit`` = ``os._exit``, the real killed-mid-admit; ``raise`` =
  :class:`InjectedFault` for in-process tests). The membership
  machinery must absorb all three, and the handshake's epoch-bump-
  before-step-publish ordering makes every window benign: a death
  BEFORE the epoch bump leaves an invisible leaked ordinal with no
  step counter (harmless — nothing of it reaches any gate), a death
  AFTER it leaves a visible member with no beat, which the never-beat
  rule declares dead and the exclude path releases within one
  heartbeat window.

Frame counts, step thresholds and the plan seed make every fault
deterministic; ``FaultPlan.random`` derives a full plan from one seed
so a chaos suite can sweep seeds without hand-writing schedules. Plans
serialize to JSON and ride ``AUTODIST_FAULT_PLAN`` (inline JSON or
``@/path``) into launched worker processes — which install them
EXPLICITLY via :meth:`FaultLine.from_env`; production sessions never
read the flag.
"""
import json
import os
import time
from collections import defaultdict

import numpy as np

from autodist_tpu_torch.const import ENV
from autodist_tpu_torch.utils import logging

FAULT_KINDS = ('kill_worker', 'drop_conn', 'close_conn', 'delay_conn',
               'torn_frame', 'stalled_writer', 'join_drop',
               'join_delay', 'join_kill')

# the join_* kinds default their match to the admit handshake's
# world-claim frames; no field is strictly required
JOIN_MATCH_DEFAULT = 'join/'

_REQUIRED = {
    'kill_worker': ('worker', 'step'),
    'drop_conn': ('match',),
    'close_conn': ('match',),
    'delay_conn': ('match',),
    'torn_frame': ('match',),
    'stalled_writer': ('match',),
    'join_drop': (),
    'join_delay': (),
    'join_kill': (),
}


class InjectedFault(RuntimeError):
    """A ``kill_worker`` fault with ``mode='raise'`` fired."""


class FaultPlan:
    """A seeded, serializable schedule of faults.

    ``faults`` is a list of dicts (see module docstring for the
    per-kind fields); ``seed`` names the plan (and drives
    :meth:`random`). Plans are immutable value objects: arming state
    (fired flags, match counts) lives in :class:`FaultLine`.
    """

    def __init__(self, faults=(), seed=0):
        self.seed = int(seed)
        self.faults = []
        for f in faults:
            f = dict(f)
            kind = f.get('kind')
            if kind not in FAULT_KINDS:
                raise ValueError('unknown fault kind %r (one of %s)'
                                 % (kind, '|'.join(FAULT_KINDS)))
            missing = [k for k in _REQUIRED[kind] if k not in f]
            if missing:
                raise ValueError('fault %r missing field(s) %s'
                                 % (kind, missing))
            if 'at' in f and int(f['at']) < 1:
                raise ValueError('fault %r: "at" is 1-based' % kind)
            self.faults.append(f)

    def to_json(self):
        return json.dumps({'seed': self.seed, 'faults': self.faults},
                          sort_keys=True)

    @classmethod
    def from_json(cls, text):
        d = json.loads(text)
        return cls(d.get('faults', ()), seed=d.get('seed', 0))

    @classmethod
    def from_env(cls):
        """The plan configured in ``AUTODIST_FAULT_PLAN`` (inline JSON
        or ``@/path/to/plan.json``), or an empty plan when unset."""
        raw = ENV.AUTODIST_FAULT_PLAN.val
        if not raw:
            return cls()
        if raw.startswith('@'):
            with open(raw[1:]) as f:
                raw = f.read()
        return cls.from_json(raw)

    @classmethod
    def random(cls, seed, workers, steps, kinds=('kill_worker',)):
        """Derive a deterministic plan from one seed: for each kind,
        the target worker and firing point are drawn from a seeded RNG
        — a chaos sweep is then just a range of seeds."""
        rng = np.random.RandomState(seed)
        faults = []
        for kind in kinds:
            worker = workers[int(rng.randint(len(workers)))]
            at = int(rng.randint(1, max(2, steps)))
            if kind == 'kill_worker':
                faults.append({'kind': kind, 'worker': worker,
                               'step': at, 'mode': 'exit'})
            elif kind == 'delay_conn':
                faults.append({'kind': kind, 'worker': worker,
                               'match': 'BGET', 'at': at,
                               'seconds': 0.02 * (1 + int(
                                   rng.randint(4)))})
            elif kind == 'stalled_writer':
                faults.append({'kind': kind, 'worker': worker,
                               'match': 'BSET', 'at': at,
                               'seconds': 0.1 * (1 + int(
                                   rng.randint(3)))})
            elif kind.startswith('join_'):
                f = {'kind': kind, 'worker': worker,
                     'at': 1 + int(rng.randint(2))}
                if kind == 'join_delay':
                    f['seconds'] = 0.02 * (1 + int(rng.randint(4)))
                elif kind == 'join_kill':
                    f['mode'] = 'raise'
                faults.append(f)
            else:   # drop_conn / close_conn / torn_frame
                faults.append({'kind': kind, 'worker': worker,
                               'match': 'BADD', 'at': at})
        return cls(faults, seed=seed)


def _parse_publish(line):
    """``(step key, delta)`` when ``line`` is a step-publishing INCR."""
    if not line.startswith('INCR '):
        return None
    parts = line.split()
    if len(parts) != 3:
        return None
    try:
        delta = int(parts[2])
    except ValueError:
        return None
    return (parts[1], delta) if delta > 0 else None


def _continuation_offset(line):
    """The declared offset of a ranged B* frame (``... <off> <total>``),
    or None for whole-tensor frames. BSADD ranges count rows; the
    offset semantics (0 = opening chunk) are identical."""
    parts = line.split()
    if parts and parts[0] == 'BSADD':
        if len(parts) < 7:
            return None
    elif len(parts) < 6 or parts[0] not in ('BSET', 'BADD'):
        return None
    try:
        return int(parts[-2])
    except ValueError:
        return None


class FaultLine:
    """Arms one :class:`FaultPlan` in this process (context manager).

    Installs the class-wide ``CoordClient.fault_hook``; every fired
    fault is appended to :attr:`events` (kind, the frame that
    triggered it, a wall-clock stamp) so chaos tests and
    ``profiling.health_report`` can assert exactly what was injected.
    ``worker`` names this process (``'p0'``...): connection faults
    carrying a ``worker`` field arm only in that worker's process;
    ``kill_worker`` always matches on the wire key instead.
    """

    def __init__(self, plan, worker=None):
        self.plan = plan
        self.worker = worker
        self.events = []
        self._steps = {}                      # step key -> tracked total
        self._match_counts = defaultdict(int)  # fault idx -> seen frames
        self._fired = set()                   # fault idxs fired (once)
        self._dead = set()                    # id(client)s killed by torn_frame
        self._installed = False

    @classmethod
    def from_env(cls, worker=None):
        return cls(FaultPlan.from_env(), worker=worker)

    def install(self):
        from autodist_tpu_torch.runtime.coord_client import CoordClient
        if CoordClient.fault_hook is not None:
            raise RuntimeError('another FaultLine is already installed '
                               'in this process')
        CoordClient.fault_hook = self._hook
        self._installed = True
        if self.plan.faults:
            logging.warning('faultline armed (%d fault(s), seed %d)',
                            len(self.plan.faults), self.plan.seed)
        return self

    def uninstall(self):
        from autodist_tpu_torch.runtime.coord_client import CoordClient
        if self._installed:
            CoordClient.fault_hook = None
            self._installed = False

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()

    def _record(self, fault, line):
        self.events.append({'kind': fault['kind'], 'fault': dict(fault),
                            'line': line[:96], 'time': time.time()})

    # -- the CoordClient send hook ----------------------------------------
    def _hook(self, client, line, payload):
        if id(client) in self._dead:
            raise OSError('faultline: connection dead (writer died '
                          'after a torn frame)')
        pub = _parse_publish(line)
        replacement = None
        for idx, fault in enumerate(self.plan.faults):
            kind = fault['kind']
            if kind == 'kill_worker':
                if pub is None or not pub[0].endswith(
                        'step/' + fault['worker']):
                    continue
                total = self._steps.get(pub[0], 0) + pub[1]
                self._steps[pub[0]] = total
                from autodist_tpu_torch.runtime.coord_client import \
                    CLEAN_CLOSE_STEP
                if total >= CLEAN_CLOSE_STEP:
                    # a clean-close / exclusion RELEASE of the counter
                    # (Session.close, _exclude_peer), not the worker
                    # reaching its death step — and possibly published
                    # by a SURVIVOR on the victim's behalf: firing here
                    # would kill the wrong process at the wrong moment
                    continue
                if idx in self._fired or total < int(fault['step']):
                    continue
                self._fired.add(idx)
                self._record(fault, line)
                if fault.get('mode', 'exit') == 'raise':
                    raise InjectedFault(
                        'faultline: worker %s killed at step %d'
                        % (fault['worker'], fault['step']))
                logging.warning('faultline: hard-killing worker %s at '
                                'step %d', fault['worker'],
                                fault['step'])
                os._exit(int(fault.get('exit_code', 137)))
            # connection faults: scoped to this process when the fault
            # names a worker
            if fault.get('worker') and fault['worker'] != self.worker:
                continue
            # join_* kinds default their match to the admit handshake's
            # world-claim frames (loose_session.admit_worker)
            match = fault.get('match') or (
                JOIN_MATCH_DEFAULT if kind.startswith('join_') else '')
            if match not in line:
                continue
            if kind == 'stalled_writer':
                off = _continuation_offset(line)
                if not off:   # only a mid-sequence chunk can stall
                    continue
            self._match_counts[idx] += 1
            if idx in self._fired or \
                    self._match_counts[idx] != int(fault.get('at', 1)):
                continue
            self._fired.add(idx)
            self._record(fault, line)
            if kind == 'join_drop':
                raise OSError('faultline: dropped join-handshake frame '
                              '%r' % line[:64])
            if kind == 'join_kill':
                if fault.get('mode', 'exit') == 'raise':
                    raise InjectedFault(
                        'faultline: worker killed mid-admit (frame %r)'
                        % line[:64])
                logging.warning('faultline: hard-killing worker during '
                                'the admit handshake (frame %r)',
                                line[:64])
                os._exit(int(fault.get('exit_code', 137)))
            if kind == 'join_delay':
                time.sleep(float(fault.get('seconds', 0.05)))
                continue
            if kind == 'drop_conn':
                raise OSError('faultline: dropped connection before %r'
                              % line.split()[0])
            if kind == 'close_conn':
                try:
                    client._sock.close()
                except OSError:
                    pass
                raise OSError('faultline: closed connection before %r'
                              % line.split()[0])
            if kind == 'delay_conn':
                time.sleep(float(fault.get('seconds', 0.05)))
            elif kind == 'stalled_writer':
                time.sleep(float(fault.get('seconds', 0.5)))
            elif kind == 'torn_frame':
                replacement = self._tear(client, line, payload)
        return replacement

    def _tear(self, client, line, payload):
        """Rewrite a whole-tensor BSET/BADD (or whole-push BSADD) as
        the opening chunk of a write twice its size, then kill the
        connection: the canonical died-mid-chunked-push wreckage
        (version parity stays odd until the reader's stall timeout
        declares the writer dead). A BSADD's range counts ROWS, so the
        phantom continuation is another <nrows> rows."""
        parts = line.split()
        if parts and parts[0] == 'BSADD' and len(parts) == 5:
            nrows = int(parts[2])
            self._dead.add(id(client))
            return ('%s 0 %d' % (line, 2 * nrows), payload)
        if len(parts) != 4 or parts[0] not in ('BSET', 'BADD'):
            logging.warning('faultline: torn_frame matched a non-whole-'
                            'tensor frame %r; leaving it intact',
                            line[:64])
            return None
        nbytes = int(parts[2])
        elems = nbytes // (2 if parts[3] == 'bf16' else 4)
        self._dead.add(id(client))
        return ('%s 0 %d' % (line, 2 * elems), payload)
