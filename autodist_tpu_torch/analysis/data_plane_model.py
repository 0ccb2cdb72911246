"""Executable small-scope model of the PS **data plane**.

The control-plane checker (:mod:`~autodist_tpu_torch.analysis.
protocol_model`) covers membership, fencing and gate orderings — but
three of the real concurrency bugs found by hand lived
one layer down, in the tensor data plane, guarded until now only by
hand reasoning:

- **the offset-0 abort**: ``abort_open_seq`` decremented
  ``open_writes`` for ANY rejected frame, so one malformed offset-0
  frame (which never opened a sequence — ``SeqFrame`` is constructed
  after the checks) closed ANOTHER writer's in-flight chunked
  sequence and cleared the torn-read parity bit under its feet — a
  reader then accepted half-written data as clean.
- **the disconnect wedge**: a writer killed between chunks (the
  exclude/restart policies' core died-mid-push case) sent no further
  frames; without the disconnect-time ``SeqAborter`` its sequence
  held ``open_writes`` forever and every reader retried odd parity
  until a ``DELNS``.
- **the telemetry-cursor race**: ``push_records`` bumps the
  atomic batch counter BEFORE the tensor write lands, so a monitor
  poll racing an in-flight push saw the seq but not the bytes — a
  cursor that advanced to the counter dropped that batch forever.

This module models exactly the cross-process data-plane state those
bugs live in, reusing the explorer unchanged via the
:class:`~autodist_tpu_torch.analysis.protocol_model.Scenario` hooks:

- the **tensor store**: per-key ``version``/``open_writes`` torn-read
  bookkeeping, ``SeqFrame`` chunked-sequence semantics (offset-0
  opens, final chunk closes, every rejection aborts), the offset-0
  abort rule, the disconnect-time ``SeqAborter``, and the B*
  fence-recheck-under-tensor-lock window (the wire-entry check and
  the commit are separate transitions, so a fence bump can land
  between them) — shared by the dense (BSET/BADD) and row-sparse
  (BSADD, ranges counting ROWS) writers, which differ only in what a
  "chunk" is;
- the **versioned reader** (BGET/BGETROWS ``v`` contract): a
  multi-chunk read accepts only when both version snapshots are even
  and equal, else retries — exactly ``coord_client``'s torn-read
  loop;
- the **session pipeline at depth 2**: join → gate → serve-prefetch →
  push → publish → bounded wait for the next step's staleness bound
  (``LooseSession._prefetch_gate``: it may time out) → peer-floor scan
  → pull-ahead, every RPC its own transition, with the peer-floor
  staleness guard (``run()`` discards a prefetch whose recorded floor
  is below the next step's staleness bound), the wait, and the floor's
  ordering (read after publish, before the pull-ahead) as
  configuration;
- the **telemetry batch-counter/cursor protocol**: counter bump and
  batch write as separate transitions (the real race window), the
  monitor's incremental cursor with its advance rule as
  configuration, and a close-time final sweep;
- the **local-SGD window** (sync rounds at ``local_steps`` H > 1):
  round-scoped gate → pull merged state → H local steps (no wire
  traffic) → one window-delta push whose merge rule ('average' =
  workers push delta/W so the PS lands the MEAN of the windows, vs
  the naive 'sum') and the gate's counter scope (sync ROUNDS vs raw
  train steps) are the configuration under test;
- the **serving snapshot seqlock** (the serving reader fleet): the
  trainer's per-round parity-odd → push tensors → publish → parity-
  even window (``LooseSession._snap_round_open/_close``) against
  non-voting replicas pulling multi-tensor snapshots, with the
  replica's ordering (pin parities+step first, pull, revalidate — vs
  the tempting read-then-stamp) as configuration and the writer
  crashable mid-round (the parity-stuck-odd keep-old-snapshot trade).

Invariants:

- **no torn read surfaces as clean** — an accepted (even, equal
  version) read must never observe chunks of a still-open write
  sequence (a sequence *aborted* by disconnect or rejection is
  legitimate partial data the staleness model absorbs — that is the
  service's documented contract, and the model encodes it);
- **no fenced zombie frame commits** after its fence bump (the
  under-tensor-lock re-check);
- **no reader wedges on odd parity after ANY writer death**
  (liveness: the stuck diagnosis names the wedged reader and the key
  whose parity is stuck odd);
- **prefetches never violate the serial staleness bound** — a served
  prefetch must contain every peer push the gate just guaranteed;
- **the cursor never permanently skips a decodable batch** (terminal
  invariant: after the final sweep, every batch whose bytes landed
  was consumed);
- **the H-step staleness bound** — a worker pulling at sync round r
  observes every peer's window pushes through round r − staleness,
  so no reader ever sees state older than H × gate_staleness train
  steps — and **window merges never diverge**: the PS total equals
  the mean of the pushed windows (the sum-not-average push is the
  pinned W-fold-overshoot counterexample);
- **no snapshot mixes tensor versions from different published
  steps** — an ACCEPTED serving snapshot's tensors all carry the one
  step it is stamped with (a replica losing its writer mid-round
  gives up and keeps serving its previous snapshot; it never blocks
  the trainer and never accepts the torn round).

What it deliberately does NOT model: payload values and shapes (the
chunk stamps track write identity, not bytes — BSADD's index/shape
validation is the fence lint's and the real service tests' job),
multi-key stores (one tensor key per scenario; per-key locks don't
interact), the stall-window timeout of the reader's retry loop
(unbounded retry + liveness detection is strictly stronger), wire
dtypes, and the control-plane orderings already covered by
``protocol_model``. See ``docs/design/static-analysis.md``.
"""
from dataclasses import dataclass, replace

from autodist_tpu_torch.analysis.protocol_model import Scenario, _set_violation


@dataclass(frozen=True)
class DataPlaneConfig:
    """Orderings under test. Defaults are HEAD's (must explore clean);
    each historical bug is one field flipped back."""

    #: which rejected frames abort an open sequence: 'continuation_only'
    #: (HEAD — only a declared offset > 0 frame can have opened one)
    #: vs 'any_frame' (the old rule: a malformed offset-0 frame
    #: closes ANOTHER writer's sequence).
    abort_offset0: str = 'continuation_only'
    #: whether a dead connection's open chunk sequences are aborted at
    #: disconnect (HEAD's SeqAborter) — False is the old service.
    disconnect_abort: bool = True
    #: where B* handlers check the fence: 'under_lock' (HEAD — the
    #: commit re-checks under the tensor lock) vs 'entry_only' (the
    #: wire-entry check alone; one in-flight zombie frame can commit
    #: after its fence bump).
    fence_recheck: str = 'under_lock'
    #: the depth-2 pipeline's prefetch ordering and run()'s guard:
    #: 'wait_then_discard' (HEAD, ``LooseSession._prefetch_gate``: after
    #: publish the pipeline waits for the next step's staleness bound,
    #: at most ``_PREFETCH_GATE_S``, so it may time out with a peer still
    #: below it; then floor scan and pull-ahead, and run() still discards
    #: a prefetch whose recorded peer floor is below the bound) vs
    #: 'wait_then_serve' (the same wait with no discard: a timed-out
    #: wait serves a stale prefetch) vs 'floor_discard' (the reference
    #: package's pipeline: pull ahead at once, discard below the floor)
    #: vs 'serve_always' (no wait, no discard; the first depth-2
    #: pipeline).
    prefetch_guard: str = 'wait_then_discard'
    #: when the pipeline job reads the peer floor: 'after_publish'
    #: (HEAD — push -> publish -> floor -> pull-ahead, so the floor
    #: lower-bounds what the pull observed) vs 'after_pull' (floor
    #: read last, overstating what the prefetch contains).
    floor_scan: str = 'after_publish'
    #: the monitor cursor's advance rule: 'decoded_prefix' (HEAD — the
    #: consumed prefix stops at the first not-yet-landed batch) vs
    #: 'counter' (the old rule: advance to the counter, dropping the
    #: in-flight batch forever).
    cursor_advance: str = 'decoded_prefix'
    #: training steps per worker in the pipeline scenario.
    steps: int = 2
    #: staleness window of the pipeline scenario's gate.
    staleness: int = 1
    #: mid-run monitor polls in the telemetry scenario (the close-time
    #: final sweep is extra).
    polls: int = 2
    #: local-SGD window length H in the local_sgd scenario: each
    #: worker takes H local optimizer steps per sync round, then
    #: pushes ONE window delta. Kept integer-divisible by the worker
    #: count so the merged mean is exact integer arithmetic.
    local_steps: int = 2
    #: the window merge rule: 'average' (HEAD — the session scales the
    #: pushed delta by 1/W so the commutative BADD lands the MEAN of
    #: the workers' windows) vs 'sum' (the naive push: the PS total
    #: overshoots W-fold, the pinned divergence counterexample).
    window_merge: str = 'average'
    #: the staleness gate's counter scope under H > 1: 'rounds' (HEAD
    #: — gate_at and the published floors both count sync ROUNDS) vs
    #: 'steps' (the gate target scaled to raw train steps while peers
    #: still publish rounds — the mixed-scope deadlock the coordinator
    #: forwards AUTODIST_LOCAL_STEPS to prevent).
    gate_scope: str = 'rounds'
    #: the serving replica's snapshot ordering:
    #: 'pin_then_read' (HEAD — pin the seqlock parities + published
    #: step FIRST, pull every tensor, revalidate the parities, accept
    #: iff unchanged) vs 'read_then_pin' (the tempting-but-wrong
    #: ordering: pull the tensors, THEN read the parity/step and stamp
    #: the snapshot — a writer completing a whole sync round between
    #: two tensor reads yields an undetectably mixed snapshot).
    snapshot_order: str = 'pin_then_read'
    #: the trainer's snap-parity behavior across an epoch-swap re-key
    #: 'bump' (HEAD — ``LooseSession._execute_replan`` brackets
    #: the re-key in ``_snap_round_open/_close``, so a replica pull
    #: straddling the swap boundary can never revalidate its pinned
    #: parity) vs 'silent' (re-key the tensors without touching the
    #: parity — a replica that pinned before the swap and read across
    #: it revalidates an UNCHANGED parity and accepts a snapshot
    #: mixing pre- and post-swap shard layouts: with overlapping key
    #: names of different geometry, merged garbage).
    swap_parity: str = 'bump'


HEAD = DataPlaneConfig()
#: Historical bug: any rejected frame decremented open_writes.
OFFSET0_ABORT_ANY_FRAME = replace(HEAD, abort_offset0='any_frame')
#: Historical bug: no disconnect-time sequence abort.
NO_DISCONNECT_ABORT = replace(HEAD, disconnect_abort=False)
#: Historical bug: the cursor advanced to the batch counter.
CURSOR_TO_COUNTER = replace(HEAD, cursor_advance='counter')
#: Same class, not historical: fence checked at wire entry only.
UNLOCKED_FENCE_RECHECK = replace(HEAD, fence_recheck='entry_only')
#: ...the pipeline serving a too-early prefetch unguarded (the bounded
#: wait alone does not bound it: the wait may time out)...
NO_FLOOR_DISCARD = replace(HEAD, prefetch_guard='wait_then_serve')
#: The reference package's pipeline (pull ahead at once, discard a
#: prefetch below the floor): explores clean too.
PULL_AT_ONCE = replace(HEAD, prefetch_guard='floor_discard')
#: ...and the floor read AFTER the pull-ahead it must lower-bound.
FLOOR_AFTER_PULL = replace(HEAD, floor_scan='after_pull')
#: The local-SGD window pushed raw (sum of local deltas, no 1/W
#: scale): every sync round the PS overshoots W-fold.
LOCAL_SGD_SUM = replace(HEAD, window_merge='sum')
#: The gate target scaled to train steps while peers publish sync
#: rounds: every worker blocks at its first gate forever.
LOCAL_SGD_STEP_GATE = replace(HEAD, gate_scope='steps')
#: The serving replica pulling its tensors BEFORE pinning the
#: parity/step: a writer completing a whole round between two tensor
#: reads serves an undetectably mixed snapshot.
SNAPSHOT_READ_BEFORE_PIN = replace(HEAD, snapshot_order='read_then_pin')
#: The epoch-swap re-key applied WITHOUT the snap-parity bracket: a
#: replica pull straddling the swap boundary revalidates clean and
#: serves a snapshot mixing the two shard layouts.
SWAP_SILENT_REKEY = replace(HEAD, swap_parity='silent')


# -- tensor-store semantics ----------------------------------------------

def _t_open(m, key):
    return m['counters'].get('t/%s/open' % key, 0)


def _t_ver(m, key):
    return m['counters'].get('t/%s/ver' % key, 0)


def _t_parity(m, key):
    """The BGET/BGETROWS 'v' reply: version*2 + (open_writes>0)."""
    return _t_ver(m, key) * 2 + (1 if _t_open(m, key) > 0 else 0)


def _seq_open(m, key, proc):
    """The write-id ``proc``'s connection holds open on ``key``
    (conn->open_seqs), or ''."""
    return m['kv'].get('seq/%s/%s' % (key, proc), '')


def seq_open_frame(m, key, proc, wid):
    """Offset-0 frame of a chunked write: opens the sequence
    (``++open_writes``, conn->open_seqs.insert)."""
    m['counters']['t/%s/open' % key] = _t_open(m, key) + 1
    m['kv']['seq/%s/%s' % (key, proc)] = wid


def seq_close(m, key, proc):
    """Release one open_writes slot + the connection's open-seq entry
    — the shared tail of finish(final), fail() and the aborts."""
    if _t_open(m, key) > 0:
        m['counters']['t/%s/open' % key] = _t_open(m, key) - 1
    m['kv'].pop('seq/%s/%s' % (key, proc), None)


def seq_abort_rejected(m, cfg, key, proc, off_declared):
    """abort_open_seq: a rejected frame's cleanup. HEAD only aborts
    when the frame DECLARED a continuation offset (off > 0) — an
    offset-0 frame never opened a sequence, so decrementing for it
    closes another writer's. The old rule decrements for any
    rejected frame."""
    if cfg.abort_offset0 == 'continuation_only' and off_declared <= 0:
        return
    # the pre-fix decrement hits the TENSOR counter even though this
    # connection opened nothing — exactly the bug
    if _t_open(m, key) > 0:
        m['counters']['t/%s/open' % key] = _t_open(m, key) - 1
    m['kv'].pop('seq/%s/%s' % (key, proc), None)


def disconnect_abort(m, cfg, proc):
    """serve_conn's SeqAborter: abort every sequence the dead
    connection still holds open (HEAD); the old service leaked
    them."""
    if not cfg.disconnect_abort:
        return
    for k in [k for k in m['kv'] if k.startswith('seq/')
              and k.endswith('/' + proc)]:
        key = k.split('/')[1]
        seq_close(m, key, proc)


def _fenced(m, proc):
    p = m['procs'][proc]
    fk = p.get('fence_key')
    return bool(fk) and m['counters'].get(fk, 0) > p.get('fence_gen', 0)


# -- process roles --------------------------------------------------------

def _writer_transitions(m, cfg, n, p):
    """A chunked B* writer (BSET/BADD dense chunks or BSADD row
    ranges — identical SeqFrame semantics; ``p['sparse']`` only labels
    the frames). One 2-chunk sequence: the offset-0 frame, then the
    final frame split into wire-entry and under-lock commit so the
    fence-recheck window is explored."""
    key = p['tkey']
    kind = 'BSADD rows' if p['sparse'] else 'BSET chunk'
    if p['wphase'] == 'w0':
        def w0(m2, n=n):
            p2 = m2['procs'][n]
            if _fenced(m2, n):
                # rejected at wire entry; an offset-0 frame opened
                # nothing, so there is nothing to abort (HEAD) — but
                # the old rule aborts anyway
                seq_abort_rejected(m2, cfg, key, n, 0)
                p2['status'] = 'failed'
                return
            wid = '%s#%d' % (n, p2['wseq'])
            seq_open_frame(m2, key, n, wid)
            m2['kv']['t/%s/c0' % key] = wid
            m2['counters']['t/%s/ver' % key] = _t_ver(m2, key) + 1
            p2['wphase'] = 'w1e'
        return [(n, 'writes %s 0 of write %s#%d (opens sequence, '
                 'parity goes odd)' % (kind, n, p['wseq']), w0)]
    if p['wphase'] == 'w1e':
        def w1_entry(m2, n=n):
            p2 = m2['procs'][n]
            if _fenced(m2, n):
                # rejected at wire entry: a continuation frame aborts
                # the sequence it opened so readers are not wedged
                seq_abort_rejected(m2, cfg, key, n, 1)
                p2['status'] = 'failed'
                return
            p2['wphase'] = 'w1c'
        return [(n, 'final %s of %s#%d passes the wire-entry fence '
                 'check' % (kind, n, p['wseq']), w1_entry)]
    if p['wphase'] == 'w1c':
        def w1_commit(m2, n=n):
            p2 = m2['procs'][n]
            if _fenced(m2, n):
                if cfg.fence_recheck == 'under_lock':
                    # reject_fenced_under_tensor_lock: the re-check
                    # under the tensor lock aborts the sequence
                    seq_close(m2, key, n)
                    p2['status'] = 'failed'
                    return
                # entry_only: the zombie frame commits anyway
                _set_violation(
                    m2, 'zombie-frame-commit',
                    'the final %s of %s committed AFTER its fence '
                    'bump: the wire-entry check alone leaves a window '
                    '— B* handlers must re-check the fence under the '
                    'tensor lock' % (kind, n))
            wid = '%s#%d' % (n, p2['wseq'])
            m2['kv']['t/%s/c1' % key] = wid
            m2['counters']['t/%s/ver' % key] = _t_ver(m2, key) + 1
            seq_close(m2, key, n)
            p2['wseq'] += 1
            if p2['wseq'] > p2['writes']:
                p2['status'] = 'done'
            else:
                p2['wphase'] = 'w0'
        return [(n, 'final %s of %s#%d commits (closes sequence, '
                 'version bumps)' % (kind, n, p['wseq']), w1_commit)]
    raise AssertionError(p['wphase'])


def _malformed_transitions(m, cfg, n, p):
    """A writer whose single offset-0 frame is malformed and rejected
    before any SeqFrame exists (bad payload / bad range) — the offset-0
    trigger."""
    def reject(m2, n=n):
        seq_abort_rejected(m2, cfg, p['tkey'], n, 0)
        m2['procs'][n]['status'] = 'done'
    return [(n, 'malformed offset-0 frame is rejected (ERR bad '
             'payload)', reject)]


def _reader_transitions(m, cfg, n, p):
    """The coord_client torn-read loop over a 2-chunk versioned read:
    accept only when both version snapshots are even and equal, else
    retry. An accepted read that observed a chunk of a still-OPEN
    sequence is the torn-read violation."""
    key = p['tkey']
    if p['rphase'] == 'r0':
        def r0(m2, n=n):
            p2 = m2['procs'][n]
            p2['ver0'] = _t_parity(m2, key)
            p2['saw0'] = m2['kv'].get('t/%s/c0' % key, 'init')
            p2['rphase'] = 'r1'
        return [(n, 'reads chunk 0 + version (BGET v)', r0)]

    def r1(m2, n=n):
        p2 = m2['procs'][n]
        ver1 = _t_parity(m2, key)
        saw1 = m2['kv'].get('t/%s/c1' % key, 'init')
        if p2['ver0'] % 2 or ver1 % 2 or p2['ver0'] != ver1:
            p2['rphase'] = 'r0'   # torn: retry (coord_client backoff)
            return
        # accepted as CLEAN: neither chunk may come from a sequence
        # that is still open (aborted partial data is legitimate
        # bounded-lag state; in-flight data is a torn read)
        open_wids = {m2['kv'][k] for k in m2['kv']
                     if k.startswith('seq/%s/' % key)}
        for saw in (p2['saw0'], saw1):
            if saw in open_wids:
                _set_violation(
                    m2, 'torn-read-clean',
                    'reader %s accepted a CLEAN read (version even '
                    'and stable) that observed chunk data of the '
                    'still-open write sequence %s — the parity bit '
                    'was cleared under the writer\'s feet' % (n, saw))
        p2['status'] = 'done'
    return [(n, 'reads chunk 1 + version; accept iff even and '
             'unchanged', r1)]


def _fencer_transitions(m, cfg, n, p):
    """The exclude path's fence bump, abstracted to one transition
    (its own ordering is protocol_model's domain): enabled only when
    the target is stalled/crashed — the heartbeat-timeout ground-truth
    abstraction."""
    w = p['target']
    st = m['procs'][w]['status']
    ts = []
    if not p['bumped'] and st in ('stalled', 'crashed'):
        def bump(m2, n=n, w=w):
            fk = m2['procs'][w]['fence_key']
            m2['counters'][fk] = m2['counters'].get(fk, 0) + 1
            m2['procs'][n]['bumped'] = True
        ts.append((n, 'declares %s dead and bumps its fence '
                   '(exclude path)' % w, bump))
    if p['bumped'] or st in ('done', 'failed'):
        def fin(m2, n=n):
            m2['procs'][n]['status'] = 'done'
        ts.append((n, 'fencer done', fin))
    return ts


# -- depth-2 pipeline ------------------------------------------------------

def _after_wait(cfg):
    """The pipeline job's phase after publish (and the prefetch wait)."""
    return 'floor' if cfg.floor_scan == 'after_publish' else 'pull'


def _pipe_transitions(m, cfg, n, p):
    """One loose-mode worker at pipeline depth 2. Each RPC of the
    run() loop and of the background job is its own transition:
    join -> gate -> serve (prefetch or fresh pull) -> push -> publish
    -> peer-floor scan -> pull-ahead -> next step. 'data/<w>' counters
    are push counts (push -> publish order holds by construction, as
    in the session); the prefetch record carries the floor it scanned
    and the per-peer push counts its pull actually observed."""
    s = p['step']
    peers = [w for w in sorted(m['procs'])
             if m['procs'][w]['role'] == 'pworker' and w != n]

    if p['pphase'] == 'gate':
        # join happened implicitly: the prefetch record is already in
        # p (the bg job's transitions completed before run() proceeds
        # — run() joins the pipeline first, so own-thread overlap
        # never touches shared state)
        target = s - cfg.staleness
        steps = [m['counters'].get('step/%s' % w, 0)
                 for w in sorted(m['procs'])
                 if m['procs'][w]['role'] == 'pworker']
        if target <= 0 or min(steps) >= target:
            def gate(m2, n=n):
                m2['procs'][n]['pphase'] = 'serve'
            return [(n, 'gate passes (step %d)' % s, gate)]
        return []   # blocked: MINWAIT (liveness catches deadlock)

    if p['pphase'] == 'serve':
        def serve(m2, n=n):
            p2 = m2['procs'][n]
            bound = p2['step'] - cfg.staleness
            if p2['pf_floor'] >= 0:   # a prefetch is in hand
                use = True
                if cfg.prefetch_guard in ('floor_discard',
                                          'wait_then_discard') and \
                        p2['pf_floor'] < bound:
                    use = False   # discard; the refetch is serial
                if use:
                    # the serial-staleness invariant: the served pull
                    # must contain every peer push the gate guarantees
                    observed = dict(p2['pf_seen'])
                    for i, w in enumerate(peers):
                        if observed.get(w, 0) < bound:
                            _set_violation(
                                m2, 'stale-prefetch',
                                'worker %s served a prefetch at step '
                                '%d whose pull observed only %d '
                                'push(es) from %s (< the staleness '
                                'bound %d the gate just guaranteed) '
                                '— recorded floor %d let it through'
                                % (n, p2['step'], observed.get(w, 0),
                                   w, bound, p2['pf_floor']))
                p2['pf_floor'] = -1
                p2['pf_seen'] = ()
            # fresh pull (or post-discard refetch) is an atomic read
            # of current state: trivially within the bound
            p2['pphase'] = 'push'
        return [(n, 'serves the step-%d pull (prefetch or fresh)' % s,
                 serve)]

    if p['pphase'] == 'push':
        def push(m2, n=n):
            m2['counters']['data/%s' % n] = \
                m2['counters'].get('data/%s' % n, 0) + 1
            m2['procs'][n]['pphase'] = 'publish'
        return [(n, 'bg: pushes step-%d delta' % s, push)]

    if p['pphase'] == 'publish':
        def publish(m2, n=n):
            m2['counters']['step/%s' % n] = s
            p2 = m2['procs'][n]
            if p2['step'] >= cfg.steps:
                p2['status'] = 'done'   # last step: no pull-ahead
            elif cfg.prefetch_guard.startswith('wait_') and \
                    s + 1 - cfg.staleness > 0:
                p2['pphase'] = 'pwait'
            else:
                p2['pphase'] = _after_wait(cfg)
        return [(n, 'bg: publishes step %d' % s, publish)]

    if p['pphase'] == 'pwait':
        # MINWAIT for the next step's bound over every member, with a
        # timeout: passing needs every counter at the bound, the
        # timeout is always possible (a slow peer, a loaded host)
        bound = s + 1 - cfg.staleness

        def waited(m2, n=n):
            m2['procs'][n]['pphase'] = _after_wait(cfg)
        ts = [(n, 'bg: prefetch wait times out (a peer below the step-%d '
               'bound %d)' % (s + 1, bound), waited)]
        if min(m['counters'].get('step/%s' % w, 0)
               for w in peers + [n]) >= bound:
            ts.insert(0, (n, 'bg: prefetch wait sees every counter at the '
                          'step-%d bound %d' % (s + 1, bound), waited))
        return ts

    if p['pphase'] == 'floor':
        def floor(m2, n=n):
            p2 = m2['procs'][n]
            vals = [m2['counters'].get('step/%s' % w, 0)
                    for w in peers] or [s]
            p2['pf_floor'] = min(min(vals), s)
            p2['pphase'] = 'pull' if cfg.floor_scan == \
                'after_publish' else 'next'
        return [(n, 'bg: scans peer step counters for the floor',
                 floor)]

    if p['pphase'] == 'pull':
        def pull(m2, n=n):
            p2 = m2['procs'][n]
            p2['pf_seen'] = tuple(sorted(
                (w, m2['counters'].get('data/%s' % w, 0))
                for w in peers))
            p2['pphase'] = 'next' if cfg.floor_scan == \
                'after_publish' else 'floor'
        return [(n, 'bg: pull-ahead snapshots peer state', pull)]

    # 'next': advance to the next run() iteration
    def nxt(m2, n=n):
        p2 = m2['procs'][n]
        p2['step'] += 1
        p2['pphase'] = 'gate'
    return [(n, 'run() returns; next step begins', nxt)]


# -- local-SGD window ------------------------------------------------------

def _lworker_transitions(m, cfg, n, p):
    """One loose-mode worker under local-SGD ``H = cfg.local_steps``:
    round-scoped gate → pull merged state → H local steps (pure
    device work, no wire traffic) → one window-delta push (the merge
    rule is the configuration) → publish the sync round. Integer
    arithmetic throughout: a local step contributes +1 to the window
    delta, so under 'average' each push lands ``H // W`` on the PS
    counter and the merged total stays exactly the mean of the
    workers' windows."""
    r = p['round']
    workers = [w for w in sorted(m['procs'])
               if m['procs'][w]['role'] == 'lworker']
    peers = [w for w in workers if w != n]

    if p['lphase'] == 'gate':
        # the staleness gate re-scoped to sync rounds: gate_at = r,
        # floors are published ROUND counters. The 'steps' scope is
        # the mixed-scope bug — the target inflates H-fold while the
        # floors stay in rounds, so no gate ever passes again.
        target = r - cfg.staleness
        if cfg.gate_scope == 'steps':
            target = r * cfg.local_steps - cfg.staleness
        floors = [m['counters'].get('round/%s' % w, 0) for w in workers]
        if target <= 0 or min(floors) >= target:
            def gate(m2, n=n):
                m2['procs'][n]['lphase'] = 'pull'
            return [(n, 'round-%d gate passes (floors in sync rounds)'
                     % r, gate)]
        return []   # blocked: MINWAIT (liveness catches deadlock)

    if p['lphase'] == 'pull':
        def pull(m2, n=n):
            p2 = m2['procs'][n]
            # the H-step staleness bound: the gate just guaranteed
            # every peer published round >= r - staleness, and pushes
            # land BEFORE publishes, so the merged state this pull
            # observes contains every peer window through that round
            # — i.e. nothing older than H x gate_staleness steps
            bound = p2['round'] - cfg.staleness
            for w in peers:
                if m2['counters'].get('round/%s' % w, 0) < bound:
                    _set_violation(
                        m2, 'stale-window-read',
                        'worker %s pulled at sync round %d but peer '
                        '%s had only published round %d (< the bound '
                        '%d) — the merged state is older than '
                        'H x gate_staleness train steps'
                        % (n, p2['round'], w,
                           m2['counters'].get('round/%s' % w, 0),
                           bound))
            p2['lstep'] = 0
            p2['lphase'] = 'local'
        return [(n, 'pulls merged state for round %d' % r, pull)]

    if p['lphase'] == 'local':
        def step(m2, n=n):
            p2 = m2['procs'][n]
            p2['lstep'] += 1
            if p2['lstep'] >= cfg.local_steps:
                p2['lphase'] = 'push'
        return [(n, 'local step %d/%d of round %d (no wire traffic)'
                 % (p['lstep'] + 1, cfg.local_steps, r), step)]

    if p['lphase'] == 'push':
        def push(m2, n=n):
            # 'average': the session scales the window delta by 1/W
            # before the commutative BADD; 'sum' is the naive raw push
            amt = cfg.local_steps
            if cfg.window_merge == 'average':
                amt = cfg.local_steps // len(workers)
            m2['counters']['ps/T'] = \
                m2['counters'].get('ps/T', 0) + amt
            m2['counters']['pushed/%s' % n] = \
                m2['counters'].get('pushed/%s' % n, 0) + 1
            m2['procs'][n]['lphase'] = 'publish'
        return [(n, 'pushes the %s window delta of round %d'
                 % (cfg.window_merge, r), push)]

    # 'publish': bump the round floor; the last round ends the worker
    def publish(m2, n=n):
        p2 = m2['procs'][n]
        m2['counters']['round/%s' % n] = r
        if p2['round'] >= cfg.steps:
            p2['status'] = 'done'
        else:
            p2['round'] += 1
            p2['lphase'] = 'gate'
    return [(n, 'publishes sync round %d' % r, publish)]


def _local_sgd_terminal_check(m):
    """The window-merge divergence invariant: once every worker is
    done, the PS total must equal the MEAN of the pushed windows —
    total_pushes x H / W. The sum-not-average push lands W x that."""
    workers = sorted(w for w in m['procs']
                     if m['procs'][w]['role'] == 'lworker')
    if not workers:
        return []
    h = m['procs'][workers[0]]['h']
    pushes = sum(m['counters'].get('pushed/%s' % w, 0)
                 for w in workers)
    expect = pushes * h // len(workers)
    ps = m['counters'].get('ps/T', 0)
    if ps != expect:
        return [(
            'window-sum-divergence',
            'after %d window push(es) of H=%d across %d workers the '
            'PS total is %d, not the window mean %d — the deltas '
            'were pushed raw (sum) instead of scaled by 1/W, so the '
            'merged state overshoots W-fold every sync round'
            % (pushes, h, len(workers), ps, expect))]
    return []


# -- serving snapshot seqlock --------------------------------------------

def _snap_parity(m, writers):
    """The replica's parity pin: the sum of every trainer's snap
    counter. Any in-flight round makes it odd; any COMPLETED round
    changes its value — so 'unchanged across the pull' implies no
    write activity at all, which is exactly what revalidation needs."""
    return sum(m['counters'].get('snap/%s' % w, 0) for w in writers)


def _snap_floor(m, writers):
    """The published floor the snapshot is stamped with: min published
    step across the cohort."""
    return min(m['counters'].get('sstep/%s' % w, 0) for w in writers)


def _swriter_transitions(m, cfg, n, p):
    """The trainer's publish path as the serving tier sees it
    (``LooseSession._snap_round_open/_close`` around ``_push_ps_deltas`` +
    ``publish_step``): per sync round the parity counter goes ODD, the
    dense tensors land one by one, the step publishes, the parity
    returns EVEN. A crash between any two transitions leaves the
    parity odd forever — the replica's documented trade is to keep
    serving its previous snapshot, never to block or to accept."""
    r = p['round']
    if p['sphase'] == 'open':
        def sopen(m2, n=n):
            m2['counters']['snap/%s' % n] = \
                m2['counters'].get('snap/%s' % n, 0) + 1
            m2['procs'][n]['sphase'] = 'pushA'
        return [(n, 'snap parity goes ODD for round %d' % r, sopen)]
    if p['sphase'] == 'pushA':
        def push_a(m2, n=n):
            m2['kv']['sv/A'] = r
            m2['procs'][n]['sphase'] = 'pushB'
        return [(n, 'pushes tensor A at round %d' % r, push_a)]
    if p['sphase'] == 'pushB':
        def push_b(m2, n=n):
            m2['kv']['sv/B'] = r
            m2['procs'][n]['sphase'] = 'publish'
        return [(n, 'pushes tensor B at round %d' % r, push_b)]
    if p['sphase'] == 'publish':
        def publish(m2, n=n):
            m2['counters']['sstep/%s' % n] = r
            m2['procs'][n]['sphase'] = 'close'
        return [(n, 'publishes step %d' % r, publish)]
    if p['sphase'] == 'close':
        # parity returns even; the last round either ends the trainer
        # or hands off to a pending epoch-swap re-key
        def sclose(m2, n=n):
            p2 = m2['procs'][n]
            m2['counters']['snap/%s' % n] = \
                m2['counters'].get('snap/%s' % n, 0) + 1
            if p2['round'] >= p2['rounds']:
                if p2.get('swap_pending'):
                    p2['sphase'] = 'swapopen' \
                        if cfg.swap_parity == 'bump' else 'rekeyA'
                else:
                    p2['status'] = 'done'
            else:
                p2['round'] += 1
                p2['sphase'] = 'open'
        return [(n, 'snap parity returns EVEN after round %d' % r,
                 sclose)]

    # -- epoch-swap re-key: LooseSession._execute_replan moving the
    # authoritative PS values old-keys -> new-keys. Values are moved,
    # never recomputed (sv/* unchanged); what changes is the shard
    # LAYOUT (lay/*). HEAD brackets the re-key in the same snap-parity
    # open/close the push path uses, so a straddling replica pull can
    # never revalidate; the 'silent' configuration re-keys without it.
    if p['sphase'] == 'swapopen':
        def swopen(m2, n=n):
            m2['counters']['snap/%s' % n] = \
                m2['counters'].get('snap/%s' % n, 0) + 1
            m2['procs'][n]['sphase'] = 'rekeyA'
        return [(n, 'snap parity goes ODD for the epoch-swap re-key',
                 swopen)]
    if p['sphase'] == 'rekeyA':
        def rekey_a(m2, n=n):
            m2['kv']['lay/A'] = 2
            m2['procs'][n]['sphase'] = 'rekeyB'
        return [(n, 're-keys tensor A under the new plan (layout 2)',
                 rekey_a)]
    if p['sphase'] == 'rekeyB':
        def rekey_b(m2, n=n):
            p2 = m2['procs'][n]
            m2['kv']['lay/B'] = 2
            if cfg.swap_parity == 'bump':
                p2['sphase'] = 'swapclose'
            else:
                p2['status'] = 'done'
        return [(n, 're-keys tensor B under the new plan (layout 2)',
                 rekey_b)]
    # 'swapclose': parity returns even, the swap is committed
    def swclose(m2, n=n):
        m2['counters']['snap/%s' % n] = \
            m2['counters'].get('snap/%s' % n, 0) + 1
        m2['procs'][n]['status'] = 'done'
    return [(n, 'snap parity returns EVEN after the re-key', swclose)]


def _sreader_transitions(m, cfg, n, p):
    """A non-voting serving replica pulling one multi-tensor snapshot.

    'pin_then_read' (HEAD): pin the parity sum + published floor while
    even, read tensor A, read tensor B, then REVALIDATE — accept only
    if the parity sum is unchanged (the monotone counter makes
    'unchanged' mean 'no write landed'), else retry from the pin. A
    parity stuck odd with every trainer dead is the crashed-writer
    case: the replica gives up this pull and keeps its previous
    snapshot (it must never stall, and must never accept the torn
    round).

    'read_then_pin' (the seeded tempting-but-wrong ordering): read the
    tensors FIRST, then read the parity/step once and stamp the
    snapshot if even — a trainer completing a whole round between the
    two tensor reads leaves the parity even again, so the mixed
    snapshot is accepted undetectably."""
    writers = sorted(w for w in m['procs']
                     if m['procs'][w]['role'] == 'swriter')

    def writer_live(m2):
        return any(m2['procs'][w]['status'] in ('running', 'stalled')
                   for w in writers)

    def accept(m2, n, pinned_step):
        p2 = m2['procs'][n]
        if p2.get('lay_a', 1) != p2.get('lay_b', 1):
            _set_violation(
                m2, 'swap-torn-snapshot',
                'replica %s ACCEPTED a snapshot straddling the '
                'epoch-swap re-key: tensor A carries shard layout %d, '
                'tensor B layout %d — with overlapping key names of '
                'different geometry the merged value is garbage, and '
                'the parity revalidation never fired'
                % (n, p2.get('lay_a', 1), p2.get('lay_b', 1)))
        elif p2['saw_a'] != p2['saw_b'] or p2['saw_a'] != pinned_step:
            _set_violation(
                m2, 'mixed-version-snapshot',
                'replica %s ACCEPTED a snapshot stamped step %d whose '
                'tensors carry versions A=%d B=%d — tensor versions '
                'from different published steps served as one '
                'consistent model' % (n, pinned_step, p2['saw_a'],
                                      p2['saw_b']))
        p2['status'] = 'done'

    if cfg.snapshot_order == 'pin_then_read':
        if p['sphase'] == 'pin':
            if _snap_parity(m, writers) % 2:
                if writer_live(m):
                    return []   # a live trainer will close the round
                def give_up(m2, n=n):
                    # crashed-writer-odd-parity: keep the previous
                    # snapshot, end the pull — never block training,
                    # never accept the torn round
                    m2['procs'][n]['status'] = 'done'
                return [(n, 'gives up the pull (trainer died '
                         'mid-round, parity stuck odd); keeps serving '
                         'its previous snapshot', give_up)]
            def pin(m2, n=n):
                p2 = m2['procs'][n]
                p2['pinned_parity'] = _snap_parity(m2, writers)
                p2['pinned_step'] = _snap_floor(m2, writers)
                p2['sphase'] = 'readA'
            return [(n, 'pins parity (even) + published floor', pin)]
        if p['sphase'] == 'readA':
            def read_a(m2, n=n):
                p2 = m2['procs'][n]
                p2['saw_a'] = m2['kv'].get('sv/A', 0)
                p2['lay_a'] = m2['kv'].get('lay/A', 1)
                p2['sphase'] = 'readB'
            return [(n, 'vmget tensor A', read_a)]
        if p['sphase'] == 'readB':
            def read_b(m2, n=n):
                p2 = m2['procs'][n]
                p2['saw_b'] = m2['kv'].get('sv/B', 0)
                p2['lay_b'] = m2['kv'].get('lay/B', 1)
                p2['sphase'] = 'check'
            return [(n, 'vmget tensor B', read_b)]
        # 'check': revalidate the pinned parity
        def check(m2, n=n):
            p2 = m2['procs'][n]
            if _snap_parity(m2, writers) != p2['pinned_parity']:
                p2['sphase'] = 'pin'   # a write landed: retry
                return
            accept(m2, n, p2['pinned_step'])
        return [(n, 'revalidates the parity; accept iff unchanged',
                 check)]

    # read_then_pin: tensors first, one parity/step read after
    if p['sphase'] == 'readA':
        def read_a(m2, n=n):
            p2 = m2['procs'][n]
            p2['saw_a'] = m2['kv'].get('sv/A', 0)
            p2['lay_a'] = m2['kv'].get('lay/A', 1)
            p2['sphase'] = 'readB'
        return [(n, 'vmget tensor A (no pin held)', read_a)]
    if p['sphase'] == 'readB':
        def read_b(m2, n=n):
            p2 = m2['procs'][n]
            p2['saw_b'] = m2['kv'].get('sv/B', 0)
            p2['lay_b'] = m2['kv'].get('lay/B', 1)
            p2['sphase'] = 'pin'
        return [(n, 'vmget tensor B (no pin held)', read_b)]
    # 'pin': one parity/step read stamps the snapshot
    if _snap_parity(m, writers) % 2:
        if not writer_live(m):
            def give_up(m2, n=n):
                m2['procs'][n]['status'] = 'done'
            return [(n, 'gives up the pull (trainer died mid-round)',
                     give_up)]
        def retry(m2, n=n):
            m2['procs'][n]['sphase'] = 'readA'
        return [(n, 'parity odd at stamp time: rereads the tensors',
                 retry)]
    def stamp(m2, n=n):
        accept(m2, n, _snap_floor(m2, writers))
    return [(n, 'parity even at stamp time: accepts the snapshot',
             stamp)]


# -- telemetry cursor ------------------------------------------------------

def _tpusher_transitions(m, cfg, n, p):
    """push_records: the atomic counter bump lands BEFORE the tensor
    write — two transitions, the real race window."""
    if p['tphase'] == 'bump':
        def bump(m2, n=n):
            m2['counters']['tb'] = m2['counters'].get('tb', 0) + 1
            m2['procs'][n]['tphase'] = 'write'
        return [(n, 'push_records: bumps the batch counter (seq %d)'
                 % (p['bseq'] + 1), bump)]

    def write(m2, n=n):
        p2 = m2['procs'][n]
        p2['bseq'] += 1
        m2['kv']['b%d' % p2['bseq']] = 'landed'
        if p2['bseq'] >= p2['batches']:
            p2['status'] = 'done'
        else:
            p2['tphase'] = 'bump'
    return [(n, 'push_records: batch b%d bytes land' % (p['bseq'] + 1),
             write)]


def _collector_transitions(m, cfg, n, p):
    """collect_new_records: read the counter, fetch cursor+1..n; the
    advance rule is configuration. Mid-run polls are budgeted; the
    close-time final sweep is enabled once the pusher is gone (close()
    flushes and collects after joining the push lane)."""
    pushers = [w for w in m['procs']
               if m['procs'][w]['role'] == 'tpusher']
    pusher_live = any(m['procs'][w]['status'] in ('running', 'stalled')
                      for w in pushers)

    def poll(m2, final, n=n):
        p2 = m2['procs'][n]
        cnt = m2['counters'].get('tb', 0)
        consumed = p2['cursor']
        for seq in range(p2['cursor'] + 1, cnt + 1):
            if ('b%d' % seq) in m2['kv']:
                consumed = seq
                m2['kv']['consumed/b%d' % seq] = '1'
            else:
                # counter-bumped but not yet written
                if cfg.cursor_advance == 'decoded_prefix':
                    break   # retry from here next poll
                consumed = seq   # the old rule: skip it forever
        p2['cursor'] = consumed
        if final:
            p2['status'] = 'done'

    ts = []
    if p['polls_left'] > 0:
        def midpoll(m2, n=n):
            m2['procs'][n]['polls_left'] -= 1
            poll(m2, final=False)
        ts.append((n, 'monitor poll (reads counter, fetches new '
                   'batches)', midpoll))
    if not pusher_live:
        def finalpoll(m2, n=n):
            poll(m2, final=True)
        ts.append((n, 'close-time final sweep', finalpoll))
    return ts


def _telemetry_terminal_check(m):
    """The no-permanent-skip invariant: every batch whose bytes landed
    must have been consumed by the final sweep."""
    problems = []
    for k in sorted(m['kv']):
        if k.startswith('b') and not k.startswith('b/') and \
                m['kv'][k] == 'landed' and \
                ('consumed/' + k) not in m['kv']:
            problems.append((
                'cursor-skip',
                'batch %s landed (decodable) but the cursor skipped '
                'it permanently — a poll racing the in-flight push '
                'advanced past the gap and never came back' % k))
    return problems


# -- dispatch + stuck diagnosis -------------------------------------------

_ROLES = {'dwriter': _writer_transitions,
          'mwriter': _malformed_transitions,
          'dreader': _reader_transitions,
          'fencer': _fencer_transitions,
          'pworker': _pipe_transitions,
          'lworker': _lworker_transitions,
          'swriter': _swriter_transitions,
          'sreader': _sreader_transitions,
          'tpusher': _tpusher_transitions,
          'collector': _collector_transitions}


def proc_transitions(m, cfg, n):
    p = m['procs'][n]
    if p['status'] != 'running':
        return []
    return _ROLES[p['role']](m, cfg, n, p)


def describe_stuck(m):
    """Stall diagnosis for data-plane states: name any reader wedged
    on odd parity (the disconnect-wedge symptom) the way the admit-inversion
    diagnosis names the invisible frozen counter."""
    lines = []
    for n in sorted(m['procs']):
        p = m['procs'][n]
        if p['status'] not in ('running', 'stalled'):
            continue
        if p['role'] == 'dreader':
            key = p['tkey']
            owners = sorted(
                k.split('/')[2] for k in m['kv']
                if k.startswith('seq/%s/' % key))
            dead = [w for w in owners
                    if m['procs'][w]['status'] in ('crashed', 'failed')]
            if _t_open(m, key) > 0 and dead:
                lines.append(
                    'reader %s is WEDGED on key %s: version parity is '
                    'stuck odd (open_writes=%d) because writer %s '
                    'died mid-sequence and nothing aborted its open '
                    'chunk sequence — every retry reads odd parity '
                    'until a DELNS' % (n, key, _t_open(m, key),
                                       ','.join(dead)))
                continue
        if p['role'] == 'pworker':
            lines.append(
                'worker %s is blocked at the step-%d gate'
                % (n, p['step']))
            continue
        if p['role'] == 'lworker':
            lines.append(
                'worker %s is blocked at the round-%d gate (floors '
                'are published in sync rounds; a step-scoped gate '
                'target can never be met)' % (n, p['round']))
            continue
        if p['role'] == 'sreader':
            lines.append(
                'serving replica %s is blocked pinning a snapshot: '
                'the snap parity is stuck odd and no give-up '
                'transition fired' % n)
            continue
        lines.append('%s is %s (role %s) with no enabled transition'
                     % (n, p['status'], p['role']))
    return '; '.join(lines) or 'no live process has an enabled ' \
                               'transition'


# -- scenario construction ------------------------------------------------

def _base(procs, crash_budget=0):
    return {'counters': {}, 'kv': {}, 'procs': procs,
            'slot_owner': {}, 'crash_budget': crash_budget,
            'violation': None}


def _writer(n, key, writes=1, sparse=False):
    return {'role': 'dwriter', 'status': 'running', 'tkey': key,
            'wphase': 'w0', 'wseq': 1, 'writes': writes,
            'sparse': sparse, 'fence_key': 'fence/' + n,
            'fence_gen': 0, 'stall_budget': 0}


def _reader(n, key):
    return {'role': 'dreader', 'status': 'running', 'tkey': key,
            'rphase': 'r0', 'ver0': 0, 'saw0': '', 'stall_budget': 0}


def _scenario(name, cfg, model, **kw):
    kw.setdefault('transitions_fn', proc_transitions)
    kw.setdefault('describe_stuck', describe_stuck)
    kw.setdefault('on_crash',
                  lambda m, n: disconnect_abort(m, cfg, n))
    return Scenario(name, cfg, model, **kw)


def torn_write_scenario(cfg):
    """One chunked writer, one malformed writer whose offset-0 frame
    is rejected mid-flight, one versioned reader. The any-frame
    abort must resurface as a torn-read-clean counterexample here."""
    procs = {'A': _writer('A', 'T'),
             'M': {'role': 'mwriter', 'status': 'running', 'tkey': 'T',
                   'stall_budget': 0},
             'R': _reader('R', 'T')}
    return _scenario('torn_write', cfg, _base(procs))


def writer_death_scenario(cfg):
    """A chunked writer that may crash between any two frames (the
    died-mid-push case every failure policy must survive) and a
    versioned reader. The missing disconnect abort must resurface
    as a stall naming the wedged reader."""
    procs = {'A': _writer('A', 'T'), 'R': _reader('R', 'T')}
    return _scenario('writer_death', cfg, _base(procs, crash_budget=1),
                     crashable=('A',))


def zombie_sparse_scenario(cfg):
    """A row-sparse (BSADD) writer stalls mid-sequence, is declared
    dead and fenced by the exclude path, then resumes its in-flight
    final frame. HEAD's under-tensor-lock re-check must reject it
    (and abort the sequence so the reader is not wedged); the
    entry-only check lets the zombie frame commit."""
    procs = {'A': _writer('A', 'T', sparse=True),
             'E': {'role': 'fencer', 'status': 'running', 'target': 'A',
                   'bumped': False, 'stall_budget': 0},
             'R': _reader('R', 'T')}
    return _scenario('zombie_sparse', cfg, _base(procs),
                     stallable=('A',))


def pipeline_scenario(cfg):
    """Two loose-mode workers at pipeline depth 2 training
    ``cfg.steps`` gated steps. The prefetch peer-floor guard and the
    floor-scan position are the configuration under test; the
    invariant is the serial staleness bound."""
    procs = {}
    for n in ('w0', 'w1'):
        procs[n] = {'role': 'pworker', 'status': 'running', 'step': 1,
                    'pphase': 'gate', 'pf_floor': -1, 'pf_seen': (),
                    'stall_budget': 0}
    return _scenario('pipeline', cfg, _base(procs))


def telemetry_scenario(cfg):
    """One span pusher (counter bump and batch write as separate
    transitions, crashable between them) and the monitor's
    incremental-cursor collector with budgeted mid-run polls plus the
    close-time final sweep. The counter-advance rule must
    resurface as a cursor-skip counterexample."""
    procs = {'P': {'role': 'tpusher', 'status': 'running',
                   'tphase': 'bump', 'bseq': 0, 'batches': 2,
                   'stall_budget': 0},
             'C': {'role': 'collector', 'status': 'running',
                   'cursor': 0, 'polls_left': cfg.polls,
                   'stall_budget': 0}}
    return _scenario('telemetry', cfg, _base(procs, crash_budget=1),
                     crashable=('P',),
                     terminal_check=_telemetry_terminal_check)


def local_sgd_scenario(cfg):
    """Two loose-mode workers under local-SGD ``H = cfg.local_steps``
    training ``cfg.steps`` sync rounds. Proves the H-step staleness
    bound (no pull observes peer state older than H x gate_staleness
    train steps) and the window-merge invariant (the PS total is the
    MEAN of the pushed windows); the sum-not-average push and the
    step-scoped gate are the pinned counterexamples."""
    procs = {}
    for n in ('w0', 'w1'):
        procs[n] = {'role': 'lworker', 'status': 'running', 'round': 1,
                    'lphase': 'gate', 'lstep': 0,
                    'h': cfg.local_steps, 'stall_budget': 0}
    return _scenario('local_sgd', cfg, _base(procs),
                     terminal_check=_local_sgd_terminal_check)


def reader_fleet_scenario(cfg):
    """One trainer publishing ``cfg.steps`` seqlock-guarded rounds
    (crashable mid-round — the parity-stuck-odd case) against two
    non-voting serving replicas each pulling one two-tensor snapshot;
    replica R0 is itself crashable (a reader killed mid-pull must be
    harmless). The replica's snapshot ordering is the configuration;
    the invariant is that no ACCEPTED snapshot mixes tensor versions
    from different published steps."""
    procs = {'W': {'role': 'swriter', 'status': 'running', 'round': 1,
                   'sphase': 'open', 'rounds': cfg.steps,
                   'stall_budget': 0}}
    first = ('pin' if cfg.snapshot_order == 'pin_then_read'
             else 'readA')
    for n in ('R0', 'R1'):
        procs[n] = {'role': 'sreader', 'status': 'running',
                    'sphase': first, 'pinned_parity': -1,
                    'pinned_step': -1, 'saw_a': -1, 'saw_b': -1,
                    'stall_budget': 0}
    return _scenario('reader_fleet', cfg, _base(procs, crash_budget=1),
                     crashable=('W', 'R0'))


def reader_fleet_swap_scenario(cfg):
    """The reader fleet across an epoch-swap boundary: one
    trainer publishes a seqlock-guarded round and then APPLIES an
    armed epoch swap — re-keying both tensors under the new plan
    (values moved, layouts changed) — while two serving replicas pull
    snapshots; the trainer may crash mid-swap. ``cfg.swap_parity`` is
    the configuration under test: HEAD's open/close bracket around the
    re-key forces any straddling pull to fail revalidation (or give up
    on a mid-swap death), while the silent re-key lets a replica
    accept a snapshot mixing the two shard layouts. One reader: the
    mixed-layout property is local to a single replica's
    pin -> read -> revalidate cycle (multi-reader independence is
    reader_fleet's job), and the second reader only multiplies the
    interleaving product without new orderings."""
    procs = {'W': {'role': 'swriter', 'status': 'running', 'round': 1,
                   'sphase': 'open', 'rounds': 1, 'swap_pending': True,
                   'stall_budget': 0}}
    first = ('pin' if cfg.snapshot_order == 'pin_then_read'
             else 'readA')
    for n in ('R0',):
        procs[n] = {'role': 'sreader', 'status': 'running',
                    'sphase': first, 'pinned_parity': -1,
                    'pinned_step': -1, 'saw_a': -1, 'saw_b': -1,
                    'stall_budget': 0}
    return _scenario('reader_fleet_swap', cfg,
                     _base(procs, crash_budget=1), crashable=('W',))


def scenarios(cfg):
    """The standard data-plane scenario suite for one configuration."""
    return [torn_write_scenario(cfg), writer_death_scenario(cfg),
            zombie_sparse_scenario(cfg), pipeline_scenario(cfg),
            telemetry_scenario(cfg), local_sgd_scenario(cfg),
            reader_fleet_scenario(cfg),
            reader_fleet_swap_scenario(cfg)]


#: Each seeded pre-fix ordering must yield its counterexample in the
#: named scenario — the sensitivity guard, exactly like the
#: control-plane checker's (DELETE_RELEASE et al.).
SEEDED_BUGS = (
    ('offset-0 abort closes another writer\'s sequence',
     OFFSET0_ABORT_ANY_FRAME, 'torn_write', 'torn-read-clean'),
    ('disconnect leaves the sequence open (reader wedge)',
     NO_DISCONNECT_ABORT, 'writer_death', 'stall'),
    ('cursor advances past an in-flight batch',
     CURSOR_TO_COUNTER, 'telemetry', 'cursor-skip'),
    ('fence checked at wire entry only (zombie frame commits)',
     UNLOCKED_FENCE_RECHECK, 'zombie_sparse', 'zombie-frame-commit'),
    ('prefetch served without the peer-floor discard',
     NO_FLOOR_DISCARD, 'pipeline', 'stale-prefetch'),
    ('peer floor scanned after the pull-ahead it must lower-bound',
     FLOOR_AFTER_PULL, 'pipeline', 'stale-prefetch'),
    ('local-SGD window pushed as SUM not average (W-fold overshoot)',
     LOCAL_SGD_SUM, 'local_sgd', 'window-sum-divergence'),
    ('local-SGD gate target scoped to train steps, not sync rounds',
     LOCAL_SGD_STEP_GATE, 'local_sgd', 'stall'),
    ('snapshot tensors read before the step is pinned (mixed-version '
     'serve)', SNAPSHOT_READ_BEFORE_PIN, 'reader_fleet',
     'mixed-version-snapshot'),
    ('epoch-swap re-key without the snap-parity bracket (straddling '
     'replica accepts mixed shard layouts)', SWAP_SILENT_REKEY,
     'reader_fleet_swap', 'swap-torn-snapshot'),
)

#: Exploration statistics of the last :func:`analyze` run.
LAST_STATS = {}


def analyze():
    """The data-plane analyzer: HEAD explores clean on every scenario
    AND every seeded pre-fix ordering still counterexamples. Returns
    finding strings (empty = clean)."""
    from autodist_tpu_torch.analysis import explore
    LAST_STATS.clear()
    return explore.run_suite(HEAD, scenarios, SEEDED_BUGS,
                             'data-plane model', stats=LAST_STATS)
