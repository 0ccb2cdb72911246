"""Post-hoc trace conformance: replay a flight-recorder dump through
the protocol model's invariants.

The control-plane model checker (:mod:`~autodist_tpu_torch.analysis.explore` over
:mod:`~autodist_tpu_torch.analysis.protocol_model`) proves the ABSTRACT
protocol's orderings safe; this module closes the loop with the LIVE
system: the telemetry plane's crash flight recorder
(:mod:`autodist_tpu_torch.telemetry.flight`) captures the control-plane
events a real run actually performed — fence binds, epoch bumps, step
publishes, exclusions, admit phases, replan stage/swap — and this
checker replays that recorded sequence against the same invariants the
model checker enumerates interleavings over:

- **no released-counter resurrection** (``resurrection``) — once a
  worker's step counter is released (exclusion / cap-retire / clean
  close sentinel), no later publish may land it below the sentinel;
  replayed through :func:`protocol_model._check_resurrection` itself.
- **no fenced write commits** (``fenced-write-commit``) — a recorded
  event IS a committed mutation (the session records after the RPC
  returns OK), so a step publish recorded for a worker whose exclusion
  claim precedes it in the trace means a zombie write landed.
- **fence-before-claim** (``unfenced-exclude``) — an exclusion claim
  recorded with no prior fence bump for the same worker is the
  ``UNFENCED_EXCLUDE`` ordering the model counterexamples.
- **no invisible frozen counter** (``admit-inversion``) — an admit's
  step-floor publish recorded BEFORE its membership epoch bump is the
  ``ADMIT_PUBLISH_FIRST`` ordering: a joiner dying in that window
  leaves a frozen counter in the gate's prefix-min no survivor can
  exclude. Likewise every admit-path write must follow the admit's
  fence bind (``unfenced-admit-write``).
- **monotonicity** (``step-regression`` / ``epoch-regression``) — a
  worker's published steps and the membership epoch only move forward.
- **slowdown pairing** (``unmatched-recovery``) — the performance
  sentry's ``recovered`` event clears a prior ``slowdown`` verdict for
  the same worker; a recovery with no preceding slowdown in the trace
  is an inconsistent perf narrative. Absence-based like
  ``unfenced-exclude``: suppressed on truncated rings (the slowdown
  may simply have scrolled off the bound) and re-armed by a retained
  ``run_start``.

A conformant dump returns ``[]``; chaos tests assert real runs produce
conformant traces, and ``python -m autodist_tpu_torch.analysis --conformance <dump>`` is
the operator CLI. What this deliberately does NOT do: re-explore
interleavings (the trace is ONE interleaving — the one that happened)
or validate tensor payloads/liveness (a dump is a bounded window, not
a complete history; events that scrolled off the ring are judged
absent, so ordering rules only fire when BOTH halves are present).
"""
from autodist_tpu_torch.analysis import protocol_model as pm


def _fmt(ev, kind, msg):
    who = ev.get('worker', ev.get('by', '?'))
    return ('trace conformance [%s] at event #%s (%s %s): %s'
            % (kind, ev.get('seq', '?'), ev.get('kind', '?'), who,
               msg))


def check_events(events):
    """Replay one recorded event sequence; returns finding strings
    (empty = the trace conforms to the protocol model)."""
    findings = []
    m = {'counters': {}, 'kv': {}, 'procs': {}, 'slot_owner': {},
         'violation': None}
    fenced = set()        # workers whose generation a fence bump hit
    excluded = {}         # worker -> seq of the exclusion claim
    admit_seen = {}       # worker -> set of admit kinds already seen
    last_step = {}        # worker -> last published step
    slowdown_open = {}    # worker -> seq of the active slowdown verdict
    last_epoch = 0
    # a ring whose first retained event is not seq 1 lost its oldest
    # events to the bound: absence-based rules (fence bump missing
    # before a claim) must not fire — the missing half may simply
    # have scrolled off
    truncated = bool(events) and events[0].get('seq', 1) > 1

    def model_violation(ev):
        if m['violation'] is not None:
            kind, msg = m['violation']
            findings.append(_fmt(ev, kind, msg))
            m['violation'] = None

    needs_worker = ('fence_bump', 'exclude_claim', 'release',
                    'admit_cap_retire', 'admit_claim',
                    'admit_fence_bind', 'admit_epoch_bump',
                    'admit_floor_publish', 'step_publish',
                    'slowdown', 'recovered')
    for ev in events:
        kind = ev.get('kind', '')
        w = ev.get('worker')
        if kind == 'run_start':
            # a new session in the same process: the ring is
            # process-wide, so per-run tracking resets here — run B's
            # step 1 after run A's step N is not a regression. The
            # boundary also ends any truncation: everything after a
            # RETAINED run_start is complete by construction, so
            # absence-based rules re-arm for this run.
            m = {'counters': {}, 'kv': {}, 'procs': {},
                 'slot_owner': {}, 'violation': None}
            fenced = set()
            excluded = {}
            admit_seen = {}
            last_step = {}
            slowdown_open = {}
            last_epoch = 0
            truncated = False
            continue
        if kind in needs_worker and not w:
            # a truncated/hand-edited dump is reported, never a crash
            findings.append(_fmt(
                ev, 'malformed-event',
                "event of kind %r carries no 'worker' field — the "
                'trace is truncated or was edited; ordering '
                'invariants cannot be attributed' % kind))
            continue
        if kind == 'slowdown':
            # the performance sentry opened a verdict; nothing to
            # judge beyond pairing — a slowdown is an observation, not
            # a mutation
            slowdown_open[w] = ev.get('seq')
            continue
        if kind == 'recovered':
            if w not in slowdown_open and not truncated:
                # absence-based, same rule as unfenced-exclude: only
                # judged on an untruncated ring (the opening slowdown
                # may have scrolled off the bound)
                findings.append(_fmt(
                    ev, 'unmatched-recovery',
                    'recovered recorded with no prior slowdown verdict '
                    'for %s — the perf narrative is inconsistent '
                    '(monitor transitions are strictly slowdown -> '
                    'recovered)' % w))
            slowdown_open.pop(w, None)
            continue
        if kind in ('fence_bump', 'admit_fence_bind', 'fence_bind'):
            if kind == 'fence_bump':
                fenced.add(w)
            else:
                admit_seen.setdefault(w, set()).add(kind)
            continue
        if kind == 'exclude_claim':
            if w not in fenced and not truncated:
                # absence-based: only judged on an untruncated ring
                # (a fence bump that scrolled off is not a violation)
                findings.append(_fmt(
                    ev, 'unfenced-exclude',
                    'exclusion claim recorded with no prior fence bump '
                    'for %s — the moment the claim is observable the '
                    "zombie's writes must already be rejected on every "
                    'service (protocol_model UNFENCED_EXCLUDE)' % w))
            excluded.setdefault(w, ev.get('seq'))
            m['counters']['excluded/' + w] = \
                m['counters'].get('excluded/' + w, 0) + 1
            continue
        if kind in ('release', 'admit_cap_retire'):
            m['kv']['released/' + (w or '')] = '1'
            m['counters']['step/' + (w or '')] = pm.SENTINEL
            continue
        if kind in ('epoch_bump', 'epoch_adopt', 'admit_epoch_bump'):
            epoch = ev.get('epoch', 0)
            if epoch < last_epoch:
                findings.append(_fmt(
                    ev, 'epoch-regression',
                    'membership epoch moved backwards (%d after %d) — '
                    'the epoch counter is monotone by construction'
                    % (epoch, last_epoch)))
            last_epoch = max(last_epoch, epoch)
            if kind == 'admit_epoch_bump':
                seen = admit_seen.setdefault(w, set())
                if 'admit_fence_bind' not in seen and \
                        'admit_claim' in seen:
                    findings.append(_fmt(
                        ev, 'unfenced-admit-write',
                        'admit epoch bump recorded before the fence '
                        'bind for %s — every admit-path write must '
                        'already be fenceable' % w))
                seen.add(kind)
            continue
        if kind == 'admit_claim':
            admit_seen.setdefault(w, set()).add(kind)
            continue
        if kind == 'admit_floor_publish':
            seen = admit_seen.setdefault(w, set())
            # anchored on the claim: with the claim in-window, the
            # whole admit tail is in-window too, so a missing epoch
            # bump before this publish is a real inversion, not ring
            # truncation
            if 'admit_epoch_bump' not in seen and \
                    ('admit_claim' in seen or not truncated):
                findings.append(_fmt(
                    ev, 'admit-inversion',
                    'adopted step floor published BEFORE the '
                    'membership epoch bump for %s — violates "no '
                    'invisible frozen counter": a joiner dying in this '
                    'window leaves a step counter inside the gate\'s '
                    'prefix-min that no survivor\'s membership view '
                    'contains, a permanent cohort stall '
                    '(protocol_model ADMIT_PUBLISH_FIRST)' % w))
            if 'admit_fence_bind' not in seen and 'admit_claim' in seen:
                findings.append(_fmt(
                    ev, 'unfenced-admit-write',
                    'admit floor publish recorded before the fence '
                    'bind for %s' % w))
            seen.add(kind)
            # the floor publish is a step publish; fall through to the
            # model's counter semantics below
            step = ev.get('floor', 0)
            m['counters']['step/' + w] = max(
                m['counters'].get('step/' + w, 0), step)
            pm._check_resurrection(m, 'step/' + w)
            model_violation(ev)
            last_step[w] = max(last_step.get(w, 0), step)
            continue
        if kind == 'step_publish':
            step = ev.get('step', 0)
            if w in excluded and step < pm.SENTINEL:
                findings.append(_fmt(
                    ev, 'fenced-write-commit',
                    'step publish for %s recorded AFTER its exclusion '
                    'claim (event #%s) — a recorded event is a '
                    'committed mutation, so a zombie write landed '
                    'past its fence (protocol_model '
                    'fenced-write-commit)' % (w, excluded[w])))
            if step < last_step.get(w, 0) and step < pm.SENTINEL:
                findings.append(_fmt(
                    ev, 'step-regression',
                    'published step moved backwards for %s (%d after '
                    '%d) — step counters are monotone under publishes'
                    % (w, step, last_step.get(w, 0))))
            # replay into the model's counter state so the RELEASED
            # check is literally protocol_model's: a recorded publish
            # is a committed mutation, so when the trace claims a
            # below-sentinel publish for a released worker, the model
            # state takes that value and the model's own invariant
            # (_check_resurrection) judges it
            cur = m['counters'].get('step/' + w, 0)
            if m['kv'].get('released/' + w) and step < pm.SENTINEL:
                m['counters']['step/' + w] = step
            else:
                m['counters']['step/' + w] = max(cur, step)
            pm._check_resurrection(m, 'step/' + w)
            model_violation(ev)
            last_step[w] = max(last_step.get(w, 0), step)
            continue
        # every other kind (launch/autoscale/replan/close/heartbeat
        # bookkeeping) carries no ordering invariant here
    return findings


def check_dump(path):
    """Load a flight-recorder dump and check it; returns
    ``(findings, meta)``. Delegates the ``swap_*`` event kinds to
    :mod:`~autodist_tpu_torch.analysis.swap_conformance` so one dump replay
    covers both the control-plane protocol and the epoch-swap
    handshake."""
    from autodist_tpu_torch.analysis import swap_conformance
    from autodist_tpu_torch.telemetry.flight import load_dump
    events, meta = load_dump(path)
    findings = check_events(events)
    findings.extend(swap_conformance.check_swap_events(events))
    return findings, meta


def analyze(paths):
    """The CLI entry (``python -m autodist_tpu_torch.analysis --conformance <dump>...``):
    finding strings across every dump, each prefixed with its file."""
    findings = []
    for path in paths:
        try:
            fs, meta = check_dump(path)
        except (OSError, ValueError) as e:
            findings.append('%s: unreadable flight-recorder dump '
                            '(%s: %s)' % (path, type(e).__name__, e))
            continue
        ctx = meta.get('context', {})
        findings.extend('%s [%s/%s]: %s'
                        % (path, ctx.get('ns', '?'),
                           ctx.get('worker', '?'), f) for f in fs)
    return findings
