"""Epoch-swap trace conformance: replay the flight recorder's
``swap_*`` events through the invariants the epoch-swap model proves.

:mod:`~autodist_tpu_torch.analysis.epoch_swap_model` verifies the ABSTRACT
stage -> ack-quorum -> arm -> boundary-apply ordering (and shows the
tempting shortcuts corrupt state); :mod:`~autodist_tpu_torch.runtime.loose_session`
implements it through the :mod:`~autodist_tpu_torch.runtime.swap_keys`
schema and records every handshake action in the crash flight
recorder (``swap_stage``, ``swap_ack``, ``swap_nack``, ``swap_arm``,
``swap_cancel``, ``swap_apply``). This checker closes the loop the
same way :mod:`~autodist_tpu_torch.analysis.conformance` does for the
control-plane protocol: a recorded trace is ONE interleaving — the
one that happened — and it must satisfy the model's orderings.

Invariants (a flight ring is PER-PROCESS, so each rule is judged only
when the trace itself contains both halves — a peer's ring holds its
ack/apply but not the chief's stage/arm):

- **stage monotonicity** (``swap-gen-regression``) — staged
  generations strictly increase; a re-stage after cancel is a NEW
  generation (exactly-one-visible hygiene).
- **arm follows stage** (``arm-without-stage``) — the chief records
  stage and arm from the same handshake thread, so an armed
  generation with no retained stage on an untruncated ring means the
  implementation armed a plan it never staged.
- **no arm past a rejection** (``arm-after-nack`` /
  ``arm-after-cancel``) — a NACK or cancel ends the generation; an
  arm recorded after either for the same generation is the
  SWAP_BEFORE_ACK_QUORUM ordering the model counterexamples (a
  nacked member would be swapped past).
- **boundary respected** (``apply-before-boundary``) — every
  ``swap_apply`` is self-describing (step + boundary): applying
  before the armed boundary is the NAIVE_BOUNDARY mixed-plan-step.
- **one boundary per generation** (``boundary-mismatch``) — every
  member of a generation must observe the SAME armed boundary; and
  an apply after the generation was cancelled (``apply-after-cancel``)
  means a member committed a plan the chief withdrew.
- **per-worker apply monotonicity** (``apply-regression``) — a
  worker applies generations in increasing order (the session's
  ``_swap_applied_gen`` guard).
- **ack/nack exclusivity** (``ack-nack-conflict``) — one worker gives
  one verdict per generation.

Static-analysis wiring (``python -m autodist_tpu_torch.analysis --swap-conformance``, part
of ``--all``): with no live dump at hand, :func:`analyze` replays a
synthetic verified trace (must be clean), replays seeded bad traces —
trace-level manifestations of the model's two seeded orderings —
which must each produce their finding (the sensitivity guard), and
pins ``swap_keys.MODEL_SYMBOLS`` against the model source: every
abstract symbol the model transitions on must be claimed by exactly
one shipped key template, so renaming either side is a finding, not
silent drift.
"""
import os
import re

_SWAP_KINDS = ('swap_stage', 'swap_ack', 'swap_nack', 'swap_arm',
               'swap_cancel', 'swap_apply')


def _fmt(ev, kind, msg):
    who = ev.get('worker', ev.get('by', '?'))
    return ('swap conformance [%s] at event #%s (%s %s): %s'
            % (kind, ev.get('seq', '?'), ev.get('kind', '?'), who,
               msg))


def check_swap_events(events):
    """Replay one recorded event sequence's ``swap_*`` events; returns
    finding strings (empty = the trace conforms to the epoch-swap
    model's orderings)."""
    findings = []

    def fresh():
        return {'staged': {},      # gen -> seq of swap_stage
                'armed': {},       # gen -> boundary of swap_arm
                'dead': {},        # gen -> seq of nack/cancel
                'verdict': {},     # (gen, worker) -> 'ack'|'nack'
                'applied': {},     # worker -> last applied gen
                'last_stage': 0}
    st = fresh()
    truncated = bool(events) and events[0].get('seq', 1) > 1
    for ev in events:
        kind = ev.get('kind', '')
        if kind == 'run_start':
            # same contract as conformance.check_events: the ring is
            # process-wide; a retained run_start both resets per-run
            # tracking and ends truncation for everything after it
            st = fresh()
            truncated = False
            continue
        if kind not in _SWAP_KINDS:
            continue
        gen = ev.get('gen')
        if not isinstance(gen, int) or gen < 1:
            findings.append(_fmt(
                ev, 'malformed-swap-event',
                "swap event carries no positive integer 'gen' field — "
                'the trace is truncated or was edited; generation '
                'invariants cannot be attributed'))
            continue
        if kind == 'swap_stage':
            if gen <= st['last_stage']:
                findings.append(_fmt(
                    ev, 'swap-gen-regression',
                    'staged generation %d after generation %d — '
                    'generations are monotone (a re-stage after '
                    'cancel is a NEW generation; exactly one staged '
                    'generation is ever visible)'
                    % (gen, st['last_stage'])))
            st['last_stage'] = max(st['last_stage'], gen)
            st['staged'][gen] = ev.get('seq')
            continue
        if kind in ('swap_ack', 'swap_nack'):
            w = ev.get('worker', '?')
            verdict = 'ack' if kind == 'swap_ack' else 'nack'
            prev = st['verdict'].get((gen, w))
            if prev is not None and prev != verdict:
                findings.append(_fmt(
                    ev, 'ack-nack-conflict',
                    'worker %s recorded both an ACK and a NACK for '
                    'generation %d — one worker gives one verdict per '
                    'staged generation' % (w, gen)))
            st['verdict'][(gen, w)] = verdict
            if kind == 'swap_nack':
                st['dead'].setdefault(gen, ev.get('seq'))
            continue
        if kind == 'swap_cancel':
            st['dead'].setdefault(gen, ev.get('seq'))
            continue
        if kind == 'swap_arm':
            if gen in st['dead']:
                reason = 'arm-after-nack' \
                    if any(v == 'nack' and g == gen
                           for (g, _w), v in st['verdict'].items()) \
                    else 'arm-after-cancel'
                findings.append(_fmt(
                    ev, reason,
                    'generation %d was armed AFTER its rejection '
                    '(event #%s) — arming without the full ack quorum '
                    'is the SWAP_BEFORE_ACK_QUORUM ordering: a nacked '
                    'member is swapped past and keeps pushing under '
                    'the old plan (epoch_swap_model mixed-plan-step)'
                    % (gen, st['dead'][gen])))
            elif gen not in st['staged'] and not truncated:
                # absence-based: stage and arm are recorded by the
                # same chief thread, so on an untruncated ring a
                # missing stage is real, not scroll-off
                findings.append(_fmt(
                    ev, 'arm-without-stage',
                    'generation %d was armed but never staged — peers '
                    'cannot have validated a plan that was never '
                    'published' % gen))
            st['armed'][gen] = ev.get('boundary', 0)
            continue
        # swap_apply
        w = ev.get('worker', '?')
        boundary = ev.get('boundary', 0)
        step = ev.get('step', 0)
        if step < boundary:
            findings.append(_fmt(
                ev, 'apply-before-boundary',
                'worker %s applied generation %d at step %d, BEFORE '
                'the armed boundary %d — the NAIVE_BOUNDARY ordering: '
                'a member crossing early executes a step the rest of '
                'the cohort runs under the other plan '
                '(epoch_swap_model mixed-plan-step)'
                % (w, gen, step, boundary)))
        if gen in st['armed'] and boundary != st['armed'][gen]:
            findings.append(_fmt(
                ev, 'boundary-mismatch',
                'worker %s applied generation %d with boundary %d but '
                'the trace armed boundary %d — every member of a '
                'generation must observe ONE boundary'
                % (w, gen, boundary, st['armed'][gen])))
        if gen in st['dead']:
            findings.append(_fmt(
                ev, 'apply-after-cancel',
                'worker %s applied generation %d, which was '
                'nacked/cancelled at event #%s — a cancelled stage '
                'must never commit' % (w, gen, st['dead'][gen])))
        if gen <= st['applied'].get(w, 0):
            findings.append(_fmt(
                ev, 'apply-regression',
                'worker %s applied generation %d after generation %d '
                '— a worker applies generations in increasing order'
                % (w, gen, st['applied'].get(w, 0))))
        st['applied'][w] = max(st['applied'].get(w, 0), gen)
    return findings


def check_dump(path):
    """Load a flight-recorder dump and run the swap checks; returns
    ``(findings, meta)``."""
    from autodist_tpu_torch.telemetry.flight import load_dump
    events, meta = load_dump(path)
    return check_swap_events(events), meta


# -- key-schema pin -------------------------------------------------------

def _model_source():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'epoch_swap_model.py')
    with open(path) as f:
        return f.read()


def check_schema_pin(model_src=None):
    """Pin the shipped key schema against the verified model's symbol
    table: every abstract ``swap/*`` symbol the model's transition
    functions touch must be claimed by exactly one
    ``swap_keys.MODEL_SYMBOLS`` template, and every claimed symbol
    must still exist in the model source — renaming either side is a
    finding, not silent drift. Returns finding strings."""
    from autodist_tpu_torch.runtime import swap_keys
    src = _model_source() if model_src is None else model_src
    # symbols the model actually transitions on: swap/* literals in
    # CODE (strip comments/docstrings so prose can't satisfy the pin)
    code = re.sub(r'""".*?"""', '', src, flags=re.S)
    code = re.sub(r'#[^\n]*', '', code)
    model_syms = set(re.findall(r"'(swap/[A-Za-z+]+)'", code))
    findings = []
    claimed = {}
    for tmpl, sym in swap_keys.MODEL_SYMBOLS.items():
        if sym in claimed:
            findings.append(
                'swap_keys.MODEL_SYMBOLS: templates %s and %s both '
                'claim model symbol %s — the mapping must stay '
                'one-to-one' % (claimed[sym], tmpl, sym))
            continue
        claimed[sym] = tmpl
    for sym in sorted(model_syms - set(claimed)):
        findings.append(
            'epoch_swap_model transitions on symbol %s but no '
            'swap_keys.MODEL_SYMBOLS template claims it — the shipped '
            'key schema no longer covers the verified ordering' % sym)
    for sym in sorted(set(claimed) - model_syms):
        findings.append(
            'swap_keys.MODEL_SYMBOLS claims model symbol %s (template '
            '%s) which epoch_swap_model no longer transitions on — '
            'stale mapping, or the model was renamed without the '
            'schema' % (sym, claimed[sym]))
    return findings


# -- static-analysis entry ------------------------------------------------

def _verified_trace():
    """A synthetic trace of the verified ordering, including a
    NACK -> cancel -> re-stage retry: must replay clean."""
    return [
        {'seq': 1, 'kind': 'run_start'},
        {'seq': 2, 'kind': 'swap_stage', 'gen': 1, 'world': 3},
        {'seq': 3, 'kind': 'swap_nack', 'gen': 1, 'worker': 'p1',
         'reason': 'cannot apply'},
        {'seq': 4, 'kind': 'swap_cancel', 'gen': 1, 'reason': 'nack'},
        {'seq': 5, 'kind': 'swap_stage', 'gen': 2, 'world': 3},
        {'seq': 6, 'kind': 'swap_ack', 'gen': 2, 'worker': 'p1'},
        {'seq': 7, 'kind': 'swap_arm', 'gen': 2, 'boundary': 7,
         'floor': 4},
        {'seq': 8, 'kind': 'swap_apply', 'gen': 2, 'worker': 'p0',
         'boundary': 7, 'step': 7},
        {'seq': 9, 'kind': 'swap_apply', 'gen': 2, 'worker': 'p1',
         'boundary': 7, 'step': 8},
    ]


#: Seeded bad traces — trace-level manifestations of the model's
#: seeded wrong orderings (and the hygiene rules). Each must produce
#: its named finding or the checker has gone blind (the same
#: sensitivity contract as the model checkers' SEEDED_BUGS).
SEEDED_TRACES = (
    ('arm past a NACK (SWAP_BEFORE_ACK_QUORUM)', 'arm-after-nack', [
        {'seq': 1, 'kind': 'run_start'},
        {'seq': 2, 'kind': 'swap_stage', 'gen': 1, 'world': 3},
        {'seq': 3, 'kind': 'swap_nack', 'gen': 1, 'worker': 'p1',
         'reason': 'cannot apply'},
        {'seq': 4, 'kind': 'swap_arm', 'gen': 1, 'boundary': 5,
         'floor': 2},
    ]),
    ('apply before the armed boundary (NAIVE_BOUNDARY)',
     'apply-before-boundary', [
         {'seq': 1, 'kind': 'run_start'},
         {'seq': 2, 'kind': 'swap_stage', 'gen': 1, 'world': 3},
         {'seq': 3, 'kind': 'swap_ack', 'gen': 1, 'worker': 'p1'},
         {'seq': 4, 'kind': 'swap_arm', 'gen': 1, 'boundary': 6,
          'floor': 3},
         {'seq': 5, 'kind': 'swap_apply', 'gen': 1, 'worker': 'p1',
          'boundary': 6, 'step': 5},
     ]),
    ('re-stage without bumping the generation', 'swap-gen-regression', [
        {'seq': 1, 'kind': 'run_start'},
        {'seq': 2, 'kind': 'swap_stage', 'gen': 2, 'world': 3},
        {'seq': 3, 'kind': 'swap_cancel', 'gen': 2,
         'reason': 'ack_timeout'},
        {'seq': 4, 'kind': 'swap_stage', 'gen': 2, 'world': 3},
    ]),
    ('apply of a cancelled generation', 'apply-after-cancel', [
        {'seq': 1, 'kind': 'run_start'},
        {'seq': 2, 'kind': 'swap_stage', 'gen': 1, 'world': 3},
        {'seq': 3, 'kind': 'swap_cancel', 'gen': 1, 'reason': 'nack'},
        {'seq': 4, 'kind': 'swap_apply', 'gen': 1, 'worker': 'p1',
         'boundary': 4, 'step': 4},
    ]),
)


def analyze(paths=None):
    """The static-analysis entry (``python -m autodist_tpu_torch.analysis
    --swap-conformance``, part of ``--all``): the synthetic verified
    trace must replay clean, every seeded bad trace must produce its
    finding, and the shipped key schema must pin to the model's symbol
    table. With ``paths``, additionally replays those dumps (the
    operator CLI path). Returns finding strings (empty = clean)."""
    findings = []
    clean = check_swap_events(_verified_trace())
    findings.extend('verified synthetic trace does not replay clean: '
                    + f for f in clean)
    for label, expect, trace in SEEDED_TRACES:
        got = check_swap_events(trace)
        if not any('[%s]' % expect in f for f in got):
            findings.append(
                'sensitivity guard: seeded trace %r no longer yields '
                'a [%s] finding (got: %s) — the swap-conformance '
                'checker has gone blind to an ordering the model '
                'counterexamples' % (label, expect, got or 'clean'))
    findings.extend(check_schema_pin())
    for path in paths or ():
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
