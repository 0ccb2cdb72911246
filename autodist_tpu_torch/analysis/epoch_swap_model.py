"""Model of the **strategy-distribution epoch** handshake, the port's
ordering of it included.

Cohort-wide lock-step migration needs a control-plane handshake: the
chief stages plan N+1, peers acknowledge, and the whole cohort swaps at
an agreed step boundary, because an executed re-plan that re-keys
shards or moves a variable between PS endpoints corrupts state the
moment ANY member runs a step under the old plan while another runs the
same step under the new one. This module is that handshake's model
(``LooseSession`` implements it through
:mod:`~autodist_tpu_torch.runtime.swap_keys`).

**The verified ordering** (:data:`VERIFIED`, must explore clean):

1. chief STAGES plan N+1 (generation-keyed, visible to peers);
2. peers FETCH + ACK (an ack certifies the peer holds the plan and
   can apply it; a peer that cannot, NACKs);
3. the chief ARMS the swap only once every LIVE peer acked and no
   nack exists (deaths degrade via the existing exclude path: the ack
   quorum is re-evaluated over live membership, exactly like the
   staleness gate's party count), publishing the boundary step
   ``B = prefix_min(published) + staleness + 2`` — beyond the
   furthest step any member can be executing before its next
   boundary check (a member executing step ``s`` implies every
   member published ``>= s - staleness - 1``, the gate invariant the
   control-plane model already proves);
4. every member checks the armed boundary at each step start (a
   counter read that piggybacks on the existing gate RPCs) and
   applies plan N+1 before executing step ``B``;
5. the chief RE-KEYS the variables the new plan moves (reads the old
   keys, writes the new ones) only once every live member has
   published step ``B - 1`` (``LooseSession._await_published``), then
   publishes the ready marker; every other member waits for it before
   its first pull under plan N+1.

**The seeded tempting-but-wrong orderings** (each must
counterexample — the same sensitivity guard as the historical bugs):

- :data:`SWAP_BEFORE_ACK_QUORUM` — the chief arms right after
  staging, without the ack quorum. A peer that nacked (cannot apply
  the plan) is swapped past: it keeps executing under plan N while
  the rest of the cohort crosses the boundary onto N+1 — the
  mixed-plan write the handshake exists to prevent. (The ack is not
  a formality: without it the chief's only alternatives at the
  boundary are corrupting writes or killing a healthy worker.)
- :data:`NAIVE_BOUNDARY` — ``B = chief's own next step``. Under a
  staleness window a peer may run up to two steps AHEAD of the
  chief, so it has already executed step ``B`` under plan N before
  the commit marker even existed.
- :data:`REKEY_AT_ONCE` — the chief re-keys at its own boundary
  check, as the reference package's chief does. A member up to
  ``staleness`` steps behind still pushes a step before ``B`` under
  plan N after the old keys were read: the push lands where nobody
  reads again (``push-on-old-keys``).

What it deliberately does NOT model: the staged plan's payload and
its storage key layout (generation-keyed staging inside the run
namespace; the purge/reuse reasoning follows the durable release
marker's lesson and needs no interleaving exploration), fence
mechanics of the excluded peer's zombie writes (``protocol_model``'s
zombie scenario owns that), and the reshard data movement's values
(``schedule_lint``'s shape algebra owns element preservation).
"""
from dataclasses import dataclass, replace

from autodist_tpu_torch.analysis.protocol_model import Scenario, _set_violation


@dataclass(frozen=True)
class EpochSwapConfig:
    """Orderings under test. Defaults are the VERIFIED contract."""

    #: when the chief may arm the swap: 'ack_quorum' (verified — every
    #: live peer acked, no nack) vs 'immediate' (right after staging).
    arm: str = 'ack_quorum'
    #: how the boundary step is chosen: 'prefix_min' (verified —
    #: prefix_min(published) + staleness + 2) vs 'chief_next' (the
    #: chief's own next step — assumes everyone is at its step).
    boundary: str = 'prefix_min'
    #: when the chief re-keys the variables the new plan moves (reads
    #: the old keys, writes the new ones, publishes the ready marker
    #: the other members wait on before their first new-plan pull):
    #: 'await_published' (verified, ``LooseSession._await_published``:
    #: once every live member has published the step before the
    #: boundary) vs 'immediate' (at the chief's own boundary check, as
    #: the reference package's chief does: a member still finishing an
    #: earlier step pushes onto the old keys after they were read) vs
    #: 'off' (a plan that re-keys nothing: no copy, no marker).
    rekey: str = 'await_published'
    #: training steps per member (small scope).
    steps: int = 3
    #: staleness window of the cohort gate.
    staleness: int = 1


VERIFIED = EpochSwapConfig()
#: Seeded wrong ordering 1: arm without the ack quorum.
SWAP_BEFORE_ACK_QUORUM = replace(VERIFIED, arm='immediate')
#: Seeded wrong ordering 2: boundary = the chief's own next step.
NAIVE_BOUNDARY = replace(VERIFIED, boundary='chief_next')
#: Seeded wrong ordering 3: the chief re-keys at its own boundary check,
#: without waiting for the members' steps before the boundary.
REKEY_AT_ONCE = replace(VERIFIED, rekey='immediate')
#: A swap whose plan re-keys nothing (the handshake alone).
NO_REKEY = replace(VERIFIED, rekey='off')


def _members(m, live_only=True):
    out = []
    for n in sorted(m['procs']):
        p = m['procs'][n]
        if p['role'] not in ('swapchief', 'swappeer'):
            continue
        if live_only and m['counters'].get('excluded/' + n, 0) > 0:
            continue
        out.append(n)
    return out


def _gate_ready(m, cfg, s):
    """The cohort staleness gate over live members' published steps."""
    target = s - cfg.staleness
    if target <= 0:
        return True
    vals = [m['counters'].get('step/' + w, 0) for w in _members(m)]
    return min(vals) >= target


def _train_transitions(m, cfg, n, p):
    """One member's training loop: boundary check -> push -> publish
    -> gate, each its own transition. The boundary check at step start
    is where the swap lands; a push records (step, plan generation)
    and cross-checks every earlier push of the same step."""
    s = p['step']
    if s > cfg.steps:
        def fin(m2, n=n):
            m2['procs'][n]['status'] = 'done'
        return [(n, 'finish (clean close)', fin)]

    if p['tphase'] == 'check':
        def check(m2, n=n):
            p2 = m2['procs'][n]
            b = m2['counters'].get('swap/B', 0)
            p2['tphase'] = 'push'
            if b and p2['step'] >= b and p2['gen'] == 0:
                if p2['can_apply']:
                    p2['gen'] = 1
                    if cfg.rekey != 'off':
                        # the chief re-keys; every other member waits
                        # for its ready marker before the new plan's
                        # first pull
                        p2['tphase'] = 'rekey' if \
                            p2['role'] == 'swapchief' else 'ready'
                # an incompatible (nacked) member swapped PAST has no
                # good move; the naive implementation keeps executing
                # plan N — the push below records the damage
        return [(n, 'step %d start: check the swap boundary' % s,
                 check)]

    if p['tphase'] == 'rekey':
        # the chief's copy of the moved variables from the old keys to
        # the new, then the ready marker
        if cfg.rekey == 'immediate' or all(
                m['counters'].get('step/' + w, 0) >= s - 1
                for w in _members(m)):
            def rekey(m2, n=n):
                m2['kv']['swap/ready'] = '1'
                m2['procs'][n]['tphase'] = 'push'
            return [(n, 're-keys the moved variables (reads the old '
                     'keys, writes the new) and marks the swap ready',
                     rekey)]
        return []   # waits for the members' steps before the boundary

    if p['tphase'] == 'ready':
        if m['kv'].get('swap/ready'):
            def ready(m2, n=n):
                m2['procs'][n]['tphase'] = 'push'
            return [(n, 'sees the swap ready; pulls under plan N+1',
                     ready)]
        return []

    if p['tphase'] == 'push':
        def push(m2, n=n):
            p2 = m2['procs'][n]
            key = 'stepgen/%d' % p2['step']
            gen = 'N+1' if p2['gen'] else 'N'
            prev = m2['kv'].get(key)
            if prev is not None and prev.split(':')[1] != gen:
                _set_violation(
                    m2, 'mixed-plan-step',
                    'step %d was executed under BOTH plan %s (by %s) '
                    'and plan %s (by %s): with re-keyed shards those '
                    'pushes land on different keys and every variable '
                    'the plans disagree on is corrupted'
                    % (p2['step'], prev.split(':')[1],
                       prev.split(':')[0], gen, n))
            elif not p2['gen'] and m2['kv'].get('swap/ready'):
                _set_violation(
                    m2, 'push-on-old-keys',
                    '%s pushed its step-%d deltas under plan N after the '
                    'chief re-keyed the moved variables: the push lands '
                    'on the old keys, which nobody reads again, so the '
                    'update is lost' % (n, p2['step']))
            else:
                m2['kv'][key] = '%s:%s' % (n, gen)
            p2['tphase'] = 'publish'
        return [(n, 'pushes step-%d deltas under plan %s'
                 % (s, 'N+1' if p['gen'] else 'N'), push)]

    if p['tphase'] == 'publish':
        def publish(m2, n=n):
            m2['counters']['step/' + n] = s
            m2['procs'][n]['tphase'] = 'gate'
        return [(n, 'publishes step %d' % s, publish)]

    # gate
    if _gate_ready(m, cfg, s):
        def gate(m2, n=n):
            p2 = m2['procs'][n]
            p2['step'] += 1
            p2['tphase'] = 'check'
        return [(n, 'gate passes (step %d)' % s, gate)]
    return []


def _chief_transitions(m, cfg, n, p):
    """The chief trains like any member; its swap-coordination
    transitions (stage, arm, exclude-a-dead-peer) are enabled
    alongside — the explorer's branching models the real daemon
    thread."""
    ts = _train_transitions(m, cfg, n, p)
    if not m['kv'].get('swap/stage'):
        def stage(m2, n=n):
            m2['kv']['swap/stage'] = '1'
        ts.append((n, 'chief stages plan N+1', stage))
    elif not m['counters'].get('swap/B', 0):
        peers = [w for w in _members(m) if w != n]
        acks = m['counters'].get('swap/acks', 0)
        nacks = m['counters'].get('swap/nacks', 0)
        may_arm = (cfg.arm == 'immediate' or
                   (acks >= len(peers) and nacks == 0))
        if may_arm:
            def arm(m2, n=n):
                if cfg.boundary == 'chief_next':
                    b = m2['procs'][n]['step'] + 1
                else:
                    vals = [m2['counters'].get('step/' + w, 0)
                            for w in _members(m2)]
                    b = min(vals) + cfg.staleness + 2
                m2['counters']['swap/B'] = b
            ts.append((n, 'chief arms the swap (publishes boundary '
                       'step)', arm))
    # deaths degrade via the exclude path (ground-truth detection, as
    # in the control-plane model; the path's own ordering is proved
    # there)
    for w in _members(m):
        if w != n and m['procs'][w]['status'] == 'crashed':
            def exclude(m2, n=n, w=w):
                m2['counters']['excluded/' + w] = 1
            ts.append((n, 'excludes dead peer %s (heartbeat timeout)'
                       % w, exclude))
    return ts


def _peer_transitions(m, cfg, n, p):
    ts = _train_transitions(m, cfg, n, p)
    if m['kv'].get('swap/stage') and not p['acked']:
        if p['can_apply']:
            def ack(m2, n=n):
                m2['counters']['swap/acks'] = \
                    m2['counters'].get('swap/acks', 0) + 1
                m2['procs'][n]['acked'] = True
            ts.append((n, 'fetches plan N+1 and ACKs', ack))
        else:
            def nack(m2, n=n):
                m2['counters']['swap/nacks'] = \
                    m2['counters'].get('swap/nacks', 0) + 1
                m2['procs'][n]['acked'] = True
            ts.append((n, 'NACKs plan N+1 (cannot apply it)', nack))
    return ts


def proc_transitions(m, cfg, n):
    p = m['procs'][n]
    if p['status'] != 'running':
        return []
    if p['role'] == 'swapchief':
        return _chief_transitions(m, cfg, n, p)
    return _peer_transitions(m, cfg, n, p)


def describe_stuck(m):
    lines = []
    for n in sorted(m['procs']):
        p = m['procs'][n]
        if p['status'] not in ('running', 'stalled'):
            continue
        where = {'rekey': 'before its re-key',
                 'ready': 'waiting for the swap\'s ready marker'}.get(
                     p.get('tphase'), 'at the step-%d gate'
                     % p.get('step', 0))
        lines.append('%s is blocked %s (plan %s)'
                     % (n, where, 'N+1' if p.get('gen') else 'N'))
    return '; '.join(lines) or 'no live process has an enabled ' \
                               'transition'


def _terminal_check(m):
    """At rest, every live member must have finished under the SAME
    plan generation — a cohort split across generations is exactly
    the divergence the boundary agreement exists to prevent."""
    gens = {}
    for n in _members(m):
        p = m['procs'][n]
        if p['status'] == 'done':
            gens[n] = 'N+1' if p['gen'] else 'N'
    if len(set(gens.values())) > 1:
        return [('swap-divergence',
                 'the cohort finished split across plan generations: '
                 '%s — members on plan N keep using the old shard '
                 'keys forever' % (', '.join(
                     '%s on %s' % kv for kv in sorted(gens.items()))))]
    return []


def _member(n, role, can_apply=True):
    return {'role': role, 'status': 'running', 'step': 1,
            'tphase': 'check', 'gen': 0, 'can_apply': can_apply,
            'acked': False, 'stall_budget': 0}


def _scenario(name, cfg, procs, **kw):
    model = {'counters': {}, 'kv': {}, 'procs': procs,
             'slot_owner': {}, 'crash_budget': kw.pop('crash_budget', 0),
             'violation': None}
    kw.setdefault('transitions_fn', proc_transitions)
    kw.setdefault('describe_stuck', describe_stuck)
    kw.setdefault('terminal_check', _terminal_check)
    return Scenario(name, cfg, model, **kw)


def swap_scenario(cfg):
    """Chief + a compatible peer that may crash anywhere (deaths
    degrade via the exclude path: the ack quorum and the gate both
    re-evaluate over live membership). The NAIVE_BOUNDARY ordering
    must counterexample here; the verified ordering explores clean.
    Two members keep the space small — the boundary race needs only
    one peer running ahead of the chief, and a second peer multiplies
    states without adding a new interleaving class (the ack quorum is
    a count either way)."""
    procs = {'c': _member('c', 'swapchief'),
             'p1': _member('p1', 'swappeer')}
    return _scenario('epoch_swap', cfg, procs, crash_budget=1,
                     crashable=('p1',))


def swap_nack_scenario(cfg):
    """Chief + a peer that NACKs (cannot apply plan N+1). Verified:
    the chief never arms, everyone finishes on plan N.
    SWAP_BEFORE_ACK_QUORUM must counterexample here (the chief
    crosses the boundary onto N+1 while the swapped-past peer keeps
    pushing N)."""
    procs = {'c': _member('c', 'swapchief'),
             'p2': _member('p2', 'swappeer', can_apply=False)}
    return _scenario('epoch_swap_nack', cfg, procs)


def scenarios(cfg):
    """The epoch-swap scenario suite for one configuration."""
    return [swap_scenario(cfg), swap_nack_scenario(cfg)]


#: The sensitivity guard: each tempting-but-wrong ordering must yield
#: its counterexample in the named scenario.
SEEDED_BUGS = (
    ('swap armed before the ack quorum (nacked peer swapped past)',
     SWAP_BEFORE_ACK_QUORUM, 'epoch_swap_nack', 'mixed-plan-step'),
    ('boundary = chief\'s own next step (peer already past it)',
     NAIVE_BOUNDARY, 'epoch_swap', 'mixed-plan-step'),
    ('re-key at the chief\'s boundary check (a lagging member\'s push '
     'lands on the old keys)', REKEY_AT_ONCE, 'epoch_swap',
     'push-on-old-keys'),
)

#: Exploration statistics of the last :func:`analyze` run.
LAST_STATS = {}


def analyze():
    """The epoch-swap analyzer: the VERIFIED handshake ordering must
    explore clean AND both tempting-but-wrong orderings must still
    counterexample. Returns finding strings (empty = clean)."""
    from autodist_tpu_torch.analysis import explore
    LAST_STATS.clear()
    return explore.run_suite(VERIFIED, scenarios, SEEDED_BUGS,
                             'epoch-swap model', stats=LAST_STATS)
