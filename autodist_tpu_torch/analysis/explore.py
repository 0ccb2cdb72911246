"""Bounded exhaustive exploration of the protocol model.

Breadth-first enumeration of EVERY interleaving of the scenario's
process transitions, plus explorer-injected crashes (budgeted) and
stall/resume pairs, with state memoization. Two property classes:

- **safety**: a transition that sets ``model['violation']``
  (fenced-write-commit, resurrection — see
  :mod:`~autodist_tpu_torch.analysis.protocol_model`) terminates its branch
  and is reported with the exact event path that reached it;
- **liveness**: after the full reachable graph is built, a backward
  reachability pass from the good terminal states (every process done/
  crashed/failed, scenario terminal invariants clean) finds states
  from which NO good terminal is reachable — a stall. The shortest
  path to one is reported with a diagnosis of what is wedged,
  including any invisible frozen counter in the gate's prefix-min.

Counterexamples print as readable event sequences
(:func:`format_violation`), which is how the two seeded historical
bugs surface in ``tests/test_torch_analysis.py``.
"""
from collections import deque
from dataclasses import dataclass, field

from autodist_tpu_torch.analysis import protocol_model as pm


@dataclass
class Violation:
    kind: str
    trace: tuple          # ((actor, label), ...)
    diagnosis: str


@dataclass
class Result:
    scenario: str
    ok: bool
    violations: list = field(default_factory=list)
    states: int = 0
    terminals: int = 0

    def kinds(self):
        return sorted({v.kind for v in self.violations})


def _copy(m):
    return {'counters': dict(m['counters']), 'kv': dict(m['kv']),
            'procs': {n: dict(p) for n, p in m['procs'].items()},
            'slot_owner': dict(m['slot_owner']),
            'crash_budget': m['crash_budget'],
            'violation': m['violation']}


def _freeze(m):
    return (tuple(sorted(m['counters'].items())),
            tuple(sorted(m['kv'].items())),
            tuple(sorted((n, tuple(sorted(p.items())))
                         for n, p in m['procs'].items())),
            tuple(sorted(m['slot_owner'].items())),
            m['crash_budget'], m['violation'])


def _transitions(m, sc):
    ts = []
    for n in sorted(m['procs']):
        p = m['procs'][n]
        if p['status'] == 'running':
            ts.extend(sc.transitions_fn(m, sc.cfg, n))
        elif p['status'] == 'stalled':
            def resume(m2, n=n):
                m2['procs'][n]['status'] = 'running'
            ts.append((n, 'resumes (was stalled)', resume))
    if m['crash_budget'] > 0:
        for n in sc.crashable:
            if m['procs'][n]['status'] in ('running', 'stalled'):
                def crash(m2, n=n):
                    m2['procs'][n]['status'] = 'crashed'
                    m2['crash_budget'] -= 1
                    # model-specific death side effects (e.g. the
                    # service's disconnect-time SeqAborter: a dead
                    # connection's open chunk sequences are aborted)
                    if sc.on_crash is not None:
                        sc.on_crash(m2, n)
                ts.append((n, 'CRASHES', crash))
    for n in sc.stallable:
        p = m['procs'][n]
        if p['status'] == 'running' and p.get('stall_budget', 0) == 0:
            def stall(m2, n=n):
                m2['procs'][n]['status'] = 'stalled'
                m2['procs'][n]['stall_budget'] = 1
            ts.append((n, 'stalls (slow past the heartbeat timeout)',
                       stall))
    return ts


def _terminal_good(m):
    return all(p['status'] in ('done', 'crashed', 'failed')
               for p in m['procs'].values())


def _path(parents, key):
    events = []
    while parents[key] is not None:
        key, actor, label = parents[key]
        events.append((actor, label))
    events.reverse()
    return tuple(events)


def _describe_stuck(m):
    lines = []
    for n in sorted(m['procs']):
        p = m['procs'][n]
        if p['status'] not in ('running', 'stalled'):
            continue
        if p['role'] == 'worker' and p['phase'] == 'gate':
            steps = {k[len('step/'):]: v
                     for k, v in m['counters'].items()
                     if k.startswith('step/')}
            k = p['world_seen'] - len(p['excluded'])
            lines.append(
                '%s is blocked at the step-%d gate: needs >= %d step '
                'counters with min >= %d, plane has %s'
                % (n, p['step'], k, p['step'], steps))
        else:
            lines.append('%s is %s (role %s) with no enabled '
                         'transition' % (n, p['status'], p['role']))
    live_views = [p for p in m['procs'].values()
                  if p['status'] in ('running', 'stalled')
                  and p['role'] == 'worker']
    for key, v in sorted(m['counters'].items()):
        if not key.startswith('step/') or v >= pm.SENTINEL:
            continue
        w = key[len('step/'):]
        owner = m['slot_owner'].get(w)
        status = m['procs'][owner]['status'] if owner else 'unknown'
        if status not in ('crashed', 'failed'):
            continue
        visible = any(int(w[1:]) < p['world_seen'] for p in live_views)
        if not visible:
            lines.append(
                '%s=%d belongs to %s %s, which is in NO survivor\'s '
                'membership view (the epoch was never bumped for it): '
                'an invisible frozen counter in the gate\'s prefix-min '
                'that no exclusion can ever release' % (key, v, status,
                                                        owner or w))
    return '; '.join(lines) or 'no live process has an enabled ' \
                               'transition'


def explore(sc, max_states=500000):
    """Exhaustively explore ``sc`` and return a :class:`Result`."""
    init = _copy(sc.model)
    k0 = _freeze(init)
    states = {k0: init}
    parents = {k0: None}
    edges = {}
    queue = deque([k0])
    violations = {}
    terminal_good = []
    terminal_bad = []   # terminal, but a terminal invariant failed
    violated = []       # branch ended in a mid-run violation
    dead_ends = []
    while queue:
        k = queue.popleft()
        m = states[k]
        if m['violation'] is not None:
            kind, msg = m['violation']
            if kind not in violations:
                violations[kind] = Violation(kind, _path(parents, k),
                                             msg)
            violated.append(k)
            edges[k] = []
            continue
        ts = _transitions(m, sc)
        if not ts:
            edges[k] = []
            if _terminal_good(m):
                ok = True
                for kind, msg in (sc.terminal_check(m)
                                  if sc.terminal_check else []):
                    ok = False
                    if kind not in violations:
                        violations[kind] = Violation(
                            kind, _path(parents, k), msg)
                if ok:
                    terminal_good.append(k)
                else:
                    terminal_bad.append(k)
            else:
                dead_ends.append(k)
            continue
        outs = []
        for actor, label, fn in ts:
            m2 = _copy(m)
            fn(m2)
            k2 = _freeze(m2)
            if k2 not in states:
                states[k2] = m2
                parents[k2] = (k, actor, label)
                queue.append(k2)
            outs.append(k2)
        edges[k] = outs
        if len(states) > max_states:
            raise RuntimeError(
                'scenario %r exceeded %d states — the model must stay '
                'small-scope' % (sc.name, max_states))
    # liveness: backward reachability over terminals. Bad terminals
    # and mid-run violation states (both reported above) seed it too —
    # a branch that ended in a reported counterexample is not ALSO a
    # stall, and must not produce a second counterexample with a
    # misleading diagnosis.
    if 'stall' not in violations:
        rev = {}
        for src, outs in edges.items():
            for dst in outs:
                rev.setdefault(dst, []).append(src)
        coreach = set(terminal_good) | set(terminal_bad) | \
            set(violated)
        bq = deque(coreach)
        while bq:
            k = bq.popleft()
            for src in rev.get(k, []):
                if src not in coreach:
                    coreach.add(src)
                    bq.append(src)
        stuck = [k for k in dead_ends if k not in coreach] or \
                [k for k in states
                 if k not in coreach and states[k]['violation'] is None]
        if stuck:
            # BFS insertion order makes parents-paths shortest; take
            # the earliest-discovered stuck state for the tightest trace
            k = min(stuck, key=lambda k: len(_path(parents, k)))
            describe = sc.describe_stuck or _describe_stuck
            violations['stall'] = Violation(
                'stall', _path(parents, k),
                'no good terminal state is reachable from here: ' +
                describe(states[k]))
    vs = sorted(violations.values(), key=lambda v: v.kind)
    return Result(scenario=sc.name, ok=not vs, violations=vs,
                  states=len(states), terminals=len(terminal_good))


def check_all(cfg, max_states=500000):
    """Explore the standard scenario suite under ``cfg``."""
    return [explore(sc, max_states=max_states)
            for sc in pm.scenarios(cfg)]


def format_violation(result, v):
    """A counterexample as a readable numbered event sequence."""
    lines = ['counterexample [%s] in scenario %r:' % (v.kind,
                                                      result.scenario)]
    for i, (actor, label) in enumerate(v.trace, 1):
        lines.append('  %2d. %-4s %s' % (i, actor + ':', label))
    lines.append('  => ' + v.diagnosis)
    return '\n'.join(lines)


#: The negative self-tests: each seeded pre-fix ordering must yield a
#: counterexample in the named scenario with the named violation kind.
#: If the model ever stops re-deriving a historical bug, it has lost
#: the sensitivity that justifies trusting its clean HEAD run.
SEEDED_BUGS = (
    ('delete-release resurrection', pm.DELETE_RELEASE,
     'exclude', 'resurrection'),
    ('admit publish-before-epoch inversion',
     pm.ADMIT_PUBLISH_FIRST, 'admit', 'stall'),
    ('unfenced exclude (claim observable before fence)',
     pm.UNFENCED_EXCLUDE, 'zombie', 'fenced-write-commit'),
    ('cap-raced join slot abandoned un-retired',
     pm.UNRETIRED_CAP_RACE, 'cap_race', 'cap-slot-unretired'),
)


#: Exploration statistics of the last :func:`analyze` run (or any
#: model-checker pass using :func:`run_suite`): per-scenario and total
#: states explored, so ``python -m autodist_tpu_torch.analysis --json`` can report model
#: cost and ``bench_compare`` can flag state-space blowup.
LAST_STATS = {}


def run_suite(head_cfg, scenarios_fn, seeded, label, stats=None,
              max_states=500000):
    """The shared both-directions analyzer every model checker runs:
    the HEAD configuration must explore clean across the whole
    scenario suite, AND every seeded pre-fix ordering must still
    produce its counterexample (the sensitivity guard). ``seeded`` is
    an iterable of ``(name, cfg, scenario_name, violation_kind)``.
    Fills ``stats`` (a dict) with per-scenario/total states explored.
    Returns finding strings (empty = clean)."""
    findings = []
    per_scenario = {}
    for sc in scenarios_fn(head_cfg):
        result = explore(sc, max_states=max_states)
        per_scenario[sc.name] = result.states
        for v in result.violations:
            findings.append(
                '%s: HEAD ordering has a counterexample (%s)\n%s'
                % (label, v.kind, format_violation(result, v)))
    for name, cfg, scen_name, kind in seeded:
        sc = {s.name: s for s in scenarios_fn(cfg)}[scen_name]
        result = explore(sc, max_states=max_states)
        # unique stats key per seeded exploration: two seeds sharing a
        # scenario+kind (e.g. both pipeline floor bugs) must both show
        # up, or a state-space blowup in the second is invisible to
        # the bench_compare gate these counts feed
        key = '%s[%s]' % (scen_name, kind)
        while key in per_scenario:
            key += "'"
        per_scenario[key] = result.states
        if kind not in result.kinds():
            findings.append(
                '%s: seeded bug %r no longer yields a %r '
                'counterexample in scenario %r (found: %s) — the model '
                'lost the sensitivity that justifies its clean HEAD '
                'run' % (label, name, kind, scen_name,
                         result.kinds() or 'none'))
    if stats is not None:
        stats['scenarios'] = per_scenario
        stats['states_explored'] = sum(per_scenario.values())
    return findings


def analyze():
    """The protocol-model analyzer: HEAD's orderings must explore clean
    across the whole scenario suite, AND every seeded pre-fix ordering
    must still produce its counterexample. Returns finding strings
    (empty = clean)."""
    LAST_STATS.clear()
    return run_suite(pm.HEAD, pm.scenarios, SEEDED_BUGS,
                     'protocol model', stats=LAST_STATS)
