"""Executable small-scope model of the control-plane protocol.

The costliest bugs in this system have been distributed-protocol
ORDERING races: the deleted-step-key resurrection (releasing a dead
worker's step counter by DELETE let any later delta-0 ``INCR`` read
recreate it at 0 and wedge every survivor's MINWAIT) and the
admit inversion (publishing the adopted step floor BEFORE
the membership epoch bump left a mid-admit corpse's counter invisibly
frozen inside the gate's prefix-min, a permanent cohort stall). Both
were found by hand or by chaos flakes; this module catches the
bug CLASS statically, in tier-1, by modeling the protocol small-scope
(2-3 workers, 2 steps, one crash) and letting
:mod:`~autodist_tpu_torch.analysis.explore` enumerate every interleaving.

The model covers exactly the cross-process control-plane state the
native ``coord_service`` holds and the orderings
``runtime/loose_session.py`` performs against it:

- counters with the service's real ``INCR`` semantics — including the
  load-bearing quirk that a delta-0 read CREATES a missing counter at 0
  (C++ ``map::operator[]``), the resurrection vector;
- per-connection writer fencing (``FENCE`` bind, mutation rejection
  once the fence counter passes the bound generation);
- ``publish_step`` as its real TWO RPCs — the delta-0 read and the
  relative-delta bump are separate transitions for every worker/joiner
  self-publish, so interleavings and crashes inside the publish window
  are explored (the exclusion RELEASE keeps both halves in one
  transition; :func:`svc_publish` documents why that is sound) — and
  the MINWAIT gate (>=k step counters under the prefix AND their
  min >= target);
- the exclude path (fence-everywhere -> atomic claim -> release ->
  epoch bump) with the release mode configurable
  (``sentinel``/HEAD vs ``delete``/the old release);
- the admit handshake (slot claim -> cap re-check -> fence bind ->
  floor scan -> epoch bump + floor publish) with the bump/publish
  order configurable (``epoch_first``/HEAD vs ``publish_first``/the
  pre-fix inversion) and the cap-race retirement togglable;
- membership visibility semantics: a survivor only refreshes its
  world/excluded view when it observes an epoch change, exactly like
  ``Session._check_peers_alive``.

What it deliberately does NOT model: tensor payloads, heartbeat
counters (ground-truth process status stands in for the
eventually-firing timeout — sound, because a crashed process's beat
counter never advances again), barriers, the purge/close protocol, and
real time. See ``docs/design/static-analysis.md`` for the extension
contract when a new protocol message is added.

Invariants (checked by :mod:`~autodist_tpu_torch.analysis.explore`):

- **no fenced write commits** — once a fence-bound writer's exclusion
  claim is observable, none of its mutations may commit;
- **no deleted-counter resurrection** — a released worker's step
  counter must never be observed below the release sentinel again;
- **no invisible frozen counter** — from every reachable state, every
  live process can still finish (gate liveness); a stuck state's
  diagnosis names any step counter frozen in the prefix-min that no
  survivor's membership view contains;
- **cap-raced claims are retired** — a join claim that raced past
  ``AUTODIST_MAX_WORKERS`` ends excluded + sentinel-released, and live
  membership never exceeds the cap at rest.
"""
from dataclasses import dataclass, replace

#: The clean-close / exclusion release sentinel (coord_client
#: CLEAN_CLOSE_STEP): a published step at/above it is a RELEASE, not
#: training progress.
SENTINEL = 1 << 30


@dataclass(frozen=True)
class ProtocolConfig:
    """Orderings under test. The defaults are HEAD's (must explore
    clean); each historical bug is one field flipped back."""

    #: exclude-path release of the dead worker's step counter:
    #: 'sentinel' (HEAD) publishes CLEAN_CLOSE_STEP; 'delete' (the
    #: old ordering) erases the key.
    release: str = 'sentinel'
    #: admit handshake tail: 'epoch_first' (HEAD) bumps the membership
    #: epoch before publishing the adopted floor; 'publish_first' is
    #: the inversion that was fixed.
    admit_order: str = 'epoch_first'
    #: the exclude path's step order. HEAD fences the zombie on every
    #: service BEFORE the claim becomes observable.
    exclude_order: tuple = ('fence', 'claim', 'release', 'epoch')
    #: whether a join claim that raced past the cap retires its slot
    #: (excluded marker + sentinel release) before refusing.
    retire_on_cap_race: bool = True
    #: training steps per worker (small scope).
    steps: int = 2
    #: staleness window of the MINWAIT gate.
    staleness: int = 0
    #: AUTODIST_MAX_WORKERS for the cap-race scenario.
    max_workers: int = 3


HEAD = ProtocolConfig()
#: Historical bug: exclusion released the dead step key by
#: DELETE; any later delta-0 INCR read resurrects it at 0.
DELETE_RELEASE = replace(HEAD, release='delete')
#: Historical bug: the admit handshake published the adopted
#: floor before the epoch bump.
ADMIT_PUBLISH_FIRST = replace(HEAD, admit_order='publish_first')
#: Extra seeded orderings (not historical, but the same class): the
#: exclusion claim observable before the zombie is fenced...
UNFENCED_EXCLUDE = replace(HEAD,
                           exclude_order=('claim', 'fence', 'release',
                                          'epoch'))
#: ...and a cap-raced join slot abandoned instead of retired.
UNRETIRED_CAP_RACE = replace(HEAD, retire_on_cap_race=False)


class Scenario:
    """One bounded system to explore: an initial model state plus the
    crash/stall choices the explorer may inject and an optional
    ``terminal_check(model) -> [(kind, msg)]`` terminal invariant.

    The explorer (:mod:`~autodist_tpu_torch.analysis.explore`) is model-
    agnostic as long as the state dict keeps the shared shape
    (``counters``/``kv``/``procs``/``slot_owner``/``crash_budget``/
    ``violation`` with hashable values); which model a scenario speaks
    is carried by three hooks:

    - ``transitions_fn(model, cfg, proc) -> [(actor, label, fn)]`` —
      the per-process transition generator (defaults to this module's
      :func:`proc_transitions`);
    - ``on_crash(model, proc)`` — side effects of an injected crash
      beyond ``status='crashed'`` (the data-plane model uses it for
      the service's disconnect-time ``SeqAborter``);
    - ``describe_stuck(model) -> str`` — the stall diagnosis (defaults
      to the control-plane one, which names invisible frozen step
      counters in the gate prefix-min).
    """

    def __init__(self, name, cfg, model, crashable=(), stallable=(),
                 terminal_check=None, transitions_fn=None,
                 on_crash=None, describe_stuck=None):
        self.name = name
        self.cfg = cfg
        self.model = model
        self.crashable = tuple(crashable)
        self.stallable = tuple(stallable)
        self.terminal_check = terminal_check
        self.transitions_fn = transitions_fn or proc_transitions
        self.on_crash = on_crash
        self.describe_stuck = describe_stuck


# -- service semantics ----------------------------------------------------

def _set_violation(m, kind, msg):
    if m['violation'] is None:
        m['violation'] = (kind, msg)


def _check_resurrection(m, key):
    """A released worker's step counter observed below the sentinel is
    the resurrection bug re-derived."""
    w = key[len('step/'):]
    if m['kv'].get('released/' + w) and m['counters'][key] < SENTINEL:
        _set_violation(
            m, 'resurrection',
            'released step counter %s recreated at %d (< sentinel): a '
            'delta-0 INCR read resurrected the deleted key — every '
            "survivor's MINWAIT prefix-min is now wedged at it"
            % (key, m['counters'][key]))


def _mutate_ok(m, proc):
    """The service's fence check for one mutating frame by ``proc``,
    plus the fenced-write-commit invariant: a fence-BOUND writer whose
    exclusion claim is already observable must never commit."""
    p = m['procs'][proc]
    fk = p.get('fence_key')
    if fk and m['counters'].get(fk, 0) > p.get('fence_gen', 0):
        # ERR fenced; the session surfaces FencedWriteError and dies
        p['status'] = 'failed'
        return False
    wkey = p.get('wkey')
    if fk and wkey and m['counters'].get('excluded/' + wkey, 0) > 0:
        _set_violation(
            m, 'fenced-write-commit',
            'a mutation by %s COMMITTED after its exclusion claim was '
            'observable — the exclude path must fence the zombie on '
            'every service before the claim lands' % proc)
    return True


def svc_incr(m, proc, key, delta):
    """INCR: atomic add, fence-checked only when delta != 0 — and the
    delta-0 read CREATES a missing counter at 0, exactly like the
    service's ``map::operator[]``. Returns the value, or None on ERR
    fenced."""
    if delta and not _mutate_ok(m, proc):
        return None
    v = m['counters'].get(key, 0) + delta
    m['counters'][key] = v
    if key.startswith('step/'):
        _check_resurrection(m, key)
    return v


def svc_delete(m, proc, key):
    """DEL (fence-checked like every mutation)."""
    if not _mutate_ok(m, proc):
        return False
    m['counters'].pop(key, None)
    return True


def svc_step_read(m, proc, wkey):
    """The read half of ``publish_step``: a delta-0 INCR — creates a
    missing counter at 0."""
    return svc_incr(m, proc, 'step/' + wkey, 0)


def svc_step_bump(m, proc, wkey, target, cur):
    """The bump half of ``publish_step``: a RELATIVE-delta INCR
    computed from the earlier read (``incr(key, target - cur)``), so a
    concurrent write landing between the two RPCs composes additively
    — exactly the service's semantics."""
    if target <= cur:
        return True
    return svc_incr(m, proc, 'step/' + wkey, target - cur) is not None


def svc_publish(m, proc, wkey, step):
    """``publish_step`` as ONE transition (both RPCs). Used only for
    the exclusion/retirement RELEASE, whose writers are not crashable
    in any scenario; keeping it atomic is sound for the sentinel
    because step counters are monotone under publishes, so the
    relative bump ``cur' + (SENTINEL - cur)`` with ``cur' >= cur``
    never lands below the sentinel. Worker/joiner self-publishes go
    through the split :func:`svc_step_read`/:func:`svc_step_bump`
    transitions instead, so the intra-publish window IS explored."""
    cur = svc_step_read(m, proc, wkey)
    if cur is None:
        return False
    return svc_step_bump(m, proc, wkey, step, cur)


def gate_ready(m, p, target):
    """MINWAIT over the step/ prefix: >= k counters AND min >= target,
    with k = the party count from THIS process's membership view
    (world_seen minus its excluded set), like the session's callable
    ``num_workers``."""
    k = p['world_seen'] - len(p['excluded'])
    steps = [v for key, v in m['counters'].items()
             if key.startswith('step/')]
    return len(steps) >= k and (min(steps) if steps else 0) >= target


def _refresh(m, p):
    """Session._refresh_membership: adopt the plane's world + excluded
    set (only ever called after observing an epoch change)."""
    p['epoch_seen'] = m['counters'].get('epoch', 0)
    p['world_seen'] = max(p['world_seen'],
                          m['counters'].get('join/world', 0))
    p['excluded'] = tuple(sorted(
        'p%d' % i for i in range(p['world_seen'])
        if m['counters'].get('excluded/p%d' % i, 0) > 0))


def _detectable_dead(m, p):
    """Members of THIS process's view whose ground-truth process is
    crashed/stalled/failed — the abstraction of 'heartbeat stalled past
    the timeout' (a dead process's beat counter never advances again,
    so the timeout eventually fires; a stalled one may be declared dead
    falsely, which is exactly the zombie case fencing must survive)."""
    out = []
    for i in range(p['world_seen']):
        w = 'p%d' % i
        if w == p.get('wkey') or w in p['excluded']:
            continue
        owner = m['slot_owner'].get(w)
        if owner is None:
            continue
        if m['procs'][owner]['status'] in ('crashed', 'stalled',
                                           'failed'):
            out.append(w)
    return out


# -- process roles --------------------------------------------------------

def _worker_transitions(m, cfg, n, p):
    ts = []
    if p['mode'] == 'excl':
        w = p['excl_target']
        stepname = cfg.exclude_order[p['excl_i']]

        def excl(m2, stepname=stepname, w=w, n=n):
            p2 = m2['procs'][n]
            if stepname == 'fence':
                svc_incr(m2, n, 'fence/' + w, 1)
            elif stepname == 'claim':
                v = svc_incr(m2, n, 'excluded/' + w, 1)
                p2['excl_won'] = (v == 1)
            elif stepname == 'release':
                if p2['excl_won']:
                    if cfg.release == 'delete':
                        svc_delete(m2, n, 'step/' + w)
                    else:
                        svc_publish(m2, n, w, SENTINEL)
                    m2['kv']['released/' + w] = '1'
            elif stepname == 'epoch':
                if p2['excl_won']:
                    svc_incr(m2, n, 'epoch', 1)
                _refresh(m2, p2)
            if p2['status'] == 'running':
                p2['excl_i'] += 1
                if p2['excl_i'] >= len(cfg.exclude_order):
                    p2['mode'] = 'run'
                    p2['excl_i'] = 0

        ts.append((n, 'exclude[%s] %s' % (stepname, w), excl))
        return ts

    if p['step'] > cfg.steps:
        def finish(m2, n=n):
            m2['procs'][n]['status'] = 'done'
        ts.append((n, 'finish (clean close)', finish))
        return ts

    if p['phase'] == 'push':
        def push(m2, n=n):
            p2 = m2['procs'][n]
            if svc_incr(m2, n, 'data/shared', 1) is not None:
                p2['phase'] = 'publish'
        ts.append((n, 'push delta (step %d)' % p['step'], push))
        return ts

    if p['phase'] == 'publish':
        def pub_read(m2, n=n):
            p2 = m2['procs'][n]
            p2['pub_cur'] = svc_step_read(m2, n, p2['wkey'])
            p2['phase'] = 'publish2'
        ts.append((n, 'publish step %d: read own counter (delta-0 '
                   'INCR)' % p['step'], pub_read))
        return ts

    if p['phase'] == 'publish2':
        def pub_bump(m2, n=n):
            p2 = m2['procs'][n]
            if svc_step_bump(m2, n, p2['wkey'], p2['step'],
                             p2['pub_cur']):
                p2['phase'] = 'gate'
        ts.append((n, 'publish step %d: bump (relative INCR)'
                   % p['step'], pub_bump))
        return ts

    # phase == 'gate': pass when MINWAIT is satisfied; otherwise the
    # failure-check alternatives (adopt an epoch change; declare a dead
    # member and enter the exclude path) are the only way forward —
    # exactly the staleness_gate slice loop.
    target = p['step'] - cfg.staleness
    if target <= 0 or gate_ready(m, p, target):
        def gate_pass(m2, n=n):
            p2 = m2['procs'][n]
            p2['step'] += 1
            p2['phase'] = 'push' if p2['pusher'] else 'publish'
        ts.append((n, 'gate passes (step %d)' % p['step'], gate_pass))
    if m['counters'].get('epoch', 0) != p['epoch_seen']:
        def adopt(m2, n=n):
            _refresh(m2, m2['procs'][n])
        ts.append((n, 'adopt epoch change (refresh membership)', adopt))
    if p['excluder']:
        for w in _detectable_dead(m, p):
            def declare(m2, n=n, w=w):
                p2 = m2['procs'][n]
                p2['mode'] = 'excl'
                p2['excl_i'] = 0
                p2['excl_target'] = w
                p2['excl_won'] = False
            ts.append((n, 'declare %s dead (heartbeat timeout)' % w,
                       declare))
    return ts


def _joiner_transitions(m, cfg, n, p):
    jpc = p['jpc']
    if jpc == 0:
        def precheck(m2, n=n):
            p2 = m2['procs'][n]
            world = m2['counters'].get('join/world', 0)
            excl = sum(1 for i in range(world)
                       if m2['counters'].get('excluded/p%d' % i, 0) > 0)
            if world - excl >= cfg.max_workers:
                p2['status'] = 'failed'   # refused before any claim
                p2['refused'] = 'precheck'
            else:
                p2['jpc'] = 1
        return [(n, 'admit: pre-check live membership vs cap',
                 precheck)]
    if jpc == 1:
        def claim(m2, n=n):
            p2 = m2['procs'][n]
            world = svc_incr(m2, n, 'join/world', 1)
            p2['ordinal'] = world - 1
            p2['wkey'] = 'p%d' % p2['ordinal']
            m2['slot_owner'][p2['wkey']] = n
            p2['jpc'] = 2
        return [(n, 'admit: claim slot (INCR join/world)', claim)]
    if jpc == 2:
        def postcheck(m2, n=n):
            p2 = m2['procs'][n]
            world = m2['counters'].get('join/world', 0)
            excl = sum(1 for i in range(world)
                       if m2['counters'].get('excluded/p%d' % i, 0) > 0)
            if world - excl > cfg.max_workers:
                p2['refused'] = 'raced'
                if cfg.retire_on_cap_race:
                    p2['jpc'] = 20
                else:
                    p2['status'] = 'failed'   # slot abandoned un-retired
            else:
                p2['jpc'] = 3
        return [(n, 'admit: re-check cap after claim', postcheck)]
    if jpc == 20:
        def retire_mark(m2, n=n):
            p2 = m2['procs'][n]
            svc_incr(m2, n, 'excluded/' + p2['wkey'], 1)
            p2['jpc'] = 21
        return [(n, 'admit: retire raced slot (excluded marker)',
                 retire_mark)]
    if jpc == 21:
        def retire_release(m2, n=n):
            p2 = m2['procs'][n]
            svc_publish(m2, n, p2['wkey'], SENTINEL)
            m2['kv']['released/' + p2['wkey']] = '1'
            p2['status'] = 'failed'
        return [(n, 'admit: retire raced slot (sentinel release)',
                 retire_release)]
    if jpc == 3:
        def gen_read(m2, n=n):
            p2 = m2['procs'][n]
            p2['fence_gen'] = svc_incr(m2, n, 'fence/' + p2['wkey'],
                                       0)
            p2['jpc'] = 30
        return [(n, 'admit: read own fence generation', gen_read)]
    if jpc == 30:
        # the two-RPC bind window: a fence bump landing between the
        # generation read and the FENCE bind is rejected at bind time
        def bind(m2, n=n):
            p2 = m2['procs'][n]
            key = 'fence/' + p2['wkey']
            if m2['counters'].get(key, 0) > p2['fence_gen']:
                p2['status'] = 'failed'   # superseded before binding
                return
            p2['fence_key'] = key
            p2['jpc'] = 4
        return [(n, 'admit: bind fence generation', bind)]
    if jpc == 4:
        if p['scan_i'] < p['ordinal']:
            def floor_read(m2, n=n):
                p2 = m2['procs'][n]
                # the delta-0 INCR read — creates missing counters
                step = svc_incr(m2, n, 'step/p%d' % p2['scan_i'], 0)
                if step != 0 and step < SENTINEL and \
                        (p2['floor'] == 0 or step < p2['floor']):
                    p2['floor'] = step
                p2['scan_i'] += 1
            return [(n, "admit: scan step/p%d for the floor "
                     '(delta-0 INCR)' % p['scan_i'], floor_read)]
        def scan_done(m2, n=n):
            m2['procs'][n]['jpc'] = 5
        return [(n, 'admit: adopt step floor', scan_done)]
    tail = (('epoch', 'pub_read', 'pub_bump')
            if cfg.admit_order == 'epoch_first'
            else ('pub_read', 'pub_bump', 'epoch'))
    if jpc in (5, 6, 7):
        stepname = tail[jpc - 5]

        def admit_tail(m2, stepname=stepname, n=n):
            p2 = m2['procs'][n]
            if stepname == 'epoch':
                if svc_incr(m2, n, 'epoch', 1) is None:
                    return
                _refresh(m2, p2)
            elif stepname == 'pub_read':
                p2['pub_cur'] = svc_step_read(m2, n, p2['wkey'])
            else:
                if not svc_step_bump(m2, n, p2['wkey'], p2['floor'],
                                     p2['pub_cur']):
                    return
            p2['jpc'] += 1
            if p2['jpc'] == 8:
                p2['pub'] = p2['floor']
        label = {'epoch': 'admit: bump membership epoch',
                 'pub_read': 'admit: publish adopted step floor '
                             '(read half)',
                 'pub_bump': 'admit: publish adopted step floor'}[
                     stepname]
        return [(n, label, admit_tail)]
    # admitted: train (publish only — enough to un-block cohort
    # gates), through the same split read/bump publish
    if p['pub'] < cfg.steps:
        if p['train_phase'] == 'read':
            def train_read(m2, n=n):
                p2 = m2['procs'][n]
                p2['pub_cur'] = svc_step_read(m2, n, p2['wkey'])
                p2['train_phase'] = 'bump'
            return [(n, 'publish step %d (post-admit): read'
                     % (p['pub'] + 1), train_read)]

        def train_bump(m2, n=n):
            p2 = m2['procs'][n]
            if svc_step_bump(m2, n, p2['wkey'], p2['pub'] + 1,
                             p2['pub_cur']):
                p2['pub'] += 1
                p2['train_phase'] = 'read'
        return [(n, 'publish step %d (post-admit): bump'
                 % (p['pub'] + 1), train_bump)]

    def jdone(m2, n=n):
        m2['procs'][n]['status'] = 'done'
    return [(n, 'finish (clean close)', jdone)]


def _monitor_transitions(m, cfg, n, p):
    targets = p['targets'].split(',')
    if p['mpc'] >= len(targets):
        def mdone(m2, n=n):
            m2['procs'][n]['status'] = 'done'
        return [(n, 'monitor done', mdone)]
    w = targets[p['mpc']]

    def poll(m2, n=n, w=w):
        # external monitors and the admit floor scan both read step
        # counters through the delta-0 INCR idiom — THE read that
        # resurrects a deleted key
        svc_incr(m2, n, 'step/' + w, 0)
        m2['procs'][n]['mpc'] += 1
    return [(n, 'monitor polls step/%s (delta-0 INCR)' % w, poll)]


def proc_transitions(m, cfg, n):
    p = m['procs'][n]
    if p['status'] != 'running':
        return []
    role = p['role']
    if role == 'worker':
        return _worker_transitions(m, cfg, n, p)
    if role == 'joiner':
        return _joiner_transitions(m, cfg, n, p)
    return _monitor_transitions(m, cfg, n, p)


# -- scenario construction ------------------------------------------------

def _worker(n, world, pusher=False, excluder=True):
    return {'role': 'worker', 'status': 'running', 'step': 1,
            'phase': 'push' if pusher else 'publish', 'mode': 'run',
            'excl_i': 0, 'excl_target': '', 'excl_won': False,
            'pub_cur': 0, 'epoch_seen': 0, 'world_seen': world,
            'excluded': (), 'fence_key': 'fence/' + n, 'fence_gen': 0,
            'wkey': n, 'pusher': pusher, 'excluder': excluder,
            'stall_budget': 0}


def _joiner(n):
    return {'role': 'joiner', 'status': 'running', 'jpc': 0,
            'ordinal': -1, 'wkey': '', 'floor': 0, 'scan_i': 0,
            'pub': 0, 'pub_cur': 0, 'train_phase': 'read',
            'refused': '', 'fence_key': '', 'fence_gen': 0,
            'epoch_seen': 0, 'world_seen': 0, 'excluded': (),
            'stall_budget': 0}


def _monitor(n, targets):
    return {'role': 'monitor', 'status': 'running', 'mpc': 0,
            'targets': ','.join(targets), 'stall_budget': 0}


def _base_model(procs, world, crash_budget=0):
    return {'counters': {'join/world': world, 'epoch': 0},
            'kv': {'init-done': '1'},
            'procs': procs,
            'slot_owner': {n: n for n, p in procs.items()
                           if p['role'] == 'worker'},
            'crash_budget': crash_budget,
            'violation': None}


def exclude_scenario(cfg):
    """Three launch workers; one may crash at any point; the survivors
    run the exclude path; an external monitor polls step counters
    (delta-0 INCR) at arbitrary interleavings. The delete-release
    must resurface as a resurrection counterexample here."""
    procs = {'p0': _worker('p0', 3), 'p1': _worker('p1', 3),
             'p2': _worker('p2', 3, excluder=False),
             'mon': _monitor('mon', ('p0', 'p1', 'p2'))}
    return Scenario('exclude', cfg, _base_model(procs, 3,
                                                crash_budget=1),
                    crashable=('p2',))


def admit_scenario(cfg):
    """Two launch workers training through gates; one joiner runs the
    admit handshake and may crash between ANY two of its steps. The
    publish-before-epoch inversion must resurface as a stall (the
    invisible frozen counter) here."""
    procs = {'p0': _worker('p0', 2), 'p1': _worker('p1', 2),
             'j': _joiner('j')}
    return Scenario('admit', cfg, _base_model(procs, 2,
                                              crash_budget=1),
                    crashable=('j',))


def zombie_scenario(cfg):
    """A worker stalls mid-step, gets declared dead and excluded, then
    resumes and tries to keep writing. With HEAD's fence-before-claim
    order every resumed write is rejected; the flipped order lets one
    commit after the exclusion is observable."""
    procs = {'p0': _worker('p0', 2),
             'p1': _worker('p1', 2, pusher=True, excluder=False)}
    return Scenario('zombie', cfg, _base_model(procs, 2),
                    stallable=('p1',))


def _cap_terminal_check(m, max_workers):
    problems = []
    world = m['counters'].get('join/world', 0)
    excl = sum(1 for i in range(world)
               if m['counters'].get('excluded/p%d' % i, 0) > 0)
    if world - excl > max_workers:
        problems.append((
            'cap-exceeded',
            'live membership %d exceeds AUTODIST_MAX_WORKERS=%d at '
            'rest' % (world - excl, max_workers)))
    for n, p in m['procs'].items():
        if p['role'] != 'joiner' or p.get('refused') != 'raced':
            continue
        w = p['wkey']
        if m['counters'].get('excluded/' + w, 0) <= 0 or \
                m['counters'].get('step/' + w, 0) < SENTINEL:
            problems.append((
                'cap-slot-unretired',
                'join claim %s raced past the cap but was not retired '
                '(excluded marker + sentinel release): survivors must '
                'pay a heartbeat window to skip it' % w))
    return problems


def cap_race_scenario(cfg):
    """Two concurrent joiners race one slot of cap headroom: both pass
    the pre-check, both claim, the loser must retire its slot."""
    procs = {'p0': _worker('p0', 2), 'p1': _worker('p1', 2),
             'j2': _joiner('j2'), 'j3': _joiner('j3')}
    # the launch cohort is already done training: the scenario isolates
    # the claim race (workers keep their published step on the plane)
    for n in ('p0', 'p1'):
        procs[n]['status'] = 'done'
    model = _base_model(procs, 2)
    model['counters']['step/p0'] = cfg.steps
    model['counters']['step/p1'] = cfg.steps
    return Scenario(
        'cap_race', cfg, model,
        terminal_check=lambda m: _cap_terminal_check(m,
                                                     cfg.max_workers))


def scenarios(cfg):
    """The standard scenario suite for one configuration."""
    return [exclude_scenario(cfg), admit_scenario(cfg),
            zombie_scenario(cfg), cap_race_scenario(cfg)]
