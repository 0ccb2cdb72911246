"""Schedule/plan consistency lint — shape algebra over the IR.

The simulator prices the collective schedule
``static_collective_schedule`` derives WITHOUT running a step; the
runtime emits the schedule ``ExecutionPlan.sync_gradients`` derives AS
the step runs (the "traced" side below, over ``torch.distributed``).
Both derive from the SAME program (``schedule_ir.bucket_program``
builds it, ``schedule_entry`` projects the static entry, ``execute``
drives the emission over the plan's group), so predicted == emitted is
structural and the per-predicate AST cross-checks collapse into two
much stronger checks:

- **IR shape algebra, run ONCE** (:func:`check_ir_algebra`): every
  dimension combination the emitters can produce — flat vs two-level,
  the int8 tier boundary, ZeRO scatter/gather halves, weight-update
  sharding, sparse rows — is built through the shared lowering over
  dividing, non-dividing and padded sizes and verified by
  :func:`schedule_ir.verify`: groups partition the mesh, chunks tile
  their spans, byte flow conserves across requantize boundaries, and
  the final per-device partition matches the declared goal. A seeded
  WRONG schedule (the int8 boundary requantize moved inside the ICI
  phase) must still produce its finding — the same sensitivity guard
  the model checkers carry (``analysis/explore.py`` SEEDED_BUGS): an
  algebra that stops flagging the counterexample fails here, not
  silently.
- **a thin routes-through-the-IR drift check**
  (:func:`check_emission_predicates`): both emitters must fuse through
  the shared ``bucket_fusable`` / ``bucket_fusion_key`` predicates with
  identical call shapes, pack via ``pack_buckets`` in the same
  reverse-production order, lower through ``bucket_program`` +
  ``schedule_entry``, and the traced side must EXECUTE through
  ``schedule_ir.execute`` (an emission helper hand-rolling a collective
  again would bypass everything the algebra proves). The shared
  flat-vs-two-level (``choose_hierarchical``) and update-sharding
  (``choose_update_sharding``) decisions must still be consulted on
  both sides with the same call shape.

Also here:

- **pricing parity** (:func:`check_pricing_parity`):
  ``cost_model.program_time`` over the lowered IR must agree with the
  closed-form ``entry_time`` on the legacy shapes — the bridge that
  lets synthesis rank hand-written and synthesized programs on one
  scale;
- **reshard shape algebra** — ``reshard.plan_reshard`` layout moves
  are verified over a synthetic geometry sweep (every src/dst layout
  pair across dividing, non-dividing and padded shapes): op-kind
  preconditions, destination-shard partition exactness, zero-wire
  claims, AND each op's own IR program (``ReshardOp.ir_program``)
  verifies clean through the same algebra the gradient schedules use;
- the absorbed ``tools/check_wire_pricing.py`` drift check (compressor
  registry vs ``cost_model._WIRE_ITEMSIZE``).
"""
import ast
import os
import re

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PLAN_SRC = os.path.join(REPO, 'autodist_tpu_torch', 'parallel', 'plan.py')

# -- IR shape algebra (the ONE verification pass) -------------------------

#: (kind, compressor, hier, wus) dimension combinations the emitters
#: can produce — the five legacy schedule dimensions as IR lowerings.
_IR_COMBOS = tuple(
    [(kind, cname, hier, False)
     for kind in ('all_reduce', 'psum_scatter', 'all_gather')
     for cname in (None, 'HorovodCompressor', 'Int8RingCompressor')
     for hier in (0, 2, 4)] +
    [(kind, cname, hier, True)                 # weight-update sharding
     for kind in ('psum_scatter', 'all_gather')
     for cname in (None, 'Int8RingCompressor')
     for hier in (0, 2)] +
    [(kind, None, 0, False)                    # sparse rows
     for kind in ('sparse_all_gather', 'sparse_scatter')])

#: raw byte sizes: dividing (1024 f32 elems over 8 devices),
#: non-dividing (1000 elems -> internal padding), and prime-odd.
_IR_SIZES = (4096, 4000, 1972)


def check_ir_algebra(n=8):
    """Build every emitter-reachable dimension combination through the
    shared lowering and run the shape algebra on it. Any finding means
    an emitter change produced a schedule that loses, duplicates or
    mis-wires elements — caught structurally, regardless of fixture
    coverage."""
    from autodist_tpu_torch.parallel import schedule_ir as sir
    findings = []
    for kind, cname, hier, wus in _IR_COMBOS:
        for nbytes in _IR_SIZES:
            try:
                prog = sir.bucket_program(
                    kind, nbytes, 'float32', cname, 'AUTO', n,
                    hier=hier, wus=wus)
            except ValueError as err:
                findings.append(
                    'schedule-ir lowering (%s, %s, hier=%d, wus=%s, '
                    '%dB) refused to build: %s'
                    % (kind, cname, hier, wus, nbytes, err))
                continue
            for f in sir.verify(prog):
                findings.append('%s [from (%s, %s, hier=%d, wus=%s, '
                                '%dB)]' % (f, kind, cname, hier, wus,
                                           nbytes))
    findings.extend(check_ir_sensitivity(n))
    return findings


def seeded_counterexample(n=8):
    """A deliberately WRONG schedule: the int8 tier-boundary program
    with its down-requantize moved INSIDE the ICI phase — the
    reduce-scatter then declares an f32 wire while the live buffer is
    already i8, exactly the mis-placed boundary the byte-flow /
    wire-state rules exist to catch."""
    from autodist_tpu_torch.parallel import schedule_ir as sir
    prog = sir.bucket_program('all_reduce', 1 << 16, 'float32',
                              'Int8RingCompressor', 'AUTO', n, hier=2)
    steps = list(prog.steps)
    for i, s in enumerate(steps):
        if s.op == 'requantize' and s.wire == 'i8' and i > 0:
            steps[i - 1], steps[i] = steps[i], steps[i - 1]
            break
    return sir.Program(prog.name + '/seeded-bad', prog.n, prog.elems,
                       prog.dtype, tuple(steps), prog.init, prog.goal,
                       dict(prog.meta))


def check_ir_sensitivity(n=8):
    """The sensitivity guard: the seeded wrong schedule must still be
    flagged, or the algebra's clean HEAD run proves nothing."""
    from autodist_tpu_torch.parallel import schedule_ir as sir
    bad = seeded_counterexample(n)
    if not sir.verify(bad):
        return ['schedule-ir sensitivity guard: the seeded wrong '
                'schedule (int8 requantize inside the ICI phase) '
                'verifies CLEAN — the algebra lost the sensitivity '
                'that justifies trusting its clean HEAD run']
    return []


# -- thin routes-through-the-IR drift check -------------------------------

def _functions(tree):
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = node
    return out


def _calls_of(fn, src, callee):
    """(positional arg count, sorted kwarg names) per call of
    ``callee`` inside ``fn``."""
    out = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        name = f.attr if isinstance(f, ast.Attribute) else \
            getattr(f, 'id', '')
        if name == callee:
            out.append((len(node.args),
                        tuple(sorted(k.arg for k in node.keywords
                                     if k.arg))))
    return out


def _sort_key(fn, src):
    """The canonical source of the ``pending.sort(key=...)`` lambda —
    the reverse-production emission order both sides must share."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == 'sort':
            for kw in node.keywords:
                if kw.arg == 'key':
                    return re.sub(
                        r'\s+', '',
                        ast.get_source_segment(src, kw.value) or '')
    return None


#: traced-emission helpers that must EXECUTE through the IR — a helper
#: dispatching a collective without ``schedule_ir.execute`` bypasses
#: the algebra, the pricing bridge and the entry-id join at once.
_TRACED_EXECUTORS = ('_reduce_fn', '_capped_psum_scatter',
                     '_int8_bucket_reduce', '_wus_scatter_bucket',
                     'gather_updated_params')


def check_emission_predicates(src=None):
    """Cross-check that sync_gradients and static_collective_schedule
    both route through the ONE shared IR lowering (and the shared
    fusion / hierarchy / update-sharding decisions)."""
    if src is None:
        with open(PLAN_SRC) as f:
            src = f.read()
    findings = []
    fns = _functions(ast.parse(src))
    traced = fns.get('sync_gradients')
    static = fns.get('static_collective_schedule')
    hier = fns.get('_hier_groups_for')
    if traced is None or static is None:
        return ['plan.py: sync_gradients/static_collective_schedule '
                'not found — update analysis/schedule_lint.py for the '
                'new layout']
    # the shared fusion predicates: both sides must consult the same
    # bucket_fusable / bucket_fusion_key with the same call shape
    for callee, what in (('bucket_fusable', 'fusable predicate'),
                         ('bucket_fusion_key', 'fusion key')):
        tc = _calls_of(traced, src, callee)
        sc = _calls_of(static, src, callee)
        if not tc or not sc:
            findings.append(
                'plan.py: the bucket %s must route through the ONE '
                'shared %s on both sides (traced call missing: %s, '
                'static call missing: %s) — an inline predicate '
                'reintroduces exactly the per-side drift the IR '
                'refactor removed' % (what, callee, not tc, not sc))
        elif set(tc) != set(sc):
            findings.append(
                'plan.py: %s call shapes DRIFTED — traced %s vs '
                'static %s: the simulator would price buckets the '
                'runtime never emits' % (callee, tc, sc))
    # the shared lowering: both sides must build programs via
    # bucket_program and project entries via schedule_entry
    for name, fn in (('sync_gradients', traced),
                     ('static_collective_schedule', static)):
        for callee in ('pack_buckets', 'bucket_program',
                       'schedule_entry'):
            if not _calls_of(fn, src, callee):
                findings.append(
                    'plan.py: %s no longer routes through %s — the '
                    'two emission paths must derive from the SAME IR '
                    'program' % (name, callee))
    # the traced side must EXECUTE through the IR interpreter
    for helper in _TRACED_EXECUTORS:
        fn = fns.get(helper)
        if fn is None:
            findings.append(
                'plan.py: traced emission helper %s missing — the '
                'schedule the simulator prices no longer exists'
                % helper)
        elif not _calls_of(fn, src, 'execute'):
            findings.append(
                'plan.py: %s no longer executes through '
                'schedule_ir.execute — a hand-rolled collective '
                'bypasses the verified lowering' % helper)
    if not _calls_of(traced, src, '_wus_scatter_bucket'):
        findings.append(
            'plan.py: sync_gradients no longer dispatches '
            'update-sharded buckets through _wus_scatter_bucket')
    # shared flat-vs-two-level decision
    traced_hier = _calls_of(hier, src, 'choose_hierarchical') \
        if hier is not None else []
    static_hier = _calls_of(static, src, 'choose_hierarchical')
    if not traced_hier or not static_hier:
        findings.append(
            'plan.py: the flat-vs-hierarchical decision must route '
            'through the ONE shared cost_model.choose_hierarchical on '
            'both sides (traced call missing: %s, static call missing: '
            '%s)' % (not traced_hier, not static_hier))
    elif set(traced_hier) != set(static_hier):
        findings.append(
            'plan.py: choose_hierarchical call shapes DRIFTED — traced '
            '%s vs static %s (same positional arity + kwargs required, '
            'or the two sides price different decisions)'
            % (traced_hier, static_hier))
    # shared update-sharding decision; an emission that never CONSULTS
    # the helper decides nothing
    wus_helper = fns.get('_wus_for')
    traced_wus = _calls_of(wus_helper, src, 'choose_update_sharding') \
        if wus_helper is not None else []
    if not _calls_of(traced, src, '_wus_for'):
        traced_wus = []
    static_wus = _calls_of(static, src, 'choose_update_sharding')
    if not traced_wus or not static_wus:
        findings.append(
            'plan.py: the replicated-vs-sharded weight-update decision '
            'must route through the ONE shared '
            'cost_model.choose_update_sharding on both sides (traced '
            'call missing: %s, static call missing: %s)'
            % (not traced_wus, not static_wus))
    elif set(traced_wus) != set(static_wus):
        findings.append(
            'plan.py: choose_update_sharding call shapes DRIFTED — '
            'traced %s vs static %s (same positional arity + kwargs '
            'required, or the slot placement, traced emission and '
            'priced schedule decide differently)'
            % (traced_wus, static_wus))
    # the static update-shard pair must survive as IR lowerings
    static_src = re.sub(r'\s+', '',
                        ast.get_source_segment(src, static) or '')
    for token, what in (
            ("('psum_scatter','grad')", 'grad-phase reduce-scatter'),
            ("('all_gather','param')", 'param-phase all-gather'),
            ('wus=True', 'wus tag')):
        if token not in static_src:
            findings.append(
                'plan.py: static_collective_schedule no longer emits '
                'the update-shard %s entry (%s) — the simulator would '
                'price a schedule without the update-sharding halves'
                % (what, token))
    tso, sso = _sort_key(traced, src), _sort_key(static, src)
    if tso != sso:
        findings.append(
            'plan.py: bucket emission order DRIFTED — sync_gradients '
            'sorts by %r, static_collective_schedule by %r' % (tso,
                                                               sso))
    return findings


# -- pricing parity: program_time over the IR == entry_time ---------------

def check_pricing_parity(n=8, nodes=2):
    """``cost_model.program_time`` over the lowered IR must agree with
    the closed-form ``entry_time`` on every legacy shape — the scale
    synthesis ranks hand-written and synthesized candidates on."""
    from autodist_tpu_torch.parallel import schedule_ir as sir
    from autodist_tpu_torch.simulator import cost_model
    params = cost_model.CostModelParams()
    findings = []
    shapes = [('all_reduce', None, 0), ('all_reduce', None, nodes),
              ('all_reduce', 'HorovodCompressor', 0),
              ('all_reduce', 'Int8RingCompressor', 0),
              ('all_reduce', 'Int8RingCompressor', nodes),
              ('psum_scatter', None, 0), ('psum_scatter', None, nodes),
              ('all_gather', None, 0), ('all_gather', None, nodes),
              ('sparse_all_gather', None, 0)]
    for kind, cname, hier in shapes:
        nbytes = 1 << 16
        entry = {'kind': kind, 'bytes': nbytes, 'dtype': 'float32',
                 'compressor': cname, 'spec': 'AUTO', 'vars': 1,
                 'hier': hier, 'members': ['v']}
        want, _ = cost_model.entry_time(entry, n, params,
                                        cross_node=True)
        prog = sir.bucket_program(kind, nbytes, 'float32', cname,
                                  'AUTO', n, hier=hier)
        got = cost_model.program_time(prog, params)
        tol = max(1e-12, 1e-6 * abs(want))
        if abs(got - want) > tol:
            findings.append(
                'pricing parity DRIFTED for (%s, %s, hier=%d): '
                'program_time %.6g s vs entry_time %.6g s — synthesis '
                'would rank hand-written schedules on a different '
                'scale than the simulator prices them'
                % (kind, cname, hier, got, want))
    return findings


# -- reshard shape algebra ------------------------------------------------

def _layouts_for(shape, n):
    """Every layout an ExecutionPlan can place a var of ``shape`` in on
    an ``n``-way data axis, with the plan's padding rule."""
    outs = [{'sharded': False, 'axis': None, 'padded_dim': None,
             'pad': 0}]
    for axis, dim in enumerate(shape):
        if dim < n:
            continue   # the plan only shards axes >= n
        padded = -(-dim // n) * n
        outs.append({'sharded': True, 'axis': axis,
                     'padded_dim': padded, 'pad': padded - dim})
    return outs


def _holdings(layout, shape, n, d):
    """The logical flat-index set device ``d`` holds under ``layout``
    (pad rows excluded)."""
    import numpy as np
    idx = np.arange(int(np.prod(shape))).reshape(shape)
    if not layout['sharded']:
        return set(idx.ravel().tolist())
    ax, dim = layout['axis'], shape[layout['axis']]
    rows = layout['padded_dim'] // n
    lo, hi = d * rows, min((d + 1) * rows, dim)
    if lo >= dim:
        return set()
    sl = [slice(None)] * len(shape)
    sl[ax] = slice(lo, hi)
    return set(idx[tuple(sl)].ravel().tolist())


def _mock_plan(shape, layout, n):
    from types import SimpleNamespace
    import numpy as np
    var = SimpleNamespace(shape=tuple(shape), dtype=np.float32)
    vp = SimpleNamespace(var=var, state_sharded=layout['sharded'],
                         shard_axis=layout['axis'] or 0,
                         padded_dim=layout['padded_dim'],
                         pad=layout['pad'])
    return SimpleNamespace(var_plans={'v': vp}, num_replicas=n,
                           cost_params=None)


def check_reshard_algebra():
    """Element-preservation + op-kind preconditions over the sweep,
    with every planned op ALSO verified through its own IR program —
    reshard and gradient sync now answer to the same algebra."""
    from autodist_tpu_torch.parallel import reshard
    from autodist_tpu_torch.parallel import schedule_ir as sir
    from autodist_tpu_torch.simulator.cost_model import CostModelParams
    import numpy as np
    params = CostModelParams()
    findings = []
    shapes = [(8,), (8, 4), (9, 4), (8, 6), (6, 10)]
    for n in (2, 4):
        for shape in shapes:
            for src in _layouts_for(shape, n):
                for dst in _layouts_for(shape, n):
                    old = _mock_plan(shape, src, n)
                    new = _mock_plan(shape, dst, n)
                    ops = reshard.plan_reshard(old, new, params=params)
                    if len(ops) != 1:
                        findings.append(
                            'reshard: plan for %s n=%d covered %d ops '
                            'for 1 var' % (shape, n, len(ops)))
                        continue
                    op = ops[0]
                    ctx = 'reshard %s n=%d %s->%s (%s)' % (
                        shape, n, _fmt(src), _fmt(dst), op.kind)
                    findings.extend(_check_op(op, src, dst, shape, n,
                                              ctx))
                    elems = int(np.prod(shape))
                    for f in sir.verify(op.ir_program(n, elems)):
                        findings.append('%s: %s' % (ctx, f))
    return findings


def _fmt(layout):
    if not layout['sharded']:
        return 'repl'
    return 'shard(ax%d,pad%d)' % (layout['axis'], layout['pad'])


def _check_op(op, src, dst, shape, n, ctx):
    problems = []
    # kind preconditions (the shape algebra each lowering requires)
    if op.kind == 'noop' and src != dst:
        problems.append('%s: noop chosen for a layout CHANGE' % ctx)
    if op.kind != 'noop' and src == dst:
        problems.append('%s: layout unchanged but op is not noop' % ctx)
    if op.kind == 'shard' and (src['sharded'] or not dst['sharded']):
        problems.append('%s: shard requires replicated->sharded' % ctx)
    if op.kind == 'all_gather' and (not src['sharded']
                                    or dst['sharded']):
        problems.append('%s: all_gather requires sharded->replicated'
                        % ctx)
    if op.kind == 'all_to_all':
        if not (src['sharded'] and dst['sharded']):
            problems.append('%s: all_to_all requires sharded->sharded'
                            % ctx)
        elif src['pad'] or dst['pad'] or src['axis'] == dst['axis']:
            problems.append(
                '%s: all_to_all chosen where its tiled split cannot '
                'lower (pad %d->%d, axis %s->%s)'
                % (ctx, src['pad'], dst['pad'], src['axis'],
                   dst['axis']))
    for layout, which in ((src, 'src'), (dst, 'dst')):
        if layout['sharded']:
            dim = shape[layout['axis']]
            if layout['padded_dim'] % n:
                problems.append('%s: %s padded_dim %d not divisible by '
                                'n=%d' % (ctx, which,
                                          layout['padded_dim'], n))
            if layout['padded_dim'] - layout['pad'] != dim:
                problems.append('%s: %s pad algebra broken (padded %d '
                                '- pad %d != dim %d)'
                                % (ctx, which, layout['padded_dim'],
                                   layout['pad'], dim))
    # element preservation: dst shards partition the logical set
    import numpy as np
    everything = set(range(int(np.prod(shape))))
    union, total = set(), 0
    for d in range(n):
        h = _holdings(dst, shape, n, d)
        union |= h
        total += len(h)
    if union != everything:
        problems.append('%s: destination layout LOSES elements (%d of '
                        '%d reachable)' % (ctx, len(union),
                                           len(everything)))
    if dst['sharded'] and total != len(everything):
        problems.append('%s: destination shards overlap (%d held vs '
                        '%d logical)' % (ctx, total, len(everything)))
    if op.kind in ('noop', 'shard') and op.wire_bytes:
        problems.append('%s: zero-wire kind claims %d wire bytes'
                        % (ctx, op.wire_bytes))
    if op.est_time_s < 0:
        problems.append('%s: negative cost estimate' % ctx)
    return problems


# -- absorbed wire-pricing drift check ------------------------------------

def check_wire_pricing():
    """Compressor registry vs cost_model._WIRE_ITEMSIZE (a compressor
    missing from the table silently prices as f32)."""
    from autodist_tpu_torch.parallel.compressor import _REGISTRY
    from autodist_tpu_torch.simulator.cost_model import _WIRE_ITEMSIZE
    registry, priced = set(_REGISTRY), set(_WIRE_ITEMSIZE)
    problems = []
    for name in sorted(registry - priced):
        problems.append('compressor registered but missing from '
                        'cost_model._WIRE_ITEMSIZE (would silently '
                        'price as f32): %s' % name)
    for name in sorted(priced - registry):
        problems.append('priced in cost_model._WIRE_ITEMSIZE but not '
                        'in the compressor registry (stale entry): %s'
                        % name)
    if not registry:
        problems.append('compressor registry is empty — the registry '
                        'moved or the import graph broke')
    return problems


def analyze():
    """Run all schedule/plan consistency checks. Returns finding
    strings (empty = clean)."""
    return (check_ir_algebra() + check_emission_predicates() +
            check_pricing_parity() + check_reshard_algebra() +
            check_wire_pricing())
