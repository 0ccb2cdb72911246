"""Collective-schedule IR: communication schedules as verifiable data.

``plan.sync_gradients`` composes five orthogonal schedule dimensions
(flat vs two-level, the int8 tier boundary, ZeRO chunking, sparse rows,
weight-update sharding) and ``static_collective_schedule`` mirrors each
case by hand. This module is the PCCL-style fix (PAPERS.md,
arXiv:2606.07019; array redistribution, arXiv:2112.01075): ONE small IR
of composable steps that

- both emission paths lower through (``bucket_program`` builds the
  program, ``schedule_entry`` derives the static entry dict from it,
  ``execute`` drives the traced emission), so predicted == traced is
  structural rather than test-pinned;
- a shape algebra verifies (``verify``): device groups are disjoint,
  reduce-scatter chunks tile their span exactly, byte flow conserves
  across requantize boundaries, and the final per-device element
  partition matches the program's declared goal.

The element model: a program runs over ``elems`` padded elements
``[0, E)``. Each device holds a set of fragments ``(lo, hi, contribs)``
where ``contribs`` is the set of devices whose local addends are summed
into that range. A gradient sync starts ``replicated`` (every device
holds ``[0, E)`` with contribs ``{itself}``) and must end with contribs
= ALL devices everywhere it claims reduced data. Permute steps change
the coordinate frame (the hierarchical schedules' block pre-permutation)
and the goal check maps holdings back to original coordinates, so "the
two-level scatter lands the flat layout" is a theorem the verifier
checks, not a comment.

The port copies the algebra, the builders (3-level hierarchies and
per-link wire dtypes included, which ``simulator.search`` synthesizes)
and the formatting from the JAX package's ``parallel/schedule_ir.py``;
``execute``/``execute_generic`` lower onto ``torch.distributed`` over the
replica group instead of jax collectives, importing torch only when
called.
"""
from dataclasses import dataclass, field

#: wire-name -> bytes per element. The i8 wire additionally carries one
#: f32 scale per AUTODIST_QUANT_BLOCK elements (wire_nbytes adds it).
WIRE_ITEMSIZE = {'f32': 4, 'bf16': 2, 'i8': 1, 'f64': 8}

COMM_OPS = ('reduce_scatter', 'all_reduce', 'all_gather')


def dtype_itemsize(dtype):
    """Bytes per element of a numpy or torch dtype or a dtype name
    (numpy has no ``bfloat16``; the port names it)."""
    import numpy as np
    if hasattr(dtype, 'itemsize') and not isinstance(dtype, type):
        return int(dtype.itemsize)
    if str(dtype) == 'bfloat16':
        return 2
    return np.dtype(dtype).itemsize


def wire_of_dtype(dtype):
    """Wire name a raw (uncompressed) tensor dtype rides."""
    return {1: 'i8', 2: 'bf16', 4: 'f32',
            8: 'f64'}.get(dtype_itemsize(dtype), 'f32')


def _quant_block():
    from autodist_tpu_torch.parallel.compressor import quant_block_size
    return quant_block_size()


def wire_nbytes(elems, wire, block=None):
    """Wire bytes of ``elems`` payload elements at ``wire``, including
    the blockscale header of the int8 tier (one f32 scale per
    ``AUTODIST_QUANT_BLOCK`` elements — same accounting as
    ``cost_model.wire_bytes``)."""
    elems = int(elems)
    out = elems * WIRE_ITEMSIZE[wire]
    if wire == 'i8' and elems:
        out += 4 * (-(-elems // (block or _quant_block())))
    return out


@dataclass(frozen=True)
class Step:
    """One IR step.

    ``groups`` are tuples of device positions on the data axis
    (explicit, never implied by a mesh). ``chunks`` (reduce_scatter /
    scatter) give each group's per-member ABSOLUTE element interval
    ``(lo, hi)``; ``span`` (all_reduce / all_gather) the per-group
    interval the collective covers. ``perm`` (permute) maps new block
    index -> old block index at ``block`` elements per block.
    ``nbytes`` declares the per-group wire payload in bytes — the
    byte-flow conservation check bounds it against the algebra, and
    ``program_time`` prices from it.
    """
    op: str
    tier: str = 'ici'
    wire: str = 'f32'
    groups: tuple = ()
    chunks: tuple = ()
    span: tuple = ()
    perm: tuple = ()
    block: int = 0
    nbytes: float = 0.0


@dataclass
class Program:
    """One schedule: ``steps`` over ``n`` devices and ``elems`` padded
    elements of ``dtype``. ``init``/``goal`` declare the boundary
    layouts the algebra checks; ``meta`` carries everything the legacy
    entry schema needs (kind, compressor, spec, raw_bytes, hier, wus,
    node_groups) plus anything synthesis wants to remember."""
    name: str
    n: int
    elems: int
    dtype: str = 'float32'
    steps: tuple = ()
    init: str = 'replicated'
    goal: str = 'reduced_replicated'
    meta: dict = field(default_factory=dict)

    def to_dict(self):
        return {
            'name': self.name, 'n': self.n, 'elems': self.elems,
            'dtype': self.dtype,
            'init': self.init if isinstance(self.init, str)
            else 'custom', 'goal': self.goal,
            'meta': {k: v for k, v in self.meta.items()
                     if k != 'node_groups'},
            'steps': [{'op': s.op, 'tier': s.tier, 'wire': s.wire,
                       'groups': [list(g) for g in s.groups],
                       'nbytes': s.nbytes} for s in self.steps],
        }


# -- fragment algebra --------------------------------------------------

def _merge(frags):
    """Normalize a fragment list: sort, merge adjacent equal-contrib
    ranges, drop empties."""
    frags = sorted((lo, hi, c) for lo, hi, c in frags if hi > lo)
    out = []
    for lo, hi, c in frags:
        if out and out[-1][1] == lo and out[-1][2] == c:
            out[-1] = (out[-1][0], hi, c)
        else:
            out.append((lo, hi, c))
    return out


def _covers(frags, lo, hi):
    """True iff the fragments cover every element of [lo, hi)."""
    pos = lo
    for flo, fhi, _ in frags:
        if flo > pos:
            break
        if fhi > pos:
            pos = fhi
        if pos >= hi:
            return True
    return pos >= hi or lo >= hi

def _restrict(frags, lo, hi):
    return [(max(flo, lo), min(fhi, hi), c) for flo, fhi, c in frags
            if fhi > lo and flo < hi]


def _subtract(frags, lo, hi):
    out = []
    for flo, fhi, c in frags:
        if fhi <= lo or flo >= hi:
            out.append((flo, fhi, c))
            continue
        if flo < lo:
            out.append((flo, lo, c))
        if fhi > hi:
            out.append((hi, fhi, c))
    return out


def _overlay(frag_lists, lo, hi):
    """Pointwise union of contribs over [lo, hi) across several
    fragment lists. Returns (fragments, holes) where holes are the
    sub-ranges no list covers."""
    cuts = {lo, hi}
    for frags in frag_lists:
        for flo, fhi, _ in frags:
            if fhi > lo and flo < hi:
                cuts.add(max(flo, lo))
                cuts.add(min(fhi, hi))
    cuts = sorted(cuts)
    out, holes = [], []
    for a, b in zip(cuts, cuts[1:]):
        union = frozenset()
        seen = False
        for frags in frag_lists:
            for flo, fhi, c in frags:
                if flo <= a and fhi >= b:
                    union = union | c
                    seen = True
                    break
        if seen:
            out.append((a, b, union))
        else:
            holes.append((a, b))
    return _merge(out), holes


def _apply_perm(frags, perm, block):
    """Map a fragment list through a block permutation (new block b
    holds old block perm[b])."""
    inv = {old: new for new, old in enumerate(perm)}
    out = []
    for lo, hi, c in frags:
        b0, b1 = lo // block, -(-hi // block)
        for ob in range(b0, b1):
            slo, shi = max(lo, ob * block), min(hi, (ob + 1) * block)
            nb = inv[ob]
            off = nb * block - ob * block
            out.append((slo + off, shi + off, c))
    return _merge(out)


def _init_holdings(program):
    E, n = program.elems, program.n
    init = program.init
    if isinstance(init, (list, tuple)):
        return [_merge(list(h)) for h in init]
    ALL = frozenset(range(n))
    if init in ('replicated', 'value_replicated'):
        c = ALL if init == 'value_replicated' else None
        return [[(0, E, c if c is not None else frozenset([d]))]
                for d in range(n)]
    if init in ('sharded', 'rows', 'value_sharded'):
        m = E // n
        c = ALL if init == 'value_sharded' else None
        return [[(d * m, (d + 1) * m,
                  c if c is not None else frozenset([d]))]
                for d in range(n)]
    raise ValueError('unknown init %r' % (init,))


def _byte_slack(elems, wire):
    """Tolerance of the declared-vs-derived wire-byte check: exact for
    fixed-width wires, blockscale rounding for i8 (builders may declare
    the inter-phase payload as total/g, which rounds the scale header
    differently than a per-chunk recount)."""
    if wire != 'i8':
        return 0.5
    return 4.0 * (elems / float(_quant_block()) + 2.0)


def run_algebra(program, init_holdings=None):
    """Run the shape algebra over ``program``; returns
    ``(findings, holdings)`` where holdings are the final per-device
    fragment lists in ORIGINAL coordinates. Empty findings = the
    schedule verifies."""
    findings = []
    E, n = int(program.elems), int(program.n)
    ALL = frozenset(range(n))
    try:
        hold = [list(h) for h in (init_holdings or
                                  _init_holdings(program))]
    except ValueError as err:
        return ['schedule-ir %s: %s' % (program.name, err)], []
    cur_wire = wire_of_dtype(program.dtype)
    to_orig = None          # current block -> original block
    perm_block = 0

    def ctx(i, step):
        return 'schedule-ir %s step %d (%s/%s)' % (
            program.name, i, step.op, step.tier)

    for i, step in enumerate(program.steps):
        where = ctx(i, step)
        if step.op == 'requantize':
            if step.wire not in WIRE_ITEMSIZE:
                findings.append('%s: unknown wire %r' % (where,
                                                         step.wire))
            cur_wire = step.wire
            continue
        if step.op == 'permute':
            B = len(step.perm)
            if not B or step.block <= 0 or B * step.block != E:
                findings.append('%s: permute must cover the %d '
                                'padded elements exactly' % (where, E))
                continue
            if sorted(step.perm) != list(range(B)):
                findings.append('%s: perm is not a bijection' % where)
                continue
            if step.nbytes:
                findings.append('%s: permute is local relabeling; '
                                'declared %.0f wire bytes'
                                % (where, step.nbytes))
            hold = [_apply_perm(h, step.perm, step.block)
                    for h in hold]
            if to_orig is None:
                to_orig = tuple(step.perm)
                perm_block = step.block
            elif perm_block != step.block:
                findings.append('%s: mixed permute block sizes'
                                % where)
            else:
                to_orig = tuple(to_orig[old] for old in step.perm)
            continue
        if step.op == 'gather':
            if step.nbytes:
                findings.append('%s: gather is local row '
                                'materialization; declared %.0f wire '
                                'bytes' % (where, step.nbytes))
            continue
        if step.op == 'scatter' and not step.groups:
            # bare marker: local dense materialization (sparse wire)
            continue

        # -- comm ops (and grouped scatter) ---------------------------
        if step.op not in COMM_OPS + ('scatter',):
            findings.append('%s: unknown op' % where)
            continue
        if not step.groups:
            findings.append('%s: comm step with no groups' % where)
            continue
        seen = set()
        bad = False
        for grp in step.groups:
            for d in grp:
                if not 0 <= d < n:
                    findings.append('%s: device %d outside mesh [0,%d)'
                                    % (where, d, n))
                    bad = True
                if d in seen:
                    findings.append('%s: device %d appears in two '
                                    'groups — groups must partition '
                                    'disjointly' % (where, d))
                    bad = True
                seen.add(d)
        if bad:
            continue
        if step.op in COMM_OPS and step.wire != cur_wire:
            findings.append(
                '%s: declared wire %r but the live buffer is %r — a '
                'requantize is missing or misplaced at this tier '
                'boundary' % (where, step.wire, cur_wire))
        payload = 0          # max per-group payload elements

        if step.op in ('reduce_scatter', 'scatter'):
            if len(step.chunks) != len(step.groups):
                findings.append('%s: %d chunk lists for %d groups'
                                % (where, len(step.chunks),
                                   len(step.groups)))
                continue
            for grp, chs in zip(step.groups, step.chunks):
                if len(chs) != len(grp):
                    findings.append('%s: %d chunks for %d members'
                                    % (where, len(chs), len(grp)))
                    continue
                nonempty = sorted((lo, hi) for lo, hi in chs
                                  if hi > lo)
                if not nonempty:
                    continue
                ulo, uhi = nonempty[0][0], nonempty[-1][1]
                pos = ulo
                tiled = True
                for lo, hi in nonempty:
                    if lo != pos:
                        tiled = False
                    pos = hi
                if not tiled or pos != uhi:
                    findings.append(
                        '%s: chunks %s do not tile [%d,%d) exactly '
                        '(gap or overlap)' % (where, nonempty, ulo,
                                              uhi))
                    continue
                if ulo < 0 or uhi > E:
                    findings.append('%s: span [%d,%d) outside the %d '
                                    'padded elements'
                                    % (where, ulo, uhi, E))
                    continue
                payload = max(payload, uhi - ulo)
                member_frags = [hold[d] for d in grp]
                if step.op == 'reduce_scatter':
                    for d in grp:
                        if not _covers(hold[d], ulo, uhi):
                            findings.append(
                                '%s: device %d does not hold the full '
                                'span [%d,%d) it must reduce'
                                % (where, d, ulo, uhi))
                    merged, holes = _overlay(member_frags, ulo, uhi)
                    for d, (lo, hi) in zip(grp, chs):
                        kept = _restrict(merged, lo, hi)
                        hold[d] = _merge(
                            _subtract(hold[d], ulo, uhi) + kept)
                else:   # scatter: redistribution / local projection
                    if step.nbytes == 0:
                        for d, (lo, hi) in zip(grp, chs):
                            if hi > lo and not _covers(hold[d], lo,
                                                       hi):
                                findings.append(
                                    '%s: zero-wire scatter but device '
                                    '%d lacks its chunk [%d,%d)'
                                    % (where, d, lo, hi))
                            hold[d] = _merge(_restrict(hold[d], lo,
                                                       hi))
                    else:
                        merged, holes = _overlay(member_frags, ulo,
                                                 uhi)
                        if holes:
                            findings.append(
                                '%s: span holes %s held by no member'
                                % (where, holes))
                        for d, (lo, hi) in zip(grp, chs):
                            hold[d] = _merge(_restrict(merged, lo,
                                                       hi))
        else:   # all_reduce / all_gather
            if len(step.span) != len(step.groups):
                findings.append('%s: %d spans for %d groups'
                                % (where, len(step.span),
                                   len(step.groups)))
                continue
            for grp, (slo, shi) in zip(step.groups, step.span):
                if slo < 0 or shi > E or shi < slo:
                    findings.append('%s: span [%d,%d) outside the %d '
                                    'padded elements'
                                    % (where, slo, shi, E))
                    continue
                payload = max(payload, shi - slo)
                member_frags = [hold[d] for d in grp]
                merged, holes = _overlay(member_frags, slo, shi)
                if step.op == 'all_reduce':
                    for d in grp:
                        if not _covers(hold[d], slo, shi):
                            findings.append(
                                '%s: device %d does not hold the full '
                                'span [%d,%d) it must reduce'
                                % (where, d, slo, shi))
                elif holes:
                    findings.append('%s: span holes %s held by no '
                                    'member' % (where, holes))
                for d in grp:
                    hold[d] = _merge(
                        _subtract(hold[d], slo, shi) + merged)

        if step.op in COMM_OPS:
            expect = wire_nbytes(payload, step.wire)
            slack = _byte_slack(payload, step.wire)
            if abs(float(step.nbytes) - expect) > slack:
                findings.append(
                    '%s: declares %.0f wire bytes but the algebra '
                    'moves %d payload elements = %d bytes at %s '
                    '(byte flow must conserve across requantize '
                    'boundaries)' % (where, step.nbytes, payload,
                                     expect, step.wire))

    # -- goal ---------------------------------------------------------
    if to_orig is not None:
        hold = [_apply_perm(h,
                            tuple(to_orig.index(b)
                                  for b in range(len(to_orig))),
                            perm_block) for h in hold]
    goal = program.goal
    m = E // n if n and E % n == 0 else 0

    def _contribs_all(h, lo, hi, d):
        for flo, fhi, c in _restrict(h, lo, hi):
            if c != ALL:
                findings.append(
                    'schedule-ir %s: device %d range [%d,%d) ends '
                    'with contributions from %d of %d devices — the '
                    'reduction is incomplete' % (program.name, d, flo,
                                                 fhi, len(c), n))
                return

    if goal == 'none':
        pass
    elif goal in ('reduced_replicated', 'value_replicated',
                  'gathered'):
        ref = None
        for d in range(n):
            if not _covers(hold[d], 0, E):
                findings.append('schedule-ir %s: device %d does not '
                                'hold the full result'
                                % (program.name, d))
            elif goal == 'reduced_replicated':
                _contribs_all(hold[d], 0, E, d)
            elif goal == 'gathered':
                if ref is None:
                    ref = hold[d]
                elif _merge(list(hold[d])) != _merge(list(ref)):
                    findings.append(
                        'schedule-ir %s: device %d gathered a '
                        'different contribution map than device 0'
                        % (program.name, d))
    elif goal in ('reduced_scattered', 'value_sharded'):
        if not m:
            findings.append('schedule-ir %s: %d elements do not '
                            'shard over %d devices'
                            % (program.name, E, n))
        else:
            for d in range(n):
                lo, hi = d * m, (d + 1) * m
                if not _covers(hold[d], lo, hi):
                    findings.append(
                        'schedule-ir %s: device %d does not hold its '
                        'shard [%d,%d)' % (program.name, d, lo, hi))
                elif goal == 'reduced_scattered':
                    _contribs_all(hold[d], lo, hi, d)
                extra = _subtract(hold[d], lo, hi)
                if extra:
                    findings.append(
                        'schedule-ir %s: device %d holds %s outside '
                        'its shard — the scatter leaked'
                        % (program.name, d, extra))
    else:
        findings.append('schedule-ir %s: unknown goal %r'
                        % (program.name, goal))
    return findings, hold


def verify(program, init_holdings=None):
    """Shape-algebra verification; returns findings ([] = clean)."""
    return run_algebra(program, init_holdings=init_holdings)[0]


def staging_bytes(program):
    """Peak staging-buffer estimate of a program's local steps — the
    memory axis synthesis prunes on: a requantize materializes the
    re-encoded buffer next to the live one, a permute its re-blocked
    copy. Wire-only accounting (the live f32 buffer itself is the
    plan's peak-bytes business, not the schedule's)."""
    E = int(program.elems)
    peak = 0
    for s in program.steps:
        if s.op == 'requantize':
            peak = max(peak, wire_nbytes(E, s.wire))
        elif s.op == 'permute':
            peak = max(peak, len(s.perm) * int(s.block) *
                       WIRE_ITEMSIZE.get(s.wire, 4))
    return int(peak)


# -- builders ----------------------------------------------------------

def contiguous_groups(n, k):
    """``k`` equal contiguous groups over ``n`` positions — the
    canonical host-major layout ``mesh.data_axis_node_groups`` lays
    devices out in, and what a static entry's ``hier`` count
    reconstructs to."""
    n, k = int(n), int(k)
    if k <= 1 or n % k:
        return None
    g = n // k
    return tuple(tuple(range(j * g, (j + 1) * g)) for j in range(k))


def _pad_to(elems, mult):
    mult = max(1, int(mult))
    return -(-int(elems) // mult) * mult


def _full_group(n):
    return (tuple(range(n)),)


def _flat_chunks(E, n):
    m = E // n
    return (tuple((d * m, (d + 1) * m) for d in range(n)),)


def flat_program(elems, dtype, *, kind='all_reduce', tier='dcn',
                 wire=None, name='', meta=None, n=None):
    """Flat single-group program: one AR / RS / AG over the whole mesh
    at ``tier``. ``wire`` defaults to the dtype's own width; a narrower
    wire gets requantize steps around the collective (the flat int8 /
    bf16 schedules)."""
    n = int(n)
    raw_wire = wire_of_dtype(dtype)
    wire = wire or raw_wire
    E = _pad_to(elems, n) if kind != 'all_reduce' else int(elems)
    steps = []
    if wire != raw_wire:
        steps.append(Step('requantize', tier='local', wire=wire))
    nb = wire_nbytes(E, wire)
    if kind == 'all_reduce':
        steps.append(Step('all_reduce', tier=tier, wire=wire,
                          groups=_full_group(n), span=((0, E),),
                          nbytes=nb))
        init, goal = 'replicated', 'reduced_replicated'
    elif kind == 'psum_scatter':
        steps.append(Step('reduce_scatter', tier=tier, wire=wire,
                          groups=_full_group(n),
                          chunks=_flat_chunks(E, n), nbytes=nb))
        init, goal = 'replicated', 'reduced_scattered'
    elif kind == 'all_gather':
        steps.append(Step('all_gather', tier=tier, wire=wire,
                          groups=_full_group(n), span=((0, E),),
                          nbytes=nb))
        init, goal = 'sharded', 'gathered'
    else:
        raise ValueError('flat_program: unknown kind %r' % (kind,))
    if wire != raw_wire and kind != 'all_gather':
        steps.append(Step('requantize', tier='local', wire=raw_wire))
    return Program(name or 'flat_%s' % kind, n, E, str(dtype),
                   tuple(steps), init, goal, dict(meta or {}))


def _wave_groups(host_sizes, c):
    """Inter-phase wave schedule for (possibly unequal) ``host_sizes``:
    the span splits into ``c = max(host_sizes)`` chunks; device ``i``
    of host ``h`` owns chunks ``[i*c//g_h, (i+1)*c//g_h)``. Rounds
    (one AR per chunk across its per-host owners) pack into
    ``W = max chunks/device`` sequential waves of device-disjoint
    groups — the straggler host pays extra waves, which is exactly how
    the cost model prices it. Equal hosts degenerate to one wave of
    the classic representative groups. Returns (waves, W) where waves
    is a list of lists of (chunk_index, group_tuple)."""
    owners = []          # per chunk: tuple of owning device positions
    base = 0
    per_dev_chunks = []
    for g in host_sizes:
        for i in range(g):
            per_dev_chunks.append((i * c // g, (i + 1) * c // g))
        base += g
    W = max((hi - lo) for lo, hi in per_dev_chunks) if per_dev_chunks \
        else 1
    for q in range(c):
        grp = []
        base = 0
        di = 0
        for g in host_sizes:
            for i in range(g):
                lo, hi = per_dev_chunks[di]
                if lo <= q < hi:
                    grp.append(base + i)
                di += 1
            base += g
        owners.append(tuple(grp))
    waves = [[] for _ in range(W)]
    for q, grp in enumerate(owners):
        waves[q % W].append((q, grp))
    return waves, W


def two_level_program(elems, dtype, host_sizes, *, kind='all_reduce',
                      tiers=('ici', 'dcn'), wires=None, name='',
                      meta=None, node_groups=None):
    """Two-level program over ``host_sizes`` devices per node (host-
    major positions). Equal sizes reproduce the legacy hierarchical
    schedules step for step; unequal sizes lift ``num_node_groups``'s
    equal-split requirement via the wave construction (the synthesis
    path — the traced emitter cannot run these yet, but the algebra
    verifies them and the cost model prices the straggler).

    ``wires`` is (intra_wire, inter_wire); an inter wire narrower than
    intra inserts the boundary requantize pair (the int8 tier-boundary
    schedule). ``kind`` 'all_reduce' | 'psum_scatter' | 'all_gather'
    (the ZeRO / weight-update-sharding halves).
    """
    host_sizes = tuple(int(g) for g in host_sizes)
    n = sum(host_sizes)
    k = len(host_sizes)
    c = max(host_sizes)
    raw_wire = wire_of_dtype(dtype)
    w_in, w_out = wires or (raw_wire, raw_wire)
    equal = len(set(host_sizes)) == 1
    if node_groups is None:
        node_groups = []
        base = 0
        for g in host_sizes:
            node_groups.append(tuple(range(base, base + g)))
            base += g
        node_groups = tuple(node_groups)
    else:
        node_groups = tuple(tuple(g) for g in node_groups)
    E = _pad_to(elems, c * (n if kind != 'all_reduce' else 1))
    if kind != 'all_reduce':
        # the flat-identity permute needs chunk granularity E/n AND
        # the intra phase needs E/c; pad to both
        E = _pad_to(elems, c * n)
    m = E // c                      # elements per inter chunk
    meta = dict(meta or {})
    meta.setdefault('node_groups', node_groups)
    meta.setdefault('hier', k)

    # intra chunks: device i of host h owns chunks [i*c//g, (i+1)*c//g)
    intra_chunks = []
    for grp, g in zip(node_groups, host_sizes):
        intra_chunks.append(tuple(
            (i * c // g * m, (i + 1) * c // g * m)
            for i in range(g)))
    intra_chunks = tuple(intra_chunks)
    waves, W = _wave_groups(host_sizes, c)
    inter_nb = wire_nbytes(E, w_out) / float(c)

    def rq(w):
        return Step('requantize', tier='local', wire=w)

    steps = []
    if w_in != raw_wire:
        steps.append(rq(w_in))
    if kind == 'all_reduce':
        steps.append(Step('reduce_scatter', tier=tiers[0], wire=w_in,
                          groups=node_groups, chunks=intra_chunks,
                          nbytes=wire_nbytes(E, w_in)))
        if w_out != w_in:
            steps.append(rq(w_out))
        for wave in waves:
            steps.append(Step(
                'all_reduce', tier=tiers[1], wire=w_out,
                groups=tuple(grp for _, grp in wave),
                span=tuple((q * m, (q + 1) * m) for q, _ in wave),
                nbytes=inter_nb))
        if w_out != w_in:
            steps.append(rq(w_in))
        steps.append(Step('all_gather', tier=tiers[0], wire=w_in,
                          groups=node_groups,
                          span=((0, E),) * k,
                          nbytes=wire_nbytes(E, w_in)))
        if w_in != raw_wire:
            steps.append(rq(raw_wire))
        init, goal = 'replicated', 'reduced_replicated'
    elif kind == 'psum_scatter':
        if not equal:
            raise ValueError('two_level_program: the scatter half '
                             'requires equal host sizes (flat-'
                             'identity layout)')
        g = host_sizes[0]
        mm = E // n                 # flat chunk size
        # arranged (permuted) coordinates: block (p, j) of a
        # (g, k, mm) layout is flat block j*g+p — the pre-permutation
        # that makes hierarchical ownership identical to flat
        perm = [0] * n
        for p in range(g):
            for j in range(k):
                perm[p * k + j] = j * g + p
        steps.append(Step('permute', tier='local', wire=w_in,
                          perm=tuple(perm), block=mm))
        intra = tuple(tuple((p * k * mm, (p + 1) * k * mm)
                            for p in range(g)) for _ in range(k))
        steps.append(Step('reduce_scatter', tier=tiers[0], wire=w_in,
                          groups=node_groups, chunks=intra,
                          nbytes=wire_nbytes(E, w_in)))
        inter_groups = tuple(
            tuple(grp[p] for grp in node_groups) for p in range(g))
        inter_chunks = tuple(
            tuple((p * k * mm + j * mm, p * k * mm + (j + 1) * mm)
                  for j in range(k)) for p in range(g))
        if w_out != w_in:
            steps.append(rq(w_out))
        steps.append(Step('reduce_scatter', tier=tiers[1],
                          wire=w_out, groups=inter_groups,
                          chunks=inter_chunks,
                          nbytes=wire_nbytes(E, w_out) / float(g)))
        if w_out != w_in:
            steps.append(rq(w_in))
        init, goal = 'replicated', 'reduced_scattered'
    elif kind == 'all_gather':
        if not equal:
            raise ValueError('two_level_program: the gather half '
                             'requires equal host sizes (flat-'
                             'identity layout)')
        g = host_sizes[0]
        mm = E // n
        perm = [0] * n
        for p in range(g):
            for j in range(k):
                perm[p * k + j] = j * g + p
        # the leading permute reinterprets each device's flat chunk d
        # as arranged block (p, j) — zero wire, pure coordinates
        steps.append(Step('permute', tier='local', wire=w_in,
                          perm=tuple(perm), block=mm))
        inter_groups = tuple(
            tuple(grp[p] for grp in node_groups) for p in range(g))
        if w_out != w_in:
            steps.append(rq(w_out))
        steps.append(Step('all_gather', tier=tiers[1], wire=w_out,
                          groups=inter_groups,
                          span=tuple((p * k * mm, (p + 1) * k * mm)
                                     for p in range(g)),
                          nbytes=wire_nbytes(E, w_out) / float(g)))
        if w_out != w_in:
            steps.append(rq(w_in))
        steps.append(Step('all_gather', tier=tiers[0], wire=w_in,
                          groups=node_groups,
                          span=((0, E),) * k,
                          nbytes=wire_nbytes(E, w_in)))
        inv = [0] * n
        for b, old in enumerate(perm):
            inv[old] = b
        steps.append(Step('permute', tier='local', wire=w_in,
                          perm=tuple(inv), block=mm))
        init, goal = 'sharded', 'gathered'
    else:
        raise ValueError('two_level_program: unknown kind %r'
                         % (kind,))
    meta.setdefault('waves', W)
    return Program(name or 'two_level_%s' % kind, n, E, str(dtype),
                   tuple(steps), init, goal, meta)


def three_level_program(elems, dtype, slices, hosts_per_slice,
                        devs_per_host, *,
                        tiers=('ici', 'host', 'dcn'), wires=None,
                        name='', meta=None):
    """Three-level all-reduce: RS(device tier within host), RS(host
    tier within slice), AR(slice tier), AG(host), AG(ici) — the AG
    phases invert the RS phases exactly, so no permute is needed and
    the goal is full replication. Only the synthesis path emits these
    (a hand-written emitter covers at most two tiers)."""
    s, h, g = int(slices), int(hosts_per_slice), int(devs_per_host)
    n = s * h * g
    raw_wire = wire_of_dtype(dtype)
    w0, w1, w2 = wires or (raw_wire, raw_wire, raw_wire)
    E = _pad_to(elems, g * h)
    mg = E // g                     # per-device chunk after RS(ici)
    mh = mg // h                    # ... after RS(host)

    def pos(si, hi, di):
        return (si * h + hi) * g + di

    host_groups = tuple(
        tuple(pos(si, hi, di) for di in range(g))
        for si in range(s) for hi in range(h))
    host_chunks = tuple(
        tuple((di * mg, (di + 1) * mg) for di in range(g))
        for _ in range(s * h))
    slice_groups = tuple(
        tuple(pos(si, hi, di) for hi in range(h))
        for si in range(s) for di in range(g))
    slice_chunks = tuple(
        tuple((di * mg + hi * mh, di * mg + (hi + 1) * mh)
              for hi in range(h))
        for si in range(s) for di in range(g))
    top_groups = tuple(
        tuple(pos(si, hi, di) for si in range(s))
        for hi in range(h) for di in range(g))
    top_spans = tuple(
        (di * mg + hi * mh, di * mg + (hi + 1) * mh)
        for hi in range(h) for di in range(g))

    steps = []

    def rq(w):
        return Step('requantize', tier='local', wire=w)

    if w0 != raw_wire:
        steps.append(rq(w0))
    steps.append(Step('reduce_scatter', tier=tiers[0], wire=w0,
                      groups=host_groups, chunks=host_chunks,
                      nbytes=wire_nbytes(E, w0)))
    if w1 != w0:
        steps.append(rq(w1))
    steps.append(Step('reduce_scatter', tier=tiers[1], wire=w1,
                      groups=slice_groups, chunks=slice_chunks,
                      nbytes=wire_nbytes(E, w1) / float(g)))
    if w2 != w1:
        steps.append(rq(w2))
    steps.append(Step('all_reduce', tier=tiers[2], wire=w2,
                      groups=top_groups, span=top_spans,
                      nbytes=wire_nbytes(E, w2) / float(g * h)))
    if w2 != w1:
        steps.append(rq(w1))
    steps.append(Step('all_gather', tier=tiers[1], wire=w1,
                      groups=slice_groups,
                      span=tuple((di * mg, (di + 1) * mg)
                                 for si in range(s)
                                 for di in range(g)),
                      nbytes=wire_nbytes(E, w1) / float(g)))
    if w1 != w0:
        steps.append(rq(w0))
    steps.append(Step('all_gather', tier=tiers[0], wire=w0,
                      groups=host_groups,
                      span=((0, E),) * (s * h),
                      nbytes=wire_nbytes(E, w0)))
    if w0 != raw_wire:
        steps.append(rq(raw_wire))
    m = dict(meta or {})
    m.setdefault('levels', 3)
    m.setdefault('uniform', True)
    return Program(name or 'three_level_all_reduce', n, E,
                   str(dtype), tuple(steps), 'replicated',
                   'reduced_replicated', m)


def sparse_program(elems, dtype, *, kind='sparse_all_gather',
                   tier='dcn', name='', meta=None, n=None):
    """Sparse (ids, rows) wire program over wire-buffer element space:
    device d materializes its segment locally (``gather``, zero wire),
    one all-gather ships every segment, and ``sparse_scatter``
    additionally marks the local dense materialization of the shard
    (outside the wire algebra — pure compute)."""
    n = int(n)
    E = _pad_to(elems, n)
    wire = wire_of_dtype(dtype)
    steps = [Step('gather', tier='local', wire=wire),
             Step('all_gather', tier=tier, wire=wire,
                  groups=_full_group(n), span=((0, E),),
                  nbytes=wire_nbytes(E, wire))]
    if kind == 'sparse_scatter':
        steps.append(Step('scatter', tier='local', wire=wire))
    return Program(name or kind, n, E, str(dtype), tuple(steps),
                   'rows', 'gathered', dict(meta or {}))


#: compressor name -> the wire its collective phases ride (None = the
#: tensor's own width). Mirrors cost_model._WIRE_ITEMSIZE.
_COMPRESSOR_WIRE = {
    'NoneCompressor': None,
    'HorovodCompressor': 'bf16',
    'HorovodCompressorEF': 'bf16',
    'Int8RingCompressor': 'i8',
    'PowerSGDCompressor': None,
}


def bucket_program(kind, nbytes, dtype, compressor, spec, n, *,
                   hier=0, wus=False, node_groups=None,
                   flat_tier='dcn', name=''):
    """THE shared lowering: the IR program for one legacy schedule
    entry, built identically by ``plan.sync_gradients`` (which then
    ``execute``\\ s it) and ``plan.static_collective_schedule`` (which
    derives its entry dict via ``schedule_entry``). ``nbytes`` are RAW
    tensor bytes (the entry schema's figure); ``hier`` the node-group
    count (0/1 = flat); ``node_groups`` the real mesh groups when the
    caller has them (defaults to the canonical contiguous layout —
    entry ids only carry the count, so both reconstruct identically).
    """
    n = int(n)
    itemsize = dtype_itemsize(dtype)
    elems = max(1, int(nbytes) // itemsize)
    cname = compressor or 'NoneCompressor'
    raw_wire = wire_of_dtype(dtype)
    cwire = _COMPRESSOR_WIRE.get(cname) or raw_wire
    if WIRE_ITEMSIZE[cwire] >= itemsize:
        cwire = raw_wire
    k = int(hier or 0)
    meta = {'kind': kind, 'compressor': cname, 'spec': spec,
            'raw_bytes': int(nbytes), 'dtype': str(dtype),
            'hier': k if k > 1 else 0, 'wus': bool(wus)}
    if kind in ('sparse_all_gather', 'sparse_scatter'):
        return sparse_program(elems, dtype, kind=kind, tier=flat_tier,
                              name=name, meta=meta, n=n)
    if kind not in ('all_reduce', 'psum_scatter', 'all_gather'):
        raise ValueError('bucket_program: unknown kind %r' % (kind,))
    if k > 1:
        groups = node_groups or contiguous_groups(n, k)
        if groups is None:
            raise ValueError('bucket_program: %d devices do not '
                             'split into %d node groups' % (n, k))
        host_sizes = tuple(len(g) for g in groups)
        if cname == 'Int8RingCompressor' and kind == 'all_reduce':
            # the int8 tier boundary: f32 intra phases, i8 only
            # across the slow tier (requantize at the boundary)
            wires = (raw_wire, 'i8')
        else:
            wires = (cwire, cwire)
        return two_level_program(elems, dtype, host_sizes, kind=kind,
                                 wires=wires, name=name, meta=meta,
                                 node_groups=groups)
    return flat_program(elems, dtype, kind=kind, tier=flat_tier,
                        wire=cwire, name=name, meta=meta, n=n)


def schedule_entry(program, *, group=None, members=(), vars_=1,
                   phase=None):
    """The legacy entry dict DERIVED from an IR program — the static
    schedule and the traced emission records both route through this,
    so the entry schema (and the entry ids that join the drift
    table) is a projection of the IR rather than a parallel encoding.
    ``phase`` is only stamped when given (traced records carry none).
    """
    meta = program.meta
    cname = meta.get('compressor')
    e = {'kind': meta.get('kind'), 'group': group,
         'compressor': None if cname == 'NoneCompressor' and
         group is None else cname,
         'dtype': meta.get('dtype', program.dtype),
         'spec': meta.get('spec', 'AUTO'), 'vars': int(vars_),
         'bytes': int(meta.get('raw_bytes', 0)),
         'members': list(members),
         'hier': int(meta.get('hier', 0)),
         'wus': bool(meta.get('wus', False))}
    if phase is not None:
        e['phase'] = phase
    if meta.get('hier_fallback'):
        e['hier_fallback'] = meta['hier_fallback']
    return e


def entry_program(entry, n, *, node_groups=None, flat_tier='dcn'):
    """Rebuild the IR program a static-schedule entry lowers to — the
    inverse of ``schedule_entry`` up to padding, used by the schedule
    lint, ``cost_model.predict``'s verification and the simulator's
    ``--schedule-dump``."""
    prog = bucket_program(
        entry['kind'], entry.get('bytes', 0), entry.get('dtype') or
        'float32', entry.get('compressor'), entry.get('spec', 'AUTO'),
        n, hier=entry.get('hier', 0), wus=entry.get('wus', False),
        node_groups=node_groups, flat_tier=flat_tier,
        name=entry.get('entry_id', ''))
    if entry.get('entry_id'):
        prog.meta['entry_id'] = entry['entry_id']
    return prog


# -- lowering / execution ----------------------------------------------

def _comm_steps(program):
    return [s for s in program.steps if s.op in COMM_OPS]


def node_groups_of(program):
    """The intra-tier device groups of a hierarchical program (list of
    lists, the ``axis_index_groups`` the legacy collectives take)."""
    groups = program.meta.get('node_groups')
    if groups:
        return [list(g) for g in groups]
    for s in _comm_steps(program):
        if len(s.groups) > 1 and len(s.groups[0]) > 1:
            return [list(g) for g in s.groups]
    return None


def lowering_of(program):
    """Structural pattern-match of the step sequence onto a traced-
    emission tag. The tags name the EXACT legacy collective
    compositions ``execute`` dispatches to, so bit-identity with the
    hand-written emitter is by construction; anything else is
    ``generic`` (synthesized — executable via ``execute_generic`` when
    uniform, otherwise priced/verified only)."""
    kind = program.meta.get('kind', '')
    if kind.startswith('sparse'):
        return kind
    comm = _comm_steps(program)
    ops = tuple(s.op for s in comm)
    n = program.n

    def full(s):
        return len(s.groups) == 1 and len(s.groups[0]) == n

    if ops == ('all_reduce',) and full(comm[0]):
        if comm[0].wire == 'i8':
            return 'int8_ring'
        if program.meta.get('spec') == 'RING':
            return 'ring'
        return 'psum'
    if ops == ('reduce_scatter', 'all_reduce', 'all_gather') and \
            not any(s.tier == 'host' for s in comm):
        return 'int8_hier' if comm[1].wire == 'i8' else 'hier'
    if ops == ('reduce_scatter',) and full(comm[0]):
        return 'psum_scatter'
    if ops == ('reduce_scatter', 'reduce_scatter'):
        return 'hier_scatter'
    if ops == ('all_gather',) and full(comm[0]):
        return 'all_gather'
    if ops == ('all_gather', 'all_gather'):
        return 'hier_gather'
    return 'generic'


def execute(program, x, group, *, axis=0):
    """Emission of ``program`` on this replica's ``x`` over the replica
    group (:class:`~autodist_tpu_torch.parallel.mesh.ReplicaGroup`) —
    the IR -> collective lowering ``plan.sync_gradients`` routes
    through. Reductions return the MEAN; gathers return the gathered
    value. Dispatches per ``lowering_of`` to the same collective
    compositions as the JAX package: the group's all-reduce,
    reduce-scatter and all-gather, send/recv rings for ``RING`` and the
    int8 wire, and the two-level schedules over the program's node
    groups (subgroups of the replica group)."""
    from autodist_tpu_torch.parallel import compressor as comp
    from autodist_tpu_torch.parallel import plan as _plan
    n = program.n
    tag = lowering_of(program)
    groups = node_groups_of(program)
    if tag == 'psum':
        return group.all_reduce(x) / n
    if tag == 'ring':
        return _plan.ring_all_reduce(x, group) / n
    if tag == 'hier':
        return _plan.hierarchical_all_reduce(x, group, groups) / n
    if tag == 'int8_ring':
        return comp.int8_ring_all_reduce(x, group) / n
    if tag == 'int8_hier':
        return comp.int8_hierarchical_all_reduce(x, group, groups) / n
    if tag == 'psum_scatter':
        return group.reduce_scatter(x, axis=axis) / n
    if tag == 'hier_scatter':
        return _plan.hierarchical_psum_scatter(x, group, groups,
                                               axis=axis) / n
    if tag == 'all_gather':
        return group.all_gather(x, axis=axis)
    if tag == 'hier_gather':
        return _plan.hierarchical_all_gather(x, group, groups, axis=axis)
    return execute_generic(program, x, group)


def executable_generic(program):
    """True when ``execute_generic`` can run this program: every comm
    step's groups are uniform-size and no step needs the int8 wire
    (the generic interpreter has no residual/blockscale state)."""
    for s in program.steps:
        if s.op == 'requantize' and s.wire == 'i8':
            return False
        if s.op in COMM_OPS:
            sizes = {len(g) for g in s.groups}
            if len(sizes) != 1:
                return False
            if s.op == 'reduce_scatter':
                widths = {hi - lo for chs in s.chunks
                          for lo, hi in chs}
                if len(widths) != 1:
                    return False
    return True


def execute_generic(program, x, group):
    """Step-by-step interpreter for synthesized (uniform) programs: sum,
    reduce-scatter and all-gather over the subgroup of each IR step,
    permutes as block relabeling. Reductions return the mean. Raises on
    programs ``executable_generic`` rejects."""
    import torch
    n, E = program.n, program.elems
    if not executable_generic(program):
        raise ValueError('program %s is not generically executable '
                         '(non-uniform groups or int8 wire)'
                         % program.name)
    shape, size = x.shape, x.numel()
    buf = x.reshape(-1)
    if E > size:
        buf = torch.nn.functional.pad(buf, (0, E - size))
    reduced = program.goal in ('reduced_replicated',
                               'reduced_scattered')
    orig_dtype = buf.dtype
    for s in program.steps:
        if s.op == 'requantize':
            buf = buf.to(torch.bfloat16 if s.wire == 'bf16'
                         else orig_dtype)
            continue
        if s.op == 'permute':
            blocks = buf.reshape(len(s.perm), s.block)
            buf = blocks[list(s.perm)].reshape(-1)
            continue
        if s.op in ('gather', 'scatter'):
            continue
        # this replica's subgroup of the step (every group is made on
        # every replica, in order); None when it idles in this step
        mine = group.split(s.groups)
        if mine is None or mine.size == 1:
            # idle or alone in its group: the identity (a singleton
            # all-reduce; scatter/gather over one replica)
            continue
        if s.op == 'all_reduce':
            buf = mine.all_reduce(buf)
        elif s.op == 'reduce_scatter':
            buf = mine.reduce_scatter(buf)
        elif s.op == 'all_gather':
            buf = mine.all_gather(buf)
    buf = buf.to(orig_dtype)
    if reduced:
        buf = buf / n
    if program.goal in ('reduced_replicated', 'gathered'):
        return buf[:size].reshape(shape)
    return buf


def format_program(program, params=None, links=None):
    """Human-readable step listing with per-step predicted times (when
    ``params`` given) — what ``tools/simulate.py --schedule-dump``
    prints so operators can see WHY a schedule won."""
    lines = ['%s: n=%d elems=%d dtype=%s goal=%s'
             % (program.name, program.n, program.elems,
                program.dtype, program.goal)]
    times = None
    if params is not None:
        from autodist_tpu_torch.simulator.cost_model import program_time
        _, times = program_time(program, params, links=links,
                                per_step=True)
    ci = 0
    for s in program.steps:
        desc = '  %-14s %-5s %-4s' % (s.op, s.tier, s.wire)
        if s.op in COMM_OPS:
            gsz = sorted({len(g) for g in s.groups})
            desc += ' groups=%dx%s bytes=%.0f' % (
                len(s.groups),
                gsz[0] if len(gsz) == 1 else tuple(gsz), s.nbytes)
            if times is not None:
                desc += '  %.3fus' % (1e6 * times[ci])
            ci += 1
        elif s.op == 'permute':
            desc += ' blocks=%d' % len(s.perm)
        lines.append(desc)
    return '\n'.join(lines)
