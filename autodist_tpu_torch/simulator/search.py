"""Candidate enumeration + ranking over the strategy builders.

Enumerates the existing builders (and their tunable knobs: AllReduce
chunk_size — which sets the gradient-bucket byte cap — the bf16-wire
and block-quantized int8-wire compressors, RING spec, and the
partitioned variants), prices each with
:mod:`cost_model`, prunes candidates whose predicted per-device peak
bytes exceed the memory budget, and returns the rest ranked by
predicted step time.

The ranking is deterministic: ties break on (peak bytes, name), and
``RandomAxisPartitionAR`` is seeded.

The port's copy of the JAX package's ``simulator/search.py``: the
builders are the port's (they build the same ``Strategy``), the pricing
is the copied cost model, so the same inputs rank the same names in the
same order.
"""
from dataclasses import dataclass

from autodist_tpu_torch.simulator import cost_model
from autodist_tpu_torch.utils import logging


@dataclass
class Candidate:
    """One priced strategy candidate."""
    name: str
    strategy: object = None
    report: object = None          # CostReport
    feasible: bool = True
    error: str = ''
    rank: int = -1                 # position after sorting (0 = best)

    @property
    def predicted_step_time_s(self):
        return self.report.predicted_step_time_s if self.report else None

    @property
    def predicted_peak_bytes(self):
        return self.report.predicted_peak_bytes if self.report else None


def default_candidates(chunk_sizes=(32, 128, 512),
                       local_steps=(2, 4, 8, 16)):
    """``[(name, builder_factory)]`` covering the nine builders + knobs.

    Factories (not instances): several builders carry per-build state
    (PS load maps), so each :func:`rank` call gets fresh ones.
    ``local_steps`` enumerates local-SGD windows on the PS plane
    (``PS(H=h)`` candidates; the plain ``PS`` entry is their H=1
    control) — H-fold wire amortization vs the divergence haircut, so
    the ranking flips to H>1 exactly where the link is weak enough.
    """
    from autodist_tpu_torch.strategy import builders as b
    cands = []
    for cs in chunk_sizes:
        cands.append(('AllReduce(chunk=%d)' % cs,
                      lambda cs=cs: b.AllReduce(chunk_size=cs)))
    cands += [
        ('AllReduce(bf16-wire)',
         lambda: b.AllReduce(compressor='HorovodCompressor')),
        # block-quantized int8 collectives (EQuARX tier): ~4x fewer
        # wire bytes than f32 at an extra quantize/requantize HBM cost
        # (CostModelParams.quant_s_per_byte) — wins when the link is
        # bandwidth-bound (DCN), loses on latency-bound ICI
        ('AllReduce(int8-wire)',
         lambda: b.AllReduce(compressor='Int8RingCompressor')),
        ('AllReduce(RING)', lambda: b.AllReduce(all_reduce_spec='RING')),
        # two-level schedule knob: 'always' forces hierarchical
        # emission wherever node groups exist (on a single-node spec
        # the schedule degenerates to the flat ring and the candidate
        # ties — flat wins the name tie-break); 'never' is the flat
        # control the multi-node A/B reads against
        ('AllReduce(hierarchical)',
         lambda: b.AllReduce(hierarchical='always')),
        ('AllReduce(flat-only)',
         lambda: b.AllReduce(hierarchical='never')),
        # cross-replica weight-update sharding (arXiv:2004.13336):
        # grad reduce-scatter + shard-local fused update + bucketed
        # param all-gather — same total wire as the all-reduce it
        # replaces, but the param gather is exposed (it cannot hide
        # behind backward) while opt slots drop to 1/n per device, so
        # the memory estimate lets budget pruning flip the rank on
        # HBM-tight configs (the default AllReduce candidates are its
        # replicated-update control)
        ('AllReduce(update-shard)',
         lambda: b.AllReduce(weight_update_sharding='always')),
        ('PartitionedAR', lambda: b.PartitionedAR()),
        ('RandomAxisPartitionAR',
         lambda: b.RandomAxisPartitionAR(seed=0)),
        ('Parallax', lambda: b.Parallax()),
        ('PS', lambda: b.PS()),
        ('PSLoadBalancing', lambda: b.PSLoadBalancing()),
        ('PartitionedPS', lambda: b.PartitionedPS()),
        ('UnevenPartitionedPS', lambda: b.UnevenPartitionedPS()),
    ]
    for h in local_steps:
        cands.append(('PS(H=%d)' % h,
                      lambda h=h: b.PS(local_steps=h)))
    return cands


def rank(graph_item, resource_spec, candidates=None,
         memory_budget_bytes=None, params=None, num_replicas=None,
         optimizer_slots=2, sparse_lookups_per_replica=4096,
         nodes=None):
    """Build + price every candidate; return (feasible, infeasible).

    ``feasible`` is sorted by (predicted step time, peak bytes, name)
    and each entry's ``strategy.cost`` carries the prediction summary.
    ``infeasible`` holds candidates pruned by the memory budget or whose
    build raised (with ``error`` set) — kept for the ranked table.
    ``nodes`` overrides the node-group count hierarchical pricing uses
    (None = derive from the spec; 1 = price everything flat).
    """
    if candidates is None:
        candidates = default_candidates()
    feasible, infeasible = [], []
    for name, factory in candidates:
        cand = Candidate(name=name)
        try:
            strategy = factory().build(graph_item, resource_spec)
            report = cost_model.predict(
                strategy, graph_item, resource_spec, params=params,
                num_replicas=num_replicas,
                optimizer_slots=optimizer_slots,
                sparse_lookups_per_replica=sparse_lookups_per_replica,
                nodes=nodes)
        except Exception as e:   # noqa: BLE001 - one bad candidate
            # must not kill the search (e.g. a builder that needs
            # devices this spec does not have)
            cand.feasible = False
            cand.error = '%s: %s' % (type(e).__name__, e)
            logging.warning('simulator: candidate %s failed to build '
                            '(%s)', name, cand.error)
            infeasible.append(cand)
            continue
        cand.strategy = strategy
        cand.report = report
        strategy.cost = dict(report.summary(), builder=name)
        if memory_budget_bytes is not None and \
                report.predicted_peak_bytes > memory_budget_bytes:
            cand.feasible = False
            cand.error = ('predicted peak %d B exceeds budget %d B'
                          % (report.predicted_peak_bytes,
                             memory_budget_bytes))
            infeasible.append(cand)
            continue
        feasible.append(cand)
    feasible.sort(key=lambda c: (c.report.predicted_step_time_s,
                                 c.report.predicted_peak_bytes, c.name))
    for i, c in enumerate(feasible):
        c.rank = i
        c.strategy.cost['rank'] = i
    return feasible, infeasible


# -- schedule-IR synthesis ---------------------------------------------

@dataclass
class ScheduleTopo:
    """A 3-tier topology schedule synthesis enumerates over.

    ``slices`` is one tuple per slice of per-host device counts —
    ``((4, 4), (4, 2))`` reads "2 slices; the second has a straggler
    host with 2 devices". Devices within a host ride ICI, hosts within
    a slice the ``host`` tier, slices the (slow) DCN tier. ``links``
    optionally overrides per-tier ``(alpha, beta)`` constants (merged
    over :func:`calibrate.tier_links`' derivation from the cost-model
    params)."""
    slices: tuple = ((1,),)
    links: dict = None

    def __post_init__(self):
        self.slices = tuple(tuple(int(g) for g in s)
                            for s in self.slices)

    @property
    def host_sizes(self):
        return tuple(g for s in self.slices for g in s)

    @property
    def slice_sizes(self):
        return tuple(sum(s) for s in self.slices)

    @property
    def num_devices(self):
        return sum(self.host_sizes)

    @property
    def uniform(self):
        hs = self.host_sizes
        return (len(set(hs)) == 1 and
                len({len(s) for s in self.slices}) == 1)


@dataclass
class ScheduleCandidate:
    """One priced + verified schedule-IR candidate."""
    name: str
    program: object = None
    handwritten: bool = True
    predicted_s: float = 0.0
    per_step_s: tuple = ()
    tier_bytes: dict = None
    staging_bytes: int = 0
    verify_s: float = 0.0
    feasible: bool = True
    error: str = ''
    rank: int = -1


def schedule_candidates(nbytes, dtype='float32', topo=None):
    """Enumerate IR programs for one ``nbytes`` gradient bucket over
    ``topo``: first the HAND-WRITTEN shapes ``plan.sync_gradients``
    can emit today (flat f32/bf16/int8 and, when every host splits
    equally, the two-level host schedule with its int8 tier boundary),
    then the SYNTHESIZED shapes only the IR reaches — wave two-level
    over unequal hosts (lifting ``num_node_groups``' equal-split
    requirement; the cost model prices the straggler's extra waves),
    two-level over slices, 3-level device/host/slice, and per-link
    wire assignment (int8 or bf16 only across the slow tier, f32
    inside). Returns ``[(name, program, handwritten)]``; shapes a
    builder rejects (e.g. 3-level on a non-uniform topo) are skipped.
    """
    from autodist_tpu_torch.parallel import schedule_ir as sir
    topo = topo or ScheduleTopo()
    n = topo.num_devices
    elems = max(1, int(nbytes) // sir.dtype_itemsize(dtype))
    raw = sir.wire_of_dtype(dtype)
    out = []

    def add(name, handwritten, build):
        try:
            prog = build()
        except ValueError:
            return
        prog.meta['handwritten'] = bool(handwritten)
        out.append((name, prog, handwritten))

    add('flat/f32', True,
        lambda: sir.flat_program(elems, dtype, n=n, name='flat/f32'))
    if raw == 'f32':
        add('flat/bf16', True,
            lambda: sir.flat_program(elems, dtype, wire='bf16', n=n,
                                     name='flat/bf16'))
        add('flat/i8', True,
            lambda: sir.flat_program(elems, dtype, wire='i8', n=n,
                                     name='flat/i8'))
    hs = topo.host_sizes
    equal = len(set(hs)) == 1
    if len(hs) > 1 and n > len(hs):
        pre, hand = ('two-level/hosts', True) if equal else \
            ('two-level/hosts/waves', False)
        add(pre + '/f32', hand,
            lambda: sir.two_level_program(elems, dtype, hs,
                                          name=pre + '/f32'))
        if raw == 'f32':
            add(pre + '/i8-dcn', hand,
                lambda: sir.two_level_program(
                    elems, dtype, hs, wires=(raw, 'i8'),
                    name=pre + '/i8-dcn'))
    ss = topo.slice_sizes
    if len(ss) > 1 and n > len(ss) and ss != hs:
        add('two-level/slices/f32', False,
            lambda: sir.two_level_program(
                elems, dtype, ss, tiers=('host', 'dcn'),
                name='two-level/slices/f32'))
        if raw == 'f32':
            add('two-level/slices/i8-dcn', False,
                lambda: sir.two_level_program(
                    elems, dtype, ss, tiers=('host', 'dcn'),
                    wires=(raw, 'i8'),
                    name='two-level/slices/i8-dcn'))
    if topo.uniform and len(topo.slices) > 1 and len(hs) > \
            len(topo.slices):
        s, h, g = len(topo.slices), len(topo.slices[0]), hs[0]
        add('three-level/f32', False,
            lambda: sir.three_level_program(elems, dtype, s, h, g,
                                            name='three-level/f32'))
        if raw == 'f32':
            add('three-level/i8-dcn', False,
                lambda: sir.three_level_program(
                    elems, dtype, s, h, g, wires=(raw, raw, 'i8'),
                    name='three-level/i8-dcn'))
            add('three-level/bf16-host-i8-dcn', False,
                lambda: sir.three_level_program(
                    elems, dtype, s, h, g,
                    wires=(raw, 'bf16', 'i8'),
                    name='three-level/bf16-host-i8-dcn'))
    return out


def rank_schedules(nbytes, dtype='float32', topo=None, params=None,
                   staging_budget_bytes=None, candidates=None):
    """Synthesize, VERIFY, and price IR schedules for one gradient
    bucket; returns ``(feasible, infeasible)``.

    Every feasible candidate passed the shape algebra
    (:func:`schedule_ir.verify` — a finding kills a candidate, so
    synthesis can never select a schedule that loses or double-counts
    elements) and is priced per step by
    :func:`cost_model.program_time` from the calibrated per-tier α-β
    (:func:`calibrate.tier_links`, overridden by ``topo.links``).
    ``staging_budget_bytes`` prunes on requantize/permute staging
    buffers. The ranking is deterministic: (predicted time, staging
    bytes, name)."""
    import time as _time
    from autodist_tpu_torch.parallel import schedule_ir as sir
    from autodist_tpu_torch.simulator import calibrate
    topo = topo or ScheduleTopo()
    if params is None:
        params = cost_model.CostModelParams()
    links = calibrate.tier_links(params)
    if topo.links:
        links.update(topo.links)
    if candidates is None:
        candidates = schedule_candidates(nbytes, dtype, topo)
    feasible, infeasible = [], []
    for name, prog, hand in candidates:
        cand = ScheduleCandidate(name=name, program=prog,
                                 handwritten=hand)
        t0 = _time.perf_counter()
        findings = sir.verify(prog)
        cand.verify_s = _time.perf_counter() - t0
        if findings:
            cand.feasible = False
            cand.error = findings[0]
            logging.warning('simulator: schedule candidate %s failed '
                            'verification (%s)', name, findings[0])
            infeasible.append(cand)
            continue
        total, per_step = cost_model.program_time(
            prog, params, links=links, per_step=True)
        cand.predicted_s = float(total)
        cand.per_step_s = tuple(per_step)
        cand.tier_bytes = cost_model.program_tier_bytes(prog)
        cand.staging_bytes = sir.staging_bytes(prog)
        if staging_budget_bytes is not None and \
                cand.staging_bytes > staging_budget_bytes:
            cand.feasible = False
            cand.error = ('staging %d B exceeds budget %d B'
                          % (cand.staging_bytes, staging_budget_bytes))
            infeasible.append(cand)
            continue
        feasible.append(cand)
    feasible.sort(key=lambda c: (c.predicted_s, c.staging_bytes,
                                 c.name))
    for i, c in enumerate(feasible):
        c.rank = i
    return feasible, infeasible


def best_schedules(feasible):
    """(best hand-written, best synthesized) of a ranked feasible
    list — either side None when its class produced no candidate."""
    hand = next((c for c in feasible if c.handwritten), None)
    synth = next((c for c in feasible if not c.handwritten), None)
    return hand, synth


def format_schedule_table(feasible, infeasible=()):
    """Ranked schedule-candidate table (the simulate CLI's
    --schedule-dump header)."""
    rows = []
    header = ('%-4s %-30s %12s %10s %6s %s'
              % ('#', 'schedule', 'pred (ms)', 'stage(KiB)', 'steps',
                 'tier bytes'))
    rows.append(header)
    rows.append('-' * len(header))
    for c in feasible:
        tiers = ' '.join('%s=%.0f' % (t, b)
                         for t, b in sorted((c.tier_bytes
                                             or {}).items()))
        rows.append('%-4d %-30s %12.4f %10.1f %6d %s'
                    % (c.rank, c.name, c.predicted_s * 1e3,
                       c.staging_bytes / 1024.0,
                       len(c.program.steps), tiers))
    for c in infeasible:
        rows.append('---  %-30s pruned: %s' % (c.name, c.error))
    return '\n'.join(rows)


def format_ranked_table(feasible, infeasible=()):
    """Human-readable ranked table (the simulate CLI's output)."""
    rows = []
    header = ('%-4s %-26s %14s %12s %8s %4s'
              % ('#', 'candidate', 'pred step (ms)', 'peak (MiB)',
                 'colls', 'H'))
    rows.append(header)
    rows.append('-' * len(header))
    for c in feasible:
        rows.append('%-4d %-26s %14.4f %12.1f %8d %4d'
                    % (c.rank, c.name,
                       c.report.predicted_step_time_s * 1e3,
                       c.report.predicted_peak_bytes / (1 << 20),
                       c.report.num_collectives,
                       getattr(c.report, 'local_steps', 1)))
    for c in infeasible:
        rows.append('---  %-26s pruned: %s' % (c.name, c.error))
    return '\n'.join(rows)
