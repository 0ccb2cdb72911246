"""Analytic α-β cost model for per-variable synchronizer choices.

The port's copy of the JAX package's ``simulator/cost_model.py``: the
wire bytes of a bucket, the calibrated constants (``CostModelParams``),
the weight-update-sharding and hierarchical decisions ``parallel/plan.py``
makes through, the per-entry and schedule-IR pricing, and the
whole-strategy prediction (``predict``, ``memory_footprint``) that
``AutoStrategy`` ranks by. It imports neither jax nor torch (the static
schedule comes from ``parallel/plan.py`` when a prediction asks for it);
only module paths and the dtype-width lookup (``_itemsize``, which knows
``bfloat16``) differ.

Grounded in the PCCL formulation (per-process-group collective cost as
α + β·bytes over link latency/bandwidth) and *Automatic Cross-Replica
Sharding of Weight Update in Data-Parallel Training* (when ZeRO-style
reduce-scatter + all-gather beats plain AllReduce):

- ring all-reduce of ``B`` bytes over ``n`` devices:
  ``2(n-1)·α + 2(n-1)/n · B·β``
- reduce-scatter or all-gather (the two ZeRO halves):
  ``(n-1)·α + (n-1)/n · B·β``

α comes from link latency (one hop per ring step), β = 1/bandwidth.
Which (α, β) pair applies — ICI or DCN — comes from the
:class:`~autodist_tpu_torch.resource_spec.Topology` hints: multi-node specs
price collectives at the DCN link (DP reduction is the cross-boundary
traffic; mesh.py keeps everything else on ICI).

The schedule being priced is NOT re-derived here: it is the exact
bucket/chunk layout the execution plan would emit, computed statically
by :func:`autodist_tpu_torch.parallel.plan.static_collective_schedule` —
same packing, same reverse-production ordering, same ZeRO chunking.
Grad-sync buckets other than the final one are assumed to overlap
backward compute and get an ``overlap_discount`` haircut; the
last-emitted bucket (the FIRST layers' gradients, produced when no
backward compute is left to hide behind) is always priced in full.
"""
from dataclasses import dataclass, field, asdict

import numpy as np

from autodist_tpu_torch.utils import logging


def _itemsize(dtype):
    from autodist_tpu_torch.parallel.schedule_ir import dtype_itemsize
    return dtype_itemsize(dtype)

#: Wire bytes per element by compressor (None = tensor's own itemsize).
#: HorovodCompressor casts f32→bf16 for the wire; Int8Ring ships int8
#: blocks plus one f32 scale per AUTODIST_QUANT_BLOCK elements (the
#: scale overhead is added by :func:`wire_bytes`, not folded in here).
#: PowerSGD's wire is rank-dependent and it never fuses — priced at
#: full bytes (None) as a conservative bound. Keys MUST cover the
#: compressor registry in :mod:`autodist_tpu_torch.parallel.compressor`
#: exactly — a compressor missing here would silently price as f32
#: (tools/check_wire_pricing.py is the tier-1 drift check).
_WIRE_ITEMSIZE = {
    'NoneCompressor': None,
    'HorovodCompressor': 2,
    'HorovodCompressorEF': 2,
    'Int8RingCompressor': 1,
    'PowerSGDCompressor': None,
}

#: Grad + optimizer-slot accounting assumptions: gradients match the
#: param dtype; optimizer slots are kept in f32 (optax default).
_OPT_SLOT_ITEMSIZE = 4


def wire_bytes(nbytes, dtype, compressor=None):
    """Bytes that actually cross the wire for a raw ``nbytes`` tensor.

    The block-quantized int8 tier additionally carries one f32 scale
    per ``AUTODIST_QUANT_BLOCK`` elements (the EQuARX blockscale
    header) — at the default block of 256 that is ~1.6% on top of the
    int8 payload, priced here so the 4x headline never overstates."""
    itemsize = _itemsize(dtype) if dtype is not None else 4
    wire = _WIRE_ITEMSIZE.get(compressor or 'NoneCompressor')
    if wire is None or wire >= itemsize:
        return int(nbytes)
    elems = int(nbytes) // itemsize
    out = elems * wire
    if compressor == 'Int8RingCompressor':
        from autodist_tpu_torch.parallel.compressor import quant_block_size
        out += 4 * (-(-elems // quant_block_size()))
    return out


@dataclass
class CostModelParams:
    """α-β constants (per link class) + overlap/compute assumptions.

    ``alpha_*`` is seconds per ring hop, ``beta_*`` seconds per byte.
    Defaults come from a :class:`Topology`'s bandwidth/latency hints;
    :mod:`calibrate` refines them from measured collective timelines.
    ``compute_time_s`` is an optional calibrated per-step compute
    estimate — 0 means "rank by sync cost alone", which preserves
    ordering (compute is strategy-invariant for a fixed model).
    """
    alpha_ici_s: float = 1e-6
    beta_ici_s_per_byte: float = 1e-11        # 100 GB/s
    alpha_dcn_s: float = 30e-6
    beta_dcn_s_per_byte: float = 8e-9         # 0.125 GB/s
    overlap_discount: float = 0.5             # hidden fraction of
    # overlappable grad-bucket time (latency-hiding scheduler)
    # Async-PS pull-ahead haircut (AUTODIST_PS_PIPELINE_DEPTH >= 2):
    # the fraction of PS param-phase traffic (the post-update re-gather
    # / next-step pull) the background pipeline hides behind the host
    # tail. Default 0 — predictions for the serial depth-1 plane stay
    # unchanged unless the caller opts in (tools/simulate.py
    # --ps-overlap, or a calibrated ps_stats overlap_frac).
    ps_overlap_discount: float = 0.0
    compute_time_s: float = 0.0
    # compressors are not free: the wire cast reads+writes the full
    # tensor at HBM speed on both ends (~800 GB/s, two passes)
    compress_s_per_byte: float = 2.5e-12
    # block quantization costs MORE than a cast: the max-abs scan, the
    # scale divide and the per-hop requantization of the int8 ring are
    # extra HBM passes over the bucket (~2 additional round trips).
    # Added ON TOP of compress_s_per_byte for Int8RingCompressor
    # entries — this is what lets a bandwidth-rich ICI topology
    # correctly REJECT the int8 tier while a DCN-bound one picks it.
    quant_s_per_byte: float = 5.0e-12
    # Two-level (hierarchical) schedules pay a tier-boundary cost the
    # flat ring does not: the re-layout between the intra-node
    # reduce-scatter and the inter-node phase (and, under the int8
    # wire, the boundary requantization) is an extra HBM round trip
    # over the bucket. Priced per RAW byte, like compress_s_per_byte —
    # this is what keeps flat the winner on topologies whose "DCN"
    # is as fast as ICI (single fat switch), where the two extra
    # phases buy nothing.
    hier_boundary_s_per_byte: float = 2.5e-12
    # What one byte of freed per-device HBM is worth in step-time
    # seconds — the exchange rate choose_update_sharding prices the
    # weight-update-sharding trade with (arXiv:2112.01075's point:
    # price the extra all-gather against the freed memory instead of
    # hard-coding the choice). Sharding the update frees
    # ~(n-1)/n of the opt-slot bytes but exposes the param all-gather
    # (it cannot hide behind backward compute the way grad buckets
    # do). The default is calibrated so an ICI-rich mesh (where wire
    # time is cheap and HBM is the binding resource — the paper's TPU
    # pod setting) shards, while a DCN-bound link (where the exposed
    # gather is expensive) keeps the replicated update. Freed HBM
    # also feeds back mechanically: the memory estimate drops sharded
    # slots to 1/n, so AutoStrategy's budget pruning unlocks sharded
    # candidates (and thus bigger batches) on tight budgets.
    freed_hbm_s_per_byte: float = 4e-12
    # Local-SGD divergence haircut (docs/design/local-sgd.md): each
    # EXTRA local step in an H-step window lets worker copies drift
    # before the averaged merge, which costs statistical efficiency —
    # modeled as (H-1) x bytes x this rate added to the per-step cost
    # of every PS sync entry whose vars ride the window. Calibrated so
    # the H enumeration flips where it should: on a weak-DCN link the
    # H-fold wire amortization (~nbytes x beta_dcn x (1-1/H)) dwarfs
    # the penalty and H in {8,16} wins, while on pure ICI the saved
    # wire (~nbytes x beta_ici) is SMALLER than one extra step's
    # penalty and H=1 stays the winner. Divergence is a per-window
    # statistical cost, not a wall-clock one — pricing it as pseudo-
    # seconds keeps the ranking one-dimensional, exactly like
    # freed_hbm_s_per_byte's exchange rate above.
    local_sgd_divergence_s_per_byte: float = 5e-11
    calibrated: bool = False

    @classmethod
    def from_topology(cls, topology):
        ici_bw, ici_lat = topology.link(cross_node=False)
        dcn_bw, dcn_lat = topology.link(cross_node=True)
        return cls(alpha_ici_s=ici_lat,
                   beta_ici_s_per_byte=1.0 / ici_bw,
                   alpha_dcn_s=dcn_lat,
                   beta_dcn_s_per_byte=1.0 / dcn_bw)

    def link(self, cross_node=False):
        """(α seconds/hop, β seconds/byte) for one link class."""
        if cross_node:
            return self.alpha_dcn_s, self.beta_dcn_s_per_byte
        return self.alpha_ici_s, self.beta_ici_s_per_byte

    def to_dict(self):
        return asdict(self)

    @classmethod
    def from_dict(cls, d):
        import dataclasses
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def collective_time(kind, nbytes, n, alpha, beta):
    """Predicted seconds for ONE collective of ``nbytes`` wire bytes
    over an ``n``-way group with link constants (α, β).

    Kinds follow the schedule schema: ``all_reduce`` (ring: reduce-
    scatter phase + all-gather phase), ``psum_scatter`` /
    ``sparse_scatter`` (reduce-scatter half), ``all_gather`` /
    ``sparse_all_gather`` (all-gather half).
    """
    n = int(n)
    if n <= 1:
        return 0.0
    nbytes = float(nbytes)
    if kind == 'all_reduce':
        return 2 * (n - 1) * alpha + 2 * (n - 1) / n * nbytes * beta
    if kind in ('psum_scatter', 'all_gather', 'sparse_scatter',
                'sparse_all_gather'):
        return (n - 1) * alpha + (n - 1) / n * nbytes * beta
    raise ValueError('Unknown collective kind %r' % (kind,))


def hierarchical_time(nbytes, n, nodes, params, ici_bytes=None):
    """Predicted seconds for a TWO-LEVEL all-reduce of ``nbytes`` wire
    bytes over ``n`` devices grouped into ``nodes`` node groups of
    ``g = n/nodes`` devices each (PCCL-style process-group synthesis):

    - intra-node reduce-scatter + all-gather: ``2(g-1)`` ICI hops
      moving ``(g-1)/g·B_ici`` each phase,
    - inter-node all-reduce of the owned ``B/g`` chunk over one
      representative per node: ``2(k-1)`` DCN hops at ``2(k-1)/k·B/g``
      bytes,
    - plus the tier-boundary re-layout/requantize HBM pass
      (``hier_boundary_s_per_byte``, charged on the intra-tier bytes).

    ``ici_bytes`` is the byte count the INTRA phases actually move
    when it differs from the cross-node wire: the int8 schedule
    quantizes only at the tier boundary, so its ICI phases ride the
    full f32 payload while the DCN phase rides the int8 wire
    (default: same as ``nbytes``).

    The degenerate shapes collapse to the flat formulas: ``nodes=1``
    is a pure-ICI ring, ``nodes=n`` a pure-DCN ring (plus the
    boundary term, which is why flat stays preferred there).
    """
    n = int(n)
    k = max(1, int(nodes))
    if n <= 1:
        return 0.0
    nbytes = float(nbytes)
    ici = nbytes if ici_bytes is None else float(ici_bytes)
    a_i, b_i = params.link(cross_node=False)
    a_d, b_d = params.link(cross_node=True)
    g = max(1, n // k)
    t = 2.0 * (g - 1) * a_i + 2.0 * (g - 1) / g * ici * b_i
    if k > 1:
        t += 2.0 * (k - 1) * a_d + \
            2.0 * (k - 1) / k * (nbytes / g) * b_d
        t += ici * params.hier_boundary_s_per_byte
    return t


def hierarchical_half_time(nbytes, n, nodes, params, ici_bytes=None):
    """Predicted seconds for ONE two-level HALF (a reduce-scatter or an
    all-gather) over ``n`` devices in ``nodes`` node groups.

    :func:`hierarchical_time` is phase-symmetric (each tier's
    reduce-scatter and all-gather phases move the same bytes, and the
    boundary HBM pass splits evenly between the two halves), so a half
    is exactly half of the full two-level all-reduce — which keeps
    RS + AG == AR, the same identity the flat formulas satisfy, and
    means :func:`choose_hierarchical` is THE decision for halves too:
    flat-half beats hier-half exactly when flat AR beats hier AR.
    Used for the hierarchical ZeRO scatter/gather halves and the
    weight-update-sharding schedule's bucket halves.
    """
    return 0.5 * hierarchical_time(nbytes, n, nodes, params,
                                   ici_bytes=ici_bytes)


#: f32 optimizer-slot tensors per parameter by captured optimizer name
#: (autodist_tpu_torch.frontend.optimizers capture tuples). Used to size the
#: freed-memory credit choose_update_sharding prices; unknown names
#: fall back to the Adam-shaped default (2) — over-estimating the
#: credit merely shards a low-state optimizer's update early, which
#: costs one exposed all-gather, never correctness.
_SLOTS_BY_OPTIMIZER = {
    'SGD': 1, 'GradientDescent': 1, 'Momentum': 1, 'LazyMomentum': 1,
    'Adagrad': 1, 'RMSProp': 2, 'Adadelta': 2,
    'Adam': 2, 'AdamW': 2, 'LazyAdam': 2, 'Nadam': 2, 'Adamax': 2,
    'LAMB': 2, 'Ftrl': 2,
}


def optimizer_slot_count(graph_item, default=2):
    """f32 slot tensors per param for the graph's captured optimizers
    (the max across them — one shared placement serves every var).

    Reads the frontend graph's optimizer capture when present
    (``graph_item.graph.optimizers``); pytree graph items (no captured
    optimizer) and unknown names use ``default``. A plain SGD capture
    with momentum 0 counts 0 (optax.sgd keeps no slot state then).
    """
    g = getattr(graph_item, 'graph', None)
    caps = list(getattr(g, 'optimizers', None) or ()) if g is not None \
        else []
    if not caps:
        return default
    out = 0
    for cap in caps:
        name, _, kwargs = (tuple(cap) + ((), {}))[:3]
        slots = _SLOTS_BY_OPTIMIZER.get(name, default)
        if name in ('SGD', 'GradientDescent') and \
                not (kwargs or {}).get('momentum'):
            slots = 0
        out = max(out, slots)
    return out


def choose_update_sharding(nbytes, dtype, compressor, n, params,
                           knob='never', opt_slots=2, cross_node=False,
                           spec='AUTO'):
    """THE per-bucket replicated-vs-sharded weight-update decision,
    shared by ``plan.sync_gradients`` (trace-time emission and slot
    placement) and ``plan.static_collective_schedule`` so the two can
    never drift.

    Returns True when the bucket's post-sync optimizer update should
    shard across replicas (reduce-scatter + shard-local fused update +
    bucketed param all-gather, arXiv:2004.13336) instead of running
    replicated after a plain all-reduce. Replicated stays the emission
    (False) on single-replica meshes, compressed wires (the RS/AG
    halves would need the compressor's reduction semantics on both
    phases — only the uncompressed f32/native wire shards), forced
    RING specs (an explicit flat-ring request — RS/AG would drop the
    forced ppermute emission), ``knob='ineligible'`` (sparse-read /
    row-lazy variables: the flat 1/n shard layout cannot preserve
    row-lazy update semantics, so VarPlan marks them ineligible and
    not even the env override shards them), and ``knob='never'`` (the
    legacy default). 'always' forces it; 'auto' shards when the freed
    opt-slot HBM (``opt_slots`` f32 slots x (n-1)/n of the params),
    valued at ``params.freed_hbm_s_per_byte``, outweighs the newly
    *exposed* wire time — the param all-gather runs after the update
    and cannot hide behind backward compute, so the exposure is the
    overlap haircut the replaced all-reduce would have enjoyed (the
    reduce-scatter half stays in the backward and keeps it). The last-emitted
    grad bucket gets no haircut in either schedule, so for it the true
    exposure delta is zero and this per-bucket decision (which cannot
    know emission position — the same call marks slot placement before
    any trace) overstates the cost: a deliberate conservatism that
    only errs toward the legacy replicated update, and only matters
    for models whose gradients pack into a single bucket ('always'
    overrides it).

    The ``AUTODIST_WEIGHT_UPDATE_SHARDING`` env knob overrides the
    strategy knob globally (it is forwarded to workers: the schedule
    is part of the traced program, and divergent HLO across SPMD
    hosts deadlocks).
    """
    from autodist_tpu_torch.const import ENV
    if (knob or 'never') == 'ineligible':
        return False
    forced = ENV.AUTODIST_WEIGHT_UPDATE_SHARDING.val
    knob = forced or knob or 'never'
    n = int(n)
    if n <= 1 or (compressor or 'NoneCompressor') != 'NoneCompressor':
        return False
    if spec == 'RING' or knob == 'never':
        return False
    if knob == 'always':
        return True
    wb = wire_bytes(nbytes, dtype, compressor)
    alpha, beta = params.link(cross_node=cross_node)
    exposed_extra = params.overlap_discount * 0.5 * collective_time(
        'all_reduce', wb, n, alpha, beta)
    itemsize = _itemsize(dtype) if dtype is not None else 4
    elems = int(nbytes) // itemsize
    freed = opt_slots * _OPT_SLOT_ITEMSIZE * elems * (n - 1) / n
    return freed * params.freed_hbm_s_per_byte >= exposed_extra


def choose_hierarchical(nbytes, dtype, compressor, n, nodes, params,
                        knob='auto', spec='AUTO'):
    """THE per-bucket flat-vs-two-level decision, shared by
    ``plan.sync_gradients`` (trace-time emission) and
    ``plan.static_collective_schedule`` so the
    predicted and traced schedules can never drift.

    Returns True when the bucket should ride the hierarchical
    schedule. Flat stays the emission (False) on single-node meshes
    (``nodes <= 1``), non-dividing group layouts, one-device groups
    (``g == 1`` degenerates to the flat DCN ring), forced RING specs
    (an explicit flat-ring request), and whenever the two-tier α-β
    prediction does not beat the flat ring priced at the DCN link —
    so existing single-node behavior is the degenerate case.
    """
    n = int(n)
    nodes = int(nodes or 0)
    if n <= 1 or nodes <= 1 or n % nodes or n // nodes <= 1:
        return False
    if spec == 'RING' or knob == 'never':
        return False
    if knob == 'always':
        return True
    wb = wire_bytes(nbytes, dtype, compressor)
    # the int8 schedule requantizes ONLY at the tier boundary: its
    # intra-node phases move the full (raw f32) payload on ICI while
    # the DCN phase rides the int8 wire
    ici_b = nbytes if compressor == 'Int8RingCompressor' else wb
    a_d, b_d = params.link(cross_node=True)
    flat = collective_time('all_reduce', wb, n, a_d, b_d)
    return hierarchical_time(wb, n, nodes, params,
                             ici_bytes=ici_b) < flat


#: fallback reasons already warned about this process — the decision
#: is re-made per bucket, and one line per node SHAPE (not per call)
#: is what an operator can read.
_UNEQUAL_WARNED = set()


def _warn_hier_fallback(reason):
    if reason and reason not in _UNEQUAL_WARNED:
        _UNEQUAL_WARNED.add(reason)
        logging.warning('hierarchical schedule falls back to flat: %s',
                        reason)


def num_node_groups_with_reason(strategy=None, resource_spec=None,
                                num_replicas=None):
    """``(k, reason)``: the node-group count plus, when the host layout
    forced the flat fallback, a one-line machine-readable reason naming
    the node shape (e.g. ``unequal-hosts:hostA=4,hostB=2``). ``reason``
    is None whenever the returned count is a genuine hierarchy (or the
    mesh is single-host, where flat is not a degradation). The reason
    rides the static schedule entries (``hier_fallback``) so a priced
    flat win stays distinguishable from a layout that could not go
    two-level — and :mod:`simulator.search` can still synthesize an
    unequal-group IR schedule for exactly these shapes."""
    from autodist_tpu_torch.const import ENV
    forced = ENV.AUTODIST_HIERARCHY_NODES.val
    if forced and forced >= 2:
        n = int(num_replicas or 0)
        if n and n % forced == 0 and n // forced >= 2:
            return forced, None
        return 1, 'forced-nodes:%d does not split n=%d' % (forced, n)
    hosts = []
    replicas = list(strategy.graph_config.replicas) if strategy and \
        strategy.graph_config.replicas else []
    if replicas:
        hosts = [d.rsplit(':', 2)[0] for d in replicas]
    elif resource_spec is not None:
        per_node = resource_spec.node_accelerator_devices or \
            {a: [a] for a in resource_spec.nodes}
        hosts = [h for h, devs in per_node.items() for _ in devs]
    if not hosts:
        return 1, None
    counts = {}
    for h in hosts:
        counts[h] = counts.get(h, 0) + 1
    k = len(counts)
    n = int(num_replicas or len(hosts))
    if k <= 1:
        return 1, None
    shape = ','.join('%s=%d' % (h, c) for h, c in counts.items())
    if len(set(counts.values())) != 1:
        return 1, 'unequal-hosts:%s' % shape
    if n % k:
        return 1, 'replicas:%d not divisible by hosts:%d (%s)' \
            % (n, k, shape)
    return k, None


def num_node_groups(strategy=None, resource_spec=None, num_replicas=None):
    """Node-group count for hierarchical pricing: distinct hosts among
    the strategy's replica devices (the same host-major order the mesh
    builder lays devices out in), falling back to the spec's
    accelerator-bearing node count. Returns 1 (flat) when the layout
    is not an EQUAL split — every host must contribute the same number
    of replica devices and that size must divide the replica count,
    mirroring ``mesh.data_axis_node_groups``'s equal-group requirement
    so pricing never assumes a two-level schedule the trace would
    refuse to emit. The ``AUTODIST_HIERARCHY_NODES`` override takes
    the same precedence it does at trace time — under the override the
    emission groups by it regardless of the spec's host layout, and
    pricing must describe the program that actually runs. A silent
    degrade is indistinguishable from a priced flat win, so the flat
    fallback logs a one-line warning naming the node shape (once per
    shape; :func:`num_node_groups_with_reason` exposes the reason)."""
    k, reason = num_node_groups_with_reason(strategy, resource_spec,
                                            num_replicas)
    _warn_hier_fallback(reason)
    return k


def entry_time(e, n, params, cross_node=False):
    """Predicted seconds (pre-overlap) + wire bytes for ONE schedule
    entry — the per-entry pricing :func:`predict` sums and the
    roofline observatory's drift table compares achieved timings
    against (:mod:`autodist_tpu_torch.telemetry.roofline`), factored out so
    the two can never price the same entry differently.

    Returns ``(seconds, wire_bytes)``. Two-level (``hier``) entries
    ride :func:`hierarchical_time`/:func:`hierarchical_half_time`
    (int8 buckets' intra phases at raw f32 bytes); compressed wires
    pay the cast/quantize HBM passes on top.
    """
    wb = wire_bytes(e['bytes'], e['dtype'], e.get('compressor'))
    hier = int(e.get('hier', 0))
    alpha, beta = params.link(cross_node=cross_node)
    if hier > 1 and e['kind'] == 'all_reduce':
        # two-level schedule: ICI phases + DCN phase + boundary.
        # int8 buckets quantize only at the tier boundary, so
        # their intra phases move the raw f32 bytes on ICI.
        ici_b = e['bytes'] \
            if e.get('compressor') == 'Int8RingCompressor' else wb
        t = hierarchical_time(wb, n, hier, params, ici_bytes=ici_b)
    elif hier > 1 and e['kind'] in ('psum_scatter', 'all_gather'):
        # a two-level ZeRO / update-sharding HALF: exactly half of
        # the two-level all-reduce (phase symmetry), so the same
        # choose_hierarchical decision applies
        t = hierarchical_half_time(wb, n, hier, params)
    else:
        t = collective_time(e['kind'], wb, n, alpha, beta)
    if wb < e['bytes']:   # compressor cast: two HBM passes per end
        t += e['bytes'] * params.compress_s_per_byte
    if e.get('compressor') == 'Int8RingCompressor':
        # block quantization: max-abs scan + scale divide + the
        # ring's per-hop requantization — extra HBM passes
        t += e['bytes'] * params.quant_s_per_byte
    return t, wb


#: schedule-IR tier ladder, fastest link first (mirrors
#: parallel.schedule_ir.TIER_ORDER — kept local to avoid importing the
#: IR module at pricing time).
_IR_TIER_ORDER = {'local': 0, 'ici': 1, 'host': 2, 'dcn': 3}


def program_links(params, links=None):
    """Per-tier ``(α, β)`` link constants for :func:`program_time`.

    Two-link topologies map the IR's four tiers onto the calibrated
    pair: ``ici`` rides the fast link, ``host`` and ``dcn`` the slow
    one, ``local`` is free. A 3-level topology (distinct host- and
    slice-crossing links) passes ``links`` overrides per tier —
    :class:`simulator.search.ScheduleTopo` carries them."""
    out = {'local': (0.0, 0.0),
           'ici': params.link(cross_node=False),
           'host': params.link(cross_node=True),
           'dcn': params.link(cross_node=True)}
    if links:
        out.update(links)
    return out


def program_time(program, params, links=None, per_step=False):
    """Predicted seconds for a schedule-IR :class:`Program`, priced
    per step from the SAME α-β constants :func:`entry_time` uses —
    for the hand-written shapes (flat ring, equal two-level, the
    ZeRO/WUS halves) this reproduces :func:`collective_time` /
    :func:`hierarchical_time` / :func:`hierarchical_half_time`
    exactly, which is what lets synthesized programs rank against
    legacy entries on one scale.

    Per comm step the time is the MAX over its device groups (groups
    run concurrently; the straggler group of an unequal split sets the
    step's pace — waves are separate steps and sum sequentially).
    Each adjacent pair of comm steps on DIFFERENT tiers charges half a
    tier-boundary re-layout pass (``hier_boundary_s_per_byte`` on the
    faster-tier step's bytes — two transitions recover the full
    boundary term of :func:`hierarchical_time`). Requantize steps
    charge the cast HBM passes (plus the quantization passes when an
    int8 wire is involved) at half the per-entry rate each, so a
    down+up pair prices exactly like the compressor charges in
    :func:`entry_time`.

    ``per_step=True`` returns ``(total, [seconds per comm step])`` —
    the list excludes the boundary/requantize overheads (they are
    between-step costs), so ``total >= sum(list)``.
    """
    link = program_links(params, links)
    times = []
    total = 0.0
    prev_tier = None
    prev_nbytes = 0.0
    cur_wire = None
    raw = float(program.meta.get('raw_bytes') or
                program.elems * _itemsize(program.dtype))
    for s in program.steps:
        if s.op == 'requantize':
            extra = 0.5 * raw * params.compress_s_per_byte
            if 'i8' in (s.wire, cur_wire):
                extra += 0.5 * raw * params.quant_s_per_byte
            total += extra
            cur_wire = s.wire
            continue
        if s.op not in ('reduce_scatter', 'all_reduce', 'all_gather'):
            continue
        alpha, beta = link[s.tier]
        factor = 2.0 if s.op == 'all_reduce' else 1.0
        t = 0.0
        for g in s.groups:
            gs = len(g)
            if gs <= 1:
                continue
            t = max(t, factor * (gs - 1) * alpha +
                    factor * (gs - 1) / gs * float(s.nbytes) * beta)
        if prev_tier is not None and s.tier != prev_tier:
            # tier boundary: half a re-layout HBM pass per crossing,
            # charged on the faster tier's payload (the buffer that
            # gets re-laid-out lives at the fast tier's width)
            fast = s.nbytes if _IR_TIER_ORDER.get(s.tier, 1) < \
                _IR_TIER_ORDER.get(prev_tier, 1) else prev_nbytes
            total += 0.5 * float(fast) * params.hier_boundary_s_per_byte
        prev_tier, prev_nbytes = s.tier, float(s.nbytes)
        times.append(t)
        total += t
    return (total, times) if per_step else total


def program_tier_bytes(program):
    """Wire bytes a schedule-IR program moves per tier — the
    worst-case single device's traffic (max over each step's groups,
    the figure a link is actually sized against), summed over steps.
    Ring accounting matches :func:`collective_time`: an all-reduce
    moves ``2(g-1)/g`` of its payload, a half moves ``(g-1)/g``."""
    out = {}
    for s in program.steps:
        if s.op not in ('reduce_scatter', 'all_reduce', 'all_gather'):
            continue
        factor = 2.0 if s.op == 'all_reduce' else 1.0
        b = 0.0
        for g in s.groups:
            gs = len(g)
            if gs <= 1:
                continue
            b = max(b, factor * (gs - 1) / gs * float(s.nbytes))
        if b:
            out[s.tier] = out.get(s.tier, 0.0) + b
    return out


def strategy_local_steps(strategy):
    """The program-wide local-SGD window length H a strategy requests:
    the min over its PS synchronizers' ``local_steps`` (mirroring
    ``ExecutionPlan``'s mixed->min collapse — the step is one program,
    so the tightest window applies), 1 when the strategy has no PS
    vars. Legacy strategies (no ``local_steps`` attribute) read 1."""
    hs = []
    for node in strategy.node_config:
        syncs = node.part_config if node.part_config \
            else [node.synchronizer]
        for s in syncs:
            if getattr(s, 'kind', '') == 'PS':
                hs.append(max(1, int(getattr(s, 'local_steps', 1)
                                     or 1)))
    return min(hs) if hs else 1


def _ps_var_names(strategy):
    """Names of variables synced through the PS plane (any shard)."""
    out = set()
    for node in strategy.node_config:
        syncs = node.part_config if node.part_config \
            else [node.synchronizer]
        if any(getattr(s, 'kind', '') == 'PS' for s in syncs):
            out.add(node.var_name)
    return out


def serve_wire_cost(dense_bytes, params=None, replicas=1, poll_hz=2.0,
                    qps=0.0, rows_per_query=0, row_bytes=0,
                    row_cache_hit_rate=0.0, compressor=None,
                    dtype=np.float32):
    """Serve-side wire model of the read-only replica fleet.

    A serving replica costs the training plane exactly its wire
    traffic (it holds no fence, votes in no gate): each replica pulls
    the whole dense model once per accepted poll (``poll_hz``, the
    ``AUTODIST_SERVE_POLL_S`` cadence upper bound — rejected polls
    move counters, not tensors) and the fleet's row-cache MISSES
    (``qps × rows_per_query × (1 − hit_rate)``) fetch embedding rows
    on demand. Both ride the DCN link class — replicas live outside
    the pod.

    Returns a dict: ``snapshot_wire_bytes`` (one pull, after the
    optional wire cast — the bf16/int8 tier halves/quarters the bulk
    pull exactly like a push), ``snapshot_pull_s`` (α-β time of one
    pull), ``snapshot_bytes_per_s`` / ``row_bytes_per_s`` /
    ``serve_bytes_per_s`` (fleet aggregates), and ``dcn_link_frac`` —
    the fraction of ONE DCN link's bandwidth the fleet consumes, the
    number an operator sizes ``replicas × poll_hz`` against so serving
    never eats the training cohort's sync budget.
    """
    params = params or CostModelParams()
    snap_wire = wire_bytes(int(dense_bytes), dtype, compressor)
    pull_s = params.alpha_dcn_s + snap_wire * params.beta_dcn_s_per_byte
    snap_rate = float(replicas) * float(poll_hz) * snap_wire
    miss_rows = float(qps) * float(rows_per_query) \
        * max(0.0, 1.0 - float(row_cache_hit_rate))
    row_rate = miss_rows * wire_bytes(int(row_bytes), dtype, compressor)
    total = snap_rate + row_rate
    return {
        'replicas': int(replicas),
        'snapshot_wire_bytes': snap_wire,
        'snapshot_pull_s': pull_s,
        'snapshot_bytes_per_s': snap_rate,
        'row_bytes_per_s': row_rate,
        'serve_bytes_per_s': total,
        'dcn_link_frac': total * params.beta_dcn_s_per_byte,
    }


@dataclass
class CostReport:
    """Per-strategy prediction: step time, sync decomposition, memory."""
    predicted_step_time_s: float = 0.0
    sync_time_s: float = 0.0           # raw (no-overlap) collective sum
    exposed_sync_time_s: float = 0.0   # after the overlap haircut
    predicted_peak_bytes: int = 0
    num_collectives: int = 0
    num_replicas: int = 1
    cross_node: bool = False
    # local-SGD window length the priced strategy syncs at (H): PS wire
    # terms above are per-STEP averages (the per-round cost / H)
    local_steps: int = 1
    # every priced schedule entry's IR program passed the shape
    # algebra (schedule_ir.verify) — a False here means the prediction
    # priced a schedule that loses or double-counts elements
    schedule_verified: bool = False
    memory: dict = field(default_factory=dict)
    breakdown: list = field(default_factory=list)

    def to_dict(self):
        return asdict(self)

    def summary(self):
        """Compact dict for Strategy.cost / bench records."""
        return {
            'predicted_step_time_s': self.predicted_step_time_s,
            'predicted_peak_bytes': self.predicted_peak_bytes,
            'sync_time_s': self.sync_time_s,
            'num_collectives': self.num_collectives,
            'num_replicas': self.num_replicas,
            'local_steps': self.local_steps,
            'schedule_verified': self.schedule_verified,
        }


def memory_footprint(strategy, graph_item, num_replicas,
                     optimizer_slots=2, schedule=None):
    """Per-device peak-bytes estimate for a strategy.

    Components: params + grads (param dtype), optimizer slots (f32,
    ``optimizer_slots`` per param — 2 for Adam's mu/nu, 1 for momentum
    SGD, 0 for plain SGD), and bucket staging (the largest grad bucket's
    concat input + reduced output live simultaneously). Opt-slot bytes
    are LAYOUT-aware: any variable whose schedule reduce-scatters its
    gradient to a shard owner — ZeRO-sharded (partitioned PS) variables
    AND weight-update-sharded AR buckets — keeps only 1/n of its slot
    (and resident-grad) bytes per device, so budget pruning stops
    rejecting sharded-update configs that actually fit. Every replica
    still materializes the FULL gathered param for compute, which
    params counts at full size.
    """
    from autodist_tpu_torch.parallel.plan import static_collective_schedule
    n = max(1, int(num_replicas))
    if schedule is None:
        schedule = static_collective_schedule(strategy, graph_item, n)
    sharded = set()
    for e in schedule:
        if e['kind'] in ('psum_scatter', 'sparse_scatter'):
            sharded.update(e['members'])
    params_b = grads_b = opt_b = 0
    for var in graph_item.trainable_var_op_to_var.values():
        itemsize = _itemsize(var.dtype)
        size = int(np.prod(var.shape or (1,)))
        nbytes = size * itemsize
        frac = 1.0 / n if var.name in sharded and n > 1 else 1.0
        # the gathered full param is live during compute regardless
        params_b += nbytes
        grads_b += int(nbytes * frac)
        opt_b += int(size * _OPT_SLOT_ITEMSIZE * optimizer_slots * frac)
    # staging: a multi-var bucket's concat input + collective output
    # coexist — for the all-reduce buckets AND the update-sharding
    # reduce-scatter buckets (same concat, scattered output)
    max_bucket = max(
        [e['bytes'] for e in schedule
         if e['kind'] in ('all_reduce', 'psum_scatter')
         and e['vars'] > 1] or [0])
    staging_b = 2 * max_bucket
    total = params_b + grads_b + opt_b + staging_b
    return {'params_bytes': params_b, 'grads_bytes': grads_b,
            'optimizer_bytes': opt_b, 'bucket_staging_bytes': staging_b,
            'total_bytes': total}


def predict(strategy, graph_item, resource_spec=None, params=None,
            num_replicas=None, optimizer_slots=2,
            sparse_lookups_per_replica=4096, nodes=None):
    """Price a built strategy: predicted step time + per-device memory.

    Args:
        strategy: a built :class:`Strategy`.
        graph_item: the GraphItem it was built against (only shapes and
            sparsity are read — nothing runs).
        resource_spec: supplies the topology (α-β defaults) and, when
            ``num_replicas`` is not given, the replica count. Optional
            when both ``params`` and ``num_replicas`` are passed.
        params: :class:`CostModelParams` override (e.g. calibrated).
        optimizer_slots: f32 slot tensors per param for the memory
            estimate (2 = Adam, 1 = momentum, 0 = SGD).
        nodes: node-group count for hierarchical (two-level) schedule
            decisions; None derives it from the strategy's replica
            hosts / the spec (``num_node_groups``). 1 forces flat-only
            pricing.

    Returns a :class:`CostReport`.
    """
    from autodist_tpu_torch.parallel.plan import static_collective_schedule
    if num_replicas is None:
        num_replicas = len(strategy.graph_config.replicas)
        if not num_replicas and resource_spec is not None:
            num_replicas = max(1, resource_spec.num_accelerators)
    n = max(1, int(num_replicas))
    cross_node = False
    if params is None:
        if resource_spec is None:
            raise ValueError('predict() needs resource_spec or params')
        params = CostModelParams.from_topology(resource_spec.topology)
    if resource_spec is not None:
        cross_node = resource_spec.topology.multi_node
    hier_fallback = None
    if nodes is None:
        nodes, hier_fallback = num_node_groups_with_reason(
            strategy, resource_spec, n)
        _warn_hier_fallback(hier_fallback)

    schedule = static_collective_schedule(
        strategy, graph_item, n,
        sparse_lookups_per_replica=sparse_lookups_per_replica,
        nodes=nodes, params=params, hier_fallback=hier_fallback)
    breakdown = []
    sync = 0.0
    # grad-phase buckets that ride the backward: all-reduce buckets
    # AND the update-sharding reduce-scatter halves (the RS replaces
    # an AR bucket in the same backward position, so it keeps the same
    # overlap haircut — the exposure choose_update_sharding assumes:
    # only the param all-gather is newly exposed)
    grad_ar = [i for i, e in enumerate(schedule)
               if e['phase'] == 'grad' and
               (e['kind'] == 'all_reduce' or
                (e.get('wus') and e['kind'] == 'psum_scatter'))]
    last_grad_ar = grad_ar[-1] if grad_ar else -1
    # local-SGD amortization (docs/design/local-sgd.md): PS-synced vars
    # under an H-step window ship once per H steps, so their per-step
    # wire price is the per-round cost / H plus the window-averaging
    # HBM pass (amortized) plus the (H-1)-step divergence haircut.
    # Only entries wholly made of PS vars amortize — AR buckets in a
    # mixed (Parallax-style) strategy still sync every step.
    local_h = strategy_local_steps(strategy)
    ps_vars = _ps_var_names(strategy) if local_h > 1 else set()
    exposed = 0.0
    for i, e in enumerate(schedule):
        t, wb = entry_time(e, n, params, cross_node=cross_node)
        hier = int(e.get('hier', 0))
        # grad buckets before the last-emitted one overlap backward
        # compute; ZeRO scatters are conservatively priced in full.
        # Param-phase traffic (the post-update re-gather — the static
        # analog of the loose-mode next-step pull) takes the optional
        # async-PS haircut so AutoStrategy predictions stay honest for
        # PS strategies once the pipelined data plane hides that wire
        # time (ps_overlap_discount defaults to 0 = serial plane).
        overlappable = (i in grad_ar and i != last_grad_ar)
        if overlappable:
            t_exposed = t * (1.0 - params.overlap_discount)
        elif e['phase'] == 'param' and params.ps_overlap_discount \
                and not e.get('wus'):
            # the weight-update-sharding param all-gather is an
            # in-step SPMD collective after the optimizer update — the
            # async-PS pipeline cannot hide it, so it is priced fully
            # exposed (exactly the exposure choose_update_sharding
            # weighs against the freed memory)
            t_exposed = t * (1.0 - params.ps_overlap_discount)
        else:
            t_exposed = t
        if local_h > 1 and e['members'] and \
                all(m in ps_vars for m in e['members']):
            # per-round wire / H, plus one averaging pass over the
            # window delta (two HBM touches, amortized over the
            # window) and the per-extra-step divergence haircut
            win = e['bytes'] * params.compress_s_per_byte / local_h \
                + (local_h - 1) * e['bytes'] \
                * params.local_sgd_divergence_s_per_byte
            t = t / local_h + win
            t_exposed = t_exposed / local_h + win
        sync += t
        exposed += t_exposed
        breakdown.append({
            'kind': e['kind'], 'phase': e['phase'], 'vars': e['vars'],
            'bytes': e['bytes'], 'wire_bytes': wb,
            'hier': hier, 'wus': bool(e.get('wus')),
            'time_s': t, 'exposed_time_s': t_exposed,
            'members': e['members'][:4] + (
                ['... %d more' % (len(e['members']) - 4)]
                if len(e['members']) > 4 else []),
        })
    mem = memory_footprint(strategy, graph_item, n,
                           optimizer_slots=optimizer_slots,
                           schedule=schedule)
    # re-derive each priced entry's IR program and run the shape
    # algebra on it, so the prediction a strategy is selected by also
    # certifies the schedule moves every element exactly once
    from autodist_tpu_torch.parallel import schedule_ir as _sir
    verified = True
    for e in schedule:
        try:
            if _sir.verify(_sir.entry_program(e, n)):
                verified = False
                break
        except ValueError:
            verified = False
            break
    report = CostReport(
        predicted_step_time_s=params.compute_time_s + exposed,
        sync_time_s=sync,
        exposed_sync_time_s=exposed,
        predicted_peak_bytes=mem['total_bytes'],
        num_collectives=len(schedule),
        num_replicas=n,
        cross_node=cross_node,
        local_steps=local_h,
        schedule_verified=verified,
        memory=mem,
        breakdown=breakdown)
    logging.debug('cost_model.predict: %d collectives, sync=%.3gs '
                  'exposed=%.3gs peak=%dB over n=%d',
                  len(schedule), sync, exposed,
                  mem['total_bytes'], n)
    return report
