"""Analytic α-β cost model for per-variable synchronizer choices.

The port's copy of the part of the JAX package's
``simulator/cost_model.py`` that ``parallel/plan.py`` decides through:
the wire bytes of a bucket, the calibrated constants
(``CostModelParams``), and the weight-update-sharding and hierarchical
decisions. It imports neither jax nor torch; only module paths and the
dtype-width lookup (``_itemsize``, which knows ``bfloat16``) differ. The whole-strategy prediction
(``predict``, ``memory_footprint``) comes with ``AutoStrategy``
(ROADMAP.md Queue 1: Simulator and AutoStrategy).

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
"""
from dataclasses import dataclass, asdict


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


