"""Execution plan: lower a compiled Strategy onto the replica group.

The counterpart of ``autodist_tpu/parallel/plan.py``. The JAX package
interprets the captured step once inside ``shard_map`` over the mesh's
data axis; the port runs one process per replica and the same
per-variable decisions lower to ``torch.distributed`` collectives over
the replica group (:class:`~autodist_tpu_torch.parallel.mesh.
ReplicaGroup`):

- **AllReduceSynchronizer** becomes a mean all-reduce, optionally
  compressor-wrapped, with same-``group`` variables packed into
  byte-capped buckets (one collective a bucket, reverse production
  order), or, under weight-update sharding, a reduce-scatter, a
  shard-local optimizer step and a bucketed all-gather;
- **PSSynchronizer** in synchronous mode is numerically an average; its
  placement semantics (variables and optimizer slots on reduction
  destinations) lower to ZeRO-style sharded state: each replica keeps
  its ``1/n`` of the (padded) shard axis, gradients are reduce-scattered
  to it and the values all-gathered at the next step;
- sparse-read (embedding) variables ship (ids, rows) instead of the
  dense vocab-sized gradient when that moves fewer bytes;
- ``RING`` forces an explicit send/recv ring;
- on several nodes (or under ``AUTODIST_HIERARCHY_NODES``) a bucket the
  cost model prices cheaper in two levels runs the hierarchical
  schedules (:func:`hierarchical_all_reduce` and its scatter and gather
  halves) over the node and cross-node subgroups.

The bucket packing, the fusion predicate and key, and the static
schedule the simulator prices are the JAX package's code, so the
emitted collectives and ``static_collective_schedule`` cannot drift.
Every collective is routed through the schedule IR
(:mod:`autodist_tpu_torch.parallel.schedule_ir`).
"""
import torch
import torch.distributed as dist

from autodist_tpu_torch.const import (BUCKET_BYTES_PER_CHUNK,
                                      DEFAULT_CHUNK_SIZE, ENV)
from autodist_tpu_torch.kernels.partitioner import PartitionerConfig
from autodist_tpu_torch.telemetry import core as _telemetry
from autodist_tpu_torch.parallel import compressor as comp
from autodist_tpu_torch.parallel import schedule_ir as sir
from autodist_tpu_torch.strategy.base import (AllReduceSynchronizer,
                                              PSSynchronizer)
from autodist_tpu_torch.utils import logging


def dtype_name(dtype):
    """'float32', 'bfloat16', ... for a numpy or torch dtype."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace('torch.', '')
    import numpy as np
    return str(np.dtype(dtype))


def _nbytes(t):
    return t.numel() * t.element_size()


def ring_all_reduce(x, group):
    """Explicit ring all-reduce (sum) over the replica group (reference
    RING spec): a ring reduce-scatter of ``1/n`` chunks (n-1 send/recv
    hops), then an all-gather of the reduced chunks."""
    n = group.size
    if n == 1:
        return x
    shape = x.shape
    flat = x.reshape(-1)
    m = -(-flat.numel() // n)
    chunks = torch.nn.functional.pad(
        flat, (0, m * n - flat.numel())).reshape(n, m)
    me = group.rank
    # after n-1 hops replica i owns the full sum of chunk (i+1) % n
    cur = chunks[me]
    for step in range(n - 1):
        cur = group.shift(cur) + chunks[(me - step - 1) % n]
    full = group.stack(cur)   # [n, m]
    # replica row j holds chunk (j+1)%n -> chunk c sits at row (c-1)%n
    full = full[[(c - 1) % n for c in range(n)]]
    return full.reshape(-1)[:x.numel()].reshape(shape)


def _inter_groups(node_groups):
    """The cross-node groups of a two-level schedule: the devices at
    the same intra-node position, one per node."""
    g = len(node_groups[0])
    return [[grp[r] for grp in node_groups] for r in range(g)]


def hierarchical_all_reduce(x, group, node_groups):
    """Two-level all-reduce (sum) over ``node_groups`` of replica
    positions: intra-node reduce-scatter, inter-node all-reduce over one
    chunk owner per node, intra-node all-gather.

    The PCCL-style process-group synthesis for a two-tier topology
    (NVLink within a node, the network across nodes): the only traffic
    that crosses the node boundary is each node's ``1/g`` chunk of the
    already-reduced bucket, so the slow link carries ``2(k-1)/k·B/g``
    bytes instead of the flat ring's ``2(n-1)/n·B`` — the gap
    :func:`~autodist_tpu_torch.simulator.cost_model.hierarchical_time`
    prices. The subgroups are the replica group's
    (:meth:`~autodist_tpu_torch.parallel.mesh.ReplicaGroup.split`).
    Addition is associative over the regrouping, so the result is the
    flat sum up to the order of the additions. Degenerate group shapes
    (one node, or one device per node) collapse to the flat all-reduce.
    """
    k = len(node_groups) if node_groups else 0
    g = len(node_groups[0]) if node_groups else 0
    if k <= 1 or g <= 1:
        return group.all_reduce(x)
    shape = x.shape
    flat = x.reshape(-1)
    m = -(-flat.numel() // g) * g
    flat = torch.nn.functional.pad(flat, (0, m - flat.numel()))
    intra = group.split(node_groups)
    cur = intra.reduce_scatter(flat)
    cur = group.split(_inter_groups(node_groups)).all_reduce(cur)
    out = intra.all_gather(cur)
    return out[:x.numel()].reshape(shape)


def hierarchical_psum_scatter(x, group, node_groups, axis=0):
    """Two-level reduce-scatter (sum) along ``axis``: intra-node
    reduce-scatter, then inter-node reduce-scatter of the owned chunk
    over one representative per node — the scatter HALF of
    :func:`hierarchical_all_reduce`. A chunk pre-permutation makes the
    final ownership IDENTICAL to the flat reduce-scatter (the replica at
    position ``d`` owns chunk ``d``), so ZeRO shard layouts and
    update-sharding buckets swap schedules without a relayout. ``axis``
    length must divide by the group size. Degenerate group shapes
    collapse to the flat collective.
    """
    k = len(node_groups) if node_groups else 0
    g = len(node_groups[0]) if node_groups else 0
    if k <= 1 or g <= 1:
        return group.reduce_scatter(x, axis=axis)
    n = k * g
    moved = x.movedim(axis, 0)
    m = moved.shape[0] // n
    rest = tuple(moved.shape[1:])
    # the two scatters deliver block (p, j) of a (g, k, m)-blocked
    # layout to the replica at intra position p in node j (position
    # j*g+p); pre-permuting (k, g) -> (g, k) block order makes that
    # block the flat layout's chunk j*g+p
    arranged = moved.reshape((k, g, m) + rest).transpose(0, 1)
    arranged = arranged.reshape((n * m,) + rest)
    cur = group.split(node_groups).reduce_scatter(arranged)
    cur = group.split(_inter_groups(node_groups)).reduce_scatter(cur)
    return cur.movedim(0, axis)


def hierarchical_all_gather(x, group, node_groups, axis=0):
    """Two-level all-gather along ``axis``: inter-node all-gather of
    this replica's chunk, then intra-node all-gather, then the inverse
    of :func:`hierarchical_psum_scatter`'s chunk permutation — the
    result is IDENTICAL to the flat all-gather (chunk ``d`` comes from
    position ``d``). The gather HALF of the two-level schedule: ZeRO
    param re-gathers and the weight-update-sharding bucket gather ride
    it when the shared cost-model decision picks the hierarchical
    schedule.
    """
    k = len(node_groups) if node_groups else 0
    g = len(node_groups[0]) if node_groups else 0
    if k <= 1 or g <= 1:
        return group.all_gather(x, axis=axis)
    moved = x.movedim(axis, 0)
    m = moved.shape[0]
    rest = tuple(moved.shape[1:])
    cur = group.split(_inter_groups(node_groups)).all_gather(moved)
    out = group.split(node_groups).all_gather(cur)
    # out block (p, j) holds the shard of position j*g+p; permute back
    # to flat chunk order
    out = out.reshape((g, k, m) + rest).transpose(0, 1)
    out = out.reshape((k * g * m,) + rest)
    return out.movedim(0, axis)


def _numel(shape):
    n = 1
    for d in (shape or (1,)):
        n *= int(d)
    return n


def bucket_bytes_cap(chunk_size=0):
    """Per-bucket byte cap for fused gradient collectives.

    ``AUTODIST_BUCKET_BYTES`` overrides directly; otherwise the cap
    derives from the strategy's ``chunk_size`` (tensors per merged
    group) at ``BUCKET_BYTES_PER_CHUNK`` each, so the reference knob
    keeps meaning something at modern model sizes: a group is never
    fused into one model-sized concat, it is packed into byte-capped
    buckets whose collectives can overlap the backward pass.
    """
    cap = ENV.AUTODIST_BUCKET_BYTES.val
    if cap:
        return max(1, cap)
    return (chunk_size or DEFAULT_CHUNK_SIZE) * BUCKET_BYTES_PER_CHUNK


def pack_buckets(items, cap_bytes, max_vars=0):
    """Greedy contiguous packing of ``[(key, nbytes)]`` into buckets.

    Pure and deterministic (the same inputs produce the same buckets on
    every process — divergent bucket layouts across SPMD hosts would
    deadlock the collective). A bucket closes when adding the next item
    would exceed ``cap_bytes`` (an item larger than the cap still gets
    a bucket of its own) or when it already holds ``max_vars`` items
    (0 = unbounded). Returns ``[[key, ...], ...]`` in input order.
    """
    buckets = []
    cur, cur_bytes = [], 0
    for key, nbytes in items:
        if cur and (cur_bytes + nbytes > cap_bytes or
                    (max_vars and len(cur) >= max_vars)):
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(key)
        cur_bytes += nbytes
    if cur:
        buckets.append(cur)
    return buckets


def bucket_fusable(plan, dtype, size):
    """THE per-variable admission predicate for fused AR buckets,
    shared verbatim by the traced emitter (``sync_gradients``) and the
    static mirror (``static_collective_schedule``): same-group
    AllReduce vars whose compressor is stateless on the bucket wire
    (none / bf16 cast) or whose int8 error-feedback state admits
    bucket-level residuals (``compressor.int8_bucket_fusable``)."""
    return bool(plan.is_ar and plan.group is not None and
                (type(plan.compressor) in (comp.NoneCompressor,
                                           comp.HorovodCompressor) or
                 comp.int8_bucket_fusable(plan.compressor, dtype,
                                          size)))


def bucket_fusion_key(plan, dtype):
    """THE bucket-fusion identity: variables may share a bucket only
    when every field that changes the emitted collective agrees —
    group, compressor, dtype, spec, and the two per-bucket schedule
    knobs (hierarchical, weight-update sharding). Both emitters key
    their packing off this tuple, so the traced and static bucket
    layouts cannot drift."""
    return (plan.group, type(plan.compressor).__name__,
            dtype_name(dtype), plan.spec, plan.hierarchical,
            plan.weight_update_sharding)


def _emit_bucket_tag(entry):
    """Telemetry tag for one emitted sync bucket (trace-time, so this
    fires once per compiled step, not per executed step): schedule
    shape (flat vs two-level), wire dtype, byte count and the
    schedule entry id — the per-bucket emission evidence the cohort
    timeline (and the roofline drift table) pairs with the measured
    step spans. No-op when telemetry is disabled."""
    tel = _telemetry.get()
    if not tel.enabled:
        return
    wire = {'Int8RingCompressor': 'i8',
            'HorovodCompressor': 'bf16',
            'HorovodCompressorEF': 'bf16'}.get(entry['compressor'],
                                               entry['dtype'])
    schedule = 'hier' if entry.get('hier') else 'flat'
    tel.event('bucket_emit', kind=entry['kind'], group=entry['group'],
              schedule=schedule, wire=wire, vars=entry['vars'],
              bytes=entry['bytes'],
              entry_id=entry.get('entry_id', ''))
    tel.count('plan/buckets_emitted')
    tel.count('plan/bucket_%s' % schedule)


def schedule_entry_key(entry):
    """Content key of one collective-schedule entry — THE join key
    between the static schedule (``static_collective_schedule``), the
    traced emission records (``ExecutionPlan.last_bucket_stats``) and
    the roofline observatory's per-entry drift table
    (:mod:`autodist_tpu.telemetry.roofline`). Built only from fields
    both sides carry identically (kind, dtype, compressor, byte count,
    leading member + member count); ``phase`` is deliberately excluded
    — the traced records do not know it, and kind already separates
    the grad/param halves of every pair the schedule emits."""
    members = entry.get('members') or []
    return '%s:%s:%s:%dB:%s+%d' % (
        entry['kind'], entry.get('dtype'),
        entry.get('compressor') or '-', int(entry.get('bytes', 0)),
        members[0] if members else '?', len(members))


def assign_entry_ids(entries, counts=None):
    """Stamp each entry with a stable ``entry_id``: its content key,
    suffixed ``#k`` for the k-th repeat of an identical key (equal-size
    ZeRO chunks of one variable). Deterministic given emission order,
    which both emission paths pin — so an id minted by the traced
    emission round-trips to exactly one static-schedule entry.
    ``counts`` threads the occurrence map across multiple calls within
    ONE trace (the param-gather records land after sync_gradients
    returns). Returns ``entries`` (mutated in place)."""
    counts = {} if counts is None else counts
    for e in entries:
        key = schedule_entry_key(e)
        k = counts.get(key, 0)
        counts[key] = k + 1
        e['entry_id'] = key if k == 0 else '%s#%d' % (key, k)
    return entries


def static_collective_schedule(strategy, graph_item, num_replicas,
                               sparse_lookups_per_replica=4096,
                               nodes=1, params=None,
                               hier_fallback=None):
    """Static mirror of :meth:`ExecutionPlan.sync_gradients`'s emission.

    Computes, WITHOUT tracing a step, the per-step collective schedule a
    strategy lowers to on an ``num_replicas``-way data mesh: the same
    bucket packing (``pack_buckets`` under the chunk_size-derived byte
    cap, reverse production order), the same ZeRO ``psum_scatter``
    chunking, the same per-bucket flat-vs-hierarchical decision
    (``cost_model.choose_hierarchical`` over ``nodes`` node groups and
    ``params``), and the param re-gather each sharded variable pays on
    the next step. This is what the simulator's cost model prices.

    Entries match the ``last_bucket_stats`` schema plus a ``phase``
    field: ``{'kind', 'group', 'compressor', 'dtype', 'spec', 'vars',
    'bytes', 'members', 'phase', 'hier', 'wus'}`` where ``phase`` is
    ``'grad'`` (gradient sync) or ``'param'`` (the post-update param
    re-gather — ZeRO all-gather or the weight-update-sharding bucket
    gather), ``hier`` is the node-group count of a two-level schedule
    (0 = flat; ZeRO scatter/gather halves and update-sharding buckets
    route through the same ``choose_hierarchical`` decision as AR
    buckets) and ``wus`` marks the reduce-scatter + all-gather pair a
    weight-update-sharded bucket lowers to
    (``choose_update_sharding``, the shared decision — padded bytes,
    sharded opt slots). Every entry additionally carries a stable
    ``entry_id`` (:func:`assign_entry_ids` over
    :func:`schedule_entry_key`) that the traced emission records and
    the roofline drift table join on.
    ``bytes``
    are RAW tensor bytes; anything REPORTING traffic must route them
    through ``simulator.cost_model.wire_bytes`` (as the cost model,
    ``profiling.bucket_report`` and ``bench.py`` do) — under a
    compressed wire the raw figure overstates by 2-4x. Sparse
    (embedding) vars
    assume ``sparse_lookups_per_replica`` looked-up rows per step, the
    runtime's data-dependent quantity.

    Every entry is DERIVED from the schedule IR: the same
    ``schedule_ir.bucket_program`` lowering the traced emission
    executes produces the entry via ``schedule_ir.schedule_entry``, so
    predicted==traced is structural rather than test-pinned. When the
    caller's host layout forced the hierarchical fallback,
    ``hier_fallback`` carries the reason and rides every flat comm
    entry, so a priced flat win stays distinguishable from a layout
    degrade.
    """
    import numpy as np

    n = int(num_replicas)
    entries = []
    if n <= 1:
        return entries
    nodes = int(nodes or 1)
    from autodist_tpu_torch.simulator.cost_model import (
        choose_hierarchical, choose_update_sharding,
        optimizer_slot_count)
    if params is None:
        from autodist_tpu_torch.simulator.cost_model import CostModelParams
        params = CostModelParams()
    opt_slots = optimizer_slot_count(graph_item)

    def half_hier(nbytes, dtype, knob, spec):
        """Two-level decision for ONE scatter/gather half — the same
        shared choose_hierarchical call as the AR buckets (half time
        is exactly half of AR time, so the comparison is identical)."""
        if nodes <= 1:
            return 0
        return nodes if choose_hierarchical(
            nbytes, dtype, 'NoneCompressor', n, nodes, params,
            knob=knob, spec=spec) else 0

    node_cfg = {nd.var_name: nd for nd in strategy.node_config}
    sources = list(graph_item.trainable_var_op_to_var.values())
    plans = []
    for var in sources:
        node = node_cfg.get(var.name)
        if node is None:
            from autodist_tpu_torch.strategy.base import StrategyNode
            node = StrategyNode(var_name=var.name,
                                synchronizer=AllReduceSynchronizer())
        plan = VarPlan(var, node)
        # mirror ExecutionPlan.__init__'s state-sharding rule
        if plan.is_ps and len(var.shape) > 0:
            ax = plan.shard_axis
            if var.shape[ax] >= n and plan.num_shards > 1:
                plan.state_sharded = True
                dim = int(var.shape[ax])
                plan.padded_dim = -(-dim // n) * n
                plan.pad = plan.padded_dim - dim
        plans.append(plan)

    def entry(kind, plan, nbytes, members, phase='grad', vars_=1,
              group=None, compressor=None, hier=0):
        prog = sir.bucket_program(kind, nbytes,
                                  str(np.dtype(plan.var.dtype)),
                                  compressor, plan.spec, n, hier=hier)
        e = sir.schedule_entry(prog, group=group, members=list(members),
                               vars_=vars_, phase=phase)
        # the legacy schema keeps the caller's literal compressor field
        # (None for the un-grouped kinds) — the IR meta normalizes to
        # registry names, which would change pinned entry ids
        e['compressor'] = compressor
        return e

    fusable = {}   # (group, compressor, dtype, spec, hier, wus) -> [idx]
    for i, (var, plan) in enumerate(zip(sources, plans)):
        itemsize = np.dtype(var.dtype).itemsize
        size = int(np.prod(var.shape or (1,)))
        nbytes = size * itemsize
        sparse = bool(graph_item.is_sparse(var)) and len(var.shape) == 2
        b = min(sparse_lookups_per_replica, int(var.shape[0])) \
            if sparse else 0
        sparse_bytes = n * b * (int(var.shape[1]) + 1) * itemsize \
            if sparse else None
        cname = type(plan.compressor).__name__
        if plan.state_sharded:
            padded_shape = list(var.shape)
            padded_shape[plan.shard_axis] = plan.padded_dim or \
                var.shape[plan.shard_axis]
            padded = int(np.prod(padded_shape)) * itemsize
            if sparse and plan.shard_axis == 0 and \
                    sparse_bytes < nbytes // n:
                entries.append(entry('sparse_scatter', plan, sparse_bytes,
                                     [var.name]))
            else:
                # mirror _capped_psum_scatter's chunking exactly
                # (incl. its per-chunk two-level decision)
                cap = bucket_bytes_cap(plan.chunk_size)
                ndim = len(var.shape)
                dstr = str(np.dtype(var.dtype))
                if padded <= cap or ndim < 2:
                    entries.append(entry(
                        'psum_scatter', plan, padded, [var.name],
                        hier=half_hier(padded, dstr,
                                       plan.hierarchical, plan.spec)))
                else:
                    split_axis = 0 if plan.shard_axis != 0 else 1
                    dim = int(padded_shape[split_axis])
                    row = padded // dim
                    k = min(dim, -(-padded // cap))
                    for j in range(k):
                        rows = dim * (j + 1) // k - dim * j // k
                        entries.append(entry(
                            'psum_scatter', plan, rows * row,
                            [var.name],
                            hier=half_hier(rows * row, dstr,
                                           plan.hierarchical,
                                           plan.spec)))
            # the updated shard is re-gathered for the next step. A
            # sparse (embedding) table only needs its looked-up rows
            # fresh — the loose-mode row-sparse plane refreshes them
            # point-to-point (BGETROWS), and the SPMD lowering gathers
            # rows, not the table — so the param phase is priced by
            # expected touched rows, not O(vocab x dim): full-size
            # pricing made AutoStrategy reject PS for exactly the
            # variables PS exists for.
            if sparse and plan.shard_axis == 0 and \
                    sparse_bytes < padded:
                entries.append(entry('sparse_all_gather', plan,
                                     sparse_bytes, [var.name],
                                     phase='param'))
            else:
                entries.append(entry(
                    'all_gather', plan, padded, [var.name],
                    phase='param',
                    hier=half_hier(padded, str(np.dtype(var.dtype)),
                                   plan.hierarchical, plan.spec)))
        elif sparse and type(plan.compressor) is comp.NoneCompressor \
                and sparse_bytes < nbytes:
            entries.append(entry('sparse_all_gather', plan, sparse_bytes,
                                 [var.name]))
        elif bucket_fusable(plan, var.dtype, size):
            fusable.setdefault(bucket_fusion_key(plan, var.dtype),
                               []).append(i)
        else:
            entries.append(entry('all_reduce', plan, nbytes, [var.name],
                                 group=plan.group, compressor=cname))
    # pack fusable groups exactly like sync_gradients: byte-capped
    # buckets in reverse production order, emitted tail-first
    pending = []
    for (group, cname, dtype, spec, hknob, wknob), idxs in \
            fusable.items():
        chunk = max(plans[i].chunk_size for i in idxs)
        cap = bucket_bytes_cap(chunk)
        items = [(i, int(np.prod(sources[i].shape or (1,))) *
                  np.dtype(sources[i].dtype).itemsize)
                 for i in reversed(idxs)]
        sizes = dict(items)
        for bucket in pack_buckets(items, cap,
                                   chunk or DEFAULT_CHUNK_SIZE):
            pending.append((bucket, sizes, group, cname, dtype, spec,
                            hknob, wknob))
    pending.sort(key=lambda b: -max(b[0]))
    for bucket, sizes, group, cname, dtype, spec, hknob, wknob in \
            pending:
        nbytes = sum(sizes[i] for i in bucket)
        if choose_update_sharding(nbytes, dtype, cname, n, params,
                                  knob=wknob, opt_slots=opt_slots,
                                  cross_node=nodes > 1, spec=spec):
            # weight-update-sharded bucket: reduce-scatter (grad
            # phase) + bucketed param all-gather (param phase), each
            # member zero-padded to a multiple of n — exactly what
            # _wus_scatter_bucket / gather_updated_params emit. The
            # psum_scatter kind is what makes memory_footprint drop
            # the members' opt-slot (and resident-grad) bytes to 1/n.
            itemsize = np.dtype(dtype).itemsize
            wbytes = sum((-(-(sizes[i] // itemsize) // n)) * n * itemsize
                         for i in bucket)
            hier = 0
            if nodes > 1 and choose_hierarchical(
                    wbytes, dtype, cname, n, nodes, params,
                    knob=hknob, spec=spec):
                hier = nodes
            members = [sources[i].name for i in bucket]
            for kind, phase in (('psum_scatter', 'grad'),
                                ('all_gather', 'param')):
                prog = sir.bucket_program(kind, wbytes, dtype, cname,
                                          spec, n, hier=hier, wus=True)
                entries.append(sir.schedule_entry(
                    prog, group=group, members=list(members),
                    vars_=len(bucket), phase=phase))
            continue
        hier = 0
        if nodes > 1 and choose_hierarchical(
                nbytes, dtype, cname, n, nodes, params,
                knob=hknob, spec=spec):
            hier = nodes
        prog = sir.bucket_program('all_reduce', nbytes, dtype, cname,
                                  spec, n, hier=hier)
        entries.append(sir.schedule_entry(
            prog, group=group,
            members=[sources[i].name for i in bucket],
            vars_=len(bucket), phase='grad'))
    if hier_fallback:
        # satellite of the unequal-host warning: the reason a flat
        # schedule was forced (vs merely priced cheaper) rides every
        # flat comm entry, joinable downstream by entry id
        for e in entries:
            if e['kind'] in ('all_reduce', 'psum_scatter',
                             'all_gather') and not e.get('hier'):
                e['hier_fallback'] = hier_fallback
    return assign_entry_ids(entries)


class ShardedGrad:
    """A reduce-scattered gradient shard (ZeRO-sharded PS variables), or
    this replica's shard of a sharded value.

    Produced by :meth:`ExecutionPlan.sync_gradients` for variables whose
    state is sharded; consumed by ``Optimizer._apply`` (updates the
    local shard only) or gathered to full on direct fetch.
    ``logical_dim`` is the unpadded size of the shard axis for uneven
    partitions: :meth:`gather` slices the padding back off.
    ``hier_groups`` carries the node groups of a two-level param
    re-gather when the shared cost-model decision picked it
    (:meth:`ExecutionPlan.gather_hier_groups`); None = flat.
    """

    is_sharded_value = True

    def __init__(self, value, axis, group, logical_dim=None,
                 hier_groups=None):
        self.value = value
        self.axis = axis
        self.group = group
        self.logical_dim = logical_dim
        self.hier_groups = hier_groups

    def gather(self):
        if self.hier_groups:
            full = hierarchical_all_gather(self.value, self.group,
                                           self.hier_groups, axis=self.axis)
        else:
            full = self.group.all_gather(self.value, axis=self.axis)
        if self.logical_dim is not None and \
                full.shape[self.axis] != self.logical_dim:
            full = full.narrow(self.axis, 0, self.logical_dim)
        return full


class UpdateShard:
    """One variable's 1/n flat shard inside a weight-update-sharded
    bucket (cross-replica weight-update sharding, arXiv:2004.13336).

    Carries the MEAN-gradient shard of an update-sharded AR bucket
    member; ``Optimizer._apply`` slices the matching param shard
    (:meth:`slice_param`), runs the shard-local update against
    shard-resident slots and hands back an UpdateShard of the UPDATED
    param (:meth:`with_value`); the ApplyGradients evaluation then
    re-gathers whole buckets through
    :meth:`ExecutionPlan.gather_updated_params`. The flat layout is
    row-major over the variable, zero-padded to a multiple of n;
    replica d owns elements ``[d*m, (d+1)*m)``.
    """

    is_update_shard = True
    is_sharded_value = True

    def __init__(self, value, plan, var, meta, index):
        self.value = value
        self.plan = plan
        self.var = var
        self.meta = meta
        self.index = index

    @property
    def shard_size(self):
        return self.meta['shard_sizes'][self.index]

    def slice_param(self, full_value):
        """This replica's flat param shard of the (replicated) full
        value — a local slice, no communication."""
        m = self.shard_size
        flat = full_value.reshape(-1)
        padded = m * self.plan.num_replicas
        if padded > flat.numel():
            flat = torch.nn.functional.pad(flat, (0, padded - flat.numel()))
        start = self.plan.group.rank * m
        return flat[start:start + m]

    def with_value(self, new_value):
        return UpdateShard(new_value, self.plan, self.var, self.meta,
                           self.index)

    def gather(self):
        """Full var-shaped value from the shards (single-member gather,
        for direct fetches and user arithmetic)."""
        if self.meta.get('hier_groups'):
            full = hierarchical_all_gather(self.value, self.plan.group,
                                           self.meta['hier_groups'])
        else:
            full = self.plan.group.all_gather(self.value)
        return full[:_numel(self.var.shape)].reshape(self.var.shape)


class VarPlan:
    """Resolved per-variable execution decisions."""

    def __init__(self, var, node):
        self.var = var
        self.node = node
        syncs = node.part_config if node.part_config else [node.synchronizer]
        self.sync = syncs[0]
        self.all_syncs = syncs
        self.is_ps = isinstance(self.sync, PSSynchronizer)
        self.is_ar = isinstance(self.sync, AllReduceSynchronizer)
        # shard geometry via the partitioner math module (reference
        # PartitionerConfig, kernel/partitioner.py:38-150)
        self.part_config = PartitionerConfig(node.partitioner)
        self.num_shards = self.part_config.num_shards
        self.partition_axis = self.part_config.axis
        self.sparse_synced = False   # set at trace time by sync_gradients
        self.staleness = getattr(self.sync, 'staleness', 0)
        self.sync_mode = getattr(self.sync, 'sync', True)
        # local-SGD window length H (PSSynchronizer.local_steps); AR
        # synchronizers carry 1 (every step)
        self.local_steps = max(
            1, int(getattr(self.sync, 'local_steps', 1) or 1))
        if self.is_ar:
            self.compressor = comp.create(self.sync.compressor, var.name)
            self.group = self.sync.group
            self.spec = self.sync.spec
            self.chunk_size = getattr(self.sync, 'chunk_size', 0)
            self.hierarchical = getattr(self.sync, 'hierarchical',
                                        'auto') or 'auto'
            self.weight_update_sharding = getattr(
                self.sync, 'weight_update_sharding', 'never') or 'never'
            if getattr(var, 'sparse_read', False):
                # row-lazy semantics (LazyAdam/LazyMomentum keep
                # zero-grad rows bit-identical) are defined over whole
                # rows; the flat 1/n shard layout cannot compute the
                # row mask shard-locally, so sparse-read variables keep
                # the replicated update — 'ineligible' is stronger than
                # 'never': the env override does not shard it either
                self.weight_update_sharding = 'ineligible'
        else:
            self.compressor = comp.create('NoneCompressor', var.name)
            self.group = None
            self.spec = 'AUTO'
            self.chunk_size = 0
            # the ZeRO scatter/gather halves route through the same
            # choose_hierarchical decision as the AR buckets; the
            # PSSynchronizer's knob governs it ('auto' default)
            self.hierarchical = getattr(self.sync, 'hierarchical',
                                        'auto') or 'auto'
            self.weight_update_sharding = 'never'
        # Cross-replica weight-update sharding (set by ExecutionPlan
        # from the per-bucket choose_update_sharding decision): the
        # gradient bucket is reduce-scattered, the optimizer updates
        # this replica's 1/n flat shard against shard-resident slots,
        # and the updated params ride a bucketed all-gather. The flat
        # layout is row-major, zero-padded to wus_padded = n * wus_shard.
        self.update_sharded = False
        self.wus_shard = 0       # per-replica flat shard elements
        self.wus_padded = 0      # padded flat size (n * wus_shard)
        self.wus_pad = 0         # zero-pad elements at the flat tail
        # ZeRO-style state sharding applies to partitioned vars; when the
        # partition axis does not divide the mesh data axis (the uneven
        # case, UnevenPartitionedPS) the physical state is zero-padded to
        # the next multiple and the padding sliced off on every read.
        self.state_sharded = False
        self.shard_axis = self.partition_axis if \
            self.partition_axis is not None else 0
        self.pad = 0             # physical padding rows on shard_axis
        self.padded_dim = None   # physical (padded) size of shard_axis


class ExecutionPlan:
    """Binds (strategy, graph_item, replica group) into the sync hooks.

    ``group`` is the :class:`~autodist_tpu_torch.parallel.mesh.
    ReplicaGroup` this process is one replica of; ``ranks_per_node``
    the resource spec's node sizes in rank order (the two-level
    schedules' node groups). ``loose`` marks a process of the loose
    PS plane (JAX ``plan.py:737-880``): its group is its own one
    replica, its variables live on the coord service's PS, and the
    gate and local-SGD fields below say how it syncs."""

    def __init__(self, strategy, graph_item, group, topology=None,
                 ranks_per_node=None, loose=False):
        from autodist_tpu_torch.parallel.mesh import data_axis_node_groups
        from autodist_tpu_torch.simulator.cost_model import CostModelParams
        self.strategy = strategy
        self.graph_item = graph_item
        self.group = group
        self.num_replicas = group.size
        # a loose process runs its own program: no group across workers
        self.loose = loose
        self.num_processes = 1 if loose else group.size
        self.topology = topology
        self.hier_groups = data_axis_node_groups(
            group, forced_nodes=ENV.AUTODIST_HIERARCHY_NODES.val,
            ranks_per_node=ranks_per_node)
        self.cost_params = CostModelParams.from_topology(topology) \
            if topology is not None else CostModelParams()
        if self.hier_groups and dist.is_available() and \
                dist.is_initialized():
            # new_group is collective: every replica makes the node and
            # cross-node groups here, in the same order, before any
            # bucket decides whether it goes two-level
            group.split(self.hier_groups)
            group.split(_inter_groups(self.hier_groups))
        self.var_plans = {}
        nodes = {n.var_name: n for n in strategy.node_config}
        for name, var in graph_item.trainable_var_op_to_var.items():
            node = nodes.get(name)
            if node is None:
                from autodist_tpu_torch.strategy.base import StrategyNode
                node = StrategyNode(
                    var_name=name, synchronizer=AllReduceSynchronizer())
                logging.debug('Variable %s missing from strategy; '
                              'defaulting to AllReduce', name)
            plan = VarPlan(var, node)
            if plan.is_ps and len(var.shape) > 0 and not loose:
                ax = plan.shard_axis
                n = self.num_replicas
                if var.shape[ax] >= n and plan.num_shards > 1:
                    plan.state_sharded = True
                    dim = int(var.shape[ax])
                    plan.padded_dim = -(-dim // n) * n
                    plan.pad = plan.padded_dim - dim
            self.var_plans[name] = plan
        # Weight-update-sharding marking: the per-bucket decision is
        # made here, before any step, because the optimizer-slot
        # placement depends on it; the static schedule runs the same
        # packing and the same shared decision the emission re-derives
        # (_wus_for), so marking, emission and pricing cannot drift.
        env_wus = ENV.AUTODIST_WEIGHT_UPDATE_SHARDING.val
        may_shard = env_wus in ('auto', 'always') or (
            env_wus != 'never' and any(
                p.is_ar and p.weight_update_sharding != 'never'
                for p in self.var_plans.values()))
        if may_shard and self.num_replicas > 1:
            nodes_n = len(self.hier_groups) if self.hier_groups else 1
            for e in static_collective_schedule(
                    strategy, graph_item, self.num_replicas,
                    nodes=nodes_n, params=self.cost_params):
                if not (e.get('wus') and e['kind'] == 'psum_scatter'):
                    continue
                for name in e['members']:
                    p = self.var_plans.get(name)
                    if p is None:
                        continue
                    size = _numel(p.var.shape)
                    p.update_sharded = True
                    p.wus_shard = -(-size // self.num_replicas)
                    p.wus_padded = p.wus_shard * self.num_replicas
                    p.wus_pad = p.wus_padded - size
        self._pure_sparse_cache = {}
        # per-collective records of the most recent sync_gradients:
        # [{'kind', 'group', 'compressor', 'dtype', 'spec', 'vars',
        # 'bytes', 'members', 'entry_id', ...}] ('bytes' RAW tensor
        # bytes); the entry ids round-trip to static_collective_schedule
        self.last_bucket_stats = []
        self._entry_id_counts = {}
        # loose-mode gate: any sync=True var demands its staleness
        # bound; the program-wide gate enforces the tightest one (the
        # step is one program)
        sync_stale = [p.staleness for p in self.var_plans.values()
                      if p.sync_mode]
        self.gate_enabled = bool(sync_stale)
        self.gate_staleness = min(sync_stale) if sync_stale else 0
        relaxed = [p for p in self.var_plans.values()
                   if p.staleness > 0 or not p.sync_mode]
        if relaxed and not loose:
            # lock-step replicas satisfy any staleness bound; the
            # relaxed-consistency plane engages only for multi-process
            # runs of an all-relaxed PS strategy
            logging.warning(
                'Strategy requests relaxed consistency (async/stale) for '
                '%d vars; lock-step execution is synchronous, which is a '
                'valid (staleness=0) schedule of the requested bound.',
                len(relaxed))
        self.local_steps = self._local_steps(loose)

    def _local_steps(self, loose):
        """The program-wide local-SGD window H (JAX ``plan.py:850-880``):
        the tightest of the PS vars' requests, ``AUTODIST_LOCAL_STEPS``
        over it; 1 with a shared optimizer (the PS update takes per-step
        gradients) or outside loose mode (lock-step replicas sync every
        step)."""
        ps_h = [p.local_steps for p in self.var_plans.values() if p.is_ps]
        h = min(ps_h) if ps_h else 1
        if ps_h and len(set(ps_h)) > 1:
            logging.warning(
                'Strategy requests mixed local_steps %s across PS vars; '
                'the step is one program, so the tightest window (%d) '
                'applies to all of them.', sorted(set(ps_h)), h)
        env_h = ENV.AUTODIST_LOCAL_STEPS.val
        if env_h > 0:
            h = env_h
        if h > 1 and any(
                p.is_ps and getattr(p.sync, 'shared_optimizer', False)
                for p in self.var_plans.values()):
            logging.warning(
                'local_steps=%d is incompatible with shared_optimizer '
                '(the PS-resident update consumes per-step deltas, not '
                'window-averaged parameter deltas); clamping to 1.', h)
            h = 1
        if h > 1 and not loose:
            logging.warning(
                'local_steps=%d requested but execution is not loose-'
                'mode; lock-step execution syncs every step (H=1 is the '
                'only schedule of this program).', h)
            h = 1
        return h

    def plan_for(self, var):
        name = var if isinstance(var, str) else var.name
        return self.var_plans[name]

    def _record_entry(self, entry):
        """Append one emission record, stamped with its schedule entry
        id, and emit its telemetry tag."""
        assign_entry_ids([entry], self._entry_id_counts)
        self.last_bucket_stats.append(entry)
        _emit_bucket_tag(entry)

    # -- gradient synchronization -----------------------------------------
    def _reduce_fn(self, spec, hier_groups=None):
        """Mean-reduce callable for ONE collective, routed through the
        schedule IR (one invocation per emitted collective)."""
        n = self.num_replicas
        k = len(hier_groups) if hier_groups else 0

        def fn(g):
            prog = sir.bucket_program(
                'all_reduce', _nbytes(g), dtype_name(g.dtype), None, spec,
                n, hier=k, node_groups=hier_groups)
            return sir.execute(prog, g, self.group)
        return fn

    def _hier_groups_for(self, nbytes, dtype, compressor_name, spec,
                         knob):
        """Node groups for ONE bucket's collective, or None for flat —
        the shared ``cost_model.choose_hierarchical`` decision."""
        groups = self.hier_groups
        if not groups:
            return None
        from autodist_tpu_torch.simulator.cost_model import \
            choose_hierarchical
        if choose_hierarchical(nbytes, dtype, compressor_name,
                               self.num_replicas, len(groups),
                               self.cost_params, knob=knob, spec=spec):
            return groups
        return None

    def _wus_for(self, nbytes, dtype, compressor_name, spec, knob):
        """Replicated-vs-sharded weight-update decision for ONE bucket
        (the shared ``cost_model.choose_update_sharding``)."""
        from autodist_tpu_torch.simulator.cost_model import (
            choose_update_sharding, optimizer_slot_count)
        return choose_update_sharding(
            nbytes, dtype, compressor_name, self.num_replicas,
            self.cost_params, knob=knob,
            opt_slots=optimizer_slot_count(self.graph_item),
            cross_node=bool(self.hier_groups), spec=spec)

    # -- sparse (IndexedSlices-equivalent) gradient sync ------------------
    def _purely_sparse(self, var):
        """True iff every consumer of ``var`` is a recorded lookup: a
        dense use puts gradient on rows outside the looked-up set, which
        the sparse wire would drop."""
        cached = self._pure_sparse_cache.get(var.name)
        if cached is not None:
            return cached
        from autodist_tpu_torch.frontend import graph as fe
        lookup_ops = set(map(id, var.lookup_ops))
        read = var._read
        pure = True
        for node in self.graph_item.graph.nodes:
            if not isinstance(node, fe.Op) or id(node) in lookup_ops:
                continue
            operands = list(node.inputs) + list(node.kwargs.values())
            if any(x is var or (read is not None and x is read)
                   for x in operands):
                pure = False
                break
        self._pure_sparse_cache[var.name] = pure
        return pure

    def _sparse_ids(self, var, env):
        """Flattened lookup ids of a sparse-read var, or None when the
        sparse path does not apply."""
        if not getattr(var, 'sparse_read', False) or \
                not getattr(var, 'lookup_ids', None) or \
                len(var.shape) != 2 or not self._purely_sparse(var):
            return None
        from autodist_tpu_torch.frontend import graph as fe
        try:
            parts = [fe.evaluate(n, env).reshape(-1).long()
                     for n in var.lookup_ids]
        except KeyError:        # ids node depends on an un-fed placeholder
            return None
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def _gather_slices(self, grad, ids):
        """All-gather each replica's (ids, rows): ``(n, B)`` ids and
        ``(n, B, dim)`` rows. Replicas may feed batches of different
        sizes: the shorter ones pad with id -1, which is dropped."""
        rows = grad.index_select(0, ids)
        lens = self.group.stack(torch.tensor([ids.numel()],
                                             device=ids.device))
        longest = int(lens.max())
        if longest > ids.numel():
            extra = longest - ids.numel()
            ids = torch.cat([ids, ids.new_full((extra,), -1)])
            rows = torch.cat([rows, rows.new_zeros((extra,) +
                                                   rows.shape[1:])])
        return self.group.stack(ids), self.group.stack(rows)

    def _sparse_allreduce(self, grad, ids):
        """Dense-equivalent mean of per-replica sparse grads: per replica
        a scatter-SET (repeated ids carry the same summed row), then the
        sum over replicas in replica order."""
        all_ids, all_rows = self._gather_slices(grad, ids)
        rows_n = grad.shape[0]
        acc = torch.zeros_like(grad)
        for ids_r, rows_r in zip(all_ids, all_rows):
            acc = acc + _scatter_set(rows_n, ids_r, rows_r)
        return acc / self.num_replicas

    def _pad_grad(self, plan, grad):
        """Zero-pad a gradient on the shard axis for uneven partitions."""
        if not plan.pad:
            return grad
        cfg = [0, 0] * grad.dim()
        cfg[2 * (grad.dim() - 1 - plan.shard_axis) + 1] = plan.pad
        return torch.nn.functional.pad(grad, cfg)

    def _sparse_scatter_to_shard(self, plan, grad, ids):
        """ZeRO variant: each shard owner keeps only its index range;
        out-of-range rows drop. Uneven partitions use the padded
        per-shard row count."""
        n = self.num_replicas
        shard_rows = (grad.shape[0] + plan.pad) // n
        all_ids, all_rows = self._gather_slices(grad, ids)
        offset = self.group.rank * shard_rows
        acc = grad.new_zeros((shard_rows, grad.shape[1]))
        for ids_r, rows_r in zip(all_ids, all_rows):
            local = torch.where(ids_r >= 0, ids_r - offset, -1)
            acc = acc + _scatter_set(shard_rows, local, rows_r)
        return ShardedGrad(acc / n, 0, self.group,
                           logical_dim=grad.shape[0])

    def _capped_psum_scatter(self, plan, grad):
        """ZeRO reduce-scatter under the same byte cap as the AR
        buckets: gradients above the cap split along a NON-scatter axis
        and reduce-scatter chunk by chunk (ownership along the scatter
        axis unchanged, so the concatenation is elementwise-identical to
        one collective). Returns the local shard (mean)."""
        n = self.num_replicas
        axis = plan.shard_axis
        g = self._pad_grad(plan, grad)
        cap = bucket_bytes_cap(plan.chunk_size)
        nbytes = _nbytes(g)

        def scatter(x, nb):
            groups = self._hier_groups_for(int(nb), dtype_name(x.dtype),
                                           'NoneCompressor', plan.spec,
                                           plan.hierarchical)
            prog = sir.bucket_program(
                'psum_scatter', int(nb), dtype_name(x.dtype), None,
                plan.spec, n, hier=len(groups) if groups else 0,
                node_groups=groups)
            self._record_entry(sir.schedule_entry(
                prog, members=[plan.var.name]))
            return sir.execute(prog, x, self.group, axis=axis)

        if nbytes <= cap or g.dim() < 2:
            return scatter(g, nbytes)
        split_axis = 0 if axis != 0 else 1
        dim = g.shape[split_axis]
        k = min(dim, -(-int(nbytes) // cap))
        bounds = [0] + [dim * i // k for i in range(1, k)] + [dim]
        parts = torch.split(g, [b - a for a, b in zip(bounds, bounds[1:])],
                            dim=split_axis)
        return torch.cat([scatter(p, _nbytes(p)) for p in parts],
                         dim=split_axis)

    def sync_gradients(self, sources, grads, env):
        """Average gradients across the replicas per each var's strategy.

        Same-group AllReduce vars with a stateless compressor are packed
        into byte-capped buckets (``pack_buckets``; cap from the
        strategy's ``chunk_size`` / ``AUTODIST_BUCKET_BYTES``), one
        collective a bucket in REVERSE gradient-production order.
        Stateful compressors (EF / PowerSGD) and PS vars reduce
        individually; sparse-read (embedding) vars ship (ids, rows)
        whenever that moves fewer bytes; ZeRO reduce-scatters are
        chunked under the same cap. With one replica every collective
        is the identity: the gradients return as they are.
        """
        self.last_bucket_stats = []
        self._entry_id_counts = {}
        if self.num_replicas == 1:
            return grads
        n = self.num_replicas
        out = list(grads)
        fusable = {}   # bucket_fusion_key -> [idx]
        for i, (var, grad) in enumerate(zip(sources, grads)):
            plan = self.plan_for(var)
            ids = self._sparse_ids(plan.var, env)
            sparse_bytes = None if ids is None else \
                n * ids.numel() * (grad.shape[1] + 1)
            if plan.state_sharded:
                if ids is not None and plan.shard_axis == 0 and \
                        sparse_bytes < grad.numel() // n:
                    out[i] = self._sparse_scatter_to_shard(plan, grad, ids)
                    plan.sparse_synced = True
                    continue
                # ZeRO path: reduce-scatter straight to the shard owner;
                # uneven partitions pad to the next multiple of n.
                out[i] = ShardedGrad(
                    self._capped_psum_scatter(plan, grad),
                    plan.shard_axis, self.group,
                    logical_dim=grad.shape[plan.shard_axis],
                    hier_groups=self.gather_hier_groups(plan))
            elif (ids is not None and
                    type(plan.compressor) is comp.NoneCompressor and
                    sparse_bytes < grad.numel()):
                out[i] = self._sparse_allreduce(grad, ids)
                plan.sparse_synced = True
            elif bucket_fusable(plan, grad.dtype, grad.numel()):
                fusable.setdefault(bucket_fusion_key(plan, grad.dtype),
                                   []).append(i)
            else:
                out[i] = plan.compressor.reduce(
                    grad, env, self._reduce_fn(plan.spec))
        # Pack every fusable group into byte-capped buckets, then emit
        # ALL buckets (across groups) ordered by reverse production:
        # the bucket holding the highest variable indices first.
        pending = []
        for (group, cname, dtype, spec, hknob, wknob), idxs in \
                fusable.items():
            chunk = max(self.plan_for(sources[i]).chunk_size
                        for i in idxs)
            cap = bucket_bytes_cap(chunk)
            items = [(i, _nbytes(grads[i])) for i in reversed(idxs)]
            for bucket in pack_buckets(items, cap,
                                       chunk or DEFAULT_CHUNK_SIZE):
                pending.append((bucket, group, cname, dtype, spec,
                                hknob, wknob))
        pending.sort(key=lambda b: -max(b[0]))
        for bucket, group, cname, dtype, spec, hknob, wknob in pending:
            nbytes = sum(_nbytes(grads[i]) for i in bucket)
            if self._wus_for(nbytes, dtype, cname, spec, wknob):
                # weight-update sharding: reduce-SCATTER the bucket, the
                # optimizer updates each replica's 1/n, one bucketed
                # all-gather brings the params back
                for i, sh in self._wus_scatter_bucket(
                        bucket, sources, grads, group, cname, dtype,
                        spec, hknob):
                    out[i] = sh
                continue
            groups = self._hier_groups_for(nbytes, dtype, cname, spec,
                                           hknob)
            prog = sir.bucket_program(
                'all_reduce', nbytes, dtype, cname, spec,
                self.num_replicas, hier=len(groups) if groups else 0,
                node_groups=groups)
            self._record_entry(sir.schedule_entry(
                prog, group=group,
                members=[sources[i].name for i in bucket],
                vars_=len(bucket)))
            if len(bucket) == 1 and groups is None:
                i = bucket[0]
                plan = self.plan_for(sources[i])
                out[i] = plan.compressor.reduce(
                    grads[i], env, self._reduce_fn(spec))
                continue
            flats = [grads[i].reshape(-1) for i in bucket]
            sizes = [f.numel() for f in flats]
            if cname == 'Int8RingCompressor':
                buf = self._int8_bucket_reduce(bucket, sources, flats,
                                               env, program=prog)
            else:
                reduce_fn = self._reduce_fn(spec, hier_groups=groups)
                buf = torch.cat(flats)
                if cname == 'HorovodCompressor' and \
                        buf.dtype == torch.float32:
                    buf = reduce_fn(
                        buf.to(torch.bfloat16)).to(torch.float32)
                else:
                    buf = reduce_fn(buf)
            offset = 0
            for i, size in zip(bucket, sizes):
                out[i] = buf[offset:offset + size].reshape(grads[i].shape)
                offset += size
        return out

    def _int8_bucket_reduce(self, bucket, sources, flats, env,
                            program=None):
        """Quantized-collective reduction of ONE packed bucket: the
        bucket quantized as one vector with per-block scales, one int8
        ring; error feedback PER MEMBER (each member's residual added to
        its slice before quantization, the slice of what the wire
        dropped kept as its next residual). Returns the mean flat
        bucket."""
        aux = getattr(env, 'aux_state', None) or {}
        comp_flats, res_keys = [], []
        for i, flat in zip(bucket, flats):
            key = 'compressor/%s' % sources[i].name
            res = (aux.get(key) or {}).get('residual')
            if res is not None:
                flat = flat + res.reshape(-1)
                res_keys.append(key)
            else:
                res_keys.append(None)
            comp_flats.append(flat)
        buf = torch.cat(comp_flats)
        transmitted = comp.block_roundtrip(buf)
        offset = 0
        for i, key, flat in zip(bucket, res_keys, comp_flats):
            size = flat.numel()
            if key is not None:
                env.aux_updates[key] = {'residual': (
                    flat - transmitted[offset:offset + size]
                ).reshape(self.plan_for(sources[i]).var.shape)}
            offset += size
        if program is None:
            program = sir.bucket_program(
                'all_reduce', _nbytes(buf), dtype_name(buf.dtype),
                'Int8RingCompressor', 'AUTO', self.num_replicas)
        return sir.execute(program, transmitted, self.group)

    def _wus_scatter_bucket(self, bucket, sources, grads, group, cname,
                            dtype, spec, hknob):
        """Scatter half of ONE weight-update-sharded bucket: each
        member's flat gradient padded to a multiple of n, the members'
        per-replica rows interleaved so ONE reduce-scatter hands every
        replica the concat of its member shards. Returns
        ``[(source index, UpdateShard)]``."""
        n = self.num_replicas
        rows, shard_sizes = [], []
        for i in bucket:
            f = grads[i].reshape(-1)
            padded = -(-f.numel() // n) * n
            if padded > f.numel():
                f = torch.nn.functional.pad(f, (0, padded - f.numel()))
            rows.append(f.reshape(n, -1))
            shard_sizes.append(padded // n)
        buf = torch.cat(rows, dim=1).reshape(-1)
        padded_bytes = _nbytes(buf)
        groups = self._hier_groups_for(padded_bytes, dtype, cname, spec,
                                       hknob)
        prog = sir.bucket_program(
            'psum_scatter', padded_bytes, dtype, cname, spec, n,
            hier=len(groups) if groups else 0, wus=True,
            node_groups=groups)
        shard = sir.execute(prog, buf, self.group)
        meta = {'members': [sources[i].name for i in bucket],
                'shard_sizes': shard_sizes, 'hier_groups': groups,
                'group': group, 'compressor': cname, 'dtype': dtype,
                'spec': spec, 'bytes': padded_bytes}
        self._record_entry(sir.schedule_entry(
            prog, group=group, members=list(meta['members']),
            vars_=len(bucket)))
        out, off = [], 0
        for pos, (i, m) in enumerate(zip(bucket, shard_sizes)):
            out.append((i, UpdateShard(shard[off:off + m], self,
                                       sources[i], meta, pos)))
            off += m
        return out

    def gather_updated_params(self, shards):
        """Gather half of weight-update sharding: one bucketed
        all-gather per scatter bucket (a partially applied bucket
        degrades to per-member gathers). ``shards`` maps var name ->
        UpdateShard of the UPDATED param. Returns {var name: full
        value}."""
        out = {}
        buckets = {}
        for name, sh in shards.items():
            buckets.setdefault(id(sh.meta), (sh.meta, {}))[1][name] = sh
        n = self.num_replicas
        for meta, members in buckets.values():
            names = meta['members']
            groups = meta['hier_groups']
            hier = len(groups) if groups else 0
            if set(names) != set(members):
                for name, sh in members.items():
                    out[name] = sh.gather()
                    mprog = sir.bucket_program(
                        'all_gather', sh.shard_size * n *
                        sh.value.element_size(), meta['dtype'],
                        meta['compressor'], meta['spec'], n, hier=hier,
                        wus=True, node_groups=groups)
                    self._record_entry(sir.schedule_entry(
                        mprog, group=meta['group'], members=[name]))
                continue
            cat = torch.cat([members[nm].value for nm in names])
            prog = sir.bucket_program(
                'all_gather', meta['bytes'], meta['dtype'],
                meta['compressor'], meta['spec'], n, hier=hier, wus=True,
                node_groups=groups)
            full = sir.execute(prog, cat, self.group)
            self._record_entry(sir.schedule_entry(
                prog, group=meta['group'], members=list(names),
                vars_=len(names)))
            mat = full.reshape(n, -1)
            off = 0
            for nm, m in zip(names, meta['shard_sizes']):
                var = members[nm].var
                flat = mat[:, off:off + m].reshape(-1)
                out[nm] = flat[:_numel(var.shape)].reshape(var.shape)
                off += m
        return out

    def gather_hier_groups(self, plan):
        """Node groups of a ZeRO-sharded variable's param re-gather, or
        None for flat — the gather half's shared two-level decision."""
        if not plan.state_sharded:
            return None
        shape = self.padded_shape(plan.var.name) or plan.var.shape
        nbytes = _numel(shape) * sir.dtype_itemsize(plan.var.dtype)
        return self._hier_groups_for(nbytes, dtype_name(plan.var.dtype),
                                     'NoneCompressor', plan.spec,
                                     plan.hierarchical)

    # -- padded physical layout (uneven partitions) ------------------------
    def padded_shape(self, var_name):
        """Physical (padded) shape of a variable's full state."""
        plan = self.var_plans.get(var_name)
        if plan is None:
            return None
        shape = list(plan.var.shape)
        if plan.state_sharded and plan.pad:
            shape[plan.shard_axis] = plan.padded_dim
        return tuple(shape)

    def pad_host(self, var_name, value):
        """Logical value -> physical (padded) layout."""
        plan = self.var_plans.get(var_name)
        if plan is None or not (plan.state_sharded and plan.pad):
            return value
        return self._pad_grad(plan, value)

    def unpad_host(self, var_name, value):
        """Physical layout -> logical value."""
        plan = self.var_plans.get(var_name)
        if plan is None or not (plan.state_sharded and plan.pad):
            return value
        dim = plan.var.shape[plan.shard_axis]
        return value.narrow(plan.shard_axis, 0, dim)

    def local_shard(self, var_name, full):
        """This replica's slice of a variable-shaped value: its ``1/n``
        of the padded shard axis for ZeRO-sharded state, the whole value
        otherwise."""
        plan = self.var_plans.get(var_name)
        if plan is None or not plan.state_sharded:
            return full
        full = self.pad_host(var_name, full)
        rows = full.shape[plan.shard_axis] // self.num_replicas
        return full.narrow(plan.shard_axis, self.group.rank * rows,
                           rows).contiguous()

    def describe(self):
        """Human-readable lowering summary."""
        lines = ['ExecutionPlan over %d replicas (this is replica %d):'
                 % (self.num_replicas, self.group.rank)]
        for name, p in self.var_plans.items():
            kind = 'AllReduce' if p.is_ar else 'PS'
            extra = ''
            if p.is_ps and getattr(p.sync, 'reduction_destination', ''):
                extra += ' dest=%s' % p.sync.reduction_destination
            if p.num_shards > 1:
                extra += ' shards=%d axis=%s' % (p.num_shards,
                                                 p.partition_axis)
            if p.state_sharded:
                extra += ' [ZeRO-sharded%s]' % (
                    ' pad=%d' % p.pad if p.pad else '')
            if p.is_ar:
                extra += ' group=%s compressor=%s' % (
                    p.group, type(p.compressor).__name__)
            if p.update_sharded:
                extra += ' [update-sharded%s]' % (
                    ' pad=%d' % p.wus_pad if p.wus_pad else '')
            if p.staleness:
                extra += ' staleness=%d' % p.staleness
            lines.append('  %s: %s%s' % (name, kind, extra))
        return '\n'.join(lines)


def _scatter_set(rows, ids, values):
    """A ``(rows, dim)`` zero table with ``values`` set at ``ids``; ids
    outside ``[0, rows)`` drop (they land on a spare row cut off after,
    so no host round trip decides which ids to keep)."""
    ids = torch.where((ids >= 0) & (ids < rows), ids, rows)
    out = values.new_zeros((rows + 1,) + values.shape[1:])
    out[ids] = values
    return out[:rows]
