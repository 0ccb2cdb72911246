"""The replica group: the data axis over ``torch.distributed`` ranks.

The counterpart of ``autodist_tpu/parallel/mesh.py`` in its data-axis
role. The JAX package builds a ``jax.sharding.Mesh`` and runs the step
once inside ``shard_map``; the port runs one process per device, so
the data axis is a group of ranks and each rank is one replica.
:class:`ReplicaGroup` holds that group and the collectives the
execution plan lowers to: sums, reduce-scatters and all-gathers over
the whole group, the neighbour exchange of the ring schedules, and the
subgroups the two-level schedules run over (:meth:`ReplicaGroup.split`),
and the point-to-point exchange the pipeline schedules hand activations
and their gradients between stages with (:meth:`ReplicaGroup.exchange`).
With one replica every collective is the identity. :class:`RankGrid`
lays the (data, pipe, seq, expert, model) grid of the functional Trainer
over the ranks, and :func:`shift`, :func:`all_to_all` and :func:`all_gather`
are the differentiable forms the ring and Ulysses attention and the
ZeRO-3 parameter gather run through. :func:`copy_to` and
:func:`reduce_from` are the two operators of Megatron-style tensor and
expert parallelism: the JAX package's GSPMD inserts the collectives
that shard a product over the model or expert axis, and the port writes
them where a replicated activation enters a rank-local product and
where its partial sum leaves it.

``mesh_from_strategy`` sizes the group as the JAX package sizes the
mesh's data axis: the strategy's replica list, capped by what the run
has (there, the visible devices; here, the processes).
"""
import torch
import torch.distributed as dist

from autodist_tpu_torch.const import (AXIS_DATA, AXIS_EXPERT, AXIS_MODEL,
                                      AXIS_PIPELINE, AXIS_SEQUENCE)
from autodist_tpu_torch.utils import logging

# the deprecated names are the only ones older releases have
_reduce_scatter = getattr(dist, 'reduce_scatter_single', None) or \
    dist.reduce_scatter_tensor
_all_gather = getattr(dist, 'all_gather_single', None) or \
    dist.all_gather_into_tensor


class ReplicaGroup:
    """``size`` replicas, this process being replica ``rank``.

    Args:
        size: replicas on the data axis.
        rank: this process's position on it.
        group: the ``torch.distributed`` group over the replicas (None
            for the default group).
        device: the device this replica's tensors live on.
    """

    def __init__(self, size=1, rank=0, group=None, device=None):
        self.size = int(size)
        self.rank = int(rank)
        self.group = group
        self.device = torch.device(device or 'cpu')
        self._splits = {}

    # -- whole-group collectives ------------------------------------------
    def all_reduce(self, x, op=dist.ReduceOp.SUM):
        """Sum (or ``op``) of ``x`` over the replicas (a new tensor)."""
        out = x.clone()
        if self.size > 1:
            dist.all_reduce(out, op=op, group=self.group)
        return out

    def reduce_scatter(self, x, axis=0):
        """Sum over the replicas, this replica's ``1/size`` slice of
        ``axis`` (which must divide by the group size)."""
        if self.size == 1:
            return x.clone()
        moved = x.movedim(axis, 0).contiguous()
        out = torch.empty((moved.shape[0] // self.size,) + moved.shape[1:],
                          dtype=x.dtype, device=x.device)
        _reduce_scatter(out, moved, group=self.group)
        return out.movedim(0, axis)

    def all_gather(self, x, axis=0):
        """The replicas' ``x`` concatenated along ``axis`` in rank
        order (a tiled all-gather)."""
        if self.size == 1:
            return x
        moved = x.movedim(axis, 0).contiguous()
        out = torch.empty((moved.shape[0] * self.size,) + moved.shape[1:],
                          dtype=x.dtype, device=x.device)
        _all_gather(out, moved, group=self.group)
        return out.movedim(0, axis)

    def stack(self, x):
        """The replicas' ``x`` stacked on a new leading axis."""
        return self.all_gather(x[None])

    def shift(self, x, offset=1):
        """Ring neighbour exchange: send ``x`` to replica ``rank +
        offset``, return what replica ``rank - offset`` sent (the
        ``ppermute`` of the JAX ring schedules). ``x`` may be a list or
        tuple of tensors: every send and receive is posted in one
        ``batch_isend_irecv``, so no rank blocks on a send."""
        many = isinstance(x, (list, tuple))
        xs = list(x) if many else [x]
        if self.size == 1 or offset % self.size == 0:
            return x
        src = self._global((self.rank - offset) % self.size)
        dst = self._global((self.rank + offset) % self.size)
        outs = [torch.empty_like(t, memory_format=torch.contiguous_format)
                for t in xs]
        ops = [dist.P2POp(dist.isend, t.contiguous(), dst, self.group)
               for t in xs]
        ops += [dist.P2POp(dist.irecv, o, src, self.group) for o in outs]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return type(x)(outs) if many else outs[0]

    def exchange(self, sends=(), recvs=()):
        """Point-to-point: post every send ``(tensor, to)`` and every
        receive ``(buffer, src)`` (positions on this group) in one
        ``batch_isend_irecv`` and wait for all of them, so a step that
        both sends and receives never blocks a peer that posts the
        matching pair in its own batch. Returns the buffers, filled."""
        ops = [dist.P2POp(dist.isend, t.contiguous(), self._global(to),
                          self.group) for t, to in sends]
        ops += [dist.P2POp(dist.irecv, buf, self._global(src), self.group)
                for buf, src in recvs]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return [buf for buf, _ in recvs]

    def all_to_all(self, x, split_axis, concat_axis):
        """Tiled all-to-all (``jax.lax.all_to_all(..., tiled=True)``):
        ``x`` splits into ``size`` blocks along ``split_axis``, block j
        goes to replica j, and the blocks received are concatenated
        along ``concat_axis`` in rank order."""
        if self.size == 1:
            return x
        n = self.size
        if x.shape[split_axis] % n:
            raise ValueError('all_to_all: dim %d of %s does not split '
                             'over %d replicas'
                             % (split_axis, tuple(x.shape), n))
        blocks = x.unflatten(split_axis, (n, x.shape[split_axis] // n))
        send = blocks.movedim(split_axis, 0).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        return recv.movedim(0, concat_axis).flatten(concat_axis,
                                                    concat_axis + 1)

    def _global(self, rank):
        if self.group is None:
            return rank
        return dist.get_global_rank(self.group, rank)

    # -- subgroups ---------------------------------------------------------
    def split(self, groups):
        """This replica's :class:`ReplicaGroup` within ``groups``,
        disjoint groups of data-axis positions (the node groups of the
        two-level schedules, their cross-node groups, or a schedule-IR
        step's groups); None when this replica is in none of them. Every
        group is made on every replica, in the same order, as
        ``new_group`` requires (a group of one needs none); positions
        rank in ascending order. Cached: each split is made once."""
        key = tuple(tuple(sorted(g)) for g in groups)
        if key not in self._splits:
            mine = None
            for g in key:
                pg = dist.new_group([self._global(r) for r in g]) \
                    if len(g) > 1 else None
                if self.rank in g:
                    mine = ReplicaGroup(len(g), g.index(self.rank), pg,
                                        self.device)
            self._splits[key] = mine
        return self._splits[key]


class RankGrid:
    """The (data, pipe, seq, expert, model) grid over a process group's
    ranks.

    The axes are the JAX mesh's, in its order (``ParallelSpec.
    build_mesh``): data outermost, model innermost, so rank ``r = ((((d
    · pp + p) · sp + s) · ep + e) · tp + t)``. :attr:`data`,
    :attr:`pipe`, :attr:`seq`, :attr:`expert` and :attr:`model` are
    this rank's groups along each axis (the ranks that share its other
    coordinates; the pipe group's positions are the stages); :attr:`batch`
    is the data x seq group, the ranks that hold other tokens and the
    same parameter shards (the group gradients, losses and token counts
    reduce over); and :attr:`world` the whole grid. :meth:`group`
    returns the group over any of those axis sets, over (pipe, seq) and
    (data, pipe, seq) (the ranks a leaf the stages share reduces over)
    and over (expert, model), the ranks that hold the same tokens. Every
    rank makes every subgroup, in the same order, as ``new_group``
    requires; an axis of size 1 is a group of one, an axis set that
    spans the grid is the world group, and axis sets that part the ranks
    alike share one group (:meth:`ReplicaGroup.split` caches by the rank
    sets: at pp 1 the (data, pipe, seq) group is :attr:`batch`). A pipe
    group of two or more runs
    one all-reduce as it is made: NCCL builds a group's communicator at
    its first call, in which every rank of the group must take part, and
    the pipeline's first calls there are point-to-point.

    ``dcn_dp`` (the multi-slice factor) must divide dp: the data axis is
    then ``dcn_dp`` contiguous blocks of ranks (:attr:`node_groups`, its
    positions), the layout the JAX ``device_mesh_array`` emulates on
    devices without a slice index. With ``ranks_per_node`` (the resource
    spec's ranks on each node, in rank order) the grid's ranks must span
    ``dcn_dp`` nodes, as the JAX mesh's devices must span ``dcn_dp``
    slices."""

    def __init__(self, dp, sp, rank, group=None, device=None, ep=1, tp=1,
                 dcn_dp=1, ranks_per_node=None, pp=1):
        self.dp, self.pp, self.sp, self.ep, self.tp = (
            int(dp), int(pp), int(sp), int(ep), int(tp))
        self.sizes = (self.dp, self.pp, self.sp, self.ep, self.tp)
        # {axis: size} in the JAX mesh's axis order
        self.shape = dict(zip(self._AXES, self.sizes))
        n = self.dp * self.pp * self.sp * self.ep * self.tp
        self.dcn_dp = int(dcn_dp)
        if self.dcn_dp > 1:
            if self.dp % self.dcn_dp:
                raise ValueError('dcn_dp=%d must divide the data axis (%d)'
                                 % (self.dcn_dp, self.dp))
            if ranks_per_node:
                node_of = [i for i, c in enumerate(ranks_per_node)
                           for _ in range(c)]
                spanned = len({node_of[r] for r in range(n)
                               if r < len(node_of)})
                if spanned != self.dcn_dp:
                    raise ValueError('dcn_dp=%d but the %d devices span %d '
                                     'slices' % (self.dcn_dp, n, spanned))
        self.world = ReplicaGroup(n, rank, group, device)
        self.data_index, self.pipe_index, self.seq_index, \
            self.expert_index, self.model_index = self.coords(int(rank))
        self._one = ReplicaGroup(1, 0, None, device)
        self._groups = {}
        for axes in ((AXIS_DATA,), (AXIS_SEQUENCE,), (AXIS_EXPERT,),
                     (AXIS_MODEL,), (AXIS_DATA, AXIS_SEQUENCE),
                     (AXIS_EXPERT, AXIS_MODEL), (AXIS_PIPELINE,),
                     (AXIS_PIPELINE, AXIS_SEQUENCE),
                     (AXIS_DATA, AXIS_PIPELINE, AXIS_SEQUENCE)):
            self._groups[axes] = self._make(axes)
        self.data = self._groups[(AXIS_DATA,)]
        self.pipe = self._groups[(AXIS_PIPELINE,)]
        if self.pipe.size > 1:
            dist.all_reduce(torch.zeros(1, device=self.pipe.device),
                            group=self.pipe.group)
        self.seq = self._groups[(AXIS_SEQUENCE,)]
        self.expert = self._groups[(AXIS_EXPERT,)]
        self.model = self._groups[(AXIS_MODEL,)]
        self.batch = self._groups[(AXIS_DATA, AXIS_SEQUENCE)]
        self.node_groups = data_axis_node_groups(
            self.data, dcn_dp=self.dcn_dp) if self.dcn_dp > 1 else None

    _AXES = (AXIS_DATA, AXIS_PIPELINE, AXIS_SEQUENCE, AXIS_EXPERT,
             AXIS_MODEL)

    def coords(self, rank):
        """(d, p, s, e, t) of ``rank``."""
        out = []
        for size in reversed(self.sizes):
            rank, c = divmod(rank, size)
            out.append(c)
        return tuple(reversed(out))

    def _make(self, axes):
        pos = [self._AXES.index(a) for a in axes]
        n = 1
        for i in pos:
            n *= self.sizes[i]
        if n == 1:
            return self._one
        if n == self.world.size:
            return self.world
        groups = {}
        for r in range(self.world.size):
            c = self.coords(r)
            key = tuple(c[i] for i in range(len(c)) if i not in pos)
            groups.setdefault(key, []).append(r)
        return self.world.split(list(groups.values()))

    def group(self, *axes):
        """The group over ``axes`` (mesh-axis names, in grid order), made
        with the grid."""
        key = tuple(a for a in self._AXES if a in axes)
        if key not in self._groups:
            raise ValueError('RankGrid: no group over %s' % (axes,))
        return self._groups[key]


# -- differentiable collectives ---------------------------------------------
# Autograd runs a backward's collectives on its own thread; each rank
# builds the same graph, so every rank posts them in the same order.

class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, offset, *xs):
        ctx.group, ctx.offset = group, offset
        return tuple(group.shift(list(xs), offset))

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros_like(g) if g is None else g for g in grads]
        return (None, None) + tuple(ctx.group.shift(grads, -ctx.offset))


def shift(group, xs, offset=1):
    """:meth:`ReplicaGroup.shift` of a list of tensors, differentiable:
    the backward of a shift to ``rank + offset`` is a shift of the
    cotangents to ``rank - offset``."""
    if group.size == 1:
        return list(xs)
    return list(_Shift.apply(group, offset, *xs))


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, split_axis, concat_axis, x):
        ctx.args = (group, split_axis, concat_axis)
        return group.all_to_all(x, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, grad):
        group, split_axis, concat_axis = ctx.args
        return None, None, None, group.all_to_all(grad, concat_axis,
                                                  split_axis)


def all_to_all(group, x, split_axis, concat_axis):
    """:meth:`ReplicaGroup.all_to_all`, differentiable: the backward is
    the inverse all-to-all (split and concat axes swapped)."""
    if group.size == 1:
        return x
    return _AllToAll.apply(group, split_axis, concat_axis, x)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, axis, x):
        ctx.args = (group, axis)
        return group.all_gather(x, axis)

    @staticmethod
    def backward(ctx, grad):
        group, axis = ctx.args
        return None, None, group.reduce_scatter(grad, axis)


def all_gather(group, x, axis):
    """:meth:`ReplicaGroup.all_gather`, differentiable: the backward
    reduce-scatters the cotangent, so each replica's slice receives the
    sum over the replicas of its part of the gradient (the ZeRO-3 /
    FSDP parameter gather)."""
    if group.size == 1:
        return x
    return _Gather.apply(group, axis, x)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return None, ctx.group.all_reduce(grad)


def copy_to(group, x):
    """Identity forward, all-reduce backward over ``group``: a replicated
    activation entering a product each rank of ``group`` computes over
    its own shard of a parameter. Each rank's cotangent covers only its
    shard's share; the sum over the group is the whole gradient, the
    same on every rank."""
    if group is None or group.size == 1:
        return x
    return _CopyTo.apply(group, x)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        return group.all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return None, grad


def reduce_from(group, x):
    """All-reduce forward, identity backward over ``group``: the partial
    sums of a rank-local product leave it replicated. The cotangent of
    the sum is the cotangent of each part, so each rank passes its own
    (the same on every rank) back unchanged."""
    if group is None or group.size == 1:
        return x
    return _ReduceFrom.apply(group, x)


def data_axis_node_groups(group, forced_nodes=0, ranks_per_node=None,
                          dcn_dp=1):
    """Node groups over the data axis for two-level schedules, or None
    when the group is effectively one node (the flat emission).

    ``forced_nodes >= 2`` (``AUTODIST_HIERARCHY_NODES``) asks for that
    many contiguous equal groups, and so does a multi-slice factor
    ``dcn_dp >= 2`` (the grid's data axis is ``dcn_dp`` contiguous
    blocks, as the JAX mesh lays a dcn_dp data axis out); otherwise
    ``ranks_per_node`` (the resource spec's node sizes, in rank order)
    splits the ranks by host. Groups must be equal and at least 2 wide,
    as in the JAX package."""
    n = group.size
    if n <= 1:
        return None
    if not (forced_nodes and forced_nodes >= 2) and dcn_dp >= 2:
        forced_nodes = dcn_dp
    if forced_nodes and forced_nodes >= 2:
        if n % forced_nodes or n // forced_nodes < 2:
            logging.warning(
                'AUTODIST_HIERARCHY_NODES=%d does not split the %d-way '
                'data axis into equal groups of >= 2; hierarchical '
                'emission stays flat', forced_nodes, n)
            return None
        g = n // forced_nodes
        return [list(range(i * g, (i + 1) * g))
                for i in range(forced_nodes)]
    sizes = [s for s in (ranks_per_node or [n]) if s]
    out, start = [], 0
    for s in sizes:
        out.append(list(range(start, min(start + s, n))))
        start += s
        if start >= n:
            break
    out = [g for g in out if g]
    widths = {len(g) for g in out}
    if len(out) < 2 or len(widths) != 1 or widths == {1}:
        return None
    return out


def mesh_from_strategy(strategy, world_size):
    """Replica count for a compiled strategy: its replica list, or the
    whole run when the list is empty, capped by the run's processes —
    the JAX package's rule with processes in place of devices."""
    n = len(strategy.graph_config.replicas) or world_size
    return min(n, world_size)
