"""The replica group: the data axis over ``torch.distributed`` ranks.

The counterpart of ``autodist_tpu/parallel/mesh.py`` in its data-axis
role. The JAX package builds a ``jax.sharding.Mesh`` and runs the step
once inside ``shard_map``; the port runs one process per device, so
the data axis is a group of ranks and each rank is one replica.
:class:`ReplicaGroup` holds that group and the collectives the
execution plan lowers to: sums, reduce-scatters and all-gathers over
the whole group, the neighbour exchange of the ring schedules, and the
subgroups the two-level schedules run over (:meth:`ReplicaGroup.split`).
With one replica every collective is the identity.

``mesh_from_strategy`` sizes the group as the JAX package sizes the
mesh's data axis: the strategy's replica list, capped by what the run
has (there, the visible devices; here, the processes).
"""
import torch
import torch.distributed as dist

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
    def all_reduce(self, x):
        """Sum of ``x`` over the replicas (a new tensor)."""
        out = x.clone()
        if self.size > 1:
            dist.all_reduce(out, group=self.group)
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

    def shift(self, x):
        """Ring neighbour exchange: send ``x`` to replica ``rank + 1``,
        return what replica ``rank - 1`` sent (the ``ppermute`` of the
        JAX ring schedules)."""
        if self.size == 1:
            return x
        out = torch.empty_like(x)
        src = self._global((self.rank - 1) % self.size)
        dst = self._global((self.rank + 1) % self.size)
        ops = [dist.P2POp(dist.isend, x.contiguous(), dst, self.group),
               dist.P2POp(dist.irecv, out, src, self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out

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


def data_axis_node_groups(group, forced_nodes=0, ranks_per_node=None):
    """Node groups over the data axis for two-level schedules, or None
    when the group is effectively one node (the flat emission).

    ``forced_nodes >= 2`` (``AUTODIST_HIERARCHY_NODES``) asks for that
    many contiguous equal groups; otherwise ``ranks_per_node`` (the
    resource spec's node sizes, in rank order) splits the ranks by
    host. Groups must be equal and at least 2 wide, as in the JAX
    package."""
    n = group.size
    if n <= 1:
        return None
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
