"""Variable partitioning math (reference kernel/partitioner.py).

The reference's ``VariablePartitioner`` performs GraphDef surgery to
split variables/optimizer slots/gradients into shard variables
(partitioner.py:349-714). Under SPMD none of that surgery exists — a
"partitioned variable" is an array with a sharded dimension — so this
module keeps the *decision* layer with reference-compatible semantics:

- :class:`PartitionerConfig`: parse/serialize the ``"2,1"`` shard-spec
  strings (one active axis only, partitioner.py:38-150);
- shard-size computation incl. the uneven case (UnevenPartitionedPS
  splits N into k parts where k need not divide N — numpy
  ``array_split`` semantics);
- the logical<->sharded index mapping used by sparse (embedding-row)
  updates (partitioner.py:660-684 splits IndexedSlices by index range).
"""
import numpy as np


class PartitionerConfig:
    """One variable's partition spec, e.g. '4,1' = 4 shards on axis 0."""

    def __init__(self, partition_str='', partition_list=None):
        if partition_list is not None:
            self.partition_list = [int(p) for p in partition_list]
        elif partition_str:
            self.partition_list = [int(p) for p in
                                   partition_str.split(',')]
        else:
            self.partition_list = []
        active = [i for i, p in enumerate(self.partition_list) if p > 1]
        if len(active) > 1:
            raise ValueError(
                'Only one partition axis is supported (got %r)'
                % (self.partition_list,))
        self.axis = active[0] if active else None
        self.num_shards = self.partition_list[self.axis] if active else 1

    @property
    def partition_str(self):
        return ','.join(str(p) for p in self.partition_list)

    def __eq__(self, other):
        return isinstance(other, PartitionerConfig) and \
            self.partition_list == other.partition_list

    def __repr__(self):
        return '<PartitionerConfig %s>' % (self.partition_str or '1')

    # -- shard geometry ----------------------------------------------------
    def shard_sizes(self, dim_size):
        """Per-shard sizes along the active axis (uneven allowed;
        np.array_split semantics: larger shards first)."""
        if self.axis is None:
            return [int(dim_size)]
        base, rem = divmod(int(dim_size), self.num_shards)
        return [base + (1 if i < rem else 0)
                for i in range(self.num_shards)]

    def shard_offsets(self, dim_size):
        sizes = self.shard_sizes(dim_size)
        return list(np.cumsum([0] + sizes[:-1]))

    def shard_shapes(self, shape):
        if self.axis is None:
            return [tuple(shape)]
        out = []
        for size in self.shard_sizes(shape[self.axis]):
            s = list(shape)
            s[self.axis] = size
            out.append(tuple(s))
        return out

    def split(self, array):
        """Split a host array into shard arrays (axis 0 of the spec)."""
        if self.axis is None:
            return [array]
        return np.array_split(array, self.num_shards, axis=self.axis)

    def merge(self, shards):
        """Inverse of split — reassemble the logical array."""
        if self.axis is None:
            (only,) = shards
            return only
        return np.concatenate(shards, axis=self.axis)

    # -- sparse index mapping (embedding rows) ----------------------------
    def shard_of_index(self, indices, dim_size):
        """Shard id + local row for each logical row index
        (reference splits IndexedSlices by index range,
        partitioner.py:660-684)."""
        if self.axis != 0:
            raise ValueError('sparse partitioning requires axis 0')
        offsets = np.asarray(self.shard_offsets(dim_size) +
                             [int(dim_size)])
        indices = np.asarray(indices)
        shard = np.searchsorted(offsets, indices, side='right') - 1
        local = indices - offsets[shard]
        return shard, local


def smallest_nontrivial_divisor(n):
    """min k>=2 dividing n, else n (partitioned_ps_strategy.py:126-134)."""
    for i in range(2, n):
        if n % i == 0:
            return i
    return n


def smallest_non_divisor(n):
    """min k>=2 NOT dividing n (uneven_partition_ps_strategy.py:125-133)."""
    for i in range(2, n):
        if n % i != 0:
            return i
    return n
