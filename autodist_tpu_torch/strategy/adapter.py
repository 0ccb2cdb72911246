"""Bridge: reference-style strategies over the port's models.

The counterpart of ``autodist_tpu/strategy/adapter.py``.
:class:`PytreeGraphItem` adapts a port model's parameters to the
GraphItem interface the builders consume, naming each variable by its
JAX pytree path (``'blocks/mlp/up/kernel'``), so every builder produces
the same ``node_config`` in both packages.

:func:`trainer_from_strategy` builds the strategy and a data-parallel
:class:`~autodist_tpu_torch.api.Trainer`, with the strategy's gradient
buckets (:func:`grad_bucket_layout`) as ``trainer.grad_buckets``.
Variables the strategy leaves unpartitioned (AllReduce, plain PS) are
replicated, which is what the Trainer does. A partitioned placement is
the ZeRO realization of PS in the JAX package; at dp = 1 it is a no-op
there and here, and at dp > 1 it raises until the ZeRO/PS slice of the
port.
"""
import numpy as np

import torch.distributed as dist

from autodist_tpu_torch.const import DEFAULT_CHUNK_SIZE
from autodist_tpu_torch.models.weights import flatten_tree
from autodist_tpu_torch.strategy.base import AllReduceSynchronizer


class _VarLike:
    """Duck-typed Variable for strategy builders (shape/dtype/name)."""

    def __init__(self, name, shape, dtype, sparse=False):
        self.name = name
        self.shape = tuple(int(d) for d in shape)
        self.dtype = np.dtype(dtype)
        self.sparse_read = sparse

    @property
    def nbytes(self):
        n = self.dtype.itemsize
        for d in self.shape:
            n *= d
        return n


class PytreeGraphItem:
    """GraphItem facade over a port model's parameters.

    State leaves (BatchNorm's running statistics, buffers in the port)
    are variables too, as they are leaves of the JAX params tree, so a
    model with BatchNorm gets the JAX builders' ``node_config``.
    A variable whose logical axes include ``vocab`` is flagged sparse
    (embedding tables get gather-style gradients), which is what
    Parallax keys its dense/sparse split on."""

    def __init__(self, model):
        self.model = model
        axes = dict(flatten_tree(model.axes()))
        self._vars = {}
        for path, p in flatten_tree(model.params()):
            name = '/'.join(path)
            self._vars[name] = _VarLike(name, p.shape, np.float32,
                                        sparse='vocab' in axes[path])

    @property
    def trainable_var_op_to_var(self):
        return self._vars

    def is_sparse(self, var):
        return var.sparse_read

    def var_by_name(self, name):
        return self._vars[name]

    def prepare(self):
        return self


def grad_bucket_layout(strategy, graph_item):
    """Byte-capped gradient-bucket layout for a strategy's AllReduce vars.

    The packing the execution plan applies when it syncs gradients
    (``parallel.plan.pack_buckets``: same-(group, compressor, spec)
    variables, reverse production order, cap from the synchronizer's
    ``chunk_size`` / ``AUTODIST_BUCKET_BYTES``), computed from the
    strategy and the variable shapes alone, so a caller can audit the
    layout without running a step. Returns ``[{'group', 'vars': [names],
    'bytes'}]`` in emission order, as the JAX package's function does.
    """
    # plan.py imports the strategy package: import it here, at call time
    from autodist_tpu_torch.parallel.plan import bucket_bytes_cap, pack_buckets

    # the plan's grouping key: stateless compressors only (stateful ones
    # reduce per variable), split by gradient dtype, by the hierarchical
    # knob and by the weight-update-sharding knob
    groups = {}   # (group, compressor, spec, dtype, hier, wus) -> items
    for node in strategy.node_config:
        sync = node.synchronizer if not node.part_config \
            else node.part_config[0]
        if not isinstance(sync, AllReduceSynchronizer):
            continue
        if sync.compressor not in ('NoneCompressor',
                                   'HorovodCompressor'):
            continue
        try:
            var = graph_item.var_by_name(node.var_name)
        except KeyError:
            continue
        nbytes = int(np.prod(var.shape or (1,))) * \
            np.dtype(var.dtype).itemsize
        wus = sync.weight_update_sharding or 'never'
        if getattr(var, 'sparse_read', False):
            wus = 'ineligible'   # the plan's row-lazy exclusion
        groups.setdefault(
            (sync.group, sync.compressor, sync.spec,
             str(np.dtype(var.dtype)), sync.hierarchical or 'auto', wus),
            []).append((node.var_name, nbytes, sync.chunk_size))
    out = []
    for (group, *_), items in sorted(groups.items(), reverse=True):
        chunk = max(c for _, _, c in items)
        cap = bucket_bytes_cap(chunk)
        rev = [(name, nbytes) for name, nbytes, _ in reversed(items)]
        sizes = dict(rev)
        for bucket in pack_buckets(rev, cap, chunk or DEFAULT_CHUNK_SIZE):
            out.append({'group': group, 'vars': list(bucket),
                        'bytes': sum(sizes[n] for n in bucket)})
    return out


def trainer_from_strategy(model, optimizer, strategy_builder,
                          resource_spec=None, spec=None, **kw):
    """Build a Trainer placed by a reference-style strategy built by
    ``strategy_builder`` over the model's parameters."""
    from autodist_tpu_torch.api import Trainer
    from autodist_tpu_torch.resource_spec import ResourceSpec

    gi = PytreeGraphItem(model)
    if resource_spec is None:
        n = dist.get_world_size() if dist.is_available() and \
            dist.is_initialized() else 1
        resource_spec = ResourceSpec(resource_info={'nodes': [{
            'address': 'localhost', 'chief': True, 'cpus': [0],
            'gpus': list(range(n)), 'network_bandwidth': 100}]})
    strategy = strategy_builder.build(gi, resource_spec)
    trainer = Trainer(model, optimizer, spec=spec, **kw)
    partitioned = [n.var_name for n in strategy.node_config
                   if n.partition_axis is not None]
    if partitioned and trainer.dp > 1:
        raise NotImplementedError(
            'strategy partitions %d variables (e.g. %s): sharded state '
            'over dp=%d waits for the ZeRO/PS slice of the port'
            % (len(partitioned), partitioned[0], trainer.dp))
    trainer.strategy = strategy
    trainer.grad_buckets = grad_bucket_layout(strategy, gi)
    return trainer
