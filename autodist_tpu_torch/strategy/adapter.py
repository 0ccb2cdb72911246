"""Bridge: reference-style strategies over the port's models.

The counterpart of ``autodist_tpu/strategy/adapter.py``.
:class:`PytreeGraphItem` adapts a port model's parameters to the
GraphItem interface the builders consume, naming each variable by its
JAX pytree path (``'blocks/mlp/up/kernel'``), so every builder produces
the same ``node_config`` in both packages.

:func:`trainer_from_strategy` builds the strategy and a data-parallel
:class:`~autodist_tpu_torch.api.Trainer`. Variables the strategy leaves
unpartitioned (AllReduce, plain PS) are replicated, which is what the
Trainer does. A partitioned placement is the ZeRO realization of PS in
the JAX package; at dp = 1 it is a no-op there and here, and at dp > 1
it raises until the ZeRO/PS slice of the port.
"""
import numpy as np

import torch.distributed as dist

from autodist_tpu_torch.models.weights import flatten_tree


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
    return trainer
