"""Bridge: reference-style strategies over the port's models.

The counterpart of ``autodist_tpu/strategy/adapter.py``.
:class:`FunctionalModel` wraps a user's own init and loss functions
(over a nested dict of tensors) in the port's model protocol, so a
third-party model trains under any builder. :class:`PytreeGraphItem` adapts a port model's parameters to the
GraphItem interface the builders consume, naming each variable by its
JAX pytree path (``'blocks/mlp/up/kernel'``), so every builder produces
the same ``node_config`` in both packages.

:func:`trainer_from_strategy` builds the strategy and a data-parallel
:class:`~autodist_tpu_torch.api.Trainer`, with the strategy's gradient
buckets (:func:`grad_bucket_layout`) as ``trainer.grad_buckets``.
Variables the strategy leaves unpartitioned (AllReduce, plain PS) are
replicated, which is what the Trainer does. A partitioned placement
(PartitionedPS, UnevenPartitionedPS, PartitionedAR,
RandomAxisPartitionAR) is the ZeRO realization of PS in the JAX package:
:func:`apply_strategy_to_shardings` maps each partitioned variable to
its shard dim over the data group, which the Trainer holds sharded (the
parameter and its optimizer slots, this rank's slice of each). At
dp = 1 it is a no-op there and here.
"""
import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from autodist_tpu_torch.const import DEFAULT_CHUNK_SIZE
from autodist_tpu_torch.models.weights import flatten_tree
from autodist_tpu_torch.strategy.base import AllReduceSynchronizer
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.utils.device import resolve_device


class _Node(nn.Module):
    """One level of a FunctionalModel's tree: its leaves as parameters,
    its sub-dicts as child nodes, each under its key."""

    def __init__(self, tree, device):
        super().__init__()
        self._keys = sorted(tree)
        for k in self._keys:
            if '.' in k or '/' in k:
                raise ValueError('FunctionalModel: a tree key may hold '
                                 'neither "." nor "/", got %r' % k)
            v = tree[k]
            if isinstance(v, dict):
                self.add_module(k, _Node(v, device))
            else:
                self.register_parameter(k, nn.Parameter(
                    torch.as_tensor(v).detach().to(device,
                                                   torch.float32).clone()))

    def tree(self):
        return {k: getattr(self, k).tree() if isinstance(
            getattr(self, k), _Node) else getattr(self, k)
            for k in self._keys}


class FunctionalModel(_Node):
    """Zero-touch adapter for a user's own functional model.

    The reference distributes unmodified user Keras/TF code by patching
    TF (``autodist/patch.py:96-197``); the JAX package wraps a user's
    ``init_fn`` and ``loss_fn`` over a param pytree. Here the same
    arguments, over a nested dict of tensors:

    - ``init_fn(generator) -> nested dict of tensors``, from a CPU
      ``torch.Generator`` (called once here, with seed 0, for the
      shapes; the Trainer's ``init(seed)`` calls it again);
    - ``loss_fn(params, batch) -> scalar`` or ``(sum, count)``: the pair
      is the global mean over the data-parallel group (see
      :mod:`autodist_tpu_torch.api`);
    - ``axes``: optional tree of logical-axis tuples, one entry a dim
      (default: every leaf unannotated, replicated until a strategy
      shards it);
    - ``apply_fn(params, *inputs)``: optional, for serving and export.

    The tree is held as nested modules under its own keys, so
    ``state_dict`` keys are the JAX pytree paths with ``.`` for ``/``
    and ``params()`` is the tree of the live ``nn.Parameter``s (f32
    master weights on ``device``, the card unless the caller names
    another). An unmodified ``torch.nn.Module`` trains through it with
    ``torch.func.functional_call`` inside the user's own ``loss_fn``::

        net = MyNet()
        def loss_fn(params, batch):
            flat = {'.'.join(p): v for p, v in flatten_tree(params)}
            logits = torch.func.functional_call(net, flat, (batch['x'],))
            return F.cross_entropy(logits, batch['y'].long())
    """

    def __init__(self, init_fn, loss_fn, axes=None, apply_fn=None,
                 device=None):
        dev = resolve_device(device)
        super().__init__(init_fn(torch.Generator().manual_seed(0)), dev)
        self._init_fn, self._loss_fn = init_fn, loss_fn
        self._axes, self._apply_fn = axes, apply_fn

    def params(self):
        return self.tree()

    def axes(self):
        if self._axes is not None:
            return self._axes

        def unannotated(tree):
            return {k: unannotated(v) if isinstance(v, dict)
                    else (None,) * v.dim() for k, v in tree.items()}
        return unannotated(self.params())

    def has_state(self):
        return False

    def loss(self, params, batch):
        return self._loss_fn(params, batch)

    def apply(self, params, *inputs, **kwargs):
        if self._apply_fn is None:
            raise ValueError('FunctionalModel has no apply_fn')
        return self._apply_fn(params, *inputs, **kwargs)

    @torch.no_grad()
    def reset_parameters(self, generator):
        """Fresh values from ``init_fn(generator)``, in place."""
        fresh = dict(flatten_tree(self._init_fn(generator)))
        for path, p in flatten_tree(self.params()):
            p.copy_(torch.as_tensor(fresh[path]))


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


def apply_strategy_to_shardings(strategy, graph_item, dp):
    """The per-variable shard dims a built Strategy lays over the data
    axis (the JAX function of the same name refines a tree of
    ``NamedSharding``s; here the Trainer takes ``{name: dim}``).

    A partitioned (PS or AR) variable shards its state over the data
    group along the strategy's partition axis when that axis divides by
    ``dp``; otherwise, and for every unpartitioned variable (a plain PS
    variable is the degenerate single shard), it stays replicated. The
    Trainer lays a dim out over the data group only when no model or
    expert group splits it, as the JAX function extends a leaf's spec
    only where it is None."""
    out = {}
    if dp <= 1:
        return out
    for node in strategy.node_config:
        axis = node.partition_axis
        if axis is None:
            continue
        try:
            var = graph_item.var_by_name(node.var_name)
        except KeyError:
            continue
        if var.shape[axis] % dp == 0 and var.shape[axis] >= dp:
            out[node.var_name] = axis
        else:
            logging.debug('Cannot shard %s axis %d over data (%s)',
                          node.var_name, axis, var.shape)
    return out


def trainer_from_strategy(model, optimizer, strategy_builder,
                          resource_spec=None, spec=None, **kw):
    """Build a Trainer placed by a reference-style strategy built by
    ``strategy_builder`` over the model's parameters: partitioned
    variables shard over the data group (``trainer.partition_dims``).
    ``spec`` passes through, its tensor and expert axes included; under
    a ``dcn_dp`` above 1, a ``resource_spec`` given here also hands the
    Trainer its ranks a node (the ``dcn_dp`` check)."""
    from autodist_tpu_torch.api import Trainer
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.runtime.device_resolver import DeviceResolver

    gi = PytreeGraphItem(model)
    n = dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1
    if resource_spec is not None and spec is not None and \
            spec.dcn_dp > 1 and 'ranks_per_node' not in kw:
        kw['ranks_per_node'] = DeviceResolver(resource_spec,
                                              n).ranks_per_node()
    if resource_spec is None:
        resource_spec = ResourceSpec(resource_info={'nodes': [{
            'address': 'localhost', 'chief': True, 'cpus': [0],
            'gpus': list(range(n)), 'network_bandwidth': 100}]})
    strategy = strategy_builder.build(gi, resource_spec)
    trainer = Trainer(model, optimizer, spec=spec, **kw)
    trainer.partition_dims = apply_strategy_to_shardings(strategy, gi,
                                                         trainer.dp)
    trainer.strategy = strategy
    trainer.grad_buckets = grad_bucket_layout(strategy, gi)
    return trainer
