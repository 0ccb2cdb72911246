"""Functional training API of the port: data-parallel ``Trainer``.

The counterpart of ``autodist_tpu/api.py``. The user hands a model, an
optimizer factory (:mod:`autodist_tpu_torch.optim`) and a
:class:`ParallelSpec` to :class:`Trainer`, which exposes the same
ergonomics: ``init`` / ``shard_batch`` / ``step`` / ``compile_step`` /
``fit`` / ``evaluate`` / ``profile`` / ``save_state`` /
``restore_state`` / ``get_params``.

Data parallelism runs over ``torch.distributed`` (NCCL on the card, gloo
on the CPU), on the default process group when one is initialized. Each
rank takes its share of the global batch, as ``P('data')`` does in the
JAX package, runs forward and backward on it, and the gradients are
all-reduced before the optimizer step. The loss is the JAX package's
mean over the global batch:

- without a mask, each rank's mean, averaged over the ranks (the ranks
  hold equal slices, so that is the global mean);
- with a ``mask`` and a model with ``per_token_loss``, the global masked
  mean ``sum(nll * mask) / max(sum(mask), 1)``: the mask count is
  all-reduced first, each rank differentiates its masked sum over that
  global count, and the gradients are summed over the ranks;
- plus, for a model with an ``aux_loss_weight`` (the MoE
  ``TransformerLM``), that weight times the model's aux loss, in both
  cases: with a mask each rank adds ``1/world`` of its aux, so the sum
  over the ranks takes their mean. The MoE load-balance loss is a
  product of two batch means; its first-choice fractions are averaged
  over the group inside the model (``core.mean_over_batch``), so the
  mean over the ranks is the global value.

A user ``loss_fn`` (or a model's ``loss``) may return a pair ``(sum,
count)``: the count is all-reduced first, each rank differentiates its
sum over the global count (floored at 1), and the gradients are summed
over the ranks, exactly as the built-in masked mean; so the loss is the
global batch's, as the JAX ``loss_fn`` sees it through GSPMD. A scalar
``loss_fn`` is taken per rank and averaged over the ranks, which is the
global value only for a loss that is a mean over equal slices (a
warning is logged once when one runs at dp > 1 on a batch with a
``mask``). With one rank there is no collective.

``ParallelSpec.grad_accum`` splits the global batch into chunks of
consecutive rows, as the JAX step does, and averages the chunks' losses
and gradients; ``shard_batch`` then gives each rank its dp-slice of every
chunk, so each chunk is the JAX chunk. ``remat='full'`` recomputes the
whole loss in the backward (``torch.utils.checkpoint``, the port of
``jax.checkpoint``).

PyTorch runs eagerly, so ``compile_step`` compiles nothing: it returns
the step callable for an already-sharded batch. The port updates the
model's parameters and the optimizer state in place; ``TrainState``
holds references to both.

Every loss runs under ``model_mode(training=...)`` with the
data-parallel group. A model with state (BatchNorm running statistics,
as buffers) records updates there; they are
written into the buffers after the optimizer step, as the JAX package
folds them into the params tree (under ``grad_accum``, the last chunk's
updates). The step hands the data-parallel group to the model on that
collector, so BatchNorm reduces its moments over the whole global batch:
in the JAX package data parallelism is GSPMD's, and a mean over the
batch axis is a mean over the global batch.

The ranks form a grid (:class:`RankGrid`) laid as the JAX package lays
its mesh; with only the data and seq axes, rank ``r = d·sp + s``.

*Sequence parallelism* (``ParallelSpec(sp > 1, sp_mode=...)``, the JAX
step's manual seq region): ``shard_batch`` also slices dim 1 of every
leaf of rank >= 2 over the seq group, the model runs on its slice under
``model_mode(seq=...)`` (ring or Ulysses attention over the seq group,
global positions), and the loss is the model's per-token NLL's global
masked mean over the data x seq tokens (the count all-reduced over the
grid; without a mask every token counts) plus ``aux_loss_weight`` times
the aux averaged over the grid: the MoE fractions reduce over the data
group inside the model, so the mean over the seq ranks is the JAX
``pmean``. As in the JAX package, this loss replaces a user
``loss_fn``. The gradients of the replicated parameters are summed over
the whole grid.

*Sharded training state* (the JAX ``_zero_extend`` and
``apply_strategy_to_shardings``): each trainable leaf may have a shard
dim over the data group, :meth:`Trainer.shard_dims`. With ``zero >= 2``
it is the first dim that divides by dp; for a variable a strategy
partitions (``partition_dims``, installed by ``trainer_from_strategy``)
it is the strategy's partition axis when that divides. A sharded leaf's
optimizer slots exist only for this rank's slice: its gradient is
reduce-scattered along the shard dim, the optimizer steps on the slice.
Under ``zero == 3`` and for a partitioned variable the parameter itself
is held as the slice, and a differentiable all-gather (its backward a
reduce-scatter) hands the full tensor to the loss, which frees it after
the backward; under ``zero == 2`` the full parameter is kept and
all-gathered from the slices after the step. Buffers (BatchNorm
statistics) stay replicated. ``get_params``, ``save_state``,
``restore_state``, ``evaluate``, ``fit`` and ``profile`` see the
logical (full) layout, so either package restores the other's
checkpoint; with sharded state ``get_params`` and ``save_state`` gather,
so every rank calls them.

*Tensor and expert parallelism* (``ParallelSpec(tp > 1)``, ``ep > 1``;
the GSPMD half of the JAX step): the grid grows to the JAX mesh's
(data, pipe, seq, expert, model) axes, rank ``r = (((d·sp + s)·ep +
e)·tp + t)``. Every leaf is laid out by ``spec_for_axes`` of its logical
axes over the grid: a dim bound to the model or expert axis is split
over that group (by the leaf's ``ParamDef.view`` where it has one), and
the model's parameter is this rank's shard, which the modules run on
(Megatron's column- and row-parallel products, the vocab-sharded
embedding and cross-entropy). The batch rides the data and seq axes
alone, so the ranks of a model or expert group hold the same rows, and
the gradient of a parameter replicated over those groups comes out
whole and equal on each of them. So the gradients, the loss and the
token counts reduce over the data x seq ranks only (``grid.batch``).
ZeRO's data dim is the first dim that no group splits and that divides
by dp, as JAX ``_zero_extend`` picks it; a strategy's partition dim
takes the data axis only when no group splits it. ``get_params``,
``save_state`` and ``state_sharding`` see the JAX layout (the shards
gathered). ``ParallelSpec(dcn_dp)`` lays the data axis out in that many
contiguous blocks (``grid.node_groups``).

*Pipeline parallelism* (``ParallelSpec(pp > 1, microbatches,
pp_schedule, pp_variant)``, the JAX step's manual pipe region): rank ``r
= ((((d·pp + p)·sp + s)·ep + e)·tp + t)``, and the ``'stage'`` dim of
the stacked blocks is split over the pipe group like a model-axis split
(``n_layers % pp`` raises ``ValueError``), so stage ``p`` holds layers
``[p·L/pp, (p+1)·L/pp)``. Every rank of a pipe group gets the same
batch slice. The model runs under ``model_mode(pipe=..., options=...)``,
which takes the transformer through the GPipe or 1F1B schedule of
:mod:`autodist_tpu_torch.parallel.pipeline`; the loss is the global
masked mean, as under sequence parallelism (a user ``loss_fn`` is
replaced, as in the JAX package). The model hands back per-rank
partials: the last stage's NLL, zeros elsewhere, and each stage's aux;
each rank differentiates its part and the parts' sum over the pipe group
is the loss, so every rank's metric is the global value. A leaf the
stages split reduces its gradient over the data x seq ranks as before;
every other leaf (the embeddings, ln_f, the lm head) is summed over the
data x pipe x seq ranks, the stages that did not use it adding zeros.
``remat='full'`` checkpoints each microbatch's stage (and the last
stage's head and NLL) rather than the whole loss: a recompute of the
schedule inside autograd's backward could not keep the stages in step.
"""
import copy
import os
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from autodist_tpu_torch import optim
from autodist_tpu_torch.const import (AXIS_DATA, AXIS_EXPERT, AXIS_MODEL,
                                      AXIS_PIPELINE, AXIS_SEQUENCE)
from autodist_tpu_torch.models import weights
from autodist_tpu_torch.models.core import (apply_tree_updates,
                                            assign_state_paths, model_mode)
from autodist_tpu_torch.parallel.axes import ParallelSpec, spec_for_axes
from autodist_tpu_torch.parallel.mesh import RankGrid, all_gather
from autodist_tpu_torch.telemetry import core as _telemetry
from autodist_tpu_torch.utils import logging


@dataclass
class TrainState:
    params: Any          # {name: nn.Parameter}, the model's own
    opt_state: Any       # the torch.optim.Optimizer over them
    step: int = 0


@dataclass
class _Leaf:
    """One leaf of the model's params tree and where its state lives."""
    path: tuple                 # its JAX path
    tensor: torch.Tensor        # the model's parameter or buffer
    shape: tuple                # the full (logical) shape
    work: tuple                 # the shape its splits cut (its view's)
    splits: list                # [(work dim, 'model' | 'expert')]
    dim: Optional[int]          # shard dim over the data group, or None
    held: bool                  # the parameter holds its data slice only
    opt: Optional[torch.Tensor]  # what the optimizer steps (None: buffer)

    @property
    def name(self):
        return '/'.join(self.path)


class Trainer:
    """Drive data-parallel training of a port model.

    Args:
        model: a port :class:`~autodist_tpu_torch.models.core.Module` with
            ``params``/``apply`` (and ``loss(params, batch)`` unless
            ``loss_fn`` is given); its device is the trainer's.
        optimizer: ``params -> torch.optim.Optimizer`` (e.g.
            ``optim.adamw(1e-4)``).
        spec: :class:`ParallelSpec`; defaults to DP over every rank.
        loss_fn: ``loss_fn(params, batch) -> scalar`` or ``(sum,
            count)`` (the global mean over the group, see the module
            docstring); defaults to ``model.loss``.
        process_group: the group of the grid's ranks; defaults to the
            default group when ``torch.distributed`` is initialized.
            Every rank constructs the Trainer (the grid's subgroups are
            made here, a collective).
        ranks_per_node: the resource spec's ranks on each node, in rank
            order; under ``dcn_dp > 1`` they must span ``dcn_dp`` nodes.

    ``partition_dims`` ({variable name: dim}) shards those variables'
    state over the data group; ``trainer_from_strategy`` installs it
    from the strategy before ``init``.
    """

    def __init__(self, model, optimizer, spec=None, loss_fn=None,
                 process_group=None, ranks_per_node=None):
        self.model = model
        self.optimizer = optimizer
        self.spec = spec or ParallelSpec()
        self._loss_fn = loss_fn
        self._warned_scalar = False
        self.group = process_group
        if dist.is_available() and dist.is_initialized():
            self.world = dist.get_world_size(process_group)
            self.rank = dist.get_rank(process_group)
        else:
            self.world, self.rank = 1, 0
        self.dp = self.spec.resolve_dp(self.world)
        self.sp, self.tp, self.ep, self.pp = (
            int(self.spec.sp), int(self.spec.tp), int(self.spec.ep),
            int(self.spec.pp))
        if self.pp > 1 and not hasattr(model, 'per_token_loss'):
            raise ValueError('ParallelSpec(pp=%d) needs a model with '
                             'per_token_loss' % self.pp)
        self.rules = self.spec.rules
        self.accum = max(1, int(self.spec.grad_accum))
        self.device = next(model.parameters()).device
        self.grid = RankGrid(self.dp, self.sp, self.rank, process_group,
                             self.device, ep=self.ep, tp=self.tp,
                             dcn_dp=self.spec.dcn_dp,
                             ranks_per_node=ranks_per_node, pp=self.pp)
        # the ranks that hold other tokens: data x seq
        self.replicas = self.grid.batch.size
        # the ranks a loss's parts are summed over: data x pipe x seq
        self._parts = self.grid.group(AXIS_DATA, AXIS_PIPELINE,
                                      AXIS_SEQUENCE)
        self.partition_dims = {}
        # split over the model and expert groups; replicated over data
        # until ``init`` lays the state out by its data dims
        self._leaves = self._layout(shard=False)
        self._has_state = model.has_state()
        if self._has_state:
            assign_state_paths(model)
        logging.info('Trainer: dp=%d pp=%d sp=%d (%s) ep=%d tp=%d '
                     'dcn_dp=%d zero=%d on %s, grad_accum=%d, remat=%s',
                     self.dp, self.pp, self.sp, self.spec.sp_mode,
                     self.ep, self.tp, self.spec.dcn_dp, self.spec.zero,
                     self.device, self.accum, self.spec.remat)

    # -- sharded state -----------------------------------------------------
    def _splits(self, name, shape, axes, view):
        """A leaf's split over the model, expert and pipe groups: (the
        shape the splits cut, [(its dim, 'model' | 'expert' | 'pipe')]).
        A leaf with a ``view`` is cut along the view's dims when a group
        splits it."""
        work, work_axes = shape, axes
        if view is not None and any(spec_for_axes(view[1], self.rules,
                                                  self.grid.shape)):
            work, work_axes = tuple(view[0]), view[1]
        splits = []
        for i, axis in enumerate(spec_for_axes(work_axes, self.rules,
                                               self.grid.shape)):
            if axis is None:
                continue
            if axis not in (AXIS_MODEL, AXIS_EXPERT, AXIS_PIPELINE):
                raise NotImplementedError(
                    '%s: the rules bind its dim %d to the %r axis; the '
                    'port shards parameters over the model, expert and '
                    'pipe axes' % (name, i, axis))
            if work[i] % self.grid.shape[axis]:
                raise ValueError(
                    '%s: dim %d of %s (size %d) does not divide over the '
                    '%d ranks of the %r axis'
                    % (name, i, work, work[i], self.grid.shape[axis], axis))
            splits.append((i, axis))
        return work, splits

    def _shard_dim(self, name, shape, axes):
        """A trainable leaf's shard dim over the data group and whether
        the parameter is held as that slice: the strategy's partition
        axis for a partitioned variable (held), else under ``zero >= 2``
        the first dim that divides by dp (held under ``zero == 3``), as
        the JAX ``_zero_extend``; a dim some group already splits never
        takes the data axis. (None, False) when replicated."""
        if self.dp <= 1:
            return None, False
        spec = spec_for_axes(axes, self.rules, self.grid.shape)
        free = [i for i in range(len(shape))
                if i >= len(spec) or spec[i] is None]
        if self.partition_dims.get(name) in free:
            return self.partition_dims[name], True
        if self.spec.zero >= 2:
            for i in free:
                if shape[i] % self.dp == 0 and shape[i] >= self.dp:
                    return i, self.spec.zero >= 3
        return None, False

    def shard_dims(self):
        """``{variable name: shard dim over the data group, or None}`` for
        every leaf of the params tree (buffers replicate), as ``init``
        laid the state out: the position of ``'data'`` in the JAX
        trainer's sharding of the leaf's optimizer slots, and, under
        ``zero == 3`` or for a partitioned variable, of the parameter
        itself (:meth:`state_sharding`)."""
        return {l.name: l.dim for l in self._leaves}

    def state_sharding(self):
        """``{'params': {name: dim}, 'opt_state': {name: dim}, 'groups':
        {name: {axis: dim}}}``: the data group's dim in each leaf of the
        parameters and of the optimizer slots as this trainer holds them
        (None: replicated), and the leaf dims the model and expert groups
        split (in the leaf's view's dims where it has one)."""
        return {'params': {l.name: l.dim if l.held else None
                           for l in self._leaves},
                'opt_state': self.shard_dims(),
                'groups': {l.name: {axis: d for d, axis in l.splits}
                           for l in self._leaves}}

    def _slice(self, x, dim):
        """This rank's slice of a tensor along ``dim`` over the data
        group."""
        c = x.shape[dim] // self.dp
        return x.narrow(dim, self.grid.data_index * c, c)

    def _local(self, x, l, data):
        """This rank's shard of the full tensor ``x`` of leaf ``l``: its
        model and expert splits, and with ``data`` its data slice."""
        if l.splits:
            x = x.reshape(l.work)
            for d, axis in l.splits:
                group = self.grid.group(axis)
                c = x.shape[d] // group.size
                x = x.narrow(d, group.rank * c, c)
            x = x.reshape(self._local_shape(l))
        if data and l.dim is not None:
            x = self._slice(x, l.dim)
        return x

    def _gather(self, t, l, data):
        """The full tensor of leaf ``l`` from this rank's shard ``t`` (the
        inverse of :meth:`_local`; a collective on every group that
        splits it)."""
        if data and l.dim is not None:
            t = self.grid.data.all_gather(t, l.dim)
        if l.splits:
            x = t.reshape(self._local_work(l))
            for d, axis in reversed(l.splits):
                x = self.grid.group(axis).all_gather(x, d)
            t = x.reshape(l.shape)
        return t

    def _local_work(self, l):
        """The shape of leaf ``l``'s model / expert shard in its work
        dims."""
        work = list(l.work)
        for d, axis in l.splits:
            work[d] //= self.grid.shape[axis]
        return tuple(work)

    def _local_shape(self, l):
        """The shape of leaf ``l``'s model / expert shard in its own
        dims: a view splits the leaf's last dim, so its trailing dims
        merge back."""
        work = self._local_work(l)
        if len(work) == len(l.shape):
            return work
        k = len(l.shape) - 1
        return work[:k] + (int(np.prod(work[k:])),)

    def _layout(self, shard=True):
        """Lay the model's leaves out: each leaf's parameter becomes its
        model / expert shard, and (with ``shard``) a held leaf's its data
        slice of that; a zero-2 leaf gets a slice parameter for the
        optimizer beside the shard."""
        trainable = {id(p) for p in self.model.parameters()}
        axes = dict(weights.flatten_tree(self.model.axes()))
        views = dict(weights.flatten_tree(self.model.views())) \
            if hasattr(self.model, 'views') else {}
        leaves = []
        for path, t in weights.flatten_tree(self.model.params()):
            name, shape = '/'.join(path), tuple(t.shape)
            work, splits = self._splits(name, shape, axes[path],
                                        views.get(path))
            dim, held = self._shard_dim(name, shape, axes[path]) \
                if shard and id(t) in trainable else (None, False)
            l = _Leaf(path, t, shape, work, splits, dim, held,
                      t if id(t) in trainable else None)
            if splits or held:
                t.data = self._local(t.detach(), l, held).clone()
            if dim is not None and not held:
                l.opt = torch.nn.Parameter(self._slice(t.detach(),
                                                       dim).clone())
            leaves.append(l)
        return leaves

    def _unshard(self):
        """Full-size storage for split or held leaves again (before a new
        init)."""
        for l in self._leaves:
            if tuple(l.tensor.shape) != l.shape:
                l.tensor.data = torch.empty(l.shape, dtype=l.tensor.dtype,
                                            device=l.tensor.device)
        self._leaves = []

    # -- init --------------------------------------------------------------
    def init(self, seed=0, params=None):
        """Fresh params from ``seed`` (the port's own init), or
        ``params`` in the JAX layout (nested dict of arrays); then the
        optimizer state, over this rank's slices of sharded leaves.
        Ranks start from rank 0's params."""
        self._unshard()
        if params is None:
            self.model.reset_parameters(torch.Generator().manual_seed(seed))
        else:
            weights.load_params(self.model, params)
        if self.world > 1:
            for p in list(self.model.parameters()) + \
                    list(self.model.buffers()):
                dist.broadcast(p.data, dist.get_global_rank(self.group, 0)
                               if self.group is not None else 0,
                               group=self.group)
        self._leaves = self._layout()
        opt_of = {id(l.tensor): l.opt for l in self._leaves}
        named = dict(self.model.named_parameters())
        opt = self.optimizer([opt_of[id(p)] for p in named.values()])
        if hasattr(opt, 'shard_groups'):
            # an optimizer that takes whole-leaf norms (LAMB) sums them
            # over the groups whose ranks hold the leaf's other shards
            opt.shard_groups.update({
                l.opt: [self.grid.group(axis) for axis in
                        ([AXIS_DATA] if l.dim is not None else []) +
                        [axis for _, axis in l.splits]]
                for l in self._leaves if l.opt is not None})
        return TrainState(params=named, opt_state=opt)

    def _params(self, grad=True):
        """The params tree the loss sees: held leaves all-gathered over
        the data group (differentiably with ``grad``), every other leaf
        the model's; model and expert shards stay this rank's."""
        params = self.model.params()
        held = [l for l in self._leaves if l.held]
        if not held:
            return params
        with torch.set_grad_enabled(grad and torch.is_grad_enabled()):
            full = {l.path: all_gather(self.grid.data, l.tensor, l.dim)
                    for l in held}
        return _replace(params, full)

    # -- data --------------------------------------------------------------
    def shard_batch(self, batch):
        """Global host batch -> this rank's share of every leaf's leading
        dim, as tensors on the trainer's device: rows [d·B/dp,
        (d+1)·B/dp) for data index d, or under ``grad_accum`` the d-th
        dp-slice of each of its chunks of consecutive rows; under
        ``sp > 1`` also columns [s·S/sp, (s+1)·S/sp) of dim 1 of every
        leaf of rank >= 2 for seq index s. The ranks of a model, expert
        or pipe group get the same rows. A tensor already on the
        trainer's device is taken as placed and passes through untouched
        (a batch from ``shard_batch`` or the prefetcher). On the card the
        copy leaves pinned memory with ``non_blocking=True``."""
        return self._place(batch, self.accum)

    def _place(self, batch, accum):
        # r = (((d·pp + p)·sp + s)·ep + e)·tp + t: the pipe, expert and
        # model ranks of one (d, s) take the same rows
        d_idx = self.rank // (self.pp * self.sp * self.ep * self.tp)
        s_idx = self.rank // (self.ep * self.tp) % self.sp

        def local(x):
            if isinstance(x, torch.Tensor):
                if x.device == self.device:
                    return x
                x = x.detach().cpu().numpy()
            x = np.asarray(x)
            if x.ndim == 0:
                return torch.as_tensor(x, device=self.device)
            if x.shape[0] % (self.dp * accum):
                raise ValueError('global batch dim %d does not split over '
                                 'dp=%d x grad_accum=%d'
                                 % (x.shape[0], self.dp, accum))
            n = x.shape[0] // (self.dp * accum)
            part = x.reshape((accum, self.dp, n) + x.shape[1:])[:, d_idx]
            part = part.reshape((accum * n,) + x.shape[1:])
            if self.sp > 1 and x.ndim >= 2:
                if x.shape[1] % self.sp:
                    raise ValueError('sequence dim %d does not split over '
                                     'sp=%d' % (x.shape[1], self.sp))
                c = x.shape[1] // self.sp
                part = part[:, s_idx * c:(s_idx + 1) * c]
            t = torch.from_numpy(np.ascontiguousarray(part))
            if self.device.type == 'cuda':
                return t.pin_memory().to(self.device, non_blocking=True)
            return t.to(self.device)
        return {k: local(v) for k, v in batch.items()}

    def _chunks(self, batch):
        """The ``accum`` chunks of a placed batch (views), in order."""
        if self.accum == 1:
            return [batch]

        def chunk(x, i):
            if x.ndim == 0:
                return x
            if x.shape[0] % self.accum:
                raise ValueError('grad_accum=%d does not divide batch dim %d'
                                 % (self.accum, x.shape[0]))
            n = x.shape[0] // self.accum
            return x[i * n:(i + 1) * n]
        return [{k: chunk(v, i) for k, v in batch.items()}
                for i in range(self.accum)]

    # -- the loss ----------------------------------------------------------
    def loss_for(self, params, batch):
        if self._loss_fn is not None:
            return self._loss_fn(params, batch)
        return self.model.loss(params, batch)

    def _global_mask(self, batch):
        """True when the loss is the global masked mean over the data x
        seq ranks: a mask, the model's per-token loss and no user loss_fn;
        or sequence or pipeline parallelism (with or without a mask)."""
        if self.sp > 1 or self.pp > 1:
            if not hasattr(self.model, 'per_token_loss'):
                raise ValueError('ParallelSpec(sp=%d) needs a model with '
                                 'per_token_loss' % self.sp)
            return True
        return self._loss_fn is None and 'mask' in batch and \
            hasattr(self.model, 'per_token_loss')

    def _mask_counts(self, chunks):
        """Each chunk's counted tokens over the data x seq ranks (the
        mask's sum, else every target), f32, floored at 1: one
        all-reduce for every chunk."""
        counts = torch.stack([
            c['mask'].float().sum() if 'mask' in c else
            torch.tensor(float(c['targets'].numel()), device=self.device)
            for c in chunks])
        self._all_reduce(counts)
        return torch.clamp(counts, min=1)

    def _mode(self, training):
        """``model_mode`` with the data group, the seq group, the pipe
        group and the pipeline's options, and the grid and rules that
        bind parameters to the model and expert groups."""
        spec = self.spec
        options = {'microbatches': int(spec.microbatches),
                   'pp_schedule': spec.pp_schedule,
                   'pp_variant': spec.pp_variant, 'remat': spec.remat}
        return model_mode(training=training, group=self.grid.data.group,
                          world=self.dp, seq=self.grid.seq,
                          sp_mode=spec.sp_mode, mesh=self.grid,
                          rules=self.rules, pipe=self.grid.pipe,
                          options=options)

    def _pair_mean(self, total, count):
        """This rank's part of a pair-form loss's global mean: its sum
        over the group's count (all-reduced, floored at 1)."""
        count = torch.as_tensor(count, dtype=torch.float32,
                                device=self.device).detach().clone()
        self._all_reduce(count)
        return total / torch.clamp(count, min=1)

    def _chunk_loss(self, params, chunk, count, training):
        """(the loss this rank differentiates, the state updates its
        forward recorded, whether the ranks' losses are summed). With
        ``count`` (a global mask count) that is this rank's masked sum
        over it, plus its share of the model's aux loss; with a loss
        that returns ``(sum, count)``, its sum over the global count;
        in both the ranks' parts are summed. Else the rank's mean loss,
        which the ranks average. The forward runs under ``model_mode``
        with the data group and the seq group. Under ``remat='full'``
        the forward runs again in the backward; the state updates are
        those of the first run."""
        def compute():
            if count is None:
                return self.loss_for(params, chunk)
            if hasattr(self.model, 'per_token_loss_with_aux'):
                nll, aux = self.model.per_token_loss_with_aux(params, chunk)
            else:
                nll, aux = self.model.per_token_loss(params, chunk), 0.0
            if 'mask' in chunk:
                nll = nll * chunk['mask'].to(nll.dtype)
            loss = nll.sum() / count
            weight = getattr(self.model, 'aux_loss_weight', 0.0)
            if weight:
                # the ranks' parts are summed: each adds its share of the
                # mean of the ranks' aux
                loss = loss + weight * aux / self.replicas
            return loss

        recorded = []

        def run():
            with self._mode(training) as mm:
                out = compute()
            if not recorded:
                recorded.append(mm.updates)
            return out

        if training and self.spec.remat == 'full' and self.pp == 1:
            loss = checkpoint(run, use_reentrant=False)
        else:
            loss = run()
        summed = count is not None
        if isinstance(loss, (tuple, list)):
            loss, summed = self._pair_mean(*loss), True
        elif not summed and self.replicas > 1 and 'mask' in chunk and \
                not self._warned_scalar:
            self._warned_scalar = True
            logging.warning(
                'Trainer: a scalar loss at dp=%d on a masked batch is the '
                'mean of the ranks\' losses, not the global batch\'s; '
                'return (sum, count) for the global mean', self.replicas)
        return loss, (recorded[0] if recorded else {}), summed

    # -- the step ----------------------------------------------------------
    def _step(self, state, batch):
        """One step on a placed batch. Its phases are telemetry spans
        (``trainer/step`` around ``trainer/forward`` and
        ``trainer/backward`` for each chunk, ``trainer/reduce``,
        ``trainer/optimizer`` and, under ZeRO 2, ``trainer/gather``):
        registry records under ``AUTODIST_TELEMETRY``, profiler ranges
        while a profiler records, nothing else otherwise."""
        tel = _telemetry.get()
        with tel.span('trainer/step', step=state.step):
            opt = state.opt_state
            opt.zero_grad(set_to_none=True)
            chunks = self._chunks(batch)
            global_mask = self._global_mask(batch)
            counts = self._mask_counts(chunks) if global_mask else None
            total, updates = None, {}
            for i, chunk in enumerate(chunks):
                with tel.span('trainer/forward'):
                    loss, updates, summed = self._chunk_loss(
                        self._params(), chunk,
                        None if counts is None else counts[i], True)
                with tel.span('trainer/backward'):
                    loss.backward()
                loss = loss.detach()
                total = loss if total is None else total + loss
            loss = total / self.accum if self.accum > 1 else total
            # a global mean sums the ranks' parts; a mean averages the
            # ranks' means
            ranks = 1 if summed else self.replicas
            with tel.span('trainer/reduce'):
                self._reduce_grads(self.accum * ranks)
                if self._parts.size > 1:
                    loss = loss.clone()
                    self._all_reduce(loss, ranks, self._parts)
            with tel.span('trainer/optimizer'):
                opt.step()
            self._gather_zero2(tel)
            if self._has_state:
                apply_tree_updates(self.model.params(), updates)
            state.step += 1
        return state, {'loss': loss}

    def _reduce_grads(self, divide):
        """Sum every gradient over the data x seq ranks and divide by
        ``divide``. A model or expert shard's gradient is its own, and a
        leaf those groups replicate has the same whole gradient on each
        of their ranks, so neither group takes part. A leaf with no data
        dim is all-reduced; one with a data dim is reduce-scattered over
        the data group along it (a held leaf's gather did that in its
        backward) and all-reduced over the seq group, and lands on the
        slice the optimizer steps. Under pipeline parallelism a leaf the
        stages do not split sums over the pipe group too, the stages
        that did not use it adding zeros."""
        replicated, sliced = ([], []), ([], [])
        for l in self._leaves:
            if l.opt is None:
                continue
            shared = self.pp > 1 and all(axis != AXIS_PIPELINE
                                         for _, axis in l.splits)
            if l.dim is None:
                if shared and l.tensor.grad is None:
                    l.tensor.grad = torch.zeros_like(l.tensor)
                if l.tensor.grad is not None:
                    replicated[shared].append(l.tensor.grad)
                continue
            if not l.held:
                g = l.tensor.grad
                if g is None:
                    g = torch.zeros_like(l.tensor)
                l.opt.grad = self.grid.data.reduce_scatter(g, l.dim)
                l.tensor.grad = None
            elif l.opt.grad is None:
                l.opt.grad = torch.zeros_like(l.opt)
            sliced[shared].append(l.opt.grad)
        _sum(self.grid.batch, replicated[False], divide)
        _sum(self._parts, replicated[True], divide)
        _sum(self.grid.seq, sliced[False], divide)
        _sum(self.grid.group(AXIS_PIPELINE, AXIS_SEQUENCE), sliced[True],
             divide)

    @torch.no_grad()
    def _gather_zero2(self, tel):
        """A zero-2 leaf's full parameter from the slices just stepped,
        inside a ``trainer/gather`` span where there is such a leaf."""
        leaves = [l for l in self._leaves if l.dim is not None and not l.held]
        if not leaves:
            return
        with tel.span('trainer/gather'):
            for l in leaves:
                l.tensor.copy_(self.grid.data.all_gather(l.opt, l.dim))

    def _all_reduce(self, tensors, divide=1, group=None):
        """Sum a tensor, or a list of them in one flat collective, over
        ``group`` (default the data x seq ranks; nothing at one rank),
        then divide by ``divide``."""
        group = group or self.grid.batch
        if group.size == 1:
            return
        if isinstance(tensors, torch.Tensor):
            dist.all_reduce(tensors, group=group.group)
            if divide != 1:
                tensors /= divide
            return
        _sum(group, tensors, divide)

    def compile_step(self, state, batch):
        """The step callable for batches already passed through
        ``shard_batch`` (PyTorch runs eagerly; nothing is compiled)."""
        return self._step

    def step(self, state, batch):
        """One optimizer step on a global host batch (or one already
        placed by ``shard_batch``); returns (state, metrics)."""
        return self._step(state, self.shard_batch(batch))

    # -- fit / evaluate ----------------------------------------------------
    def fit(self, state, data, steps=None, eval_data=None, eval_every=0,
            checkpoint_manager=None, save_every=0, prefetch=0):
        """Train over an iterable of batches.

        Args:
            state: TrainState from :meth:`init`.
            data: iterable (or iterator) of global host batches.
            steps: stop after this many steps (None = exhaust ``data``).
            eval_data: optional sequence of eval batches.
            eval_every: run :meth:`evaluate` every N steps (0 = only at
                the end when ``eval_data`` is given).
            checkpoint_manager: optional CheckpointManager; the full
                state (params, optimizer slots, step) is saved every
                ``save_every`` steps and at the end.
            save_every: checkpoint cadence (0 = only at the end).
            prefetch: keep this many placed batches in flight, so the
                host-to-device copy overlaps the step (0 = off). With
                ``steps=N`` the prefetcher reads up to ``prefetch``
                batches past the N-th from ``data``.

        Returns:
            (state, history): 'loss' has one entry a step and, when
            evaluating, 'eval_loss' entries of (step, loss).
        """
        history = {'loss': []}
        if eval_data is not None:
            history['eval_loss'] = []
        if prefetch:
            from autodist_tpu_torch.data.prefetch import prefetch_to_device
            data = prefetch_to_device(data, self.shard_batch, size=prefetch)
        n = 0
        for batch in iter(data):
            state, metrics = self.step(state, batch)
            history['loss'].append(float(metrics['loss']))
            n += 1
            if eval_data is not None and eval_every and \
                    n % eval_every == 0:
                history['eval_loss'].append(
                    (n, self.evaluate(state, eval_data)))
            if checkpoint_manager is not None and save_every and \
                    n % save_every == 0:
                self.save_state(checkpoint_manager, state)
            if steps is not None and n >= steps:
                break
        if eval_data is not None and (not eval_every or n % eval_every):
            history['eval_loss'].append((n, self.evaluate(state,
                                                          eval_data)))
        if checkpoint_manager is not None and (not save_every or
                                               n % save_every):
            self.save_state(checkpoint_manager, state)
        if checkpoint_manager is not None:
            checkpoint_manager.wait_until_finished()   # drain async save
        return state, history

    @torch.no_grad()
    def evaluate(self, state, batches, metrics_fn=None):
        """Mean loss over ``batches`` in eval mode (BatchNorm on its
        running statistics), without updating the state.

        With ``metrics_fn(params, batch) -> {name: scalar or (sum,
        count)}`` returns ``{'loss': ..., **means of metrics}`` instead
        of the bare loss. Each batch's loss is taken as in training (see
        the module docstring); a pair metric is the global sum over the
        global count, a scalar metric each rank's value on its slice,
        averaged over the ranks. Under pipeline parallelism the loss is
        the sum of the stages' partials; ``metrics_fn`` runs on every
        stage (its forward is the pipeline's, a collective over the pipe
        group), and only the last stage's values count: the other
        stages' outputs are zeros, not logits."""
        params = self._params(grad=False)
        last_stage = self.grid.pipe_index == self.pp - 1
        totals, count = {}, 0
        for batch in batches:
            batch = self._place(batch, 1)
            global_mask = self._global_mask(batch)
            counts = self._mask_counts([batch]) if global_mask else None
            with self._mode(False):
                loss, _, summed = self._chunk_loss(
                    params, batch, None if counts is None else counts[0],
                    False)
                out = {'loss': (loss.float(), summed)}
                if metrics_fn is not None:
                    for k, v in metrics_fn(params, batch).items():
                        pair = isinstance(v, (tuple, list))
                        v = self._pair_mean(*v) if pair else v
                        v = torch.as_tensor(v, dtype=torch.float32,
                                            device=self.device)
                        out[k] = (v if last_stage else torch.zeros_like(v),
                                  pair)
            for name, (val, summed) in out.items():
                self._all_reduce(val, 1 if summed else self.replicas,
                                 self._parts)
                totals[name] = totals.get(name, 0.0) + float(val)
            count += 1
        means = {name: val / max(count, 1) for name, val in totals.items()}
        return means if metrics_fn is not None else means.get('loss', 0.0)

    # -- checkpoint/resume of the full training state ----------------------
    def _slot_kind(self, opt):
        if isinstance(opt, (torch.optim.Adam, torch.optim.AdamW,
                            optim.Lamb)):
            return 'adam'
        if isinstance(opt, torch.optim.SGD):
            return 'trace' if opt.param_groups[0]['momentum'] else None
        raise NotImplementedError(
            'save_state: no optax layout for %s' % type(opt).__name__)

    def _state_tree(self, state, skeleton=False):
        """The state as the JAX package's ``TrainState`` flattens it, in
        the logical (full) layout: the params tree under ``.params``,
        optax's slots under ``.opt_state/0`` (Adam and AdamW:
        ``.count``, ``.mu``, ``.nu``; SGD with momentum: ``.trace``),
        and ``.step``. Sharded leaves and slots are all-gathered over
        the groups that split them (a collective: every rank builds the
        tree). State
        buffers get zero slots, as their zero gradients give them in
        optax. With ``skeleton``, uninitialized host arrays of the right
        shapes."""
        def host(t):
            return t.detach().float().cpu().numpy()

        opt = state.opt_state
        kind = self._slot_kind(opt)

        def param(l):
            if skeleton:
                return np.empty(l.shape, np.float32)
            return host(self._gather(l.tensor.detach(), l, l.held))

        tree = {'.params': _tree(param, self._leaves),
                '.step': np.asarray(state.step, np.int32)}
        if kind is None:
            return tree

        def slot(name):
            def leaf(l):
                s = opt.state.get(l.opt, {}) if l.opt is not None else {}
                if name in s and not skeleton:
                    return host(self._gather(s[name], l, True))
                return np.zeros(l.shape, np.float32)
            return _tree(leaf, self._leaves)

        if kind == 'trace':
            tree['.opt_state'] = ({'.trace': slot('momentum_buffer')},)
            return tree
        steps = [int(s['step']) for s in opt.state.values() if 'step' in s]
        tree['.opt_state'] = ({'.count': np.asarray(max(steps, default=0),
                                                    np.int32),
                               '.mu': slot('exp_avg'),
                               '.nu': slot('exp_avg_sq')},)
        return tree

    def save_state(self, manager, state):
        """Checkpoint params, optimizer slots and step for exact resume,
        in the JAX package's ``TrainState`` layout, so either package
        restores the other's checkpoint. Every rank builds the tree
        (sharded state is gathered); rank 0 writes."""
        tree = self._state_tree(state)
        if self.world > 1 and self.rank != 0:
            return None
        return manager.save(int(state.step), tree)

    def restore_state(self, manager, state_template, step=None):
        """Restore a :meth:`save_state` checkpoint (either package's) into
        this trainer's model and optimizer, in place, each rank taking
        its slices of sharded leaves. Returns ``(state, step)``;
        ``(state_template, None)`` when there is no checkpoint."""
        like = self._state_tree(state_template, skeleton=True)
        tree, got_step = manager.restore(like=like, step=step)
        if tree is None:
            return state_template, None
        with torch.no_grad():
            for l in self._leaves:
                value = self._leaf_value(tree['.params'], l)
                l.tensor.copy_(self._local(value, l, l.held))
                if l.dim is not None and not l.held:
                    l.opt.copy_(self._local(value, l, True))
        opt = state_template.opt_state
        kind = self._slot_kind(opt)
        step_count = int(tree['.step'])
        if kind is not None:
            slots = tree['.opt_state'][0]
            for l in self._leaves:
                if l.opt is None:
                    continue
                leaf = {}
                if kind == 'trace' and step_count:
                    leaf['momentum_buffer'] = self._slot(slots['.trace'], l)
                elif kind == 'adam' and int(slots['.count']):
                    leaf['step'] = torch.tensor(float(slots['.count']),
                                                dtype=torch.float32)
                    leaf['exp_avg'] = self._slot(slots['.mu'], l)
                    leaf['exp_avg_sq'] = self._slot(slots['.nu'], l)
                opt.state[l.opt] = leaf
        state_template.step = step_count
        return state_template, got_step

    def _leaf_value(self, tree, l):
        """The full value at ``l``'s path of a JAX-layout tree, as a
        tensor like ``l``'s."""
        for k in l.path:
            tree = tree[k]
        if tuple(np.shape(tree)) != l.shape:
            raise ValueError('restore_state: %s has shape %s, the model '
                             '%s' % (l.name, np.shape(tree), l.shape))
        return torch.from_numpy(np.ascontiguousarray(tree)).to(
            l.tensor.device, l.tensor.dtype)

    def _slot(self, tree, l):
        """This rank's slot tensor for ``l`` from a JAX-layout slot tree
        (its shard when the leaf is sharded)."""
        return self._local(self._leaf_value(tree, l), l, True).contiguous()

    # -- profiling ---------------------------------------------------------
    def profile(self, state, batch, trace_dir, steps=3):
        """Write a ``torch.profiler`` trace (Chrome / Perfetto JSON,
        ``trace_dir/rank<r>.pt.trace.json``) of ``steps`` training steps
        after one untraced warm-up step, with operator shapes (the
        collectives' sizes, which ``utils/profiling.collective_timeline``
        reads, ride them), and the step's phases as the ranges
        ``autodist.trainer/step``, ``/forward``, ``/backward``,
        ``/reduce``, ``/optimizer`` and ``/gather`` (:meth:`_step`).
        Returns ``trace_dir``. The traced steps' updates are discarded:
        params, buffers, optimizer state and step are put back as they
        were (profiling must not perturb training)."""
        from torch.profiler import ProfilerActivity, profile
        placed = self.shard_batch(batch)
        opt = state.opt_state
        tensors = list(self.model.parameters()) + \
            list(self.model.buffers()) + \
            [l.opt for l in self._leaves if l.dim is not None and not l.held]
        saved = ([t.detach().clone() for t in tensors],
                 copy.deepcopy(opt.state_dict()), state.step)
        activities = [ProfilerActivity.CPU]
        if self.device.type == 'cuda':
            activities.append(ProfilerActivity.CUDA)
        try:
            _, m = self._step(state, placed)     # warm-up outside the trace
            float(m['loss'])
            os.makedirs(trace_dir, exist_ok=True)
            with profile(activities=activities, record_shapes=True) as prof:
                for _ in range(steps):
                    _, m = self._step(state, placed)
                float(m['loss'])
            prof.export_chrome_trace(os.path.join(
                trace_dir, 'rank%d.pt.trace.json' % self.rank))
        finally:
            with torch.no_grad():
                for t, v in zip(tensors, saved[0]):
                    t.copy_(v)
            opt.load_state_dict(saved[1])
            state.step = saved[2]
            opt.zero_grad(set_to_none=True)
        logging.info('Profiler trace (%d steps) written to %s',
                     steps, trace_dir)
        return trace_dir

    # -- fetch -------------------------------------------------------------
    def get_params(self, state):
        """Params on the host in the JAX layout (nested dict of numpy),
        full: sharded leaves are all-gathered, so every rank calls it."""
        with torch.no_grad():
            return weights.tree_to_numpy(_tree(
                lambda l: self._gather(l.tensor.detach(), l, l.held),
                self._leaves))


def _tree(fn, leaves):
    """The nested dict of ``fn(leaf)`` at each leaf's path."""
    out = {}
    for l in leaves:
        node = out
        for k in l.path[:-1]:
            node = node.setdefault(k, {})
        node[l.path[-1]] = fn(l)
    return out


def _replace(tree, values):
    """``tree`` with the leaves at the paths of ``values`` replaced."""
    def walk(node, prefix):
        return {k: walk(v, prefix + (k,)) if isinstance(v, dict)
                else values.get(prefix + (k,), v) for k, v in node.items()}
    return walk(tree, ())


def _sum(group, tensors, divide=1):
    """Sum ``tensors`` in place over a ``ReplicaGroup`` in one flat
    collective (nothing with one member), then divide by ``divide``."""
    if not tensors:
        return
    if group.size == 1:
        if divide != 1:
            for t in tensors:
                t.div_(divide)
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group.group)
    if divide != 1:
        flat /= divide
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
