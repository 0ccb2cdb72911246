"""Functional training API of the port: data-parallel ``Trainer``.

The counterpart of ``autodist_tpu/api.py``. The user hands a model, an
optimizer factory (:mod:`autodist_tpu_torch.optim`) and a
:class:`ParallelSpec` to :class:`Trainer`, which exposes the same
ergonomics: ``init`` / ``shard_batch`` / ``step`` / ``compile_step`` /
``get_params``.

Data parallelism runs over ``torch.distributed`` (NCCL on the card, gloo
on the CPU), on the default process group when one is initialized. Each
rank takes its contiguous slice of the global batch, as ``P('data')``
does in the JAX package, runs forward and backward on it, and the
gradients are all-reduce-averaged before the optimizer step; the
reported loss is the global mean. (With a loss mask, that is the mean of
the ranks' masked means: the JAX package's global masked mean when every
rank holds as many unmasked tokens.) With one rank there is no
collective.
PyTorch runs eagerly, so ``compile_step`` compiles nothing: it returns
the step callable for an already-sharded batch. The port updates the
model's parameters and the optimizer state in place; ``TrainState``
holds references to both.

A model with state (BatchNorm running statistics, as buffers) runs its
loss under ``model_mode(training=True)``; the updates it records are
written into the buffers after the optimizer step, as the JAX package
folds them into the params tree. The step hands the data-parallel group
to the model on that collector, so BatchNorm reduces its moments over
the whole global batch: in the JAX package data parallelism is GSPMD's,
and a mean over the batch axis is a mean over the global batch.
"""
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from autodist_tpu_torch.models import weights
from autodist_tpu_torch.models.core import (apply_tree_updates,
                                            assign_state_paths, model_mode)
from autodist_tpu_torch.parallel.axes import ParallelSpec
from autodist_tpu_torch.utils import logging


@dataclass
class TrainState:
    params: Any          # {name: nn.Parameter}, the model's own
    opt_state: Any       # the torch.optim.Optimizer over them
    step: int = 0


class Trainer:
    """Drive data-parallel training of a port model.

    Args:
        model: a port :class:`~autodist_tpu_torch.models.core.Module` with
            ``params``/``apply`` (and ``loss(params, batch)`` unless
            ``loss_fn`` is given); its device is the trainer's.
        optimizer: ``params -> torch.optim.Optimizer`` (e.g.
            ``optim.adamw(1e-4)``).
        spec: :class:`ParallelSpec`; defaults to DP over every rank.
        loss_fn: ``loss_fn(params, batch) -> scalar``; defaults to
            ``model.loss``.
        process_group: the data-parallel group; defaults to the
            default group when ``torch.distributed`` is initialized.
    """

    def __init__(self, model, optimizer, spec=None, loss_fn=None,
                 process_group=None):
        self.model = model
        self.optimizer = optimizer
        self.spec = spec or ParallelSpec()
        self._loss_fn = loss_fn
        self.group = process_group
        if dist.is_available() and dist.is_initialized():
            self.world = dist.get_world_size(process_group)
            self.rank = dist.get_rank(process_group)
        else:
            self.world, self.rank = 1, 0
        self.dp = self.spec.resolve_dp(self.world)
        self.device = next(model.parameters()).device
        self._has_state = model.has_state()
        if self._has_state:
            assign_state_paths(model)
        logging.info('Trainer: dp=%d on %s', self.dp, self.device)

    # -- init --------------------------------------------------------------
    def init(self, seed=0, params=None):
        """Fresh params from ``seed`` (the port's own init), or
        ``params`` in the JAX layout (nested dict of arrays); then the
        optimizer state. Ranks start from rank 0's params."""
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
        named = dict(self.model.named_parameters())
        return TrainState(params=named,
                          opt_state=self.optimizer(list(named.values())))

    # -- data --------------------------------------------------------------
    def shard_batch(self, batch):
        """Global host batch -> this rank's contiguous slice of every
        leaf's leading dim, as tensors on the trainer's device."""
        def local(x):
            x = np.asarray(x)
            if x.ndim == 0:
                return torch.as_tensor(x, device=self.device)
            if x.shape[0] % self.dp:
                raise ValueError('global batch dim %d does not split over '
                                 'dp=%d' % (x.shape[0], self.dp))
            n = x.shape[0] // self.dp
            part = np.ascontiguousarray(x[self.rank * n:(self.rank + 1) * n])
            return torch.from_numpy(part).to(self.device)
        return {k: local(v) for k, v in batch.items()}

    # -- the step ----------------------------------------------------------
    def loss_for(self, params, batch):
        if self._loss_fn is not None:
            return self._loss_fn(params, batch)
        return self.model.loss(params, batch)

    def _step(self, state, batch):
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        params = self.model.params()
        if self._has_state:
            with model_mode(training=True, group=self.group,
                            world=self.world) as mm:
                loss = self.loss_for(params, batch)
        else:
            loss = self.loss_for(params, batch)
        loss.backward()
        loss = loss.detach()
        if self.world > 1:
            self._all_reduce_mean([p.grad for p in state.params.values()
                                   if p.grad is not None])
            loss = loss.clone()
            dist.all_reduce(loss, group=self.group)
            loss /= self.world
        opt.step()
        if self._has_state:
            apply_tree_updates(params, mm.updates)
        state.step += 1
        return state, {'loss': loss}

    def _all_reduce_mean(self, grads):
        """Average ``grads`` over the group in one flat collective."""
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.group)
        flat /= self.world
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    def compile_step(self, state, batch):
        """The step callable for batches already passed through
        ``shard_batch`` (PyTorch runs eagerly; nothing is compiled)."""
        return self._step

    def step(self, state, batch):
        """One optimizer step on a global host batch; returns
        (state, metrics)."""
        return self._step(state, self.shard_batch(batch))

    # -- fetch -------------------------------------------------------------
    def get_params(self, state):
        """Params on the host in the JAX layout (nested dict of numpy)."""
        return weights.params_to_jax(self.model)
