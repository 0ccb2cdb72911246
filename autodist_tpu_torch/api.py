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

A user ``loss_fn`` is taken per rank and averaged over the ranks, which
is the global value only for a loss that is a mean over equal slices.
With one rank there is no collective.

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
"""
import copy
import os
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

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
        self.accum = max(1, int(self.spec.grad_accum))
        self.device = next(model.parameters()).device
        self._has_state = model.has_state()
        if self._has_state:
            assign_state_paths(model)
        logging.info('Trainer: dp=%d on %s, grad_accum=%d, remat=%s',
                     self.dp, self.device, self.accum, self.spec.remat)

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
        """Global host batch -> this rank's share of every leaf's leading
        dim, as tensors on the trainer's device: rows [r·B/dp,
        (r+1)·B/dp), or under ``grad_accum`` the r-th dp-slice of each
        of its chunks of consecutive rows. A tensor already on the
        trainer's device is taken as placed and passes through untouched
        (a batch from ``shard_batch`` or the prefetcher). On the card the
        copy leaves pinned memory with ``non_blocking=True``."""
        return self._place(batch, self.accum)

    def _place(self, batch, accum):
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
            part = x.reshape((accum, self.dp, n) + x.shape[1:])[:, self.rank]
            t = torch.from_numpy(np.ascontiguousarray(
                part.reshape((accum * n,) + x.shape[1:])))
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
        """True when the loss is the global masked mean over the group's
        ranks (a mask, the model's per-token loss, no user loss_fn)."""
        return self._loss_fn is None and 'mask' in batch and \
            hasattr(self.model, 'per_token_loss')

    def _mask_counts(self, chunks):
        """Each chunk's unmasked-token count over the whole group, f32,
        floored at 1: one all-reduce for every chunk."""
        counts = torch.stack([c['mask'].float().sum() for c in chunks])
        self._all_reduce(counts)
        return torch.clamp(counts, min=1)

    def _chunk_loss(self, params, chunk, count, training):
        """(the loss this rank differentiates, the state updates its
        forward recorded). With ``count`` (a global mask count) that is
        this rank's masked sum over it, plus its share of the model's
        aux loss; else the rank's mean loss. The forward runs under
        ``model_mode`` with the data-parallel group. Under
        ``remat='full'`` the forward runs again in the backward; the
        state updates are those of the first run."""
        def compute():
            if count is None:
                return self.loss_for(params, chunk)
            if hasattr(self.model, 'per_token_loss_with_aux'):
                nll, aux = self.model.per_token_loss_with_aux(params, chunk)
            else:
                nll, aux = self.model.per_token_loss(params, chunk), 0.0
            loss = (nll * chunk['mask'].to(nll.dtype)).sum() / count
            weight = getattr(self.model, 'aux_loss_weight', 0.0)
            if weight:
                # the ranks' parts are summed: each adds its share of the
                # mean of the ranks' aux
                loss = loss + weight * aux / self.world
            return loss

        recorded = []

        def run():
            with model_mode(training=training, group=self.group,
                            world=self.world) as mm:
                out = compute()
            if not recorded:
                recorded.append(mm.updates)
            return out

        if training and self.spec.remat == 'full':
            loss = checkpoint(run, use_reentrant=False)
        else:
            loss = run()
        return loss, (recorded[0] if recorded else {})

    # -- the step ----------------------------------------------------------
    def _step(self, state, batch):
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        params = self.model.params()
        chunks = self._chunks(batch)
        global_mask = self._global_mask(batch)
        counts = self._mask_counts(chunks) if global_mask else None
        total, updates = None, {}
        for i, chunk in enumerate(chunks):
            loss, updates = self._chunk_loss(
                params, chunk, None if counts is None else counts[i], True)
            loss.backward()
            loss = loss.detach()
            total = loss if total is None else total + loss
        loss = total / self.accum if self.accum > 1 else total
        # the global masked mean sums the ranks' parts; a mean averages
        # the ranks' means
        ranks = 1 if global_mask else self.world
        grads = [p.grad for p in state.params.values() if p.grad is not None]
        if self.world > 1:
            self._all_reduce(grads, self.accum * ranks)
            loss = loss.clone()
            self._all_reduce(loss, ranks)
        elif self.accum > 1:
            for g in grads:
                g.div_(self.accum)
        opt.step()
        if self._has_state:
            apply_tree_updates(params, updates)
        state.step += 1
        return state, {'loss': loss}

    def _all_reduce(self, tensors, divide=1):
        """Sum a tensor, or a list of them in one flat collective, over
        the group (nothing at one rank), then divide by ``divide``."""
        if self.world == 1:
            return
        if isinstance(tensors, torch.Tensor):
            dist.all_reduce(tensors, group=self.group)
            if divide != 1:
                tensors /= divide
            return
        flat = torch.cat([g.reshape(-1) for g in tensors])
        dist.all_reduce(flat, group=self.group)
        if divide != 1:
            flat /= divide
        offset = 0
        for g in tensors:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

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

        With ``metrics_fn(params, batch) -> {name: scalar}`` returns
        ``{'loss': ..., **means of metrics}`` instead of the bare loss.
        Each batch's loss is the global one (see the module docstring);
        a metric is each rank's value on its slice, averaged over the
        ranks."""
        params = self.model.params()
        totals, count = {}, 0
        for batch in batches:
            batch = self._place(batch, 1)
            global_mask = self._global_mask(batch)
            counts = self._mask_counts([batch]) if global_mask else None
            with model_mode(training=False, group=self.group,
                            world=self.world):
                loss, _ = self._chunk_loss(
                    params, batch, None if counts is None else counts[0],
                    False)
                out = {'loss': loss.float()}
                if metrics_fn is not None:
                    out.update({k: torch.as_tensor(v, dtype=torch.float32,
                                                   device=self.device)
                                for k, v in metrics_fn(params,
                                                       batch).items()})
            self._all_reduce(out['loss'], 1 if global_mask else self.world)
            for name, val in out.items():
                if name != 'loss':
                    self._all_reduce(val, self.world)
                totals[name] = totals.get(name, 0.0) + float(val)
            count += 1
        means = {name: val / max(count, 1) for name, val in totals.items()}
        return means if metrics_fn is not None else means.get('loss', 0.0)

    # -- checkpoint/resume of the full training state ----------------------
    def _slot_kind(self, opt):
        if isinstance(opt, (torch.optim.Adam, torch.optim.AdamW)):
            return 'adam'
        if isinstance(opt, torch.optim.SGD):
            return 'trace' if opt.param_groups[0]['momentum'] else None
        raise NotImplementedError(
            'save_state: no optax layout for %s' % type(opt).__name__)

    def _state_tree(self, state, skeleton=False):
        """The state as the JAX package's ``TrainState`` flattens it: the
        params tree under ``.params``, optax's slots under
        ``.opt_state/0`` (Adam and AdamW: ``.count``, ``.mu``, ``.nu``;
        SGD with momentum: ``.trace``), and ``.step``. State buffers get
        zero slots, as their zero gradients give them in optax. With
        ``skeleton``, uninitialized host arrays of the right shapes."""
        def host(t):
            if skeleton:
                return np.empty(tuple(t.shape), np.float32)
            return t.detach().float().cpu().numpy()

        opt = state.opt_state
        kind = self._slot_kind(opt)
        params = self.model.params()
        tree = {'.params': _map_tree(host, params),
                '.step': np.asarray(state.step, np.int32)}
        if kind is None:
            return tree

        def slot(name):
            def leaf(p):
                s = opt.state.get(p, {}) if isinstance(
                    p, torch.nn.Parameter) else {}
                if name in s and not skeleton:
                    return host(s[name])
                return np.zeros(tuple(p.shape), np.float32)
            return _map_tree(leaf, params)

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
        restores the other's checkpoint. Rank 0 writes (the state is
        replicated)."""
        tree = self._state_tree(state)
        if self.world > 1 and self.rank != 0:
            return None
        return manager.save(int(state.step), tree)

    def restore_state(self, manager, state_template, step=None):
        """Restore a :meth:`save_state` checkpoint (either package's) into
        this trainer's model and optimizer, in place. Returns
        ``(state, step)``; ``(state_template, None)`` when there is no
        checkpoint."""
        like = self._state_tree(state_template, skeleton=True)
        tree, got_step = manager.restore(like=like, step=step)
        if tree is None:
            return state_template, None
        weights.load_params(self.model, tree['.params'])
        opt = state_template.opt_state
        kind = self._slot_kind(opt)
        step_count = int(tree['.step'])
        if kind is not None:
            slots = tree['.opt_state'][0]
            flat = dict(weights.flatten_tree(self.model.params()))
            for path, p in flat.items():
                if not isinstance(p, torch.nn.Parameter):
                    continue
                leaf = {}
                if kind == 'trace' and step_count:
                    leaf['momentum_buffer'] = _slot_tensor(slots['.trace'],
                                                           path, p)
                elif kind == 'adam' and int(slots['.count']):
                    leaf['step'] = torch.tensor(float(slots['.count']),
                                                dtype=torch.float32)
                    leaf['exp_avg'] = _slot_tensor(slots['.mu'], path, p)
                    leaf['exp_avg_sq'] = _slot_tensor(slots['.nu'], path, p)
                opt.state[p] = leaf
        state_template.step = step_count
        return state_template, got_step

    # -- profiling ---------------------------------------------------------
    def profile(self, state, batch, trace_dir, steps=3):
        """Write a ``torch.profiler`` trace (Chrome / Perfetto JSON,
        ``trace_dir/rank<r>.pt.trace.json``) of ``steps`` training steps
        after one untraced warm-up step, with operator shapes (the
        collectives' sizes, which ``utils/profiling.collective_timeline``
        reads, ride them). Returns ``trace_dir``. The
        traced steps' updates are discarded: params, buffers, optimizer
        state and step are put back as they were (profiling must not
        perturb training)."""
        from torch.profiler import ProfilerActivity, profile
        placed = self.shard_batch(batch)
        opt = state.opt_state
        tensors = list(self.model.parameters()) + list(self.model.buffers())
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
        """Params on the host in the JAX layout (nested dict of numpy)."""
        return weights.params_to_jax(self.model)


def _map_tree(fn, tree):
    return {k: _map_tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _slot_tensor(tree, path, p):
    """The slot at ``path`` of a JAX-layout slot tree, as a tensor like
    the parameter ``p``."""
    for k in path:
        tree = tree[k]
    return torch.from_numpy(np.ascontiguousarray(tree)).to(p.device, p.dtype)
