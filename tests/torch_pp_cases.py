"""The port's side of the pipeline tests: the schedules called directly
over a pipe group, the live bytes each schedule keeps, and a Trainer's
refusals (a layer count the stages do not divide, a batch the
microbatches do not divide, unstacked layers), each called as
``fn(rank, world, **kwargs)`` on every rank of a gloo group
(``torch_dsl_worlds.run_group``). The Trainer runs go through
``torch_trainer_cases.train``. This module imports no jax.
"""
import weakref

import numpy as np
import torch

from autodist_tpu_torch import optim
from autodist_tpu_torch.api import Trainer
from autodist_tpu_torch.models.transformer import (TransformerConfig,
                                                   TransformerLM)
from autodist_tpu_torch.parallel import pipeline
from autodist_tpu_torch.parallel.axes import ParallelSpec
from autodist_tpu_torch.parallel.mesh import ReplicaGroup

# the direct case: per stage LAYERS layers of [DIM, DIM], MB rows a
# microbatch
LAYERS, DIM, MB = 2, 8, 2


def direct_inputs(stages, microbatches, seed=0):
    """The whole stack's weights [stages, LAYERS, DIM, DIM], the tail's
    vector, x [M·MB, DIM] and integer targets [M·MB, 1], from
    ``RandomState(seed)`` (the JAX test's draws)."""
    rng = np.random.RandomState(seed)
    return {'w': rng.randn(stages, LAYERS, DIM, DIM).astype('f4') / 4,
            'out': rng.randn(DIM).astype('f4'),
            'x': rng.randn(microbatches * MB, DIM).astype('f4'),
            'tgt': rng.randint(0, 2, (microbatches * MB, 1)).astype(np.int32)}


def block_fn(p, h):
    return torch.tanh(h @ p['w']), None


def tail_fn(tp, h, e):
    return (h @ tp['out'])[:, None] * (1.0 + e.to(h.dtype))


def _loss_grads(out, leaves):
    loss = out.float().square().sum()
    loss.backward()
    return loss.item(), [t.grad.numpy().copy() if t.grad is not None
                         else None for t in leaves]


def direct(rank, world, variant, microbatches, seed=0):
    """``one_f_one_b`` without a head over the world as the pipe group,
    this rank the stage of the same index, in the fused mode (``variant``
    'remat' or 'stash') or, for 'legacy', with a tail that closes over
    its vector: each rank takes ``sum(out ** 2)`` of its partial and
    differentiates it. Returns {'loss', 'w' (this stage's weights'
    gradient), 'out' (the tail vector's), 'x' (x's; None past the first
    stage)}."""
    d = direct_inputs(world, microbatches, seed)
    w = torch.from_numpy(d['w'][rank]).requires_grad_()
    out_v = torch.from_numpy(d['out']).requires_grad_()
    x = torch.from_numpy(d['x']).requires_grad_()
    if variant == 'legacy':
        tail = {'tail_fn': lambda h, e: tail_fn({'out': out_v}, h, e)}
    else:
        tail = {'tail_fn': tail_fn, 'tail_params': {'out': out_v},
                'variant': variant}
    out, _ = pipeline.one_f_one_b(
        block_fn, {'w': w}, x, ReplicaGroup(world, rank), microbatches,
        extra=torch.from_numpy(d['tgt']), **tail)
    loss, (gw, gout, gx) = _loss_grads(out, [w, out_v, x])
    return {'loss': loss, 'w': gw, 'out': gout, 'x': gx}


def direct_reference(stages, microbatches, seed=0):
    """The same loss by the plain composition on one process:
    {'loss', 'w' [stages, ...], 'out', 'x'}."""
    d = direct_inputs(stages, microbatches, seed)
    w = torch.from_numpy(d['w']).requires_grad_()
    out_v = torch.from_numpy(d['out']).requires_grad_()
    x = torch.from_numpy(d['x']).requires_grad_()
    h = x
    for s in range(stages):
        for l in range(LAYERS):
            h, _ = block_fn({'w': w[s, l]}, h)
    out = tail_fn({'out': out_v}, h, torch.from_numpy(d['tgt']))
    loss, (gw, gout, gx) = _loss_grads(out, [w, out_v, x])
    return {'loss': loss, 'w': gw, 'out': gout, 'x': gx}


class LiveSaved:
    """The bytes of the distinct storages autograd holds saved (graph
    residuals and ``save_for_backward``, the stash among them), and
    their peak: each saved tensor is packed into a handle whose
    finalizer releases its storage's count. The parameters' storages
    (``skip``) are left out: every schedule holds them."""

    def __init__(self, skip=()):
        self.skip = set(skip)
        self.refs = {}
        self.live = self.peak = 0

    def _release(self, key):
        count, nbytes = self.refs[key]
        if count == 1:
            del self.refs[key]
            self.live -= nbytes
        else:
            self.refs[key] = (count - 1, nbytes)

    def pack(self, t):
        handle = _Handle(t)
        storage = t.untyped_storage()
        key = storage.data_ptr()
        if key in self.skip or storage.nbytes() == 0:
            return handle
        count, nbytes = self.refs.get(key, (0, storage.nbytes()))
        if count == 0:
            self.live += nbytes
            self.peak = max(self.peak, self.live)
        self.refs[key] = (count + 1, nbytes)
        weakref.finalize(handle, self._release, key)
        return handle

    @staticmethod
    def unpack(handle):
        return handle.t

    def hooks(self):
        return torch.autograd.graph.saved_tensors_hooks(self.pack,
                                                        self.unpack)


class _Handle:
    def __init__(self, t):
        self.t = t


# the memory case (the JAX test's): 4 layers, vocab 4096, seq 128,
# batch 32, sgd, at pp = the world
MEMORY_CFG = dict(n_layers=4, max_len=128, vocab=4096)
MEMORY_BATCH = (32, 128)


def memory(rank, world, schedule, microbatches, variant='remat'):
    """One Trainer step at pp = world of the memory configuration under
    ``schedule`` ('gpipe' | '1f1b') and ``variant``, inside
    :class:`LiveSaved`'s hooks: {'peak', 'loss'} (peak live saved bytes
    on this rank)."""
    cfg = TransformerConfig.tiny(dtype=torch.float32, **MEMORY_CFG)
    model = TransformerLM(cfg, device='cpu')
    trainer = Trainer(model, optim.sgd(0.1), spec=ParallelSpec(
        pp=world, dp=1, microbatches=microbatches, pp_schedule=schedule,
        pp_variant=variant))
    state = trainer.init(seed=0)
    rng = np.random.RandomState(0)
    batch = {k: rng.randint(0, cfg.vocab, MEMORY_BATCH).astype(np.int32)
             for k in ('tokens', 'targets')}
    live = LiveSaved(p.untyped_storage().data_ptr()
                     for p in model.parameters())
    with live.hooks():
        _, m = trainer.step(state, batch)
    return {'peak': live.peak, 'loss': float(m['loss']),
            'left': live.live}


def indivisible_layers(rank, world):
    """A Trainer at pp 2 over ``TransformerConfig.tiny(n_layers=3)``:
    {'raised': the exception's type name, 'message'}."""
    model = TransformerLM(TransformerConfig.tiny(n_layers=3,
                                                 dtype=torch.float32),
                          device='cpu')
    try:
        Trainer(model, optim.sgd(0.1), spec=ParallelSpec(pp=2))
    except Exception as e:  # noqa: BLE001 - the test reads its type
        return {'raised': type(e).__name__, 'message': str(e)}
    return {'raised': None, 'message': ''}


def step_refusal(rank, world, config, spec):
    """One Trainer step of ``TransformerConfig.tiny(**config)`` at
    ``spec`` on ``lm_batch()``: {'raised': the exception's type name,
    'message'}."""
    import torch_trainer_cases as cases
    model = TransformerLM(TransformerConfig.tiny(dtype=torch.float32,
                                                 **config), device='cpu')
    trainer = Trainer(model, optim.sgd(0.1), spec=ParallelSpec(**spec))
    state = trainer.init(seed=0)
    try:
        trainer.step(state, cases.lm_batch())
    except Exception as e:  # noqa: BLE001 - the test reads its type
        return {'raised': type(e).__name__, 'message': str(e)}
    return {'raised': None, 'message': ''}
