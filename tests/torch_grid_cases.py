"""The port's side of the (data, seq) grid tests: ring and Ulysses
attention over a seq group, and checkpoints of sharded training state,
each called as ``fn(rank, world, **kwargs)`` on every rank of a gloo
group (``torch_dsl_worlds.run_group``). The Trainer runs go through
``torch_trainer_cases.train``. This module imports no jax.
"""
import numpy as np
import torch

import torch_trainer_cases as cases
from autodist_tpu_torch.checkpoint.saver import CheckpointManager
from autodist_tpu_torch.parallel.mesh import ReplicaGroup
from autodist_tpu_torch.parallel.ring_attention import ring_attention
from autodist_tpu_torch.parallel.ulysses import ulysses_attention


def qkv(shape, seed):
    """Global q, k, v [B, H, S, D] f32 from ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


def attention(rank, world, mode, shape, seed, causal):
    """This rank's seq shard of q, k, v through ``mode`` ('ring' |
    'ulysses') over the world as the seq group: the output shard and the
    gradients of sum(out ** 2) over the whole sequence with respect to
    this rank's shards of q, k and v."""
    group = ReplicaGroup(world, rank)
    c = shape[2] // world
    q, k, v = (torch.from_numpy(x[:, :, rank * c:(rank + 1) * c].copy())
               .requires_grad_() for x in qkv(shape, seed))
    fn = ring_attention if mode == 'ring' else ulysses_attention
    out = fn(q, k, v, group, causal=causal)
    out.square().sum().backward()
    return {'out': out.detach().numpy(),
            'grads': [t.grad.numpy() for t in (q, k, v)]}


def save_then_step(rank, world, init, batches, path, opt, spec,
                   builder=None, kind='lm'):
    """Train on ``batches[:-1]`` from ``init``, save the state to
    ``path`` (rank 0 writes), then one more step: {'tree' (the saved
    leaves, gathered), 'loss', 'params'}."""
    trainer = cases.make_trainer(kind, opt=opt, spec=spec, builder=builder)
    state = trainer.init(params=init)
    for b in batches[:-1]:
        state, _ = trainer.step(state, b)
    trainer.save_state(CheckpointManager(path), state)
    tree = _flat_tree(trainer._state_tree(state))
    state, m = trainer.step(state, batches[-1])
    return {'tree': tree, 'loss': float(m['loss']),
            'params': cases.flat(trainer.get_params(state))}


def restore_then_step(rank, world, path, batch, opt, spec, builder=None,
                      kind='lm'):
    """Restore the checkpoint at ``path`` into a trainer of ``spec``, then
    one step on ``batch``: {'tree' (the restored leaves, gathered),
    'step', 'loss', 'params'}."""
    trainer = cases.make_trainer(kind, opt=opt, spec=spec, builder=builder)
    state = trainer.init(seed=1)   # other params: the restore replaces them
    state, step = trainer.restore_state(CheckpointManager(path), state)
    tree = _flat_tree(trainer._state_tree(state))
    state, m = trainer.step(state, batch)
    return {'tree': tree, 'step': step, 'loss': float(m['loss']),
            'params': cases.flat(trainer.get_params(state))}


def _flat_tree(tree):
    """The leaves of a state tree, copied: a replicated leaf's host array
    is a view of the live CPU parameter, which the next step moves."""
    from autodist_tpu_torch.checkpoint.saver import _leaf_paths
    return {n: np.array(v, copy=True) for n, v in _leaf_paths(tree)}
