"""The port's side of the tensor- and expert-parallel tests: the two
Megatron operators, the vocab-sharded lookup and cross-entropy, and the
round trip of JAX params through a sharded Trainer, each called as
``fn(rank, world, **kwargs)`` on every rank of a gloo group
(``torch_dsl_worlds.run_group``). The Trainer runs go through
``torch_trainer_cases.train``. This module imports no jax.
"""
import numpy as np
import torch
import torch.nn.functional as F

import torch_trainer_cases as cases
from autodist_tpu_torch.models.core import sharded_embedding_lookup
from autodist_tpu_torch.models.transformer import vocab_parallel_nll
from autodist_tpu_torch.parallel.mesh import ReplicaGroup, copy_to, reduce_from

# the function-level shapes: a [V, D] table, [B, S] ids, [B, S, V] logits
VOCAB, DIM, IDS = 24, 8, (2, 6)


def inputs(seed=0):
    """The global table, ids (every rank's range, and the ends), logits,
    targets and a per-token weight, from ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, VOCAB, IDS)
    ids[0, :2] = (0, VOCAB - 1)
    return {'table': rng.randn(VOCAB, DIM).astype(np.float32),
            'ids': ids.astype(np.int64),
            'logits': rng.randn(*IDS, VOCAB).astype(np.float32),
            'targets': rng.randint(0, VOCAB, IDS).astype(np.int64),
            'weight': rng.randn(*IDS).astype(np.float32)}


def _shard(x, rank, world, dim):
    c = x.shape[dim] // world
    return torch.from_numpy(np.ascontiguousarray(
        np.take(x, range(rank * c, (rank + 1) * c), axis=dim)))


def operators(rank, world, seed=0):
    """``copy_to`` and ``reduce_from`` over the world: {'copy': (out,
    grad of sum(out * w_r)), 'reduce': (out, grad)}, where rank r's
    weight w_r and input x_r are ``RandomState(seed + r)`` draws."""
    group = ReplicaGroup(world, rank)
    rng = np.random.RandomState(seed + rank)
    x, w = (torch.from_numpy(rng.randn(3, 5).astype(np.float32))
            for _ in range(2))
    out = {}
    for name, fn in (('copy', copy_to), ('reduce', reduce_from)):
        xr = x.clone().requires_grad_()
        y = fn(group, xr)
        (y * w).sum().backward()
        out[name] = (y.detach().numpy(), xr.grad.numpy())
    return out


def lookup_and_nll(rank, world, seed=0):
    """The vocab-sharded lookup and NLL over the world, this rank holding
    rows (columns) ``[r · V / world, (r + 1) · V / world)``: {'rows',
    'table_grad' (of sum(rows ** 2), this rank's rows), 'nll',
    'logits_grad' (of sum(nll * weight), this rank's columns)}."""
    group = ReplicaGroup(world, rank)
    x = inputs(seed)
    table = _shard(x['table'], rank, world, 0).requires_grad_()
    rows = sharded_embedding_lookup(table, torch.from_numpy(x['ids']), group)
    rows.square().sum().backward()
    logits = _shard(x['logits'], rank, world, 2).requires_grad_()
    nll = vocab_parallel_nll(logits, torch.from_numpy(x['targets']), group)
    (nll * torch.from_numpy(x['weight'])).sum().backward()
    return {'rows': rows.detach().numpy(), 'table_grad': table.grad.numpy(),
            'nll': nll.detach().numpy(), 'logits_grad': logits.grad.numpy()}


def unsharded(seed=0):
    """The same values from the plain functions on whole tensors."""
    x = inputs(seed)
    table = torch.from_numpy(x['table']).requires_grad_()
    rows = F.embedding(torch.from_numpy(x['ids']), table)
    rows.square().sum().backward()
    logits = torch.from_numpy(x['logits']).requires_grad_()
    targets = torch.from_numpy(x['targets'])
    nll = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, targets[..., None])[..., 0]
    (nll * torch.from_numpy(x['weight'])).sum().backward()
    return {'rows': rows.detach().numpy(), 'table_grad': table.grad.numpy(),
            'nll': nll.detach().numpy(), 'logits_grad': logits.grad.numpy()}


def round_trip(rank, world, init, spec, kind='lm'):
    """``init(params=init)`` then ``get_params`` at ``spec``: {'params'
    (flat), 'qkv' (this rank's shard of the first layer's qkv kernel),
    'model_index', 'groups' (``state_sharding()['groups']``)}."""
    trainer = cases.make_trainer(kind, spec=spec)
    state = trainer.init(params=init)
    return {'params': cases.flat(trainer.get_params(state)),
            'qkv': trainer.model.params()['blocks']['attn']['qkv']['kernel']
            .detach().numpy().copy(),
            'model_index': trainer.grid.model_index,
            'groups': trainer.state_sharding()['groups']}


def indivisible_vocab(rank, world):
    """A Trainer at tp = world over ``TransformerConfig.tiny(vocab=250)``:
    {'raised': the exception's type name, 'message'}."""
    from autodist_tpu_torch import optim
    from autodist_tpu_torch.api import Trainer
    from autodist_tpu_torch.models.transformer import (TransformerConfig,
                                                       TransformerLM)
    from autodist_tpu_torch.parallel.axes import ParallelSpec
    model = TransformerLM(TransformerConfig.tiny(vocab=250,
                                                 dtype=torch.float32),
                          device='cpu')
    try:
        Trainer(model, optim.sgd(0.1), spec=ParallelSpec(tp=world))
    except Exception as e:  # noqa: BLE001 - the test reads its type
        return {'raised': type(e).__name__, 'message': str(e)}
    return {'raised': None, 'message': ''}


def grid_layout(rank, world, dp, sp, ep, tp, dcn_dp=1, pp=1):
    """This rank's coordinates on a ``RankGrid`` and the global ranks of
    each of its groups, its data axis's node groups, and whether the
    (data, pipe, seq) and (pipe, seq) groups are the batch and seq
    groups' objects (one communicator for one set of ranks)."""
    import torch.distributed as dist
    from autodist_tpu_torch.parallel.mesh import RankGrid
    grid = RankGrid(dp, sp, rank, ep=ep, tp=tp, dcn_dp=dcn_dp, pp=pp)

    def members(group):
        if group.size == 1:
            return [rank]
        if group.group is None:
            return list(range(world))
        return dist.get_process_group_ranks(group.group)
    return {'coords': grid.coords(rank),
            'groups': {name: members(getattr(grid, name)) for name in
                       ('data', 'pipe', 'seq', 'expert', 'model', 'batch')},
            'expert_model': members(grid.group('expert', 'model')),
            'parts': members(grid.group('data', 'pipe', 'seq')),
            'shape': grid.shape, 'node_groups': grid.node_groups,
            'shared': (grid.group('data', 'pipe', 'seq') is grid.batch,
                       grid.group('pipe', 'seq') is grid.seq)}
