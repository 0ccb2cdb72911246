"""The reference's readings of a cell's first steps: each step's loss,
the first gradient's norm by leaf, and each leaf's change after the
steps, from the weights and batches the benchmark made.

Rows run in blocks of about ``block_tokens`` tokens so that the
materialized attention fits; under several ranks each takes its share of
the rows and the gradients are summed over them with its own
all-reduce.

The model and the optimizer are the modules that the configuration
names: ``reference/<reference>.py`` (``param_specs``, ``nll_sum``) and
``reference/optimizers/<optimizer.name>.py`` (``Plain``)."""
import importlib

import numpy as np
import torch
import torch.distributed as dist


def model_module(config):
    """The plain model that the configuration names."""
    return importlib.import_module('perfbench.reference.' +
                                   config['reference'])


def optimizer_module(config):
    """The plain optimizer that the configuration names."""
    return importlib.import_module('perfbench.reference.optimizers.' +
                                   config['optimizer']['name'])


def _rows(batch, rank, world):
    n = batch['tokens'].shape[0] // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def readings(weights, config, batches, device, mm=torch.matmul, rank=0,
             world=1, group=None, block_tokens=4096):
    """{'losses': [..], 'grad1': {leaf: norm}, 'change': {leaf: norm}}
    after ``len(batches)`` steps of the configuration ``config`` from
    ``weights`` ({path: f32 array})."""
    model, nll_sum = config['model'], model_module(config).nll_sum
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p = {k: torch.tensor(v, dtype=torch.float32, device=device)
         .requires_grad_() for k, v in weights.items()}
    plain = optimizer_module(config).Plain(config['optimizer'])
    losses, grad1 = [], None
    for batch in batches:
        rows, seq = batch['tokens'].shape
        count = float(rows * seq)
        mine = _rows(batch, rank, world)
        per = max(1, block_tokens // seq)
        total = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(0, mine['tokens'].shape[0], per):
            tok, tgt = (torch.from_numpy(np.ascontiguousarray(
                mine[k][i:i + per])).to(device).long()
                for k in ('tokens', 'targets'))
            part = nll_sum(p, model, tok, tgt, mm) / count
            part.backward()
            total += part.detach()
        grads = {k: t.grad for k, t in p.items()}
        if world > 1:
            flat = torch.cat([total.reshape(1)] +
                             [g.reshape(-1) for g in grads.values()])
            dist.all_reduce(flat, group=group)
            total, off = flat[0], 1
            for g in grads.values():
                g.copy_(flat[off:off + g.numel()].view_as(g))
                off += g.numel()
        losses.append(float(total))
        if grad1 is None:
            grad1 = {k: float(g.norm()) for k, g in grads.items()}
        plain.step({k: t.data for k, t in p.items()}, grads)
        for t in p.values():
            t.grad = None
    change = {k: float((t.detach() - torch.as_tensor(
        weights[k], device=device)).norm()) for k, t in p.items()}
    return {'losses': losses, 'grad1': grad1, 'change': change}
