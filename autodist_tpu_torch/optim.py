"""Optimizers of the port, with optax's numerics.

The JAX package takes optax transformations; the port takes a factory
``params -> torch.optim.Optimizer`` whose update matches the optax one.
``torch.optim``'s defaults differ from optax's (``AdamW`` decays by 1e-2,
``optax.adamw`` by 1e-4), so every hyperparameter is stated here.
The optimizer is built over the model's parameters only, so state
buffers (BatchNorm's running statistics) never reach it.
"""
import functools

import torch


def sgd(learning_rate, momentum=None, nesterov=False):
    """``optax.sgd``: trace t = g + momentum * t (t = g on the first
    step), p -= lr * t; with ``nesterov``, p -= lr * (g + momentum * t).
    ``torch.optim.SGD`` with dampening 0 is that update, first step
    included."""
    return functools.partial(torch.optim.SGD, lr=learning_rate,
                             momentum=momentum or 0.0, dampening=0.0,
                             nesterov=bool(nesterov))


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8):
    """``optax.adam`` (``eps_root`` 0): p -= lr * m_hat / (sqrt(v_hat) +
    eps), with no weight decay (``torch.optim.Adam``'s default is none
    too, stated here all the same)."""
    return functools.partial(torch.optim.Adam, lr=learning_rate,
                             betas=(b1, b2), eps=eps, weight_decay=0.0)


def adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4):
    """``optax.adamw``: decoupled weight decay on every leaf,
    p -= lr * (m_hat / (sqrt(v_hat) + eps) + weight_decay * p)."""
    return functools.partial(torch.optim.AdamW, lr=learning_rate,
                             betas=(b1, b2), eps=eps,
                             weight_decay=weight_decay)


class Lamb(torch.optim.Optimizer):
    """``optax.lamb``: Adam's bias-corrected direction u = m_hat /
    (sqrt(v_hat + eps_root) + eps) + weight_decay * p, scaled per leaf by
    the trust ratio ||p|| / ||u|| (1 where either norm is 0), then
    p -= lr * ratio * u. The slots are Adam's (``step``, ``exp_avg``,
    ``exp_avg_sq``), so checkpoints take optax's ``ScaleByAdamState``
    layout.

    The norms are the whole leaf's, as optax takes them: where a
    parameter holds only a shard of its leaf, ``shard_groups[p]`` lists
    the groups (each with ``.size`` and ``.group``, as the Trainer's
    grid gives them) whose ranks hold the other shards, and the squared
    norms are summed over them. The Trainer fills it."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-6,
                 eps_root=0.0, weight_decay=0.0):
        super().__init__(params, dict(lr=lr, betas=(b1, b2), eps=eps,
                                      eps_root=eps_root,
                                      weight_decay=weight_decay))
        self.shard_groups = {}

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        todo = []
        for group in self.param_groups:
            b1, b2 = group['betas']
            for p in group['params']:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st['step'] = torch.tensor(0.0)
                    st['exp_avg'] = torch.zeros_like(p)
                    st['exp_avg_sq'] = torch.zeros_like(p)
                st['step'] += 1
                t = float(st['step'])
                g = p.grad
                st['exp_avg'].mul_(b1).add_(g, alpha=1 - b1)
                st['exp_avg_sq'].mul_(b2).addcmul_(g, g, value=1 - b2)
                u = (st['exp_avg'] / (1 - b1 ** t)) / (
                    (st['exp_avg_sq'] / (1 - b2 ** t) + group['eps_root'])
                    .sqrt() + group['eps'])
                if group['weight_decay']:
                    u.add_(p, alpha=group['weight_decay'])
                todo.append((p, u, group['lr']))
        if not todo:
            return loss
        sq = torch.stack([torch.stack([(p.float() * p.float()).sum(),
                                       (u.float() * u.float()).sum()])
                          for p, u, _ in todo])
        self._sum_shards(sq, [p for p, _, _ in todo])
        norms = sq.sqrt()
        for (p, u, lr), (pn, un) in zip(todo, norms.unbind(0)):
            ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn),
                                pn / un)
            p.sub_(u * (lr * ratio).to(u.dtype))
        return loss

    def _sum_shards(self, sq, params):
        """Sum each sharded leaf's squared norms over its groups."""
        import torch.distributed as dist
        by_groups = {}
        for i, p in enumerate(params):
            groups = tuple(g for g in self.shard_groups.get(p, ())
                           if g.size > 1)
            if groups:
                by_groups.setdefault(groups, []).append(i)
        # every rank holds the same leaves in the same order, so each
        # rank of a group posts its collectives in the same order
        for groups, idx in sorted(by_groups.items(),
                                  key=lambda kv: kv[1][0]):
            part = sq[idx].contiguous()
            for g in groups:
                dist.all_reduce(part, group=g.group)
            sq[idx] = part


def lamb(learning_rate, b1=0.9, b2=0.999, eps=1e-6, eps_root=0.0,
         weight_decay=0.0):
    """``optax.lamb`` with optax's defaults (see :class:`Lamb`)."""
    return functools.partial(Lamb, lr=learning_rate, b1=b1, b2=b2, eps=eps,
                             eps_root=eps_root, weight_decay=weight_decay)
