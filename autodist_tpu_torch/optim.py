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
