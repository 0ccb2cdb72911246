"""Shared bootstrap of the port's examples: the repo root on the import
path, the ``--device`` flag, and a timed-steps harness.

Every example runs on the card unless ``--device cpu`` is given; none
imports jax or the JAX package.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def add_device_flag(parser):
    parser.add_argument('--device', default='cuda',
                        help="where to run: 'cuda' (default) or 'cpu'")


def timed_steps(trainer, state, batch, steps, losses=None):
    """Place the batch once, take one warm-up step, then time ``steps``
    steps. The host read of the loss (``float``) fences each timing.
    With a list as ``losses``, every step's loss (the warm-up's first) is
    appended to it, a host read each step. Returns ``(state, last_loss,
    elapsed_s)``."""
    step = trainer.compile_step(state, batch)
    batch = trainer.shard_batch(batch)
    state, metrics = step(state, batch)   # warm-up
    first = float(metrics['loss'])
    if losses is not None:
        losses.append(first)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step(state, batch)
        if losses is not None:
            losses.append(float(metrics['loss']))
    loss = float(metrics['loss'])
    return state, loss, time.perf_counter() - t0
