"""Neural Collaborative Filtering through the PyTorch port: GMF+MLP
towers over user/item embedding tables, the canonical sparse-variable
workload.

The counterpart of ``examples/ncf.py``: ml-20m's table sizes by default,
the reference's pairing of PSLoadBalancing with partitioned embeddings,
through ``trainer_from_strategy``.

    python examples_torch/ncf.py --users 100000 --items 50000 --steps 10
    python examples_torch/ncf.py --device cpu --tiny --steps 3
"""
import argparse

import _common
import numpy as np

from autodist_tpu_torch import optim
from autodist_tpu_torch import strategy as strategies
from autodist_tpu_torch.models.ncf import NCF
from autodist_tpu_torch.strategy.adapter import trainer_from_strategy


def parse(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--users', type=int, default=138493)   # ml-20m scale
    p.add_argument('--items', type=int, default=26744)
    p.add_argument('--batch', type=int, default=4096)
    p.add_argument('--steps', type=int, default=10)
    p.add_argument('--lr', type=float, default=1e-3)
    p.add_argument('--tiny', action='store_true')
    p.add_argument('--strategy', default='PSLoadBalancing')
    _common.add_device_flag(p)
    args = p.parse_args(argv)
    if args.tiny:
        args.users, args.items, args.batch = 1000, 500, 256
    return args


def run(args, losses=None):
    """Train on one batch; returns (examples/s, last loss, processes).
    ``losses`` (a list) gets every step's loss."""
    model = NCF(args.users, args.items, mf_dim=8 if args.tiny else 64,
                mlp_dims=(16, 8) if args.tiny else (256, 128, 64),
                device=args.device)
    builder = getattr(strategies, args.strategy)()
    trainer = trainer_from_strategy(model, optim.adam(args.lr), builder)
    state = trainer.init(seed=0)

    rng = np.random.RandomState(0)
    batch = {
        'users': rng.randint(0, args.users, (args.batch,), dtype=np.int32),
        'items': rng.randint(0, args.items, (args.batch,), dtype=np.int32),
        'labels': rng.randint(0, 2, (args.batch,), dtype=np.int32)}

    state, loss, dt = _common.timed_steps(trainer, state, batch, args.steps,
                                          losses)
    return args.steps * args.batch / dt, loss, trainer.world


def main(argv=None):
    args = parse(argv)
    ex, loss, n = run(args)   # one process (and device) per rank
    print('ncf [%s]: %.0f examples/s (%.0f /chip), loss=%.4f' %
          (args.strategy, ex, ex / n, loss))


if __name__ == '__main__':
    main()
