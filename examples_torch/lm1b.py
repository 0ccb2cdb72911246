"""LM1B language model through the PyTorch port: a multi-layer LSTM LM
with a large vocabulary, paired (as the reference pairs it) with
PartitionedPS, through ``trainer_from_strategy``.

The counterpart of ``examples/lm1b.py``. Text comes from
``SYS_DATA_PATH`` / ``--data`` (a ``tokens.npy`` there) or a synthetic
stream.

    python examples_torch/lm1b.py --vocab 100000 --steps 10
    python examples_torch/lm1b.py --device cpu --tiny --steps 3
"""
import argparse
import os

import _common
import numpy as np

from autodist_tpu_torch import optim
from autodist_tpu_torch import strategy as strategies
from autodist_tpu_torch.models.rnn import LSTMLM
from autodist_tpu_torch.strategy.adapter import trainer_from_strategy


def load_tokens(args):
    data = args.data or os.environ.get('SYS_DATA_PATH') or ''
    path = os.path.join(data, 'tokens.npy') if data else ''
    if path and os.path.exists(path):
        toks = np.load(path).astype(np.int32)
        need = args.batch * (args.seq + 1)
        toks = np.resize(toks, (need,))
    else:
        rng = np.random.RandomState(0)
        toks = rng.randint(0, args.vocab,
                           (args.batch * (args.seq + 1),), dtype=np.int32)
    toks = toks.reshape(args.batch, args.seq + 1)
    return {'tokens': toks[:, :-1], 'targets': toks[:, 1:]}


def parse(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--vocab', type=int, default=100000)
    p.add_argument('--dim', type=int, default=512)
    p.add_argument('--hidden', type=int, default=1024)
    p.add_argument('--layers', type=int, default=2)
    p.add_argument('--batch', type=int, default=128)
    p.add_argument('--seq', type=int, default=32)
    p.add_argument('--steps', type=int, default=10)
    p.add_argument('--lr', type=float, default=1e-3)
    p.add_argument('--tiny', action='store_true')
    p.add_argument('--strategy', default='PartitionedPS')
    p.add_argument('--data', default=None)
    _common.add_device_flag(p)
    args = p.parse_args(argv)
    if args.tiny:
        args.vocab, args.dim, args.hidden = 1000, 32, 64
        args.batch, args.seq = 16, 16
    return args


def run(args, losses=None):
    """Train on one batch of tokens; returns (tokens/s, last loss,
    processes). ``losses`` (a list) gets every step's loss."""
    model = LSTMLM(vocab=args.vocab, dim=args.dim, hidden=args.hidden,
                   n_layers=args.layers, device=args.device)
    builder = getattr(strategies, args.strategy)()
    trainer = trainer_from_strategy(model, optim.adam(args.lr), builder)
    state = trainer.init(seed=0)
    batch = load_tokens(args)
    state, loss, dt = _common.timed_steps(trainer, state, batch, args.steps,
                                          losses)
    return args.steps * args.batch * args.seq / dt, loss, trainer.world


def main(argv=None):
    args = parse(argv)
    tps, loss, n = run(args)   # one process (and device) per rank
    print('lm1b-lstm [%s]: %.0f tokens/s (%.0f /chip), ppl=%.2f' %
          (args.strategy, tps, tps / n, float(np.exp(min(loss, 20)))))


if __name__ == '__main__':
    main()
