"""BERT-large pre-training benchmark on the PyTorch port's functional
Trainer: masked-LM-style training of the TransformerLM in bfloat16 with
LAMB or AdamW, multi-axis parallelism through ``ParallelSpec``
(dp / tp / pp / sp / zero, microbatches and the pipeline schedule).

The counterpart of ``examples/bert.py``. ``bert_large`` runs at seq 512
by default, ``MIN_KERNEL_SEQ``, so its attention goes through the
hand-written flash kernels (non-causal) on the card. One process per
device: the spec's degrees multiply to the world (``torchrun`` or
``AUTODIST_PROCESS_ID`` / ``AUTODIST_NUM_PROCESSES`` for more than one).

    python examples_torch/bert.py --config bert_large --batch 8 --steps 20
    python examples_torch/bert.py --device cpu --config tiny --steps 3
"""
import argparse

import _common
import numpy as np
import torch

from autodist_tpu_torch import optim
from autodist_tpu_torch.api import Trainer
from autodist_tpu_torch.models.transformer import (TransformerConfig,
                                                   TransformerLM)
from autodist_tpu_torch.parallel.axes import ParallelSpec


def parse(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--config', default='tiny',
                   choices=['tiny', 'gpt_small', 'bert_large'])
    p.add_argument('--batch', type=int, default=8, help='global batch')
    p.add_argument('--seq', type=int, default=None)
    p.add_argument('--steps', type=int, default=10)
    p.add_argument('--lr', type=float, default=1e-4)
    p.add_argument('--optimizer', default='adamw',
                   choices=['adamw', 'lamb'])
    p.add_argument('--dp', type=int, default=None)
    p.add_argument('--tp', type=int, default=1)
    p.add_argument('--pp', type=int, default=1)
    p.add_argument('--sp', type=int, default=1)
    p.add_argument('--sp-mode', default='ring', choices=['ring', 'ulysses'])
    p.add_argument('--zero', type=int, default=1)
    p.add_argument('--microbatches', type=int, default=1)
    p.add_argument('--pp-schedule', default='gpipe',
                   choices=['gpipe', '1f1b'],
                   help="'1f1b': interleaved schedule, live activations "
                        'bounded by the pipe depth')
    p.add_argument('--pp-variant', default='auto',
                   choices=['auto', 'remat', 'stash', 'legacy'],
                   help='1f1b backward: remat (pp-bounded memory) | stash '
                        '(per-microbatch boundary stash) | auto (stash '
                        'while it fits)')
    p.add_argument('--grad-accum', type=int, default=1)
    p.add_argument('--fp32', action='store_true')
    _common.add_device_flag(p)
    return p.parse_args(argv)


def build(args):
    """(trainer, state, batch, seq) for ``args``."""
    dtype = torch.float32 if (args.fp32 or args.config == 'tiny') \
        else torch.bfloat16
    cfg = getattr(TransformerConfig, args.config)(
        dtype=dtype, remat=(args.config == 'bert_large'))
    seq = args.seq or (512 if args.config == 'bert_large' else 64)
    model = TransformerLM(cfg, device=args.device, seed=0)
    opt = (optim.lamb if args.optimizer == 'lamb' else optim.adamw)(args.lr)
    spec = ParallelSpec(dp=args.dp or 0, tp=args.tp, pp=args.pp, sp=args.sp,
                        sp_mode=args.sp_mode, zero=args.zero,
                        microbatches=args.microbatches,
                        pp_schedule=args.pp_schedule,
                        pp_variant=args.pp_variant,
                        grad_accum=args.grad_accum)
    trainer = Trainer(model, opt, spec=spec)
    state = trainer.init(seed=0)

    rng = np.random.RandomState(0)
    batch = {
        'tokens': rng.randint(0, cfg.vocab, (args.batch, seq),
                              dtype=np.int32),
        'targets': rng.randint(0, cfg.vocab, (args.batch, seq),
                               dtype=np.int32)}
    return trainer, state, batch, seq


def run(args, losses=None):
    """Train ``args.steps`` timed steps after a warm-up; returns (tokens/s,
    last loss, trainer). ``losses`` (a list) gets every step's loss."""
    trainer, state, batch, seq = build(args)
    state, loss, dt = _common.timed_steps(trainer, state, batch, args.steps,
                                          losses)
    return args.steps * args.batch * seq / dt, loss, trainer


def main(argv=None):
    args = parse(argv)
    tps, loss, trainer = run(args)
    n = trainer.world   # one process (and device) per rank
    print('%s (%s): %.0f tokens/s (%.0f tokens/s/chip), loss=%.4f' %
          (args.config, dict(trainer.grid.shape), tps, tps / n, loss))


if __name__ == '__main__':
    main()
