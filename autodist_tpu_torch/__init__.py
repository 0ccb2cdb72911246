"""autodist_tpu_torch: the PyTorch / CUDA port of autodist_tpu.

A second package beside the JAX reference, ported slice by slice. This
slice trains ``TransformerLM`` data-parallel through :class:`Trainer`
(or :func:`trainer_from_strategy`), with attention at long sequence
through hand-written Hopper flash-attention kernels. It imports torch
and numpy, never jax or the JAX package.
"""
from autodist_tpu_torch.api import Trainer, TrainState  # noqa: F401
from autodist_tpu_torch.parallel.axes import ParallelSpec  # noqa: F401
from autodist_tpu_torch.strategy.adapter import (  # noqa: F401
    trainer_from_strategy)
