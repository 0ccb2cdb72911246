"""Optimizer: device ms a step of the kernels launched inside the
benchmark's ``perfbench.optimizer`` range around the optimizer's
``step``."""
from perfbench import trace


def read(rec):
    return trace.ms_per_step(
        rec, lambda k, r: trace.launched_in(k, r, 'optimizer'),
        with_rank=True, none_if_empty=True)
