"""Collectives: device ms a step of NCCL kernels. Nothing on one card."""
from perfbench import trace


def read(rec):
    return trace.ms_per_step(rec, lambda k: trace.kind(k[0]) == 'nccl',
                             none_if_empty=True)
