"""Kernels: device ms a step in the port's flash-attention kernels (K1
forward, K2 dQ, K3 dK/dV). Nothing where no flash kernel ran."""
from perfbench import trace


def read(rec):
    return trace.ms_per_step(rec, lambda k: trace.kind(k[0]) == 'flash',
                             none_if_empty=True)
