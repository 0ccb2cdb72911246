"""Models: device ms a step in GEMM kernels (cuBLAS, CUTLASS), averaged
over the traced steps and the cards."""
from perfbench import trace


def read(rec):
    return trace.ms_per_step(rec, lambda k: trace.kind(k[0]) == 'gemm')
