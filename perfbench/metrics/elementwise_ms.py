"""Models: device ms a step in every kernel that is no GEMM, no flash
kernel, no collective and not launched by the optimizer: LayerNorm,
GELU, the master-weight casts, softmax and the NLL, copies and sets."""
from perfbench import trace


def read(rec):
    return trace.ms_per_step(
        rec, lambda k, r: trace.kind(k[0]) == 'other' and
        not trace.launched_in(k, r, 'optimizer'), with_rank=True)
