"""The work of a kernel launch: FLOP and bytes, and who is counting them.

The CUDA kernels launch through ``ctypes``, so neither PyTorch's FLOP
counter nor a dispatch mode sees them. Each wrapper reports the work of
the launch it makes (:func:`record`) by the formulas below — the same
ones ``chip_smoke.py`` holds the kernels' times against — to every
counter open at that moment (:func:`recording`). The plain versions the
CPU runs are PyTorch operations, which the counters see as they are, so
nothing is counted twice.

Bytes are the function's own traffic: each input read once and each
output written once.
"""
import contextlib

import torch

_OPEN = []


def attention(kernel, shape, dtype, causal):
    """(FLOP, bytes) of one flash-attention call at ``shape`` [B, H, S,
    D]: 'fwd', 'dq', 'dkv' or 'bwd' (dQ and dK/dV together). Causal work
    counts only the kept (q, k) pairs."""
    b, h, s, d = shape
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    # products of 2*D per pair
    per_pair = {'fwd': 2, 'dq': 3, 'dkv': 4, 'bwd': 7}[kernel]
    el = torch.tensor([], dtype=dtype).element_size()
    tensors_in, rows_in, tensors_out, rows_out = {
        'fwd': (3, 0, 1, 1), 'dq': (4, 2, 1, 0), 'dkv': (4, 2, 2, 0),
        'bwd': (4, 2, 3, 0)}[kernel]
    return (2 * d * pairs * per_pair,
            b * h * s * d * el * (tensors_in + tensors_out) +
            b * h * s * 4 * (rows_in + rows_out))


def conv_bn(n, c_in, c_out, dtype, prologue, want_stats=True):
    """(FLOP, bytes) of one fused 1x1-conv + BatchNorm call: 2 N Cin Cout
    FLOP; bytes of x, W and y once each, plus a and b (f32 [Cin]) with a
    prologue and s1, s2 (f32 [Cout]) with stats."""
    el = torch.tensor([], dtype=dtype).element_size()
    return 2 * n * c_in * c_out, \
        (n * c_in + c_in * c_out + n * c_out) * el + \
        (2 * c_in * 4 if prologue else 0) + (2 * c_out * 4 if want_stats
                                             else 0)


def record(flops, nbytes):
    """Add one launch's work to every open counter."""
    for acc in _OPEN:
        acc['flops'] += flops
        acc['bytes'] += nbytes
        acc['launches'] += 1


@contextlib.contextmanager
def recording():
    """A counter of the kernel launches made inside the block:
    ``{'flops', 'bytes', 'launches'}``."""
    acc = {'flops': 0, 'bytes': 0, 'launches': 0}
    _OPEN.append(acc)
    try:
        yield acc
    finally:
        _OPEN[:] = [a for a in _OPEN if a is not acc]
