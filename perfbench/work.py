"""Frozen arithmetic of the yardstick: the H100's peaks, the model FLOP
of a training step, and the (FLOP, bytes) bound of a flash-attention
launch.

The attention bound is a copy of ``autodist_tpu_torch/kernels/work.py``
(``attention``) as it stood when the benchmark was written: a later
change to the program cannot move it.
"""

#: NVIDIA H100 SXM data sheet, dense, at the 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

_ITEMSIZE = {'bfloat16': 2, 'float16': 2, 'float32': 4}


def matmul_params(cfg):
    """Parameters that enter a matmul in one token's forward: per layer
    the fused qkv (d x 3d), the output (d x d), the MLP up and down
    (d x f, f x d), then the head (d x vocab; the tied table counts
    once, as the head; a lookup is no matmul)."""
    d, f = cfg['dim'], cfg['dim'] * cfg['mlp_ratio']
    return cfg['n_layers'] * (4 * d * d + 2 * d * f) + d * cfg['vocab']


def attention_pairs(seq, causal):
    """(query, key) pairs a head scores in one sequence: every pair, or
    the kept ones of a causal mask, diagonal included."""
    return seq * (seq + 1) // 2 if causal else seq * seq


def step_flops(cfg, seq, rows):
    """The model FLOP of one training step over ``rows`` sequences of
    ``seq`` tokens: 6 N T for the matmul parameters (forward 2, backward
    4), plus attention's QK^T and PV, 2 x 2 d FLOP a kept pair forward
    and twice that backward. Recompute is not counted.

    gpt2-small at s4096 b4: N = 12 (4 768^2 + 2 768 3072) + 768 50257
    = 123,532,032; 6 N T = 12.143 TFLOP; attention 12 x 4 x 8,390,656
    x 12 x 768 = 3.712 TFLOP; 15.855 TFLOP a step.
    bert-large at s512 b32: N = 24 (4 1024^2 + 2 1024 4096) + 1024
    30522 = 333,221,888; 6 N T = 32.757 TFLOP; attention 24 x 32 x
    262,144 x 12 x 1024 = 2.474 TFLOP; 35.231 TFLOP a step."""
    tokens = seq * rows
    dense = 6 * matmul_params(cfg) * tokens
    attn = cfg['n_layers'] * rows * attention_pairs(seq, cfg['causal']) \
        * 12 * cfg['dim']
    return dense + attn


def attention(kernel, shape, dtype, causal):
    """(FLOP, bytes) of one flash-attention launch at ``shape`` [B, H,
    S, D]: 'fwd', 'dq' or 'dkv'. Causal work counts only the kept
    pairs; bytes are each input read once and each output written
    once, the f32 row vectors (lse, delta) included."""
    b, h, s, d = shape
    pairs = b * h * attention_pairs(s, causal)
    per_pair = {'fwd': 2, 'dq': 3, 'dkv': 4}[kernel]
    el = _ITEMSIZE[dtype]
    tensors_in, rows_in, tensors_out, rows_out = {
        'fwd': (3, 0, 1, 1), 'dq': (4, 2, 1, 0), 'dkv': (4, 2, 2, 0)}[kernel]
    return (2 * d * pairs * per_pair,
            b * h * s * d * el * (tensors_in + tensors_out) +
            b * h * s * 4 * (rows_in + rows_out))


def bound_s(flops, nbytes):
    """The least time the card could take: the larger of the two."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
