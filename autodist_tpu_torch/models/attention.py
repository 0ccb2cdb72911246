"""Multi-head attention for the port.

The counterpart of ``autodist_tpu/models/attention.py``. With a live
seq group (``core.seq_group()``, set by the Trainer under sequence
parallelism) the attention runs over it by ``core.sp_mode()``: Ulysses
(:mod:`autodist_tpu_torch.parallel.ulysses`) or the ring
(:mod:`autodist_tpu_torch.parallel.ring_attention`), as the JAX module
dispatches on its manual ``seq`` axis. Otherwise each rank holds its
local batch, so the JAX package's unsharded branch and its
nested-manual ``_tp_manual_flash`` branch are one rule here: the flash
kernel when ``flash_attention.preferred(q.shape)`` holds, else
``local_flash_attention``. Tensor parallelism is refused by
``ParallelSpec`` until it is ported.
"""
import torch

from autodist_tpu_torch.kernels import flash_attention as fa
from autodist_tpu_torch.models.core import Dense, Module, seq_group, sp_mode
from autodist_tpu_torch.parallel.ring_attention import (local_flash_attention,
                                                        ring_attention)
from autodist_tpu_torch.parallel.ulysses import ulysses_attention


class MultiHeadAttention(Module):
    """Causal (or full) self-attention; [batch, seq, embed] in/out."""

    def __init__(self, dim, num_heads, head_dim=None, causal=True,
                 dtype=torch.float32, device=None, stack=()):
        super().__init__(stack)
        self.dim = dim
        self.num_heads = num_heads
        self.head_dim = head_dim or dim // num_heads
        self.causal = causal
        self.dtype = dtype
        inner = self.num_heads * self.head_dim
        # fused qkv, laid out [b, s, 3, h, d] as in the JAX package
        self.qkv = Dense(dim, 3 * inner, 'embed', 'heads', use_bias=False,
                         dtype=dtype, device=device, stack=stack)
        self.out = Dense(inner, dim, 'heads', 'embed', use_bias=False,
                         dtype=dtype, device=device, stack=stack)

    def param_defs(self):
        return {'qkv': self.qkv, 'out': self.out}

    def apply(self, params, x):
        b, s, _ = x.shape
        h, d = self.num_heads, self.head_dim
        qkv = self.qkv.apply(params['qkv'], x).reshape(b, s, 3, h, d)
        # [b, s, 3, h, d] -> 3 x [b, h, s, d]
        q, k, v = qkv.permute(2, 0, 3, 1, 4).contiguous().unbind(0)
        seq = seq_group()
        if seq is not None:
            if sp_mode() == 'ulysses':
                o = ulysses_attention(q, k, v, seq, causal=self.causal)
            else:
                o = ring_attention(q, k, v, seq, causal=self.causal)
        elif fa.preferred(q.shape):
            o = fa.flash_attention(q, k, v, causal=self.causal)
        else:
            o = local_flash_attention(q, k, v, causal=self.causal)
        o = o.transpose(1, 2).reshape(b, s, h * d)
        return self.out.apply(params['out'], o)
