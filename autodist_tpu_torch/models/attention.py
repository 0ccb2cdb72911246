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
``local_flash_attention``.

Under tensor parallelism (a live ``'heads'`` axis) each rank of the
model group runs ``h / tp`` heads: the fused qkv kernel is
column-parallel, and its shard is the rank's block of heads of the
``[dim, 3, h, d]`` view (``ParamDef.view``), where the JAX package's
GSPMD reshards across the ``reshape(b, s, 3, h, d)``; ``out`` is
row-parallel. The local attention then dispatches as above on the
local shape ``[b, h / tp, s, d]``, which is what the JAX
``_tp_manual_flash`` runs the kernel on; Ulysses splits the local heads
over the seq group, so it needs ``(h / tp) % sp == 0``.
"""
import torch

from autodist_tpu_torch.kernels import flash_attention as fa
from autodist_tpu_torch.models.core import (Dense, Module, ParamDef,
                                            seq_group, sp_mode)
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
        self.qkv = _QkvDense(dim, self.num_heads, self.head_dim,
                             dtype=dtype, device=device, stack=stack)
        self.out = Dense(inner, dim, 'heads', 'embed', use_bias=False,
                         dtype=dtype, device=device, stack=stack)

    def param_defs(self):
        return {'qkv': self.qkv, 'out': self.out}

    def apply(self, params, x):
        b, s, _ = x.shape
        d = self.head_dim
        qkv = self.qkv.apply(params['qkv'], x)
        h = qkv.shape[-1] // (3 * d)     # this rank's heads
        qkv = qkv.reshape(b, s, 3, h, d)
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


class _QkvDense(Dense):
    """The fused qkv product: a ``Dense`` whose kernel ``[dim, 3 · h ·
    d]`` is sharded by its ``[dim, 3, h, d]`` view, heads on the model
    axis."""

    def __init__(self, dim, heads, head_dim, **kw):
        self.heads, self.head_dim = heads, head_dim
        super().__init__(dim, 3 * heads * head_dim, 'embed', 'heads',
                         use_bias=False, **kw)

    def param_defs(self):
        return {'kernel': ParamDef(
            (self.in_dim, self.out_dim), (self.in_axis, self.out_axis),
            'fan_in', view=((self.in_dim, 3, self.heads, self.head_dim),
                            (self.in_axis, None, self.out_axis, None)))}
