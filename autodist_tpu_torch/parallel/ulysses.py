"""Ulysses sequence parallelism: an all-to-all head/sequence transposition.

The counterpart of ``autodist_tpu/parallel/ulysses.py`` (DeepSpeed-
Ulysses, arXiv:2309.14509). Where ring attention keeps Q local and
rotates K/V around the seq group, Ulysses transposes the split instead:
one all-to-all takes q, k and v from sequence-split / all heads
``[b, h, s/n, d]`` to head-split / the whole sequence ``[b, h/n, s, d]``,
attention runs locally per head group, and a second all-to-all takes the
output back. Heads must divide by the seq group's size.

The local attention is the flash kernels (K1-K3,
:mod:`autodist_tpu_torch.kernels.flash_attention`) when
``flash_attention.preferred`` holds for the transposed shape, else
``local_flash_attention``: the rule ``models/attention.py`` applies to
every local attention of the port. (The JAX package also asks that the
trace run on device-local data, ``unsharded_execution()``; a rank's
tensors here are always its own, and both compute the same function.)
The all-to-alls go through
:func:`~autodist_tpu_torch.parallel.mesh.all_to_all`, whose backward is
the inverse all-to-all.
"""
import torch

from autodist_tpu_torch.kernels import flash_attention as fa
from autodist_tpu_torch.parallel.mesh import all_to_all
from autodist_tpu_torch.parallel.ring_attention import local_flash_attention


def local_attention(q, k, v, causal, sm_scale=None):
    """Attention over device-local [b, h, s, d]: the flash kernels when
    ``fa.preferred`` holds, else the plain path."""
    if fa.preferred(q.shape):
        return fa.flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    return local_flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)


def ulysses_attention(q, k, v, group, causal=True, sm_scale=None):
    """Exact attention over a sequence-split axis via all-to-all.

    Args:
        q, k, v: [batch, heads, seq_shard, head_dim] local shards with all
            the heads (the sequence split over ``group``).
        group: the seq group carrying the shards.
        causal: the standard causal mask (positions are global after the
            transposition).
        sm_scale: softmax scale (default 1/sqrt(head_dim)).

    Returns:
        [batch, heads, seq_shard, head_dim] local output shard.
    """
    n = group.size
    heads = q.shape[1]
    if heads % n != 0:
        raise ValueError(
            'ulysses sp_mode needs heads %% sp == 0 (heads=%d, sp=%d); '
            'use sp_mode="ring" for this config' % (heads, n))
    if n == 1:
        return local_attention(q, k, v, causal, sm_scale)
    # [3, b, h, s/n, d] -> [3, b, h/n, s, d]: one all-to-all for q, k, v
    qkv = all_to_all(group, torch.stack([q, k, v]), 2, 3)
    o = local_attention(*qkv.unbind(0), causal, sm_scale)
    # [b, h/n, s, d] -> [b, h, s/n, d]
    return all_to_all(group, o, 2, 1)
