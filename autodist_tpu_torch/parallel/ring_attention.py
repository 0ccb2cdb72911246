"""Plain single-device attention: the short-sequence path.

The counterpart of ``local_flash_attention`` in
``autodist_tpu/parallel/ring_attention.py``: a materialized softmax in
f32 with P cast to v's dtype before P.V, which is what the model runs
below ``flash_attention.MIN_KERNEL_SEQ`` (the seq-128 BERT shape). It is
plain PyTorch, not a kernel, as the JAX version is plain jnp. Ring
attention proper (sequence parallelism over a ring of ranks) waits for
a later slice of the port.
"""
import torch

NEG_INF = -1e30


def local_flash_attention(q, k, v, causal=True, sm_scale=None):
    """Exact attention over [batch, heads, seq, head_dim]; output in v's
    dtype."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = torch.arange(sq, device=s.device)[:, None] >= \
            torch.arange(sk, device=s.device)[None, :]
        s = torch.where(mask, s, torch.full((), NEG_INF, device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v)
