"""Ring attention: sequence-parallel exact attention, and the plain
single-device attention of the short-sequence path.

The counterpart of ``autodist_tpu/parallel/ring_attention.py``. The
sequence axis is split over the ranks of a seq group
(:class:`~autodist_tpu_torch.parallel.mesh.ReplicaGroup`); each rank
keeps its Q shard and the K/V shards travel around the ring, one hop a
step, while the output accumulates in f32 with an online softmax (the
flash-attention merge). The causal mask is built in *global*
positions: after ``step`` hops a rank holds the K/V block of rank
``(my - step) % n``. The last hop would be idle and is skipped.

The block math is plain PyTorch, as the JAX package's is plain jnp: no
Pallas kernel computes it there, so none does here. The hops go
through :func:`~autodist_tpu_torch.parallel.mesh.shift`, whose backward
is the shift the other way round, so autograd differentiates the ring
as JAX differentiates through ``ppermute``.

``local_flash_attention`` is what the model runs below
``flash_attention.MIN_KERNEL_SEQ`` (the seq-128 BERT shape): a
materialized softmax in f32 with P cast to v's dtype before P.V.
"""
import torch

from autodist_tpu_torch.parallel.mesh import shift

NEG_INF = -1e30


def _block_attn(q, k, v, mask, sm_scale):
    """One (Q shard x K/V block) flash partial: the unnormalized output,
    the row max and the row sum, all f32. ``mask`` is additive [Sq, Sk]
    or None."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if mask is not None:
        s = s + mask
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.matmul(p.to(v.dtype), v)
    return o.float(), m, l


def _merge(acc, m_run, l_run, o, m, l):
    """Fold one block's partial into the running accumulators."""
    m_new = torch.maximum(m_run, m)
    alpha = torch.exp(m_run - m_new)      # rescale the old accumulator
    beta = torch.exp(m - m_new)           # rescale the new block
    acc = acc * alpha[..., None] + o * beta[..., None]
    return acc, m_new, l_run * alpha + l * beta


def causal_mask(my, owner, s_shard, device):
    """Additive f32 mask of Q shard ``my`` against the K/V block of
    ``owner``, in global positions."""
    q_pos = my * s_shard + torch.arange(s_shard, device=device)
    k_pos = owner * s_shard + torch.arange(s_shard, device=device)
    allowed = q_pos[:, None] >= k_pos[None, :]
    return torch.where(allowed, 0.0, NEG_INF).to(torch.float32)


def merge_blocks(q, blocks, my, causal=True, sm_scale=None):
    """The ring's block-and-merge for Q shard ``my``: ``blocks`` yields
    ``(owner, k, v)``, the K/V shards in the order the ring brings them.
    Returns the output shard in q's dtype."""
    s_shard = q.shape[2]
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    acc = m_run = l_run = None
    for owner, k, v in blocks:
        mask = causal_mask(my, owner, s_shard, q.device) if causal else None
        o, m, l = _block_attn(q, k, v, mask, sm_scale)
        if acc is None:
            acc = torch.zeros_like(o)
            m_run = torch.full_like(m, float('-inf'))
            l_run = torch.zeros_like(l)
        acc, m_run, l_run = _merge(acc, m_run, l_run, o, m, l)
    # a fully masked row would leave l_run == 0 (causal self-attention
    # always sees its own position); guard all the same
    out = acc / torch.clamp(l_run, min=1e-30)[..., None]
    return out.to(q.dtype)


def _visits(group, k, v):
    """(owner, k, v) after each hop: after ``step`` hops a rank holds the
    block of rank ``(my - step) % n``. The final hop would be idle, so
    it is skipped."""
    n, my = group.size, group.rank
    for step in range(n):
        yield (my - step) % n, k, v
        if step < n - 1:
            k, v = shift(group, [k, v])


def ring_attention(q, k, v, group, causal=True, sm_scale=None):
    """Exact attention over a ring-sharded sequence axis.

    Args:
        q, k, v: [batch, heads, seq_shard, head_dim] local shards.
        group: the seq group carrying the shards, rank r holding
            positions [r·seq_shard, (r+1)·seq_shard).
        causal: apply a causal mask in global positions.
        sm_scale: softmax scale (default 1/sqrt(head_dim)).

    Returns:
        [batch, heads, seq_shard, head_dim] local output shard, in q's
        dtype.
    """
    return merge_blocks(q, _visits(group, k, v), group.rank, causal,
                        sm_scale)


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
