"""Gradient compressors wrapping the all-reduce collective.

The counterpart of ``autodist_tpu/parallel/compressor.py``:
``NoneCompressor``, ``HorovodCompressor`` (bfloat16 wire),
``HorovodCompressorEF`` (error feedback), ``Int8RingCompressor`` (int8
wire with one f32 scale per ``AUTODIST_QUANT_BLOCK`` elements, its ring
a send/recv ring over the replica group, and its two-level form over the
node subgroups) and ``PowerSGDCompressor``
(rank-2 power iteration with error feedback).

A compressor transforms this replica's gradient before the collective
and back after; its persistent state (the residual, PowerSGD's ``q``)
is this replica's own, kept by the session.
"""
import torch

_REGISTRY = {}


def register(cls):
    _REGISTRY[cls.__name__] = cls
    return cls


def create(name, var_name):
    """Factory by proto enum name (reference Compressor.create)."""
    if name not in _REGISTRY:
        raise ValueError('Unknown compressor %r (have %s)' %
                         (name, sorted(_REGISTRY)))
    return _REGISTRY[name](var_name)


class Compressor:
    """Base: ``reduce(grad, env, reduce_fn) -> averaged gradient``."""

    def __init__(self, var_name):
        self.var_name = var_name

    def init_state(self, var_value):
        """Aux state of this compressor ({} if stateless); ``var_value``
        is the variable's numpy initial value."""
        return {}

    def reduce(self, grad, env, reduce_fn):
        raise NotImplementedError


@register
class NoneCompressor(Compressor):
    """Straight all-reduce."""

    def reduce(self, grad, env, reduce_fn):
        return reduce_fn(grad)


@register
class HorovodCompressor(Compressor):
    """Cast f32 to bfloat16 for the wire, cast back after."""

    def reduce(self, grad, env, reduce_fn):
        if grad.dtype == torch.float32:
            return reduce_fn(grad.to(torch.bfloat16)).to(torch.float32)
        return reduce_fn(grad)


@register
class HorovodCompressorEF(Compressor):
    """bfloat16 all-reduce with error feedback: the rounding residual is
    carried to the next step and added back before compression."""

    def init_state(self, var_value):
        import numpy as np
        if var_value.dtype != np.float32:
            return {}
        return {'residual': torch.zeros(var_value.shape,
                                        dtype=torch.float32)}

    def reduce(self, grad, env, reduce_fn):
        key = 'compressor/%s' % self.var_name
        if grad.dtype != torch.float32:
            return reduce_fn(grad)
        compensated = grad + env.aux_state[key]['residual']
        compressed = compensated.to(torch.bfloat16)
        env.aux_updates[key] = {
            'residual': compensated - compressed.to(torch.float32)}
        return reduce_fn(compressed).to(torch.float32)


def quant_block_size():
    """Elements per int8 quantization block (``AUTODIST_QUANT_BLOCK``)."""
    from autodist_tpu_torch.const import ENV
    return ENV.AUTODIST_QUANT_BLOCK.val


def _quantize_int8_blocks(x, block):
    """Symmetric per-block int8 quantization of a flat f32 vector:
    ``(q [nb, block] int8, scales [nb] f32)``, zero-padded to a block
    multiple."""
    flat = x.reshape(-1).to(torch.float32)
    nb = -(-flat.numel() // block)
    flat = torch.nn.functional.pad(flat, (0, nb * block - flat.numel()))
    blocks = flat.reshape(nb, block)
    scales = blocks.abs().amax(dim=1) / 127.0 + 1e-30
    q = torch.clamp(torch.round(blocks / scales[:, None]),
                    -127, 127).to(torch.int8)
    return q, scales


def _dequantize_int8_blocks(q, scales, size):
    """Inverse of :func:`_quantize_int8_blocks` (flat f32, pad removed)."""
    return (q.to(torch.float32) * scales[:, None]).reshape(-1)[:size]


def block_roundtrip(x, block=None):
    """What a block-quantized int8 wire carries for ``x``:
    dequantize(quantize(x)), same shape."""
    block = block or quant_block_size()
    q, scales = _quantize_int8_blocks(x, block)
    return _dequantize_int8_blocks(q, scales, x.numel()).reshape(x.shape)


def int8_ring_all_reduce(x, group, block=None):
    """Int8-wire all-reduce (sum) over ``group``, block-quantized.

    Ring reduce-scatter with per-hop requantization (each hop ships an
    int8 chunk and its block scales to the next replica), then an int8
    all-gather of the reduced chunks — the JAX package's schedule, its
    ``ppermute`` hops as send/recv pairs."""
    n = group.size
    if n == 1:
        return x
    block = block or quant_block_size()
    shape = x.shape
    flat = x.reshape(-1).to(torch.float32)
    m = -(-flat.numel() // n)
    chunks = torch.nn.functional.pad(
        flat, (0, m * n - flat.numel())).reshape(n, m)
    me = group.rank
    # after n-1 hops replica i owns the full sum of chunk (i+1) % n
    cur = chunks[me]
    for step in range(n - 1):
        q, scales = _quantize_int8_blocks(cur, block)
        q, scales = group.shift(q), group.shift(scales)
        cur = _dequantize_int8_blocks(q, scales, m) + \
            chunks[(me - step - 1) % n]
    q, scales = _quantize_int8_blocks(cur, block)
    all_q = group.stack(q)              # [n, nb, block] int8
    all_s = group.stack(scales)         # [n, nb]
    full = (all_q.to(torch.float32) * all_s[:, :, None]).reshape(n, -1)[:, :m]
    # replica row j holds chunk (j+1)%n -> chunk c sits at row (c-1)%n
    full = full[[(c - 1) % n for c in range(n)]]
    return full.reshape(-1)[:x.numel()].reshape(shape)


def int8_grouped_ring_all_reduce(x, group, groups, block=None):
    """Block-quantized int8 ring all-reduce (sum) over INDEPENDENT
    equal-size groups of replica positions: the recipe of
    :func:`int8_ring_all_reduce`, its ring run within each group at
    once (each replica's ring is its group's subgroup). This is the
    inter-node phase of the two-level schedule: ``groups`` then holds
    one same-chunk representative per node."""
    if len(groups[0]) == 1:
        return x
    return int8_ring_all_reduce(x, group.split(groups), block=block)


def int8_hierarchical_all_reduce(x, group, node_groups, block=None):
    """Two-level int8-wire all-reduce (sum): quantize once, requantize
    at the tier boundary.

    The caller has already block-roundtripped the bucket once (the
    "quantize once" of the error-feedback contract); the intra-node
    phases then ride plain f32 collectives on the fast link, and only
    the tier BOUNDARY requantizes: each node's partial chunk sum rides
    the int8 ring across nodes (per-hop requantization), and the
    reduced chunks all-gather back within each node at f32.
    """
    from autodist_tpu_torch.parallel.plan import _inter_groups
    k = len(node_groups)
    g = len(node_groups[0])
    if k <= 1 or g <= 1:
        return int8_ring_all_reduce(x, group, block=block)
    shape = x.shape
    flat = x.reshape(-1).to(torch.float32)
    m = -(-flat.numel() // g) * g
    flat = torch.nn.functional.pad(flat, (0, m - flat.numel()))
    intra = group.split(node_groups)
    cur = intra.reduce_scatter(flat)
    cur = int8_grouped_ring_all_reduce(cur, group,
                                       _inter_groups(node_groups),
                                       block=block)
    out = intra.all_gather(cur)
    return out[:x.numel()].reshape(shape)


def int8_bucket_fusable(compressor, dtype, size):
    """THE bucket-fusion predicate for the int8 tier, shared by the
    traced emission and ``static_collective_schedule``: f32 tensors of
    at least ``MIN_SIZE`` elements (the ones with a residual)."""
    import numpy as np
    if isinstance(dtype, torch.dtype):
        dtype = str(dtype).replace('torch.', '')
    return (type(compressor) is Int8RingCompressor and
            np.dtype(dtype) == np.float32 and
            size >= Int8RingCompressor.MIN_SIZE)


@register
class Int8RingCompressor(Compressor):
    """Int8-wire quantized all-reduce with error feedback. Tensors below
    ``MIN_SIZE`` elements, or not f32, take the plain collective."""

    MIN_SIZE = 128

    def init_state(self, var_value):
        import numpy as np
        if var_value.dtype != np.float32 or \
                np.prod(var_value.shape, dtype=int) < self.MIN_SIZE:
            return {}
        return {'residual': torch.zeros(var_value.shape,
                                        dtype=torch.float32)}

    def reduce(self, grad, env, reduce_fn):
        if grad.dtype != torch.float32 or grad.numel() < self.MIN_SIZE:
            return reduce_fn(grad)
        key = 'compressor/%s' % self.var_name
        compensated = grad + env.aux_state[key]['residual']
        transmitted = block_roundtrip(compensated)
        env.aux_updates[key] = {'residual': compensated - transmitted}
        group = env.plan.group
        return int8_ring_all_reduce(transmitted, group) / group.size


@register
class PowerSGDCompressor(Compressor):
    """Rank-``RANK`` PowerSGD (arXiv:1905.13727) with error feedback:
    ``M ~ P Q^T`` with ``P = M Q`` and ``Q = M^T P`` all-reduced; plain
    all-reduce for tensors of rank < 2."""

    RANK = 2

    def init_state(self, var_value):
        if var_value.ndim < 2:
            return {}
        import zlib
        import numpy as np
        n = int(var_value.shape[0])
        m = int(np.prod(var_value.shape[1:]))
        # deterministic across processes (crc32, not the salted hash)
        rng = np.random.RandomState(
            zlib.crc32(self.var_name.encode()) % (2 ** 31))
        q = rng.standard_normal((m, self.RANK)).astype('float32')
        return {'q': torch.from_numpy(q),
                'residual': torch.zeros((n, m), dtype=torch.float32)}

    def reduce(self, grad, env, reduce_fn):
        if grad.dim() < 2:
            return reduce_fn(grad)
        key = 'compressor/%s' % self.var_name
        state = env.aux_state[key]
        shape = grad.shape
        mat = grad.reshape(shape[0], -1) + state['residual']
        p, _ = torch.linalg.qr(reduce_fn(mat @ state['q']))
        new_q = reduce_fn(mat.T @ p)
        approx = p @ new_q.T
        env.aux_updates[key] = {'q': new_q, 'residual': mat - approx}
        return approx.reshape(shape)
