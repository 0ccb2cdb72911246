"""Flash attention through hand-written Hopper kernels, fwd + bwd.

The counterpart of ``autodist_tpu/kernels/flash_attention.py``. The three
Pallas TPU kernels there (``_fwd_kernel``, ``_dq_kernel``,
``_dkv_kernel``) are CUDA C++ kernels here, in
``kernels/csrc/flash_attention.cu`` (built for ``sm_90a`` at first use by
:mod:`autodist_tpu_torch.kernels.build`). The algorithm is the same
flash-attention-2 recipe: the score matrix never reaches device memory,
the forward keeps an online softmax per row, and the backward recomputes
P from the saved logsumexp.

Layout: q/k/v are [batch, heads, seq, head_dim]; LSE is f32
[batch, heads, seq, 1], as in the JAX package. ``supports``,
``preferred``, ``_pick_block`` and ``MIN_KERNEL_SEQ`` keep the JAX rule
exactly, so the same shapes take the same branch in both packages. The
CUDA tiles are the kernels' own and are documented in the source: bf16
from head dim 64 on runs all three as TMA-fed wgmma kernels, on 128-row
output tiles (dK/dV from 256 on: 64-row kv tiles, split by columns over
the two consumer warpgroups), in chunks of 256 output columns above
256; every other case runs on the CUDA cores or mma.sync on 64-row
tiles (f32: 32-row query tiles at head dim 256, chunks of 128 columns
above 256). ``kernel_name`` says
which kernel the dispatch picks; the TPU's ``_default_blocks`` tiling
has no counterpart here.

The kernels take head dims 16, 32, 64, 128, 256 and every multiple of 64
above 256; the JAX kernel takes any. ``flash_attention`` zero-pads q, k
and v along the head dim up to the next of these (``padded_head_dim``)
and slices the output back: zero columns of q and k leave every score
unchanged, since ``sm_scale`` comes from the true head dim; zero columns
of v give zero columns of o, and autograd slices dq, dk and dv the same
way.

Beside the kernels live their plain PyTorch versions (``_fwd_plain``,
``_dq_plain``, ``_dkv_plain``): they materialize the scores but keep the
kernels' cast points and constants. A tensor on the CPU goes to them; a
CUDA tensor launches the kernel or raises. ``LAUNCHES`` counts kernel
launches by name, ``KERNEL_LAUNCHES`` by the CUDA kernel that ran.
"""
import ctypes
import functools

import torch
import torch.nn.functional as F

from autodist_tpu_torch.kernels import build, work

NEG_INF = -1e30   # same masking constant as parallel/ring_attention.py
SOURCE = 'flash_attention.cu'
HEAD_DIMS = (16, 32, 64, 128, 256)   # and every multiple of COL_STEP above
COL_STEP = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_CODES = {'fwd': 0, 'dq': 1, 'dkv': 2}

#: Kernel launches since the last reset, by kernel: 'fwd', 'dq', 'dkv'.
LAUNCHES = {'fwd': 0, 'dq': 0, 'dkv': 0}
#: The same launches by the CUDA kernel that ran (``kernel_name``).
KERNEL_LAUNCHES = {}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    KERNEL_LAUNCHES.clear()


def _pick_block(seq, target):
    for b in (target, 1024, 512, 256, 128, 64, 32, 16, 8):
        if b <= target and seq % b == 0 and b <= seq:
            return b
    return None


def supports(shape, block=128):
    """Whether flash_attention can run for [B, H, S, D] (S divisible
    into >=8-row blocks)."""
    s = shape[2]
    return _pick_block(s, block) is not None


# The JAX package's crossover, kept so both packages dispatch alike. It
# was measured on a TPU v5e; the H100's own crossover is not measured.
MIN_KERNEL_SEQ = 512


def preferred(shape):
    """True when the dispatch rule sends [B, H, S, D] to the kernel."""
    return shape[2] >= MIN_KERNEL_SEQ and supports(shape)


def padded_head_dim(head_dim):
    """The head dim the kernels run ``head_dim`` at: the smallest of
    ``HEAD_DIMS`` that holds it, above them the next multiple of
    ``COL_STEP`` (264 -> 320)."""
    for width in HEAD_DIMS:
        if head_dim <= width:
            return width
    return -(-head_dim // COL_STEP) * COL_STEP


def kernel_width(head_dim):
    """Whether the kernels take ``head_dim`` as it is."""
    return head_dim in HEAD_DIMS or (head_dim > HEAD_DIMS[-1] and
                                     head_dim % COL_STEP == 0)


# ---------------------------------------------------------------------------
# plain versions: materialized scores, the kernels' cast points
# ---------------------------------------------------------------------------

def _scores(q, k, causal, sm_scale):
    """Masked, scaled f32 scores [B, H, S, S] (the kernels' ``s``)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        n = s.shape[-1]
        pos = torch.arange(n, device=s.device)
        s = torch.where(pos[:, None] >= pos[None, :], s,
                        torch.full((), NEG_INF, device=s.device))
    return s


def _fwd_plain(q, k, v, causal, sm_scale):
    """(o in q's dtype, lse f32 [B, H, S, 1]); P rounded to v's dtype
    before P.V, l floored at 1e-30."""
    s = _scores(q, k, causal, sm_scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return (acc / l).to(q.dtype), m + torch.log(l)


def _dq_plain(q, k, v, do, lse, delta, causal, sm_scale):
    """dQ in q's dtype; dS rounded to k's dtype before dS.K."""
    p = torch.exp(_scores(q, k, causal, sm_scale) - lse)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta) * sm_scale
    return torch.matmul(ds.to(k.dtype).float(), k.float()).to(q.dtype)


def _dkv_plain(q, k, v, do, lse, delta, causal, sm_scale):
    """(dK, dV) in k's and v's dtypes; P rounded to dO's dtype before
    P^T.dO and dS to q's dtype before dS^T.Q."""
    p = torch.exp(_scores(q, k, causal, sm_scale) - lse)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta) * sm_scale
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    'fa_fwd': [_I, _I, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P],
    'fa_dq': [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P],
    'fa_dkv': [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P],
    'fa_wgmma_smem': [_I, _I],   # (0 fwd | 1 dQ | 2 dK/dV, head dim) -> bytes
    'fa_kernel_name': [_I, _I, _I],   # (kernel, dtype, head dim) -> name
}
_lib = None


def load_library():
    """Build (at first use) and bind the kernels' C entries."""
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_char_p if name == 'fa_kernel_name' \
                else ctypes.c_int
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def kernel_name(kernel, dtype, head_dim):
    """The CUDA kernel that the dispatch launches for ``kernel`` ('fwd',
    'dq' or 'dkv') at this dtype and kernel head dim, as
    'fwd_wgmma_kernel<bf16,256>'; None where no kernel takes it. Read
    from the library (its ``route()``), so it builds the kernels."""
    name = load_library().fa_kernel_name(_KERNEL_CODES[kernel],
                                         _DTYPE_CODES[dtype], head_dim)
    if name is None:
        return None
    return '%s<%s,%d>' % (name.decode(), 'bf16' if dtype == torch.bfloat16
                          else 'f32', head_dim)


def _check(tensors, head_dim):
    """Validate what the kernels take, before any pointer is passed."""
    ref = tensors[0]
    if ref.dtype not in _DTYPE_CODES:
        raise TypeError('flash_attention kernels take float32 or bfloat16, '
                        'got %s' % ref.dtype)
    if not kernel_width(head_dim):
        raise ValueError('flash_attention kernels take head_dim in %s or a '
                         'multiple of %d above, got %d'
                         % (HEAD_DIMS, COL_STEP, head_dim))
    for t in tensors:
        if t.device != ref.device or t.dtype != ref.dtype or \
                t.shape != ref.shape:
            raise ValueError('flash_attention: q/k/v (and dO) must share '
                             'device, dtype and shape')
    # bf16 from head dim 64 on runs TMA-fed kernels (S % 8 == 0)
    if ref.dtype == torch.bfloat16 and head_dim >= 64 and ref.shape[2] % 8:
        raise ValueError('flash_attention: bf16 at head_dim %d takes seq '
                         'a multiple of 8 (as supports() admits), got %d'
                         % (head_dim, ref.shape[2]))


def _launch(name, fn, shape, dtype, causal, *args):
    """Launch kernel ``name`` on q of ``shape`` [B, H, S, D]; count the
    launch and report its work (``kernels/work.py``)."""
    head_dim = shape[3]
    err = fn(_DTYPE_CODES[dtype], head_dim, *args)
    if err != 0:
        raise RuntimeError('%s kernel launch failed: cudaError %d'
                           % (name, err))
    LAUNCHES[name] += 1
    kernel = kernel_name(name, dtype, head_dim)
    KERNEL_LAUNCHES[kernel] = KERNEL_LAUNCHES.get(kernel, 0) + 1
    work.record(*work.attention(name, tuple(shape), dtype, causal))


def _prep(t):
    """Contiguous, 16-byte aligned (the kernels load bf16 pairs, and TMA
    takes 16-byte aligned tensors)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _fwd_cuda(q, k, v, causal, sm_scale):
    b, h, s, d = q.shape
    _check((q, k, v), d)
    q, k, v = _prep(q), _prep(k), _prep(v)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s, 1), dtype=torch.float32, device=q.device)
    lib = load_library()
    with torch.cuda.device(q.device):
        _launch('fwd', lib.fa_fwd, q.shape, q.dtype, causal, _ptr(q),
                _ptr(k), _ptr(v), _ptr(o), _ptr(lse), b * h, s,
                float(sm_scale), int(causal), _stream(q))
    return o, lse


def _check_rows(rows, q):
    """lse / delta: f32 [B, H, S, 1] on q's device, contiguous."""
    for t in rows:
        if t.dtype != torch.float32 or t.shape != q.shape[:3] + (1,) or \
                t.device != q.device or not t.is_contiguous():
            raise ValueError('flash_attention: lse and delta must be '
                             'contiguous f32 [B, H, S, 1] on q\'s device')


def _dq_cuda(q, k, v, do, lse, delta, causal, sm_scale):
    b, h, s, d = q.shape
    _check((q, k, v, do), d)
    _check_rows((lse, delta), q)
    q, k, v, do, lse, delta = (_prep(t) for t in (q, k, v, do, lse, delta))
    dq = torch.empty_like(q)
    lib = load_library()
    with torch.cuda.device(q.device):
        _launch('dq', lib.fa_dq, q.shape, q.dtype, causal, _ptr(q),
                _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta), _ptr(dq),
                b * h, s, float(sm_scale), int(causal), _stream(q))
    return dq


def _dkv_cuda(q, k, v, do, lse, delta, causal, sm_scale):
    b, h, s, d = q.shape
    _check((q, k, v, do), d)
    _check_rows((lse, delta), q)
    q, k, v, do, lse, delta = (_prep(t) for t in (q, k, v, do, lse, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = load_library()
    with torch.cuda.device(q.device):
        _launch('dkv', lib.fa_dkv, q.shape, q.dtype, causal, _ptr(q),
                _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta), _ptr(dk),
                _ptr(dv), b * h, s, float(sm_scale), int(causal), _stream(q))
    return dk, dv


def _delta(do, o):
    """rowsum(dO * O) in f32, [B, H, S, 1]: computed outside the kernels,
    as XLA computes it outside the Pallas ones."""
    return (do.float() * o.float()).sum(dim=-1, keepdim=True).contiguous()


# ---------------------------------------------------------------------------
# dispatch + autograd
# ---------------------------------------------------------------------------

def _fwd(q, k, v, causal, sm_scale):
    if q.device.type == 'cuda':
        return _fwd_cuda(q, k, v, causal, sm_scale)
    if q.device.type == 'cpu':
        return _fwd_plain(q, k, v, causal, sm_scale)
    raise ValueError('flash_attention: no path for device %s' % q.device)


def _bwd(q, k, v, o, lse, do, causal, sm_scale):
    """(dq, dk, dv): delta in torch, then dQ and dK/dV."""
    if q.device.type == 'cuda':
        dq_fn, dkv_fn = _dq_cuda, _dkv_cuda
        do = _prep(do)
    elif q.device.type == 'cpu':
        dq_fn, dkv_fn = _dq_plain, _dkv_plain
    else:
        raise ValueError('flash_attention: no path for device %s' % q.device)
    delta = _delta(do, o)
    dq = dq_fn(q, k, v, do, lse, delta, causal, sm_scale)
    return (dq,) + dkv_fn(q, k, v, do, lse, delta, causal, sm_scale)


class _FlashAttention(torch.autograd.Function):
    """Saves (q, k, v, o, lse); the backward launches dQ then dK/dV."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        o, lse = _fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, o, lse, do, ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=True, sm_scale=None):
    """Exact attention over [batch, heads, seq, head_dim] tensors.

    Differentiable (flash backward). Requires ``seq`` to split into
    uniform blocks (``supports()``), as the JAX package does; callers
    take ``local_flash_attention`` otherwise. CUDA tensors run the
    kernels, CPU tensors their plain versions; on both, a head dim the
    kernels lack (``kernel_width``) runs zero-padded to
    ``padded_head_dim``.
    """
    head_dim = q.shape[-1]
    if sm_scale is None:
        sm_scale = head_dim ** -0.5
    if not supports(q.shape):
        raise ValueError('flash_attention: seq %d not blockable; check '
                         'supports() first' % q.shape[2])
    width = padded_head_dim(head_dim)
    if width != head_dim:
        q, k, v = (F.pad(t, (0, width - head_dim)) for t in (q, k, v))
    o = _FlashAttention.apply(q, k, v, bool(causal), float(sm_scale))
    return o if width == head_dim else o[..., :head_dim]
