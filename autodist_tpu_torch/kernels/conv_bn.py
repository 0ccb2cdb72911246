"""Fused pointwise conv + BatchNorm through a hand-written Hopper kernel.

The counterpart of ``autodist_tpu/kernels/conv_bn.py``. A 1x1 conv is the
product ``[N, Cin] x [Cin, Cout]`` of the NHWC activations (flattened
after the stride subsample) with the kernel; the Pallas kernel there
(``_kernel``, launched by ``_fwd_call``) rides two BatchNorm passes on
that product:

- **prologue**: the previous BatchNorm's normalize + affine (+ ReLU),
  ``relu?(x * a + b)`` per input channel in f32, cast back to x's dtype,
  applied to each input tile on its way into the product;
- **epilogue**: the next BatchNorm's moment sums, s1 = sum_rows acc and
  s2 = sum_rows acc^2 per output channel, in f32 from the f32
  accumulator (not from y after rounding); zeros when
  ``want_stats=False``.

Here that kernel is CUDA C++ in ``kernels/csrc/conv_bn.cu`` (built for
``sm_90a`` at first use by :mod:`autodist_tpu_torch.kernels.build`): bf16
runs a TMA-fed, mbarrier-pipelined wgmma kernel, f32 a CUDA-core one.
Each CTA owns a 128-row output tile and loops over Cin, so the stats come
out per row tile and a second small pass sums them in a fixed order (no
atomics; deterministic). W goes in as it lies, [Cin, Cout], cast to x's
dtype. The source says what bounds it and what the design does about
that.

``supports``, ``_pick_block_n`` and ``_pick_block_cout`` keep the JAX
rule exactly, so the same shapes take the fused branch in both packages;
the CUDA tile is the kernel's own. The backward is plain PyTorch, as the
JAX package's is plain XLA (``_fused_bwd``), with its cast points.

Beside the kernel lives its plain PyTorch version (``_fwd_plain``) with
the same cast points: a tensor on the CPU goes to it; a CUDA tensor
launches the kernel or raises. ``LAUNCHES['conv_bn']`` counts kernel
launches.
"""
import ctypes

import torch

from autodist_tpu_torch.kernels import build, work

SOURCE = 'conv_bn.cu'
ROW_TILE = 128     # rows of the CUDA kernels' output tile (csrc BM)
COUT_TILE = 128    # Cout must be a multiple of this (csrc BN)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches since the last reset.
LAUNCHES = {'conv_bn': 0}


def reset_launches():
    LAUNCHES['conv_bn'] = 0


def supports(n_rows, c_in, c_out, block_n=None):
    """Whether the fused kernel serves [N, Cin] x [Cin, Cout]: the JAX
    package's rule (Cin % 8 == 0, Cout % 128 == 0, N divisible into a
    row block of 512 ... 8), kept for dispatch parity."""
    bn = block_n or _pick_block_n(n_rows)
    return c_in % 8 == 0 and c_out % 128 == 0 and bn is not None


def _pick_block_n(n_rows):
    for b in (512, 256, 128, 64, 32, 16, 8):
        if n_rows % b == 0 and b <= n_rows:
            return b
    return None


def _pick_block_cout(c_out):
    for b in (512, 256, 128):
        if c_out % b == 0 and b <= c_out:
            return b
    return c_out


# ---------------------------------------------------------------------------
# the plain version: the kernel's cast points
# ---------------------------------------------------------------------------

def _fwd_plain(x2d, w, a, b, relu, want_stats, out_dtype):
    """(y in out_dtype, s1, s2 f32 [Cout]). The prologue runs in f32 and
    rounds to x's dtype; the product of that and W (cast to x's dtype)
    is taken in f32; s1/s2 come from the f32 product."""
    xn = x2d
    if a is not None:
        xn = x2d.float() * a.float() + b.float()
        if relu:
            xn = torch.clamp_min(xn, 0.0)
        xn = xn.to(x2d.dtype)
    acc = xn.float() @ w.to(x2d.dtype).float()
    if want_stats:
        s1, s2 = acc.sum(0), (acc * acc).sum(0)
    else:
        s1 = s2 = torch.zeros(w.shape[1], dtype=torch.float32,
                              device=x2d.device)
    return acc.to(out_dtype), s1, s2


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    'cb_fwd': [_I, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _I, _I,
               _P],
    'cb_block_n': [_I],      # Cout -> output channels of the bf16 tile
    'cb_wgmma_smem': [_I],   # Cout -> bf16 kernel's dynamic shared bytes
}
_lib = None


def load_library():
    """Build (at first use) and bind the kernel's C entries."""
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _prep(t):
    """Contiguous, 16-byte aligned (TMA and the 16-byte loads need it)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _fwd_cuda(x2d, w, a, b, relu, want_stats, out_dtype):
    n, c_in = x2d.shape
    c_out = w.shape[1]
    if x2d.dtype not in _DTYPE_CODES or out_dtype not in _DTYPE_CODES:
        raise TypeError('conv_bn kernel takes float32 or bfloat16, got %s '
                        '-> %s' % (x2d.dtype, out_dtype))
    if c_in % 8 or c_out % COUT_TILE or w.shape[0] != c_in:
        raise ValueError('conv_bn kernel takes x [N, Cin] and w [Cin, Cout] '
                         'with Cin %% 8 == 0 and Cout %% %d == 0, got x %s '
                         'and w %s'
                         % (COUT_TILE, tuple(x2d.shape), tuple(w.shape)))
    for t in (w, a, b):
        if t is not None and t.device != x2d.device:
            raise ValueError('conv_bn: every input must be on %s'
                             % x2d.device)
    dev = x2d.device
    x2d = _prep(x2d)
    w = _prep(w.to(x2d.dtype))               # [Cin, Cout], as it lies
    if a is not None:
        a = _prep(a.reshape(c_in).float())
        b = _prep(b.reshape(c_in).float())
    y = torch.empty((n, c_out), dtype=out_dtype, device=dev)
    tiles = -(-n // ROW_TILE)
    if want_stats:
        part = torch.empty((2, tiles, c_out), dtype=torch.float32, device=dev)
        s = torch.empty((2, c_out), dtype=torch.float32, device=dev)
    else:
        part = None
        s = torch.zeros((2, c_out), dtype=torch.float32, device=dev)
    if n == 0:
        return y, s[0], s[1]
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.cb_fwd(
            _DTYPE_CODES[x2d.dtype], _DTYPE_CODES[out_dtype], _ptr(x2d),
            _ptr(w), _ptr(a), _ptr(b), int(a is not None), int(relu),
            int(want_stats), _ptr(y), _ptr(part), _ptr(s), n, c_in, c_out,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError('conv_bn kernel launch failed: cudaError %d' % err)
    LAUNCHES['conv_bn'] += 1
    work.record(*work.conv_bn(n, c_in, c_out, x2d.dtype, a is not None,
                              want_stats))
    return y, s[0], s[1]


def _fwd(x2d, w, a, b, relu, want_stats, out_dtype):
    if x2d.device.type == 'cuda':
        return _fwd_cuda(x2d, w, a, b, relu, want_stats, out_dtype)
    if x2d.device.type == 'cpu':
        return _fwd_plain(x2d, w, a, b, relu, want_stats, out_dtype)
    raise ValueError('conv_bn: no path for device %s' % x2d.device)


# ---------------------------------------------------------------------------
# autograd: the JAX package's _fused_bwd, in plain PyTorch
# ---------------------------------------------------------------------------

def _mm(a, b, out_dtype):
    """a @ b with f32 sums, rounded once to ``out_dtype`` (the vjp's
    ``preferred_element_type=f32`` products). cuBLAS sums bf16 products
    in f32; ``out_dtype=f32`` keeps that sum unrounded."""
    if a.device.type == 'cuda':
        if a.dtype == out_dtype:
            return torch.mm(a, b)
        return torch.mm(a, b, out_dtype=out_dtype)
    return torch.mm(a.float(), b.float()).to(out_dtype)


class _FusedPointwise(torch.autograd.Function):
    """Outputs (y, s1, s2). Backward: dY = dy + ds1 + 2 y ds2 in the
    activation dtype, xn recomputed with a and b cast to that dtype,
    dW = xn^T dY in f32, dxn = dY W^T rounded to the activation dtype,
    then the ReLU mask and da = sum dxn x, db = sum dxn in f32."""

    @staticmethod
    def forward(ctx, x2d, w, a, b, relu, want_stats, out_dtype):
        y, s1, s2 = _fwd(x2d, w, a, b, relu, want_stats, out_dtype)
        ctx.save_for_backward(x2d, w, a, b, y if want_stats else None)
        ctx.relu, ctx.want_stats = relu, want_stats
        if not want_stats:
            ctx.mark_non_differentiable(s1, s2)
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, ds1, ds2):
        x2d, w, a, b, y = ctx.saved_tensors
        cdt = x2d.dtype
        d_y = dy.to(cdt)
        if ctx.want_stats:
            d_y = d_y + ds1.to(cdt)[None, :] + \
                y.to(cdt) * (2.0 * ds2).to(cdt)[None, :]
        if a is not None:
            av = a.reshape(1, -1).to(cdt)
            bv = b.reshape(1, -1).to(cdt)
            xn = x2d * av + bv
            if ctx.relu:
                xn = torch.clamp_min(xn, 0)
        else:
            xn = x2d
        dw = _mm(xn.t(), d_y, torch.float32)
        dxn = _mm(d_y, w.to(cdt).t(), cdt)
        da = db = None
        if a is not None:
            if ctx.relu:
                dxn = torch.where(xn > 0, dxn, torch.zeros_like(dxn))
            dx = dxn * av
            dxf = dxn.float()
            da = (dxf * x2d.float()).sum(0).reshape(a.shape).to(a.dtype)
            db = dxf.sum(0).reshape(b.shape).to(b.dtype)
        else:
            dx = dxn
        return dx, dw.to(w.dtype), da, db, None, None, None


def fused_pointwise(x, w, scale=None, bias=None, prologue_relu=False,
                    want_stats=True, out_dtype=None, stride=1):
    """Fused 1x1 conv (+ BN prologue/epilogue) on NHWC input.

    Args:
        x: [B, H, W, Cin] activations.
        w: [Cin, Cout] pointwise kernel (a [1, 1, Cin, Cout] HWIO conv
            kernel reshaped); cast to x's dtype for the product.
        scale, bias: optional per-Cin f32 ``relu?(x * scale + bias)``
            applied to ``x`` on the way into the product (the PREVIOUS
            BatchNorm's folded coefficients); ``prologue_relu`` adds the
            ReLU.
        want_stats: also return (sum y, sum y^2) per output channel from
            the f32 accumulator (the NEXT BatchNorm's moments).
        out_dtype: dtype of y (defaults to x's).
        stride: 1x1 conv stride (spatial subsample before the product).

    Returns:
        ``(y [B, H', W', Cout], s1 [Cout], s2 [Cout])``; s1/s2 are zeros
        when ``want_stats=False``.
    """
    if stride != 1:
        x = x[:, ::stride, ::stride, :]
    batch, hh, ww, c_in = x.shape
    n = batch * hh * ww
    out_dtype = out_dtype or x.dtype
    y, s1, s2 = _FusedPointwise.apply(
        x.reshape(n, c_in), w, scale, None if scale is None else bias,
        bool(prologue_relu), bool(want_stats), out_dtype)
    return y.reshape(batch, hh, ww, w.shape[1]), s1, s2
