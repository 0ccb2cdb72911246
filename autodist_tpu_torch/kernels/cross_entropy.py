"""Token cross-entropy of the LM head through a hand-written kernel pair.

``token_nll(logits, targets)`` is ``logsumexp(logits) - logits[target]``
over the last dim, in f32, from logits in their own dtype (the head's
bf16). On the card the forward reads the logits once and the backward
reads them once and writes the gradient once, in the logits' dtype; no
f32 copy of the logits is made. The plain version is the f32
``logsumexp - gather``.

Two custom operators (``torch.library``), each a CUDA kernel in
``kernels/csrc/cross_entropy.cu`` (built for ``sm_90a`` at first use by
:mod:`autodist_tpu_torch.kernels.build`) and a plain version for every
other device:

- ``autodist_tpu_torch::xent_fwd(logits [R, V], targets [R])`` ->
  ``(nll, lse)``, both f32 [R];
- ``autodist_tpu_torch::xent_bwd(logits, targets, lse, g)`` -> the
  gradient ``g_r (exp(x_rj - lse_r) - onehot_rj)``, computed in f32 and
  rounded once to the logits' dtype; ``g`` is dL/dnll per row, so a mask
  or a mean's count reaches it.

``xent_fwd``'s autograd rule saves the logits, the targets and the lse
(not differentiable) and calls ``xent_bwd``. The rule is the input's
device: a CUDA tensor takes the kernels, any other the plain version.

The kernels take f32 or bf16 logits at any row stride of at least V
with unit column stride (a padded head's rows, with no copy); other
layouts are copied first. The gradient comes back with the logits' row
stride. A target outside ``[0, V)`` gives a NaN NLL (the plain version
raises, as ``gather`` does).

``LAUNCHES`` counts kernel launches ('fwd', 'bwd') and calls of the
plain versions ('plain', forward and backward alike). A launch reports
no work to :mod:`~autodist_tpu_torch.kernels.work`'s counters beyond
itself: the operators are dispatcher calls, so a byte counter over the
dispatcher sees their operands already, and their few operations an
element are no FLOP that the counters count.
"""
import ctypes

import torch

from autodist_tpu_torch.kernels import build, work

SOURCE = 'cross_entropy.cu'
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches ('fwd', 'bwd') and plain calls ('plain') since the
#: last reset.
LAUNCHES = {'fwd': 0, 'bwd': 0, 'plain': 0}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _as_lies(logits):
    """Whether the kernels read ``logits`` [R, V] as they lie: unit column
    stride, rows at least V apart."""
    return logits.stride(1) == 1 and logits.stride(0) >= logits.shape[1]


def _row_stride(logits):
    """The row stride the kernels read ``logits`` at: its own where they
    take the rows as they lie, else V (a contiguous copy)."""
    return logits.stride(0) if _as_lies(logits) else logits.shape[1]


# ---------------------------------------------------------------------------
# plain versions: the f32 arithmetic the kernels are held to
# ---------------------------------------------------------------------------

def _fwd_plain(logits, targets):
    """(nll, lse) f32 [R]: ``logsumexp`` and ``gather`` on f32 logits."""
    x = logits.float()
    lse = torch.logsumexp(x, dim=-1)
    gold = torch.gather(x, -1, targets.long()[:, None])[:, 0]
    return lse - gold, lse


def _bwd_plain(logits, targets, lse, g):
    """The gradient as autograd gives it through f32 ``logsumexp`` and
    ``gather``: ``g exp(x - lse)`` plus ``-g`` at the target, summed in
    f32 and rounded to the logits' dtype; laid out with the logits' row
    stride."""
    g = g.float()
    d = g[:, None] * torch.exp(logits.float() - lse[:, None])
    d = d + torch.zeros_like(d).scatter_add_(-1, targets.long()[:, None],
                                             -g[:, None])
    d = d.to(logits.dtype)
    st = _row_stride(logits)
    if st == d.shape[1]:
        return d
    return torch.empty_strided(d.shape, (st, 1), dtype=d.dtype,
                               device=d.device).copy_(d)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    'xent_fwd': [_I, _P, _L, _P, _I, _I, _P, _P, _P],
    'xent_bwd': [_I, _P, _L, _P, _P, _P, _P, _I, _I, _P],
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
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _rows(logits, targets, *rows):
    """Check what the kernels take; return the logits as they read them
    (a contiguous copy unless ``_as_lies``), their row stride, and the
    targets and every per-row input made contiguous: int64 and f32 [R]."""
    if logits.dtype not in _DTYPE_CODES:
        raise TypeError('cross-entropy kernels take float32 or bfloat16 '
                        'logits, got %s' % logits.dtype)
    r = logits.shape[0]
    for t in (targets,) + rows:
        if t.device != logits.device or t.shape != (r,):
            raise ValueError('cross-entropy: targets and per-row inputs '
                             'must be [%d] on %s' % (r, logits.device))
    x = logits if _as_lies(logits) else logits.contiguous()
    return (x, x.stride(0), targets.long().contiguous()) + tuple(
        t.float().contiguous() for t in rows)


def _launch(name, fn, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError('%s kernel launch failed: cudaError %d'
                           % (name, err))
    LAUNCHES[name] += 1
    work.record(0, 0)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _fwd_cuda(logits, targets):
    x, st, tgt = _rows(logits, targets)
    r, v = x.shape
    nll = torch.empty(r, dtype=torch.float32, device=x.device)
    lse = torch.empty_like(nll)
    with torch.cuda.device(x.device):
        _launch('fwd', load_library().xent_fwd, _DTYPE_CODES[x.dtype],
                _ptr(x), st, _ptr(tgt), r, v, _ptr(nll), _ptr(lse),
                _stream(x))
    return nll, lse


def _empty_rows(x, st):
    """An empty [R, V] laid out as ``x``: row stride ``st``, its address
    the same as ``x``'s modulo 16, so the kernel's 16-byte stores split
    each row where its loads do."""
    r, v = x.shape
    per = 16 // x.element_size()
    buf = torch.empty((r - 1) * st + v + per, dtype=x.dtype, device=x.device)
    off = (x.data_ptr() - buf.data_ptr()) % 16 // x.element_size()
    return buf.as_strided((r, v), (st, 1), off)


def _bwd_cuda(logits, targets, lse, g):
    x, st, tgt, lse, g = _rows(logits, targets, lse, g)
    r, v = x.shape
    if r == 0:
        return torch.empty_strided((0, v), (st, 1), dtype=x.dtype,
                                   device=x.device)
    dx = _empty_rows(x, st)
    with torch.cuda.device(x.device):
        _launch('bwd', load_library().xent_bwd, _DTYPE_CODES[x.dtype],
                _ptr(x), st, _ptr(tgt), _ptr(lse), _ptr(g), _ptr(dx), r, v,
                _stream(x))
    return dx


# ---------------------------------------------------------------------------
# the operators, their autograd rule and the entry
# ---------------------------------------------------------------------------

@torch.library.custom_op('autodist_tpu_torch::xent_fwd', mutates_args=())
def xent_fwd(logits: torch.Tensor, targets: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(nll, lse) f32 [R] of logits [R, V] against targets [R]: the kernel
    on the card (registered below), the plain version elsewhere."""
    LAUNCHES['plain'] += 1
    return _fwd_plain(logits, targets)


xent_fwd.register_kernel('cuda', _fwd_cuda)


@xent_fwd.register_fake
def _xent_fwd_fake(logits, targets):
    r = logits.shape[0]
    return (logits.new_empty((r,), dtype=torch.float32),
            logits.new_empty((r,), dtype=torch.float32))


@torch.library.custom_op('autodist_tpu_torch::xent_bwd', mutates_args=())
def xent_bwd(logits: torch.Tensor, targets: torch.Tensor, lse: torch.Tensor,
             g: torch.Tensor) -> torch.Tensor:
    """The gradient of ``xent_fwd``'s nll for dL/dnll ``g`` [R], in the
    logits' dtype and row stride: the kernel on the card, the plain
    version elsewhere."""
    LAUNCHES['plain'] += 1
    return _bwd_plain(logits, targets, lse, g)


xent_bwd.register_kernel('cuda', _bwd_cuda)


@xent_bwd.register_fake
def _xent_bwd_fake(logits, targets, lse, g):
    return logits.new_empty_strided(tuple(logits.shape),
                                    (_row_stride(logits), 1))


def _setup_context(ctx, inputs, output):
    logits, targets = inputs
    ctx.save_for_backward(logits, targets, output[1])
    ctx.mark_non_differentiable(output[1])


def _backward(ctx, g_nll, g_lse):
    logits, targets, lse = ctx.saved_tensors
    return xent_bwd(logits, targets, lse, g_nll), None


xent_fwd.register_autograd(_backward, setup_context=_setup_context)


def token_nll(logits, targets):
    """``logsumexp(logits) - logits[target]`` over the last dim, f32 of
    ``targets``' shape; differentiable in ``logits``."""
    v = logits.shape[-1]
    nll, _ = xent_fwd(logits.reshape(-1, v), targets.reshape(-1))
    return nll.reshape(targets.shape)
