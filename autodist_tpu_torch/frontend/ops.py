"""Lifted numeric ops for the symbolic frontend.

The counterpart of ``autodist_tpu/frontend/ops.py``, as torch
functions. Any torch function can be lifted with :func:`lift`; the
common ones used by the reference's example models are exported
directly, with the JAX package's semantics (``reduce_mean`` of integers
is a float mean, ``one_hot`` of an out-of-range id is a zero row,
NHWC/HWIO convolutions with XLA's ``'SAME'`` padding, TF's ``SAME``
average pool over the valid cells).

``embedding_lookup`` additionally marks its table Variable as
``sparse_read`` and records its id tensors and lookup nodes — what the
strategy builders and the sparse (ids, rows) gradient path key on.
"""
import numpy as np
import torch
import torch.nn.functional as F

from autodist_tpu_torch.frontend import graph as fe
from autodist_tpu_torch.models.vision import (_conv_nhwc, _nchw, _nhwc,
                                              _pad_nhwc, _pads)


def lift(fn):
    """Lift a function of torch tensors to operate on SymTensors."""
    def lifted(*args, **kwargs):
        return fe.Op(fn, list(args), kwargs)
    lifted.__name__ = getattr(fn, '__name__', 'lifted')
    return lifted


def _sym(fn, *args, **kwargs):
    return fe.Op(fn, list(args), kwargs)


def torch_dtype(dtype):
    """The torch dtype of a numpy (or torch) dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def constant(value, name=None):
    return fe.Const(value, name=name)


# Elementwise / reductions -------------------------------------------------
def square(x):
    return _sym(torch.square, x)


def sqrt(x):
    return _sym(torch.sqrt, x)


def exp(x):
    return _sym(torch.exp, x)


def log(x):
    return _sym(torch.log, x)


def tanh(x):
    return _sym(torch.tanh, x)


def sigmoid(x):
    return _sym(torch.sigmoid, x)


def relu(x):
    return _sym(torch.relu, x)


def softmax(x, axis=-1):
    return _sym(lambda v: torch.softmax(v, dim=axis), x)


def abs(x):  # noqa: A001 - mirrors tf.abs
    return _sym(torch.abs, x)


def _float(v):
    return v if v.is_floating_point() else v.to(torch.float32)


def reduce_mean(x, axis=None):
    return _sym(lambda v: _float(v).mean() if axis is None
                else _float(v).mean(dim=axis), x)


def reduce_sum(x, axis=None):
    return _sym(lambda v: v.sum() if axis is None else v.sum(dim=axis), x)


def reduce_max(x, axis=None):
    return _sym(lambda v: v.max() if axis is None else v.amax(dim=axis), x)


def argmax(x, axis=-1):
    return _sym(lambda v: torch.argmax(v, dim=axis), x)


def cast(x, dtype):
    return _sym(lambda v: v.to(torch_dtype(dtype)), x)


def reshape(x, shape):
    return _sym(lambda v: v.reshape(tuple(shape)), x)


def transpose(x, axes=None):
    def fn(v):
        return v.permute(*(reversed(range(v.dim())) if axes is None
                           else axes))
    return _sym(fn, x)


def concat(xs, axis=0):
    return fe.Op(lambda *vs: torch.cat(vs, dim=axis), list(xs))


def stack(xs, axis=0):
    return fe.Op(lambda *vs: torch.stack(vs, dim=axis), list(xs))


def matmul(a, b):
    return _sym(torch.matmul, a, b)


def one_hot(x, depth):
    def fn(v):
        return (v[..., None] == torch.arange(depth, device=v.device)).to(
            torch.float32)
    return _sym(fn, x)


def squeeze(x, axis=None):
    return _sym(lambda v: v.squeeze() if axis is None else v.squeeze(axis),
                x)


def expand_dims(x, axis):
    return _sym(lambda v: v.unsqueeze(axis), x)


# Losses -------------------------------------------------------------------
def sigmoid_cross_entropy_with_logits(labels, logits):
    def fn(labels, logits):
        return torch.clamp_min(logits, 0) - logits * labels + \
            torch.log1p(torch.exp(-torch.abs(logits)))
    return _sym(fn, labels, logits)


def sparse_softmax_cross_entropy_with_logits(labels, logits):
    def fn(labels, logits):
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.take_along_dim(
            logp, labels[..., None].long(), dim=-1)[..., 0]
    return _sym(fn, labels, logits)


def softmax_cross_entropy_with_logits(labels, logits):
    def fn(labels, logits):
        return -(labels * torch.log_softmax(logits, dim=-1)).sum(dim=-1)
    return _sym(fn, labels, logits)


# Embeddings ---------------------------------------------------------------
def _take(p, i, axis):
    """``jnp.take(p, i, axis)``: index ``axis`` of ``p`` by ``i``."""
    i = i.long()
    if axis == 0 and p.dim() == 2:
        return F.embedding(i, p)
    out = p.index_select(axis, i.reshape(-1))
    return out.reshape(p.shape[:axis] + i.shape + p.shape[axis + 1:])


def gather(params, indices, axis=0):
    """Index gather; marks a Variable source as sparse-read so strategy
    builders can treat its gradient as sparse (reference: IndexedSlices
    through ``embedding_lookup_v2``)."""
    node = _sym(lambda p, i: _take(p, i, axis), params, indices)
    if isinstance(params, fe.Variable):
        params.sparse_read = True
        if axis == 0 and isinstance(indices, fe.SymTensor):
            params.lookup_ids.append(indices)
            params.lookup_ops.append(node)
    return node


def embedding_lookup(params, ids):
    """Row gather from an embedding table Variable."""
    return gather(params, ids, axis=0)


# Convolutions / pooling ---------------------------------------------------
def conv2d(x, filters, strides=1, padding='SAME'):
    """NHWC conv with HWIO filters and XLA's padding (asymmetric
    ``'SAME'`` where XLA's is), as :mod:`models.vision` computes it."""
    s = (strides, strides) if isinstance(strides, int) else tuple(strides)
    return _sym(lambda x, w: _conv_nhwc(x, w, s, padding), x, filters)


def bias_add(x, b):
    return _sym(lambda x, b: x + b, x, b)


def _pool_dims(size, strides):
    k = (size, size) if isinstance(size, int) else tuple(size)
    s = k if strides is None else (
        (strides, strides) if isinstance(strides, int) else tuple(strides))
    return k, s


def max_pool(x, size=2, strides=None, padding='VALID'):
    k, s = _pool_dims(size, strides)

    def fn(x):
        pads = _pads(x.shape[1:3], k, s, padding)
        x = _pad_nhwc(x, pads, value=float('-inf'))
        return _nhwc(F.max_pool2d(_nchw(x), k, s))
    return _sym(fn, x)


def avg_pool(x, size=2, strides=None, padding='VALID'):
    k, s = _pool_dims(size, strides)

    def fn(x):
        pads = _pads(x.shape[1:3], k, s, padding)
        summed = F.avg_pool2d(_nchw(_pad_nhwc(x, pads)), k, s,
                              divisor_override=1)
        if padding == 'VALID':
            return _nhwc(summed / (k[0] * k[1]))
        # SAME: TF semantics divide by the count of VALID cells in each
        # window (padded cells excluded), not the full window size
        ones = torch.ones_like(x[:1, :, :, :1])
        counts = F.avg_pool2d(_nchw(_pad_nhwc(ones, pads)), k, s,
                              divisor_override=1)
        return _nhwc(summed / counts)
    return _sym(fn, x)


# Control flow -------------------------------------------------------------
def while_loop(cond_fn, body_fn, init, max_iters=None):
    """A loop over symbolic carries; ``cond_fn``/``body_fn`` are torch
    functions of the carry tuple.

    With ``max_iters`` (a static trip bound) it runs at most that many
    iterations, each gated by ``cond_fn`` — the JAX package's bounded,
    reverse-differentiable form (case c4). Without it the loop is
    forward-only, as ``lax.while_loop`` is: it refuses to run where a
    gradient would have to flow through it."""
    if max_iters is None:
        def fn(*vals):
            if torch.is_grad_enabled() and any(
                    torch.is_tensor(v) and v.requires_grad for v in vals):
                raise ValueError(
                    'while_loop without max_iters is forward-only; pass '
                    'max_iters to differentiate through it')
            vals = tuple(vals)
            while bool(cond_fn(vals)):
                vals = tuple(body_fn(vals))
            return vals
        return fe.Op(fn, list(init))

    def fn(*vals):
        vals = tuple(vals)
        for _ in range(int(max_iters)):
            if not bool(cond_fn(vals)):
                break
            vals = tuple(body_fn(vals))
        return vals
    return fe.Op(fn, list(init))


def cond(pred, true_fn, false_fn, operands):
    def fn(p, *vals):
        return true_fn(*vals) if bool(p) else false_fn(*vals)
    return fe.Op(fn, [pred] + list(operands))


def scan(body_fn, init, xs):
    """``lax.scan``: ``body_fn(carry, x) -> (carry, y)`` over the
    leading axis of ``xs``; returns ``(carry, stacked ys)``."""
    def fn(c, x):
        ys = []
        for t in range(x.shape[0]):
            c, y = body_fn(c, x[t])
            ys.append(y)
        if not ys or ys[0] is None:
            return c, None
        if isinstance(ys[0], (tuple, list)):
            return c, type(ys[0])(torch.stack(parts) for parts in zip(*ys))
        return c, torch.stack(ys)
    return _sym(fn, init, xs)
