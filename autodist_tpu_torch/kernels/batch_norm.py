"""Training BatchNorm with hand-written backward passes, for the port.

The counterpart of ``autodist_tpu/kernels/batch_norm.py``, which is XLA
code (a ``jax.custom_vjp`` over one variadic reduce), not a Pallas
kernel; its port is PyTorch ops, as two ``torch.autograd.Function``s:

- :func:`moments`: ``(E[x], E[x^2])`` over all but the channel (last)
  axis, f32 sums; backward ``dx = (d1 + 2 x d2) / n``.
- :func:`batch_norm_train`: ``(y, mean, var)`` over the leading axes of
  NHWC ``x``, var clamped at 0; the backward takes one pass for
  ``(sum dy, sum dy * x)``, recovers ``d_gamma`` and ``d_beta`` from
  them, and folds ``dx`` to ``k1 * dy + k2 * x + k3`` with per-channel
  ``k``. The cotangents of mean and var are ignored: they feed the
  running statistics, which are not part of the loss.

y and dx are in x's dtype and the saved tensor is x itself; the
``[C]`` vectors are f32 (the sums cast x to f32 as they read it, which
in eager PyTorch is an f32 copy of x for the length of the reduction).
No model calls these functions: the port's ``vision.BatchNorm`` keeps
its own formulation, as the JAX package's models keep theirs.
"""
import torch


def _rows(x):
    return x.reshape(-1, x.shape[-1])


def _sums(a, b=None):
    """Per-channel f32 (sum a, sum a * b) over every row (b defaults to
    a)."""
    af = _rows(a).float()
    bf = af if b is None else _rows(b).float()
    return af.sum(0), (af * bf).sum(0)


class _Moments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        n = x.numel() // x.shape[-1]
        s1, s2 = _sums(x)
        return s1 / n, s2 / n

    @staticmethod
    def backward(ctx, d1, d2):
        x, = ctx.saved_tensors
        n = x.numel() // x.shape[-1]
        dt = x.dtype
        dx = torch.zeros_like(x)
        if d1 is not None:
            dx = dx + (d1 / n).to(dt)
        if d2 is not None:
            dx = dx + x * (2.0 * d2 / n).to(dt)
        return dx


def moments(x):
    """Differentiable batch moments ``(E[x], E[x^2])`` in f32 over all but
    the channel axis."""
    return _Moments.apply(x)


class _BatchNormTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        n = x.numel() // x.shape[-1]
        s1, s2 = _sums(x)
        mean = s1 / n
        var = torch.clamp(s2 / n - mean * mean, min=0.0)
        a = scale * torch.rsqrt(var + eps)
        b = bias - mean * a
        dt = x.dtype
        y = x * a.to(dt) + b.to(dt)
        ctx.eps = eps
        ctx.save_for_backward(x, scale, mean, var)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, scale, mean, var = ctx.saved_tensors
        n = x.numel() // x.shape[-1]
        inv = torch.rsqrt(var + ctx.eps)
        sdy, sdyx = _sums(dy, x)
        db = sdy
        # d_gamma = sum dy * xhat = (sum dy * x - mean * sum dy) * inv
        dg = (sdyx - mean * sdy) * inv
        # dx = gamma * inv * (dy - (db + xhat * dg) / n), folded to one
        # multiply-add in x with per-channel k's
        g_inv = scale * inv
        k2 = -g_inv * dg * inv / n
        k3 = -g_inv * (db - dg * inv * mean) / n
        dt = x.dtype
        dx = dy * g_inv.to(dt) + x * k2.to(dt) + k3.to(dt)
        return dx, dg.to(scale.dtype), db.to(scale.dtype), None


def batch_norm_train(x, scale, bias, eps):
    """Training-mode BatchNorm over the leading axes of NHWC ``x``:
    ``(y, mean, var)``, y in x's dtype, batch statistics in f32."""
    return _BatchNormTrain.apply(x, scale, bias, eps)
