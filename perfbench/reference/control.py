"""The control: the reference with every matmul in float8, the nearest
precision below the bfloat16 the configurations state. Operands are
rounded to e4m3 and the gradient that reaches a matmul's output to e5m2,
each scaled per tensor by its largest magnitude (the usual fp8 training
recipe); products accumulate in float32."""
import torch

E4M3 = (torch.float8_e4m3fn, 448.0)
E5M2 = (torch.float8_e5m2, 57344.0)


def quantize(t, fmt):
    dtype, top = fmt
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return (t / scale).to(dtype).to(t.dtype) * scale


class _Operand(torch.autograd.Function):
    """e4m3 forward; the gradient passes straight through."""

    @staticmethod
    def forward(ctx, t):
        return quantize(t, E4M3)

    @staticmethod
    def backward(ctx, g):
        return g


class _OutputGrad(torch.autograd.Function):
    """Identity forward; the gradient arriving at a product is rounded
    to e5m2."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return quantize(g, E5M2)


def fp8_mm(a, b):
    return _OutputGrad.apply(torch.matmul(_Operand.apply(a),
                                          _Operand.apply(b)))
