"""The port's fused pointwise conv + BatchNorm against the JAX package's.

On the CPU the port's ``fused_pointwise`` runs the kernel's plain
version; the JAX one runs the Pallas kernel in interpret mode, with its
custom vjp. Inputs come from numpy with a seed.

Tolerances. f32: products summed in another order, 1e-5 relative (y,
gradients); the moment sums s1/s2 add 128 rows of such products, 1e-5
of the largest |s|. bf16: y is rounded to bf16 from f32 sums taken in
another order, so it may differ by one bf16 ulp (2^-7 relative, 1e-2
with margin); s1/s2 still come from the f32 accumulator (1e-5). bf16
gradients: dY and the recomputed xn are rounded to bf16 in both
packages, but XLA may keep a fused elementwise chain in f32 and round
once where PyTorch rounds after each op, so a bf16 intermediate may sit
one ulp apart and the products built on it move by about that: 2e-2
of the largest |gradient|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu.kernels import conv_bn as jcb
from autodist_tpu_torch.kernels import conv_bn as cb

B, H, W, CIN, COUT = 2, 8, 8, 16, 128


def _inputs(seed, dtype):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, W, CIN).astype(np.float32)
    w = (rng.randn(CIN, COUT) / np.sqrt(CIN)).astype(np.float32)
    a = (rng.rand(CIN) + 0.5).astype(np.float32)
    b = rng.randn(CIN).astype(np.float32)
    return x, w, a, b


def _jax_x(x, dtype):
    return jnp.asarray(x, dtype=jnp.bfloat16 if dtype == 'bfloat16'
                       else jnp.float32)


def _torch_x(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _prologue(kind, a, b):
    """(scale, bias, relu) for a prologue kind."""
    if kind is None:
        return None, None, False
    return a, b, kind == 'relu'


def _close(got, want, rel):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize('stride', [1, 2])
@pytest.mark.parametrize('prologue', [None, 'affine', 'relu'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_forward_matches_jax(dtype, prologue, stride):
    x, w, a, b = _inputs(0, dtype)
    sa, sb, relu = _prologue(prologue, a, b)
    jy, js1, js2 = jcb.fused_pointwise(
        _jax_x(x, dtype), jnp.asarray(w),
        None if sa is None else jnp.asarray(sa),
        None if sb is None else jnp.asarray(sb), prologue_relu=relu,
        stride=stride, interpret=True)
    y, s1, s2 = cb.fused_pointwise(
        _torch_x(x, dtype), torch.from_numpy(w),
        None if sa is None else torch.from_numpy(sa),
        None if sb is None else torch.from_numpy(sb), prologue_relu=relu,
        stride=stride)
    assert tuple(y.shape) == jy.shape and y.dtype == getattr(torch, dtype)
    y_tol = 1e-5 if dtype == 'float32' else 1e-2
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy, np.float32), rtol=y_tol,
                               atol=y_tol * float(np.abs(
                                   np.asarray(jy, np.float32)).max()))
    _close(s1.numpy(), js1, 1e-5)
    _close(s2.numpy(), js2, 1e-5)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_want_stats_false_gives_zeros(dtype):
    x, w, a, b = _inputs(1, dtype)
    jy, js1, js2 = jcb.fused_pointwise(
        _jax_x(x, dtype), jnp.asarray(w), jnp.asarray(a), jnp.asarray(b),
        prologue_relu=True, want_stats=False, interpret=True)
    y, s1, s2 = cb.fused_pointwise(
        _torch_x(x, dtype), torch.from_numpy(w), torch.from_numpy(a),
        torch.from_numpy(b), prologue_relu=True, want_stats=False)
    assert not np.asarray(js1).any() and not np.asarray(js2).any()
    assert not s1.any() and not s2.any()
    assert s1.shape == (COUT,) and s1.dtype == torch.float32
    y_tol = 1e-5 if dtype == 'float32' else 1e-2
    _close(y.float().numpy(), jy, y_tol)


def test_out_dtype_f32_from_bf16_input():
    x, w, _, _ = _inputs(2, 'bfloat16')
    jy, js1, _ = jcb.fused_pointwise(_jax_x(x, 'bfloat16'), jnp.asarray(w),
                                     out_dtype=jnp.float32, interpret=True)
    y, s1, _ = cb.fused_pointwise(_torch_x(x, 'bfloat16'),
                                  torch.from_numpy(w),
                                  out_dtype=torch.float32)
    assert y.dtype == torch.float32
    _close(y.numpy(), jy, 1e-5)
    _close(s1.numpy(), js1, 1e-5)


def test_supports_matches_jax_over_a_grid():
    for rows in (8, 17, 24, 40, 128, 200, 512, 1000, 12544, 50176, 802816):
        for c_in in (3, 8, 24, 64, 92, 96, 2048):
            for c_out in (64, 128, 200, 256, 384, 2048):
                assert cb.supports(rows, c_in, c_out) == \
                    jcb.supports(rows, c_in, c_out), (rows, c_in, c_out)
    for n in (8, 24, 1000, 50176):
        assert cb._pick_block_n(n) == jcb._pick_block_n(n)
    for c in (128, 384, 1024, 2048):
        assert cb._pick_block_cout(c) == jcb._pick_block_cout(c)


@pytest.mark.parametrize('stride', [1, 2])
@pytest.mark.parametrize('prologue', [None, 'affine', 'relu'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_backward_matches_jax_grad(dtype, prologue, stride):
    """Cotangents through y, s1 and s2 at once: the gradient of
    sum(y * cy) + sum(s1 * c1) + sum(s2 * c2) w.r.t. x, W, scale, bias."""
    x, w, a, b = _inputs(3, dtype)
    rng = np.random.RandomState(4)
    ho, wo = -(-H // stride), -(-W // stride)
    cy = rng.randn(B, ho, wo, COUT).astype(np.float32)
    c1 = (rng.randn(COUT) * 0.1).astype(np.float32)
    c2 = (rng.randn(COUT) * 0.01).astype(np.float32)
    sa, sb, relu = _prologue(prologue, a, b)
    jdt = jnp.bfloat16 if dtype == 'bfloat16' else jnp.float32

    def jloss(x_, w_, a_, b_):
        y, s1, s2 = jcb.fused_pointwise(x_, w_, a_, b_, prologue_relu=relu,
                                        stride=stride, interpret=True)
        return (jnp.sum(y.astype(jnp.float32) * cy) + jnp.sum(s1 * c1) +
                jnp.sum(s2 * c2))

    jargs = [_jax_x(x, dtype), jnp.asarray(w)]
    if sa is not None:
        jargs += [jnp.asarray(sa), jnp.asarray(sb)]
        jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(*jargs)
    else:
        jgrads = jax.grad(lambda x_, w_: jloss(x_, w_, None, None),
                          argnums=(0, 1))(*jargs)
    assert jgrads[0].dtype == jdt

    targs = [_torch_x(x, dtype).requires_grad_(),
             torch.from_numpy(w).requires_grad_()]
    if sa is not None:
        targs += [torch.from_numpy(sa).requires_grad_(),
                  torch.from_numpy(sb).requires_grad_()]
    y, s1, s2 = cb.fused_pointwise(
        targs[0], targs[1], *(targs[2:] or [None, None]),
        prologue_relu=relu, stride=stride)
    loss = ((y.float() * torch.from_numpy(cy)).sum() +
            (s1 * torch.from_numpy(c1)).sum() +
            (s2 * torch.from_numpy(c2)).sum())
    loss.backward()
    assert targs[0].grad.dtype == getattr(torch, dtype)
    tol = 1e-5 if dtype == 'float32' else 2e-2
    for t, jg in zip(targs, jgrads):
        _close(t.grad.float().numpy(), jg, tol)


def test_other_devices_raise():
    x = torch.empty((1, 8, 8, 16), device='meta')
    with pytest.raises(ValueError, match='no path'):
        cb.fused_pointwise(x, torch.empty((16, 128), device='meta'))


@pytest.mark.parametrize('case,error,match', [
    ('x_dtype', TypeError, 'float32 or bfloat16'),
    ('c_out', ValueError, 'Cout % 128'),
    ('c_in', ValueError, 'Cin % 8'),
    ('w_transposed', ValueError, 'Cin % 8'),
    ('device', ValueError, 'every input must be on')])
def test_kernel_wrapper_checks_its_arguments(case, error, match):
    """The CUDA wrapper refuses what the kernel does not take before it
    passes any pointer, so these raise here as on the card. W goes to the
    kernel as it lies, [Cin, Cout]: a W given as [Cout, Cin] is refused,
    not read transposed."""
    x = torch.zeros((40, 16), dtype=torch.bfloat16)
    w = torch.zeros((16, 128))
    a = b = torch.zeros(16)
    if case == 'x_dtype':
        x = x.half()
    elif case == 'c_out':
        w = torch.zeros((16, 200))
    elif case == 'c_in':
        x, w, a, b = torch.zeros((40, 12), dtype=torch.bfloat16), \
            torch.zeros((12, 128)), torch.zeros(12), torch.zeros(12)
    elif case == 'w_transposed':
        w = torch.zeros((128, 16))
    else:
        a = torch.zeros(16, device='meta')
    with pytest.raises(error, match=match):
        cb._fwd_cuda(x, w, a, b, True, True, torch.bfloat16)
