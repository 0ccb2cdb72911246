"""The port's training BatchNorm functions against the JAX package's
``kernels/batch_norm.py``, on the CPU: the twins of
tests/test_batch_norm_kernel.py, with the JAX functions as the reference
on the same numpy-seeded inputs, and the port's ``vision.BatchNorm``
training formulation beside them.

Tolerances as in tests/test_batch_norm_kernel.py (f32): y and var 1e-5,
means and the moments' gradient 1e-6, the backward 2e-5 (sums over the
rows in another order). bf16: 2e-2 of the largest magnitude of y and
dx (one bf16 ulp of each, from f32 coefficients), the f32 statistics
and parameter gradients 1e-5 relative (f32 sums of the same bf16
values)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu.kernels.batch_norm import batch_norm_train as j_bn_train
from autodist_tpu.kernels.batch_norm import moments as j_moments
from autodist_tpu_torch.kernels.batch_norm import batch_norm_train, moments
from autodist_tpu_torch.models.vision import BatchNorm

EPS = 1e-5


def _inputs(shape, seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    if dtype != np.float32:
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return (x, (rng.rand(c) + 0.5).astype(np.float32),
            rng.randn(c).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_forward_and_stats_match_jax(dtype):
    x, g, b, _ = _inputs((4, 5, 6, 16), 0, dtype)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == 'f32' else \
        (jnp.bfloat16, torch.bfloat16)
    jy, jmean, jvar = j_bn_train(jnp.asarray(x, jdt), jnp.asarray(g),
                                 jnp.asarray(b), EPS)
    y, mean, var = batch_norm_train(torch.tensor(x).to(tdt),
                                    torch.tensor(g), torch.tensor(b), EPS)
    assert y.dtype == tdt and mean.dtype == var.dtype == torch.float32
    want = np.asarray(jy.astype(jnp.float32))
    if dtype == 'f32':
        np.testing.assert_allclose(y.numpy(), want, atol=1e-5)
    else:
        assert np.max(np.abs(y.float().numpy() - want)) <= \
            2e-2 * np.max(np.abs(want))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), atol=1e-5,
                               rtol=1e-5)
    assert not mean.requires_grad and not var.requires_grad


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_closed_form_backward_matches_jax(dtype):
    """dx, d_gamma, d_beta of sum(y * ct) against the JAX custom vjp; the
    cotangents of mean and var are ignored in both."""
    x, g, b, ct = _inputs((3, 4, 4, 8), 1, dtype)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == 'f32' else \
        (jnp.bfloat16, torch.bfloat16)

    def jf(xx, gg, bb):
        y, mean, var = j_bn_train(xx, gg, bb, EPS)
        return jnp.sum(y.astype(jnp.float32) * ct) + jnp.sum(mean) + \
            jnp.sum(var)
    want = jax.grad(jf, (0, 1, 2))(jnp.asarray(x, jdt), jnp.asarray(g),
                                    jnp.asarray(b))
    tx = torch.tensor(x).to(tdt).requires_grad_(True)
    tg = torch.tensor(g).requires_grad_(True)
    tb = torch.tensor(b).requires_grad_(True)
    y, mean, var = batch_norm_train(tx, tg, tb, EPS)
    (torch.sum(y.float() * torch.from_numpy(ct)) + mean.sum() +
     var.sum()).backward()
    got = (tx.grad, tg.grad, tb.grad)
    assert tx.grad.dtype == tdt
    for name, t, w in zip(('dx', 'dg', 'db'), got, want):
        t, w = t.float().numpy(), np.asarray(w.astype(jnp.float32))
        if dtype == 'f32':
            np.testing.assert_allclose(t, w, atol=2e-5, err_msg=name)
        elif name == 'dx':
            assert np.max(np.abs(t - w)) <= 2e-2 * np.max(np.abs(w)), name
        else:
            np.testing.assert_allclose(t, w, rtol=1e-5, atol=1e-5,
                                       err_msg=name)


def test_moments_and_grad_match_jax():
    x, _, _, _ = _inputs((2, 3, 3, 4), 2)
    jm1, jm2 = j_moments(jnp.asarray(x))
    tx = torch.tensor(x).requires_grad_(True)
    m1, m2 = moments(tx)
    np.testing.assert_allclose(m1.detach().numpy(), np.asarray(jm1),
                               atol=1e-6)
    np.testing.assert_allclose(m2.detach().numpy(), np.asarray(jm2),
                               atol=1e-6, rtol=1e-6)
    (torch.sum(m1 * 0.3) + torch.sum(m2 * 0.1)).backward()
    want = jax.grad(lambda v: jnp.sum(j_moments(v)[0] * 0.3) +
                    jnp.sum(j_moments(v)[1] * 0.1))(jnp.asarray(x))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want), atol=1e-6)
    # one of the two moments unused: its cotangent counts as zero
    tx.grad = None
    torch.sum(moments(tx)[1]).backward()
    want = jax.grad(lambda v: jnp.sum(j_moments(v)[1]))(jnp.asarray(x))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want), atol=1e-6)


def test_matches_the_vision_batch_norm_training_formulation():
    """The same y and gradients as the port's ``vision.BatchNorm`` in
    training mode, which computes them by autograd through its moments:
    the A/B the card phase times."""
    x, g, b, ct = _inputs((2, 4, 4, 32), 3)
    bn = BatchNorm(32, eps=EPS, device='cpu')
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(g))
        bn.bias.copy_(torch.from_numpy(b))
    tx1 = torch.tensor(x).requires_grad_(True)
    y1 = bn(tx1)
    torch.sum(y1 * torch.from_numpy(ct)).backward()
    tx2 = torch.tensor(x).requires_grad_(True)
    tg = torch.tensor(g).requires_grad_(True)
    tb = torch.tensor(b).requires_grad_(True)
    y2, _, _ = batch_norm_train(tx2, tg, tb, EPS)
    torch.sum(y2 * torch.from_numpy(ct)).backward()
    np.testing.assert_allclose(y2.detach().numpy(), y1.detach().numpy(),
                               atol=1e-5)
    for got, want in ((tx2.grad, tx1.grad), (tg.grad, bn.scale.grad),
                      (tb.grad, bn.bias.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)
