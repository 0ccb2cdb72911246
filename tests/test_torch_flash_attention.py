"""Port flash attention against the JAX package's Pallas kernels.

The JAX kernels run in Pallas interpret mode on the CPU, as
tests/test_flash_attention.py runs them; the port runs the plain
versions of its CUDA kernels (a CPU tensor takes them). Inputs are made
from a numpy seed and handed to both. Tolerances are those of
tests/test_flash_attention.py: 2e-5 on the forward (f32, the online
softmax rescales in another order than the materialized one) and 5e-4
on gradients (three chained f32 products, summed in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu.kernels import flash_attention as jfa
from autodist_tpu_torch.kernels import build
from autodist_tpu_torch.kernels import flash_attention as fa
from autodist_tpu_torch.models.transformer import (TransformerConfig,
                                                   TransformerLM)
from autodist_tpu_torch.utils.device import resolve_device

CASES = [((2, 3, 128, 64), None), ((1, 2, 96, 32), None),
         ((1, 1, 40, 16), 0.5)]


def _inputs(shape, seed, n=4):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


def _jax_blocks(s):
    dq_blk, dk_blk = jfa._default_blocks(s)
    return jfa._pick_block(s, dq_blk), jfa._pick_block(s, dk_blk)


def _scale(shape, sm_scale):
    return shape[-1] ** -0.5 if sm_scale is None else sm_scale


@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('shape,sm_scale', CASES)
def test_plain_fwd_matches_pallas(shape, sm_scale, causal):
    q, k, v, _ = _inputs(shape, 0)
    scale = _scale(shape, sm_scale)
    bq, bk = _jax_blocks(shape[2])
    o_j, lse_j = jfa._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal, scale, bq, bk, True)
    o_t, lse_t = fa._fwd_plain(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal, scale)
    assert lse_t.shape == lse_j.shape == shape[:3] + (1,)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('shape,sm_scale', CASES)
def test_plain_bwd_matches_pallas(shape, sm_scale, causal):
    """dQ and dK/dV from the same (o, lse, dO): the Pallas forward's
    outputs feed both backward implementations."""
    q, k, v, do = _inputs(shape, 1)
    scale = _scale(shape, sm_scale)
    bq, bk = _jax_blocks(shape[2])
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o, lse = jfa._fwd(jq, jk, jv, causal, scale, bq, bk, True)
    want = jfa._bwd(jq, jk, jv, o, lse, jdo, causal, scale, bq, bk, True)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    to, tlse = torch.from_numpy(np.array(o)), \
        torch.from_numpy(np.array(lse))
    delta = fa._delta(tdo, to)
    dq = fa._dq_plain(tq, tk, tv, tdo, tlse, delta, causal, scale)
    dk, dv = fa._dkv_plain(tq, tk, tv, tdo, tlse, delta, causal, scale)
    for got, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                   atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('shape,sm_scale', CASES)
def test_autograd_matches_jax_grad(shape, sm_scale, causal):
    """The autograd Function's gradients against jax.grad through the
    Pallas custom VJP, for a random cotangent."""
    q, k, v, w = _inputs(shape, 2)

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
        return jnp.sum(o * jnp.asarray(w))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = fa.flash_attention(tq, tk, tv, causal=causal, sm_scale=sm_scale)
    (o * torch.from_numpy(w)).sum().backward()
    for got, wg in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(wg),
                                   atol=5e-4, rtol=5e-4)
    assert fa.LAUNCHES == {'fwd': 0, 'dq': 0, 'dkv': 0}  # CPU: no kernel


def test_dispatch_rule_matches_jax():
    for s in range(1, 1101):
        shape = (1, 1, s, 64)
        assert fa.supports(shape) == jfa.supports(shape), s
        assert fa.preferred(shape) == jfa.preferred(shape), s
        assert fa._pick_block(s, 128) == jfa._pick_block(s, 128), s
    assert fa.MIN_KERNEL_SEQ == jfa.MIN_KERNEL_SEQ == 512


def test_unblockable_seq_raises_like_jax():
    x = torch.zeros(1, 1, 13, 16)
    with pytest.raises(ValueError, match='not blockable'):
        fa.flash_attention(x, x, x)


def test_cuda_request_without_gpu_raises(monkeypatch):
    """Without a card, asking for CUDA raises; nothing carries on on the
    CPU. The kernel build needs nvcc and says so."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        resolve_device(None)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        TransformerLM(TransformerConfig.tiny(dtype=torch.float32))
    monkeypatch.setenv('PATH', '')
    monkeypatch.delenv('CUDA_HOME', raising=False)
    monkeypatch.setattr(build.os.path, 'isfile', lambda p: False)
    with pytest.raises(RuntimeError, match='nvcc not found'):
        build.nvcc_path()


@pytest.mark.parametrize('seq,head_dim,dtype,raises', [
    (36, 64, torch.bfloat16, True), (36, 128, torch.bfloat16, True),
    (36, 32, torch.bfloat16, False), (36, 64, torch.float32, False),
    (40, 64, torch.bfloat16, False), (36, 256, torch.bfloat16, True),
    (36, 256, torch.float32, False), (36, 384, torch.bfloat16, True),
    (36, 384, torch.float32, False)])
def test_wgmma_kernels_take_seq_a_multiple_of_8(seq, head_dim, dtype,
                                                raises):
    """bf16 from head dim 64 on runs TMA-fed kernels (all three), whose
    lse/delta rows need S % 8 == 0 (every S supports() admits): the
    wrapper says so before any pointer reaches the card; other cases pass
    the check."""
    x = torch.zeros(1, 1, seq, head_dim, dtype=dtype)
    if raises:
        with pytest.raises(ValueError, match='multiple of 8'):
            fa._check((x, x, x), head_dim)
    else:
        fa._check((x, x, x), head_dim)
    assert fa.supports((1, 1, seq, head_dim)) == (seq % 8 == 0)


@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('head_dim', [80, 96, 160])
def test_head_dims_between_the_kernels_widths_pad_and_slice(head_dim,
                                                             causal):
    """A head dim the kernels lack runs zero-padded to the next width
    (80, 96 -> 128; 160 -> 256) with sm_scale from the true head dim,
    and o, dq, dk, dv are sliced back: the same values as the plain
    versions at the true head dim (f32: the padding adds exact zeros, so
    only the products' blocking differs; 1e-5)."""
    assert fa.padded_head_dim(head_dim) == (128 if head_dim <= 128 else 256)
    shape = (1, 2, 64, head_dim)
    q, k, v, w = _inputs(shape, 6)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = fa.flash_attention(tq, tk, tv, causal=causal)
    assert o.shape == shape
    (o * torch.from_numpy(w)).sum().backward()
    pq, pk, pv, do = map(torch.from_numpy, (q, k, v, w))
    scale = head_dim ** -0.5
    o2, lse2 = fa._fwd_plain(pq, pk, pv, causal, scale)
    delta = fa._delta(do, o2)
    dq2 = fa._dq_plain(pq, pk, pv, do, lse2, delta, causal, scale)
    dk2, dv2 = fa._dkv_plain(pq, pk, pv, do, lse2, delta, causal, scale)
    for got, want in ((o, o2), (tq.grad, dq2), (tk.grad, dk2),
                      (tv.grad, dv2)):
        assert got.shape == shape
        np.testing.assert_allclose(got.detach().numpy(), want.numpy(),
                                   atol=1e-5, rtol=1e-5)


def test_padded_head_dim_widths():
    """The kernels' widths: 16, 32, 64, 128, 256, then every multiple of
    64 (the column-chunked kernels); any other head dim pads up."""
    assert fa.padded_head_dim(256) == 256 and fa.padded_head_dim(16) == 16
    assert fa.padded_head_dim(1) == 16
    assert [fa.padded_head_dim(d) for d in (257, 264, 320, 321, 384,
                                            1000)] == \
        [320, 320, 320, 384, 384, 1024]
    assert all(fa.kernel_width(fa.padded_head_dim(d)) for d in range(1, 600))
    assert not fa.kernel_width(192) and not fa.kernel_width(264)


@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('head_dim', [264, 320, 384])
def test_head_dims_above_256_match_jax_interpret(head_dim, causal):
    """Above 256 the wrapper pads to the next multiple of 64 (264 -> 320)
    and slices back: the forward and the gradients of the port's wrapper
    on the CPU (the plain versions at the padded width) against the JAX
    flash_attention in Pallas interpret mode, which takes any head dim,
    for a random cotangent. Tolerances as the other parity tests here:
    2e-5 on o, 5e-4 on gradients."""
    shape = (1, 2, 64, head_dim)
    q, k, v, w = _inputs(shape, 9)

    def jloss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, causal=causal) *
                       jnp.asarray(w))

    jo = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal)
    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = fa.flash_attention(tq, tk, tv, causal=causal)
    assert o.shape == shape
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                               atol=2e-5, rtol=2e-5)
    (o * torch.from_numpy(w)).sum().backward()
    for got, wg in zip((tq.grad, tk.grad, tv.grad), want):
        assert got.shape == shape
        np.testing.assert_allclose(got.numpy(), np.asarray(wg),
                                   atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('head_dim', [256, 384])
def test_bf16_dkv_plain_matches_jax_interpret(head_dim, causal):
    """bf16 dK/dV at the head dims of the wgmma dK/dV kernels with 64-row
    kv tiles (256, and 384 in column chunks): the plain version, which
    keeps the kernels' cast points (P rounded to dO's dtype, dS to q's),
    against the gradients of the JAX flash_attention in Pallas interpret
    mode, whose _dkv_kernel rounds at the same points, for a bf16
    cotangent; o and lse from the Pallas forward feed the plain version.
    Tolerance 1e-2 + 2e-2 |want| (chip_smoke's bf16 gradient tolerance):
    the two exps differ in f32's last bits, which can move a rounding of
    P or dS by one bf16 ulp, and each output is rounded to bf16 from f32
    sums taken in another order."""
    shape = (1, 2, 128, head_dim)
    q, k, v, do = (jnp.asarray(x, jnp.bfloat16) for x in _inputs(shape, 10))
    scale = head_dim ** -0.5
    _, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(q, k, v,
                                                        causal=causal),
                     q, k, v)
    _, jdk, jdv = vjp(do)
    bq, bk = _jax_blocks(shape[2])
    o, lse = jfa._fwd(q, k, v, causal, scale, bq, bk, True)

    def torch_bf16(x):
        return torch.from_numpy(np.array(x.astype(jnp.float32))).to(
            torch.bfloat16)
    tq, tk, tv, tdo, to = map(torch_bf16, (q, k, v, do, o))
    dk, dv = fa._dkv_plain(tq, tk, tv, tdo, torch.from_numpy(np.array(lse)),
                           fa._delta(tdo, to), causal, scale)
    for got, want in ((dk, jdk), (dv, jdv)):
        assert got.dtype == torch.bfloat16 and got.shape == shape
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   atol=1e-2, rtol=2e-2)


def _lm_matches_jax_interpret(dim, n_heads):
    """TransformerLM with ``dim`` / ``n_heads`` = head dim, one layer, at
    S = 512: the flash branch in both packages (Pallas interpret mode in
    JAX, which takes any head dim; the padded plain versions in the
    port). Loss 1e-5 relative, gradients 5e-4 as the other flash parity
    tests."""
    from autodist_tpu.models.transformer import TransformerConfig as JConfig
    from autodist_tpu.models.transformer import TransformerLM as JLM
    from autodist_tpu_torch.models.weights import load_params, tree_to_numpy
    kw = dict(dim=dim, n_heads=n_heads, max_len=512, n_layers=1)
    jm = JLM(JConfig.tiny(dtype=jnp.float32, **kw))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = TransformerLM(TransformerConfig.tiny(dtype=torch.float32, **kw),
                       device='cpu')
    load_params(tm, jp)
    shape = (1, n_heads, 512, dim // n_heads)
    assert fa.preferred(shape) and jfa.preferred(shape)
    rng = np.random.RandomState(5)
    batch = {k: rng.randint(0, 256, (1, 512), dtype=np.int32)
             for k in ('tokens', 'targets')}
    params = tm.params()
    loss = tm.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)

    def grads(tree):
        return {k: grads(v) if isinstance(v, dict) else v.grad
                for k, v in tree.items()}
    got = jax.tree_util.tree_flatten_with_path(tree_to_numpy(grads(params)))
    want = jax.tree_util.tree_flatten_with_path(jgrads)
    assert [p for p, _ in got[0]] == [p for p, _ in want[0]]
    for (path, g), (_, w) in zip(got[0], want[0]):
        np.testing.assert_allclose(g, np.asarray(w), atol=5e-4, rtol=5e-4,
                                   err_msg=str(path))


def test_lm_at_head_dim_96_matches_jax_interpret():
    """dim 192 and 2 heads: head dim 96, padded to 128 in the port."""
    _lm_matches_jax_interpret(192, 2)


def test_lm_at_head_dim_384_matches_jax_interpret():
    """dim 768 and 2 heads (gpt_small's width with 2 heads): head dim
    384, above the fixed widths, which the port runs as it is."""
    _lm_matches_jax_interpret(768, 2)
