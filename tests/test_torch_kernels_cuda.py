"""The port's CUDA kernels against their plain versions, on the card.

These need a CUDA card (the kernels have no CPU mode) and skip without
one. The file imports no jax, so it runs on the machine with the card:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: ``tests/conftest.py`` sets up JAX.) Flash attention:
shapes include ragged tile edges (S = 40, 96, 200 against 64- and
128-row tiles), every head dim the kernels take, a long S that wraps the
wgmma kernels' TMA ring many times, and a bitwise repeat of two launches.
Head dims the kernels lack (80, 96, 160, 264) run through the wrapper,
zero-padded to 128, 256 or 320, against the plain versions at the true
head dim; the head-dim-256 kernels (the three wgmma kernels in bf16) and
the column-chunked kernels above 256 run directly too, bf16 dK/dV at 256,
320 and 384 with ragged S and a bitwise repeat, and the dispatch names
the kernel each case runs. The fused conv + BatchNorm kernel: row
counts that are multiples of 8 but
not of its 128-row tile, Cin = 8, 24 and 2048 (a Cin tail short of its
64-wide step), stride 2, each prologue, bf16 and f32, and a prologue that
would leak relu(b) into the padding if the kernel did not zero it.
"""
import numpy as np
import pytest
import torch

from autodist_tpu_torch.kernels import conv_bn as cb
from autodist_tpu_torch.kernels import flash_attention as fa


def _inputs(shape, seed, n=4):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('shape', [(2, 3, 128, 64), (1, 2, 200, 128),
                                   (1, 1, 40, 16), (2, 2, 96, 32),
                                   (1, 2, 4096, 64), (1, 2, 1024, 128),
                                   (2, 2, 200, 128), (1, 2, 200, 64)])
def test_kernels_match_plain_on_card(shape, causal, dtype):
    """Each CUDA kernel against its plain version on the card (ragged
    edges included). bf16 at D = 64 and 128 runs the wgmma kernels for
    the forward, dQ and dK/dV: S = 4096 wraps their TMA ring many times
    and runs the longest q tiles first; S = 200 at D = 64 and 128 reads
    the zero rows TMA fills in past a ragged S. Tolerance: f32 with TF32 off sums
    in another order (1e-5); bf16 rounds P before P.V at another running
    max in the online softmax, so O may move by 2 bf16 ulps (2e-2); dQ/dK/
    dV see the same P and dS roundings as the plain version (1e-2). The
    wgmma kernels take P as exp2f of the score scaled by scale * log2(e),
    where the plain version takes exp of the scaled score: that changes P
    only in f32's last bits, far inside these tolerances."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels have no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(x).to('cuda', dt)
                   for x in _inputs(shape, 3))
    scale = shape[-1] ** -0.5
    o, lse = fa._fwd_cuda(q, k, v, causal, scale)
    o2, lse2 = fa._fwd_plain(q, k, v, causal, scale)
    delta = fa._delta(do, o)
    dq = fa._dq_cuda(q, k, v, do, lse, delta, causal, scale)
    dk, dv = fa._dkv_cuda(q, k, v, do, lse, delta, causal, scale)
    dq2 = fa._dq_plain(q, k, v, do, lse, delta, causal, scale)
    dk2, dv2 = fa._dkv_plain(q, k, v, do, lse, delta, causal, scale)
    tol = {'float32': (1e-5, 1e-5, 1e-5), 'bfloat16': (2e-2, 1e-5, 1e-2)}
    t_o, t_lse, t_g = tol[dtype]
    torch.testing.assert_close(o.float(), o2.float(), atol=t_o, rtol=t_o)
    torch.testing.assert_close(lse, lse2, atol=t_lse, rtol=t_lse)
    for a, b in ((dq, dq2), (dk, dk2), (dv, dv2)):
        torch.testing.assert_close(a.float(), b.float(), atol=t_g, rtol=t_g)


@pytest.mark.cuda
@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('shape', [(2, 3, 1024, 64), (1, 2, 200, 128),
                                   (1, 2, 200, 64), (1, 2, 1024, 256),
                                   (1, 2, 200, 384)])
def test_kernels_repeat_bitwise_on_card(shape, causal):
    """Each CTA owns its output tile, with no atomics: two launches of
    the forward, dQ and dK/dV (bf16: the wgmma kernels at 64, 128 and
    256, the column-chunked ones at 384) on the same inputs give the same
    bits."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels have no CPU mode')
    q, k, v, do = (torch.from_numpy(x).to('cuda', torch.bfloat16)
                   for x in _inputs(shape, 4))
    scale = shape[-1] ** -0.5
    o, lse = fa._fwd_cuda(q, k, v, causal, scale)
    o2, lse2 = fa._fwd_cuda(q, k, v, causal, scale)
    delta = fa._delta(do, o)
    dq = fa._dq_cuda(q, k, v, do, lse, delta, causal, scale)
    dq2 = fa._dq_cuda(q, k, v, do, lse, delta, causal, scale)
    dk, dv = fa._dkv_cuda(q, k, v, do, lse, delta, causal, scale)
    dk2, dv2 = fa._dkv_cuda(q, k, v, do, lse, delta, causal, scale)
    for a, b in ((o, o2), (lse, lse2), (dq, dq2), (dk, dk2), (dv, dv2)):
        assert torch.equal(a, b)


def _conv_inputs(shape, c_out, seed):
    rng = np.random.RandomState(seed)
    c_in = shape[-1]
    return (rng.randn(*shape).astype(np.float32),
            (rng.randn(c_in, c_out) / np.sqrt(c_in)).astype(np.float32),
            (rng.rand(c_in) + 0.5).astype(np.float32),
            rng.randn(c_in).astype(np.float32))


def _close_to_max(got, want, rel):
    want = want.float()
    torch.testing.assert_close(got.float(), want, rtol=0,
                               atol=rel * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('head_dim', [80, 96, 160])
def test_padded_head_dims_match_plain_on_card(head_dim, causal, dtype):
    """Through the wrapper, which pads 80 and 96 to 128 and 160 to 256:
    one launch of each kernel, and o, dq, dk, dv against the plain
    versions at the true head dim (S = 200, a ragged edge for every
    tile). Tolerances as test_kernels_match_plain_on_card; the padding
    adds exact zeros to every sum."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels have no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    shape = (2, 2, 200, head_dim)
    q, k, v, do = (torch.from_numpy(x).to('cuda', dt)
                   for x in _inputs(shape, 4))
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    fa.reset_launches()
    o = fa.flash_attention(qq, kk, vv, causal=causal)
    dq, dk, dv = torch.autograd.grad(o, (qq, kk, vv), do)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {'fwd': 1, 'dq': 1, 'dkv': 1}
    scale = head_dim ** -0.5
    o2, lse2 = fa._fwd_plain(q, k, v, causal, scale)
    delta = fa._delta(do, o2)
    dq2 = fa._dq_plain(q, k, v, do, lse2, delta, causal, scale)
    dk2, dv2 = fa._dkv_plain(q, k, v, do, lse2, delta, causal, scale)
    t_o, t_g = {'float32': (1e-5, 1e-5), 'bfloat16': (2e-2, 1e-2)}[dtype]
    assert o.shape == dq.shape == shape
    torch.testing.assert_close(o.float(), o2.float(), atol=t_o, rtol=t_o)
    for a, b in ((dq, dq2), (dk, dk2), (dv, dv2)):
        torch.testing.assert_close(a.float(), b.float(), atol=t_g, rtol=t_g)


@pytest.mark.cuda
def test_dispatch_names_the_kernel_of_each_head_dim():
    """route() in the source, read through fa_kernel_name: bf16 at 256
    runs the three wgmma kernels; f32 at 256 the CUDA-core kernels; every
    multiple of 64 above 256 the column-chunked kernels (all three bf16
    ones on the tensor cores); a width the kernels lack, none."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels are built there')
    bf, f32 = torch.bfloat16, torch.float32
    want = {(bf, 256): ('fwd_wgmma_kernel', 'dq_wgmma_kernel',
                        'dkv_wgmma_kernel'),
            (f32, 256): ('fwd_kernel', 'dq_kernel', 'dkv_kernel'),
            (bf, 128): ('fwd_wgmma_kernel', 'dq_wgmma_kernel',
                        'dkv_wgmma_kernel'),
            (bf, 32): ('fwd_mma_kernel', 'dq_mma_kernel', 'dkv_mma_kernel')}
    for d in (320, 384, 1024):
        want[(f32, d)] = ('fwd_cols_kernel', 'dq_cols_kernel',
                          'dkv_cols_kernel')
        want[(bf, d)] = ('fwd_wgmma_cols_kernel', 'dq_wgmma_cols_kernel',
                         'dkv_wgmma_cols_kernel')
    for (dt, d), names in want.items():
        tag = 'bf16' if dt == bf else 'f32'
        assert [fa.kernel_name(k, dt, d) for k in ('fwd', 'dq', 'dkv')] == \
            ['%s<%s,%d>' % (n, tag, d) for n in names]
    for d in (192, 264, 48):
        assert fa.kernel_name('fwd', bf, d) is None


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('causal', [True, False])
def test_head_dim_256_kernels_match_plain_on_card(causal, dtype):
    """The kernels at head dim 256, called directly (bf16: the three
    wgmma kernels; f32: all three on the CUDA cores): every output against
    its plain version, ragged S = 200 and a longer S = 1024."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels have no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    for shape in ((1, 2, 200, 256), (1, 1, 1024, 256)):
        q, k, v, do = (torch.from_numpy(x).to('cuda', dt)
                       for x in _inputs(shape, 7))
        scale = shape[-1] ** -0.5
        o, lse = fa._fwd_cuda(q, k, v, causal, scale)
        o2, lse2 = fa._fwd_plain(q, k, v, causal, scale)
        delta = fa._delta(do, o)
        outs = (fa._dq_cuda(q, k, v, do, lse, delta, causal, scale),) + \
            fa._dkv_cuda(q, k, v, do, lse, delta, causal, scale)
        want = (fa._dq_plain(q, k, v, do, lse, delta, causal, scale),) + \
            fa._dkv_plain(q, k, v, do, lse, delta, causal, scale)
        t_o, t_g = {'float32': (1e-5, 1e-5),
                    'bfloat16': (2e-2, 1e-2)}[dtype]
        torch.testing.assert_close(o.float(), o2.float(), atol=t_o, rtol=t_o)
        torch.testing.assert_close(lse, lse2, atol=1e-5, rtol=1e-5)
        for a, b in zip(outs, want):
            torch.testing.assert_close(a.float(), b.float(), atol=t_g,
                                       rtol=t_g)


@pytest.mark.cuda
@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('head_dim', [256, 320, 384])
def test_bf16_dkv_from_head_dim_256_matches_plain_on_card(head_dim, causal):
    """bf16 dK/dV from head dim 256 on, the wgmma kernels with 64-row kv
    tiles split by columns over the two warpgroups (dkv_wgmma_kernel at
    256, dkv_wgmma_cols_kernel above, whose last chunk at 320 holds one
    64-column slab and leaves the second warpgroup no output column),
    called directly: against the plain version at S = 1000 (ragged for
    the 64-row kv and q tiles) and S = 4096 (the TMA rings wrapped many
    times), and a second launch on the same inputs gives the same bits.
    Tolerance as test_kernels_match_plain_on_card (1e-2)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels have no CPU mode')
    dt = torch.bfloat16
    assert fa.kernel_name('dkv', dt, head_dim) == '%s<bf16,%d>' % (
        'dkv_wgmma_kernel' if head_dim == 256 else 'dkv_wgmma_cols_kernel',
        head_dim)
    for shape in ((2, 2, 1000, head_dim), (1, 1, 4096, head_dim)):
        q, k, v, do = (torch.from_numpy(x).to('cuda', dt)
                       for x in _inputs(shape, 11))
        scale = head_dim ** -0.5
        o, lse = fa._fwd_cuda(q, k, v, causal, scale)
        delta = fa._delta(do, o)
        args = (q, k, v, do, lse, delta, causal, scale)
        fa.reset_launches()
        dk, dv = fa._dkv_cuda(*args)
        dk2, dv2 = fa._dkv_cuda(*args)
        assert fa.KERNEL_LAUNCHES == {fa.kernel_name('dkv', dt, head_dim): 2}
        want = fa._dkv_plain(*args)
        torch.cuda.synchronize()
        for a, b in zip((dk, dv), want):
            assert a.shape == shape
            torch.testing.assert_close(a.float(), b.float(), atol=1e-2,
                                       rtol=1e-2)
        assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('prologue', [None, 'affine', 'relu'])
@pytest.mark.parametrize('shape,c_out,stride', [
    ((1, 5, 8, 8), 128, 1),          # 40 rows, Cin 8
    ((2, 10, 10, 24), 256, 1),       # 200 rows, Cin 24
    ((2, 14, 14, 2048), 512, 1),     # 392 rows, Cin 2048
    ((4, 14, 14, 64), 128, 2),       # stride 2: 196 rows
    ((8, 28, 28, 256), 1024, 1)])    # 6272 rows
def test_conv_bn_kernel_matches_plain_on_card(shape, c_out, stride,
                                              prologue, dtype):
    """y, s1 and s2 of the kernel against its plain version on the card.
    Tolerance: f32 (TF32 off) sums in another order, 1e-5 of the largest
    |y|; bf16 y is rounded from f32 sums taken in another order, so one
    bf16 ulp (1e-2); s1/s2 come from the f32 accumulator in both, 1e-5 of
    the largest |s|."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel has no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    x, w, a, b = (torch.from_numpy(t).cuda()
                  for t in _conv_inputs(shape, c_out, 5))
    x = x.to(dt)[:, ::stride, ::stride].reshape(-1, shape[-1])
    if prologue is None:
        a = b = None
    relu = prologue == 'relu'
    y, s1, s2 = cb._fwd_cuda(x, w, a, b, relu, True, dt)
    y2, t1, t2 = cb._fwd_plain(x, w, a, b, relu, True, dt)
    torch.cuda.synchronize()
    _close_to_max(y, y2, 1e-5 if dtype == 'float32' else 1e-2)
    _close_to_max(s1, t1, 1e-5)
    _close_to_max(s2, t2, 1e-5)
    y3, z1, z2 = cb._fwd_cuda(x, w, a, b, relu, False, dt)
    assert not z1.any() and not z2.any()
    torch.testing.assert_close(y3, y, rtol=0, atol=0)


@pytest.mark.cuda
def test_conv_bn_kernel_zeroes_the_padding_after_the_prologue():
    """N = 40 rows and Cin = 24 fill a fraction of the kernel's 128-row,
    64-Cin tile; TMA reads zeros there, and relu(0 * a + b) with b = +1
    would be 1, not 0. s1 and s2 must be the f32 column sums of the plain
    y (out_dtype f32: the accumulator itself) over the 40 real rows only,
    within the tolerance above (1e-5 of the largest |s|), and y within
    one bf16 ulp."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel has no CPU mode')
    x, w, a, _ = (torch.from_numpy(t).cuda()
                  for t in _conv_inputs((40, 24), 256, 8))
    x = x.to(torch.bfloat16)
    b = torch.ones(24, device='cuda')
    y, s1, s2 = cb._fwd_cuda(x, w, a, b, True, True, torch.bfloat16)
    acc, _, _ = cb._fwd_plain(x, w, a, b, True, True, torch.float32)
    torch.cuda.synchronize()
    _close_to_max(y, acc.to(torch.bfloat16), 1e-2)
    _close_to_max(s1, acc.sum(0), 1e-5)
    _close_to_max(s2, (acc * acc).sum(0), 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_conv_bn_backward_on_card_matches_cpu(dtype):
    """The autograd Function on the card (the kernel forward, cuBLAS
    products with f32 sums) against the same Function on the CPU (the
    plain version): gradients of x, W, scale and bias through y, s1 and
    s2. Tolerance: 1e-5 of the largest |gradient| in f32 (TF32 off);
    bf16 rounds dY and xn to bf16 on both sides from sums taken in
    another order, 2e-2."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel has no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    x, w, a, b = _conv_inputs((2, 8, 8, 64), 128, 6)
    rng = np.random.RandomState(7)
    cy = rng.randn(2, 4, 4, 128).astype(np.float32)
    c1, c2 = rng.randn(128).astype(np.float32), \
        (rng.randn(128) * 0.01).astype(np.float32)
    grads = {}
    for dev in ('cuda', 'cpu'):
        ts = [torch.from_numpy(t).to(dev) for t in (x, w, a, b)]
        ts[0] = ts[0].to(dt)
        for t in ts:
            t.requires_grad_()
        y, s1, s2 = cb.fused_pointwise(*ts, prologue_relu=True, stride=2)
        loss = ((y.float() * torch.from_numpy(cy).to(dev)).sum() +
                (s1 * torch.from_numpy(c1).to(dev)).sum() +
                (s2 * torch.from_numpy(c2).to(dev)).sum())
        loss.backward()
        grads[dev] = [t.grad.cpu() for t in ts]
    tol = 1e-5 if dtype == 'float32' else 2e-2
    for g, want in zip(grads['cuda'], grads['cpu']):
        assert g.dtype == want.dtype
        _close_to_max(g, want, tol)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('head_dim', [264, 384])
def test_head_dims_above_256_match_plain_on_card(head_dim, causal, dtype):
    """The column-chunked kernels (the score products streamed over D;
    chunks of 256 output columns for the bf16 kernels on the tensor
    cores, of 128 for the f32 ones): through the wrapper, which pads
    264 to 320 (a last chunk of 64 columns) and runs 384 as it is, one
    launch of each kernel, and o, dq, dk, dv against the plain versions
    at the true head dim (S = 200, ragged for every tile); then the
    kernels called directly at 384, LSE included, at S = 1024.
    Tolerances as test_kernels_match_plain_on_card."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels have no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    t_o, t_g = {'float32': (1e-5, 1e-5), 'bfloat16': (2e-2, 1e-2)}[dtype]
    shape = (2, 2, 200, head_dim)
    q, k, v, do = (torch.from_numpy(x).to('cuda', dt)
                   for x in _inputs(shape, 8))
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    fa.reset_launches()
    o = fa.flash_attention(qq, kk, vv, causal=causal)
    dq, dk, dv = torch.autograd.grad(o, (qq, kk, vv), do)
    torch.cuda.synchronize()
    width = fa.padded_head_dim(head_dim)
    assert fa.LAUNCHES == {'fwd': 1, 'dq': 1, 'dkv': 1}
    assert fa.KERNEL_LAUNCHES == {fa.kernel_name(n, dt, width): 1
                                  for n in ('fwd', 'dq', 'dkv')}
    scale = head_dim ** -0.5
    o2, lse2 = fa._fwd_plain(q, k, v, causal, scale)
    delta = fa._delta(do, o2)
    dq2 = fa._dq_plain(q, k, v, do, lse2, delta, causal, scale)
    dk2, dv2 = fa._dkv_plain(q, k, v, do, lse2, delta, causal, scale)
    assert o.shape == dq.shape == dk.shape == dv.shape == shape
    torch.testing.assert_close(o.float(), o2.float(), atol=t_o, rtol=t_o)
    for a, b in ((dq, dq2), (dk, dk2), (dv, dv2)):
        torch.testing.assert_close(a.float(), b.float(), atol=t_g, rtol=t_g)
    if head_dim % 64:
        return
    shape = (1, 1, 1024, head_dim)
    q, k, v, do = (torch.from_numpy(x).to('cuda', dt)
                   for x in _inputs(shape, 9))
    o, lse = fa._fwd_cuda(q, k, v, causal, scale)
    o2, lse2 = fa._fwd_plain(q, k, v, causal, scale)
    delta = fa._delta(do, o)
    outs = (fa._dq_cuda(q, k, v, do, lse, delta, causal, scale),) + \
        fa._dkv_cuda(q, k, v, do, lse, delta, causal, scale)
    want = (fa._dq_plain(q, k, v, do, lse, delta, causal, scale),) + \
        fa._dkv_plain(q, k, v, do, lse, delta, causal, scale)
    torch.testing.assert_close(o.float(), o2.float(), atol=t_o, rtol=t_o)
    torch.testing.assert_close(lse, lse2, atol=1e-5, rtol=1e-5)
    for a, b in zip(outs, want):
        torch.testing.assert_close(a.float(), b.float(), atol=t_g, rtol=t_g)
