"""The cross-entropy kernels against their plain versions, on the card.

These need a CUDA card (the kernels have no CPU mode) and skip without
one. The file imports no jax, so it runs on the machine with the card:

    python -m pytest --noconftest -m cuda -s tests/test_torch_cross_entropy_cuda.py

Shapes: both benchmark cells' heads ([16384, 50257] and [16384, 30522]
bf16), small vocabs (256, 1,000) with a row count no tile divides, a
padded row stride (50,257 columns of 50,304-wide rows), and rows that do
not start on 16 bytes; f32 logits at a small shape. The per-row g has
zeros and varies from row to row. Pass marks: the NLL and lse within
1e-5 relative of the plain f32 path; the gradient within one bf16 ulp of
the plain path's rounded gradient (the forward sums its exps through
``ex2.approx`` in another order, and the backward's exp may round its
last f32 bit otherwise, so a rounding to bf16 can fall the other way);
f32 gradients within 2e-6 relative. ``-s`` prints each kernel's time at
the cells' shapes against its byte bound (bytes / 3.35 TB/s).
"""
import pytest
import torch

from autodist_tpu_torch.kernels import cross_entropy as ce

PEAK_BYTES = 3.35e12   # H100 SXM HBM3, bytes/s


def _card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels have no CPU mode')


def _inputs(r, v, dtype, stride=None, offset=0, seed=0):
    """Logits [r, v] at row stride ``stride`` (default v) starting
    ``offset`` elements into their buffer; targets; g with zeros."""
    gen = torch.Generator(device='cuda').manual_seed(seed)
    st = stride or v
    buf = torch.randn(offset + r * st, generator=gen, device='cuda') * 4
    x = buf.to(dtype).as_strided((r, v), (st, 1), offset)
    t = torch.randint(0, v, (r,), generator=gen, device='cuda')
    g = torch.rand(r, generator=gen, device='cuda')
    g = g * (torch.rand(r, generator=gen, device='cuda') > 0.25) / r
    return x, t, g


def _within_one_bf16_ulp(got, want):
    """|got - want| at most one bf16 spacing of the larger magnitude."""
    a, b = got.float(), want.float()
    big = torch.maximum(a.abs(), b.abs())
    _, e = torch.frexp(big)
    ulp = torch.ldexp(torch.ones_like(big), e - 8)
    bad = (a - b).abs() > ulp
    assert not bad.any(), '%d of %d elements beyond one bf16 ulp, worst ' \
        '%s' % (int(bad.sum()), a.numel(), float(((a - b).abs() - ulp).max()))


def _check(r, v, dtype, stride=None, offset=0):
    x, t, g = _inputs(r, v, dtype, stride, offset)
    ce.reset_launches()
    nll, lse = ce.xent_fwd(x, t)
    want_nll, want_lse = ce._fwd_plain(x, t)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=0)
    torch.testing.assert_close(nll, want_nll, rtol=1e-5, atol=0)
    dx = ce.xent_bwd(x, t, lse, g)
    assert dx.stride() == x.stride() and dx.dtype == dtype
    want = ce._bwd_plain(x, t, lse, g)
    if dtype == torch.bfloat16:
        _within_one_bf16_ulp(dx, want)
    else:
        torch.testing.assert_close(dx, want, rtol=2e-6, atol=1e-12)
    assert ce.LAUNCHES == {'fwd': 1, 'bwd': 1, 'plain': 0}
    return x, t, g, dx


@pytest.mark.cuda
@pytest.mark.parametrize('r,v,stride,offset', [
    (16384, 50257, None, 0),      # gpt2-small.s4096.b4's head
    (16384, 30522, None, 0),      # the bert-large cells' head
    (16384, 50257, 50304, 0),     # a head padded to a multiple of 64
    (333, 256, None, 0),
    (333, 1000, None, 0),
    (257, 1000, 1003, 3),         # rows off 16 bytes, another alignment each
])
def test_kernels_match_plain_on_card(r, v, stride, offset):
    _card()
    _check(r, v, torch.bfloat16, stride, offset)


@pytest.mark.cuda
@pytest.mark.parametrize('v,stride,offset', [(1000, None, 0),
                                             (997, 1001, 1)])
def test_f32_logits_match_plain_on_card(v, stride, offset):
    _card()
    _check(129, v, torch.float32, stride, offset)


@pytest.mark.cuda
def test_token_nll_through_autograd_matches_the_f32_path_on_card():
    """The model's entry: ``token_nll`` on [b, s, V] bf16 logits, its
    gradient through autograd against autograd through the f32 path."""
    _card()
    x, t, g = _inputs(4 * 512, 1000, torch.bfloat16, seed=5)
    x, t, g = x.view(4, 512, 1000), t.view(4, 512), g.view(4, 512)
    a = x.clone().requires_grad_()
    b = x.clone().requires_grad_()
    ce.reset_launches()
    got = ce.token_nll(a, t)
    (got * g).sum().backward()
    assert ce.LAUNCHES == {'fwd': 1, 'bwd': 1, 'plain': 0}
    bf = b.float()
    want = torch.logsumexp(bf, -1) - torch.gather(bf, -1, t[..., None])[..., 0]
    (want * g).sum().backward()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    _within_one_bf16_ulp(a.grad, b.grad)


@pytest.mark.cuda
def test_kernels_repeat_bitwise_on_card():
    """No atomics: two launches give the same bits."""
    _card()
    x, t, g = _inputs(1024, 50257, torch.bfloat16, seed=2)
    a = ce.xent_fwd(x, t)
    b = ce.xent_fwd(x, t)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(ce.xent_bwd(x, t, a[1], g), ce.xent_bwd(x, t, a[1], g))


def _ms(fn, n=20):
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


@pytest.mark.cuda
@pytest.mark.parametrize('r,v', [(16384, 50257), (16384, 30522)])
def test_kernel_time_against_the_byte_bound(r, v):
    """Reports each kernel's ms at a cell's shape against its byte bound:
    the forward reads R V bf16 logits (and the targets, writes nll and
    lse), the backward reads them and writes the gradient; the plain f32
    path's ms beside them. Asserts only that the times are positive: a
    time is a reading, not a pass mark."""
    _card()
    x, t, g = _inputs(r, v, torch.bfloat16)
    nll, lse = ce.xent_fwd(x, t)
    fwd_bytes = r * v * 2 + r * (8 + 4 + 4)
    bwd_bytes = 2 * r * v * 2 + r * (8 + 4 + 4)
    rows = {}
    for name, fn, nbytes in (
            ('xent_fwd_kernel', lambda: ce._fwd_cuda(x, t), fwd_bytes),
            ('xent_bwd_kernel', lambda: ce._bwd_cuda(x, t, lse, g),
             bwd_bytes)):
        ms = _ms(fn)
        bound = nbytes / PEAK_BYTES * 1e3
        rows[name] = (ms, bound)
        print('\n%s [%d, %d] bf16: %.4f ms, bound %.4f ms (bytes), %.1f %% '
              'of bound; %s' % (name, r, v, ms, bound, 100 * bound / ms,
                                torch.cuda.get_device_name()))
        assert ms > 0
    plain = _ms(lambda: ce._bwd_plain(x, t, *ce._fwd_plain(x, t)[1:], g), 3)
    print('plain f32 forward + backward [%d, %d]: %.4f ms' % (r, v, plain))
