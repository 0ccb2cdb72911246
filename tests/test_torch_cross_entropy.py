"""The cross-entropy operators of the LM head, on the CPU.

The operators' CPU path is the f32 ``logsumexp - gather`` expression
that ``TransformerLM`` computed before them, and autograd's gradient of
it; these tests hold the operators (``torch.library.opcheck``), the
dispatch rule, the layout helpers the CUDA path relies on, and the
model's loss through them against that expression, bit for bit. The
kernels themselves run on the card only
(``tests/test_torch_cross_entropy_cuda.py``).
"""
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from autodist_tpu_torch.kernels import cross_entropy as ce
from autodist_tpu_torch.models.transformer import (TransformerConfig,
                                                   TransformerLM)


def _old_nll(logits, targets):
    """The token NLL as ``TransformerLM._chunk_nll`` computed it before
    the operators: f32 logits, ``logsumexp`` minus the gathered gold."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return logz - gold


def _inputs(r, v, dtype, seed=0, pad=0):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(r, v + pad, generator=gen) * 3).to(dtype)[:, :v]
    t = torch.randint(0, v, (r,), generator=gen)
    g = torch.rand(r, generator=gen) * (torch.rand(r, generator=gen) > 0.3)
    return x, t, g


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('pad', [0, 5])
def test_opcheck_both_operators(dtype, pad):
    """Schema, fake tensors, autograd registration and AOT dispatch of
    ``xent_fwd`` and ``xent_bwd``, contiguous and at a padded row
    stride."""
    x, t, g = _inputs(6, 19, dtype, pad=pad)
    _, lse = ce.xent_fwd(x, t)
    torch.library.opcheck(ce.xent_fwd, (x.requires_grad_(), t))
    torch.library.opcheck(ce.xent_bwd, (x.detach(), t, lse, g))


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_value_and_gradient_equal_the_f32_expression(dtype):
    """``token_nll`` and its gradient for a per-row g with zeros: the same
    bits as autograd through the f32 expression."""
    x, t, g = _inputs(40, 301, dtype, seed=1)
    x = x.view(4, 10, 301)
    t = t.view(4, 10)
    a = x.clone().requires_grad_()
    b = x.clone().requires_grad_()
    got = ce.token_nll(a, t)
    want = _old_nll(b, t)
    assert got.dtype == torch.float32 and got.shape == t.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    (got * g.view(4, 10)).sum().backward()
    (want * g.view(4, 10)).sum().backward()
    assert a.grad.dtype == dtype
    torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)


def test_lse_is_returned_but_not_differentiable():
    x, t, _ = _inputs(3, 7, torch.float32)
    nll, lse = ce.xent_fwd(x.requires_grad_(), t)
    assert nll.requires_grad and not lse.requires_grad
    torch.testing.assert_close(lse, torch.logsumexp(x.detach(), -1),
                               rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_path_and_count_it():
    """The dispatch rule is the input's device: on the CPU the plain
    versions run, ``LAUNCHES['plain']`` counts the forward and the
    backward, and no kernel launch is counted."""
    ce.reset_launches()
    x, t, g = _inputs(5, 11, torch.bfloat16)
    nll = ce.token_nll(x.requires_grad_(), t)
    assert ce.LAUNCHES == {'fwd': 0, 'bwd': 0, 'plain': 1}
    (nll * g).sum().backward()
    assert ce.LAUNCHES == {'fwd': 0, 'bwd': 0, 'plain': 2}
    ce.reset_launches()
    assert ce.LAUNCHES == {'fwd': 0, 'bwd': 0, 'plain': 0}


def test_gradient_keeps_a_padded_row_stride():
    """Logits read as the rows of a wider buffer (a padded head) get their
    gradient at that row stride, in the plain path and under fake
    tensors alike; other layouts come back contiguous."""
    x, t, g = _inputs(6, 19, torch.bfloat16, pad=13)
    assert ce._row_stride(x) == 32
    _, lse = ce.xent_fwd(x, t)
    d = ce.xent_bwd(x, t, lse, g)
    assert d.stride() == (32, 1)
    torch.testing.assert_close(d, ce.xent_bwd(x.contiguous(), t, lse, g),
                               rtol=0, atol=0)
    cols = x.t().contiguous().t()    # column-major: copied, V apart
    assert ce._row_stride(cols) == 19
    with FakeTensorMode() as mode:
        fx = mode.from_tensor(x)
        fd = ce.xent_bwd(fx, mode.from_tensor(t), mode.from_tensor(lse),
                         mode.from_tensor(g))
        assert fd.shape == (6, 19) and fd.stride() == (32, 1)
        nll, flse = ce.xent_fwd(fx, mode.from_tensor(t))
        assert nll.shape == flse.shape == (6,)
        assert nll.dtype == flse.dtype == torch.float32


@pytest.mark.parametrize('dtype,offset', [(torch.bfloat16, 3),
                                          (torch.bfloat16, 0),
                                          (torch.float32, 1)])
def test_empty_rows_match_the_logits_alignment(dtype, offset):
    """The backward's output has the logits' row stride and their address
    modulo 16, whatever their storage offset, so the kernel's vector
    stores split each row where its loads do."""
    buf = torch.empty(offset + 5 * 23, dtype=dtype)
    x = buf.as_strided((5, 21), (23, 1), offset)
    d = ce._empty_rows(x, 23)
    assert d.shape == (5, 21) and d.stride() == (23, 1)
    assert d.data_ptr() % 16 == x.data_ptr() % 16
    end = d.storage_offset() + 4 * 23 + 21
    assert end <= d.untyped_storage().nbytes() // d.element_size()


def test_kernel_inputs_are_checked_before_any_launch():
    x, t, _ = _inputs(4, 9, torch.float32)
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        ce._rows(x.half(), t)
    with pytest.raises(ValueError, match=r'must be \[4\]'):
        ce._rows(x, t[:3])
    got, st, tgt = ce._rows(x.t().contiguous().t(), t.int())
    assert got.is_contiguous() and st == 9 and tgt.dtype == torch.int64


def _lm(dtype, **kw):
    return TransformerLM(TransformerConfig.tiny(dtype=dtype, **kw),
                         device='cpu', seed=3)


def _batch(b, s, vocab, mask=False):
    rng = np.random.RandomState(7)
    batch = {'tokens': torch.from_numpy(rng.randint(0, vocab, (b, s))),
             'targets': torch.from_numpy(rng.randint(0, vocab, (b, s)))}
    if mask:
        batch['mask'] = torch.from_numpy((rng.rand(b, s) > 0.4)
                                         .astype(np.float32))
    return batch


def _loss_and_grads(model, batch):
    params = model.params()
    for p in model.parameters():
        p.grad = None
    loss = model.loss(params, batch)
    loss.backward()
    return loss.detach(), [p.grad.clone() for p in model.parameters()]


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('kw,mask', [({}, False), ({}, True),
                                     ({'loss_chunk': 8}, False),
                                     ({'loss_chunk': 8}, True)])
def test_model_loss_and_grads_equal_the_f32_expression(dtype, kw, mask,
                                                       monkeypatch):
    """``TransformerLM.loss`` and every parameter's gradient through the
    operator are the bits the f32 expression gave, unchunked and under
    ``loss_chunk`` (4 checkpointed chunks), with and without a mask."""
    model = _lm(dtype, **kw)
    batch = _batch(2, 16, model.cfg.vocab, mask)
    ce.reset_launches()
    got = _loss_and_grads(model, batch)
    chunks = 4 if kw else 1
    # each chunk's forward, its recompute under loss_chunk, its backward
    assert ce.LAUNCHES['plain'] == chunks * (3 if kw else 2)
    monkeypatch.setattr(ce, 'token_nll', _old_nll)
    want = _loss_and_grads(model, batch)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    for a, b in zip(got[1], want[1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
