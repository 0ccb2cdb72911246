"""The port's vision family against the JAX package, on the CPU in f32.

The JAX package initializes the params; ``load_params`` carries them
(state buffers included) into the port, and both run the same
numpy-seeded NHWC images. With ``AUTODIST_FUSED_CONV=1`` the JAX side
runs the Pallas kernel in interpret mode and the port the kernel's plain
version. Tolerances (f32): single convs and pools 1e-5 (products summed
in another order); whole models 1e-5 on logits, losses and EMA updates
and 2e-5 of the largest |gradient| on gradients, which chain those
products through several BatchNorms (batch statistics over a few
images amplify rounding by up to 1/std).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu.kernels import conv_bn as jcb
from autodist_tpu.models import core as jcore
from autodist_tpu.models import vision as jv
from autodist_tpu_torch.kernels import conv_bn as cb
from autodist_tpu_torch.models import core
from autodist_tpu_torch.models import vision as tv
from autodist_tpu_torch.models.weights import (flatten_tree, load_params,
                                               params_to_jax)

F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(params=['0', '1'], ids=['unfused', 'fused'])
def fused(request, monkeypatch):
    monkeypatch.setenv('AUTODIST_FUSED_CONV', request.param)
    return request.param == '1'


def _images(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pair(jmod, tmod, seed=0):
    """JAX params for ``jmod`` (numpy), loaded into ``tmod``."""
    jp = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(seed)))
    load_params(tmod, jp)
    return jp


def _flat(tree):
    return {'/'.join(k): np.asarray(v, np.float32)
            for k, v in flatten_tree(tree)}


def _assert_close_rel(got, want, rel, what=''):
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=rel * scale,
                                   err_msg='%s %s' % (what, k))


def _grads(module):
    return {'/'.join(k): v.grad.numpy()
            for k, v in flatten_tree(module.params()) if v.grad is not None}


def _train_both(jmod, tmod, jp, fn_j, fn_t):
    """(loss, grads, state updates) of a training-mode forward in both
    packages; ``fn_*(module, params) -> scalar``."""
    jcore.assign_state_paths(jmod)
    core.assign_state_paths(tmod)

    def jl(p):
        with jcore.model_mode(training=True) as mm:
            loss = fn_j(jmod, p)
        return loss, dict(mm.updates)
    (jloss, jup), jg = jax.value_and_grad(jl, has_aux=True)(jp)
    with core.model_mode(training=True) as mm:
        loss = fn_t(tmod, tmod.params())
    loss.backward()
    want_up = {'/'.join(k): np.asarray(v) for k, v in jup.items()}
    got_up = {'/'.join(k): v.numpy() for k, v in mm.updates.items()}
    assert got_up.keys() == want_up.keys() and want_up
    return ((float(loss.detach()), float(jloss)), (_grads(tmod), _flat(jg)),
            (got_up, want_up))


def _check_train(jmod, tmod, jp, fn_j, fn_t):
    """Loss, every gradient and every EMA update agree. A gradient is
    held to 2e-5 of its own largest entry plus 1e-6 of the model's
    largest: a BatchNorm scale that feeds another batch-statistics
    BatchNorm has a gradient that nearly cancels (1e-5 of the model's
    largest), and its rounding residue is all that is left of it."""
    (l, jl), (g, jg), (u, ju) = _train_both(jmod, tmod, jp, fn_j, fn_t)
    np.testing.assert_allclose(l, jl, **F32)
    assert len(g) == len(list(tmod.parameters())) and set(g) <= set(jg)
    top = max(float(np.abs(jg[k]).max()) for k in g)
    for k in g:
        np.testing.assert_allclose(
            g[k], jg[k], rtol=0, err_msg='grad ' + k,
            atol=2e-5 * float(np.abs(jg[k]).max()) + 1e-6 * top)
    for k in u:
        np.testing.assert_allclose(u[k], ju[k], err_msg=k, **F32)


# ---------------------------------------------------------------------------
# Conv, pooling, BatchNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('kernel,stride,padding,hw', [
    (3, 1, 'SAME', (9, 10)), (3, 2, 'SAME', (9, 10)), (3, 2, 'SAME', (8, 8)),
    (3, 1, 'VALID', (9, 10)), (3, 2, 'VALID', (9, 10)),
    ((1, 7), 1, 'SAME', (9, 10)), ((7, 1), 1, 'SAME', (9, 10)),
    (7, 2, 'SAME', (16, 16)), (1, 2, 'SAME', (9, 10))])
def test_conv_matches_jax(kernel, stride, padding, hw):
    """Asymmetric XLA 'SAME' padding included: 3x3/2 at 8 pads 0/1 and
    7x7/2 at 16 pads 2/3."""
    jc = jv.Conv(5, 8, kernel, stride, padding, use_bias=True)
    tc = tv.Conv(5, 8, kernel, stride, padding, use_bias=True, device='cpu')
    jp = _pair(jc, tc)
    x = _images((2,) + hw + (5,))
    cy = _images(jc.apply(jp, jnp.asarray(x)).shape, seed=1)
    jy, jvjp = jax.vjp(lambda p, x_: jc.apply(p, x_), jp, jnp.asarray(x))
    jgp, jgx = jvjp(jnp.asarray(cy))
    tx = torch.from_numpy(x).requires_grad_()
    y = tc.apply(tc.params(), tx)
    assert y.is_contiguous()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **F32)
    (y * torch.from_numpy(cy)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **F32)
    _assert_close_rel(_grads(tc), _flat(jgp), 1e-5)


@pytest.mark.parametrize('padding,hw', [('SAME', (16, 16)), ('SAME', (15, 17)),
                                        ('VALID', (16, 16)),
                                        ('VALID', (15, 17))])
def test_space_to_depth_stem_matches_jax(padding, hw, monkeypatch):
    monkeypatch.setenv('AUTODIST_S2D_STEM', '1')
    jc = jv.Conv(3, 8, 7, 2, padding)
    tc = tv.Conv(3, 8, 7, 2, padding, device='cpu')
    jp = _pair(jc, tc)
    x = _images((2,) + hw + (3,))
    y = tc.apply(tc.params(), torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(y, np.asarray(jc.apply(jp, jnp.asarray(x))),
                               **F32)
    monkeypatch.setenv('AUTODIST_S2D_STEM', '0')
    plain = tc.apply(tc.params(), torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(y, plain, **F32)


@pytest.mark.parametrize('kind,args,hw', [
    ('max', (3, 2, 'SAME'), (9, 10)), ('max', (3, 2, 'SAME'), (8, 8)),
    ('max', (2, 2, 'SAME'), (7, 8)), ('max', (3, 2, 'VALID'), (9, 10)),
    ('avg', (2, 2, 'VALID'), (8, 9)), ('avg', (3, 1, 'SAME'), (7, 8)),
    ('global', (), (5, 6))])
def test_pooling_matches_jax(kind, args, hw):
    fns = {'max': (jv.max_pool, tv.max_pool), 'avg': (jv.avg_pool,
                                                      tv.avg_pool),
           'global': (jv.global_avg_pool, tv.global_avg_pool)}
    jf, tf = fns[kind]
    x = _images((2,) + hw + (4,))
    jy, jvjp = jax.vjp(lambda x_: jf(x_, *args), jnp.asarray(x))
    cy = _images(jy.shape, seed=1)
    tx = torch.from_numpy(x).requires_grad_()
    y = tf(tx, *args)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **F32)
    (y * torch.from_numpy(cy)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(),
                               np.asarray(jvjp(jnp.asarray(cy))[0]), **F32)


def test_batchnorm_training_with_ema_updates():
    jb, tb = jv.BatchNorm(6), tv.BatchNorm(6, device='cpu')
    jp = _pair(jb, tb)
    jp = dict(jp, ema_mean=np.full(6, 0.3, np.float32),
              ema_var=np.full(6, 2.0, np.float32))
    load_params(tb, jp)
    x = _images((3, 4, 5, 6)) * 2 + 1
    cy = _images((3, 4, 5, 6), seed=1)
    jx = jnp.asarray(x)
    tx = torch.from_numpy(x).requires_grad_()
    _check_train(
        jb, tb, jp, lambda m, p: jnp.sum(m.apply(p, jx) * cy),
        lambda m, p: (m.apply(p, tx) * torch.from_numpy(cy)).sum())
    # the input gradient, through the moments' closed-form backward
    jcore.assign_state_paths(jb)
    with jcore.model_mode(training=True):
        jgx = jax.grad(lambda x_: jnp.sum(jb.apply(jp, x_) * cy))(jx)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **F32)


def test_batchnorm_eval_uses_running_stats():
    jb, tb = jv.BatchNorm(6), tv.BatchNorm(6, device='cpu')
    jp = _pair(jb, tb)
    rng = np.random.RandomState(2)
    jp = dict(jp, ema_mean=rng.randn(6).astype(np.float32),
              ema_var=(rng.rand(6) + 0.5).astype(np.float32))
    load_params(tb, jp)
    x = _images((3, 4, 5, 6))
    with jcore.model_mode(training=False):
        want = np.asarray(jb.apply(jp, jnp.asarray(x)))
    core.assign_state_paths(tb)
    with core.model_mode(training=False) as mm:
        got = tb.apply(tb.params(), torch.from_numpy(x)).detach().numpy()
    assert not mm.updates
    np.testing.assert_allclose(got, want, **F32)


def test_state_leaves_are_buffers():
    tb = tv.BatchNorm(6, device='cpu')
    assert {n for n, _ in tb.named_parameters()} == {'scale', 'bias'}
    assert {n for n, _ in tb.named_buffers()} == {'ema_mean', 'ema_var'}
    assert tb.has_state() and not tv.Conv(3, 8, device='cpu').has_state()
    assert tb.trainable_mask() == jv.BatchNorm(6).trainable_mask()
    assert sorted(params_to_jax(tb)) == ['bias', 'ema_mean', 'ema_var',
                                         'scale']


# ---------------------------------------------------------------------------
# blocks, with the fused gate on and off
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('kernel,stride,relu', [(1, 1, True), (1, 2, False),
                                                (3, 1, True)])
def test_convbn_matches_jax(kernel, stride, relu, fused):
    jm = jv.ConvBn(16, 128, kernel, stride, relu=relu)
    tm = tv.ConvBn(16, 128, kernel, stride, relu=relu, device='cpu')
    jp = _pair(jm, tm)
    x = _images((2, 8, 8, 16))
    cy = _images((2, 8 // stride, 8 // stride, 128), seed=1)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    _check_train(jm, tm, jp, lambda m, p: jnp.sum(m.apply(p, jx) * cy),
                 lambda m, p: (m.apply(p, tx) * torch.from_numpy(cy)).sum())


@pytest.mark.parametrize('in_ch,stride', [(128, 1), (64, 2)],
                         ids=['identity', 'projection'])
def test_bottleneck_matches_jax(in_ch, stride, fused):
    jm = jv.Bottleneck(in_ch, 32, stride)
    tm = tv.Bottleneck(in_ch, 32, stride, device='cpu')
    assert (tm.proj is None) == (in_ch == 128)
    jp = _pair(jm, tm)
    x = _images((2, 8, 8, in_ch))
    cy = _images((2, 8 // stride, 8 // stride, 128), seed=1)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    _check_train(jm, tm, jp, lambda m, p: jnp.sum(m.apply(p, jx) * cy),
                 lambda m, p: (m.apply(p, tx) * torch.from_numpy(cy)).sum())


def _class_batch(b, hw, classes, seed=0):
    rng = np.random.RandomState(seed)
    return {'images': rng.randn(b, hw, hw, 3).astype(np.float32),
            'labels': rng.randint(0, classes, (b,)).astype(np.int32)}


def _check_model(jm, tm, batch):
    """Logits, then loss, gradients and EMA updates of a training step."""
    jp = _pair(jm, tm)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want = np.asarray(jm.apply(jp, jb['images']))
    got = tm.apply(tm.params(), tb['images']).detach().numpy()
    np.testing.assert_allclose(got, want, **F32)
    _check_train(jm, tm, jp, lambda m, p: m.loss(p, jb),
                 lambda m, p: m.loss(p, tb))


def test_small_resnet_matches_jax(fused, monkeypatch):
    """Logits, loss, every gradient and every EMA update of
    ``ResNet((1, 1), num_classes=10)``; with the gate on, block 0 takes
    the unfused Bottleneck with conv-c and the projection fused by
    ConvBn's own gate, block 1 the fused Bottleneck."""
    calls = []
    real = cb.fused_pointwise
    monkeypatch.setattr(cb, 'fused_pointwise',
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    batch = _class_batch(4, 32, 10)
    _check_model(jv.ResNet((1, 1), num_classes=10),
                 tv.ResNet((1, 1), num_classes=10, device='cpu'), batch)
    # 5 per forward (block 0: conv-c and the projection; block 1: a, c
    # and the projection), run twice: plain, then training
    assert len(calls) == (10 if fused else 0)


def test_densenet_reduced_matches_jax(fused):
    """DenseNet((2, 2), growth=32) at 32 px: with the gate on, every dense
    layer's conv1 rides the kernel with bn1's fold as its prologue."""
    batch = _class_batch(2, 32, 10)
    _check_model(jv.DenseNet((2, 2), growth=32, num_classes=10),
                 tv.DenseNet((2, 2), growth=32, num_classes=10,
                             device='cpu'), batch)


def test_densenet_buffer_form_matches_jax(monkeypatch):
    monkeypatch.setenv('AUTODIST_DENSENET_DUS', '1')
    batch = _class_batch(2, 32, 10, seed=1)
    _check_model(jv.DenseNet((2, 2), growth=32, num_classes=10),
                 tv.DenseNet((2, 2), growth=32, num_classes=10,
                             device='cpu'), batch)


def test_vgg_custom_cfg_matches_jax():
    cfg = (8, 'M', 16, 'M')
    batch = _class_batch(2, 16, 10)
    jm = jv.VGG(cfg, num_classes=10, fc_spatial=4)
    tm = tv.VGG(cfg, num_classes=10, fc_spatial=4, device='cpu')
    jp = _pair(jm, tm)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jl, jg = jax.value_and_grad(jm.loss)(jp, jb)
    loss = tm.loss(tm.params(), tb)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), **F32)
    _assert_close_rel(_grads(tm), _flat(jg), 2e-5)
    with pytest.raises(ValueError, match='fc_spatial'):
        bad = tv.VGG(cfg, num_classes=10, fc_spatial=3, device='cpu')
        bad.apply(bad.params(), tb['images'])


def test_inception_v3_forward_matches_jax():
    """Eval mode (running statistics): at 75 px the last blocks run at
    1 x 1 spatial size, where batch statistics over two images turn
    every channel into +-1 and flip on rounding-level differences, so a
    training-mode forward compares nothing but that sign. Running
    statistics keep the comparison about the blocks: 1e-4 of the largest
    logit through 94 convs."""
    batch = _class_batch(2, 75, 10)
    jm = jv.InceptionV3(num_classes=10)
    tm = tv.InceptionV3(num_classes=10, device='cpu')
    jp = _pair(jm, tm)
    with jcore.model_mode(training=False):
        want = np.asarray(jm.apply(jp, jnp.asarray(batch['images'])))
    with torch.no_grad(), core.model_mode(training=False):
        got = tm.apply(tm.params(), torch.from_numpy(batch['images']))
    assert got.shape == (2, 10)
    _assert_close_rel({'logits': got.numpy()}, {'logits': want}, 1e-4)
    with pytest.raises(ValueError, match='75x75'):
        tm.apply(tm.params(), torch.zeros(1, 64, 64, 3))


# ---------------------------------------------------------------------------
# ResNet-101's fused calls per forward: the JAX model's shape trace
# against the port's own dispatch (meta tensors, no arithmetic)
# ---------------------------------------------------------------------------

def _jax_fused_calls(batch, monkeypatch):
    calls = []

    def counted(x, w, *a, stride=1, **k):
        calls.append(1)
        b, h, ww, _ = x[:, ::stride, ::stride].shape
        c = w.shape[1]
        return (jnp.zeros((b, h, ww, c), x.dtype), jnp.zeros(c),
                jnp.zeros(c))
    monkeypatch.setattr(jcb, 'fused_pointwise', counted)
    model = jv.ResNet.resnet101(dtype=jnp.bfloat16)
    images = jax.ShapeDtypeStruct((batch, 224, 224, 3), jnp.float32)
    jax.eval_shape(lambda: model.apply(model.init(jax.random.PRNGKey(0)),
                                       jnp.zeros(images.shape)))
    return len(calls)


def _port_fused_calls(batch, monkeypatch):
    calls = []

    def counted(x, w, *a, stride=1, **k):
        calls.append(1)
        b, h, ww, _ = x[:, ::stride, ::stride].shape
        c = w.shape[1]
        return (x.new_empty((b, h, ww, c)), w.new_empty(c), w.new_empty(c))
    monkeypatch.setattr(cb, 'fused_pointwise', counted)
    model = tv.ResNet.resnet101(dtype=torch.bfloat16, device='meta')
    model.apply(model.params(), torch.empty((batch, 224, 224, 3),
                                            device='meta'))
    return len(calls)


@pytest.mark.parametrize('batch,calls', [(256, 53), (128, 62)])
def test_resnet101_fused_calls_per_forward(batch, calls, monkeypatch):
    monkeypatch.setenv('AUTODIST_FUSED_CONV', '1')
    assert _port_fused_calls(batch, monkeypatch) == calls
    assert _jax_fused_calls(batch, monkeypatch) == calls
