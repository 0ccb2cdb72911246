"""ImageNet CNN family of the port: ResNet, VGG, DenseNet, Inception.

The counterpart of ``autodist_tpu/models/vision.py``, with its parameter
paths and its layout: activations are NHWC and conv kernels HWIO at every
public function, so parity tests compare like with like. A conv runs
through cuDNN on the NCHW *view* of the NHWC tensor (``permute(0, 3, 1,
2)`` of a contiguous NHWC tensor is a channels_last NCHW tensor, so no
layout copy is made) and its output permutes back to contiguous NHWC.
``'SAME'`` padding follows XLA: low = total // 2, high = total - low,
which is asymmetric at stride 2 (the 7x7 stem at 224 pads 2/3); the port
pads explicitly where the two differ, and ``max_pool`` pads with -inf.

BatchNorm is written out, not ``F.batch_norm``: var = max(E[x^2] -
E[x]^2, 0) from f32 moments, a = scale * rsqrt(var + eps), b = bias -
mean * a, and the apply step ``x * a + b`` in the model dtype. Running
means and (biased) variances are state buffers updated as m * ema + (1 -
m) * stat with m = 0.9 through the Trainer's state channel
(:func:`~autodist_tpu_torch.models.core.record_state_update`). The
moments of one rank's slice are summed over the data-parallel group
(:func:`~autodist_tpu_torch.models.core.reduce_over_batch`), which is
what the JAX package's GSPMD data parallelism computes.

``AUTODIST_FUSED_CONV=1`` sends eligible 1x1 convs to the fused conv +
BatchNorm kernel (:mod:`autodist_tpu_torch.kernels.conv_bn`), under the
JAX package's gates and defaults (off; row ceiling
``AUTODIST_FUSED_CONV_MAX_ROWS`` = 120000). Those defaults were chosen on
a TPU; the H100's own crossover is a measurement (``PERF.md``), not a
change of default.
"""
import torch
import torch.nn.functional as F

from autodist_tpu_torch.const import ENV
from autodist_tpu_torch.kernels import conv_bn
from autodist_tpu_torch.models.core import (Dense, Module, ParamDef,
                                            is_training, record_state_update,
                                            reduce_over_batch)
from autodist_tpu_torch.utils.device import resolve_device


def _s2d_stem_enabled():
    """``AUTODIST_S2D_STEM=1``: the stride-2 stem in space-to-depth form
    (default off, as in the JAX package)."""
    return ENV.AUTODIST_S2D_STEM.val


def _densenet_dus_enabled():
    """``AUTODIST_DENSENET_DUS=1``: DenseNet blocks built in a
    preallocated buffer (see ``DenseNet._apply_dus``)."""
    return ENV.AUTODIST_DENSENET_DUS.val


def _pads(spatial, window, stride, padding):
    """((low, high) per spatial dim) of XLA's ``'SAME'`` / ``'VALID'``."""
    if padding == 'VALID':
        return tuple((0, 0) for _ in spatial)
    if padding != 'SAME':
        raise ValueError('padding %r: only SAME and VALID' % (padding,))
    out = []
    for n, k, s in zip(spatial, window, stride):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        out.append((total // 2, total - total // 2))
    return tuple(out)


def _pad_nhwc(x, pads, value=0.0):
    (ht, hb), (wl, wr) = pads
    if ht == hb == wl == wr == 0:
        return x
    return F.pad(x, (0, 0, wl, wr, ht, hb), value=value)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(y):
    return y.permute(0, 2, 3, 1).contiguous()


def _conv_nhwc(x, kernel, stride, padding):
    """NHWC x HWIO conv with XLA's padding, through cuDNN on the
    channels_last view."""
    pads = _pads(x.shape[1:3], kernel.shape[:2], stride, padding)
    if all(lo == hi for lo, hi in pads):
        pad = tuple(lo for lo, _ in pads)
    else:
        x, pad = _pad_nhwc(x, pads), (0, 0)
    return _nhwc(F.conv2d(_nchw(x), kernel.permute(3, 2, 0, 1),
                          stride=stride, padding=pad))


def space_to_depth_conv(x, kernel, stride=2, padding='SAME'):
    """Stride-2 conv computed in space-to-depth form: numerically the
    same window set as a ceil(k/2) x ceil(k/2) stride-1 conv on the 2x2
    space-to-depth input (C -> 4C) with rearranged weights. ``kernel`` is
    the original [kh, kw, C, O]; stride must be 2."""
    assert stride == 2 and padding in ('SAME', 'VALID')
    n, h, w, c = x.shape
    kh, kw, _, o = kernel.shape
    if padding == 'SAME':
        out_h, out_w = -(-h // 2), -(-w // 2)
        pl_h = max((out_h - 1) * 2 + kh - h, 0) // 2
        pl_w = max((out_w - 1) * 2 + kw - w, 0) // 2
    else:
        out_h, out_w = (h - kh) // 2 + 1, (w - kw) // 2 + 1
        pl_h = pl_w = 0
    kh2, kw2 = -(-kh // 2) * 2, -(-kw // 2) * 2
    in_h, in_w = (out_h - 1) * 2 + kh2, (out_w - 1) * 2 + kw2
    if in_h - pl_h < h:
        x = x[:, :in_h - pl_h]
    if in_w - pl_w < w:
        x = x[:, :, :in_w - pl_w]
    x = _pad_nhwc(x, ((pl_h, max(in_h - x.shape[1] - pl_h, 0)),
                      (pl_w, max(in_w - x.shape[2] - pl_w, 0))))
    k = F.pad(kernel, (0, 0, 0, 0, 0, kw2 - kw, 0, kh2 - kh))
    x = x.reshape(n, in_h // 2, 2, in_w // 2, 2, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(n, in_h // 2, in_w // 2, 4 * c)
    k = k.reshape(kh2 // 2, 2, kw2 // 2, 2, c, o)
    k = k.permute(0, 2, 1, 3, 4, 5).reshape(kh2 // 2, kw2 // 2, 4 * c, o)
    return _conv_nhwc(x, k, (1, 1), 'VALID')


class Conv(Module):
    """NHWC conv, HWIO kernel."""

    def __init__(self, in_ch, out_ch, kernel=3, stride=1, padding='SAME',
                 use_bias=False, dtype=torch.float32, device=None):
        super().__init__()
        self.in_ch, self.out_ch = in_ch, out_ch
        # ``kernel`` names the parameter; the window is ``kernel_size``
        self.kernel_size = (kernel, kernel) if isinstance(kernel, int) \
            else tuple(kernel)
        self.stride = (stride, stride) if isinstance(stride, int) \
            else tuple(stride)
        self.padding = padding
        self.use_bias = use_bias
        self.dtype = dtype
        self._register(resolve_device(device))

    def param_defs(self):
        d = {'kernel': ParamDef(self.kernel_size + (self.in_ch, self.out_ch),
                                (None, None, None, None), 'fan_in')}
        if self.use_bias:
            d['bias'] = ParamDef((self.out_ch,), (None,), 'zeros')
        return d

    def apply(self, params, x):
        x = x.to(self.dtype)
        k = params['kernel'].to(self.dtype)
        if (self.stride == (2, 2) and self.padding in ('SAME', 'VALID') and
                self.in_ch <= 4 and _s2d_stem_enabled()):
            y = space_to_depth_conv(x, k, padding=self.padding)
        else:
            y = _conv_nhwc(x, k, self.stride, self.padding)
        if self.use_bias:
            y = y + params['bias'].to(self.dtype)
        return y


class _Moments(torch.autograd.Function):
    """(sum x, sum x^2) per channel (last axis) over every other axis, in
    f32. Saves only x, in its own dtype: autodiff of ``x.float()**2``
    would keep an f32 copy of every BatchNorm input. Backward: dx =
    d1 + 2 x d2 in f32, cast once (the closed form autodiff of the JAX
    moments gives)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        xf = x.float().reshape(-1, x.shape[-1])
        return xf.sum(0), (xf * xf).sum(0)

    @staticmethod
    def backward(ctx, d1, d2):
        x, = ctx.saved_tensors
        return (d1 + 2.0 * x.float() * d2).to(x.dtype)


def _batch_moments(s1, s2, n):
    """(E[x], E[x^2]) over the whole data-parallel batch from this rank's
    sums over its ``n`` rows."""
    c = s1.shape[0]
    s = reduce_over_batch(torch.cat([s1, s2, s1.new_full((1,), float(n))]))
    return s[:c] / s[2 * c], s[c:2 * c] / s[2 * c]


class BatchNorm(Module):
    """Batch normalization with running statistics.

    Training mode (the default outside any ``model_mode`` context)
    normalizes with batch statistics and, when a state collector is
    active, records EMA updates of mean/var into the ``ema_mean`` /
    ``ema_var`` buffers. Eval mode (``model_mode(training=False)``)
    normalizes with the running statistics."""

    def __init__(self, ch, eps=1e-5, momentum=0.9, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.ch, self.eps, self.dtype = ch, eps, dtype
        self.momentum = momentum
        self._register(resolve_device(device))

    def param_defs(self):
        return {'scale': ParamDef((self.ch,), (None,), 'ones'),
                'bias': ParamDef((self.ch,), (None,), 'zeros'),
                'ema_mean': ParamDef((self.ch,), (None,), 'zeros',
                                     trainable=False),
                'ema_var': ParamDef((self.ch,), (None,), 'ones',
                                    trainable=False)}

    def coeffs_from_moments(self, params, mean, m2):
        """Folded (a, b) from the first and second raw moments (from a
        reduction over the activation or from the fused kernel's
        epilogue); records the EMA updates."""
        var = torch.clamp_min(m2 - torch.square(mean), 0.0)
        m = self.momentum
        record_state_update(
            self, 'ema_mean', m * params['ema_mean'] + (1 - m) * mean)
        record_state_update(
            self, 'ema_var', m * params['ema_var'] + (1 - m) * var)
        a = params['scale'] * torch.rsqrt(var + self.eps)
        b = params['bias'] - mean * a
        return a, b

    def coeffs(self, params, x):
        """(a, b) such that the normalized output is ``x * a + b``."""
        if is_training():
            s1, s2 = _Moments.apply(x)
            return self.coeffs_from_moments(
                params, *_batch_moments(s1, s2, x.numel() // x.shape[-1]))
        a = params['scale'] * torch.rsqrt(params['ema_var'] + self.eps)
        b = params['bias'] - params['ema_mean'] * a
        return a, b

    def apply(self, params, x):
        a, b = self.coeffs(params, x)
        return x.to(self.dtype) * a.to(self.dtype) + b.to(self.dtype)


def max_pool(x, window=3, stride=2, padding='SAME'):
    pads = _pads(x.shape[1:3], (window, window), (stride, stride), padding)
    x = _pad_nhwc(x, pads, value=float('-inf'))
    return _nhwc(F.max_pool2d(_nchw(x), window, stride))


def avg_pool(x, window, stride=1, padding='VALID'):
    """Window sum over zero padding, divided by window^2 (padding counts,
    as in the JAX package)."""
    pads = _pads(x.shape[1:3], (window, window), (stride, stride), padding)
    return _nhwc(F.avg_pool2d(_nchw(_pad_nhwc(x, pads)), window, stride))


def global_avg_pool(x):
    return x.mean(dim=(1, 2))


def _fused_conv_enabled():
    """Fused-pointwise dispatch gate: ``AUTODIST_FUSED_CONV=1`` opts in to
    the fused conv + BatchNorm kernel; default off, as in the JAX
    package (whose default was set by a TPU measurement)."""
    return ENV.AUTODIST_FUSED_CONV.val


def _fused_max_rows():
    """Row-count ceiling for the fused kernel (0 = no limit); the JAX
    package's default, kept for dispatch parity."""
    return ENV.AUTODIST_FUSED_CONV_MAX_ROWS.val


def _fused_pointwise_ok(conv, x):
    if conv.kernel_size != (1, 1) or conv.use_bias:
        return False
    sh, sw = conv.stride
    if sh != sw:   # fused_pointwise subsamples both dims by one stride
        return False
    b, h, w, _ = x.shape
    h, w = -(-h // sh), -(-w // sw)
    rows = b * h * w
    limit = _fused_max_rows()
    if limit and rows > limit:
        return False
    return conv_bn.supports(rows, conv.in_ch, conv.out_ch)


def _fold(y, a, b, dt, relu=False, add=None):
    """The deferred BN epilogue ``relu?(y * a + b (+ add))`` as one
    elementwise pass in the model dtype."""
    out = y.to(dt) * a.to(dt) + b.to(dt)
    if add is not None:
        out = out + add
    return torch.relu(out) if relu else out


def _pointwise_raw_coeffs(conv, bn, conv_params, bn_params, x,
                          prologue=None):
    """Fused 1x1 conv through the kernel: RAW conv output + the FOLLOWING
    BatchNorm's folded (a, b). ``prologue=(scale, bias, relu?)`` is the
    PREVIOUS BatchNorm's fold, applied on the way into the product.
    Moments come from the kernel's epilogue (training) or the EMAs
    (eval)."""
    training = is_training()
    kern = conv_params['kernel'].reshape(conv.in_ch, conv.out_ch)
    scale, bias, prelu = (None, None, False) if prologue is None \
        else prologue
    y, s1, s2 = conv_bn.fused_pointwise(
        x.to(conv.dtype), kern, scale=scale, bias=bias,
        prologue_relu=prelu, want_stats=training, stride=conv.stride[0])
    if training:
        n = y.shape[0] * y.shape[1] * y.shape[2]
        a, b = bn.coeffs_from_moments(bn_params, *_batch_moments(s1, s2, n))
    else:
        a, b = bn.coeffs(bn_params, y)
    return y, (a, b)


class ConvBn(Module):
    """conv + BN + optional relu."""

    def __init__(self, in_ch, out_ch, kernel=3, stride=1, relu=True,
                 padding='SAME', dtype=torch.float32, device=None):
        super().__init__()
        self.conv = Conv(in_ch, out_ch, kernel, stride, padding,
                         dtype=dtype, device=device)
        self.bn = BatchNorm(out_ch, dtype=dtype, device=device)
        self.relu = relu

    def param_defs(self):
        return {'conv': self.conv, 'bn': self.bn}

    def apply(self, params, x):
        if _fused_conv_enabled() and _fused_pointwise_ok(self.conv, x):
            y, (a, b) = self.raw_coeffs(params, x)
            return _fold(y, a, b, self.conv.dtype, relu=self.relu)
        y = self.bn.apply(params['bn'], self.conv.apply(params['conv'], x))
        return torch.relu(y) if self.relu else y

    # -- fused (deferred-normalize) protocol ------------------------------
    def raw_coeffs(self, params, x, prologue=None):
        """``(y_raw, (a, b))``: the caller applies ``relu?(y * a + b)``
        itself, usually in the NEXT conv's prologue. 1x1 convs the gate
        admits ride the fused kernel; others take cuDNN + a reduction."""
        if _fused_pointwise_ok(self.conv, x):
            return _pointwise_raw_coeffs(self.conv, self.bn, params['conv'],
                                         params['bn'], x, prologue)
        if prologue is not None:
            scale, bias, prelu = prologue
            x = _fold(x, scale, bias, self.conv.dtype, relu=prelu)
        y = self.conv.apply(params['conv'], x)
        return y, self.bn.coeffs(params['bn'], y)


# ---------------------------------------------------------------------------
# ResNet (v1.5 bottleneck; resnet50/101/152)
# ---------------------------------------------------------------------------

class Bottleneck(Module):
    expansion = 4

    def __init__(self, in_ch, width, stride=1, dtype=torch.float32,
                 device=None):
        super().__init__()
        out_ch = width * self.expansion
        kw = dict(dtype=dtype, device=device)
        self.a = ConvBn(in_ch, width, 1, 1, **kw)
        self.b = ConvBn(width, width, 3, stride, **kw)
        self.c = ConvBn(width, out_ch, 1, 1, relu=False, **kw)
        self.proj = None
        if stride != 1 or in_ch != out_ch:
            self.proj = ConvBn(in_ch, out_ch, 1, stride, relu=False, **kw)
        self.out_ch = out_ch

    def param_defs(self):
        d = {'a': self.a, 'b': self.b, 'c': self.c}
        if self.proj is not None:
            d['proj'] = self.proj
        return d

    def apply(self, params, x):
        if _fused_conv_enabled() and _fused_pointwise_ok(self.a.conv, x):
            return self._apply_fused(params, x)
        sc = x if self.proj is None else self.proj.apply(params['proj'], x)
        y = self.a.apply(params['a'], x)
        y = self.b.apply(params['b'], y)
        y = self.c.apply(params['c'], y)
        return torch.relu(y + sc)

    def _apply_fused(self, params, x):
        """The two 1x1 convs ride the fused kernel: their BN moments come
        from its epilogue, and bn2's normalize + ReLU runs in conv-c's
        prologue. What is left: bn1's apply into the 3x3's input, bn2's
        moments, and one residual-add epilogue."""
        dt = self.a.conv.dtype
        y1, (a1, b1) = self.a.raw_coeffs(params['a'], x)
        y1n = _fold(y1, a1, b1, dt, relu=True)
        y2, (a2, b2) = self.b.raw_coeffs(params['b'], y1n)
        y3, (a3, b3) = self.c.raw_coeffs(params['c'], y2,
                                         prologue=(a2, b2, True))
        if self.proj is None:
            sc = x.to(dt)
        else:
            ysc, (asc, bsc) = self.proj.raw_coeffs(params['proj'], x)
            sc = _fold(ysc, asc, bsc, dt)
        return _fold(y3, a3, b3, dt, relu=True, add=sc)


def _softmax_xent(logits, labels):
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (logz - gold).mean()


class _Classifier(Module):
    """A top-level image model: initializes itself from ``seed`` on its
    device, and its loss is the mean softmax cross-entropy of
    ``batch['images']`` (NHWC) against ``batch['labels']``."""

    def _finish(self, seed):
        self._register(None)
        self.reset_parameters(torch.Generator().manual_seed(seed))

    def loss(self, params, batch):
        return _softmax_xent(self.apply(params, batch['images']),
                             batch['labels'])


class ResNet(_Classifier):
    """ResNet-v1.5; stage_sizes (3,4,23,3) = ResNet-101."""

    def __init__(self, stage_sizes, num_classes=1000, dtype=torch.float32,
                 device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        kw = dict(dtype=dtype, device=device)
        self.stem = ConvBn(3, 64, 7, 2, **kw)
        self.blocks = []
        in_ch = 64
        for stage, n in enumerate(stage_sizes):
            width = 64 * (2 ** stage)
            for i in range(n):
                stride = 2 if (i == 0 and stage > 0) else 1
                blk = Bottleneck(in_ch, width, stride, **kw)
                self.blocks.append(blk)
                in_ch = blk.out_ch
        self.head = Dense(in_ch, num_classes, 'embed', 'classes', **kw)
        self._finish(seed)

    @classmethod
    def resnet50(cls, **kw):
        return cls((3, 4, 6, 3), **kw)

    @classmethod
    def resnet101(cls, **kw):
        return cls((3, 4, 23, 3), **kw)

    @classmethod
    def resnet152(cls, **kw):
        return cls((3, 8, 36, 3), **kw)

    def param_defs(self):
        d = {'stem': self.stem, 'head': self.head}
        for i, b in enumerate(self.blocks):
            d['block_%03d' % i] = b
        return d

    def apply(self, params, x):
        y = self.stem.apply(params['stem'], x)
        y = max_pool(y, 3, 2)
        for i, b in enumerate(self.blocks):
            y = b.apply(params['block_%03d' % i], y)
        y = global_avg_pool(y)
        return self.head.apply(params['head'], y).float()


# ---------------------------------------------------------------------------
# VGG16
# ---------------------------------------------------------------------------

class VGG(_Classifier):
    CFG16 = (64, 64, 'M', 128, 128, 'M', 256, 256, 256, 'M',
             512, 512, 512, 'M', 512, 512, 512, 'M')

    def __init__(self, cfg=CFG16, num_classes=1000, dtype=torch.float32,
                 fc_spatial=7, device=None, seed=0):
        """``fc_spatial`` is the spatial size after the conv stack (7 for
        CFG16 at 224 px); the fixed-size fc head is sized from it."""
        super().__init__()
        device = resolve_device(device)
        kw = dict(dtype=dtype, device=device)
        self.cfg = cfg
        self.fc_spatial = fc_spatial
        self.convs = []
        in_ch = 3
        for v in cfg:
            if v == 'M':
                continue
            self.convs.append(Conv(in_ch, v, 3, 1, use_bias=True, **kw))
            in_ch = v
        self.fc1 = Dense(in_ch * fc_spatial * fc_spatial, 4096, 'embed',
                         'mlp', **kw)
        self.fc2 = Dense(4096, 4096, 'mlp', 'mlp', **kw)
        self.head = Dense(4096, num_classes, 'mlp', 'classes', **kw)
        self._finish(seed)

    @classmethod
    def vgg16(cls, **kw):
        return cls(cls.CFG16, **kw)

    def param_defs(self):
        d = {'fc1': self.fc1, 'fc2': self.fc2, 'head': self.head}
        for i, c in enumerate(self.convs):
            d['conv_%02d' % i] = c
        return d

    def apply(self, params, x):
        ci = 0
        y = x
        for v in self.cfg:
            if v == 'M':
                y = max_pool(y, 2, 2)
            else:
                y = torch.relu(
                    self.convs[ci].apply(params['conv_%02d' % ci], y))
                ci += 1
        if y.shape[1] != self.fc_spatial:
            raise ValueError(
                'VGG conv stack produced %dx%d spatial but the fc head '
                'was sized for %dx%d; pass fc_spatial=%d for this '
                'cfg/resolution' % (y.shape[1], y.shape[2],
                                    self.fc_spatial, self.fc_spatial,
                                    y.shape[1]))
        y = y.reshape(y.shape[0], -1)
        y = torch.relu(self.fc1.apply(params['fc1'], y))
        y = torch.relu(self.fc2.apply(params['fc2'], y))
        return self.head.apply(params['head'], y).float()


# ---------------------------------------------------------------------------
# DenseNet121
# ---------------------------------------------------------------------------

class DenseLayer(Module):
    def __init__(self, in_ch, growth, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.bn1 = BatchNorm(in_ch, **kw)
        self.conv1 = Conv(in_ch, 4 * growth, 1, **kw)
        self.bn2 = BatchNorm(4 * growth, **kw)
        self.conv2 = Conv(4 * growth, growth, 3, **kw)

    def param_defs(self):
        return {'bn1': self.bn1, 'conv1': self.conv1,
                'bn2': self.bn2, 'conv2': self.conv2}

    def growth_out(self, params, x):
        """The layer's NEW features only ([..., growth], no concat). With
        the gate on, conv1 rides the fused kernel with bn1's fold as its
        prologue (the kernel's second call site)."""
        if _fused_conv_enabled() and _fused_pointwise_ok(self.conv1, x):
            dt = self.conv1.dtype
            a1, b1 = self.bn1.coeffs(params['bn1'], x)
            y, (a2, b2) = _pointwise_raw_coeffs(
                self.conv1, self.bn2, params['conv1'], params['bn2'], x,
                prologue=(a1, b1, True))
            yn = _fold(y, a2, b2, dt, relu=True)
            return self.conv2.apply(params['conv2'], yn)
        y = self.conv1.apply(params['conv1'], torch.relu(
            self.bn1.apply(params['bn1'], x)))
        return self.conv2.apply(params['conv2'], torch.relu(
            self.bn2.apply(params['bn2'], y)))

    def apply(self, params, x):
        return torch.cat([x, self.growth_out(params, x)], dim=-1)


class DenseNet(_Classifier):
    """DenseNet-BC; block config (6,12,24,16) = DenseNet-121."""

    def __init__(self, block_cfg=(6, 12, 24, 16), growth=32,
                 num_classes=1000, dtype=torch.float32, device=None,
                 seed=0):
        super().__init__()
        device = resolve_device(device)
        kw = dict(dtype=dtype, device=device)
        self.stem = ConvBn(3, 2 * growth, 7, 2, **kw)
        ch = 2 * growth
        self.layers = []   # ('dense', layer) / ('trans', conv)
        for bi, n in enumerate(block_cfg):
            for _ in range(n):
                self.layers.append(('dense', DenseLayer(ch, growth, **kw)))
                ch += growth
            if bi != len(block_cfg) - 1:
                self.layers.append(('trans', ConvBn(ch, ch // 2, 1, **kw)))
                ch //= 2
        self.bn_f = BatchNorm(ch, **kw)
        self.head = Dense(ch, num_classes, 'embed', 'classes', **kw)
        self._finish(seed)

    @classmethod
    def densenet121(cls, **kw):
        return cls((6, 12, 24, 16), **kw)

    def param_defs(self):
        d = {'stem': self.stem, 'bn_f': self.bn_f, 'head': self.head}
        for i, (_, m) in enumerate(self.layers):
            d['layer_%03d' % i] = m
        return d

    def apply(self, params, x):
        y = self.stem.apply(params['stem'], x)
        y = max_pool(y, 3, 2)
        if _densenet_dus_enabled():
            return self._apply_dus(params, y)
        for i, (kind, m) in enumerate(self.layers):
            y = m.apply(params['layer_%03d' % i], y)
            if kind == 'trans':
                y = avg_pool(y, 2, 2, 'VALID')
        return self._head(params, y)

    def _head(self, params, y):
        y = torch.relu(self.bn_f.apply(params['bn_f'], y))
        y = global_avg_pool(y)
        return self.head.apply(params['head'], y).float()

    def _apply_dus(self, params, y):
        """Dense blocks in a buffer of the block's final width, each layer
        writing only its ``growth`` new channels
        (``AUTODIST_DENSENET_DUS=1``); numerically the concat form. The
        writes are out of place (``slice_scatter``): the layers' saved
        inputs are views of the buffer, which autograd forbids writing
        in place, so the port keeps the form, not its copy saving."""
        i = 0
        n = len(self.layers)
        while i < n:
            kind, m = self.layers[i]
            if kind == 'trans':
                y = m.apply(params['layer_%03d' % i], y)
                y = avg_pool(y, 2, 2, 'VALID')
                i += 1
                continue
            run = 0
            while i + run < n and self.layers[i + run][0] == 'dense':
                run += 1
            ch = y.shape[-1]
            growth = self.layers[i][1].conv2.out_ch
            growths = [self.layers[i + j][1].conv2.out_ch
                       for j in range(run)]
            if any(g != growth for g in growths):
                raise ValueError(
                    'AUTODIST_DENSENET_DUS requires every dense layer '
                    'in a block to share conv2.out_ch (growth); got %s '
                    'for layers %d..%d — use the concat form for '
                    'heterogeneous growth' % (growths, i, i + run - 1))
            buf = y.new_zeros(y.shape[:-1] + (ch + growth * run,))
            buf = buf.slice_scatter(y, dim=-1, start=0, end=ch)
            for j in range(run):
                _, layer = self.layers[i + j]
                new = layer.growth_out(params['layer_%03d' % (i + j)],
                                       buf[..., :ch])
                buf = buf.slice_scatter(new.to(buf.dtype), dim=-1,
                                        start=ch, end=ch + growth)
                ch += growth
            y = buf
            i += run
        return self._head(params, y)


# ---------------------------------------------------------------------------
# InceptionV3 (standard 299x299 stem)
# ---------------------------------------------------------------------------

class InceptionBlock(Module):
    """Parallel towers concatenated on channels. Each tower is a list of
    ConvBn specs (out_ch, kernel, stride, padding); ``pool_ch`` adds an
    avg-pool + 1x1 tower (param key ``pool``)."""

    def __init__(self, in_ch, towers, pool_ch=0, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.towers = []
        for tower in towers:
            mods, ch = [], in_ch
            for (out_ch, kernel, stride, padding) in tower:
                mods.append(ConvBn(ch, out_ch, kernel, stride,
                                   padding=padding, **kw))
                ch = out_ch
            self.towers.append(mods)
        self.pool_ch = pool_ch
        if pool_ch:
            self.pool = ConvBn(in_ch, pool_ch, 1, **kw)
        self.out_ch = sum(t[-1][0] for t in towers) + pool_ch
        self._register(None)

    def param_defs(self):
        d = {}
        for ti, mods in enumerate(self.towers):
            for mi, m in enumerate(mods):
                d['t%d_%d' % (ti, mi)] = m
        if self.pool_ch:
            d['pool'] = self.pool
        return d

    def apply(self, params, x):
        outs = []
        for ti, mods in enumerate(self.towers):
            y = x
            for mi, m in enumerate(mods):
                y = m.apply(params['t%d_%d' % (ti, mi)], y)
            outs.append(y)
        if self.pool_ch:
            p = avg_pool(x, 3, 1, 'SAME')
            outs.append(self.pool.apply(params['pool'], p))
        return torch.cat(outs, dim=-1)


def _c(out, k=1, s=1, p='SAME'):
    return (out, k, s, p)


class InceptionV3(_Classifier):
    def __init__(self, num_classes=1000, dtype=torch.float32, device=None,
                 seed=0):
        super().__init__()
        d = dict(dtype=dtype, device=resolve_device(device))
        self.stem = [ConvBn(3, 32, 3, 2, padding='VALID', **d),
                     ConvBn(32, 32, 3, 1, padding='VALID', **d),
                     ConvBn(32, 64, 3, 1, **d),
                     ConvBn(64, 80, 1, 1, padding='VALID', **d),
                     ConvBn(80, 192, 3, 1, padding='VALID', **d)]
        blocks = []
        ch = 192
        for pool_ch in (32, 64, 64):  # 3x inception-A
            b = InceptionBlock(ch, [[_c(64)],
                                    [_c(48), _c(64, 5)],
                                    [_c(64), _c(96, 3), _c(96, 3)]],
                               pool_ch, **d)
            blocks.append(('b', b))
            ch = b.out_ch
        grid = InceptionBlock(ch, [[_c(384, 3, 2, 'VALID')],
                                   [_c(64), _c(96, 3),
                                    _c(96, 3, 2, 'VALID')]], 0, **d)
        blocks.append(('g', grid))
        ch = grid.out_ch + ch  # the pool branch keeps the input channels
        for mid in (128, 160, 160, 192):  # 4x inception-B (7x1/1x7)
            b = InceptionBlock(
                ch, [[_c(192)],
                     [_c(mid), _c(mid, (1, 7)), _c(192, (7, 1))],
                     [_c(mid), _c(mid, (7, 1)), _c(mid, (1, 7)),
                      _c(mid, (7, 1)), _c(192, (1, 7))]],
                192, **d)
            blocks.append(('b', b))
            ch = b.out_ch
        grid2 = InceptionBlock(ch, [[_c(192), _c(320, 3, 2, 'VALID')],
                                    [_c(192), _c(192, (1, 7)),
                                     _c(192, (7, 1)),
                                     _c(192, 3, 2, 'VALID')]], 0, **d)
        blocks.append(('g', grid2))
        ch = grid2.out_ch + ch
        for _ in range(2):  # 2x inception-C
            b = InceptionBlock(ch, [[_c(320)],
                                    [_c(384), _c(384, (1, 3))],
                                    [_c(448), _c(384, 3), _c(384, (3, 1))]],
                               192, **d)
            blocks.append(('b', b))
            ch = b.out_ch
        self.blocks = blocks
        self.head = Dense(ch, num_classes, 'embed', 'classes', **d)
        self._finish(seed)

    def param_defs(self):
        d = {'head': self.head}
        for i, m in enumerate(self.stem):
            d['stem_%d' % i] = m
        for i, (_, m) in enumerate(self.blocks):
            d['inc_%02d' % i] = m
        return d

    def apply(self, params, x):
        if x.shape[1] < 75 or x.shape[2] < 75:
            # below this the grid reductions reach zero spatial size
            raise ValueError('InceptionV3 needs inputs >= 75x75, got '
                             '%dx%d' % (x.shape[1], x.shape[2]))
        y = x
        for i, m in enumerate(self.stem):
            y = m.apply(params['stem_%d' % i], y)
            if i == 2:
                y = max_pool(y, 3, 2, 'VALID')
        y = max_pool(y, 3, 2, 'VALID')
        for i, (kind, m) in enumerate(self.blocks):
            if kind == 'g':
                pooled = max_pool(y, 3, 2, 'VALID')
                y = torch.cat([m.apply(params['inc_%02d' % i], y), pooled],
                              dim=-1)
            else:
                y = m.apply(params['inc_%02d' % i], y)
        y = global_avg_pool(y)
        return self.head.apply(params['head'], y).float()
