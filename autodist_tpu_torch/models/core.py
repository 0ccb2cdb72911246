"""Minimal module system for the port's model zoo.

The counterpart of ``autodist_tpu/models/core.py``. A module declares its
parameters with ``param_defs()`` -> {name: ParamDef | Module}, as in the
JAX package, and registers them under the same names, so a parameter's
``state_dict`` key is its JAX pytree path with ``.`` for ``/``
(``blocks.attn.qkv.kernel``). ``apply(params, ...)`` stays a function of
a params dict, which is what lets stacked layers (``stack=(n,)``, the
JAX ``_Stacked``) hand one layer's slice to a shared block; ``forward``
applies the module's own parameters.

Params are f32 master weights, cast to the compute dtype at use.
Modules take an explicit ``device`` (the card unless the caller names
another, see :mod:`autodist_tpu_torch.utils.device`) and initialize from
a ``torch.Generator`` (:meth:`Module.reset_parameters`): the port's
random numbers are its own, and parity tests carry the JAX package's
params across with :mod:`autodist_tpu_torch.models.weights`.
"""
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from autodist_tpu_torch.utils.device import resolve_device


@dataclass
class ParamDef:
    shape: tuple
    axes: tuple            # logical axis names, len == len(shape)
    init: str = 'normal'   # normal | zeros | ones | fan_in
    scale: float = 0.02


class Module(nn.Module):
    """Base: parameters declared by ``param_defs()``.

    Subclasses create their submodules as attributes named as in
    ``param_defs()``, then call :meth:`_register` to allocate their own
    leaf parameters with the leading ``stack`` axes."""

    def __init__(self, stack=()):
        super().__init__()
        self.stack = tuple(stack)

    def param_defs(self):
        raise NotImplementedError

    def apply(self, params, *args, **kwargs):
        raise NotImplementedError

    def forward(self, *args, **kwargs):
        return self.apply(self.params(), *args, **kwargs)

    def _register(self, device):
        for name, d in self.param_defs().items():
            if isinstance(d, ParamDef):
                self.register_parameter(name, nn.Parameter(torch.empty(
                    self.stack + tuple(d.shape), dtype=torch.float32,
                    device=device)))

    def params(self):
        """Nested dict of this module's parameters, by JAX path."""
        return {name: d.params() if isinstance(d, Module)
                else getattr(self, name)
                for name, d in sorted(self.param_defs().items())}

    def axes(self):
        """Logical axes of every parameter; stacked ones lead with
        ``'stage'`` as in the JAX ``_Stacked``."""
        lead = ('stage',) * len(self.stack)
        return {name: d.axes() if isinstance(d, Module)
                else lead + tuple(d.axes)
                for name, d in sorted(self.param_defs().items())}

    @torch.no_grad()
    def reset_parameters(self, generator):
        """Initialize every parameter below this module from
        ``generator`` (a CPU ``torch.Generator``, so a seed gives the same
        weights on every device)."""
        for name, d in sorted(self.param_defs().items()):
            if isinstance(d, Module):
                d.reset_parameters(generator)
                continue
            p = getattr(self, name)
            if d.init == 'zeros':
                p.zero_()
            elif d.init == 'ones':
                p.fill_(1.0)
            else:
                std = d.scale
                if d.init == 'fan_in':
                    # fan-in = product of all non-output dims of one
                    # (unstacked) param
                    std = 1.0 / math.sqrt(max(math.prod(d.shape[:-1])
                                              if len(d.shape) > 1
                                              else d.shape[0], 1))
                p.copy_(torch.randn(p.shape, generator=generator) * std)


class Dense(Module):
    """y = x @ w + b, computed in ``dtype``."""

    def __init__(self, in_dim, out_dim, in_axis='embed', out_axis='mlp',
                 use_bias=True, dtype=torch.float32, device=None, stack=()):
        super().__init__(stack)
        self.in_dim, self.out_dim = in_dim, out_dim
        self.in_axis, self.out_axis = in_axis, out_axis
        self.use_bias = use_bias
        self.dtype = dtype
        self._register(resolve_device(device))

    def param_defs(self):
        d = {'kernel': ParamDef((self.in_dim, self.out_dim),
                                (self.in_axis, self.out_axis), 'fan_in')}
        if self.use_bias:
            d['bias'] = ParamDef((self.out_dim,), (self.out_axis,), 'zeros')
        return d

    def apply(self, params, x):
        y = x.to(self.dtype) @ params['kernel'].to(self.dtype)
        if self.use_bias:
            y = y + params['bias'].to(self.dtype)
        return y


class Embedding(Module):
    """Token embedding; ``attend`` is the tied output head."""

    def __init__(self, vocab, dim, vocab_axis='vocab', dim_axis='embed',
                 dtype=torch.float32, device=None, stack=()):
        super().__init__(stack)
        self.vocab, self.dim = vocab, dim
        self.vocab_axis, self.dim_axis = vocab_axis, dim_axis
        self.dtype = dtype
        self._register(resolve_device(device))

    def param_defs(self):
        return {'table': ParamDef((self.vocab, self.dim),
                                  (self.vocab_axis, self.dim_axis),
                                  'normal', 0.02)}

    def apply(self, params, ids):
        return F.embedding(ids, params['table'].to(self.dtype))

    def attend(self, params, x):
        """Tied-output logits: x @ table.T"""
        return x @ params['table'].to(self.dtype).T


class LayerNorm(Module):
    """LayerNorm in f32 (eps 1e-6), output in ``dtype``."""

    def __init__(self, dim, axis_name='embed', eps=1e-6,
                 dtype=torch.float32, device=None, stack=()):
        super().__init__(stack)
        self.dim, self.axis_name, self.eps = dim, axis_name, eps
        self.dtype = dtype
        self._register(resolve_device(device))

    def param_defs(self):
        return {'scale': ParamDef((self.dim,), (self.axis_name,), 'ones'),
                'bias': ParamDef((self.dim,), (self.axis_name,), 'zeros')}

    def apply(self, params, x):
        y = F.layer_norm(x.float(), (self.dim,), params['scale'],
                         params['bias'], self.eps)
        return y.to(self.dtype)


class Mlp(Module):
    """Transformer MLP: up, tanh-approximate GELU (``jax.nn.gelu``'s
    default), down."""

    def __init__(self, dim, hidden, dtype=torch.float32, device=None,
                 stack=()):
        super().__init__(stack)
        self.up = Dense(dim, hidden, 'embed', 'mlp', dtype=dtype,
                        device=device, stack=stack)
        self.down = Dense(hidden, dim, 'mlp', 'embed', dtype=dtype,
                          device=device, stack=stack)

    def param_defs(self):
        return {'up': self.up, 'down': self.down}

    def apply(self, params, x):
        h = F.gelu(self.up.apply(params['up'], x), approximate='tanh')
        return self.down.apply(params['down'], h)
