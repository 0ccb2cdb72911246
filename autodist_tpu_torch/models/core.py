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

A ``ParamDef(trainable=False)`` leaf (BatchNorm's running statistics) is
a registered *buffer*, not a parameter: the optimizer never sees it, yet
``params()`` and ``state_dict`` carry it under its JAX path, as the JAX
``init`` carries it in the params tree. It advances through the state
channel below (:func:`record_state_update`), as in the JAX package.
"""
import math
import threading
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.nn.functional import all_reduce
from torch.utils.checkpoint import checkpoint as torch_checkpoint

from autodist_tpu_torch.utils.device import resolve_device


@dataclass
class ParamDef:
    shape: tuple
    axes: tuple            # logical axis names, len == len(shape)
    init: str = 'normal'   # normal | zeros | ones | fan_in
    scale: float = 0.02
    # False = a STATE leaf (BatchNorm running stats): a buffer the
    # optimizer never touches; it advances via record_state_update.
    trainable: bool = True


class Module(nn.Module):
    """Base: parameters declared by ``param_defs()``.

    Subclasses create their submodules, then call :meth:`_register` to
    allocate their own leaves with the leading ``stack`` axes and to
    register every submodule under its ``param_defs()`` name (submodules
    held in lists need it; attributes named as in ``param_defs()`` are
    registered by ``nn.Module`` already)."""

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
        """Allocate this module's own leaves (parameters, or buffers for
        state leaves) and register its submodules under their
        ``param_defs`` names, which are their JAX paths."""
        for name, d in self.param_defs().items():
            if isinstance(d, Module):
                self.add_module(name, d)
                continue
            t = torch.empty(self.stack + tuple(d.shape),
                            dtype=torch.float32, device=device)
            if d.trainable:
                self.register_parameter(name, nn.Parameter(t))
            else:
                self.register_buffer(name, t)

    def params(self):
        """Nested dict of this module's parameters and state buffers, by
        JAX path."""
        return {name: d.params() if isinstance(d, Module)
                else getattr(self, name)
                for name, d in sorted(self.param_defs().items())}

    def trainable_mask(self):
        """Bool tree mirroring ``params()``: False at state leaves."""
        return {name: (d.trainable_mask() if isinstance(d, Module)
                       else d.trainable)
                for name, d in sorted(self.param_defs().items())}

    def has_state(self):
        return not all(_leaves(self.trainable_mask()))

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


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# ---------------------------------------------------------------------------
# Model state (BatchNorm running stats)
#
# As in the JAX package: during the loss forward a collector is active,
# stateful modules call ``record_state_update(module, name, value)``, and
# the trainer writes the recorded values into the state buffers after the
# optimizer step. Paths are stamped on module instances once per trainer
# (``assign_state_paths``). The collector also carries the data-parallel
# process group of the step, so BatchNorm can reduce its moments over the
# whole data-parallel batch (``reduce_over_batch``).
# ---------------------------------------------------------------------------
_MODEL_CTX = threading.local()


class _StateCollector:
    def __init__(self, training, group, world):
        self.training = training
        self.group = group
        self.world = world
        self.updates = {}    # path tuple -> new value (detached)


class _resumed:
    """Context: make ``col`` the active collector again (the backward's
    recompute runs on another thread, and after the forward's context
    has closed)."""

    def __init__(self, col):
        self.col = col

    def __enter__(self):
        stack = getattr(_MODEL_CTX, 'stack', None)
        if stack is None:
            stack = _MODEL_CTX.stack = []
        stack.append(self.col)

    def __exit__(self, *exc):
        _MODEL_CTX.stack.pop()


class model_mode(_resumed):
    """Context: set training/eval mode and collect state updates during a
    forward. ``group``/``world`` name the data-parallel group whose ranks
    each hold a slice of the batch (``world`` 1: no collective)."""

    def __init__(self, training=True, group=None, world=1):
        super().__init__(_StateCollector(training, group, world))

    @property
    def updates(self):
        return self.col.updates

    def __enter__(self):
        super().__enter__()
        return self


def _collector():
    stack = getattr(_MODEL_CTX, 'stack', None)
    return stack[-1] if stack else None


def is_training():
    """True outside any model_mode context (benchmark semantics)."""
    col = _collector()
    return True if col is None else col.training


def reduce_over_batch(t):
    """Sum ``t`` over the data-parallel group of the active step, with a
    differentiable all-reduce (its backward sums the cotangents over the
    ranks); ``t`` itself outside a step or with one rank. This is what
    makes a per-rank BatchNorm compute the JAX package's global-batch
    statistics."""
    col = _collector()
    if col is None or col.world <= 1:
        return t
    return all_reduce(t, group=col.group or dist.group.WORLD)


def mean_over_batch(t):
    """Mean of ``t`` over the data-parallel group of the active step, as
    a constant (no gradient flows through the collective); ``t`` itself
    outside a step or with one rank. The ranks hold equal slices, so the
    mean of their batch means is the global batch's: the JAX package's
    value, where GSPMD sees the whole batch."""
    col = _collector()
    if col is None or col.world <= 1:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=col.group or dist.group.WORLD)
    return t / col.world


def checkpoint(fn, *args, context_fn=None):
    """``torch.utils.checkpoint`` (non-reentrant) of ``fn(*args)``, whose
    recompute in the backward runs under the model mode active at this
    call, so a collective the forward ran over the data-parallel group
    (:func:`mean_over_batch`, :func:`reduce_over_batch`) runs again in
    the recompute. ``context_fn`` as in ``torch.utils.checkpoint``
    (selective policies). Without grad mode it just calls ``fn``."""
    if not torch.is_grad_enabled():
        return fn(*args)
    col = _collector()

    def run(*a):
        if col is None:
            return fn(*a)
        with _resumed(col):
            return fn(*a)
    kw = {} if context_fn is None else {'context_fn': context_fn}
    return torch_checkpoint(run, *args, use_reentrant=False, **kw)


def record_state_update(module, name, value):
    """Record a new value for state leaf ``name`` of ``module`` (no-op
    when no collector is active, e.g. plain benchmark forwards). The
    value is detached: state takes no gradient."""
    col = _collector()
    if col is None:
        return
    path = getattr(module, '_state_path', None)
    if path is None:
        raise ValueError(
            '%s has state but no assigned path — build it through a '
            'Trainer (assign_state_paths) to track running statistics'
            % type(module).__name__)
    col.updates[path + (name,)] = value.detach()


def assign_state_paths(module, prefix=(), _seen=None):
    """Walk the module tree once, stamping each submodule with its param
    path so state updates can be written back by position. A stateful
    instance may occupy only one tree position (one stamped path cannot
    name two); stateless instances may be shared."""
    if _seen is None:
        _seen = set()
    if id(module) in _seen and module.has_state():
        raise ValueError(
            'stateful module %s appears at multiple tree positions '
            '(%s and %s); give each position its own instance so its '
            'running statistics have a unique home'
            % (type(module).__name__, module._state_path, prefix))
    _seen.add(id(module))
    module._state_path = prefix
    for name, d in module.param_defs().items():
        if isinstance(d, Module):
            assign_state_paths(d, prefix + (name,), _seen)


@torch.no_grad()
def apply_tree_updates(tree, updates):
    """Write ``{path tuple: value}`` into the leaves of ``tree`` (a
    ``params()`` tree), IN PLACE: the leaves are the model's own state
    buffers, so the model advances without a copy of its tree (the JAX
    package returns a new tree instead). Returns ``tree``."""
    for path, value in updates.items():
        node = tree
        for key in path[:-1]:
            node = node[key]
        node[path[-1]].copy_(value)
    return tree


class Sequential(Module):
    """Compose modules; params keyed ``layer_000``, ``layer_001``, ...
    (the JAX ``Sequential``'s keys). Each layer keeps its own device."""

    def __init__(self, layers):
        super().__init__()
        self.layers = list(layers)
        for name, m in self.param_defs().items():
            self.add_module(name, m)

    def param_defs(self):
        return {'layer_%03d' % i: m for i, m in enumerate(self.layers)}

    def apply(self, params, x, **kw):
        for i, m in enumerate(self.layers):
            x = m.apply(params['layer_%03d' % i], x, **kw)
        return x


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
