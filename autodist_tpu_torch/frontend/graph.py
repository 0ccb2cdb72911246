"""Symbolic capture frontend.

The counterpart of ``autodist_tpu/frontend/graph.py``: a *minimal
symbolic tensor DSL* captured while user code runs inside
``ad.scope()``:

- :class:`Placeholder`, :class:`Variable` reads, :class:`Const` and generic
  lifted-torch :class:`Op` nodes form a DAG;
- :class:`Gradients` nodes capture ``ad.gradients(loss, vars)`` requests;
- optimizer ``apply_gradients`` creates an :class:`ApplyGradients` train-op
  node and records grad→target pairs on the graph (same bookkeeping the
  reference does via monkey-patching);
- at session time the DAG is *interpreted eagerly* on this replica's
  tensors (:func:`evaluate`); gradients come from ``torch.autograd``
  over leaf tensors made from the variables' values. PyTorch has no
  trace to compile, so the interpretation runs every step.
"""
import itertools
import threading

import operator

import numpy as np
import torch

_GRAPH_STACK = threading.local()


def _stack():
    if not hasattr(_GRAPH_STACK, 'stack'):
        _GRAPH_STACK.stack = []
    return _GRAPH_STACK.stack


def get_default_graph():
    """Return the innermost active Graph, creating a global one if needed."""
    stack = _stack()
    if not stack:
        stack.append(Graph())
    return stack[-1]


class Graph:
    """A captured symbolic program: nodes, variables, grad→target pairs."""

    def __init__(self):
        self._name_counter = itertools.count()
        self.variables = {}            # name -> Variable
        self.nodes = []
        self.grad_target_pairs = {}    # grad node -> Variable
        self.optimizers = []           # captured (class, args, kwargs)
        self.savers = []               # registered Saver objects

    def unique_name(self, prefix):
        return '%s_%d' % (prefix, next(self._name_counter))

    def register_variable(self, var):
        if var.name in self.variables:
            raise ValueError('Duplicate variable name %r' % var.name)
        self.variables[var.name] = var

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()

    def as_default(self):
        return self


class SymTensor:
    """Base class for all symbolic nodes. Supports numpy-style operators."""

    def __init__(self, shape=None, dtype=None, name=None):
        self.graph = get_default_graph()
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.name = name or self.graph.unique_name(type(self).__name__)
        self.graph.nodes.append(self)

    # -- operator sugar ---------------------------------------------------
    def _binop(self, fn, other, reverse=False):
        a, b = (other, self) if reverse else (self, other)
        return Op(fn, [a, b])

    def __add__(self, o):
        return self._binop(operator.add, o)

    def __radd__(self, o):
        return self._binop(operator.add, o, True)

    def __sub__(self, o):
        return self._binop(operator.sub, o)

    def __rsub__(self, o):
        return self._binop(operator.sub, o, True)

    def __mul__(self, o):
        return self._binop(operator.mul, o)

    def __rmul__(self, o):
        return self._binop(operator.mul, o, True)

    def __truediv__(self, o):
        return self._binop(operator.truediv, o)

    def __rtruediv__(self, o):
        return self._binop(operator.truediv, o, True)

    def __pow__(self, o):
        return self._binop(operator.pow, o)

    def __matmul__(self, o):
        return self._binop(operator.matmul, o)

    def __rmatmul__(self, o):
        return self._binop(operator.matmul, o, True)

    def __neg__(self):
        return Op(operator.neg, [self])

    def __getitem__(self, idx):
        return Op(lambda x: x[idx], [self])

    @property
    def T(self):  # noqa: N802 - numpy-style transpose property
        return Op(_transpose, [self])

    def __repr__(self):
        return '<%s %r shape=%s>' % (type(self).__name__, self.name,
                                     self.shape)


class Placeholder(SymTensor):
    """Feedable input; polymorphic batch dim expressed as None."""

    def __init__(self, shape=None, dtype=np.float32, name=None):
        super().__init__(shape, dtype, name)


class Const(SymTensor):
    """Embedded constant value."""

    def __init__(self, value, name=None):
        value = np.asarray(value)
        super().__init__(value.shape, value.dtype, name)
        self.value = value


class Op(SymTensor):
    """Generic lifted op: ``fn(*inputs, **kwargs)`` where inputs may mix
    SymTensors and python literals."""

    def __init__(self, fn, inputs, kwargs=None, name=None):
        super().__init__(None, None, name)
        self.fn = fn
        self.inputs = list(inputs)
        self.kwargs = kwargs or {}


class VariableRead(SymTensor):
    """Read of a Variable's current value at step entry."""

    def __init__(self, variable):
        super().__init__(variable.init_value.shape,
                         variable.init_value.dtype,
                         variable.name + '/read')
        self.variable = variable


class Gradients(SymTensor):
    """``ad.gradients(loss, sources)``: list-valued node.

    Evaluated by re-interpreting the loss subgraph on leaf tensors made
    from the source variables' values and calling
    ``torch.autograd.grad`` — the analogue of the reference's reliance
    on TF's symbolic autodiff.
    """

    def __init__(self, loss, sources, name=None):
        super().__init__(None, None, name)
        self.loss = loss
        self.sources = list(sources)
        self._slices = None

    def __iter__(self):
        if self._slices is None:
            self._slices = [GradientSlice(self, i)
                            for i in range(len(self.sources))]
        return iter(self._slices)

    def __len__(self):
        return len(self.sources)


class GradientSlice(SymTensor):
    """The i-th output of a Gradients node."""

    def __init__(self, grads, index):
        super().__init__(None, None,
                         '%s/grad_%d' % (grads.name, index))
        self.grads = grads
        self.index = index


class ApplyGradients(SymTensor):
    """Train op: applying an optimizer update to variables.

    Mirrors the reference's optimizer-capture: creating this node records
    grad→target pairs on the graph (graph_item.py:93-109) and the optimizer
    spec (graph_item.py:73-90) for the strategy layer to inspect.
    """

    def __init__(self, optimizer, grads_and_vars, name=None):
        super().__init__((), None, name or
                         get_default_graph().unique_name('ApplyGradients'))
        self.optimizer = optimizer
        self.grads_and_vars = list(grads_and_vars)
        g = self.graph
        for grad, var in self.grads_and_vars:
            g.grad_target_pairs[grad] = var


class Variable:
    """A mutable training parameter.

    Not itself a node: arithmetic on it reads the current value via a
    :class:`VariableRead`. State lives in the Session.
    """

    def __init__(self, initial_value, name=None, trainable=True,
                 dtype=None):
        self.graph = get_default_graph()
        init = np.asarray(initial_value, dtype=dtype)
        if init.dtype == np.float64:
            init = init.astype(np.float32)  # the JAX package's default
        self.init_value = init
        self.name = name or self.graph.unique_name('Variable')
        self.trainable = trainable
        # Set when the variable is consumed by an embedding lookup — the
        # analogue of the reference's IndexedSlices-gradient detection
        # (partitioned_ps_strategy.py / parallax_strategy.py sparse checks).
        self.sparse_read = False
        # The id-tensor nodes of those lookups: lets the sync layer ship
        # (indices, rows) instead of the dense vocab-sized gradient (the
        # IndexedSlices equivalent, reference partitioner.py:660-684).
        # lookup_ops are the gather Op nodes themselves, used to prove the
        # variable has no OTHER (dense) consumers before the sparse wire
        # is allowed — a dense use contributes gradient to rows outside
        # the looked-up set, which the sparse wire would drop.
        self.lookup_ids = []
        self.lookup_ops = []
        self.graph.register_variable(self)
        self._read = None

    @property
    def shape(self):
        return self.init_value.shape

    @property
    def dtype(self):
        return self.init_value.dtype

    @property
    def nbytes(self):
        return int(self.init_value.nbytes)

    def read(self):
        if self._read is None:
            self._read = VariableRead(self)
        return self._read

    # operator sugar delegates to the read node
    def __add__(self, o):
        return self.read() + o

    def __radd__(self, o):
        return o + self.read()

    def __sub__(self, o):
        return self.read() - o

    def __rsub__(self, o):
        return o - self.read()

    def __mul__(self, o):
        return self.read() * o

    def __rmul__(self, o):
        return o * self.read()

    def __truediv__(self, o):
        return self.read() / o

    def __rtruediv__(self, o):
        return o / self.read()

    def __pow__(self, o):
        return self.read() ** o

    def __matmul__(self, o):
        return self.read() @ o

    def __rmatmul__(self, o):
        return o @ self.read()

    def __neg__(self):
        return -self.read()

    def __getitem__(self, idx):
        return self.read()[idx]

    @property
    def T(self):  # noqa: N802
        return self.read().T

    def __repr__(self):
        return '<Variable %r shape=%s dtype=%s>' % (
            self.name, self.shape, self.dtype)


def placeholder(shape=None, dtype=np.float32, name=None):
    """Create a feedable input node (parity with tf.placeholder)."""
    return Placeholder(shape, dtype, name)


def gradients(loss, sources):
    """Symbolic gradients of ``loss`` w.r.t. ``sources`` (Variables)."""
    for s in sources:
        if not isinstance(s, Variable):
            raise TypeError('gradients sources must be Variables, got %r'
                            % (s,))
    return Gradients(loss, sources)


# ---------------------------------------------------------------------------
# Evaluation: interpret the DAG eagerly on torch tensors.
# ---------------------------------------------------------------------------

class Env:
    """One evaluation environment: variable values + feeds + memo table."""

    def __init__(self, var_values, feeds, grad_sync_fn=None,
                 opt_state=None, aux_state=None):
        self.var_values = var_values      # {var name: tensor}
        self.feeds = feeds                # {Placeholder node: tensor}
        self.memo = {}
        # Hook applied to the full evaluated gradient list of a Gradients
        # node: ``fn(sources, grads, env) -> synced grads``. The strategy
        # compiler injects per-variable synchronization here (all-reduce
        # / compressor / bucketed collectives / reduce-scatter) over the
        # replica group.
        self.grad_sync_fn = grad_sync_fn
        self.opt_state = opt_state or {}  # {optimizer uid: slot pytree}
        self.aux_state = aux_state or {}  # e.g. compressor residuals
        self.var_shards = {}              # local shards of ZeRO-sharded vars
        self.updates = {}                 # {var name: new value}
        self.opt_updates = {}             # {optimizer uid: new slot pytree}
        self.aux_updates = {}             # {aux key: new value}
        self.plan = None                  # the ExecutionPlan, when run
        self.device = None                # where Const values go


def evaluate(node, env):
    """Interpret one node under ``env`` (memoized)."""
    if isinstance(node, Variable):
        node = node.read()
    key = id(node)
    if key in env.memo:
        return env.memo[key]
    out = _eval(node, env)
    env.memo[key] = out
    return out


def _resolve(x, env):
    if isinstance(x, (SymTensor, Variable)):
        return _degrade(evaluate(x, env))
    if isinstance(x, (list, tuple)):
        return type(x)(_resolve(v, env) for v in x)
    return x


def _degrade(val):
    """Materialize framework wrappers before generic ops consume them.

    A ZeRO-sharded gradient (parallel.plan.ShardedGrad) stays a shard on
    the ApplyGradients fast path, but user arithmetic on it (grad-norm
    clipping etc.) needs the full array — gather without disturbing the
    memoized shard."""
    if isinstance(val, list):
        return [_degrade(v) for v in val]
    return val.gather() if getattr(val, 'is_sharded_value', False) else val


def _eval(node, env):
    if isinstance(node, Placeholder):
        if node not in env.feeds:
            raise KeyError('Placeholder %r was not fed' % node.name)
        return env.feeds[node]
    if isinstance(node, Const):
        return torch.as_tensor(node.value, device=env.device)
    if isinstance(node, VariableRead):
        return env.var_values[node.variable.name]
    if isinstance(node, Op):
        args = [_resolve(a, env) for a in node.inputs]
        kwargs = {k: _resolve(v, env) for k, v in node.kwargs.items()}
        return node.fn(*args, **kwargs)
    if isinstance(node, Gradients):
        return _eval_gradients(node, env)
    if isinstance(node, GradientSlice):
        return evaluate(node.grads, env)[node.index]
    if isinstance(node, ApplyGradients):
        return _eval_apply(node, env)
    raise TypeError('Cannot evaluate node %r' % (node,))


def _eval_gradients(node, env):
    names = [v.name for v in node.sources]
    leaves = [env.var_values[n].detach().requires_grad_(True)
              for n in names]
    sub = dict(env.var_values)
    sub.update(zip(names, leaves))
    sub_env = Env(sub, env.feeds, None, env.opt_state, env.aux_state)
    sub_env.plan, sub_env.device = env.plan, env.device
    with torch.enable_grad():
        loss = evaluate(node.loss, sub_env)
        if loss.dtype not in (torch.float32, torch.float64):
            loss = loss.to(torch.float32)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # Share the forward pass with a direct fetch of the loss node.
    env.memo.setdefault(id(node.loss), loss.detach())
    grads = [torch.zeros_like(v) if g is None else g
             for v, g in zip(leaves, grads)]
    if env.grad_sync_fn is not None:
        grads = env.grad_sync_fn(node.sources, grads, env)
    return grads


def _eval_apply(node, env):
    gv = []
    for grad, var in node.grads_and_vars:
        gv.append((evaluate(grad, env), var))
    new_values = node.optimizer._apply(gv, env)
    # weight-update-sharded variables come back as UpdateShards (each
    # replica updated its 1/n); re-gather whole buckets at once — one
    # collective per scatter bucket, the gather half of the schedule
    # (parallel.plan.ExecutionPlan.gather_updated_params)
    pending = {var: val for var, val in new_values.items()
               if getattr(val, 'is_update_shard', False)}
    if pending:
        plan = next(iter(pending.values())).plan
        gathered = plan.gather_updated_params(
            {var.name: val for var, val in pending.items()})
        for var in pending:
            new_values[var] = gathered[var.name]
    for var, val in new_values.items():
        env.updates[var.name] = val
    return None  # train-op sentinel value (fetched as None)


def _transpose(x):
    """numpy's ``.T``: all axes reversed."""
    return x.permute(*reversed(range(x.dim())))
