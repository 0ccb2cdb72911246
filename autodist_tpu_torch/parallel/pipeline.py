"""Pipeline parallelism: GPipe and 1F1B microbatch schedules over the
pipe group.

The counterpart of ``autodist_tpu/parallel/pipeline.py``. The JAX package
runs every stage in one SPMD program, simulating the schedule with a
scan whose ``ppermute`` hops carry activations from stage to stage. The
port runs one process per device, so each rank of the pipe group (a
:class:`~autodist_tpu_torch.parallel.mesh.ReplicaGroup` whose positions
are the stages) runs its own schedule: its ``n_layers / pp`` layers on
each microbatch, the activations going forward and their gradients
backward by point-to-point (:meth:`ReplicaGroup.exchange`), and the
backward of each microbatch an explicit ``torch.autograd.backward(out,
grad)`` of that microbatch's graph.

Both schedules are differentiable functions of tensors, as the JAX
ones are: ``(out, aux)`` comes back from a ``torch.autograd.Function``
whose backward runs the schedule's backward half, so a caller takes any
loss of ``out`` and calls ``backward()`` on every rank. ``out`` is a
per-rank partial, as the JAX fused mode hands it out of its
``custom_vjp``: the last stage holds the output, every other stage zeros
of its shape, and the sum over the pipe group is the output; ``aux``
(the MoE load-balance loss, summed over a stage's layers) is this
stage's sum over the microbatches over ``M``, so the sum over the pipe
group is the JAX ``psum(aux) / M``: summed over the stages, averaged
over the microbatches (each microbatch is a routing group, the GShard
grouping, as in the JAX package). The backward takes the last stage's
cotangent of ``out`` (a loss replicated over the stages gives every
rank the same one) and each rank's cotangent of ``aux``.

- :func:`gpipe`: every microbatch's forward, keeping its graph, then
  every microbatch's backward: all ``M`` microbatches' activations are
  live at the turn (the GPipe memory profile). ``remat=True``
  checkpoints each microbatch's stage instead, so the turn holds only
  the stage inputs.
- :func:`one_f_one_b` with ``tail_params`` (the fused mode): the head
  (``head_fn``, the embedding) folds into the first stage and the tail
  (``tail_fn``, the head and loss) into the last, so what crosses the
  region is token-sized. The forward keeps no graph; the backward runs
  each microbatch's stage again, with its graph, before its backward.
  The variants (``variant=``):

  * ``'remat'``: the forward keeps nothing; the backward is the 1F1B
    schedule proper: the chain runs forward again (stage 0 embeds its
    tokens anew, every other stage receives its input anew) and each
    rank holds at most ``pp - stage`` microbatches in flight, their
    graphs, so its live activations are bounded by the pipe depth and do
    not grow with ``M``.
  * ``'stash'``: the forward keeps each microbatch's stage input (one
    full-batch hidden slab a rank past the first, the JAX stash); the
    backward recomputes each microbatch's stage from its stash right
    before that microbatch's backward, one graph live at a time, and no
    activation crosses forward again.
  * ``'auto'``: ``'stash'`` while the stash (``M`` boundary
    activations) fits ``AUTODIST_PP_STASH_LIMIT_MB``, else ``'remat'``,
    decided from the first stage's boundary shape as the JAX package
    decides it.

  Without ``tail_params`` and ``head_params`` (the legacy mode), the
  un-fused schedule: :func:`gpipe`'s, with a closure-style
  ``tail_fn(h, extra_mb)`` on the last stage (its parameters' gradients
  reach them through the closure). It gives the numbers of the
  un-fused schedule, as the JAX legacy 1F1B gives GPipe's.

``M`` may be anything that divides the batch, ``M < pp`` included: each
rank's schedule counts its own microbatches, so no residency slots need
padding. ``pp == 1`` (no group, or a group of one) is the plain
composition head, layers, tail, differentiated by autograd.
"""
import collections

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from autodist_tpu_torch.const import ENV
from autodist_tpu_torch.parallel.axes import resumed_step, step_context

VARIANTS = ('auto', 'remat', 'stash')
# dtypes a boundary tensor may have, by their index in the spec message
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int32, torch.int64)
_MAX_DIMS = 6


def unstack(tree):
    """Per-layer trees of views into stacked params (leading dim the
    layers). One ``unbind`` per leaf: its backward stacks the layers'
    grads in one op, where taking one layer at a time would add a
    zero-padded full-size grad per layer (O(L^2) memory traffic)."""
    leaves = {k: unstack(v) if isinstance(v, dict) else v.unbind(0)
              for k, v in tree.items()}
    n = len(next(iter(leaves.values())))
    return [{k: v[i] for k, v in leaves.items()} for i in range(n)]


def run_stack(block_fn, stacked_params, h):
    """``(h, aux)`` after this rank's layers: ``block_fn(layer_params, h)
    -> (h, aux or None)`` over the leading dim of ``stacked_params``;
    aux the layers' sum in f32, None when every layer gave None."""
    aux = None
    for layer in unstack(stacked_params):
        h, a = block_fn(layer, h)
        if a is not None:
            a = a.float()
            aux = a if aux is None else aux + a
    return h, aux


def _tree_leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    return [tree]


def _tree_build(tree, leaves):
    """``tree`` with its leaves replaced, in :func:`_tree_leaves` order."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        return next(it)
    return None if tree is None else walk(tree)


def _stages(group):
    return 1 if group is None else group.size


def _check_batch(x, M):
    if M < 1 or x.shape[0] % M:
        raise ValueError('pipeline: batch %d not divisible by microbatches '
                         '%d' % (x.shape[0], M))


def _spec(group, src, t):
    """(shape, dtype) of ``t``, a tensor on stage ``src``, on every stage:
    one broadcast of a small int64 message over the pipe group."""
    meta = torch.zeros(2 + _MAX_DIMS, dtype=torch.int64, device=group.device)
    if group.rank == src:
        meta[0] = _DTYPES.index(t.dtype)
        meta[1] = t.dim()
        meta[2:2 + t.dim()] = torch.tensor(t.shape)
    dist.broadcast(meta, group._global(src), group=group.group)
    meta = meta.tolist()
    return tuple(meta[2:2 + meta[1]]), _DTYPES[meta[0]]


def _backward(y, g, aux, aux_ct):
    """``torch.autograd.backward`` of one microbatch's output ``y`` with
    cotangent ``g`` and of its aux with ``aux_ct``."""
    tensors, grads = [], []
    if y.requires_grad:
        tensors.append(y)
        grads.append(g.to(y.dtype))
    if aux is not None and aux.requires_grad:
        tensors.append(aux)
        grads.append(aux_ct.to(aux.dtype).reshape(aux.shape))
    if tensors:
        torch.autograd.backward(tensors, grads)


class _Schedule:
    """One pipeline call on one rank: the stage's pieces, its trees'
    layouts, and the microbatching of ``x`` and ``extra``."""

    def __init__(self, block_fn, group, M, mode, head_fn, tail_fn,
                 closure_tail, trees, remat=False):
        self.block_fn, self.group, self.M, self.mode = (block_fn, group,
                                                        int(M), mode)
        self.head_fn, self.tail_fn = head_fn, tail_fn
        self.closure_tail = closure_tail
        self.trees = trees            # (stacked, tail, head) params trees
        self.counts = [len(_tree_leaves(t)) for t in trees]
        self.remat = remat
        self.p, self.P = group.rank, group.size
        self.first, self.last = self.p == 0, self.p == self.P - 1
        # the step's model mode, made active again in the backward, which
        # runs on autograd's thread
        self.col = step_context()
        self.h_spec = self.out_spec = None

    # -- the trees ----------------------------------------------------------
    def split(self, tensors):
        """(stacked, tail, head) trees, x and extra from the flat inputs."""
        out, i = [], 0
        for tree, n in zip(self.trees, self.counts):
            out.append(_tree_build(tree, tensors[i:i + n]))
            i += n
        return out + [tensors[i], tensors[i + 1]]

    # -- the pieces of a stage ----------------------------------------------
    def mb(self, t, j):
        n = t.shape[0] // self.M
        return t[j * n:(j + 1) * n]

    def head(self, hp, x_mb):
        return x_mb if self.head_fn is None else self.head_fn(hp, x_mb)

    def stage(self, sp, h):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(self._resumed_stack, sp, h,
                              use_reentrant=False)
        return run_stack(self.block_fn, sp, h)

    def _resumed_stack(self, sp, h):
        """:func:`run_stack` under the step's model mode, which a
        checkpoint's recompute needs (it runs in the backward)."""
        with resumed_step(self.col):
            return run_stack(self.block_fn, sp, h)

    def tail(self, tp, h, e_mb):
        if self.tail_fn is None:
            return h
        if self.closure_tail:
            return self.tail_fn(h, e_mb)
        return self.tail_fn(tp, h, e_mb)

    # -- point to point -----------------------------------------------------
    def h_buffer(self):
        """An empty boundary activation, to receive one into."""
        return torch.empty(self.h_spec[0], dtype=self.h_spec[1],
                           device=self.group.device)

    def recv_prev(self):
        return self.group.exchange(recvs=[(self.h_buffer(), self.p - 1)])[0]

    def send_next(self, y):
        self.group.exchange(sends=[(y.detach(), self.p + 1)])

    def recv_next(self, like):
        return self.group.exchange(
            recvs=[(torch.empty_like(like), self.p + 1)])[0]

    def send_prev(self, g):
        self.group.exchange(sends=[(g, self.p - 1)])

    def first_input(self, hp, x):
        """Stage 0's microbatch 0 through the head, and the boundary spec
        broadcast to every stage (once a call)."""
        h0 = self.head(hp, self.mb(x, 0)) if self.first else None
        if self.h_spec is None:
            self.h_spec = _spec(self.group, 0, h0)
        return h0

    def finish(self, outs, aux_sum, B):
        """The per-rank partial ``out`` (zeros of the last stage's shape
        elsewhere) and the stage's aux over ``M``."""
        y0 = outs[0] if self.last else None
        self.out_spec = _spec(self.group, self.P - 1, y0)
        if self.last:
            out = torch.cat(outs, 0)
        else:
            out = torch.zeros((B,) + self.out_spec[0][1:],
                              dtype=self.out_spec[1],
                              device=self.group.device)
        if aux_sum is None:
            aux = torch.zeros((), dtype=torch.float32,
                              device=self.group.device)
        else:
            aux = aux_sum / self.M
        return out, aux

    # -- forward without graphs ---------------------------------------------
    def forward_only(self, sp, tp, hp, x, e, stash=None):
        """Every microbatch forward with no graph; with ``stash`` (a
        list) each stage input past the first stage is kept there."""
        outs, aux_sum = [], None
        h0 = self.first_input(hp, x)
        for j in range(self.M):
            if self.first:
                h = h0 if j == 0 else self.head(hp, self.mb(x, j))
            else:
                h = self.recv_prev()
                if stash is not None:
                    stash.append(h)
            y, aux = self.stage(sp, h)
            if aux is not None:
                aux_sum = aux if aux_sum is None else aux_sum + aux
            if self.last:
                outs.append(self.tail(tp, y, self.mb(e, j)))
            else:
                self.send_next(y)
        return outs, aux_sum


def _leafs(tensors):
    """Detached copies of ``tensors`` as graph leaves (floating tensors
    that required grad keep requiring it)."""
    return [t.detach().requires_grad_(t.requires_grad and
                                      t.is_floating_point())
            for t in tensors]


class _Pipeline(torch.autograd.Function):
    """``(out, aux)`` of a schedule (``run``) over the flat inputs: the
    stacked, tail and head params' leaves, ``x`` and ``extra``. The
    backward hands back each input's gradient on this rank: this stage's
    layers', the tail params' on the last stage, the head params' and
    ``x``'s on the first (None where the rank did not use them)."""

    @staticmethod
    def forward(ctx, run, *tensors):
        ctx.run = run
        B = tensors[-2].shape[0]
        if run.mode == 'gpipe':
            return _gpipe_forward(ctx, run, tensors, B)
        sp, tp, hp, x, e = run.split(tensors)
        stash = [] if run.mode == 'stash' else None
        outs, aux_sum = run.forward_only(sp, tp, hp, x, e, stash)
        ctx.save_for_backward(*tensors, *(stash or []))
        return run.finish(outs, aux_sum, B)

    @staticmethod
    def backward(ctx, ct_out, ct_aux):
        run = ctx.run
        with resumed_step(run.col), torch.enable_grad():
            if run.mode == 'gpipe':
                grads = _gpipe_backward(ctx, run, ct_out, ct_aux)
            else:
                saved = ctx.saved_tensors
                n = sum(run.counts) + 2
                leaves = _leafs(saved[:n])
                if run.mode == 'stash':
                    grads = _stash_backward(run, leaves, list(saved[n:]),
                                            ct_out, ct_aux)
                else:
                    grads = _remat_backward(run, leaves, ct_out, ct_aux)
        return (None,) + tuple(grads)


def _grads(leaves):
    """Each leaf's gradient (None for ``extra`` and unused leaves)."""
    return [t.grad if t.requires_grad else None for t in leaves[:-1]] + \
        [None]


def _gpipe_forward(ctx, run, tensors, B):
    leaves = _leafs(tensors)
    sp, tp, hp, x, e = run.split(leaves)
    kept, outs, aux_sum = [], [], None
    with torch.enable_grad():
        h0 = run.first_input(hp, x)
        for j in range(run.M):
            if run.first:
                h_in = h0 if j == 0 else run.head(hp, run.mb(x, j))
            else:
                h_in = run.recv_prev().requires_grad_()
            y, aux = run.stage(sp, h_in)
            if run.last:
                y = run.tail(tp, y, run.mb(e, j))
                outs.append(y.detach())
            else:
                run.send_next(y)
            kept.append((h_in, y, aux))
            if aux is not None:
                aux_sum = aux.detach() if aux_sum is None else \
                    aux_sum + aux.detach()
    ctx.kept, ctx.leaves = kept, leaves
    return run.finish(outs, aux_sum, B)


def _gpipe_backward(ctx, run, ct_out, ct_aux):
    aux_ct = ct_aux / run.M
    for j in range(run.M):
        h_in, y, aux = ctx.kept[j]
        ctx.kept[j] = None
        g = run.mb(ct_out, j) if run.last else run.recv_next(y)
        _backward(y, g, aux, aux_ct)
        if not run.first:
            run.send_prev(h_in.grad)
    del ctx.kept
    return _grads(ctx.leaves)


def _stash_backward(run, leaves, stash, ct_out, ct_aux):
    """Each microbatch's stage again from its stash (stage 0: from its
    tokens through the head), its graph kept just for its backward."""
    sp, tp, hp, x, e = run.split(leaves)
    aux_ct = ct_aux / run.M
    for j in range(run.M):
        if run.first:
            h_in = run.head(hp, run.mb(x, j))
        else:
            h_in = stash[j].detach().requires_grad_()
            stash[j] = None
        y, aux = run.stage(sp, h_in)
        if run.last:
            y = run.tail(tp, y, run.mb(e, j))
            g = run.mb(ct_out, j)
        else:
            g = run.recv_next(y)
        _backward(y, g, aux, aux_ct)
        if not run.first:
            run.send_prev(h_in.grad)
    return _grads(leaves)


def _remat_backward(run, leaves, ct_out, ct_aux):
    """The 1F1B schedule (warm-up forwards, one forward and one backward
    a step, the cool-down backwards), its forwards the chain's second
    forward with graphs: stage ``s`` runs ``min(pp - s - 1, M)``
    forwards ahead, so at most ``pp - s`` microbatches are in flight. A
    step that sends an activation and receives a gradient (or the
    reverse) posts both in one exchange, as its peer does."""
    sp, tp, hp, x, e = run.split(leaves)
    aux_ct = ct_aux / run.M
    group, p, M = run.group, run.p, run.M
    flight = collections.deque()

    def forward(j, h_in):
        if run.first:
            h = run.head(hp, run.mb(x, j))
        else:
            h = h_in.requires_grad_()
        y, aux = run.stage(sp, h)
        if run.last:
            y = run.tail(tp, y, run.mb(e, j))
        flight.append((j, h_in, y, aux))
        return y

    def backward(g):
        j, h_in, y, aux = flight.popleft()
        if run.last:
            g = run.mb(ct_out, j)
        _backward(y, g, aux, aux_ct)
        return None if run.first else h_in.grad

    warm = min(run.P - p - 1, M)
    for j in range(warm):
        y = forward(j, None if run.first else run.recv_prev())
        run.send_next(y)
    steady = M - warm
    h_in = run.recv_prev() if steady and not run.first else None
    for i in range(steady):
        y = forward(warm + i, h_in)
        g = None
        if not run.last:
            g = group.exchange(sends=[(y.detach(), p + 1)],
                               recvs=[(torch.empty_like(y), p + 1)])[0]
        g_in = backward(g)
        h_in = None
        if not run.first:
            if i == steady - 1:
                run.send_prev(g_in)
            else:
                h_in = group.exchange(sends=[(g_in, p - 1)],
                                      recvs=[(run.h_buffer(), p - 1)])[0]
    for i in range(steady, M):
        g = None if run.last else run.recv_next(flight[0][2])
        g_in = backward(g)
        if not run.first:
            run.send_prev(g_in)
    return _grads(leaves)


def _run(run, stacked_params, tail_params, head_params, x, extra):
    """Apply the schedule: through :class:`_Pipeline` when a gradient is
    wanted, else the forward alone."""
    tensors = (_tree_leaves(stacked_params) + _tree_leaves(tail_params) +
               _tree_leaves(head_params) + [x, extra])
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _Pipeline.apply(run, *tensors)
    sp, tp, hp, x, e = run.split(tensors)
    outs, aux_sum = run.forward_only(sp, tp, hp, x, e)
    return run.finish(outs, aux_sum, x.shape[0])


def _dummy_extra(x):
    return torch.zeros((x.shape[0], 1), dtype=torch.int32, device=x.device)


def gpipe(block_fn, stacked_params, x, group, microbatches, remat=False):
    """Run a stage-sharded layer stack as a GPipe pipeline.

    Args:
        block_fn: ``block_fn(layer_params, h) -> (h, aux or None)``, one
            layer; ``aux`` a scalar auxiliary loss (the MoE balance
            loss) summed over the layers.
        stacked_params: this stage's params tree, leading dim its layers.
        x: [batch, ...] the input (only the first stage's is read).
        group: the pipe group (positions are stages), or None.
        microbatches: M, which must divide the batch.
        remat: checkpoint each microbatch's stage (the forward saves only
            its input; the backward recomputes it).

    Returns:
        ``(out, aux)``: the last stage's [batch, ...] output (zeros of
        its shape on every other stage) and this stage's aux over M (see
        the module docstring)."""
    M = int(microbatches)
    _check_batch(x, M)
    if _stages(group) == 1:
        h, aux = run_stack(block_fn, stacked_params, x)
        return h, aux if aux is not None else torch.zeros((),
                                                          device=x.device)
    run = _Schedule(block_fn, group, M, 'gpipe', None, None, False,
                    (stacked_params, None, None), remat)
    return _run(run, stacked_params, None, None, x, _dummy_extra(x))


def one_f_one_b(block_fn, stacked_params, x, group, microbatches,
                tail_fn=None, extra=None, tail_params=None, head_fn=None,
                head_params=None, variant='auto'):
    """1F1B schedule; see the module docstring for the fused mode (pass
    ``tail_params``: ``tail_fn(tail_params, h, extra_mb)`` on the last
    stage, ``head_fn(head_params, x_mb)`` on the first) and its
    ``variant``, and for the legacy mode (neither ``tail_params`` nor
    ``head_params``: ``tail_fn(h, extra_mb)`` closes over its params).

    Returns ``(out, aux)``: per-rank partials whose sum over the pipe
    group is the output and the aux (see the module docstring). Gradients
    reach this stage's ``stacked_params``, the tail params (last stage),
    the head params and a floating ``x`` (first stage).

    Raises ``ValueError`` for a batch that ``microbatches`` does not
    divide, an unknown variant, a floating ``extra`` in the fused mode
    (its backward does not propagate into ``extra``), a closure-style
    ``tail_fn`` beside ``head_params`` (its params would lose their
    gradients) and a ``head_fn`` without ``head_params``."""
    M = int(microbatches)
    if _stages(group) == 1:
        h = x if head_fn is None else head_fn(head_params, x)
        h, aux = run_stack(block_fn, stacked_params, h)
        if tail_fn is not None:
            h = tail_fn(tail_params, h, extra) if tail_params is not None \
                else tail_fn(h, extra)
        return h, aux if aux is not None else torch.zeros((),
                                                          device=x.device)
    _check_batch(x, M)
    if tail_params is not None or head_params is not None:
        if tail_fn is not None and tail_params is None:
            raise ValueError(
                'fused 1F1B (head_params given) needs the param-explicit '
                'tail convention: pass tail_params with '
                'tail_fn(tail_params, h, extra_mb) - a closure-style '
                'tail_fn(h, extra) would silently lose its parameter '
                'gradients')
        if extra is None:
            extra = _dummy_extra(x)
        elif extra.is_floating_point():
            raise ValueError(
                'fused 1F1B does not backpropagate into a floating-point '
                '`extra` stream; use integer targets or the legacy '
                'schedule (no tail_params)')
        if variant not in VARIANTS:
            raise ValueError('unknown 1F1B variant %r' % (variant,))
        run = _Schedule(block_fn, group, M, variant, head_fn, tail_fn,
                        False, (stacked_params, tail_params, head_params))
        if variant == 'auto':
            run.mode = _auto_variant(run, head_params, x)
        return _run(run, stacked_params, tail_params, head_params, x, extra)
    if head_fn is not None:
        raise ValueError(
            'head_fn requires the fused 1F1B mode: pass head_params '
            '(and tail_params if a tail_fn is used)')
    run = _Schedule(block_fn, group, M, 'gpipe', None, tail_fn, True,
                    (stacked_params, None, None))
    return _run(run, stacked_params, None, None, x,
                _dummy_extra(x) if extra is None else extra)


def stash_bytes(shape, dtype, microbatches):
    """The stash's bytes on a rank: ``microbatches`` boundary
    activations of ``shape`` (one microbatch's) and ``dtype``."""
    return int(microbatches) * int(np.prod(shape)) * \
        torch.empty((), dtype=dtype).element_size()


def _auto_variant(run, head_params, x):
    """'stash' while the stash fits ``AUTODIST_PP_STASH_LIMIT_MB``, else
    'remat': the first stage's boundary shape (its head's output on one
    microbatch, no graph) is broadcast, so every stage decides alike."""
    with torch.no_grad():
        run.first_input(head_params, x)
    limit = ENV.AUTODIST_PP_STASH_LIMIT_MB.val * (1 << 20)
    return 'stash' if stash_bytes(run.h_spec[0], run.h_spec[1],
                                  run.M) <= limit else 'remat'
