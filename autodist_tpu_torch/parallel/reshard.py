"""Resharding: strategy-A layout -> strategy-B layout.

The counterpart of ``autodist_tpu/parallel/reshard.py``. An
:class:`~autodist_tpu_torch.parallel.plan.ExecutionPlan` places every
variable either REPLICATED or ZeRO-sharded along one axis over its
replica group (padded for uneven partitions). Migrating live state
between two plans (an elastic re-plan picking a new strategy) is a
per-variable layout map, executed on each replica's device with
``torch.distributed`` collectives over the plans' group, chosen by the
redistribution cost model:

==================  ==================  ===========================
source layout       target layout       collective
==================  ==================  ===========================
replicated          replicated          none (``noop``)
replicated          sharded(b)          local slice (``shard``, 0 wire)
sharded(a)          replicated          ``all_gather``
                                        (``all_gather_into_tensor``)
sharded(a)          sharded(b), a != b  ``all_to_all``
                                        (``all_to_all_single``) OR
                                        ``gather_scatter`` — cheaper
                                        one per the cost model
sharded(a)          sharded(a), pad'    ``gather_scatter`` (repad)
==================  ==================  ===========================

The planning half (:func:`var_layout`, :class:`ReshardOp`,
:func:`plan_reshard`, :func:`summarize`) is the JAX module's arithmetic,
copied. ``all_to_all`` sends each peer a contiguous permutation of the
destination axis and concatenates what arrives along the source axis;
``gather_scatter`` gathers, unpads, repads and slices. A loose worker
is one process with one device, so inside it every move is a one-rank
``noop`` or ``shard``; the collectives run across the ranks of a plan
whose group spans several processes.

Numerics: every path is a pure data movement — no arithmetic touches
the values — so a round trip A -> B -> A is bit-identical (the
property ``tests/test_reshard.py`` pins for the JAX module and
``tests/test_torch_reshard.py`` for this one).
"""
from dataclasses import dataclass, field, asdict

import numpy as np
import torch
import torch.distributed as dist

from autodist_tpu_torch.utils import logging

def var_layout(plan, name):
    """One variable's physical layout under ``plan``:
    ``{'sharded', 'axis', 'padded_dim', 'pad'}`` (axis fields are None
    for replicated state)."""
    p = plan.var_plans[name]
    if not p.state_sharded:
        return {'sharded': False, 'axis': None, 'padded_dim': None,
                'pad': 0}
    return {'sharded': True, 'axis': int(p.shard_axis),
            'padded_dim': int(p.padded_dim or
                              p.var.shape[p.shard_axis]),
            'pad': int(p.pad)}


@dataclass
class ReshardOp:
    """One variable's planned layout move."""
    var_name: str
    kind: str                      # noop|shard|all_gather|all_to_all|
    #                                gather_scatter
    src: dict = field(default_factory=dict)
    dst: dict = field(default_factory=dict)
    wire_bytes: int = 0            # per-device bytes on the wire
    est_time_s: float = 0.0        # redistribution cost-model estimate

    def to_dict(self):
        return asdict(self)

    def ir_program(self, n, elems, dtype='float32'):
        """This move as a :mod:`~autodist_tpu_torch.parallel.schedule_ir`
        program — the same IR gradient syncs lower through, so the
        shape algebra verifies reshards too (``tools/analyze.py
        --schedule`` runs it). Element space is the flattened padded
        physical array in the DESTINATION coordinate frame; every path
        is pure data movement, so holdings carry full-value (ALL-
        contrib) fragments and the algebra checks coverage, never
        reduction completeness. ``ReshardOp`` stores layouts only, so
        the caller supplies the mesh size ``n`` and the physical
        element count ``elems``. Chaining ``run_algebra`` holdings
        through consecutive programs proves A -> B -> A identity
        (the JAX package's ``tests/test_schedule_ir.py`` pins it)."""
        from autodist_tpu_torch.parallel import schedule_ir as sir
        n = int(n)
        wire = sir.wire_of_dtype(dtype)
        meta = {'reshard': self.kind, 'var': self.var_name}
        name = 'reshard_%s_%s' % (self.kind, self.var_name)
        full = (tuple(range(n)),)
        if self.kind == 'noop':
            state = 'value_sharded' if self.src.get('sharded') \
                else 'value_replicated'
            E = sir._pad_to(elems, n) if state == 'value_sharded' \
                else int(elems)
            return sir.Program(name, n, E, str(dtype), (), state,
                               state, meta)
        E = sir._pad_to(elems, n)
        m = E // n
        chunks = (tuple((d * m, (d + 1) * m) for d in range(n)),)
        if self.kind == 'shard':
            # replicated -> sharded: zero-wire local projection; the
            # algebra checks each device already covers its chunk.
            steps = (sir.Step('scatter', tier='local', wire=wire,
                              groups=full, chunks=chunks),)
            return sir.Program(name, n, E, str(dtype), steps,
                               'value_replicated', 'value_sharded',
                               meta)
        if self.kind == 'all_gather':
            steps = (sir.Step('all_gather', tier='dcn', wire=wire,
                              groups=full, span=((0, E),),
                              nbytes=sir.wire_nbytes(E, wire)),)
            return sir.Program(name, n, E, str(dtype), steps,
                               'value_sharded', 'value_replicated',
                               meta)
        if self.kind == 'all_to_all':
            # sharded(a) -> sharded(b): in the destination frame each
            # source shard is the block transpose — device d holds one
            # mm-slice of every destination chunk — and one wired
            # scatter redistributes them into contiguous chunks.
            E = sir._pad_to(elems, n * n)
            m = E // n
            mm = m // n
            ALL = frozenset(range(n))
            init = [[(j * m + d * mm, j * m + (d + 1) * mm, ALL)
                     for j in range(n)] for d in range(n)]
            chunks = (tuple((d * m, (d + 1) * m) for d in range(n)),)
            nb = (n - 1) / float(max(1, n)) * \
                sir.wire_nbytes(E, wire) or 1.0
            steps = (sir.Step('scatter', tier='dcn', wire=wire,
                              groups=full, chunks=chunks, nbytes=nb),)
            return sir.Program(name, n, E, str(dtype), steps, init,
                               'value_sharded', meta)
        if self.kind == 'gather_scatter':
            steps = (sir.Step('all_gather', tier='dcn', wire=wire,
                              groups=full, span=((0, E),),
                              nbytes=sir.wire_nbytes(E, wire)),
                     sir.Step('scatter', tier='local', wire=wire,
                              groups=full, chunks=chunks))
            return sir.Program(name, n, E, str(dtype), steps,
                               'value_sharded', 'value_sharded', meta)
        raise ValueError('Unknown reshard kind %r' % (self.kind,))


def _move_cost(kind, nbytes, n, params):
    """Redistribution cost-model estimate for one move of ``nbytes``
    physical bytes over the ``n``-way data axis. Collectives price at
    the DCN tier when the plan spans nodes is unknowable here, so the
    conservative cross-node constants apply; ``gather_scatter``
    additionally pays a full-tensor HBM pass (the per-device
    materialize + re-slice ``all_to_all`` avoids)."""
    if n <= 1 or kind in ('noop', 'shard'):
        return 0.0
    alpha, beta = params.link(cross_node=True)
    t = (n - 1) * alpha + (n - 1) / n * float(nbytes) * beta
    if kind == 'gather_scatter':
        t += float(nbytes) * params.compress_s_per_byte
    return t


def plan_reshard(old_plan, new_plan, params=None):
    """Plan the per-variable moves from ``old_plan``'s layouts to
    ``new_plan``'s. Pure (no device work); returns ``[ReshardOp]``
    covering every variable both plans know, cheapest collective per
    the redistribution cost model."""
    if params is None:
        params = getattr(new_plan, 'cost_params', None) or \
            getattr(old_plan, 'cost_params', None)
    n = old_plan.num_replicas
    ops = []
    for name in old_plan.var_plans:
        if name not in new_plan.var_plans:
            continue
        src = var_layout(old_plan, name)
        dst = var_layout(new_plan, name)
        var = old_plan.var_plans[name].var
        itemsize = np.dtype(var.dtype).itemsize
        phys = list(var.shape)
        if src['sharded']:
            phys[src['axis']] = src['padded_dim']
        nbytes = int(np.prod(phys or [1])) * itemsize
        if src == dst:
            kind = 'noop'
        elif not src['sharded'] and dst['sharded']:
            kind = 'shard'
        elif src['sharded'] and not dst['sharded']:
            kind = 'all_gather'
        else:
            # sharded -> sharded: all_to_all only lowers when neither
            # side is padded (its tiled split needs exact division);
            # otherwise the single-program gather+re-slice handles any
            # geometry. Where both apply, the cost model picks.
            clean = (src['pad'] == 0 and dst['pad'] == 0 and
                     src['axis'] != dst['axis'])
            if clean and _move_cost('all_to_all', nbytes, n, params) <= \
                    _move_cost('gather_scatter', nbytes, n, params):
                kind = 'all_to_all'
            else:
                kind = 'gather_scatter'
        wire = 0 if kind in ('noop', 'shard') else \
            int((n - 1) / max(1, n) * nbytes)
        ops.append(ReshardOp(
            var_name=name, kind=kind, src=src, dst=dst,
            wire_bytes=wire,
            est_time_s=_move_cost(kind, nbytes, n, params)))
    return ops


def _narrow_mine(x, axis, n, rank):
    size = x.shape[axis] // n
    return x.narrow(axis, rank * size, size).contiguous()


def reshard_fn(op, old_plan, new_plan):
    """A callable moving ONE variable's physical tensor (this replica's
    shard, or the whole value when replicated) from ``op.src`` to
    ``op.dst`` layout over the new plan's replica group, reusable for
    any tensor of the variable's physical shape (optimizer slots shaped
    like their variable ride the same fn)."""
    group = new_plan.group
    n, rank = group.size, group.rank
    var = new_plan.var_plans[op.var_name].var
    logical = tuple(int(d) for d in var.shape)
    src, dst = op.src, op.dst

    def unpad_src(x):
        if src['sharded'] and src['pad']:
            x = x.narrow(src['axis'], 0, logical[src['axis']])
        return x

    def pad_dst(x):
        if dst['sharded'] and dst['pad']:
            cfg = [0, 0] * x.dim()
            # F.pad lists (before, after) pairs from the LAST axis back
            cfg[2 * (x.dim() - 1 - dst['axis']) + 1] = dst['pad']
            x = torch.nn.functional.pad(x, cfg)
        return x

    def gather(x):
        return unpad_src(group.all_gather(x.contiguous(),
                                          axis=src['axis']))

    if op.kind == 'noop':
        return lambda x: x

    if op.kind == 'shard':
        return lambda x: _narrow_mine(pad_dst(x), dst['axis'], n, rank)

    if op.kind == 'all_gather':
        return gather

    if op.kind == 'all_to_all':
        def a2a(x):
            if n == 1:
                return x
            # rows of the destination axis, grouped by the rank that
            # keeps them: peer j gets the j-th contiguous block
            moved = x.movedim(dst['axis'], 0).contiguous()
            out = torch.empty_like(moved)
            dist.all_to_all_single(out, moved, group=group.group)
            # out's j-th block is peer j's source shard of my rows:
            # concatenate the blocks along the source axis, rank order
            blocks = out.chunk(n, dim=0)
            return torch.cat([b.movedim(0, dst['axis']) for b in blocks],
                             dim=src['axis']).contiguous()
        return a2a

    if op.kind == 'gather_scatter':
        return lambda x: _narrow_mine(pad_dst(gather(x)), dst['axis'], n,
                                      rank)

    raise ValueError('Unknown reshard kind %r' % (op.kind,))


def apply_reshard(old_plan, new_plan, arrays, ops=None, extra=None):
    """Execute a reshard plan on this replica (every replica of the
    group calls it, in the same order: the moves are collectives).

    Args:
        old_plan / new_plan: the two :class:`ExecutionPlan`\\ s. They
            must share one replica group (a reshard moves layouts, not
            devices).
        arrays: ``{var name: physical tensor}`` under ``old_plan``'s
            layouts (the session's ``_var_state``).
        ops: a ``plan_reshard`` result to execute (default: planned
            fresh).
        extra: optional ``{var name: [more tensors]}`` that share their
            variable's physical layout (optimizer slot tensors); moved
            through the SAME fn.

    Returns ``(new_arrays, new_extra, ops)`` with every tensor laid out
    per ``new_plan``. Values are moved, never recomputed — bit-exact.
    """
    og, ng = old_plan.group, new_plan.group
    if (og.size, og.rank, og.group, og.device) != \
            (ng.size, ng.rank, ng.group, ng.device):
        raise ValueError('reshard requires both plans on one replica '
                         'group; got %d ranks on %s vs %d on %s'
                         % (og.size, og.device, ng.size, ng.device))
    if ops is None:
        ops = plan_reshard(old_plan, new_plan)
    extra = extra or {}
    out, out_extra = {}, {}
    moved = 0
    for op in ops:
        arr = arrays.get(op.var_name)
        if arr is None:
            continue
        fn = reshard_fn(op, old_plan, new_plan)
        out[op.var_name] = fn(arr)
        if op.var_name in extra:
            out_extra[op.var_name] = [fn(a)
                                      for a in extra[op.var_name]]
        if op.kind != 'noop':
            moved += 1
    logging.info('reshard: %d vars moved (%d layout changes), '
                 'est %.3g s, %.1f KiB wire per device', len(out),
                 moved, sum(o.est_time_s for o in ops),
                 sum(o.wire_bytes for o in ops) / 1024.0)
    return out, out_extra, ops


def summarize(ops):
    """Compact audit record of a reshard plan (rides health_stats)."""
    kinds = {}
    for op in ops:
        kinds[op.kind] = kinds.get(op.kind, 0) + 1
    return {'vars': len(ops), 'kinds': kinds,
            'wire_bytes': sum(o.wire_bytes for o in ops),
            'est_time_s': sum(o.est_time_s for o in ops)}
