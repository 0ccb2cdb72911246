"""The port's side of the simulator and two-level-collective tests, run
on every rank of a gloo group (``torch_dsl_worlds.run_group``).

Each function is called as ``fn(rank, world, **kwargs)`` and returns
numpy values. Replica r's inputs are row r of a seeded numpy array, so a
test can hand the same rows to the JAX package. This module imports no
jax.
"""
import numpy as np
import torch

import autodist_tpu_torch as ad
import torch_dsl_cases as dsl
from autodist_tpu_torch.frontend import graph as fe

NODE_GROUPS = [[0, 1], [2, 3]]
META = torch.device('meta')


def shapes_model(shapes):
    """A ``FunctionalModel`` of named f32 parameters (shapes only, on the
    meta device) for ``PytreeGraphItem``: what the JAX tests build with
    their ``FunctionalModel``."""
    from autodist_tpu_torch.strategy.adapter import FunctionalModel

    def init_fn(generator):
        return {k: torch.empty(s, device=META) for k, s in shapes.items()}

    def loss_fn(params, batch):
        raise NotImplementedError('a shapes-only model has no loss')
    return FunctionalModel(init_fn, loss_fn, device=META)


def make_gi(shapes):
    from autodist_tpu_torch.strategy.adapter import PytreeGraphItem
    return PytreeGraphItem(shapes_model(shapes))


def make_rs(n=8, device='tpus', topology=None, nodes=1, cls=None):
    """A spec of ``nodes`` hosts sharing ``n`` devices, in the JAX tests'
    shape; ``cls`` picks the package's ResourceSpec (the port's by
    default)."""
    if cls is None:
        from autodist_tpu_torch.resource_spec import ResourceSpec as cls
    node_list = []
    for i in range(nodes):
        node = {'address': 'host%d' % i, 'cpus': [0],
                'network_bandwidth': 100,
                device: list(range(n // nodes))}
        if i == 0:
            node['chief'] = True
        node_list.append(node)
    info = {'nodes': node_list}
    if topology:
        info['topology'] = topology
    return cls(resource_info=info)


def rows(seed, shape, world, integers=False):
    """Every replica's input, stacked: ``[world, *shape]`` f32 (integers
    in [-8, 8) when asked, whose sums are exact in any order)."""
    rng = np.random.RandomState(seed)
    if integers:
        return rng.randint(-8, 8, (world,) + tuple(shape)).astype('f4')
    return rng.randn(world, *shape).astype('f4')


def _np(t):
    return t.float().numpy()


# -- the two-level collectives against flat ----------------------------------
def hier_collectives(rank, world):
    """Each two-level collective and its flat counterpart on this rank's
    row, integer-valued (exact) and random; the int8 two-level
    all-reduce; and each two-level lowering of ``schedule_ir.execute``
    against the flat program. Returns {label: (two-level, flat)}."""
    from autodist_tpu_torch.parallel import compressor as comp
    from autodist_tpu_torch.parallel import plan as P
    from autodist_tpu_torch.parallel import schedule_ir as sir
    from autodist_tpu_torch.parallel.mesh import ReplicaGroup
    g = ReplicaGroup(world, rank)
    out = {}
    for data in ('int', 'randn'):
        x = torch.from_numpy(rows(1, (8, 6), world, data == 'int')[rank])
        xt = x.T.contiguous()
        out[data + '/all_reduce'] = (
            P.hierarchical_all_reduce(x, g, NODE_GROUPS), g.all_reduce(x))
        out[data + '/psum_scatter'] = (
            P.hierarchical_psum_scatter(x, g, NODE_GROUPS),
            g.reduce_scatter(x))
        out[data + '/psum_scatter_axis1'] = (
            P.hierarchical_psum_scatter(xt, g, NODE_GROUPS, axis=1),
            g.reduce_scatter(xt, axis=1))
        out[data + '/all_gather'] = (
            P.hierarchical_all_gather(x, g, NODE_GROUPS, axis=1),
            g.all_gather(x, axis=1))
        nb = x.numel() * 4
        for kind, inp in (('all_reduce', x), ('psum_scatter', x),
                          ('all_gather', x[:2])):
            two = sir.bucket_program(kind, nb, 'float32', None, 'AUTO',
                                     world, hier=2, node_groups=NODE_GROUPS)
            flat = sir.bucket_program(kind, nb, 'float32', None, 'AUTO',
                                      world)
            out['%s/execute/%s' % (data, sir.lowering_of(two))] = (
                sir.execute(two, inp, g), sir.execute(flat, inp, g))
        three = sir.three_level_program(x.numel(), 'float32', 2, 1, 2)
        out['%s/execute/%s' % (data, sir.lowering_of(three))] = (
            sir.execute(three, x, g), g.all_reduce(x) / world)
    y = torch.from_numpy(rows(2, (1000,), world)[rank])
    two = sir.bucket_program('all_reduce', 4000, 'float32',
                             'Int8RingCompressor', 'AUTO', world, hier=2,
                             node_groups=NODE_GROUPS)
    out['int8/hierarchical'] = (
        comp.int8_hierarchical_all_reduce(y, g, NODE_GROUPS), g.all_reduce(y))
    out['int8/execute/' + sir.lowering_of(two)] = (
        sir.execute(two, y, g), g.all_reduce(y) / world)
    return {k: (_np(a), _np(b)) for k, (a, b) in out.items()}


def hier_plan(rank, world):
    """``ExecutionPlan.sync_gradients`` under AUTODIST_HIERARCHY_NODES=2
    (set by the caller): hierarchical='always' against 'never' for the
    plain f32 wire, a bf16 tensor dtype and the bf16 cast wire (integer
    gradients), the int8 bucket path (block-constant and random), and
    the traced bucket records against the static schedule."""
    from autodist_tpu_torch.parallel.plan import static_collective_schedule
    AR = ad.AllReduce
    out = {}
    shapes = [(64, 48)] * 5
    ints = [rows(10 + i, s, world, True)[rank] for i, s in enumerate(shapes)]
    for dtype, cname in (('float32', 'NoneCompressor'),
                         ('bfloat16', 'NoneCompressor'),
                         ('float32', 'HorovodCompressor')):
        for knob in ('never', 'always'):
            plan, sources = dsl._plan_over(
                shapes, AR(chunk_size=2, compressor=cname,
                           hierarchical=knob), world)
            grads = [torch.from_numpy(g).to(getattr(torch, dtype))
                     for g in ints]
            got = plan.sync_gradients(sources, grads, fe.Env({}, {}))
            out['%s/%s/%s' % (dtype, cname, knob)] = (
                [_np(o) for o in got], [o.dtype == grads[0].dtype
                                        for o in got],
                [b['hier'] for b in plan.last_bucket_stats],
                plan.hier_groups)
    const_shapes = [(32, 32)] * 4
    rand_shapes = [(64, 64)] * 4
    for label, shp, make in (
            ('const', const_shapes,
             lambda i, s: np.full(s, float(i + 1), 'f4')),
            ('randn', rand_shapes,
             lambda i, s: rows(30 + i, s, world)[rank])):
        for key, knob, cname in (('f32', 'never', 'NoneCompressor'),
                                 ('flat8', 'never', 'Int8RingCompressor'),
                                 ('hier8', 'always', 'Int8RingCompressor')):
            plan, sources = dsl._plan_over(
                shp, AR(chunk_size=2, compressor=cname, hierarchical=knob),
                world)
            grads = [torch.from_numpy(make(i, s)) for i, s in enumerate(shp)]
            got = plan.sync_gradients(sources, grads, fe.Env({}, {}))
            out['int8/%s/%s' % (label, key)] = (
                [_np(o) for o in got],
                [(b['hier'], b['compressor'])
                 for b in plan.last_bucket_stats])
    shapes = [(128, 128)] * 6
    plan, sources = dsl._plan_over(shapes, AR(chunk_size=2), world)
    plan.sync_gradients(sources, [torch.ones(s) for s in shapes],
                        fe.Env({}, {}))
    static = [e for e in static_collective_schedule(
        plan.strategy, plan.graph_item, world, nodes=2)
        if e['phase'] == 'grad']
    out['static_vs_traced'] = (
        [(e['bytes'], e['members'], e['hier']) for e in static],
        [(e['bytes'], e['members'], e.get('hier', 0))
         for e in plan.last_bucket_stats])
    return out


def hier_c0(rank, world):
    """The c0 program under AllReduce(hierarchical='always') over
    AUTODIST_HIERARCHY_NODES=2 (set by the caller): (loss, W, b) and the
    plan's node groups and bucket records."""
    autodist = dsl.fresh(ad.AllReduce(hierarchical='always'), world)
    res = dsl.cs.run_linear_regression(autodist, rank, world)
    plan = autodist._session._plan if hasattr(autodist, '_session') \
        else None
    return res, (plan.hier_groups if plan is not None else None), \
        ([b['hier'] for b in plan.last_bucket_stats]
         if plan is not None else None)


# -- the simulator's measured mode over gloo ---------------------------------
def static_vs_traced(rank, world):
    """The static schedule's gradient buckets and the buckets the plan
    emits, for six [128, 128] variables under AllReduce(chunk_size=2)."""
    shapes = [(128, 128)] * 6
    vals, traced, _, static = dsl.sync(rank, world, shapes,
                                       ad.AllReduce(chunk_size=2),
                                       1 << 30)
    static = [e for e in static if e['phase'] == 'grad']
    return ([(e['bytes'], e['members']) for e in static],
            [(e['bytes'], e['members']) for e in traced])


def trainer_profile(rank, world, trace_dir, steps=3):
    """A small TransformerLM through the Trainer at ``world`` ranks,
    profiled for ``steps`` steps into ``trace_dir`` (each rank writes
    ``rank<r>.pt.trace.json``); returns the timeline's rows as (kind,
    bytes, ranks, ns, count), read from every rank's trace, the gradient
    bytes the step all-reduces, and the calibration of the traces."""
    from autodist_tpu_torch import optim
    from autodist_tpu_torch.api import Trainer
    from autodist_tpu_torch.models.transformer import (TransformerConfig,
                                                       TransformerLM)
    from autodist_tpu_torch.simulator.calibrate import calibrate_from_trace
    from autodist_tpu_torch.simulator.cost_model import CostModelParams
    from autodist_tpu_torch.utils.profiling import collective_timeline
    cfg = TransformerConfig.tiny(dtype=torch.float32, max_len=64)
    model = TransformerLM(cfg, device='cpu', seed=0)
    trainer = Trainer(model, optim.sgd(0.1))
    state = trainer.init(seed=0)
    batch = dsl.cs.make_batch(cfg.vocab, 4, 32)
    trainer.profile(state, batch, trace_dir, steps=steps)
    torch.distributed.barrier()   # every rank's trace is written
    timeline = collective_timeline(trace_dir)
    params = calibrate_from_trace(CostModelParams(), trace_dir, world)
    grad_bytes = sum(p.numel() * p.element_size()
                     for p in model.parameters())
    return ([(d.kind, d.nbytes, d.ranks, ns, cnt)
             for d, ns, cnt in timeline], grad_bytes,
            (params.calibrated, params.alpha_ici_s,
             params.beta_ici_s_per_byte))
