"""The port's side of the reshard tests: plans over a replica group of
``world`` ranks, and a round trip A -> B -> A of seeded values through
``parallel/reshard.apply_reshard``, run on every rank of a group
(``torch_dsl_worlds.run_group`` on gloo, or the card test's NCCL group).
The variables and the two layouts are ``tests/test_reshard.py``'s. This
module imports no jax.
"""
import numpy as np
import torch
import torch.distributed as dist

SHAPES = {'w': (24, 16), 'u': (30, 8), 'b': (48,), 's': ()}

A_CFG = {'w': ('8,1', 8),    # even shard, axis 0
         'u': ('2,1', 2),    # uneven at world 4 (30 rows pad to 32)
         'b': None, 's': None}
B_CFG = {'w': ('1,8', 8),    # shard axis flips 0 -> 1
         'u': None,          # sharded -> replicated
         'b': ('8', 8),      # replicated -> sharded
         's': None}          # scalar stays replicated
PAD_A = {'u': ('2,1', 2)}    # the padded axis change: gather_scatter
PAD_B = {'u': ('1,2', 2)}


class GraphItem:
    """The variables of ``SHAPES`` as a graph item (a variable a
    strategy leaves out is AllReduce, as in the JAX plan)."""

    def __init__(self):
        from autodist_tpu_torch.strategy.adapter import _VarLike
        self._vars = {n: _VarLike(n, s, np.float32)
                      for n, s in SHAPES.items()}

    @property
    def trainable_var_op_to_var(self):
        return self._vars

    def is_sparse(self, var):
        return False

    def var_by_name(self, name):
        return self._vars[name]


def make_strategy(cfg):
    """cfg: {var: None (replicated AR) | (partitioner, num_shards)}."""
    from autodist_tpu_torch.strategy.base import (AllReduceSynchronizer,
                                                  PSSynchronizer, Strategy,
                                                  StrategyNode)
    s = Strategy()
    for name, c in cfg.items():
        if c is None:
            s.node_config.append(StrategyNode(
                var_name=name, synchronizer=AllReduceSynchronizer()))
        else:
            part, nsh = c
            s.node_config.append(StrategyNode(
                var_name=name, partitioner=part,
                part_config=[PSSynchronizer() for _ in range(nsh)]))
    return s


def make_plans(world, rank, cfg_a, cfg_b, device='cpu', group=None):
    from autodist_tpu_torch.parallel.mesh import ReplicaGroup
    from autodist_tpu_torch.parallel.plan import ExecutionPlan
    gi = GraphItem()
    g = ReplicaGroup(world, rank, group, device)
    return (ExecutionPlan(make_strategy(cfg_a), gi, g),
            ExecutionPlan(make_strategy(cfg_b), gi, g))


def host_values(seed):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*s).astype('f4') if s
            else np.float32(rng.randn()) for k, s in SHAPES.items()}


def roundtrip(rank, world, cfg_a, cfg_b, seed=0, device='cpu',
              slots=False):
    """Every rank: its A-layout shards of seeded values, moved to B and
    back. Returns {'kinds', 'b': {name: B shard}, 'back_equal': bool,
    'slots_equal': bool or None} (host arrays); ``kinds`` lists the
    kinds both directions ran."""
    from autodist_tpu_torch.parallel import reshard
    pa, pb = make_plans(world, rank, cfg_a, cfg_b, device)
    host = host_values(seed)
    arrays = {k: pa.local_shard(k, torch.as_tensor(v, device=device))
              for k, v in host.items()}
    extra = None
    if slots:
        # an optimizer slot shaped like its variable rides the same op
        extra = {k: [2 * a] for k, a in arrays.items()}
    b_arrays, b_extra, ops = reshard.apply_reshard(pa, pb, arrays,
                                                   extra=extra)
    back, back_extra, ops_back = reshard.apply_reshard(pb, pa, b_arrays,
                                                       extra=b_extra)
    same = all(torch.equal(back[k], arrays[k]) for k in arrays)
    # what each rank must hold under B: its slice of the padded host
    # value, cut on the host without a collective
    want_b = {k: pb.local_shard(k, torch.as_tensor(v)).numpy()
              for k, v in host.items()}
    slots_equal = None
    if slots:
        slots_equal = all(torch.equal(back_extra[k][0], extra[k][0])
                          for k in arrays) and all(
            torch.equal(b_extra[k][0], 2 * b_arrays[k]) for k in arrays)
    if dist.is_initialized():
        dist.barrier()
    return {'kinds': sorted({o.kind for o in ops + ops_back}),
            'kinds_ab': {o.var_name: o.kind for o in ops},
            'b': {k: v.cpu().numpy() for k, v in b_arrays.items()},
            'want_b': want_b,
            'back_equal': same, 'slots_equal': slots_equal}
