"""Strategy representation, builder ABC, and compiler.

Mirrors the reference strategy language (``autodist/proto/strategy.proto:
30-69``, ``synchronizers.proto:24-56``, ``autodist/strategy/base.py``):
per-variable ``Node{var_name, synchronizer, partitioner, part_config[]}``
plus a ``GraphConfig{replicas[]}``. Serialization is JSON on disk under
``strategies/<id>`` under the working directory of ``const.py`` (the
reference serializes protobuf, base.py:78-99).

The compiler step (reference ``StrategyCompiler``, base.py:120-168)
resolves abstract device strings; the lowering onto a trainer happens in
:mod:`autodist_tpu_torch.strategy.adapter`, so the strategy stays
hardware-agnostic.
"""
import hashlib
import json
import os
import uuid
from dataclasses import dataclass, field, asdict

from autodist_tpu_torch.const import DEFAULT_SERIALIZATION_DIR
from autodist_tpu_torch.utils import logging


# -- synchronizer configs (synchronizers.proto parity) ----------------------

@dataclass
class PSSynchronizer:
    """Parameter-server-style sync (synchronizers.proto:24-37).

    On TPU this lowers to sharded-state (ZeRO-like) updates: gradients are
    reduce-scattered to the shard owner(s) given by ``reduction_destination``
    and updated parameters are all-gathered — push/pull without a literal
    server. ``sync=False`` / ``staleness>0`` engage the bounded-staleness
    pipeline (delayed gradient application windows).

    ``hierarchical`` governs the two-level lowering of the ZeRO halves
    (the gradient reduce-scatter and the param all-gather) on
    multi-node meshes, routed through the same
    ``cost_model.choose_hierarchical`` decision the AR buckets use:
    'auto' (default — the cost model decides per emission), 'never'
    (always the flat collective) or 'always'. Legacy strategies
    deserialize to 'auto'; single-node meshes are the degenerate flat
    case either way.
    """
    reduction_destination: str = ''
    local_replication: bool = False
    sync: bool = True
    staleness: int = 0
    hierarchical: str = 'auto'    # auto | never | always
    # loose mode: run the optimizer step ON the PS with service-resident
    # slot state shared by all workers (the reference re-creates the
    # optimizer over PS-resident variables, kernel/partitioner.py:570-573,
    # and places the update op on the PS, ps_synchronizer.py:175-176).
    # Supported for the SGD family (plain/momentum); other optimizers
    # fall back to worker-local slots with a logged note.
    shared_optimizer: bool = False
    # local-SGD window length H: workers take H local optimizer steps,
    # then push the AVERAGED parameter delta accumulated over the window
    # (delta/num_workers, so the merged PS state lands on the mean of
    # the workers' windows — a raw sum overshoots by the worker count)
    # and pull the merged state. 1 (default, and what legacy strategies
    # deserialize to) is today's every-step loose push, bit-identical.
    # Only the loose PS data plane honors H>1; shared_optimizer is
    # incompatible (the PS-resident update consumes per-step deltas).
    local_steps: int = 1
    kind: str = 'PS'


@dataclass
class AllReduceSynchronizer:
    """Collective all-reduce sync (synchronizers.proto:40-56).

    ``spec`` picks the collective lowering: AUTO lets XLA choose the ICI
    algorithm (the NCCL/RING distinction of the reference collapses into
    XLA's scheduler); RING forces a ppermute ring (useful cross-slice).
    ``compressor`` names a gradient compressor class; ``group`` merges
    same-group variables into one fused collective (reference: scoped
    allocator; here: concatenated flat-bucket all-reduce).
    ``chunk_size`` carries the builder's grouping bound so the execution
    plan can derive its per-bucket byte cap (parallel/plan.py): fused
    groups are further packed into byte-capped buckets so collectives
    overlap the backward pass instead of serializing behind it. 0 means
    "unspecified" (legacy strategies) and falls back to
    const.DEFAULT_CHUNK_SIZE.
    ``hierarchical`` governs two-level (intra-node reduce-scatter ->
    inter-node all-reduce -> intra-node all-gather) bucket emission on
    multi-node meshes: 'auto' (default — the simulator's cost model
    decides per bucket; flat is the degenerate single-node case),
    'never' (always the flat ring) or 'always' (force two-level where
    node groups exist). Legacy strategies deserialize to 'auto'.
    ``weight_update_sharding`` governs cross-replica sharding of the
    optimizer update itself (arXiv:2004.13336): instead of every
    replica running the full update over replicated slots, the fused
    gradient bucket is reduce-SCATTERED, each replica updates its 1/n
    shard with shard-resident optimizer slots, and the updated params
    ride one bucketed all-gather — freeing ~(n-1)/n of the opt-slot
    HBM at the cost of an exposed param-phase all-gather. 'never'
    (default — the legacy replicated update), 'always', or 'auto'
    (the shared ``cost_model.choose_update_sharding`` decision prices
    the all-gather exposure against the freed memory). Only
    NoneCompressor (uncompressed-wire), non-RING buckets shard, and
    sparse-read (row-lazy) variables never do — the flat shard layout
    cannot preserve LazyAdam/LazyMomentum row semantics; the
    ``AUTODIST_WEIGHT_UPDATE_SHARDING`` env knob overrides globally.
    """
    spec: str = 'AUTO'            # AUTO | RING
    compressor: str = 'NoneCompressor'
    group: int = 0
    chunk_size: int = 0
    hierarchical: str = 'auto'    # auto | never | always
    weight_update_sharding: str = 'never'   # never | auto | always
    kind: str = 'AllReduce'


_SYNC_KINDS = {'PS': PSSynchronizer, 'AllReduce': AllReduceSynchronizer}


@dataclass
class StrategyNode:
    """Per-variable config (strategy.proto:30-55).

    ``partitioner`` is the reference's shard string, e.g. ``"2,1"`` = two
    shards along axis 0. ``part_config`` holds one synchronizer per shard.
    """
    var_name: str = ''
    synchronizer: object = None
    partitioner: str = ''
    part_config: list = field(default_factory=list)

    @property
    def num_shards(self):
        if not self.partitioner:
            return 1
        p = 1
        for s in self.partitioner.split(','):
            p *= int(s)
        return p

    @property
    def partition_axis(self):
        """The single active partition axis, or None (partitioner.py:94-150)."""
        if not self.partitioner:
            return None
        for axis, s in enumerate(self.partitioner.split(',')):
            if int(s) > 1:
                return axis
        return None


@dataclass
class GraphConfig:
    """Replica devices (strategy.proto:58-69)."""
    replicas: list = field(default_factory=list)


class Strategy:
    """A built strategy: id + per-var node configs + graph config."""

    def __init__(self, strategy_id=None):
        self.id = strategy_id or uuid.uuid4().hex[:16]
        self.path = os.path.join(DEFAULT_SERIALIZATION_DIR, self.id)
        self.node_config = []      # list[StrategyNode]
        self.graph_config = GraphConfig()
        # predicted-cost metadata attached by the simulator (AutoStrategy
        # / simulator.search): {'builder', 'predicted_step_time_s',
        # 'predicted_peak_bytes', ...}. None for hand-built strategies.
        # Rides serialization so workers and audits see what the chief
        # predicted.
        self.cost = None

    # -- (de)serialization ------------------------------------------------
    def to_dict(self):
        def enc_sync(s):
            return asdict(s) if s is not None else None

        out = {
            'id': self.id,
            'node_config': [{
                'var_name': n.var_name,
                'synchronizer': enc_sync(n.synchronizer),
                'partitioner': n.partitioner,
                'part_config': [enc_sync(p) for p in n.part_config],
            } for n in self.node_config],
            'graph_config': {'replicas': list(self.graph_config.replicas)},
        }
        if self.cost is not None:
            out['cost'] = dict(self.cost)
        return out

    @classmethod
    def from_dict(cls, d):
        def dec_sync(sd):
            if sd is None:
                return None
            return _SYNC_KINDS[sd.get('kind', 'AllReduce')](**sd)

        s = cls(strategy_id=d['id'])
        for nd in d['node_config']:
            node = StrategyNode(
                var_name=nd['var_name'],
                synchronizer=dec_sync(nd['synchronizer']),
                partitioner=nd.get('partitioner', ''),
                part_config=[dec_sync(p) for p in nd.get('part_config', [])])
            s.node_config.append(node)
        s.graph_config = GraphConfig(
            replicas=list(d['graph_config']['replicas']))
        s.cost = dict(d['cost']) if d.get('cost') is not None else None
        return s

    def serialize(self):
        """Write to disk so worker processes can load it by id."""
        os.makedirs(DEFAULT_SERIALIZATION_DIR, exist_ok=True)
        with open(self.path, 'w') as f:
            json.dump(self.to_dict(), f, sort_keys=True, indent=1)
        return self.path

    @classmethod
    def deserialize(cls, strategy_id):
        path = os.path.join(DEFAULT_SERIALIZATION_DIR, strategy_id)
        with open(path, 'r') as f:
            return cls.from_dict(json.load(f))

    def __str__(self):
        return json.dumps(self.to_dict(), indent=1, sort_keys=True)

    def __eq__(self, other):
        return isinstance(other, Strategy) and \
            self.to_dict() == other.to_dict()

    def __hash__(self):
        return hash(json.dumps(self.to_dict(), sort_keys=True))


class StrategyBuilder:
    """ABC for strategy builders (reference base.py:102-117)."""

    def build(self, graph_item, resource_spec):
        """Generate a Strategy from the captured program + cluster."""
        raise NotImplementedError


class StrategyCompiler:
    """Resolve device strings and prune stateless vars (base.py:120-168).

    The heavier mesh/sharding binding happens in
    :class:`autodist_tpu.parallel.compiler.ExecutionPlanBuilder`; this class
    keeps reference parity for the string-level compilation step.
    """

    def __init__(self, graph_item):
        self._graph_item = graph_item
        self._device_resolver = None

    def set_device_resolver(self, resolver):
        self._device_resolver = resolver
        return self

    def prune(self, strategy):
        """Drop node configs for variables this graph does not have
        (reference base.py:137-168 prunes stateless vars). Idempotent;
        callers may prune early (e.g. before the execution-mode decision)
        and still pass the result through :meth:`compile`."""
        known = set(self._graph_item.trainable_var_op_to_var.keys())
        kept = [n for n in strategy.node_config if n.var_name in known]
        dropped = [n.var_name for n in strategy.node_config
                   if n.var_name not in known]
        if dropped:
            logging.debug('Pruned stateless/unknown vars from strategy: %s',
                          dropped)
        strategy.node_config = kept
        return strategy

    def _resolve_devices(self, strategy):
        if self._device_resolver is None:
            return strategy
        strategy.graph_config.replicas = [
            self._device_resolver(d) for d in strategy.graph_config.replicas]
        for node in strategy.node_config:
            for sync in [node.synchronizer] + list(node.part_config):
                if isinstance(sync, PSSynchronizer) and \
                        sync.reduction_destination:
                    sync.reduction_destination = self._device_resolver(
                        sync.reduction_destination)
        return strategy

    def compile(self, strategy):
        strategy = self.prune(strategy)
        strategy = self._resolve_devices(strategy)
        return strategy


def byte_size_load_fn(var):
    """Estimated byte size of a variable (reference ps_lb_strategy.py:86-117)."""
    import numpy as np
    dtype = np.dtype(var.dtype)
    size = dtype.itemsize
    shape = var.shape
    if len(shape) == 0:
        return size
    if shape[0] is None:
        # unknown batch-like dim: assume a modest default like the reference
        shape = (128,) + tuple(shape[1:])
    n = 1
    for d in shape:
        n *= int(d)
    return n * size
