"""The concrete strategy builders.

One-to-one with the reference's ``autodist/strategy/`` directory:

- :class:`PS`                   — ps_strategy.py:40-56
- :class:`PSLoadBalancing`      — ps_lb_strategy.py:64-117
- :class:`PartitionedPS`        — partitioned_ps_strategy.py:60-135
- :class:`UnevenPartitionedPS`  — uneven_partition_ps_strategy.py:125-133
- :class:`AllReduce`            — all_reduce_strategy.py:38-90
- :class:`PartitionedAR`        — partitioned_all_reduce_strategy.py:71-118
- :class:`RandomAxisPartitionAR`— random_axis_partition_all_reduce_strategy.py:96-141
- :class:`Parallax`             — parallax_strategy.py:38-70

plus the cost-model-driven selector (the upstream ``simulator/``
package's role):

- :class:`AutoStrategy` — simulates every candidate above with
  :mod:`autodist_tpu_torch.simulator` and returns the predicted-cheapest
  plan that fits the memory budget.

Builders only *choose* per-variable synchronization/partitioning/placement;
the lowering onto the data-parallel Trainer happens in
:mod:`autodist_tpu_torch.strategy.adapter`.
"""
from math import ceil

import numpy as np

from autodist_tpu_torch.const import ENV
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.strategy.base import (
    AllReduceSynchronizer, PSSynchronizer, Strategy, StrategyBuilder,
    StrategyNode, byte_size_load_fn)


def replica_devices(resource_spec):
    """Replica device list: accelerators, else the node's CPUs
    (reference all_reduce_strategy.py:52-56)."""
    reps = [k for k, _ in resource_spec.accelerator_devices]
    accel_nodes = {d.host_address
                   for _, d in resource_spec.accelerator_devices}
    for node, cpus in resource_spec.node_cpu_devices.items():
        if node not in accel_nodes:
            reps.extend(cpus)
    return reps


# shard-count rules live with the partitioner math
# (kernels/partitioner.py mirrors reference kernel/partitioner.py)
from autodist_tpu_torch.kernels.partitioner import (                   # noqa: E402
    smallest_non_divisor as _smallest_non_divisor,
    smallest_nontrivial_divisor as _smallest_nontrivial_divisor)


class PS(StrategyBuilder):
    """All variables on a single parameter server (the first CPU device)."""

    def __init__(self, local_proxy_variable=False, sync=True, staleness=0,
                 shared_optimizer=False, local_steps=1):
        self._local_proxy_variable = local_proxy_variable
        self._sync = sync
        self._staleness = staleness
        self._shared_optimizer = shared_optimizer
        self._local_steps = local_steps

    def build(self, graph_item, resource_spec):
        s = Strategy()
        s.graph_config.replicas = replica_devices(resource_spec)
        reduction_device = next(iter(resource_spec.cpu_devices))[0]
        for var in graph_item.trainable_var_op_to_var.values():
            s.node_config.append(StrategyNode(
                var_name=var.name,
                synchronizer=PSSynchronizer(
                    reduction_destination=reduction_device,
                    local_replication=self._local_proxy_variable,
                    sync=self._sync,
                    staleness=self._staleness,
                    shared_optimizer=self._shared_optimizer,
                    local_steps=self._local_steps)))
        return s


class PSLoadBalancing(StrategyBuilder):
    """Greedy byte-size bin-packing of variables onto all PS devices."""

    def __init__(self, local_proxy_variable=False, sync=True, staleness=0,
                 shared_optimizer=False, local_steps=1):
        self._local_proxy_variable = local_proxy_variable
        self._sync = sync
        self._staleness = staleness
        self._shared_optimizer = shared_optimizer
        self._local_steps = local_steps
        self.loads = {}

    def build(self, graph_item, resource_spec):
        s = Strategy()
        s.graph_config.replicas = replica_devices(resource_spec)
        self.loads = {k: 0.0 for k, _ in resource_spec.cpu_devices}
        for var in graph_item.trainable_var_op_to_var.values():
            s.node_config.append(self._gen_ps_node_config(var))
        return s

    def _gen_ps_node_config(self, var):
        min_ps = min(self.loads, key=self.loads.get)
        self.loads[min_ps] += byte_size_load_fn(var)
        return StrategyNode(
            var_name=var.name,
            synchronizer=PSSynchronizer(
                reduction_destination=min_ps,
                local_replication=self._local_proxy_variable,
                sync=self._sync,
                staleness=self._staleness,
                shared_optimizer=self._shared_optimizer,
                local_steps=self._local_steps))


class PartitionedPS(StrategyBuilder):
    """Axis-0 partitioning onto load-balanced PSes."""

    def __init__(self, local_proxy_variable=False, sync=True, staleness=0,
                 shared_optimizer=False, local_steps=1):
        self._local_proxy_variable = local_proxy_variable
        self._sync = sync
        self._staleness = staleness
        self._shared_optimizer = shared_optimizer
        self._local_steps = local_steps
        self.loads = {}

    def build(self, graph_item, resource_spec):
        s = Strategy()
        s.graph_config.replicas = replica_devices(resource_spec)
        self.loads = {k: 0.0 for k, _ in resource_spec.cpu_devices}
        for var in graph_item.trainable_var_op_to_var.values():
            s.node_config.append(self._gen_node_config(var))
        return s

    def get_num_shards(self, var):
        if len(var.shape) == 0:
            return 1
        return _smallest_nontrivial_divisor(int(var.shape[0]))

    def _gen_node_config(self, var):
        if len(self.loads) <= 1 and not ENV.AUTODIST_IS_TESTING.val:
            num_shards = 1       # single PS: don't partition (ref :81-87)
        else:
            num_shards = self.get_num_shards(var)
        sorted_ps = sorted(self.loads, key=self.loads.get)
        if num_shards > len(sorted_ps):
            sorted_ps = sorted_ps * ceil(num_shards / len(sorted_ps))
        targets = sorted_ps[:num_shards]
        for ps in targets:
            self.loads[ps] += byte_size_load_fn(var) / num_shards

        def ps_sync(dest):
            return PSSynchronizer(
                reduction_destination=dest,
                local_replication=self._local_proxy_variable,
                sync=self._sync, staleness=self._staleness,
                shared_optimizer=self._shared_optimizer,
                local_steps=self._local_steps)

        if num_shards == 1:
            return StrategyNode(var_name=var.name,
                                synchronizer=ps_sync(targets[0]))
        partition_list = [1] * max(len(var.shape), 1)
        partition_list[0] = min(num_shards, int(var.shape[0]))
        return StrategyNode(
            var_name=var.name,
            partitioner=','.join(str(p) for p in partition_list),
            part_config=[ps_sync(t) for t in targets])


class UnevenPartitionedPS(PartitionedPS):
    """Same placement, but shard count = smallest non-divisor so shard
    sizes are uneven (exercises uneven-split paths)."""

    def get_num_shards(self, var):
        if len(var.shape) == 0:
            return 1
        return _smallest_non_divisor(int(var.shape[0]))


class AllReduce(StrategyBuilder):
    """All dense variables via grouped collective all-reduce."""

    def __init__(self, chunk_size=128, all_reduce_spec='AUTO',
                 compressor='NoneCompressor', hierarchical='auto',
                 weight_update_sharding='never'):
        if chunk_size < 1:
            raise ValueError('The chunk_size must be greater than zero.')
        self.chunk_size = chunk_size
        self.all_reduce_spec = all_reduce_spec
        self.compressor = compressor
        self.hierarchical = hierarchical
        self.weight_update_sharding = weight_update_sharding

    def build(self, graph_item, resource_spec):
        s = Strategy()
        s.graph_config.replicas = replica_devices(resource_spec)
        for i, var in enumerate(
                graph_item.trainable_var_op_to_var.values()):
            s.node_config.append(StrategyNode(
                var_name=var.name,
                synchronizer=AllReduceSynchronizer(
                    spec=self.all_reduce_spec,
                    compressor=self.compressor,
                    group=i // self.chunk_size,
                    chunk_size=self.chunk_size,
                    hierarchical=self.hierarchical,
                    weight_update_sharding=self.weight_update_sharding)))
        return s


class PartitionedAR(StrategyBuilder):
    """Axis-0 partitioning, each shard synced by all-reduce."""

    def __init__(self, chunk_size=128, all_reduce_spec='AUTO',
                 compressor='NoneCompressor', hierarchical='auto',
                 weight_update_sharding='never'):
        self.chunk_size = chunk_size
        self.all_reduce_spec = all_reduce_spec
        self.compressor = compressor
        self.hierarchical = hierarchical
        self.weight_update_sharding = weight_update_sharding

    def build(self, graph_item, resource_spec):
        s = Strategy()
        s.graph_config.replicas = replica_devices(resource_spec)
        counter = 0
        for var in graph_item.trainable_var_op_to_var.values():
            node, used = self._gen_node_config(var, counter)
            counter += used
            s.node_config.append(node)
        return s

    def _num_shards_and_axis(self, var, graph_item=None):
        if len(var.shape) == 0:
            return 1, 0
        return _smallest_nontrivial_divisor(int(var.shape[0])), 0

    def _gen_node_config(self, var, counter):
        num_shards, axis = self._num_shards_and_axis(var)

        def ar(i):
            return AllReduceSynchronizer(
                spec=self.all_reduce_spec, compressor=self.compressor,
                group=(counter + i) // self.chunk_size,
                chunk_size=self.chunk_size,
                hierarchical=self.hierarchical,
                weight_update_sharding=self.weight_update_sharding)

        if num_shards <= 1:
            return StrategyNode(var_name=var.name,
                                synchronizer=ar(0)), 1
        partition_list = [1] * len(var.shape)
        partition_list[axis] = num_shards
        return StrategyNode(
            var_name=var.name,
            partitioner=','.join(str(p) for p in partition_list),
            part_config=[ar(i) for i in range(num_shards)]), num_shards


class RandomAxisPartitionAR(PartitionedAR):
    """Partition along a random non-1 axis (axis 0 forced for sparse)."""

    def __init__(self, chunk_size=128, seed=None, **kwargs):
        super().__init__(chunk_size, **kwargs)
        self._rng = np.random.RandomState(seed)
        self._graph_item = None

    def build(self, graph_item, resource_spec):
        self._graph_item = graph_item
        return super().build(graph_item, resource_spec)

    def _num_shards_and_axis(self, var, graph_item=None):
        if len(var.shape) == 0:
            return 1, 0
        non_one = [i for i, d in enumerate(var.shape) if d > 1]
        if not non_one:
            return 1, 0
        if self._graph_item is not None and \
                self._graph_item.is_sparse(var):
            axis = 0
        else:
            axis = non_one[int(self._rng.randint(0, len(non_one)))]
        return _smallest_nontrivial_divisor(int(var.shape[axis])), axis


class AutoStrategy(StrategyBuilder):
    """Cost-model-driven selector: simulate, rank, pick (the tenth
    builder — the reference paper's *automatic* strategy synthesis).

    ``build()`` enumerates candidate strategies (every concrete builder
    plus its chunk_size / compressor / partition knobs), prices each
    with the α-β cost model over the resource spec's ICI/DCN topology
    hints, prunes candidates whose predicted per-device peak bytes
    exceed ``memory_budget_bytes``, and returns the cheapest remaining
    plan. The prediction rides on ``Strategy.cost``.

    Args:
        memory_budget_bytes: per-device memory budget; candidates
            predicted above it are pruned. None = no pruning.
        optimizer_slots: f32 optimizer slot tensors per param for the
            memory estimate (2 = Adam, 1 = momentum SGD, 0 = SGD).
        candidates: override ``[(name, builder_factory)]`` list
            (default :func:`simulator.search.default_candidates`).
        cost_params: :class:`CostModelParams` override (e.g. from a
            previous calibration).
        trace_dir: optional profiler trace of a short real run; α-β
            constants are refined from its collective timeline before
            ranking (measured mode). Degrades to analytic constants
            when the trace has no collectives (CPU fallback).
        num_replicas: override the replica count the simulator prices
            (default: the spec's accelerator count).
        sparse_lookups_per_replica: expected embedding rows one replica
            looks up per step — batch-derived (pass the per-replica
            batch size, or batch x ids-per-example); prices sparse
            variables' PS traffic by touched rows instead of full size.
        drift_table: entry-labeled drift table from the roofline
            observatory (``telemetry.roofline.drift_table``, or a
            BENCH record's ``roofline.drift`` block — it carries the
            samples). Preferred over ``trace_dir``: tiers are labeled
            by schedule entry rather than the replica-groups
            heuristic, and samples carry full buffer bytes, so the
            refit β is exact for reduce-scatter/all-gather rows too
            (``calibrate.calibrate_from_drift``).
    """

    def __init__(self, memory_budget_bytes=None, optimizer_slots=2,
                 candidates=None, cost_params=None, trace_dir=None,
                 num_replicas=None, sparse_lookups_per_replica=4096,
                 drift_table=None):
        self._budget = memory_budget_bytes
        self._optimizer_slots = optimizer_slots
        self._candidates = candidates
        self._cost_params = cost_params
        self._trace_dir = trace_dir
        self._num_replicas = num_replicas
        self._sparse_lookups = sparse_lookups_per_replica
        # entry-labeled drift table from a previous run's roofline
        # observatory (telemetry.roofline.drift_table): preferred over
        # trace_dir — its samples are tier-labeled by schedule entry
        # (not the replica-groups heuristic) and carry full buffer
        # bytes (not HLO result shapes), so the refit β is exact for
        # reduce-scatter/all-gather rows too
        self._drift_table = drift_table
        # populated by build() for audits / bench reporting
        self.last_ranked = []
        self.last_infeasible = []

    def build(self, graph_item, resource_spec):
        from autodist_tpu_torch.simulator import search
        from autodist_tpu_torch.simulator.calibrate import (
            calibrate_from_drift, calibrate_from_trace)
        from autodist_tpu_torch.simulator.cost_model import CostModelParams

        n = self._num_replicas
        if n is None:
            n = len(replica_devices(resource_spec))
        params = self._cost_params or CostModelParams.from_topology(
            resource_spec.topology)
        if self._drift_table is not None:
            from autodist_tpu_torch.simulator.cost_model import num_node_groups
            k = num_node_groups(resource_spec=resource_spec,
                                num_replicas=n)
            params = calibrate_from_drift(
                params, self._drift_table, n,
                devices_per_node=n // k if k > 1 else n)
        elif self._trace_dir:
            from autodist_tpu_torch.simulator.cost_model import num_node_groups
            k = num_node_groups(resource_spec=resource_spec,
                                num_replicas=n)
            params = calibrate_from_trace(
                params, self._trace_dir, n,
                cross_node=resource_spec.topology.multi_node,
                devices_per_node=n // k if k > 1 else 0)
        feasible, infeasible = search.rank(
            graph_item, resource_spec, candidates=self._candidates,
            memory_budget_bytes=self._budget, params=params,
            num_replicas=n, optimizer_slots=self._optimizer_slots,
            sparse_lookups_per_replica=self._sparse_lookups)
        self.last_ranked = feasible
        self.last_infeasible = infeasible
        if not feasible:
            detail = '; '.join('%s (%s)' % (c.name, c.error)
                               for c in infeasible[:4])
            if self._budget is not None and any(
                    c.report is not None for c in infeasible):
                msg = ('no candidate fits the %d-byte memory budget '
                       'over %d replicas' % (self._budget, n))
            else:
                msg = ('every candidate failed to build over %d '
                       'replicas' % n)
            raise ValueError('AutoStrategy: %s: %s'
                             % (msg, detail or 'no candidates'))
        best = feasible[0]
        logging.info('AutoStrategy picked %s (predicted step %.4g ms, '
                     'peak %.1f MiB) over %d feasible / %d pruned',
                     best.name,
                     best.report.predicted_step_time_s * 1e3,
                     best.report.predicted_peak_bytes / (1 << 20),
                     len(feasible), len(infeasible))
        return best.strategy


class Parallax(StrategyBuilder):
    """Hybrid: dense vars → AllReduce, sparse vars → load-balanced PS
    (arXiv:1808.02621; parallax_strategy.py:38-70)."""

    def __init__(self, chunk_size=128, local_proxy_variable=False,
                 sync=True, staleness=0, all_reduce_spec='AUTO',
                 compressor='NoneCompressor', shared_optimizer=False,
                 hierarchical='auto', weight_update_sharding='never',
                 local_steps=1):
        self.chunk_size = chunk_size
        self.all_reduce_spec = all_reduce_spec
        self.compressor = compressor
        self.hierarchical = hierarchical
        self.weight_update_sharding = weight_update_sharding
        self._local_proxy_variable = local_proxy_variable
        self._sync = sync
        self._staleness = staleness
        self._shared_optimizer = shared_optimizer
        self._local_steps = local_steps

    def build(self, graph_item, resource_spec):
        s = Strategy()
        s.graph_config.replicas = replica_devices(resource_spec)
        loads = {k: 0.0 for k, _ in resource_spec.cpu_devices}
        dense_count = 0
        for var in graph_item.trainable_var_op_to_var.values():
            if graph_item.is_sparse(var):
                min_ps = min(loads, key=loads.get)
                loads[min_ps] += byte_size_load_fn(var)
                s.node_config.append(StrategyNode(
                    var_name=var.name,
                    synchronizer=PSSynchronizer(
                        reduction_destination=min_ps,
                        local_replication=self._local_proxy_variable,
                        sync=self._sync, staleness=self._staleness,
                        shared_optimizer=self._shared_optimizer,
                        local_steps=self._local_steps)))
            else:
                s.node_config.append(StrategyNode(
                    var_name=var.name,
                    synchronizer=AllReduceSynchronizer(
                        spec=self.all_reduce_spec,
                        compressor=self.compressor,
                        group=dense_count // self.chunk_size,
                        chunk_size=self.chunk_size,
                        hierarchical=self.hierarchical,
                        weight_update_sharding=self.
                        weight_update_sharding)))
                dense_count += 1
        return s
