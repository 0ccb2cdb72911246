"""User-facing engine: the :class:`AutoDist` object.

The counterpart of ``autodist_tpu/autodist.py`` (reference
``autodist/autodist.py:297-322``): construct with a resource spec and a
strategy builder, capture the model under ``.scope()``, then
``create_distributed_session()`` (TF1-style) or ``.function()``
(TF2-style).

The port runs one process per device: the replicas are the ranks of
the default ``torch.distributed`` group (formed here from
``AUTODIST_PROCESS_ID`` / ``AUTODIST_NUM_PROCESSES`` or torchrun's
``RANK`` / ``WORLD_SIZE`` when the caller has not formed it; NCCL on the
card, gloo on the CPU), or the one process when there is no group. The
chief (rank 0) builds and serializes the strategy and broadcasts it to
the other ranks, which deserialize it — never each its own (a
``RandomAxisPartitionAR`` or a strategy id would differ). Every rank
then lowers it to the same execution plan.

A strategy whose synchronizers are all relaxed-consistency PS
(``staleness > 0`` or ``sync=False``) runs in loose mode across several
processes (JAX ``autodist.py:337-347``): every process runs its own
program on its own device, with no group across the workers, and the
variables live on the native coord service
(:class:`~autodist_tpu_torch.runtime.loose_session.LooseSession`). The
control plane that carries it (:meth:`AutoDist._ensure_control_plane`)
also carries the strategy from the chief to the workers whenever the
run names its coord service (``AUTODIST_COORD_SERVICE_ADDR``) and no
group is formed yet.
"""
import atexit
import base64
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from autodist_tpu_torch.const import DEFAULT_COORD_PORT, ENV
from autodist_tpu_torch.frontend import graph as fe
from autodist_tpu_torch.graph_item import GraphItem
from autodist_tpu_torch.parallel.mesh import ReplicaGroup, mesh_from_strategy
from autodist_tpu_torch.parallel.plan import ExecutionPlan
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.runtime.cluster import (Cluster, is_local_address,
                                               world_and_rank)
from autodist_tpu_torch.runtime.device_resolver import DeviceResolver
from autodist_tpu_torch.runtime.session import Session
from autodist_tpu_torch.strategy import base as strategy_base
from autodist_tpu_torch.strategy.builders import PSLoadBalancing
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.utils import visualization as viz
from autodist_tpu_torch.utils.device import resolve_device

_DEFAULT_AUTODIST = {}


def set_default_autodist(o):
    """Register the process's AutoDist instance (one per process)."""
    if os.getpid() in _DEFAULT_AUTODIST:
        raise NotImplementedError(
            'Currently only one AutoDist instance is allowed in one process.')
    _DEFAULT_AUTODIST[os.getpid()] = o


def get_default_autodist():
    return _DEFAULT_AUTODIST.get(os.getpid(), None)


def _default_resource_info():
    """Single-node spec with one device for each process of the run."""
    world, _ = world_and_rank()
    return {'nodes': [{'address': 'localhost', 'chief': True, 'cpus': [0],
                       'gpus': list(range(world)),
                       'network_bandwidth': 100}]}


class AutoDist:
    """Distributed-training engine with minimal-code-change ergonomics.

    Args:
        resource_spec_file: path to a resource spec YAML. Defaults to a
            single-node spec with one device for each process.
        strategy_builder: a StrategyBuilder (default PSLoadBalancing, as
            in the reference autodist.py:70).
        resource_info: the spec as a dict, in place of the file.
        device: where the replicas compute; ``cuda`` (each rank on its
            resolved card) unless the caller asks for ``'cpu'``.
    """

    def __init__(self, resource_spec_file=None, strategy_builder=None,
                 resource_info=None, device=None):
        set_default_autodist(self)
        if resource_spec_file is None and resource_info is None and \
                ENV.SYS_RESOURCE_PATH.val:
            resource_spec_file = ENV.SYS_RESOURCE_PATH.val
        if resource_spec_file is not None:
            self._resource_spec = ResourceSpec(
                resource_file=resource_spec_file)
        else:
            self._resource_spec = ResourceSpec(
                resource_info=resource_info or _default_resource_info())
        self._strategy_builder = strategy_builder or PSLoadBalancing()
        self._device = resolve_device(device)
        self._original_graph_item = None
        self._transformed = None      # (strategy, group, plan)
        self._session = None
        self._cluster = Cluster(self._resource_spec)
        self._built = False
        self._ext_launched = \
            os.environ.get(ENV.AUTODIST_PROCESS_ID.name) is not None or \
            os.environ.get('WORLD_SIZE') is not None or \
            (dist.is_available() and dist.is_initialized())
        self._coord = None   # coord-service client (loose mode)
        self._fn_cache = {}

    # -- capture -----------------------------------------------------------
    def scope(self):
        """Context manager capturing the code block to be distributed
        (reference autodist.py:309-322)."""
        self._original_graph_item = GraphItem(graph=fe.Graph())
        return self._original_graph_item.graph

    # -- strategy ----------------------------------------------------------
    def build_strategy(self):
        """Build the Strategy for the captured graph (autodist.py:91-98)."""
        return self._strategy_builder.build(
            self._original_graph_item, self._resource_spec)

    def _build_or_load_strategy(self, world, rank):
        """The chief builds and serializes the strategy and sends it to
        the other ranks — over the coord service when the control plane
        is up, else over the group — and they deserialize what it sent
        (JAX ``autodist.py:109-142``)."""
        self._original_graph_item.prepare()
        s = None
        ns = ENV.AUTODIST_RUN_ID.val
        if rank == 0:
            s = self.build_strategy()
            s.serialize()
        if world == 1:
            return s
        if self._coord is not None:
            if rank == 0:
                blob = base64.b64encode(json.dumps(
                    s.to_dict()).encode()).decode()
                self._coord.set('strategy/%s/blob' % ns, blob)
                self._coord.set('strategy/%s/id' % ns, s.id)
                return s
            self._coord.wait_key('strategy/%s/id' % ns, timeout_s=120.0)
            blob = self._coord.get('strategy/%s/blob' % ns)
            return strategy_base.Strategy.from_dict(
                json.loads(base64.b64decode(blob).decode()))
        box = [s.to_dict() if rank == 0 else None]
        dist.broadcast_object_list(box, src=0)
        if rank:
            s = strategy_base.Strategy.from_dict(box[0])
        return s

    def _ensure_control_plane(self, rank, world):
        """Bring up, or connect to, the native coord service and the PS
        endpoints of this host (JAX ``autodist.py:161-305``). The chief
        starts the service when its address names this host; every
        process connects. Processes that a launcher started together
        meet at an init barrier after the chief has cleared a reused
        service's strategy keys, so no worker reads a stale one."""
        if self._coord is not None:
            return
        from autodist_tpu_torch.runtime import coord_client as cc
        nodes = list(self._resource_spec.nodes)
        addr = ENV.AUTODIST_COORD_SERVICE_ADDR.val or \
            '%s:%d' % (self._resource_spec.chief, DEFAULT_COORD_PORT)
        host, port = addr.rsplit(':', 1)
        all_local = all(is_local_address(n) for n in nodes)
        bind = '127.0.0.1' if all_local else '0.0.0.0'
        if rank == 0 and (host == self._resource_spec.chief or
                          is_local_address(host)):
            proc = cc.ensure_service(int(port), bind=bind)
            if proc is not None and not self._ext_launched:
                # the chief owns a service it started for a run nobody
                # launched; otherwise the launcher owns its lifetime
                atexit.register(proc.terminate)
        # an all-local run binds loopback, so every process dials it
        self._coord = cc.connect_with_retry(
            ('127.0.0.1' if all_local else host, int(port)))
        for ep_host, ep_port in cc.ps_endpoints():
            if is_local_address(ep_host):
                proc = cc.ensure_service(ep_port, bind=bind)
                if proc is not None and not self._ext_launched:
                    atexit.register(proc.terminate)
        if not self._ext_launched:
            return
        ns = ENV.AUTODIST_RUN_ID.val
        if rank == 0:
            self._coord.delete('strategy/%s/id' % ns)
            self._coord.delete('strategy/%s/blob' % ns)
            # a previous run's marker would let this run's workers skip
            # the barrier and read the keys mid-delete
            self._coord.delete('ctrl/init-done/%s' % ns)
            self._coord.barrier('ctrl/init/%s' % ns, world,
                                timeout_s=120.0)
            # a supervised replacement started after a crash must not
            # block on a barrier its cohort already passed
            self._coord.set('ctrl/init-done/%s' % ns, '1')
        elif ENV.AUTODIST_ELASTIC_JOIN.val:
            # a live joiner starts after the rendezvous and is no party
            # the chief counted: it waits for the marker instead
            self._coord.wait_key('ctrl/init-done/%s' % ns, timeout_s=120.0)
        else:
            # a fresh member and a replacement look alike here: try the
            # barrier, and between bounded slices look for the marker
            # (JAX ``autodist.py:258-287``; 2 s slices, where the JAX
            # package's are 10 s, bound a replacement's wait)
            deadline = time.time() + 120.0
            while True:
                try:
                    self._coord.barrier(
                        'ctrl/init/%s' % ns, world,
                        timeout_s=min(2.0, max(1.0,
                                               deadline - time.time())))
                    break
                except TimeoutError:
                    if self._coord.get('ctrl/init-done/%s' % ns) \
                            is not None:
                        break
                    if time.time() >= deadline:
                        raise

    def _uses_control_plane(self, world):
        """True when the strategy travels over the coord service: a run
        of several processes that names its service and has no group."""
        return world > 1 and bool(ENV.AUTODIST_COORD_SERVICE_ADDR.val) \
            and not (dist.is_available() and dist.is_initialized())

    @staticmethod
    def _strategy_is_loose(strategy):
        """True when every synchronizer is relaxed-consistency PS
        (staleness > 0 or sync=False): the JAX package then runs
        independent processes around its PS data plane."""
        syncs = []
        for node in strategy.node_config:
            syncs.extend(node.part_config if node.part_config
                         else [node.synchronizer])
        ps = [s for s in syncs
              if isinstance(s, strategy_base.PSSynchronizer)]
        if len(ps) != len(syncs) or not ps:
            return False
        return all(s.staleness > 0 or not s.sync for s in ps)

    def _build(self):
        nodes = list(self._resource_spec.nodes)
        if len(nodes) > 1 and not self._ext_launched:
            raise NotImplementedError(
                'a spec of %d nodes asks the chief to launch the workers '
                'over ssh: the Coordinator launch is not ported yet '
                '(ROADMAP.md Queue 1: Loose-mode PS plane); start one '
                'process per device yourself (AUTODIST_PROCESS_ID / '
                'AUTODIST_NUM_PROCESSES, or torchrun)' % len(nodes))
        world, rank = world_and_rank()
        resolver = DeviceResolver(self._resource_spec, world,
                                  self._device.type)
        device = self._device_of(resolver, rank)
        if device.type == 'cuda':
            # NCCL (and broadcast_object_list on it) works on the
            # current device: each rank on its own card
            torch.cuda.set_device(device)
        if self._uses_control_plane(world):
            self._ensure_control_plane(rank, world)
        else:
            world, rank = self._cluster.start(device.type)
        # phase dumps (reference graph_transformer.py:62-90 logs the graph
        # after each transform phase; AUTODIST_DUMP_GRAPHS gates ours)
        viz.log_text('\n'.join(
            repr(n) for n in self._original_graph_item.graph.nodes),
            '0-original-capture')
        strategy = self._build_or_load_strategy(world, rank)
        viz.log_text(strategy, '1-strategy')
        compiler = strategy_base.StrategyCompiler(self._original_graph_item)
        # prune before the mode decision: nodes of variables this graph
        # does not have must not decide it
        strategy = compiler.prune(strategy)
        loose = world > 1 and self._strategy_is_loose(strategy)
        if loose:
            # independent processes around the coord service's PS; the
            # strategy's devices stay as it names them
            logging.info('Relaxed-consistency PS strategy: loose '
                         'multi-process mode (process %d of %d)', rank,
                         world)
            self._ensure_control_plane(rank, world)
            group = ReplicaGroup(1, 0, None, device)
        else:
            if self._coord is not None:
                world, rank = self._cluster.start(device.type)
            compiler.set_device_resolver(resolver)
        compiled = compiler.compile(strategy)
        logging.debug('Compiled strategy: %s', compiled)
        viz.log_text(compiled, '2-compiled-strategy')
        if not loose:
            n = mesh_from_strategy(compiled, world)
            if n < world:
                raise ValueError(
                    'the strategy places %d replicas but the run has %d '
                    'processes; start one process per replica'
                    % (n, world))
            group = ReplicaGroup(n, rank, None, device)
        plan = ExecutionPlan(compiled, self._original_graph_item, group,
                             topology=self._resource_spec.topology,
                             ranks_per_node=None if loose else
                             resolver.ranks_per_node(), loose=loose)
        described = plan.describe()
        logging.debug(described)
        viz.log_text(described, '3-execution-plan')
        self._transformed = (compiled, group, plan)
        self._built = True

    def _device_of(self, resolver, rank):
        """This rank's device: the one asked for, or for ``cuda`` the
        card of the spec's device that resolves to this rank."""
        if self._device.type != 'cuda' or self._device.index is not None:
            return self._device
        for name, _ in self._resource_spec.accelerator_devices:
            r = resolver.resolve(name)
            if r is not None and r.rank == rank and r.device is not None:
                return r.device
        return resolve_device('cuda:%d' % (
            rank % max(1, torch.cuda.device_count())))

    def is_built(self):
        return self._built

    # -- execution ---------------------------------------------------------
    def create_distributed_session(self):
        """Create the distributed Session (reference autodist.py:191-198)."""
        if not self.is_built():
            self._build()
        _, _, plan = self._transformed
        if plan.loose:
            from autodist_tpu_torch.runtime.loose_session import \
                LooseSession
            self._session = LooseSession(self._original_graph_item, plan,
                                         self._coord,
                                         resource_spec=self._resource_spec)
        else:
            self._session = Session(self._original_graph_item, plan)
        atexit.register(self._session.close)
        return self._session

    def function(self, fn):
        """TF2-style wrapper (reference autodist.py:269-289): ndarray args
        become placeholders (first dim batch-polymorphic), the traced
        fetches run through a distributed session on every call."""
        def wrapper(*args, **kwargs):
            key = id(fn)
            if key not in self._fn_cache:
                # the entry holds a strong ref to fn: id() stays unique
                self._fn_cache[key] = (fn,
                                       self._build_fn(fn, *args, **kwargs))
            return self._fn_cache[key][1](*args, **kwargs)
        return wrapper

    def _build_fn(self, fn, *args, **kwargs):
        # Later functions extend the SAME graph and share the session;
        # they may reuse variables but not introduce new ones (the
        # strategy has no node_config for them). Snapshot first so a
        # rejected trace rolls back completely.
        graph = self._original_graph_item.graph
        extending = self._session is not None
        nodes_before = len(graph.nodes)
        vars_before = set(graph.variables)
        pairs_before = dict(graph.grad_target_pairs)
        opts_before = len(graph.optimizers)
        savers_before = len(graph.savers)
        ph_index = {}
        args_ph, kwargs_ph = [], {}
        for i, a in enumerate(args):
            if isinstance(a, np.ndarray):
                ph = fe.Placeholder((None,) + a.shape[1:],
                                    a.dtype, name='arg%d' % i)
                ph_index[ph] = i
                args_ph.append(ph)
            else:
                args_ph.append(a)
        for k, v in kwargs.items():
            if isinstance(v, np.ndarray):
                ph = fe.Placeholder((None,) + v.shape[1:], v.dtype,
                                    name='kwarg_%s' % k)
                ph_index[ph] = k
                kwargs_ph[k] = ph
            else:
                kwargs_ph[k] = v

        def _rollback():
            del graph.nodes[nodes_before:]
            for name in set(graph.variables) - vars_before:
                del graph.variables[name]
            graph.grad_target_pairs = pairs_before
            del graph.optimizers[opts_before:]
            del graph.savers[savers_before:]

        try:
            with graph:
                fetches = fn(*args_ph, **kwargs_ph)
        except Exception:
            _rollback()
            raise
        if extending:
            new_vars = set(graph.variables) - vars_before
            if new_vars:
                _rollback()
                raise ValueError(
                    "a later 'autodist.function' created new variables %s "
                    "after the strategy was built; create all variables "
                    "under the first traced function (or one scope) so "
                    "the strategy covers them" % sorted(new_vars))
            session = self._session
            session.refresh_mutation_guard()
        else:
            session = self.create_distributed_session()

        def run_fn(*args, **kwargs):
            feed = {}
            for ph, idx in ph_index.items():
                feed[ph] = args[idx] if isinstance(idx, int) \
                    else kwargs[idx]
            return session.run(fetches, feed)
        return run_fn

