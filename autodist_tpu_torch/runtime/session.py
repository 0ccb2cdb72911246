"""Session: runs the captured program step by step.

The counterpart of ``autodist_tpu/runtime/session.py`` on its lock-step
(SPMD) path. The JAX session interprets the captured program once
inside ``shard_map`` and jit-compiles it; the port runs one process per
replica and interprets the program eagerly every step, on this
replica's tensors, with the gradient synchronization of the execution
plan over ``torch.distributed``. Every process of the replica group
calls ``run`` with the same fetches, as every jax process enters the
same program.

- **feeds** (reference remapper.py:109-123) are process-local: each
  process feeds its own batch, which is its replica's whole feed;
- **fetches** (remapper.py:125-185): train ops fetch as None; tensors
  return this replica's value (a process holds one replica, so there is
  nothing to concatenate);
- **state**: variables, optimizer slots and compressor aux state live
  on this replica's device; ZeRO-sharded variables and their slots hold
  this replica's shard, gathered at the start of every run; the aux
  state (error-feedback residuals) is this replica's own.

Loose mode (the relaxed-consistency PS plane) is ROADMAP.md Queue 1's
"Loose-mode PS plane" item; checkpointing came with the Trainer's
(``checkpoint/saver.py``).
"""
import contextlib
import os
import time
from collections import deque

import numpy as np
import torch
import torch.distributed as dist

from autodist_tpu_torch.const import DEFAULT_TRACE_DIR, ENV
from autodist_tpu_torch.frontend import graph as fe
from autodist_tpu_torch.parallel.plan import ShardedGrad
from autodist_tpu_torch.telemetry import core as _telemetry
from autodist_tpu_torch.utils import logging


class RunOptions:
    """Shim for tf.RunOptions: ``trace_level > 0`` records the step with
    ``torch.profiler`` into a Chrome trace under ``trace_dir``."""

    NO_TRACE = 0
    FULL_TRACE = 3

    def __init__(self, trace_level=0, trace_dir=None):
        self.trace_level = trace_level
        self.trace_dir = trace_dir or DEFAULT_TRACE_DIR


def to_numpy(t):
    """A fetched tensor on the host (bfloat16, which numpy lacks, as
    float32)."""
    if not torch.is_tensor(t):
        return np.asarray(t)
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


class Session:
    """Holds the state and runs the interpreted step."""

    def __init__(self, graph_item, plan):
        self._graph_item = graph_item
        self._plan = plan
        self._group = plan.group
        self._device = plan.group.device
        self._step_count = 0
        self._closed = False
        self._tel = _telemetry.get()
        self._step_walls = deque(maxlen=ENV.AUTODIST_TELEMETRY_MAX_SPANS.val)
        # graph-mutation guard (reference autodist.py:152-165); the
        # framework's own VariableRead nodes are not counted
        self._built_node_count = self._user_node_count()
        self._init_state()

    def _user_node_count(self):
        return sum(1 for n in self._graph_item.graph.nodes
                   if not isinstance(n, fe.VariableRead))

    def refresh_mutation_guard(self):
        """Re-baseline the mutation guard after a sanctioned graph
        extension (a later ``autodist.function`` trace), and give any
        newly seen (optimizer, variable) pair its slots."""
        self._built_node_count = self._user_node_count()
        self._refresh_opt_state()

    # -- state ------------------------------------------------------------
    def _tensor(self, value):
        return torch.as_tensor(np.asarray(value), device=self._device)

    def _init_state(self):
        plan, group = self._plan, self._group
        variables = self._graph_item.graph.variables
        full = {name: self._tensor(v.init_value)
                for name, v in variables.items()}
        if group.size > 1:
            # replicas start from the chief's initial values (reference
            # all_reduce_synchronizer.py:175-196)
            src = group._global(0)
            for name in sorted(full):
                dist.broadcast(full[name], src, group=group.group)
        self._var_state = {name: plan.local_shard(name, val)
                           for name, val in full.items()}
        self._opt_state = {}
        self._refresh_opt_state(full)
        # compressor aux state: this replica's own (error-feedback
        # residuals differ per replica)
        self._aux_state = {}
        for name, vplan in plan.var_plans.items():
            aux = vplan.compressor.init_state(
                np.asarray(vplan.var.init_value))
            if aux:
                self._aux_state['compressor/%s' % name] = {
                    k: v.to(self._device) for k, v in aux.items()}

    def _refresh_opt_state(self, values=None):
        """Init + place slot state {uid: {var name: state}} for every
        (optimizer, var) pair of the graph not yet covered (one
        optimizer may minimize several losses), from ``values`` (full
        variable values on the device) or the initial values. Returns
        True when anything was added."""
        added = False
        opt_vars = {}
        for node in self._graph_item.graph.nodes:
            if isinstance(node, fe.ApplyGradients):
                opt = node.optimizer
                _, seen = opt_vars.setdefault(opt.uid, (opt, {}))
                for _, v in node.grads_and_vars:
                    seen[v.name] = v
        for uid, (opt, seen) in opt_vars.items():
            have = self._opt_state.get(uid, {})
            missing = [v for name, v in seen.items() if name not in have]
            if not missing:
                continue
            slots = opt.init_slot_state(missing, {
                v.name: values[v.name] if values else
                self._tensor(v.init_value) for v in missing})
            state = self._opt_state.setdefault(uid, {})
            for vname, leafstate in slots.items():
                state[vname] = self._place_slots(vname, leafstate)
                added = True
        return added

    def _place_slots(self, var_name, leafstate):
        """Shard slots like their variable (ZeRO, padded like it for
        uneven partitions); weight-update-sharded variables keep their
        slots as FLAT 1/n shards (row-major, zero-padded); scalars (the
        step counts) are the replica's own."""
        var = self._graph_item.var_by_name(var_name)
        vplan = self._plan.var_plans.get(var_name)
        wus = vplan is not None and vplan.update_sharded

        def place(leaf):
            if not torch.is_tensor(leaf):
                return leaf
            leaf = leaf.to(self._device)
            if tuple(leaf.shape) != tuple(var.shape):
                return leaf
            if wus:
                flat = torch.nn.functional.pad(leaf.reshape(-1),
                                               (0, vplan.wus_pad))
                m = vplan.wus_shard
                return flat[self._group.rank * m:
                            (self._group.rank + 1) * m].clone()
            return self._plan.local_shard(var_name, leaf)

        return {k: place(v) for k, v in leafstate.items()}

    # -- run --------------------------------------------------------------
    def run(self, fetches, feed_dict=None, options=None):
        """Execute fetches (reference WrappedSession.run,
        runner.py:117-132). Every executed train step records one
        wall-time sample (:attr:`step_wall_series`)."""
        t0 = time.perf_counter()
        before = self._step_count
        results = self._run_fetches(fetches, feed_dict, options)
        if self._step_count > before:
            wall = time.perf_counter() - t0
            self._step_walls.append(wall)
            if self._tel.enabled:
                self._tel.observe('step_wall_s', wall)
                self._tel.gauge('step', self._step_count)
                self._tel.record_span('step', t0, wall,
                                      step=self._step_count,
                                      worker='p%d' % self._group.rank)
        return results

    @property
    def step_wall_series(self):
        """Wall seconds of the recent train steps (bounded)."""
        return list(self._step_walls)

    def _feed(self, value):
        if torch.is_tensor(value):
            return value.to(self._device)
        v = np.asarray(value)
        if v.dtype == np.float64:
            v = v.astype(np.float32)
        return torch.from_numpy(np.ascontiguousarray(v)).to(self._device)

    def _run_fetches(self, fetches, feed_dict=None, options=None):
        if self._closed:
            raise RuntimeError('Session is closed')
        if ENV.AUTODIST_IS_TESTING.val and \
                self._user_node_count() != self._built_node_count:
            raise RuntimeError(
                'Graph modified after distributed session creation '
                '(%d nodes, built with %d)' %
                (self._user_node_count(), self._built_node_count))
        feed_dict = feed_dict or {}
        single = not isinstance(fetches, (list, tuple))
        fetch_list = [fetches] if single else list(fetches)
        norm = [f.read() if isinstance(f, fe.Variable) else f
                for f in fetch_list]
        feeds = {ph: self._feed(value) for ph, value in feed_dict.items()}
        # a run is a training step only if it executes an optimizer
        # update; fetch-only runs do not advance the step count
        is_train = any(isinstance(f, fe.ApplyGradients) for f in norm)
        tracing = options is not None and \
            getattr(options, 'trace_level', 0) > 0
        profiler = torch.profiler.profile() if tracing else \
            contextlib.nullcontext()
        with profiler, torch.no_grad():
            outs = self._step(norm, feeds)
        if tracing:
            os.makedirs(options.trace_dir, exist_ok=True)
            path = os.path.join(options.trace_dir, 'step_%d_rank_%d.json'
                                % (self._step_count, self._group.rank))
            profiler.export_chrome_trace(path)
            logging.info('Profiler trace written to %s', path)
        if is_train:
            self._step_count += 1
        results = [self._contract(f, o) for f, o in zip(norm, outs)]
        return results[0] if single else results

    def _step(self, fetch_nodes, feeds):
        plan = self._plan
        full = dict(self._var_state)
        for name, p in plan.var_plans.items():
            if p.state_sharded:
                full[name] = ShardedGrad(
                    self._var_state[name], p.shard_axis, self._group,
                    logical_dim=p.var.shape[p.shard_axis],
                    hier_groups=plan.gather_hier_groups(p)).gather()
        env = fe.Env(full, feeds, grad_sync_fn=plan.sync_gradients,
                     opt_state=self._opt_state, aux_state=self._aux_state)
        env.var_shards = dict(self._var_state)
        env.plan = plan
        env.device = self._device
        outs = [fe._degrade(fe.evaluate(node, env)) for node in fetch_nodes]
        self._var_state.update(env.updates)
        for uid, slots in env.opt_updates.items():
            self._opt_state[uid] = {**self._opt_state.get(uid, {}), **slots}
        self._aux_state.update(env.aux_updates)
        return outs

    def _contract(self, fetch, value):
        """The reference fetch contract over this process's one replica:
        train ops fetch as None, everything else as this replica's value
        (the JAX package concatenates a polymorphic-dim fetch over its
        process's replicas; here there is one)."""
        if isinstance(fetch, fe.ApplyGradients):
            return None
        if isinstance(value, list):  # list-valued fetch (Gradients)
            return [to_numpy(v) for v in value]
        if isinstance(value, tuple):
            return tuple(to_numpy(v) for v in value)
        return to_numpy(value)

    # -- lifecycle ---------------------------------------------------------
    def close(self):
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def step_count(self):
        return self._step_count

    # state access for savers / tests
    def get_variable_value(self, var):
        """The variable's logical value on the host; a ZeRO-sharded
        variable is gathered (a collective: every replica calls it)."""
        name = var.name if isinstance(var, fe.Variable) else var
        value = self._var_state[name]
        p = self._plan.var_plans.get(name)
        if p is not None and p.state_sharded:
            value = self._plan.unpad_host(name, self._group.all_gather(
                value, axis=p.shard_axis))
        return to_numpy(value)

    def load_variable_value(self, var, value):
        name = var.name if isinstance(var, fe.Variable) else var
        dtype = self._var_state[name].dtype
        self._var_state[name] = self._plan.local_shard(
            name, self._tensor(value).to(dtype))
