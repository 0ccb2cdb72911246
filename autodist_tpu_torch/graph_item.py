"""GraphItem: the framework's intermediate representation.

Reference parity: ``autodist/graph_item.py:218-553`` wraps a ``tf.Graph``
plus (a) grad→target pairs captured by optimizer monkey-patches, (b) an
``Info`` record replacing TF collections (variables / savers), and (c)
proto serialization.

The port's copy of ``autodist_tpu/graph_item.py``: the GraphItem wraps
the symbolic :class:`~autodist_tpu_torch.frontend.graph.Graph` captured
under ``ad.scope()`` *or* a user-supplied functional train step, and
exposes the same queries the strategy layer needs: trainable variables
with shapes/dtypes/sizes, grad→target pairs, sparsity flags, captured
optimizers, and savers.
"""
import json

import numpy as np

from autodist_tpu_torch.frontend import graph as fe


class Info:
    """Collections replacement: variables + savers (graph_item.py:112-215)."""

    def __init__(self):
        self.variables = []    # list of fe.Variable
        self.savers = []

    def update_variables(self, variables, replace=True):
        if replace:
            self.variables = list(variables)
        else:
            self.variables.extend(variables)

    def update_savers(self, savers, replace=True):
        if replace:
            self.savers = list(savers)
        else:
            self.savers.extend(savers)

    @property
    def trainable_variables(self):
        return [v for v in self.variables if v.trainable]


class GraphItem:
    """The captured program handed from the frontend to strategy + backend."""

    def __init__(self, graph=None, step_fn=None, params=None):
        """Either wrap a symbolic ``graph`` or a functional ``step_fn``.

        Args:
            graph: frontend Graph captured under ``ad.scope()``.
            step_fn: pure function ``(state, *batch) -> (metrics, state)``
                for the functional API (``ad.function``).
            params: example state pytree for the functional API.
        """
        self.graph = graph if graph is not None else fe.Graph()
        self.step_fn = step_fn
        self.params = params
        self.info = Info()

    # -- capture-side queries ---------------------------------------------
    @property
    def all_variables(self):
        return list(self.graph.variables.values())

    @property
    def trainable_var_op_to_var(self):
        """name -> Variable (the reference keys by var op; we key by name)."""
        return {v.name: v for v in self.all_variables if v.trainable}

    @property
    def trainable_variables(self):
        return [v for v in self.all_variables if v.trainable]

    @property
    def grad_target_pairs(self):
        """{grad node: target Variable} captured at apply_gradients time."""
        return dict(self.graph.grad_target_pairs)

    @property
    def grad_target_name_pairs(self):
        return {g.name: v.name for g, v in
                self.graph.grad_target_pairs.items()}

    @property
    def optimizers(self):
        """Captured (class name, args, kwargs) tuples."""
        return list(self.graph.optimizers)

    def var_by_name(self, name):
        return self.graph.variables[name]

    def is_sparse(self, var):
        """Whether the variable's gradient is sparse (embedding read)."""
        if isinstance(var, str):
            var = self.var_by_name(var)
        return bool(var.sparse_read)

    def prepare(self):
        """Sync Info from the captured graph (graph_item.py:494-497)."""
        self.info.update_variables(self.all_variables, replace=True)
        self.info.update_savers(self.graph.savers, replace=True)
        return self

    # -- serialization -----------------------------------------------------
    def to_dict(self):
        """Serializable metadata view (variables + grad pairs + optimizers).

        The reference serializes the whole GraphDef (graph_item.py:499-553);
        here program capture is re-run on every process (same design: each
        worker re-executes the user script and re-captures), so only the
        metadata needs round-tripping.
        """
        return {
            'variables': [{
                'name': v.name,
                'shape': list(v.shape),
                'dtype': str(np.dtype(v.dtype).name),
                'trainable': bool(v.trainable),
                'sparse_read': bool(v.sparse_read),
            } for v in self.all_variables],
            'grad_target_pairs': self.grad_target_name_pairs,
            'optimizers': [
                {'class': c, 'args': list(a), 'kwargs': dict(k)}
                for c, a, k in self.optimizers],
        }

    def serialize(self):
        return json.dumps(self.to_dict(), sort_keys=True)

    @staticmethod
    def metadata_from_serialized(s):
        return json.loads(s)
