"""autodist_tpu_torch: the PyTorch / CUDA port of autodist_tpu.

A second package beside the JAX reference, ported slice by slice. It
has both user APIs of the JAX package:

- the reference-shaped DSL: a single-device program written under
  ``AutoDist(...).scope()``, a strategy builder assigning each variable
  a synchronizer, and ``sess.run`` executing it with one process per
  device over ``torch.distributed``::

      import autodist_tpu_torch as ad
      autodist = ad.AutoDist(resource_spec_file, ad.AllReduce(128))
      with autodist.scope():
          W = ad.Variable(5.0, name='W')
          b = ad.Variable(0.0, name='b')
          x = ad.placeholder(shape=[None])
          y = ad.placeholder(shape=[None])
          loss = ad.ops.reduce_mean(ad.ops.square(W * x + b - y))
          train_op = ad.optimizers.SGD(0.01).minimize(loss)
      sess = autodist.create_distributed_session()
      sess.run([loss, train_op], {x: batch_x, y: batch_y})

- the functional :class:`Trainer` (``trainer_from_strategy``), which
  trains the Transformer and vision models data-parallel through
  hand-written Hopper kernels, and NCF and the LSTM language model
  (``NCF``, ``LSTMLM``), with ``fit`` / ``evaluate`` / ``profile`` and
  checkpoints that either package restores.

It imports torch and numpy, never jax or the JAX package.
"""
from autodist_tpu_torch.api import Trainer, TrainState  # noqa: F401
from autodist_tpu_torch.autodist import (  # noqa: F401
    AutoDist, get_default_autodist)
from autodist_tpu_torch.frontend import ops  # noqa: F401
from autodist_tpu_torch.frontend import optimizers  # noqa: F401
from autodist_tpu_torch.frontend.graph import (  # noqa: F401
    Graph, Placeholder, Variable, gradients, placeholder)
from autodist_tpu_torch.graph_item import GraphItem  # noqa: F401
from autodist_tpu_torch.models import LSTMLM, NCF  # noqa: F401
from autodist_tpu_torch.parallel.axes import ParallelSpec  # noqa: F401
from autodist_tpu_torch.resource_spec import ResourceSpec  # noqa: F401
from autodist_tpu_torch.strategy import (  # noqa: F401
    PS, AllReduce, Parallax, PartitionedAR, PartitionedPS,
    PSLoadBalancing, RandomAxisPartitionAR, UnevenPartitionedPS)
from autodist_tpu_torch.strategy.adapter import (  # noqa: F401
    trainer_from_strategy)

__version__ = '0.1.0'
