"""The port's side of the export, program-dump and adapter tests, run on
every rank of a gloo group (``torch_dsl_worlds.run_group``) or in this
process. Each function is called as ``fn(rank, world, **kwargs)`` and
returns plain Python or numpy values. This module imports no jax.
"""
import os

import numpy as np

import autodist_tpu_torch as ad
import chip_smoke as cs


def dump_phases(rank, world, run_dir):
    """The JAX test's program (one SGD step of mean((w x)^2) under
    AllReduce) with ``AUTODIST_DUMP_GRAPHS`` on and the dumps sent to
    ``run_dir``: the names of the files there (rank 0 writes them)."""
    from autodist_tpu_torch.utils import visualization as viz
    os.environ['AUTODIST_DUMP_GRAPHS'] = '1'
    viz._RUN_DIR = run_dir
    try:
        autodist = cs.fresh_autodist(ad.AllReduce(), 'cpu', world)
        with autodist.scope():
            x = ad.placeholder(shape=[None], dtype=np.float32, name='x')
            w = ad.Variable(2.0, name='w')
            loss = ad.ops.reduce_mean(ad.ops.square(w * x))
            train_op = ad.optimizers.SGD(0.1).minimize(loss, [w])
            sess = autodist.create_distributed_session()
            sess.run(train_op, {x: np.ones(4, np.float32)})
            w_after = sess.get_variable_value('w')
    finally:
        del os.environ['AUTODIST_DUMP_GRAPHS']
    return {'names': sorted(os.listdir(run_dir)) if rank == 0 else [],
            'w': float(w_after)}
