"""The port's side of the loose multi-process tests: each function runs
in every worker process of :func:`torch_loose_worlds.run_loose` as
``fn(pid, nprocs, **kwargs)`` and mirrors a loose case of
``tests/integration/test_multiprocess.py``. This module imports no jax.
"""
import os
import time

import numpy as np

import autodist_tpu_torch as ad

# reference c0 data (cases/c0.py), one seed a worker
SEEDS = (123, 456, 789, 1011)


def make_data(seed):
    np.random.seed(seed)
    inputs = np.random.randn(1000)
    noises = np.random.randn(1000)
    outputs = inputs * 3.0 + 2.0 + noises
    return inputs.astype(np.float32), outputs.astype(np.float32)


def _autodist(builder, nprocs, nodes=1):
    """An AutoDist over one node of ``nprocs`` devices, or over ``nodes``
    one-device nodes (two PS destinations, as the JAX test's spec)."""
    from autodist_tpu_torch import autodist as ad_mod
    ad_mod._DEFAULT_AUTODIST.clear()
    spec = [{'address': 'localhost', 'gpus': list(range(nprocs)),
             'chief': True, 'network_bandwidth': 100}]
    if nodes > 1:
        spec = [{'address': addr, 'gpus': [0], 'network_bandwidth': 100}
                for addr in ('localhost', '127.0.0.1')[:nodes]]
        spec[0]['chief'] = True
    return ad.AutoDist(resource_info={'nodes': spec},
                       strategy_builder=builder, device='cpu')


def _linear(autodist, opt):
    """The c0 program: (session, x, y, W, b, train_op)."""
    with autodist.scope():
        x = ad.placeholder(shape=[None], dtype=np.float32, name='x')
        y = ad.placeholder(shape=[None], dtype=np.float32, name='y')
        W = ad.Variable(5.0, name='W')
        b = ad.Variable(0.0, name='b')
        loss = ad.ops.reduce_mean(ad.ops.square(W * x + b - y))
        train_op = opt.minimize(loss, [W, b])
        sess = autodist.create_distributed_session()
    return sess, x, y, train_op


def _finish(autodist, sess, nprocs):
    """Both workers done pushing, then each closes (the last one out
    purges the namespace, so nobody reads after it)."""
    tag = os.environ['AUTODIST_RUN_ID']
    autodist._coord.barrier('test/%s/trained' % tag, nprocs,
                            timeout_s=120.0)
    b = float(np.ravel(sess.get_variable_value('b'))[0])
    autodist._coord.barrier('test/%s/read' % tag, nprocs, timeout_s=120.0)
    sess.close()
    return b


def staleness(pid, nprocs, steps=8, sleep_s=0.3, **builder_kwargs):
    """The chief runs ahead of slow workers; returns how far ahead of
    the slowest it was after each step, the final b, and the proxy
    hits (c9 semantics, cases/c9.py:14-21)."""
    autodist = _autodist(ad.PS(**builder_kwargs), nprocs)
    inputs, outputs = make_data(SEEDS[pid])
    sess, x, y, train_op = _linear(autodist, ad.optimizers.SGD(0.01))
    lead = []
    for step in range(1, steps + 1):
        sess.run(train_op, {x: inputs, y: outputs})
        if pid == 0:
            lead.append(step - min(sess.peer_step(i)
                                   for i in range(1, nprocs)))
        else:
            time.sleep(sleep_s)
    hits = sess._proxy_hits
    stats = sess.ps_stats
    return {'lead': lead, 'b': _finish(autodist, sess, nprocs),
            'proxy_hits': hits, 'max_lag': stats['pipeline']['max_lag'],
            'push_bytes': stats['push_bytes']}


def shared_optimizer(pid, nprocs, opt='momentum', shared=True):
    """Five steps of both workers on the same data, the optimizer's
    slots on the PS (BSTEP) or on each worker."""
    autodist = _autodist(ad.PS(staleness=1, shared_optimizer=shared),
                         nprocs)
    inputs, outputs = make_data(123)
    optimizer = ad.optimizers.Momentum(0.01, momentum=0.9) \
        if opt == 'momentum' else ad.optimizers.Adam(0.05)
    sess, x, y, train_op = _linear(autodist, optimizer)
    for _ in range(5):
        sess.run(train_op, {x: inputs, y: outputs})
    tag = os.environ['AUTODIST_RUN_ID']
    autodist._coord.barrier('test/%s/pushed' % tag, nprocs,
                            timeout_s=120.0)
    # b's tensor on the endpoint the session placed it on
    ep = sess._shard_endpoints('b', 1)[0]
    stat = sess._pool.run([(ep, lambda c: c.vstat(sess._key('var/b')))])[0]
    pushes = sess._shared_pushes
    return {'b': _finish(autodist, sess, nprocs), 'stat': stat,
            'shared_pushes': pushes}


def partitioned(pid, nprocs, dim=64):
    """One partitioned variable over two PS endpoints: each shard on
    its own, the bytes split between them."""
    autodist = _autodist(ad.PartitionedPS(staleness=1), nprocs, nodes=2)
    rng = np.random.RandomState(0)
    W0 = (rng.randn(dim, dim) / dim).astype(np.float32)
    xs = rng.randn(8, dim).astype(np.float32)
    ys = rng.randn(8, dim).astype(np.float32)
    with autodist.scope():
        x = ad.placeholder(shape=[None, dim], dtype=np.float32, name='x')
        y = ad.placeholder(shape=[None, dim], dtype=np.float32, name='y')
        W = ad.Variable(W0, name='W')
        loss = ad.ops.reduce_mean(ad.ops.square(ad.ops.matmul(x, W) - y))
        train_op = ad.optimizers.SGD(0.1).minimize(loss, [W])
        sess = autodist.create_distributed_session()
    for _ in range(3):
        sess.run(train_op, {x: xs, y: ys})
    stats = sess.ps_stats
    tag = os.environ['AUTODIST_RUN_ID']
    autodist._coord.barrier('test/%s/trained' % tag, nprocs,
                            timeout_s=120.0)
    W_after = sess.get_variable_value('W')
    autodist._coord.barrier('test/%s/read' % tag, nprocs, timeout_s=120.0)
    shard_eps = list(sess._ps_index['W'])
    sess.close()
    half = dim // 2
    return {'shard_eps': shard_eps, 'ep_bytes': stats['bytes_per_endpoint'],
            'moved_lo': float(np.abs(W_after[:half] - W0[:half]).max()),
            'moved_hi': float(np.abs(W_after[half:] - W0[half:]).max())}


def clean_shutdown(pid, nprocs):
    """A worker that closes after 2 steps is released, not dead: the
    chief trains its 10 steps."""
    autodist = _autodist(ad.PS(staleness=2), nprocs)
    inputs, outputs = make_data(SEEDS[pid])
    sess, x, y, train_op = _linear(autodist, ad.optimizers.SGD(0.01))
    if pid:
        for _ in range(2):
            sess.run(train_op, {x: inputs, y: outputs})
        sess.close()
        return {}
    steps, failed = 0, ''
    try:
        for _ in range(10):
            sess.run(train_op, {x: inputs, y: outputs})
            steps += 1
    except RuntimeError as e:
        failed = str(e)
    sess.close()
    return {'steps': steps, 'failed': failed}


def dead_worker(pid, nprocs):
    """The worker dies after 2 steps; the chief, held at the gate, fails
    within the heartbeat window instead of hanging."""
    autodist = _autodist(ad.PS(staleness=2), nprocs)
    inputs, outputs = make_data(SEEDS[pid])
    sess, x, y, train_op = _linear(autodist, ad.optimizers.SGD(0.01))
    if pid:
        for _ in range(2):
            sess.run(train_op, {x: inputs, y: outputs})
        os._exit(17)   # a crash: no cleanup, no barrier
    t0 = time.time()
    steps, failed = 0, ''
    try:
        for _ in range(20):
            sess.run(train_op, {x: inputs, y: outputs})
            steps += 1
    except RuntimeError as e:
        failed = str(e)
    return {'steps': steps, 'failed': failed, 'wait_s': time.time() - t0}


def group_formed(rank, world, steps=3):
    """A loose run in processes that formed their gloo group first (as
    under torchrun; run by ``torch_dsl_worlds.run_group`` with
    ``AUTODIST_COORD_SERVICE_ADDR`` set): the group carries the strategy,
    identity comes from it, and the chief starts the service. The chief
    shuts it down at the end only if it started it: when another process
    took the probed port first, ``ensure_service`` joined that process's
    service, which is not this run's to stop."""
    import torch.distributed as dist
    from autodist_tpu_torch.runtime import coord_client as cc
    from autodist_tpu_torch.utils.loose_harness import stop_service
    started = []
    ensure = cc.ensure_service

    def ensure_recorded(port, **kwargs):
        started.append((port, ensure(port, **kwargs)))
        return started[-1][1]

    cc.ensure_service = ensure_recorded
    try:
        autodist = _autodist(ad.PS(staleness=1), world)
        inputs, outputs = make_data(SEEDS[rank])
        sess, x, y, train_op = _linear(autodist, ad.optimizers.SGD(0.01))
    finally:
        cc.ensure_service = ensure
    for _ in range(steps):
        sess.run(train_op, {x: inputs, y: outputs})
    dist.barrier()
    got = {'session': type(sess).__name__, 'worker': sess._worker_name,
           'workers': sess._num_workers,
           'b': float(np.ravel(sess.get_variable_value('b'))[0])}
    dist.barrier()
    sess.close()
    dist.barrier()
    for port, proc in started:
        if proc is not None:
            stop_service(port, proc)
    return got


def telemetry_pair(pid, nprocs, steps=8):
    """The c0 program at depth 2 with telemetry on (the launcher's env):
    each worker trains ``steps`` steps; the workers close first, then
    the chief, whose close exports the cohort trace with every final
    batch. The chief reports its ``perf`` section, the trace's path and
    what a purge of the telemetry namespace finds after every close."""
    autodist = _autodist(ad.PS(staleness=2), nprocs)
    inputs, outputs = make_data(SEEDS[pid])
    sess, x, y, train_op = _linear(autodist, ad.optimizers.SGD(0.01))
    for _ in range(steps):
        sess.run(train_op, {x: inputs, y: outputs})
    tag = os.environ['AUTODIST_RUN_ID']
    coord = autodist._coord
    coord.barrier('test/%s/trained' % tag, nprocs, timeout_s=120.0)
    out = {'monitor': sess.monitor}
    if pid:
        sess.close()
        coord.barrier('test/%s/closed' % tag, nprocs, timeout_s=120.0)
    else:
        coord.barrier('test/%s/closed' % tag, nprocs, timeout_s=120.0)
        sess.close()
        out = {'perf': sess.health_stats['perf'],
               'trace_path': sess.trace_path,
               'left_after_close': coord.delete_namespace(
                   sess._key('telemetry/'))}
    out['pushed_bytes'] = sess.telemetry_pushed_bytes
    return out
