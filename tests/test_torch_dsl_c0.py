"""The reference DSL path of the port against the JAX package: the c0
linear regression and the rest of
``tests/integration/test_linear_regression.py``.

The same program runs under ``autodist_tpu`` on the 8-device CPU mesh
with ``n_gpus = world`` and under ``autodist_tpu_torch`` with one
process per replica: in this process at world 1, and in one gloo group
of 2 processes (3 for the uneven split) for all the cases at once
(``torch_dsl_worlds.run_group``). Rank r feeds the share of the batch
the JAX package's replica r sees, so rank 0's fetches are the JAX
package's (which returns replica 0's values). Tolerances: 1e-5 on f32
wires, 2e-3 on the bfloat16 ones, as the JAX tests hold them.
"""
import numpy as np
import pytest

import autodist_tpu as jad
import chip_smoke as cs
import torch_dsl_cases as cases
from torch_dsl_worlds import run_group
from autodist_tpu import autodist as jad_mod

STRATEGIES = [name for name, _ in cs.C0_STRATEGIES]


def jax_autodist(builder, n_gpus):
    jad_mod._DEFAULT_AUTODIST.clear()
    return jad.AutoDist(resource_info={'nodes': [{
        'address': 'localhost', 'gpus': list(range(n_gpus)), 'chief': True,
        'network_bandwidth': 100}]}, strategy_builder=builder)


def jax_builder(name):
    import autodist_tpu.strategy as s
    return {
        'AllReduce': lambda: s.AllReduce(chunk_size=128),
        'AllReduce_chunk1': lambda: s.AllReduce(chunk_size=1),
        'AllReduce_ring': lambda: s.AllReduce(chunk_size=128,
                                              all_reduce_spec='RING'),
        'AllReduce_hvd': lambda: s.AllReduce(
            chunk_size=128, compressor='HorovodCompressor'),
        'AllReduce_hvd_ef': lambda: s.AllReduce(
            chunk_size=128, compressor='HorovodCompressorEF'),
        'PS': lambda: s.PS(),
        'PS_proxy': lambda: s.PS(local_proxy_variable=True),
        'PSLoadBalancing': lambda: s.PSLoadBalancing(),
        'PartitionedPS': lambda: s.PartitionedPS(),
        'UnevenPartitionedPS': lambda: s.UnevenPartitionedPS(),
        'PartitionedAR': lambda: s.PartitionedAR(),
        'RandomAxisPartitionAR': lambda: s.RandomAxisPartitionAR(seed=1),
        'Parallax': lambda: s.Parallax(),
        'AutoStrategy': lambda: s.AutoStrategy(),
    }[name]()


def jax_linear_regression(autodist):
    """tests/integration/test_linear_regression.py's program."""
    np.random.seed(123)
    inputs = np.random.randn(1000)
    noises = np.random.randn(1000)
    outputs = inputs * 3.0 + 2.0 + noises
    with autodist.scope():
        x = jad.placeholder(shape=[None], dtype=np.float32, name='x')
        y = jad.placeholder(shape=[None], dtype=np.float32, name='y')
        W = jad.Variable(5.0, name='W')
        b = jad.Variable(0.0, name='b')
        loss = jad.ops.reduce_mean(jad.ops.square(W * x + b - y))
        train_op = jad.optimizers.SGD(0.01).minimize(loss, [W, b])
        sess = autodist.create_distributed_session()
        loss_val, _ = sess.run([loss, train_op], {x: inputs, y: outputs})
        W_val, b_val = sess.run([W, b])
    return float(loss_val), float(W_val), float(b_val), sess


def jax_matrix_regression(builder, n_gpus, d):
    autodist = jax_autodist(builder, n_gpus)
    np.random.seed(7)
    X = np.random.randn(64, d).astype(np.float32)
    y = np.random.randn(64, 1).astype(np.float32)
    with autodist.scope():
        xp = jad.placeholder(shape=[None, d], dtype=np.float32, name='x')
        yp = jad.placeholder(shape=[None, 1], dtype=np.float32, name='y')
        W = jad.Variable(np.linspace(-1, 1, d)[:, None].astype(np.float32),
                         name='W')
        loss = jad.ops.reduce_mean(
            jad.ops.square(jad.ops.matmul(xp, W) - yp))
        train_op = jad.optimizers.Adam(0.05).minimize(loss, [W])
        sess = autodist.create_distributed_session()
        for _ in range(3):
            sess.run(train_op, {xp: X, yp: y})
        return np.asarray(sess.get_variable_value(W))


@pytest.fixture(scope='module')
def world2():
    """Every world-2 case of this file in one gloo group."""
    return run_group(2, [
        ('c0', 'torch_dsl_cases:c0_matrix', {}),
        ('steps', 'torch_dsl_cases:c0_step_count', {}),
        ('replicas8', 'torch_dsl_cases:c0_replicas', {'n_gpus': 8}),
        ('concat', 'torch_dsl_cases:batched_fetch', {}),
        ('shared_opt', 'torch_dsl_cases:shared_optimizer', {}),
        ('uneven_pad', 'torch_dsl_cases:matrix_regression',
         {'builder': 'UnevenPartitionedPS', 'd': 13}),
        ('ef', 'torch_dsl_cases:ef_residual', {}),
        ('loose', 'torch_dsl_cases:loose_policies', {}),
        ('load', 'torch_dsl_cases:load_roundtrip', {}),
    ])


@pytest.fixture(scope='module')
def jax_c0():
    """The JAX package's c0 matrix at 2 replicas: {name: (loss, W, b)}."""
    out = {}
    for name in STRATEGIES:
        out[name] = jax_linear_regression(
            jax_autodist(jax_builder(name), 2))[:3]
    jad_mod._DEFAULT_AUTODIST.clear()
    return out


@pytest.mark.parametrize('name', STRATEGIES)
def test_c0_world1_matches_jax(name, jax_c0):
    """World 1, in this process: the port's one step against the JAX
    package's (whose replicas all hold the same W and b)."""
    loss, W, b = cs.run_linear_regression(cases.fresh(
        cases.builder_named(name)))
    tol = cs.c0_tol(name)
    assert abs(b - cs.EXPECTED_B) <= tol, (name, b)
    assert abs(W - jax_c0[name][1]) <= tol and \
        abs(b - jax_c0[name][2]) <= tol, (name, (W, b), jax_c0[name])
    assert loss > 0


@pytest.mark.parametrize('name', STRATEGIES)
def test_c0_gloo_world2_matches_jax(name, world2, jax_c0):
    tol = cs.c0_tol(name)
    per_rank = [r[name] for r in world2['c0']]
    for loss, W, b in per_rank:
        assert abs(b - cs.EXPECTED_B) <= tol, (name, b)
        assert abs(W - jax_c0[name][1]) <= tol and \
            abs(b - jax_c0[name][2]) <= tol, (name, (W, b), jax_c0[name])
    # rank 0 fetches replica 0's loss, on the first half of the batch
    assert abs(per_rank[0][0] - jax_c0[name][0]) <= \
        tol * max(1.0, abs(jax_c0[name][0])), (name, per_rank[0][0])


def test_fetch_only_runs_do_not_count_steps(world2):
    assert world2['steps'] == [1, 1]


def test_uneven_replica_count_world3():
    """1000 examples over 3 processes: the batch does not split, every
    rank feeds all of it (the JAX package replicates such a feed), and
    the step is the single-device step."""
    out = run_group(3, [('c0', 'torch_dsl_cases:c0_replicas',
                         {'n_gpus': 3})])['c0']
    jax_loss, jax_W, jax_b, _ = jax_linear_regression(
        jax_autodist(jax_builder('AllReduce'), 3))
    for replicas, (loss, W, b) in out:
        assert replicas == 3
        assert abs(b - cs.EXPECTED_B) <= 1e-5
        assert abs(b - jax_b) <= 1e-5 and abs(W - jax_W) <= 1e-5
        assert abs(loss - jax_loss) <= 1e-5 * jax_loss


def test_spec_with_more_replicas_than_processes(world2):
    """A spec of 8 devices on a run of 2 processes takes the 2 that
    exist: the JAX package's rule (``mesh_from_strategy`` caps the
    replica list by the devices) with processes for devices."""
    from autodist_tpu.parallel import mesh as jmesh
    import jax
    _, _, _, sess = jax_linear_regression(
        jax_autodist(jax_builder('AllReduce'), 8))
    strategy = sess._plan.strategy
    jax_n = jmesh.mesh_from_strategy(
        strategy, devices=jax.devices()[:2]).shape['data']
    from autodist_tpu_torch.parallel.mesh import mesh_from_strategy
    assert mesh_from_strategy(strategy, 2) == jax_n == 2
    for replicas, (_, _, b) in world2['replicas8']:
        assert replicas == 2
        assert abs(b - cs.EXPECTED_B) <= 1e-5


def test_fetch_batched_concat(world2):
    """A polymorphic-dim fetch: the JAX package concatenates its 4
    replicas' predictions; each port process returns its replica's,
    and the ranks' outputs in order are the JAX package's."""
    autodist = jax_autodist(jax_builder('AllReduce'), 2)
    with autodist.scope():
        x = jad.placeholder(shape=[None], dtype=np.float32, name='x')
        W = jad.Variable(2.0, name='W')
        pred = jad.ops.reshape(W * x, (-1,))
        sess = autodist.create_distributed_session()
        want = np.asarray(sess.run(pred, {x: np.arange(8, dtype=np.float32)}))
    got = np.concatenate(world2['concat'])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(cases.batched_fetch(0, 1), want)


def test_optimizer_shared_across_two_train_ops(world2):
    autodist = jax_autodist(jax_builder('AllReduce'), 2)
    with autodist.scope():
        a = jad.Variable(1.0, name='a')
        c = jad.Variable(2.0, name='c')
        opt = jad.optimizers.Adam(0.1)
        t1 = opt.minimize(jad.ops.square(a.read()), [a])
        t2 = opt.minimize(jad.ops.square(c.read()), [c])
        sess = autodist.create_distributed_session()
        sess.run([t1, t2])
        want = (float(sess.get_variable_value(a)),
                float(sess.get_variable_value(c)))
    assert want[0] != 1.0 and want[1] != 2.0
    for got in world2['shared_opt'] + [cases.shared_optimizer(0, 1)]:
        np.testing.assert_allclose(np.asarray(got, np.float32), want,
                                   atol=1e-6)


def test_uneven_partition_padded_sharding_parity(world2):
    """UnevenPartitionedPS on a dim-13 weight over 2 replicas: the state
    shards with padding (13 -> 14, 7 rows a replica) and the numerics
    match the JAX package's and a single-device run."""
    want = jax_matrix_regression(jax_builder('UnevenPartitionedPS'), 2, 13)
    ref = jax_matrix_regression(jax_builder('AllReduce'), 1, 13)
    for W, geometry, local_shape in world2['uneven_pad']:
        assert geometry == (True, 1, 14)
        assert local_shape == (7, 1)
        assert W.shape == (13, 1)
        np.testing.assert_allclose(W, want, atol=1e-5)
        np.testing.assert_allclose(W, ref, atol=1e-5)


def test_error_feedback_residual_is_per_replica(world2):
    """Each replica carries its own EF residual (the JAX package's aux
    state has a leading replica dim), equal to the JAX replica's."""
    autodist = jax_autodist(jax_builder('AllReduce_hvd_ef'), 2)
    sess = jax_linear_regression(autodist)[3]
    want = np.asarray(sess._aux_state['compressor/W']['residual'])
    assert want.shape[0] == 2
    got = world2['ef']
    assert not np.array_equal(got[0], got[1])
    for r in range(2):
        np.testing.assert_allclose(got[r], want[r], atol=1e-6)


def test_loose_mode_raises_naming_its_queue_item(world2):
    """c0 at world 2 in loose mode (PS(staleness=2)), the ranks taking
    their steps in turn: under the exclude policy, with no fault, each
    rank's loss and the PS's W and b after both pushes equal the fail
    run's bit for bit, and rank 0's loss is the lock-step c0 loss of
    its share (it pulled the initial values)."""
    runs = world2['loose']
    for rank, run in enumerate(runs):
        fail, exclude = run['fail'], run['exclude']
        assert fail[:2] == ('LooseSession', 'fail')
        assert exclude[:2] == ('LooseSession', 'exclude')
        assert exclude[2:] == fail[2:], rank
    # both pushes are on the PS, and both ranks read the same values
    assert runs[0]['fail'][3:] == runs[1]['fail'][3:]
    assert runs[0]['fail'][4] != 0.0


def test_load_and_get_variable_value_of_sharded_state(world2):
    """A ZeRO-sharded variable (13 rows padded to 14 over 2 replicas)
    loads from a host value, each rank keeping its 7 rows, reads back
    whole, and trains from the loaded value (reduce_sum(x @ W) with x
    all ones: every row's gradient is the batch size, 2)."""
    value = np.arange(13, dtype=np.float32)[:, None] / 13
    padded = np.concatenate([value, np.zeros((1, 1), np.float32)])
    for rank, (back, shard, after) in enumerate(world2['load']):
        np.testing.assert_array_equal(back, value)
        np.testing.assert_array_equal(shard, padded[7 * rank:7 * rank + 7])
        np.testing.assert_allclose(after, value - 0.1 * 2, atol=1e-6)


_LAUNCHED = r'''
import json, sys
import chip_smoke as cs
import autodist_tpu_torch as ad
import torch.distributed as dist
rank, world = int(sys.argv[1]), int(sys.argv[2])
assert not dist.is_initialized()
autodist = ad.AutoDist(strategy_builder=ad.PartitionedPS(), device='cpu')
loss, W, b = cs.run_linear_regression(autodist, rank, world)
print(json.dumps({'world': dist.get_world_size(), 'rank': dist.get_rank(),
                  'backend': dist.get_backend(), 'W': W, 'b': b}))
'''


def test_launch_by_autodist_env_forms_the_group():
    """One process per replica started with AUTODIST_PROCESS_ID /
    AUTODIST_NUM_PROCESSES (and the chief's address): AutoDist forms the
    gloo group itself, over a default spec of one device a process."""
    import json
    import os
    import subprocess
    import sys
    from torch_dsl_worlds import REPO, free_port
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, '-c', _LAUNCHED, str(r), '2'], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=REPO, AUTODIST_PROCESS_ID=str(r),
                 AUTODIST_NUM_PROCESSES='2', OMP_NUM_THREADS='1',
                 AUTODIST_COORDINATOR_ADDR='127.0.0.1:%d' % port))
        for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    got = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    assert [g['rank'] for g in got] == [0, 1]
    for g in got:
        assert g['world'] == 2 and g['backend'] == 'gloo'
        assert abs(g['b'] - cs.EXPECTED_B) <= 1e-5
