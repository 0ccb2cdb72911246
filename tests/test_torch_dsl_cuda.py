"""The DSL path over NCCL on several cards: dp = N equals one card.

Needs at least two CUDA cards and skips otherwise. The file imports no
jax, so it runs on a machine with the cards:

    python -m pytest --noconftest -m cuda tests/test_torch_dsl_cuda.py

One process per card runs, in one NCCL group, the c0 matrix
(``chip_smoke.c0_matrix``: the c0 program under its 14 builder entries)
and a narrow NCF written in DSL ops (``chip_smoke.ncf_program``; 512
users, 1024 items, GMF 16, MLP 64-32-16, batch 256, Adam 1e-3, 4 steps)
under AllReduce, PSLoadBalancing, PartitionedPS, Parallax and
AllReduce with the int8 wire. Each rank feeds its quarter (its half on
two cards) of every batch. Against the same programs on one card with
the whole batches:

- c0: W and b to 1e-5 (2e-3 on the bfloat16 wires), as the JAX tests;
- NCF, f32 wires: the mean of the ranks' losses (each a mean over its
  share) to 1e-5 relative; every variable to 1e-4 absolute. Adam moves
  a parameter by up to lr = 1e-3 a step whatever its gradient's size,
  so a component whose gradient is near zero can move by a visibly
  different fraction of lr when its gradient differs only by the
  rounding of a sum taken in another order: 1e-4 is a tenth of one
  step's largest move;
- NCF, f32 wires: the four tables take the sparse (ids, rows) route
  (``sparse_synced``; the ids of a step are fewer than the rows), and
  no recorded collective of the step carries a table;
- NCF, int8 wire: the int8 ring quantizes what dp = 1 never sends, so
  the run must track the f32 one at the same dp: losses to 1e-3
  relative against one card, as the JAX package's int8 tests hold it,
  and each variable's 4-step update (its value less its initial value)
  within ``INT8_UPDATE_REL`` of the f32 run's update, in relative L2
  norm; each variable must also have moved by at least one Adam step
  (lr) somewhere, so a ring that returned zeros fails. A per-element
  limit cannot be used: Adam's first steps move each component by
  about lr times the sign of its gradient, so a small component that
  int8 rounds to zero or flips moves up to 2 lr a step differently
  (readings below: 4.8e-3 after 4 steps).

``INT8_UPDATE_REL`` was set from gloo readings of this program at
dp = 4 on the CPU: the relative update error was 1.0e-5 (head bias) to
0.161 (the second MLP kernel), tables 0.076-0.132; with the quantizer
made 8 times coarser (15 levels a side for 127) it read 0.241-0.458 on
the tables and MLP kernels. On four H100 80GB HBM3 cards (700 W) the
int8 run read the same to three digits (1.0e-5 to 0.161, tables
0.076-0.132, largest element difference 4.8e-3, every variable moved
at least 3.4e-3), and the f32 runs equalled one card within 8.0e-8.

TF32 is off on both sides.
"""
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from chip_smoke import NCF_TABLES, ncf_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NCF_NARROW = {'users': 512, 'items': 1024, 'mf_dim': 16,
              'mlp': (64, 32, 16), 'batch': 256}
#: the largest relative L2 error of a variable's update under the int8
#: wire against the f32 wire (readings in the module docstring)
INT8_UPDATE_REL = 0.25
STRATEGIES = ('AllReduce', 'PSLoadBalancing', 'PartitionedPS', 'Parallax',
              'AllReduce_int8')

_RUN = r'''
import pickle, sys
import torch
import torch.distributed as dist
import autodist_tpu_torch as ad
import chip_smoke as cs

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
cfg = eval(sys.argv[5])
torch.cuda.set_device(rank)
dist.init_process_group('nccl', init_method='tcp://127.0.0.1:' + port,
                        world_size=world, rank=rank)
builders = {
    'AllReduce': ad.AllReduce, 'PSLoadBalancing': ad.PSLoadBalancing,
    'PartitionedPS': ad.PartitionedPS, 'Parallax': ad.Parallax,
    'AllReduce_int8': lambda: ad.AllReduce(compressor='Int8RingCompressor')}
res = {'c0': cs.c0_matrix('cuda', rank, world)}
for name, builder in builders.items():
    losses, _, plan, _ = cs.ncf_train(builder(), 'cuda', cfg, 4, rank=rank,
                                      world=world)
    sess = cs.ad.get_default_autodist()._session
    res[name] = (losses, {v: sess.get_variable_value(v)
                          for v in sorted(plan.var_plans)},
                 {t: plan.var_plans[t].sparse_synced for t in cs.NCF_TABLES},
                 sorted({m for e in plan.last_bucket_stats
                         for m in e['members']}))
with open(out % rank, 'wb') as f:
    pickle.dump(res, f)
dist.destroy_process_group()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _launch(world, out):
    env = dict(os.environ, PYTHONPATH=REPO)
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, '-c', _RUN, str(r),
                               str(world), port, out, repr(NCF_NARROW)],
                              env=env, cwd=REPO) for r in range(world)]
    try:
        return [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def _load(path):
    with open(path, 'rb') as f:
        return pickle.load(f)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip('needs at least two CUDA cards')
    world = 4 if n >= 4 else 2
    tmp = tmp_path_factory.mktemp('dsl')
    single, multi = str(tmp / 'one%d.pkl'), str(tmp / 'dp%d.pkl')
    assert _launch(1, single) == [0]
    assert _launch(world, multi) == [0] * world
    return _load(single % 0), [_load(multi % r) for r in range(world)]


@pytest.mark.cuda
def test_nccl_dsl_c0_matrix_equals_one_card(runs):
    one, many = runs
    assert len(one['c0']) == 14
    for name, (_, W1, b1) in one['c0'].items():
        tol = 2e-3 if 'hvd' in name else 1e-5
        for rank_res in many:
            _, W, b = rank_res['c0'][name]
            assert abs(W - W1) <= tol and abs(b - b1) <= tol, name
            assert abs(b - 0.01 * 4.17503) <= tol, name


@pytest.mark.cuda
@pytest.mark.parametrize('name', STRATEGIES)
def test_nccl_dsl_ncf_equals_one_card(runs, name):
    one, many = runs
    losses1, vars1 = one[name][:2]
    mean = np.mean([r[name][0] for r in many], axis=0)
    if name.endswith('int8'):
        np.testing.assert_allclose(mean, losses1, rtol=1e-3)
        init = ncf_init(NCF_NARROW)
        for r in many:
            f32 = r['AllReduce'][1]
            for v, got in r[name][1].items():
                step, want = got - init[v], f32[v] - init[v]
                rel = np.linalg.norm(step - want) / np.linalg.norm(want)
                assert rel <= INT8_UPDATE_REL, (v, rel)
                assert np.abs(step).max() >= 1e-3, v
        return
    np.testing.assert_allclose(mean, losses1, rtol=1e-5)
    for r in many:
        for v, want in vars1.items():
            np.testing.assert_allclose(r[name][1][v], want, atol=1e-4,
                                       rtol=0, err_msg='%s %s' % (name, v))


@pytest.mark.cuda
@pytest.mark.parametrize('name', STRATEGIES)
def test_nccl_dsl_ncf_sparse_route(runs, name):
    """The (ids, rows) route carries the tables on f32 wires; the int8
    wire carries them dense, in its recorded buckets."""
    _, many = runs
    for r in many:
        _, _, synced, members = r[name]
        if name.endswith('int8'):
            assert not any(synced.values())
            assert set(NCF_TABLES) <= set(members)
        else:
            assert synced == dict.fromkeys(NCF_TABLES, True)
            assert not set(NCF_TABLES) & set(members)
