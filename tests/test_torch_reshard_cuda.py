"""Every reshard kind under NCCL at dp = 4, one process a card: the
layouts of ``tests/test_reshard.py`` (``torch_reshard_cases``), moved
A -> B -> A on the cards by ``parallel/reshard.apply_reshard``
(``all_gather_into_tensor``, ``all_to_all_single``, the local slice and
the gather-unpad-repad-slice). Each rank's tensors under B equal its
slice of the padded host values bit for bit, and the round trip returns
every rank's tensors, optimizer slots riding the same op included, bit
for bit. Needs four CUDA cards and skips otherwise; imports no jax, so
it runs on the card's machine:

    python -m pytest --noconftest -m cuda tests/test_torch_reshard_cuda.py
"""
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

_RUN = r'''
import pickle, sys
import torch
import torch.distributed as dist
import torch_reshard_cases as cases
rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
torch.cuda.set_device(rank)
dist.init_process_group('nccl', init_method='tcp://127.0.0.1:' + port,
                        world_size=world, rank=rank)
res = {name: cases.roundtrip(rank, world, a, b, seed=0, device='cuda',
                             slots=True)
       for name, a, b in (('main', cases.A_CFG, cases.B_CFG),
                          ('padded', cases.PAD_A, cases.PAD_B))}
with open(out % rank, 'wb') as f:
    pickle.dump(res, f)
dist.destroy_process_group()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip('needs four CUDA cards')
    world = 4
    out = str(tmp_path_factory.mktemp('reshard') / 'rank%d.pkl')
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, HERE]))
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, '-c', _RUN, str(r),
                               str(world), port, out], env=env, cwd=REPO)
             for r in range(world)]
    try:
        assert [p.wait(timeout=300) for p in procs] == [0] * world
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    res = []
    for r in range(world):
        with open(out % r, 'rb') as f:
            res.append(pickle.load(f))
    return res


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['main', 'padded'])
def test_nccl_reshard_every_kind_bit_identical(runs, name):
    kinds = set()
    for rec in (r[name] for r in runs):
        assert rec['back_equal'] and rec['slots_equal']
        for k, arr in rec['b'].items():
            np.testing.assert_array_equal(arr, rec['want_b'][k],
                                          err_msg=k)
        kinds |= set(rec['kinds'])
    if name == 'main':
        assert {'all_to_all', 'all_gather', 'shard', 'noop'} <= kinds
    else:
        # 30 rows over 4 ranks pad to 32: the padded axis change
        assert 'gather_scatter' in kinds
