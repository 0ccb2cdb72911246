"""Data parallelism over NCCL on several cards: dp = N equals one card.

Needs at least two CUDA cards and skips otherwise. The file imports no
jax, so it runs on a machine with the cards:

    python -m pytest --noconftest -m cuda tests/test_torch_trainer_cuda.py

One worker process per card trains a small model on its slice of a
global batch for 3 steps; the losses and params must match the same 3
steps on one card with the whole batch. Two models: a Transformer whose
attention takes the flash kernels (S = 512), under adamw; and a small
ResNet through the fused conv + BatchNorm kernel
(``AUTODIST_FUSED_CONV=1``), under sgd with momentum, whose BatchNorm
moments are summed over the ranks (so dp = N normalizes over the same
global batch as one card). Tolerance: f32 with TF32 off; the mean over N
slices sums in another order than the mean over the batch, so losses
agree to 1e-5 relative. adamw moves each param by up to about
lr = 1e-4 a step whatever its gradient's size, so a component whose
gradient is near zero can move by a visibly different fraction of lr
when its gradient differs only by rounding (one pos_embed entry in
65536 moved 2.4e-6 apart on four H100s): params agree to 1e-5
absolute, a tenth of one step's move. The ResNet (sgd 0.1, momentum
0.9; cuDNN with TF32 off): a param moves by lr times its gradient, and
the gradients of the two runs agree to the rounding of sums taken in
other orders over 8 images, amplified by the BatchNorms' 1/std; params
and running statistics agree to 1e-4 absolute.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RUN = r'''
import sys
import numpy as np
import torch
import torch.distributed as dist
from autodist_tpu_torch import optim
from autodist_tpu_torch.api import Trainer
from autodist_tpu_torch.models import vision
from autodist_tpu_torch.models.transformer import (TransformerConfig,
                                                   TransformerLM)
from autodist_tpu_torch.models.weights import flatten_tree

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
rank, world, port, out, kind = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4], sys.argv[5])
torch.cuda.set_device(rank)
if world > 1:
    dist.init_process_group('nccl', init_method='tcp://127.0.0.1:' + port,
                            world_size=world, rank=rank)
rng = np.random.RandomState(0)
device = 'cuda:%d' % rank
if kind == 'lm':
    cfg = TransformerConfig.tiny(dtype=torch.float32, dim=128, n_heads=2,
                                 max_len=512)
    model = TransformerLM(cfg, device=device, seed=rank)
    trainer = Trainer(model, optim.adamw(1e-4))
    batch = {'tokens': rng.randint(0, cfg.vocab, (8, 512), dtype=np.int32),
             'targets': rng.randint(0, cfg.vocab, (8, 512), dtype=np.int32)}
else:
    model = vision.ResNet((1, 1), num_classes=10, device=device, seed=rank)
    trainer = Trainer(model, optim.sgd(0.1, momentum=0.9))
    batch = {'images': rng.randn(8, 32, 32, 3).astype(np.float32),
             'labels': rng.randint(0, 10, (8,)).astype(np.int32)}
state = trainer.init(seed=0)          # ranks start from rank 0's params
losses = [float(trainer.step(state, batch)[1]['loss']) for _ in range(3)]
flat = {'/'.join(p): v for p, v in flatten_tree(trainer.get_params(state))}
np.savez(out % rank, losses=np.asarray(losses), **flat)
if world > 1:
    dist.destroy_process_group()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _launch(world, out, port, kind):
    env = dict(os.environ, PYTHONPATH=REPO, AUTODIST_FUSED_CONV='1')
    procs = [subprocess.Popen([sys.executable, '-c', _RUN, str(r),
                               str(world), str(port), out, kind], env=env)
             for r in range(world)]
    try:
        return [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


@pytest.mark.cuda
@pytest.mark.parametrize('kind,atol', [
    pytest.param('lm', 1e-5, id='lm'), pytest.param('resnet', 1e-4,
                                                    id='resnet')])
def test_nccl_dp_equals_one_card(tmp_path, kind, atol):
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip('needs at least two CUDA cards')
    world = 4 if n >= 4 else 2
    single = str(tmp_path / 'single%d.npz')
    multi = str(tmp_path / 'dp%d.npz')
    assert _launch(1, single, _free_port(), kind) == [0]
    assert _launch(world, multi, _free_port(), kind) == [0] * world
    want = np.load(single % 0)
    for r in range(world):
        got = np.load(multi % r)
        np.testing.assert_allclose(got['losses'], want['losses'], rtol=1e-5)
        for name in want.files:
            if name != 'losses':
                np.testing.assert_allclose(got[name], want[name], atol=atol,
                                           rtol=0, err_msg=name)
