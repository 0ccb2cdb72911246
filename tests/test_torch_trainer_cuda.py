"""The Trainer on the card: data parallelism over NCCL (dp = N equals one
card), the sparse family against the CPU, and checkpoints.

The NCCL tests need at least two CUDA cards, the others one; each skips
without them. The file imports no jax, so it runs on a machine with the
cards:

    python -m pytest --noconftest -m cuda tests/test_torch_trainer_cuda.py

One worker process per card trains a small model on its slice of a
global batch for 3 steps; the losses and params must match the same 3
steps on one card with the whole batch. Three models: a Transformer
whose attention takes the flash kernels (S = 512), under adamw, without
a loss mask and with one that leaves the ranks unequal numbers of
counted tokens (the loss is the global masked mean); the same with MoE
blocks (4 experts, aux weight 1.0, remat), whose load-balance loss takes
its first-choice fractions over the global batch; and a small
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
if kind.startswith('lm') or kind == 'moe':
    # the MoE case: aux weight 1.0 and remat, so the aux's first-choice
    # fractions are all-reduced in the forward and again in the recompute
    extra = dict(moe_experts=4, moe_aux_coef=1.0, remat=True) \
        if kind == 'moe' else {}
    cfg = TransformerConfig.tiny(dtype=torch.float32, dim=128, n_heads=2,
                                 max_len=512, **extra)
    model = TransformerLM(cfg, device=device, seed=rank)
    trainer = Trainer(model, optim.adamw(1e-4))
    batch = {'tokens': rng.randint(0, cfg.vocab, (8, 512), dtype=np.int32),
             'targets': rng.randint(0, cfg.vocab, (8, 512), dtype=np.int32)}
    if kind == 'lm_masked':
        # rows 0-1 counted only up to column 4: the ranks hold unequal
        # numbers of counted tokens, and the loss is the global mean
        batch['mask'] = np.ones((8, 512), np.float32)
        batch['mask'][:2, 4:] = 0
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
    pytest.param('lm', 1e-5, id='lm'),
    pytest.param('lm_masked', 1e-5, id='lm_masked'),
    pytest.param('moe', 1e-5, id='moe'),
    pytest.param('resnet', 1e-4, id='resnet')])
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


def _sparse_cases():
    from autodist_tpu_torch.models.ncf import NCF
    from autodist_tpu_torch.models.rnn import LSTMLM
    rng = np.random.RandomState(0)
    ncf = [{'users': rng.randint(0, 64, (32,)).astype(np.int32),
            'items': rng.randint(0, 48, (32,)).astype(np.int32),
            'labels': rng.randint(0, 2, (32,)).astype(np.float32)}
           for _ in range(3)]
    lstm = [{'tokens': rng.randint(0, 64, (4, 6)).astype(np.int32),
             'targets': rng.randint(0, 64, (4, 6)).astype(np.int32),
             'mask': (rng.rand(4, 6) > 0.3).astype(np.float32)}
            for _ in range(3)]
    return {
        'ncf': (lambda dev: NCF(64, 48, mf_dim=8, mlp_dims=(16, 8, 4),
                                device=dev), ncf),
        'lstm': (lambda dev: LSTMLM(64, 16, 24, 2, device=dev), lstm),
        'lstm_tied': (lambda dev: LSTMLM(64, 16, 16, 1, tied=True,
                                         device=dev), lstm)}


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['ncf', 'lstm', 'lstm_tied'])
def test_sparse_models_on_card_match_cpu(kind):
    """NCF and LSTMLM at tiny width, 3 Adam(1e-3) steps through
    ``trainer_from_strategy(..., PSLoadBalancing())`` from the same init
    (the port's own, from a seed), on the card and on the CPU: losses
    within 1e-5 relative (f32, TF32 off; sums in other orders) and params
    within 1e-4 absolute (a tenth of one Adam step's largest move)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from autodist_tpu_torch import optim
    from autodist_tpu_torch.models.weights import flatten_tree
    from autodist_tpu_torch.strategy import (PSLoadBalancing,
                                             trainer_from_strategy)
    torch.backends.cuda.matmul.allow_tf32 = False
    make, batches = _sparse_cases()[kind]
    out = {}
    for dev in ('cuda', 'cpu'):
        tr = trainer_from_strategy(make(dev), optim.adam(1e-3),
                                   PSLoadBalancing())
        state = tr.init(seed=0)
        losses = [float(tr.step(state, b)[1]['loss']) for b in batches]
        out[dev] = (losses, dict(flatten_tree(tr.get_params(state))))
    np.testing.assert_allclose(out['cuda'][0], out['cpu'][0], rtol=1e-5)
    for path, v in out['cpu'][1].items():
        np.testing.assert_allclose(out['cuda'][1][path], v, atol=1e-4,
                                   rtol=0, err_msg='/'.join(path))


@pytest.mark.cuda
def test_save_restore_round_trip_on_card(tmp_path):
    """save_state / restore_state of NCF under Adam on the card: a fresh
    trainer reads back the params and Adam slots bit for bit, and its
    next step equals the original trainer's next step bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from autodist_tpu_torch import optim
    from autodist_tpu_torch.api import Trainer
    from autodist_tpu_torch.checkpoint.saver import (CheckpointManager,
                                                     _leaf_paths)
    make, batches = _sparse_cases()['ncf']
    tr = Trainer(make('cuda'), optim.adam(1e-3))
    state = tr.init(seed=0)
    for b in batches[:2]:
        tr.step(state, b)
    mgr = CheckpointManager(str(tmp_path))
    tr.save_state(mgr, state)
    fresh = Trainer(make('cuda'), optim.adam(1e-3))
    fstate, step = fresh.restore_state(mgr, fresh.init(seed=1))
    assert step == 2 and fstate.step == 2
    saved = dict(_leaf_paths(tr._state_tree(state)))
    restored = dict(_leaf_paths(fresh._state_tree(fstate)))
    assert saved.keys() == restored.keys()
    for k in saved:
        np.testing.assert_array_equal(restored[k], saved[k], err_msg=k)
    a = float(tr.step(state, batches[2])[1]['loss'])
    b = float(fresh.step(fstate, batches[2])[1]['loss'])
    assert a == b
    for p, q in zip(tr.model.parameters(), fresh.model.parameters()):
        assert torch.equal(p, q)
