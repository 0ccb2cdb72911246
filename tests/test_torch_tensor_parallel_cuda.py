"""Tensor and expert parallelism on the cards: the Trainer over NCCL at
tp, ep and ep x tp, against one card.

The tests need at least two CUDA cards and skip without them; with four
they run tp 4, ep 4, ep 2 x tp 2 and tp 2 x dp 2 (zero 3), with two or
three tp 2 and ep 2. The file imports no jax, so it runs on a machine
with the cards:

    python -m pytest --noconftest -m cuda tests/test_torch_tensor_parallel_cuda.py

One worker process per card (``chip_smoke.py --grid-worker``) trains a
small f32 Transformer (dim 256, 4 heads of 64, 2 layers; the MoE arm
with 4 experts, top 2) at S = 512 on batch 4 for 3 adamw(1e-4) steps;
the same steps run on one card. Each rank of a model group runs its
heads at [4, 4 / tp, 512, 64], where the flash kernels run as on one
card (S = 512 is their crossover), so the launches are one card's.
Tolerance: f32 with TF32 off, the products' partial sums added in
another order: losses 1e-5 relative, params 1e-5 absolute, a tenth of
one adamw step's move (``tests/test_torch_seq_parallel_cuda.py`` holds
sp = N to the same). Each rank's memory after each step passes
``chip_smoke.check_state_bytes``: no growth from the first step to the
last, and the predicted state plus the step's inputs and the caching
allocator's slack at most.
"""
import tempfile

import numpy as np
import pytest
import torch

SMALL = dict(vocab=256, dim=256, n_layers=2, n_heads=4, max_len=512,
             causal=True, dtype='float32', remat=False)
MOE = dict(SMALL, moe_experts=4, moe_top_k=2)


def _cards():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip('needs at least two CUDA cards')
    return 4 if n >= 4 else 2


def _specs(n):
    specs = [('lm', dict(tp=n)), ('moe', dict(ep=n))]
    if n == 4:
        specs += [('moe', dict(ep=2, tp=2)), ('lm', dict(tp=2, dp=2, zero=3))]
    return specs


@pytest.mark.cuda
def test_tp_and_ep_equal_one_card():
    import chip_smoke as cs
    n = _cards()
    torch.backends.cuda.matmul.allow_tf32 = False
    base = dict(seq=512, batch=4, lr=1e-4, steps=3, params=True)
    refs = {kind: cs.grid_run(dict(base, cfg=cfg, name=kind, spec={}),
                              'cuda:0')
            for kind, cfg in (('lm', SMALL), ('moe', MOE))}
    runs = [dict(base, cfg=SMALL if kind == 'lm' else MOE, kind=kind,
                 name='%s_%s' % (kind, '_'.join('%s%s' % kv
                                                 for kv in spec.items())),
                 spec=spec) for kind, spec in _specs(n)]
    with tempfile.TemporaryDirectory() as out:
        ranks = cs.launch_grid(runs, n, 'cuda', out)
    assert sum(refs['lm']['launches'].values()) > 0
    for run in runs:
        ref = refs[run['kind']]
        for r, rank in enumerate(ranks):
            got = rank[run['name']]
            np.testing.assert_allclose(got['losses'], ref['losses'],
                                       rtol=1e-5, err_msg=run['name'])
            for k, want in ref['params'].items():
                np.testing.assert_allclose(
                    np.asarray(got['params'][k]), np.asarray(want),
                    atol=1e-5, rtol=0, err_msg='%s %s rank %d'
                    % (run['name'], k, r))
            assert got['launches'] == ref['launches'], run['name']
            assert got['predicted_state_bytes'] < \
                ref['predicted_state_bytes'], run['name']
            cs.check_state_bytes('%s rank %d' % (run['name'], r), got)
        print(run['name'], n, 'cards', ranks[0][run['name']]['losses'],
              'state bytes', ranks[0][run['name']]['state_bytes'],
              'asked', ranks[0][run['name']]['state_requested_bytes'],
              'predicted', ranks[0][run['name']]['predicted_state_bytes'])
