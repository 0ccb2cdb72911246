"""Sequence parallelism on the cards: ring and Ulysses attention through
the Trainer over NCCL, against one card.

The tests need at least two CUDA cards and skip without them; with four
they run sp 4 and sp 2 x dp 2, with two or three sp 2. The file imports
no jax, so it runs on a machine with the cards:

    python -m pytest --noconftest -m cuda tests/test_torch_seq_parallel_cuda.py

One worker process per card (``chip_smoke.py --grid-worker``) trains a
small f32 Transformer (dim 256, 4 heads of 64, 2 layers) at S = 512 on
batch 4 for 3 adamw(1e-4) steps, ring and Ulysses; the same steps run on
one card with the whole sequence. Under Ulysses each rank's local
attention is the whole sequence (S = 512), so it takes the flash kernels
as one card does, launch for launch. Tolerance: f32 with TF32 off, the
sums taken in other orders (the masked-mean count over the grid, the
ring's online softmax over blocks against the kernel's): losses 1e-5
relative, and params 1e-5 absolute, a tenth of one adamw step's move
(``tests/test_torch_trainer_cuda.py`` holds dp = N to the same).
Then gpt_small at seq 4096, batch 4, bf16 with remat runs 3 adamw(1e-3)
steps at sp = N under each mode: finite losses that fall.
"""
import tempfile

import numpy as np
import pytest
import torch

SMALL = dict(vocab=256, dim=256, n_layers=2, n_heads=4, max_len=512,
             causal=True, dtype='float32', remat=False)
GPT_SMALL = dict(vocab=32000, dim=768, n_layers=12, n_heads=12,
                 max_len=4096, causal=True, dtype='bfloat16', remat=True)


def _cards():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip('needs at least two CUDA cards')
    return 4 if n >= 4 else 2


def _grids(n):
    return [(n, 1)] + ([(2, 2)] if n == 4 else [])


@pytest.mark.cuda
def test_ring_and_ulysses_equal_one_card():
    import chip_smoke as cs
    n = _cards()
    torch.backends.cuda.matmul.allow_tf32 = False
    base = dict(cfg=SMALL, seq=512, batch=4, lr=1e-4, steps=3, params=True)
    ref = cs.grid_run(dict(base, name='one', spec={}), 'cuda:0')
    runs = [dict(base, name='%s_sp%d_dp%d' % (mode, sp, dp),
                 spec=dict(sp=sp, dp=dp, sp_mode=mode))
            for mode in ('ring', 'ulysses') for sp, dp in _grids(n)]
    with tempfile.TemporaryDirectory() as out:
        ranks = cs.launch_grid(runs, n, 'cuda', out)
    assert sum(ref['launches'].values()) > 0
    for run in runs:
        for r, rank in enumerate(ranks):
            got = rank[run['name']]
            np.testing.assert_allclose(got['losses'], ref['losses'],
                                       rtol=1e-5, err_msg=run['name'])
            for k, want in ref['params'].items():
                np.testing.assert_allclose(
                    np.asarray(got['params'][k]), np.asarray(want),
                    atol=1e-5, rtol=0, err_msg='%s %s rank %d'
                    % (run['name'], k, r))
            if run['spec']['sp_mode'] == 'ulysses':
                assert got['launches'] == ref['launches'], run['name']
            else:
                assert got['launches'] == {}, run['name']


@pytest.mark.cuda
def test_gpt_small_seq_4096_trains_under_both_modes():
    import chip_smoke as cs
    n = _cards()
    runs = [dict(cfg=GPT_SMALL, seq=4096, batch=4, lr=1e-3, steps=3,
                 name=mode, spec=dict(sp=n, sp_mode=mode))
            for mode in ('ring', 'ulysses')]
    with tempfile.TemporaryDirectory() as out:
        ranks = cs.launch_grid(runs, n, 'cuda', out)
    for run in runs:
        for rank in ranks:
            losses = rank[run['name']]['losses']
            assert all(np.isfinite(losses)), (run['name'], losses)
            assert losses[-1] < losses[0], (run['name'], losses)
        print(run['name'], n, 'cards', ranks[0][run['name']]['losses'],
              'tokens/s', ranks[0][run['name']]['tokens_per_s'])
