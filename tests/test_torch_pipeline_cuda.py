"""Pipeline parallelism on the cards: the Trainer over NCCL at pp 2 and
pp 4 under GPipe and both 1F1B variants, against one card.

The test needs at least two CUDA cards and skips without them; with four
it runs pp 4 (GPipe, 1F1B stash, 1F1B remat) and pp 2 x dp 2 (GPipe,
1F1B remat), with two or three pp 2 alone. The file imports no jax, so it
runs on a machine with the cards:

    python -m pytest --noconftest -m cuda tests/test_torch_pipeline_cuda.py

One worker process per card (``chip_smoke.py --grid-worker``) trains a
small f32 Transformer (dim 256, 4 heads of 64, 4 layers, remat) at S =
512 on batch 8 in 4 microbatches for 3 adamw(1e-4) steps; the same steps
run on one card. Each stage runs its microbatches' attention at [2, 4,
512, 64], where the flash kernels run (S = 512 is their crossover), so
every rank's K1-K3 launches are ``chip_smoke.pp_launches``: its stage's
layers x the microbatches x 2 / 1 / 1 under GPipe (the block and its
recompute) and 3 / 1 / 1 under 1F1B (one forward more), a step.
Tolerance: f32 with TF32 off, the products' partial sums added in
another order: losses 1e-5 relative, params 1e-5 absolute, a tenth of
one adamw step's move (``tests/test_torch_tensor_parallel_cuda.py``).
The memory pair: at pp = N, batch 32 in 16 microbatches and a vocab of
8192 (the last stage's logits, 32 MiB a microbatch, are the GPipe turn's
bulk), 1F1B remat's peak is below GPipe's on every card.
"""
import tempfile

import numpy as np
import pytest
import torch

SMALL = dict(vocab=256, dim=256, n_layers=4, n_heads=4, max_len=512,
             causal=True, dtype='float32', remat=True)
BASE = dict(seq=512, batch=8, lr=1e-4, steps=3, params=True)


def _cards():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip('needs at least two CUDA cards')
    return 4 if n >= 4 else 2


def _pp(n, m, schedule, variant='auto', **kw):
    return dict(pp=n, microbatches=m, pp_schedule=schedule,
                pp_variant=variant, **kw)


def _runs(n):
    runs = [('gpipe', _pp(n, 4, 'gpipe')),
            ('1f1b_stash', _pp(n, 4, '1f1b', 'stash')),
            ('1f1b_remat', _pp(n, 4, '1f1b', 'remat'))]
    if n == 4:
        runs += [('pp2_dp2_gpipe', _pp(2, 4, 'gpipe', dp=2)),
                 ('pp2_dp2_1f1b_remat', _pp(2, 4, '1f1b', 'remat', dp=2))]
    return [dict(BASE, cfg=SMALL, name=name, spec=spec)
            for name, spec in runs]


@pytest.mark.cuda
def test_pipeline_equals_one_card_with_exact_launches():
    import chip_smoke as cs
    n = _cards()
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = cs.grid_run(dict(BASE, cfg=SMALL, name='one', spec={}), 'cuda:0')
    runs = _runs(n)
    with tempfile.TemporaryDirectory() as out:
        ranks = cs.launch_grid(runs, n, 'cuda', out)
    assert sum(ref['launches'].values()) > 0
    for run in runs:
        want = {cs.fa.kernel_name(k, torch.float32, 64): c
                for k, c in cs.pp_launches(run).items()}
        for r, rank in enumerate(ranks):
            got = rank[run['name']]
            np.testing.assert_allclose(got['losses'], ref['losses'],
                                       rtol=1e-5, err_msg=run['name'])
            for k, v in ref['params'].items():
                np.testing.assert_allclose(
                    np.asarray(got['params'][k]), np.asarray(v), atol=1e-5,
                    rtol=0, err_msg='%s %s rank %d' % (run['name'], k, r))
            assert got['launches'] == want, (run['name'], r)


@pytest.mark.cuda
def test_1f1b_remat_peaks_below_gpipe_on_every_card():
    import chip_smoke as cs
    n = _cards()
    cfg = dict(SMALL, vocab=8192)
    runs = [dict(BASE, cfg=cfg, batch=32, name=name, params=False,
                 spec=_pp(n, 16, schedule, variant))
            for name, schedule, variant in (('gpipe', 'gpipe', 'auto'),
                                            ('remat', '1f1b', 'remat'))]
    with tempfile.TemporaryDirectory() as out:
        ranks = cs.launch_grid(runs, n, 'cuda', out)
    gpipe = [rank['gpipe']['peak_mem_bytes'] for rank in ranks]
    remat = [rank['remat']['peak_mem_bytes'] for rank in ranks]
    print('peak bytes a card: gpipe %s, 1f1b remat %s' % (gpipe, remat))
    assert all(r < g for r, g in zip(remat, gpipe)), (remat, gpipe)
    for rank in ranks:
        np.testing.assert_allclose(rank['remat']['losses'],
                                   rank['gpipe']['losses'], rtol=1e-5)
