"""Sharded training state on the cards: ZeRO 2 and 3 and PartitionedPS
through the Trainer over NCCL, against one card, and the memory each
saves.

The tests need at least two CUDA cards and skip without them (dp = 4
with four, else 2). The file imports no jax, so it runs on a machine
with the cards:

    python -m pytest --noconftest -m cuda -s tests/test_torch_zero_cuda.py

One worker process per card (``chip_smoke.py --grid-worker``) trains a
small f32 Transformer (dim 256, 2 layers, S = 512) on its slice of a
global batch of 8 for 3 adamw(1e-4) steps under zero 2, zero 3 and
``trainer_from_strategy(PartitionedPS())`` (one PS device a rank, so
it partitions); the same steps run on one card with the whole batch.
Tolerance as ``tests/test_torch_trainer_cuda.py`` holds dp = N: losses
1e-5 relative, params 1e-5 absolute (f32, TF32 off).

Memory: a wider f32 model (dim 1024, 8 layers, vocab 32000, S = 128,
batch 2 a rank) whose adamw state dwarfs its activations, under zero 1,
2 and 3. After a step a rank holds, per trainable element, its param,
gradient and two slots (16 bytes) under zero 1; under zero 2 the full
param plus a 1/dp slice of all four (4 + 16/dp); under zero 3 a slice
of all four (16/dp), for every leaf with a dim that divides by dp
(``chip_smoke.grid_state_bytes`` from ``Trainer.state_sharding``). The
bytes allocated after the step, once the collectives' deferred frees
have landed (``chip_smoke.settled_bytes``), go down against zero 1 by
that prediction within 5 % of zero 1's state, and the peak goes down
too.
"""
import json
import tempfile

import numpy as np
import pytest
import torch

SMALL = dict(vocab=256, dim=256, n_layers=2, n_heads=4, max_len=512,
             causal=True, dtype='float32', remat=False)
WIDE = dict(vocab=32000, dim=1024, n_layers=8, n_heads=16, max_len=128,
            causal=True, dtype='float32', remat=False)


def _cards():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip('needs at least two CUDA cards')
    return 4 if n >= 4 else 2


@pytest.mark.cuda
def test_sharded_state_equals_one_card():
    import chip_smoke as cs
    n = _cards()
    torch.backends.cuda.matmul.allow_tf32 = False
    base = dict(cfg=SMALL, seq=512, batch=8, lr=1e-4, steps=3, params=True)
    ref = cs.grid_run(dict(base, name='one', spec={}), 'cuda:0')
    runs = [dict(base, name='zero2', spec=dict(dp=n, zero=2)),
            dict(base, name='zero3', spec=dict(dp=n, zero=3)),
            dict(base, name='partitioned_ps', spec=dict(dp=n),
                 builder='PartitionedPS')]
    with tempfile.TemporaryDirectory() as out:
        ranks = cs.launch_grid(runs, n, 'cuda', out)
    for run in runs:
        for r, rank in enumerate(ranks):
            got = rank[run['name']]
            assert got['sharded_leaves'] > 0, run['name']
            np.testing.assert_allclose(got['losses'], ref['losses'],
                                       rtol=1e-5, err_msg=run['name'])
            for k, want in ref['params'].items():
                np.testing.assert_allclose(
                    np.asarray(got['params'][k]), np.asarray(want),
                    atol=1e-5, rtol=0, err_msg='%s %s rank %d'
                    % (run['name'], k, r))


@pytest.mark.cuda
def test_memory_per_card_falls_by_the_predicted_state_bytes():
    import chip_smoke as cs
    n = _cards()
    runs = [dict(cfg=WIDE, seq=128, batch=2 * n, lr=1e-4, steps=2,
                 name='zero%d' % z, spec=dict(dp=n, zero=z))
            for z in (1, 2, 3)]
    with tempfile.TemporaryDirectory() as out:
        ranks = cs.launch_grid(runs, n, 'cuda', out)
    recs = {run['name']: max((rank[run['name']] for rank in ranks),
                             key=lambda rec: rec['state_bytes'])
            for run in runs}
    one = recs['zero1']
    for name in ('zero2', 'zero3'):
        rec = recs[name]
        predicted = one['predicted_state_bytes'] - \
            rec['predicted_state_bytes']
        measured = one['state_bytes'] - rec['state_bytes']
        print(json.dumps({'cards': n, 'run': name,
                          'predicted_saving_bytes': predicted,
                          'measured_saving_bytes': measured,
                          'state_bytes': rec['state_bytes'],
                          'state_bytes_at_step_end':
                              rec['state_bytes_at_step_end'],
                          'zero1_state_bytes': one['state_bytes'],
                          'peak_mem_bytes': rec['peak_mem_bytes'],
                          'zero1_peak_mem_bytes': one['peak_mem_bytes']}))
        assert predicted > 0
        assert abs(measured - predicted) <= 0.05 * one['state_bytes'], \
            (name, measured, predicted)
        assert rec['peak_mem_bytes'] < one['peak_mem_bytes'], name
