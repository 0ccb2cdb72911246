"""The loose PS plane at four workers, one a card (``chip_smoke``'s
``loose_pair`` phase with ``workers=4``): NCF at ml-20m width under
PS(staleness=2) with LazyAdam, each worker its own process on its own
card, sharing the coord service and two PS endpoints, at pipeline depth
2 on the f32 and i8 wires, 20 steps each, on a new batch every step and
again on one batch a worker. The phase's requirements hold for every
worker (finite losses, the first near ln 2, no lag beyond the staleness,
the PS's tables equal to a fresh pull; on one batch the last 5 losses
below the first and the tables the initial values plus the four
workers' pushes; the first i8 push 3.5-4.1x below f32's at the same
bytes a pull). Needs four cards and skips otherwise; imports no jax, so
it runs on the card's machine:

    python -m pytest --noconftest -m cuda tests/test_torch_loose_cuda.py

With ``--basetemp=DIR`` the phase's records land in
``DIR/<test>/loose_pair_four.json``.
"""
import json
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.cuda
def test_loose_pair_four_workers_one_per_card(tmp_path):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip('needs four CUDA cards')
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    summary = cs.loose_pair_phase(cs.NCF_FULL, cs.LOOSE_PAIR_STEPS, 'cuda',
                                  workers=4)
    with open(tmp_path / 'loose_pair_four.json', 'w') as f:
        json.dump(summary, f)
    for kind in cs.LOOSE_PAIR_KINDS:
        for wire in ('f32', 'i8'):
            assert len(summary[kind][wire]) == 4
            assert all(r['max_lag'] <= cs.LOOSE_STALENESS
                       for r in summary[kind][wire])
    assert len(summary['push_ratio_first']) == 4
