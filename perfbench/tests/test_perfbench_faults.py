"""A run with the timed path broken underneath comes out not correct:
the look for a card is skipped, the rest of the run is driven on the
CPU at tiny widths."""
import pytest

import tiny
from perfbench import harness, readings


def run(cell, fault=None, seed=2 ** 31 + 3):
    undo = readings.plant(fault) if fault else (lambda: None)
    try:
        return harness.run_rank(tiny.spec(cell), seed, 0.3, False,
                                device='cpu', log=lambda *a: None)
    finally:
        undo()


@pytest.mark.parametrize('cell', ['gpt2-small.s4096.b4',
                                  'bert-large.s512.b32',
                                  'bert-large.s128.b128'])
def test_a_sound_run_is_correct(cell):
    out = run(cell)
    assert out['correct'], out['checks']
    assert list(out)[-1] == 'checks'
    assert set(out['metrics']) == {'tokens_per_s', 'step_ms_p95',
                                   'peak_mem_gib', 'setup_s'}


@pytest.mark.parametrize('fault', ['frozen', 'half_batch'])
@pytest.mark.parametrize('cell', ['gpt2-small.s4096.b4',
                                  'bert-large.s512.b32'])
def test_a_broken_step_is_not_correct(cell, fault):
    out = run(cell, fault)
    assert not out['correct'], out['checks']


def test_the_traced_run_reports_the_per_layer_metrics():
    s = tiny.spec('bert-large.s512.b32')
    out = harness.run_rank(s, 5, 0.3, True, device='cpu',
                           log=lambda *a: None)
    assert out['correct']
    assert {'host_dispatch_ms', 'step_mfu', 'device_idle_frac'} <= \
        set(out['metrics'])
    assert set(out['breakdown']) == {'device_ops', 'idle_gaps'}
    assert out['device']['window_s'] > 0
