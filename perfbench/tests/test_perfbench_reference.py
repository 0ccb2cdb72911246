"""The plain reference against the port at tiny widths on the CPU,
through the port's plain paths: causal and non-causal, AdamW and LAMB,
the flash kernels' plain versions (seq 512) and the materialized arm
(seq 32), one process and dp 2 over gloo; and the control."""
import pytest

import tiny
from perfbench import check, readings

PATHS = [('gpt2-small.s4096.b4', 32, 4), ('gpt2-small.s4096.b4', 512, 2),
         ('bert-large.s512.b32', 32, 4), ('bert-large.s512.b32', 512, 2)]


def numbers(cell, dtype, seq, batch, control=False):
    s = tiny.spec(cell, dtype=dtype, seq=seq, batch=batch, max_len=512)
    job = {'seeds': [] if control else [2 ** 31 + 7],
           'control_seeds': [2 ** 31 + 7] if control else []}
    return readings.readings_rank(s, job, 0, 1, 'cpu')[0]['numbers']


@pytest.mark.parametrize('cell,seq,batch', PATHS)
def test_port_in_f32_is_the_reference(cell, seq, batch):
    # the same arithmetic in the same precision: only the order of sums
    # differs (measured: at most 1.7e-5, the change after three steps)
    n = numbers(cell, 'float32', seq, batch)
    assert n['loss'] < 1e-5 and n['grad1'] < 1e-4 and n['change'] < 1e-4


@pytest.mark.parametrize('cell,seq,batch', PATHS)
def test_control_reads_far_above_the_port_in_bf16(cell, seq, batch):
    port = numbers(cell, 'bfloat16', seq, batch)
    ctl = numbers(cell, 'bfloat16', seq, batch, control=True)
    assert max(ctl[k] / port[k] for k in check.NUMBERS) > 3
    assert ctl['grad1'] > 3 * port['grad1']


def test_dp2_over_gloo_is_correct_and_its_exchange_is_needed():
    good = tiny.run_ranks('bert-large.s512.b32.dp4', 2, 2 ** 31 + 11)
    assert good['correct'] and good['device']['count'] == 2
    bad = tiny.run_ranks('bert-large.s512.b32.dp4', 2, 2 ** 31 + 11,
                         fault='no_exchange')
    assert not bad['correct']
