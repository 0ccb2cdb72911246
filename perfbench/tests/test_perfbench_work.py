"""The frozen FLOP count of a step, pinned to hand-worked numbers."""
import pytest

from perfbench import harness, work


def flops(cell):
    s = harness.load_spec(cell)
    return work.step_flops(s['config']['model'], s['traffic']['seq'],
                           s['traffic']['batch'])


def test_gpt2_small_s4096_b4():
    # N = 12 (4 768^2 + 2 768 3072) + 768 50257 = 123,532,032
    # 6 N T = 6 x 123,532,032 x 16,384 = 12.1436e12
    # attention: 12 layers x 4 rows x 4096 x 4097 / 2 pairs x 12 x 768
    assert work.matmul_params(harness.load_spec(
        'gpt2-small.s4096.b4')['config']['model']) == 123_532_032
    assert flops('gpt2-small.s4096.b4') == pytest.approx(15.855e12,
                                                         rel=1e-3)


def test_bert_large_s512_b32():
    # N = 24 (4 1024^2 + 2 1024 4096) + 1024 30522 = 333,221,888
    # 6 N T = 32.757e12; attention 24 x 32 x 512^2 x 12 x 1024 = 2.474e12
    assert flops('bert-large.s512.b32') == pytest.approx(35.231e12,
                                                         rel=1e-3)


def test_the_four_card_cell_is_four_of_the_one_card_cell():
    assert flops('bert-large.s512.b32.dp4') == \
        4 * flops('bert-large.s512.b32')


def test_attention_bound_matches_the_kernels_table():
    # PERF.md's K1 row at [4, 12, 4096, 64] bf16 causal: 0.1043 ms (ops)
    f, b = work.attention('fwd', (4, 12, 4096, 64), 'bfloat16', True)
    assert work.bound_s(f, b) == pytest.approx(0.1043e-3, rel=2e-3)
