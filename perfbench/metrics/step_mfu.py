"""Device: model FLOP utilization of the measured window, in %: the
model FLOP of all its steps (``perfbench/work.py``: 6 N T for the
matmul parameters plus attention, no recompute) over the window's
seconds and the cards' bf16 peak."""
from perfbench import work


def read(rec):
    w, t = rec['window'], rec['traffic']
    flops = w['steps'] * work.step_flops(rec['model'], t['seq'], t['batch'])
    return 100.0 * flops / w['seconds'] / (work.PEAK_BF16_FLOPS *
                                           rec['chips'])
