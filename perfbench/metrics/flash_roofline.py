"""Kernels: the flash kernels' share of their roofline, in %: the sum
over the traced launches of the least time the card could take at the
cell's attention shape (``perfbench/work.py``) over the sum of their
device time. The launches traced must equal the program's own launch
counter over the traced steps; otherwise, or where no flash kernel ran,
nothing."""
from perfbench import trace, work


def read(rec):
    m = rec['model']
    rows = rec['traffic']['batch'] // rec['chips']
    shape = (rows, m['n_heads'], rec['traffic']['seq'],
             m['dim'] // m['n_heads'])
    bound = spent = 0.0
    for r in rec['ranks']:
        counts = {'fwd': 0, 'dq': 0, 'dkv': 0}
        for k in r['kernels']:
            if trace.kind(k[0]) != 'flash':
                continue
            name = trace.flash_kernel(k[0])
            counts[name] += 1
            bound += work.bound_s(*work.attention(name, shape, m['dtype'],
                                                  m['causal']))
            spent += (k[2] - k[1]) / 1e6
        if counts != (r['flash_launches'] or {}):
            return None
    return 100.0 * bound / spent if spent > 0 else None
