"""Device: the share of the measured window's step in which the card
computes nothing, 1 - (compute busy a step) / (the window's mean step),
mean over the cards.

Compute busy a step is the union of the device operations other than
the collectives (NCCL kernels) over the traced steps, over their number:
kernels run as long under the profiler as without it, but a collective's
kernel also spins while it waits for the slowest rank, and the profiler
slows the ranks' hosts, so the collectives are read apart
(``allreduce_ms``, ``allreduce_exposed_ms``) and their exposed time
counts here as idle. The step is the untraced window's seconds over its
steps: the profiler slows the host, which paces some cells, so the
traced window's own length would count that slowing as idle."""
from perfbench import trace


def read(rec):
    w = rec['window']
    step_us = 1e6 * w['seconds'] / w['steps']
    fr = [1 - trace.length(trace.union(
        [k[1], k[2]] for k in r['kernels'] if trace.kind(k[0]) != 'nccl'))
        / r['steps'] / step_us for r in rec['ranks']]
    return sum(fr) / len(fr)
