"""Collectives: device ms a step in which an NCCL kernel runs and no
other device operation does, on the same card. Nothing on one card."""
from perfbench import trace


def read(rec):
    total, seen = 0.0, False
    for r in rec['ranks']:
        comm = trace.union([k[1], k[2]] for k in r['kernels']
                           if trace.kind(k[0]) == 'nccl')
        seen = seen or bool(comm)
        rest = trace.union([k[1], k[2]] for k in r['kernels']
                           if trace.kind(k[0]) != 'nccl')
        total += trace.minus(comm, rest) / 1e3 / r['steps']
    return total / len(rec['ranks']) if seen else None
