"""Tiny specs of the benchmark's cells for the CPU tests: the cell's own
files, the model cut to a few widths and the traffic to a few rows."""
import copy

from perfbench import harness, readings, run

TINY_MODEL = dict(vocab=256, dim=64, n_layers=2, n_heads=4, max_len=64)
# The cells' limits were set at their own sizes on the card. At these
# widths on the CPU the port in bfloat16 reads up to 1.0e-4 (loss),
# 2.9e-3 (grad1) and 8.2e-3 (change); half the batch reads 2.4e-3 /
# 0.18 / 2.4e-2, a frozen step 1 on both leaf numbers.
TINY_LIMITS = {'loss': 4e-4, 'grad1': 1e-2, 'change': 1.5e-2}


def spec(cell, dtype='bfloat16', seq=32, batch=4, **model):
    s = copy.deepcopy(harness.load_spec(cell))
    s['config']['model'].update(TINY_MODEL, dtype=dtype, **model)
    s['traffic'].update(seq=seq, batch=batch)
    s['cell']['limits'] = dict(TINY_LIMITS)
    return s


def rank_worker(rank, world, port, cell, seed, fault, queue):
    """One gloo rank of a run on the CPU; rank 0 puts its result."""
    import torch.distributed as dist
    dist.init_process_group('gloo', init_method='tcp://127.0.0.1:%d' % port,
                            world_size=world, rank=rank)
    try:
        undo = readings.plant(fault) if fault else (lambda: None)
        s = spec(cell)
        s['cell']['spec']['dp'] = world
        out = harness.run_rank(s, seed, 0.3, False, rank, world, 'cpu',
                               log=lambda *a: None)
        undo()
        if rank == 0:
            queue.put(out)
    finally:
        dist.destroy_process_group()


def run_ranks(cell, world, seed, fault=None):
    import multiprocessing as mp
    ctx = mp.get_context('spawn')
    queue = ctx.Queue()
    port = run.free_port()
    procs = [ctx.Process(target=rank_worker,
                         args=(r, world, port, cell, seed, fault, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    import queue as queues
    import time
    out, deadline = None, time.time() + 600
    try:
        while out is None and time.time() < deadline:
            try:
                out = queue.get(timeout=1)
            except queues.Empty:
                if all(p.exitcode not in (None, 0) or not p.is_alive()
                       for p in procs) and queue.empty():
                    break
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert out is not None and all(p.exitcode == 0 for p in procs)
    return out
