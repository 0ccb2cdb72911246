"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout. The process exits with a code other
than 0, and prints no result, where no card (or fewer than the cell
asks for) is visible, or where ``jax``, ``jaxlib``, ``flax`` or the JAX
package is loaded once the window has closed. A cell on several cards
runs one process a card: this one is rank 0 and starts the others,
which join it over NCCL on a free localhost port; each of them makes the
same import check once its part is done, and a rank that fails it fails
the run.
"""
import argparse
import json
import os
import socket
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, '_cache')
WORKER_TIMEOUT_S = 300


def fixed_caches():
    """Build and kernel caches at fixed paths inside the checkout."""
    os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(CACHE,
                                                      'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = os.path.join(CACHE, 'triton')
    os.environ.setdefault('USE_FLAX', '0')


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload')
    p.add_argument('--seed', type=int)
    p.add_argument('--seconds', type=float)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    p.add_argument('--worker', help=argparse.SUPPRESS)
    return p.parse_args(argv)


def free_port():
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def rank_main(job, started=None):
    """One rank: join the group, run the job (a run of the cell, or the
    readings of ``readings.py``), leave the group. ``job['device']`` is
    'cuda' (NCCL, the rank's card) or 'cpu' (gloo)."""
    import torch
    import torch.distributed as dist

    from perfbench import harness
    rank, world, spec = job['rank'], job['world'], job['spec']
    cuda = job.get('device', 'cuda') == 'cuda'
    device = 'cuda:%d' % rank if cuda else 'cpu'
    if cuda:
        torch.cuda.set_device(rank)
    if world > 1:
        dist.init_process_group(
            'nccl' if cuda else 'gloo',
            init_method='tcp://127.0.0.1:%d' % job['port'],
            world_size=world, rank=rank,
            device_id=torch.device(device) if cuda else None)
    try:
        if job.get('readings'):
            from perfbench import readings
            return readings.readings_rank(spec, job['readings'], rank,
                                          world, device)
        return harness.run_rank(spec, job['seed'], job['seconds'],
                                bool(job['trace']), rank, world, device,
                                started)
    finally:
        if world > 1:
            dist.destroy_process_group()


def import_check():
    """0, or 4 where this process holds ``jax``, ``jaxlib``, ``flax`` or
    the JAX package (named on standard error)."""
    from perfbench import harness
    found = harness.forbidden_modules()
    if found:
        print('perfbench: the run loaded %s' % ', '.join(found),
              file=sys.stderr)
        return 4
    return 0


def worker(job):
    """A rank other than 0: its part of the job, then the import check;
    a code other than 0 fails the whole run."""
    rank_main(job)
    return import_check()


def launch(job, started=None):
    """Run ``job`` on ``job['world']`` ranks: this process is rank 0 and
    starts the others; returns rank 0's result, None where a rank
    failed or loaded what no run may hold."""
    job = dict(job, rank=0, port=free_port())
    workers = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), '--worker',
         json.dumps(dict(job, rank=r))], cwd=ROOT)
        for r in range(1, job['world'])]
    try:
        out = rank_main(job, started)
        codes = [w.wait(timeout=WORKER_TIMEOUT_S) for w in workers]
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.wait()
    if any(codes):
        print('perfbench: rank processes exited %s' % codes,
              file=sys.stderr)
        return None
    return out


def main(argv=None):
    fixed_caches()
    sys.path.insert(0, ROOT)
    args = parse(sys.argv[1:] if argv is None else argv)
    if args.worker:
        return worker(json.loads(args.worker))
    from perfbench import harness
    started = harness.process_start()
    spec = harness.load_spec(args.workload, ROOT)
    import torch

    import autodist_tpu_torch  # noqa: F401  (the system under test)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec['chips']:
        print('perfbench: %s needs %d CUDA device(s); %d visible'
              % (args.workload, spec['chips'],
                 torch.cuda.device_count() if torch.cuda.is_available()
                 else 0), file=sys.stderr)
        return 3
    out = launch({'spec': spec, 'seed': args.seed, 'seconds': args.seconds,
                  'trace': args.trace, 'world': spec['chips']}, started)
    if out is None:
        return 5
    code = import_check()
    if code:
        return code
    for name, c in out['checks'].items():
        print('perfbench check %s %.6g limit %.6g'
              % (name, c['value'], c['limit']), file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
