"""Run port DSL programs in a gloo group of N processes, on the CPU.

The JAX package runs its replicas inside one process; the port runs one
process per replica. :func:`run_group` starts ``world`` processes, forms
one gloo group over them, and runs every case it is given in that group
(one spawn for all the cases of a test file): each case names a
function of a module (the module must not import jax) that is called as
``fn(rank, world, **kwargs)`` on every rank. Returns each case's
per-rank results; a case that raised on any rank raises here with the
rank's traceback.

This module imports no jax, so the spawned processes never load it.
"""
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


class CaseError(RuntimeError):
    pass


def run_group(world, cases, timeout=300):
    """Run ``cases`` — ``[(key, 'module:function', kwargs), ...]`` — in
    one gloo group of ``world`` processes. Returns
    ``{key: [rank 0's result, rank 1's, ...]}``."""
    with tempfile.TemporaryDirectory() as tmp:
        spec = os.path.join(tmp, 'cases.pkl')
        with open(spec, 'wb') as f:
            pickle.dump(cases, f)
        out = os.path.join(tmp, 'rank%d.pkl')
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [REPO, HERE, os.environ.get('PYTHONPATH', '')]),
            OMP_NUM_THREADS='1')
        # the group meets at a file of this run, not at a port probed
        # here: another process may take a probed port before rank 0
        # binds it
        store = 'file://' + os.path.join(tmp, 'store')
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(world),
             store, spec, out], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for r in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0].decode(
                    errors='replace'))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        per_rank = []
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0 or not os.path.exists(out % r):
                raise CaseError('rank %d exited %s:\n%s'
                                % (r, p.returncode, log[-4000:]))
            with open(out % r, 'rb') as f:
                per_rank.append(pickle.load(f))
    results = {}
    for key, _, _ in cases:
        vals = [rank_out[key] for rank_out in per_rank]
        for r, v in enumerate(vals):
            if isinstance(v, dict) and '__error__' in v:
                raise CaseError('case %s failed on rank %d:\n%s'
                                % (key, r, v['__error__']))
        results[key] = vals
    return results


def _child(rank, world, store, spec, out):
    import importlib
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method=store,
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=120))
    with open(spec, 'rb') as f:
        cases = pickle.load(f)
    results = {}
    for key, target, kwargs in cases:
        mod, fn = target.split(':')
        env = kwargs.pop('env', {}) if isinstance(kwargs, dict) else {}
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update({k: str(v) for k, v in env.items()})
        try:
            results[key] = getattr(importlib.import_module(mod), fn)(
                rank, world, **kwargs)
        except Exception:  # noqa: BLE001 - reported to the parent
            results[key] = {'__error__': traceback.format_exc()}
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            from autodist_tpu_torch import autodist as ad_mod
            ad_mod._DEFAULT_AUTODIST.clear()
    with open(out % rank, 'wb') as f:
        pickle.dump(results, f)
    dist.destroy_process_group()


if __name__ == '__main__':
    _child(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
           sys.argv[5])
