"""Run port loose-mode cases in N worker processes on the CPU.

The loose counterpart of :mod:`torch_dsl_worlds`: the processes form no
group. Each is started as a launcher would start it —
``AUTODIST_PROCESS_ID``, ``AUTODIST_NUM_PROCESSES`` and
``AUTODIST_COORD_SERVICE_ADDR`` in its environment — and runs every case
it is given in order; a case is a function ``fn(pid, nprocs, **kwargs)``
of a module that imports no jax, and runs under a run id of its own
(``AUTODIST_RUN_ID``), so its strategy keys and barriers are its own on
the one coord service. :func:`run_loose` plays the launcher: it starts
the service (and any PS endpoints) on ports of its own before the
workers, which join them, and shuts down only what it started. Returns ``{case key: [pid 0's result, pid 1's, ...]}``.
"""
import os
import pickle
import subprocess
import sys
import tempfile
import traceback
import uuid

from autodist_tpu_torch.utils.loose_harness import start_service, stop_service
from torch_dsl_worlds import HERE, REPO, CaseError


def run_loose(nprocs, cases, extra_env=None, endpoints=0, timeout=240,
              required=None):
    """Run ``cases`` — ``[(key, 'module:function', kwargs), ...]`` — in
    ``nprocs`` loose worker processes. ``endpoints`` PS endpoints are
    named in ``AUTODIST_PS_ENDPOINTS``. A process whose ``required``
    entry is False may exit with any code and leave no results."""
    required = required or (True,) * nprocs
    services = []
    try:
        for _ in range(1 + endpoints):
            services.append(start_service())
        return _launch(nprocs, cases, extra_env, services, timeout,
                       required)
    finally:
        for port, proc in services:
            stop_service(port, proc)


def _launch(nprocs, cases, extra_env, services, timeout, required):
    port, ep_ports = services[0][0], [p for p, _ in services[1:]]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, HERE, os.environ.get('PYTHONPATH', '')]),
        OMP_NUM_THREADS='1', AUTODIST_NUM_PROCESSES=str(nprocs),
        AUTODIST_COORD_SERVICE_ADDR='127.0.0.1:%d' % port)
    env.pop('AUTODIST_IS_TESTING', None)
    if ep_ports:
        env['AUTODIST_PS_ENDPOINTS'] = ','.join(
            '127.0.0.1:%d' % p for p in ep_ports)
    env.update(extra_env or {})
    nonce = uuid.uuid4().hex[:8]
    with tempfile.TemporaryDirectory() as tmp:
        spec = os.path.join(tmp, 'cases.pkl')
        with open(spec, 'wb') as f:
            pickle.dump([(key, target, kwargs, '%s-%s' % (key, nonce))
                         for key, target, kwargs in cases], f)
        out = os.path.join(tmp, 'pid%d.pkl')
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), spec, out],
            env=dict(env, AUTODIST_PROCESS_ID=str(pid)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for pid in range(nprocs)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0].decode(
                    errors='replace'))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        per_pid = []
        for pid, (p, log) in enumerate(zip(procs, logs)):
            if not required[pid]:
                per_pid.append(None)
                continue
            if p.returncode != 0 or not os.path.exists(out % pid):
                raise CaseError('pid %d exited %s:\n%s'
                                % (pid, p.returncode, log[-4000:]))
            with open(out % pid, 'rb') as f:
                per_pid.append(pickle.load(f))
    results = {}
    for key, _, _ in cases:
        vals = [r[key] if r is not None else None for r in per_pid]
        for pid, v in enumerate(vals):
            if isinstance(v, dict) and '__error__' in v:
                raise CaseError('case %s failed on pid %d:\n%s'
                                % (key, pid, v['__error__']))
        results[key] = vals
    return results


def _child(spec, out):
    import importlib

    import torch
    torch.set_num_threads(1)
    pid = int(os.environ['AUTODIST_PROCESS_ID'])
    nprocs = int(os.environ['AUTODIST_NUM_PROCESSES'])
    with open(spec, 'rb') as f:
        cases = pickle.load(f)
    results = {}
    for key, target, kwargs, run_id in cases:
        mod, fn = target.split(':')
        env = dict(kwargs.pop('env', {}), AUTODIST_RUN_ID=run_id)
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update({k: str(v) for k, v in env.items()})
        try:
            results[key] = getattr(importlib.import_module(mod), fn)(
                pid, nprocs, **kwargs)
        except Exception:  # noqa: BLE001 - reported to the launcher
            results[key] = {'__error__': traceback.format_exc()}
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            from autodist_tpu_torch import autodist as ad_mod
            ad_mod._DEFAULT_AUTODIST.clear()
    with open(out % pid, 'wb') as f:
        pickle.dump(results, f)


if __name__ == '__main__':
    _child(sys.argv[1], sys.argv[2])
