"""The chief's launch on four cards: ``AutoDist`` in one process, on a
spec of four local nodes, launches the other three through ``ssh`` /
``scp`` exec shims (``chip_smoke.write_shims``), and the
four ranks run the lock-step c0 program under ``AllReduce`` over NCCL,
rank r on card r. The file imports no jax, so it runs on a machine with
the cards:

    python -m pytest --noconftest -m cuda tests/test_torch_launch_cuda.py

Before a call on the cards, the same program runs here over gloo on the
CPU: ``python tests/test_torch_launch_cuda.py gloo <dir>``.

The reference is one process on one card over a spec of four devices
with the whole batch (a dp = 4 run in one process). Tolerance, as
``tests/test_torch_trainer_cuda.py``'s: f32 with TF32 off, the mean over
four slices sums in another order than the mean over the batch, so the
mean of the ranks' losses agrees with the reference's loss to 1e-5
relative and W and b to 1e-5 absolute after 3 SGD steps.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
STEPS = 3

PROG = textwrap.dedent('''
    import json, os, sys
    for name in ('jax', 'jaxlib', 'autodist_tpu'):
        sys.modules[name] = None
    import numpy as np
    import torch
    sys.path.insert(0, %(repo)r)
    torch.backends.cuda.matmul.allow_tf32 = False
    import autodist_tpu_torch as ad
    import chip_smoke as cs

    device, out, world, steps = sys.argv[1], sys.argv[2], %(world)d, %(steps)d
    single = len(sys.argv) > 3
    if single:
        autodist = cs.fresh_autodist(ad.AllReduce(chunk_size=128), device,
                                     world)
        rank, share = 0, 1
    else:
        autodist = ad.AutoDist(strategy_builder=ad.AllReduce(chunk_size=128),
                               device=device)
        rank = int(os.environ.get('AUTODIST_PROCESS_ID', 0))
        share = world
    np.random.seed(123)
    inputs = np.random.randn(1000)
    outputs = inputs * 3.0 + 2.0 + np.random.randn(1000)
    with autodist.scope():
        x = ad.placeholder(shape=[None], dtype=np.float32, name='x')
        y = ad.placeholder(shape=[None], dtype=np.float32, name='y')
        W = ad.Variable(5.0, name='W')
        b = ad.Variable(0.0, name='b')
        loss = ad.ops.reduce_mean(ad.ops.square(W * x + b - y))
        train_op = ad.optimizers.SGD(0.01).minimize(loss, [W, b])
        sess = autodist.create_distributed_session()
        feed = {x: cs.local_slice(inputs, rank, share),
                y: cs.local_slice(outputs, rank, share)}
        losses = [float(sess.run([loss, train_op], feed)[0])
                  for _ in range(steps)]
        W_val, b_val = (float(np.ravel(v)[0]) for v in sess.run([W, b]))
    import torch.distributed as dist
    rec = {'rank': rank, 'losses': losses, 'W': W_val, 'b': b_val,
           'world': dist.get_world_size() if dist.is_initialized() else 1,
           'backend': dist.get_backend() if dist.is_initialized() else '',
           'device': str(sess._device)}
    with open(os.path.join(out, 'rank%%d.json' %% rank), 'w') as f:
        json.dump(rec, f)
    if dist.is_initialized():
        dist.barrier()   # the chief's exit terminates what it launched
''')


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def run(device, out, timeout=300):
    """The launched run (the chief plus three shim-launched workers) and
    the one-process reference, both writing ``rank<r>.json`` under
    ``out/launched`` and ``out/single``. Returns (launched, reference)."""
    import chip_smoke
    launched, single = (os.path.join(out, d) for d in ('launched',
                                                       'single'))
    for d in (launched, single):
        os.makedirs(d, exist_ok=True)
    bindir = chip_smoke.write_shims(os.path.join(out, 'bin'))
    spec = os.path.join(out, 'resources.yml')
    with open(spec, 'w') as f:
        json.dump({'nodes': [
            dict({'address': '127.0.0.%d' % (r + 1), 'gpus': [r],
                  'network_bandwidth': 100}, **({'chief': True} if r == 0
                                                else {}))
            for r in range(WORLD)]}, f)
    prog = os.path.join(out, 'prog.py')
    with open(prog, 'w') as f:
        f.write(PROG % {'repo': REPO, 'world': WORLD, 'steps': STEPS})
    env = {k: v for k, v in os.environ.items()
           if not k.startswith('AUTODIST_')}
    env.update(PATH=bindir + os.pathsep + env.get('PATH', ''),
               SHIM_LOG=os.path.join(out, 'shim.log'),
               SYS_RESOURCE_PATH=spec, PYTHONPATH=REPO, OMP_NUM_THREADS='1',
               AUTODIST_COORD_SERVICE_ADDR='127.0.0.1:%d' % _free_port(),
               AUTODIST_COORDINATOR_ADDR='127.0.0.1:%d' % _free_port())
    try:
        chief = subprocess.run([sys.executable, prog, device, launched],
                               env=env, cwd=out, capture_output=True,
                               text=True, timeout=timeout)
    finally:
        # a chief that fails fast runs no exit handler for its service
        from autodist_tpu_torch.runtime.coord_client import CoordClient
        host, port = env['AUTODIST_COORD_SERVICE_ADDR'].rsplit(':', 1)
        try:
            CoordClient((host, int(port)), timeout=2.0).shutdown()
        except OSError:
            pass
    assert chief.returncode == 0, chief.stderr[-4000:]
    ref_env = {k: v for k, v in env.items() if k != 'SYS_RESOURCE_PATH'}
    ref = subprocess.run([sys.executable, prog, device, single, 'single'],
                         env=ref_env, cwd=out, capture_output=True,
                         text=True, timeout=timeout)
    assert ref.returncode == 0, ref.stderr[-4000:]
    got = []
    for r in range(WORLD):
        with open(os.path.join(launched, 'rank%d.json' % r)) as f:
            got.append(json.load(f))
    with open(os.path.join(single, 'rank0.json')) as f:
        want = json.load(f)
    with open(os.path.join(out, 'shim.log')) as f:
        shim = f.read()
    return got, want, shim


def check(got, want, shim, backend):
    assert [g['rank'] for g in got] == list(range(WORLD))
    for g in got:
        assert g['world'] == WORLD and g['backend'] == backend, g
        np.testing.assert_allclose(g['W'], want['W'], atol=1e-5, rtol=0)
        np.testing.assert_allclose(g['b'], want['b'], atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.mean([g['losses'] for g in got], axis=0),
                               want['losses'], rtol=1e-5)
    for r in range(1, WORLD):
        assert 'AUTODIST_WORKER=127.0.0.%d ' % (r + 1) in shim, shim
    assert shim.count('mv -f') == WORLD - 1


@pytest.mark.cuda
def test_chief_launches_four_ranks_under_nccl(tmp_path):
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < WORLD:
        pytest.skip('needs four CUDA cards')
    got, want, shim = run('cuda', str(tmp_path))
    check(got, want, shim, 'nccl')
    assert [g['device'] for g in got] == ['cuda:%d' % r
                                          for r in range(WORLD)]
    print(json.dumps({'launched': got, 'single': want}))


if __name__ == '__main__':
    # python tests/test_torch_launch_cuda.py gloo <dir>: the same program
    # over gloo on the CPU
    assert sys.argv[1] == 'gloo'
    sys.path.insert(0, REPO)
    got, want, shim = run('cpu', sys.argv[2])
    check(got, want, shim, 'gloo')
    print(json.dumps({'launched': got, 'single': want}))
