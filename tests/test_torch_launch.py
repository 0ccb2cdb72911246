"""The port's launch path: :class:`Coordinator` over ssh, the chief's
worker launch from ``AutoDist``, and ``python -m
autodist_tpu_torch.launch`` (the counterpart of the JAX package's
``tests/integration/test_ssh_launch.py`` and the ``Coordinator`` cases
of ``tests/test_coordinator_recovery.py``).

- Under ``AUTODIST_DEBUG_REMOTE`` the port's Coordinator logs the same
  scp, rename and ssh command lines as the JAX package's for the same
  spec and env; the one difference allowed is the ``LIBTPU_INIT_ARGS``
  assignment the JAX package forwards and the port drops (the TPU
  runtime's). The strategy files share one path for the comparison.
- The exec-shim tier: ``ssh`` and ``scp`` on ``PATH`` are shims that run
  the remote command here (``chip_smoke.write_shims``, the JAX test's
  shims), so the chief's generated command lines are really forked.
  Both roles of a loose c0 run train; a worker's ``os._exit(17)`` makes
  the chief exit 1 (fail-fast supervision).
- A lock-step ``AllReduce`` c0 run that the port chief launched forms a
  gloo group of 2 and its ``b`` after one step equals the JAX package's
  c0 value within 1e-6.
- ``launch_cli`` over two local nodes exits 0 with both roles' results
  and its coord service gone.

Heartbeat timeouts are 1 s; the shim processes import the port only.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

import chip_smoke
from autodist_tpu_torch.runtime.coordinator import Coordinator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B_TOL = 1e-6

PROG = textwrap.dedent("""
    import json, os, sys
    for name in ('jax', 'jaxlib', 'autodist_tpu'):
        sys.modules[name] = None
    import numpy as np
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, %(repo)r)
    import autodist_tpu_torch as ad

    ROLE = 'worker' if os.environ.get('AUTODIST_WORKER') else 'chief'
    autodist = ad.AutoDist(strategy_builder=ad.PS(staleness=1),
                           device='cpu')
    np.random.seed(123)
    inputs = np.random.randn(1000).astype(np.float32)
    outputs = (inputs * 3.0 + 2.0 +
               np.random.randn(1000)).astype(np.float32)
    with autodist.scope():
        x = ad.placeholder(shape=[None], dtype=np.float32, name='x')
        y = ad.placeholder(shape=[None], dtype=np.float32, name='y')
        W = ad.Variable(5.0, name='W')
        b = ad.Variable(0.0, name='b')
        loss = ad.ops.reduce_mean(ad.ops.square(W * x + b - y))
        train_op = ad.optimizers.SGD(0.01).minimize(loss, [W, b])
        sess = autodist.create_distributed_session()
        %(worker_hook)s
        for _ in range(3):
            sess.run(train_op, {x: inputs, y: outputs})
        b_val = float(np.ravel(sess.get_variable_value('b'))[0])
    print('RESULT ' + json.dumps({
        'role': ROLE, 'b': b_val, 'rank': sess._rank,
        'world': sess._num_workers,
        'strategy_id': os.environ.get('AUTODIST_STRATEGY_ID', '')}),
        flush=True)
    autodist._coord.barrier('test/done', 2, timeout_s=120.0)
    sess.close()
""")

LOCKSTEP = textwrap.dedent("""
    import json, os, sys
    for name in ('jax', 'jaxlib', 'autodist_tpu'):
        sys.modules[name] = None
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    sys.path.insert(0, %(repo)r)
    import autodist_tpu_torch as ad
    import chip_smoke as cs

    autodist = ad.AutoDist(strategy_builder=ad.AllReduce(chunk_size=128),
                           device='cpu')
    # the chief is rank 0 of the spec's two nodes; it claims that
    # identity only when its session builds, so its share is named here
    loss, W, b = cs.run_linear_regression(
        autodist, int(os.environ.get('AUTODIST_PROCESS_ID', 0)), 2)
    print('RESULT ' + json.dumps({
        'role': 'worker' if os.environ.get('AUTODIST_WORKER') else 'chief',
        'rank': dist.get_rank(), 'world': dist.get_world_size(),
        'backend': dist.get_backend(), 'loss': loss, 'W': W, 'b': b}),
        flush=True)
    # the chief's exit terminates the workers it launched
    dist.barrier()
""")


def free_port():
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _resource_file(tmp_path):
    info = {'nodes': [
        {'address': '127.0.0.1', 'cpus': [0], 'gpus': [0], 'chief': True,
         'network_bandwidth': 100},
        {'address': '127.0.0.2', 'cpus': [0], 'gpus': [0],
         'network_bandwidth': 100}]}
    path = tmp_path / 'resources.yml'
    path.write_text(json.dumps(info))   # JSON is valid YAML
    return str(path)


def _env(tmp_path, shims=True):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith('AUTODIST_')}
    env.update(SYS_RESOURCE_PATH=_resource_file(tmp_path),
               AUTODIST_COORD_SERVICE_ADDR='127.0.0.1:%d' % free_port(),
               AUTODIST_COORDINATOR_ADDR='127.0.0.1:%d' % free_port(),
               AUTODIST_HEARTBEAT_TIMEOUT='1',
               # a forwarded flag: it must ride the worker's command line
               AUTODIST_S2D_STEM='1',
               SHIM_LOG=str(tmp_path / 'shim.log'), OMP_NUM_THREADS='1',
               PYTHONPATH=REPO)
    if shims:
        env['PATH'] = chip_smoke.write_shims(str(tmp_path / 'bin')) + \
            os.pathsep + env['PATH']
    return env


def _stop_service(addr):
    """Shut down the coord service a chief started at ``addr``: a chief
    that exits through the fail-fast path runs no exit handler."""
    from autodist_tpu_torch.runtime.coord_client import CoordClient
    host, port = addr.rsplit(':', 1)
    try:
        CoordClient((host, int(port)), timeout=2.0).shutdown()
    except OSError:
        pass


def _run(tmp_path, prog, argv=(), shims=True, timeout=120):
    path = tmp_path / 'prog.py'
    path.write_text(prog)
    env = _env(tmp_path, shims)
    try:
        return subprocess.run([sys.executable] + list(argv) + [str(path)],
                              env=env, cwd=str(tmp_path),
                              capture_output=True, text=True,
                              timeout=timeout)
    finally:
        _stop_service(env['AUTODIST_COORD_SERVICE_ADDR'])


def _results(out):
    """RESULT payloads; processes share one pipe, so lines can butt
    against each other."""
    dec = json.JSONDecoder()
    found, text, pos = [], out.stdout, 0
    while True:
        pos = text.find('RESULT ', pos)
        if pos < 0:
            return found
        obj, end = dec.raw_decode(text[pos + len('RESULT '):])
        found.append(obj)
        pos += len('RESULT ') + end


# -- the exec-shim tier -------------------------------------------------------
@pytest.mark.integration
def test_ssh_launch_path_executes(tmp_path):
    """The chief forks ssh/scp (exec shims), the shipped command line
    brings up the worker as rank 1 of 2, both train, and the strategy
    file ships by scp to a temporary name and ``mv -f``."""
    out = _run(tmp_path, PROG % {'repo': REPO, 'worker_hook': 'pass'})
    assert out.returncode == 0, out.stderr[-4000:]
    results = {r['role']: r for r in _results(out)}
    assert set(results) == {'chief', 'worker'}, out.stdout
    assert (results['chief']['rank'], results['worker']['rank']) == (0, 1)
    assert results['chief']['world'] == results['worker']['world'] == 2
    for r in results.values():
        assert abs(r['b']) > 1e-4, r
    assert results['worker']['strategy_id']
    log = (tmp_path / 'shim.log').read_text()
    assert 'scp' in log and '127.0.0.2' in log, log
    assert 'AUTODIST_WORKER=127.0.0.2' in log, log
    assert 'AUTODIST_STRATEGY_ID=%s' % results['worker']['strategy_id'] \
        in log, log
    assert 'AUTODIST_S2D_STEM=1' in log, log
    assert 'mv -f' in log, log


@pytest.mark.integration
def test_ssh_launch_monitor_fails_fast(tmp_path):
    """A worker dying mid-run makes the chief exit 1 through the
    fail-fast supervisor, with real forked processes."""
    hook = ("if ROLE == 'worker':\n"
            "            sess.run(train_op, {x: inputs, y: outputs})\n"
            "            os._exit(17)   # simulated crash mid-run")
    t0 = time.time()
    out = _run(tmp_path, PROG % {'repo': REPO, 'worker_hook': hook})
    assert out.returncode == 1, (out.returncode, out.stdout,
                                 out.stderr[-2000:])
    assert time.time() - t0 < 60
    assert 'exited with code 17' in (out.stdout + out.stderr)


def _jax_c0_b():
    """The JAX package's c0 ``b`` after one step over 2 replicas."""
    import autodist_tpu as jad
    from autodist_tpu import autodist as jad_mod
    jad_mod._DEFAULT_AUTODIST.clear()
    autodist = jad.AutoDist(resource_info={'nodes': [{
        'address': 'localhost', 'gpus': [0, 1], 'chief': True,
        'network_bandwidth': 100}]},
        strategy_builder=jad.strategy.AllReduce(chunk_size=128))
    np.random.seed(123)
    inputs = np.random.randn(1000)
    noises = np.random.randn(1000)
    outputs = inputs * 3.0 + 2.0 + noises
    with autodist.scope():
        x = jad.placeholder(shape=[None], dtype=np.float32, name='x')
        y = jad.placeholder(shape=[None], dtype=np.float32, name='y')
        W = jad.Variable(5.0, name='W')
        b = jad.Variable(0.0, name='b')
        loss = jad.ops.reduce_mean(jad.ops.square(W * x + b - y))
        train_op = jad.optimizers.SGD(0.01).minimize(loss, [W, b])
        sess = autodist.create_distributed_session()
        sess.run([loss, train_op], {x: inputs, y: outputs})
        b_val = float(np.ravel(sess.run(b))[0])
    jad_mod._DEFAULT_AUTODIST.clear()
    return b_val


@pytest.mark.integration
def test_lockstep_c0_launched_by_the_chief_matches_jax(tmp_path):
    """AllReduce c0 over gloo, the worker launched by the port chief
    through the shims: both ranks end with the JAX package's b."""
    out = _run(tmp_path, LOCKSTEP % {'repo': REPO})
    assert out.returncode == 0, out.stderr[-4000:]
    results = {r['role']: r for r in _results(out)}
    assert set(results) == {'chief', 'worker'}, out.stdout
    want = _jax_c0_b()
    for r in results.values():
        assert r['world'] == 2 and r['backend'] == 'gloo'
        assert abs(r['b'] - want) <= B_TOL, (r, want)
    assert (results['chief']['rank'], results['worker']['rank']) == (0, 1)


@pytest.mark.integration
def test_launch_cli_two_local_nodes(tmp_path):
    """``python -m autodist_tpu_torch.launch --spec`` with two local
    nodes: rc 0, both roles' results, and the launcher's coord service
    stops with it."""
    env = _env(tmp_path, shims=False)
    path = tmp_path / 'prog.py'
    path.write_text(PROG % {'repo': REPO, 'worker_hook': 'pass'})
    out = subprocess.run(
        [sys.executable, '-m', 'autodist_tpu_torch.launch', '--spec',
         env['SYS_RESOURCE_PATH'], str(path)], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-4000:]
    results = {r['role']: r for r in _results(out)}
    assert set(results) == {'chief', 'worker'}, out.stdout
    assert not results['worker']['strategy_id']   # the coord-service blob
    host, port = env['AUTODIST_COORD_SERVICE_ADDR'].rsplit(':', 1)
    with pytest.raises(OSError):
        socket.create_connection((host, int(port)), timeout=2.0).close()


# -- AUTODIST_DEBUG_REMOTE: the command lines ---------------------------------
def _debug_lines(pkg, tmp_path, monkeypatch):
    """The debug-remote lines of ``launch_clients`` and ``scale_up(1)``
    from ``pkg``'s Coordinator over a 3-node spec with an ssh section
    (key, port, user, venv) and a coord token."""
    import logging
    if pkg == 'jax':
        from autodist_tpu.resource_spec import ResourceSpec
        from autodist_tpu.runtime.coordinator import Coordinator as Co
        from autodist_tpu.strategy import base
        from autodist_tpu.utils import logging as adlog
    else:
        from autodist_tpu_torch.resource_spec import ResourceSpec
        from autodist_tpu_torch.runtime.coordinator import Coordinator as Co
        from autodist_tpu_torch.strategy import base
        from autodist_tpu_torch.utils import logging as adlog
    s = base.Strategy(strategy_id='launch-parity')
    s.node_config = [base.StrategyNode(
        var_name='w', synchronizer=base.PSSynchronizer(staleness=2))]
    s.path = str(tmp_path / 'strategies' / 'launch-parity')
    os.makedirs(os.path.dirname(s.path), exist_ok=True)
    spec = ResourceSpec(resource_info={
        'nodes': [{'address': '10.0.0.1', 'gpus': [0], 'chief': True,
                   'network_bandwidth': 100},
                  {'address': '10.0.0.2', 'gpus': [0],
                   'network_bandwidth': 100, 'ssh_config': 'c'},
                  {'address': '10.0.0.3', 'gpus': [0],
                   'network_bandwidth': 100}],
        'ssh': {'c': {'key_file': '/keys/id', 'port': 2222,
                      'username': 'me', 'python_venv': '/venv'}}})
    lines = []

    class Grab(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if msg.startswith('[debug-remote]'):
                lines.append(msg)

    handler = Grab()
    logger = adlog.get_logger()
    logger.addHandler(handler)
    try:
        co = Co(s, spec)
        co.launch_clients()
        co.scale_up(1)
    finally:
        logger.removeHandler(handler)
    return lines


def test_debug_remote_command_lines_equal_jax(tmp_path, monkeypatch):
    for k in list(os.environ):
        if k.startswith('AUTODIST_'):
            monkeypatch.delenv(k)
    monkeypatch.setenv('AUTODIST_DEBUG_REMOTE', '1')
    monkeypatch.setenv('AUTODIST_COORD_TOKEN', 's3cret')
    monkeypatch.setenv('AUTODIST_COORD_SERVICE_ADDR',
                       '10.0.0.1:%d' % free_port())
    monkeypatch.setenv('AUTODIST_PEER_FAILURE_POLICY', 'exclude')
    monkeypatch.setenv('AUTODIST_TELEMETRY', '1')
    monkeypatch.setenv('AUTODIST_PS_PIPELINE_DEPTH', '2')
    monkeypatch.setenv('LIBTPU_INIT_ARGS', '--xla_tpu_flag=1')
    monkeypatch.setattr(sys, 'argv', ['/work/train.py', '--lr', '0.1'])
    monkeypatch.chdir(tmp_path)
    jax_lines = _debug_lines('jax', tmp_path, monkeypatch)
    port_lines = _debug_lines('port', tmp_path, monkeypatch)
    assert len(jax_lines) == len(port_lines) == 3 * 2 * 2 + 3
    dropped = " LIBTPU_INIT_ARGS=--xla_tpu_flag=1"
    assert all(dropped not in line for line in port_lines)
    assert [line.replace(dropped, '') for line in jax_lines] == port_lines
    launch = [line for line in port_lines if 'train.py' in line]
    assert len(launch) == 3
    assert launch[0].startswith('[debug-remote] ssh -o '
                                'StrictHostKeyChecking=no -i /keys/id -p '
                                '2222 me@10.0.0.2 cd ')
    assert '. /venv/bin/activate && AUTODIST_WORKER=10.0.0.2 ' in launch[0]
    assert 'AUTODIST_COORD_TOKEN_FILE=' in launch[0]
    assert 's3cret' not in ' '.join(port_lines)
    assert 'AUTODIST_ELASTIC_JOIN=1' in launch[2] and \
        'AUTODIST_PROCESS_ID=3' in launch[2]
    assert oct(os.stat(tmp_path / 'strategies' / 'coord_token')
               .st_mode & 0o777) == '0o600'


# -- the Coordinator cases of tests/test_coordinator_recovery.py -------------
def _strategy(staleness):
    from autodist_tpu_torch.strategy.base import (AllReduceSynchronizer,
                                                  PSSynchronizer, Strategy,
                                                  StrategyNode)
    s = Strategy(strategy_id='scaleup-test')
    sync = PSSynchronizer(staleness=staleness) if staleness is not None \
        else AllReduceSynchronizer()
    s.node_config = [StrategyNode(var_name='w', synchronizer=sync)]
    return s


def _coordinator(nodes=2, staleness=2):
    from autodist_tpu_torch.resource_spec import ResourceSpec
    info = {'nodes': [{'address': 'localhost', 'chief': True,
                       'gpus': [0], 'network_bandwidth': 10}]}
    for i in range(1, nodes):
        info['nodes'].append({'address': '127.0.0.%d' % i, 'gpus': [0],
                              'network_bandwidth': 10})
    co = Coordinator(_strategy(staleness), ResourceSpec(resource_info=info))
    co._next_pid = nodes
    return co


def _capture(caplog):
    from autodist_tpu_torch.utils import logging as adlog
    logger = adlog.get_logger()
    logger.addHandler(caplog.handler)
    return logger


def test_effective_policy_forces_fail_for_lockstep(monkeypatch):
    monkeypatch.setenv('AUTODIST_PEER_FAILURE_POLICY', 'exclude')
    assert _coordinator(staleness=None)._effective_policy() == 'fail'
    assert _coordinator(staleness=2)._effective_policy() == 'exclude'
    monkeypatch.setenv('AUTODIST_PEER_FAILURE_POLICY', 'fail')
    assert _coordinator(staleness=2)._effective_policy() == 'fail'


def test_coord_service_targets_dedup_local_spellings(monkeypatch):
    monkeypatch.setenv('AUTODIST_COORD_SERVICE_ADDR', 'localhost:5000')
    monkeypatch.setenv('AUTODIST_PS_ENDPOINTS',
                       '127.0.0.1:5000,127.0.0.1:5001')
    assert _coordinator()._coord_service_targets() == [
        ('127.0.0.1', 5000), ('127.0.0.1', 5001)]


def test_scale_up_launches_joiners_with_elastic_env(monkeypatch, caplog):
    monkeypatch.setenv('AUTODIST_DEBUG_REMOTE', '1')
    monkeypatch.setenv('AUTODIST_PEER_FAILURE_POLICY', 'exclude')
    monkeypatch.setenv('AUTODIST_COORD_SERVICE_ADDR',
                       '127.0.0.1:%d' % free_port())
    co = _coordinator(nodes=2)
    logger = _capture(caplog)
    try:
        co.scale_up(2)
    finally:
        logger.removeHandler(caplog.handler)
    launched = [r.getMessage() for r in caplog.records
                if 'AUTODIST_ELASTIC_JOIN=1' in r.getMessage()]
    assert len(launched) == 2
    assert any('AUTODIST_PROCESS_ID=2' in m for m in launched)
    assert any('AUTODIST_PROCESS_ID=3' in m for m in launched)
    assert co._next_pid == 4


def test_scale_up_restart_policy_maps_to_exclude(monkeypatch, caplog):
    monkeypatch.setenv('AUTODIST_DEBUG_REMOTE', '1')
    monkeypatch.setenv('AUTODIST_PEER_FAILURE_POLICY', 'restart')
    monkeypatch.setenv('AUTODIST_COORD_SERVICE_ADDR',
                       '127.0.0.1:%d' % free_port())
    co = _coordinator(nodes=2)
    logger = _capture(caplog)
    try:
        co.scale_up(1)
    finally:
        logger.removeHandler(caplog.handler)
    assert any('exclude semantics' in r.getMessage()
               for r in caplog.records)


def test_scale_up_clamped_by_max_workers(monkeypatch):
    monkeypatch.setenv('AUTODIST_DEBUG_REMOTE', '1')
    monkeypatch.setenv('AUTODIST_MAX_WORKERS', '3')
    monkeypatch.setenv('AUTODIST_COORD_SERVICE_ADDR',
                       '127.0.0.1:%d' % free_port())
    co = _coordinator(nodes=2)
    co.scale_up(5)                  # room for exactly one more
    assert co._next_pid == 3


def test_autoscaler_wires_scale_up_and_metrics_source(monkeypatch):
    """``Coordinator.autoscaler``: its decisions execute through
    ``scale_up`` from the ordinals already issued, on the sampled
    ``metrics_source`` signal."""
    monkeypatch.setenv('AUTODIST_MAX_WORKERS', '8')
    monkeypatch.setenv('AUTODIST_COORD_SERVICE_ADDR',
                       '127.0.0.1:%d' % free_port())
    from autodist_tpu_torch.runtime.coordinator import autoscale_policy
    co = _coordinator(nodes=2)
    asked = []
    co.scale_up = lambda n: asked.append(n) or [object()] * n
    ctl = co.autoscaler(autoscale_policy(step_time_target_s=0.5),
                        metrics_source=lambda: {'step_time_s': 1.0})
    rec = ctl.tick()
    assert rec['action'] == 'scale_up' and asked == [1]
    assert rec['world'] == 2 and ctl.world == 3
    assert ctl.tick({'step_time_s': 0.1})['reason'] == 'no_opinion'


def test_run_remote_retries_transient_failure_once(monkeypatch):
    calls = []

    def flaky(cmd, check, timeout):
        calls.append((tuple(cmd), timeout))
        if len(calls) == 1:
            raise subprocess.TimeoutExpired(cmd, timeout)

    monkeypatch.setattr(subprocess, 'run', flaky)
    monkeypatch.setattr(
        'autodist_tpu_torch.runtime.coordinator.time.sleep', lambda s: None)
    Coordinator._run_remote(['scp', 'a', 'b'], 'test ship', timeout_s=7.0)
    assert len(calls) == 2 and all(t == 7.0 for _, t in calls)


def test_run_remote_raises_after_retry_budget(monkeypatch):
    def always_down(cmd, check, timeout):
        raise subprocess.CalledProcessError(255, cmd)

    monkeypatch.setattr(subprocess, 'run', always_down)
    monkeypatch.setattr(
        'autodist_tpu_torch.runtime.coordinator.time.sleep', lambda s: None)
    with pytest.raises(subprocess.CalledProcessError):
        Coordinator._run_remote(['ssh', 'h', 'mv a b'], 'test ship')


def test_chief_identity_is_rank_zero_of_the_spec(monkeypatch):
    """One derivation: the chief claims rank 0 of one process per node,
    and the workers it launches are given the same count."""
    from autodist_tpu_torch.runtime.coordinator import (claim_chief_identity,
                                                        launch_world)
    for name in ('AUTODIST_PROCESS_ID', 'AUTODIST_NUM_PROCESSES'):
        monkeypatch.setenv(name, '')   # restored as absent afterwards
        monkeypatch.delenv(name)
    co = _coordinator(nodes=3)
    assert launch_world(co._resource_spec) == 3
    assert claim_chief_identity(co._resource_spec) == (3, 0)
    assert co._worker_env('127.0.0.1', 1)['AUTODIST_NUM_PROCESSES'] == '3'
    assert os.environ['AUTODIST_PROCESS_ID'] == '0'
