"""Single-process loose-mode harness.

The counterpart of ``autodist_tpu/utils/loose_harness.py``. Loose mode
is a mode of several processes; driving its PS data plane from one
process takes an environment dance: the build must see 2 processes (the
mode decision) while the session sees 1 (no peers to wait for) — the
same data plane either way. The tests and ``chip_smoke.py`` both ride
this helper, so the dance lives in one place. :func:`start_service` and
:func:`stop_service` give such a harness a coord service of its own.

:func:`ack_staged_swaps` of the JAX module (the epoch-swap ack of a
simulated peer) waits for the epoch swap (ROADMAP.md Queue 1,
"Loose-mode PS plane", its second half).
"""
import os
import socket
import subprocess
import tempfile
import time
from contextlib import contextmanager

_KNOBS = ('AUTODIST_COORD_SERVICE_ADDR', 'AUTODIST_PS_PIPELINE_DEPTH',
          'AUTODIST_NUM_PROCESSES', 'AUTODIST_PROCESS_ID')


@contextmanager
def single_process_loose_env(coord_port, depth):
    """Environment for a single-process loose run against the coord
    service on localhost ``coord_port`` at PS pipeline ``depth``.

    Yields a zero-argument callable to call after ``autodist._build()``
    (which must see 2 processes: loose mode) and before
    ``create_distributed_session()`` (which must see 1: no peers to
    meet). Every knob is restored on exit, and the process's AutoDist
    slot is released so the caller's instance owns it.
    """
    from autodist_tpu_torch import autodist as ad_mod
    saved = {k: os.environ.get(k) for k in _KNOBS}
    ad_mod._DEFAULT_AUTODIST.clear()
    try:
        # this process is the chief, started by no launcher
        os.environ.pop('AUTODIST_PROCESS_ID', None)
        os.environ['AUTODIST_COORD_SERVICE_ADDR'] = \
            '127.0.0.1:%d' % coord_port
        os.environ['AUTODIST_PS_PIPELINE_DEPTH'] = str(depth)
        os.environ['AUTODIST_NUM_PROCESSES'] = '2'

        def session_sees_one_process():
            os.environ['AUTODIST_NUM_PROCESSES'] = '1'

        yield session_sees_one_process
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def start_service(attempts=20, wait_s=30.0):
    """A coord service of the caller's own on a free loopback port:
    ``(port, process)``.

    ``coord_client.ensure_service`` joins whatever already listens on
    its port, so a harness that shuts its service down afterwards could
    stop another's. Here the binary (built from the checkout's
    ``native/coord_service.cc``) is started on a port just probed free
    and counts as started only once it reports that it listens; when
    another process took the port between the probe and the bind, the
    binary exits and the next attempt probes another port.
    """
    from autodist_tpu_torch.native_build import build
    from autodist_tpu_torch.runtime.coord_client import coord_token
    binary = build('coord_service.cc')
    env = dict(os.environ)
    token = coord_token()
    if token:
        env['AUTODIST_COORD_TOKEN'] = token
    for _ in range(attempts):
        with socket.socket() as sock:
            sock.bind(('127.0.0.1', 0))
            port = sock.getsockname()[1]
        with tempfile.TemporaryFile() as err:
            proc = subprocess.Popen([binary, str(port), '127.0.0.1'],
                                    stdout=subprocess.DEVNULL, stderr=err,
                                    env=env)
            deadline = time.time() + wait_s
            while time.time() < deadline:
                err.seek(0)
                if b'listening on' in err.read():
                    return port, proc
                if proc.poll() is not None:
                    break               # the port was taken: probe again
                time.sleep(0.02)
            else:
                proc.kill()
                proc.wait()
                raise RuntimeError('coord_service did not listen on :%d '
                                   'within %.0f s' % (port, wait_s))
    raise RuntimeError('coord_service found no free port in %d attempts'
                       % attempts)


def stop_service(port, proc, timeout=10.0):
    """Shut down a service :func:`start_service` started. While ``proc``
    lives the port is its own, so the shutdown reaches no other."""
    from autodist_tpu_torch.runtime.coord_client import CoordClient
    if proc.poll() is None:
        try:
            CoordClient(('127.0.0.1', port), timeout=2.0).shutdown()
        except OSError:
            pass
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=timeout)
