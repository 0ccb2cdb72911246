"""Coordinator: launch and babysit the worker processes across hosts
(the counterpart of ``autodist_tpu/runtime/coordinator.py``).

Reference parity (``autodist/coordinator.py:46-110``): the chief re-runs
the *user's own script* on every other host with the serialized strategy
id in the environment, then fail-fast-monitors the remote processes
(``os._exit(1)`` when any worker dies). :class:`Coordinator` keeps that
contract and adds the identity variables (process id, process count,
the rendezvous address ``torch.distributed`` forms its group at, the
coord service) so the launched processes form one run.

- :class:`WorkerSupervisor`: the policy-aware babysitter of one worker
  (``fail`` / ``exclude`` / ``restart``);
- :func:`autoscale_policy` and :class:`AutoscaleController`: the
  autoscale decision layer;
- :class:`Coordinator`: the ssh launch (``launch_clients``), supervised
  growth (``scale_up``) and its autoscaler;
- :func:`launch_cli`: ``python -m autodist_tpu_torch.launch``, one
  process per node of the spec with the identity env set.

Remote execution is plain ssh via subprocess; ``AUTODIST_DEBUG_REMOTE``
logs the commands instead of running them (reference
cluster.py:340-342). The JAX package also arms the XLA overlap flags and
forwards ``LIBTPU_INIT_ARGS``; both are the TPU runtime's and have no
counterpart here.
"""
import os
import shlex
import subprocess
import sys
import threading
import time

from autodist_tpu_torch.const import (DEFAULT_COORD_PORT,
                                      DEFAULT_JAX_COORD_PORT,
                                      DEFAULT_WORKING_DIR, ENV)
from autodist_tpu_torch.utils import logging

#: the knobs every launched process must see as the chief does: each is
#: part of the program, the wire format, or the cohort's shared policy
#: (JAX ``coordinator.py:26-114``, every one of them in the port's
#: ``const.ENV``)
_FORWARDED_FLAGS = (ENV.AUTODIST_MIN_LOG_LEVEL, ENV.AUTODIST_IS_TESTING,
                    ENV.AUTODIST_COORD_SERVICE_ADDR,
                    ENV.AUTODIST_HEARTBEAT_TIMEOUT,
                    ENV.AUTODIST_PS_ENDPOINTS, ENV.AUTODIST_PS_WIRE_DTYPE,
                    ENV.AUTODIST_PS_CHUNK_BYTES,
                    # row-sparse push: every worker classifies deltas
                    # under the same threshold and refresh cadence
                    ENV.AUTODIST_SPARSE_PUSH_MAX_FRAC,
                    ENV.AUTODIST_SPARSE_FULL_REFRESH_EVERY,
                    # the block layout is part of the compressor and of
                    # the PS frame format
                    ENV.AUTODIST_QUANT_BLOCK,
                    ENV.AUTODIST_S2D_STEM, ENV.AUTODIST_DENSENET_DUS,
                    # kernel choice and pipeline variant: the ranks of a
                    # lock-step group must run the same program
                    ENV.AUTODIST_FUSED_CONV,
                    ENV.AUTODIST_FUSED_CONV_MAX_ROWS,
                    ENV.AUTODIST_PP_STASH_LIMIT_MB,
                    ENV.AUTODIST_HIERARCHY_NODES,
                    ENV.AUTODIST_WEIGHT_UPDATE_SHARDING,
                    # the roofline: one cadence and one peak row for the
                    # whole cohort, or the comparison skews
                    ENV.AUTODIST_ROOFLINE, ENV.AUTODIST_ROOFLINE_EVERY,
                    ENV.AUTODIST_ROOFLINE_PEAKS,
                    ENV.AUTODIST_BUCKET_BYTES, ENV.AUTODIST_XLA_OVERLAP,
                    ENV.AUTODIST_PS_TORN_RETRIES,
                    ENV.AUTODIST_PS_TORN_BACKOFF_S,
                    # the loose data plane: depth and stall window
                    ENV.AUTODIST_PS_PIPELINE_DEPTH,
                    ENV.AUTODIST_PS_STALL_TIMEOUT_S,
                    # local SGD: the gate counts rounds, so every worker
                    # agrees on the window and the merge rule
                    ENV.AUTODIST_LOCAL_STEPS,
                    ENV.AUTODIST_LOCAL_SGD_AVERAGE,
                    # elastic recovery and growth: one policy, one set
                    # of bounds
                    ENV.AUTODIST_PEER_FAILURE_POLICY,
                    ENV.AUTODIST_MIN_WORKERS,
                    ENV.AUTODIST_MAX_WORKER_RESTARTS,
                    ENV.AUTODIST_RESTART_WAIT_S,
                    ENV.AUTODIST_MAX_WORKERS,
                    # the telemetry plane: a cohort timeline needs every
                    # worker emitting and pushing under the chief's knobs
                    ENV.AUTODIST_TELEMETRY,
                    ENV.AUTODIST_TELEMETRY_DIR,
                    ENV.AUTODIST_TELEMETRY_MAX_SPANS,
                    ENV.AUTODIST_TELEMETRY_PUSH_EVERY,
                    ENV.AUTODIST_FLIGHT_RECORDER_EVENTS,
                    # serving readers grade staleness like the fleet
                    ENV.AUTODIST_SERVE_POLL_S,
                    ENV.AUTODIST_SERVE_STALENESS_BOUND,
                    ENV.AUTODIST_SERVE_ROW_CACHE_ROWS,
                    ENV.AUTODIST_SERVE_ROW_TTL_S,
                    ENV.AUTODIST_SERVE_SNAPSHOT_RETRIES,
                    ENV.AUTODIST_SERVE_WIRE,
                    # the epoch swap's opt-in and handshake bounds
                    ENV.AUTODIST_EXECUTE_REPLAN,
                    ENV.AUTODIST_SWAP_ACK_TIMEOUT_S,
                    ENV.AUTODIST_SWAP_RETRY_BACKOFF_S,
                    ENV.AUTODIST_SWAP_MAX_RETRIES,
                    ENV.SYS_DATA_PATH, ENV.SYS_RESOURCE_PATH)


def launch_world(resource_spec):
    """The process count of a run the chief launches: one process per
    node of the spec, unless the caller set ``AUTODIST_NUM_PROCESSES``.
    The one place that count is derived: the chief claims it
    (:func:`claim_chief_identity`) and every launched worker is given
    it."""
    return int(os.environ.get(ENV.AUTODIST_NUM_PROCESSES.name) or
               len(list(resource_spec.nodes)))


def claim_chief_identity(resource_spec):
    """Make this process rank 0 of :func:`launch_world` in its own env
    (``AUTODIST_PROCESS_ID`` / ``AUTODIST_NUM_PROCESSES``, kept when
    already set), before any worker exists, so ``AutoDist``, the
    ``Cluster`` and the session read the identity the workers are
    launched with (JAX ``autodist.py:170-174``). Returns (world, rank)."""
    os.environ[ENV.AUTODIST_NUM_PROCESSES.name] = \
        str(launch_world(resource_spec))
    os.environ.setdefault(ENV.AUTODIST_PROCESS_ID.name, '0')
    return ENV.AUTODIST_NUM_PROCESSES.val, ENV.AUTODIST_PROCESS_ID.val


class WorkerSupervisor:
    """Policy-aware babysitter for ONE worker process — the recovery
    half of the reference's fail-fast monitor (coordinator.py:98-110).

    - ``fail`` (default): any nonzero exit calls ``on_give_up`` (the
      chief aborts) — the pre-recovery behavior.
    - ``exclude``: a dead worker is logged and left to the surviving
      peers, which fence its generation and shrink the gate membership.
    - ``restart``: up to ``max_restarts`` supervised respawns with
      capped exponential backoff; the dead incarnation's writer
      generation is fenced (``fence`` callback) BEFORE every respawn —
      an ssh-severed zombie may still be alive on the remote host, and
      its writes must be rejected from the moment its replacement can
      exist. A fence attempt that fails consumes one restart attempt
      and is retried under the backoff (never an unfenced respawn, but
      never a whole-chief abort on one transient RPC miss either).
      Exhausting the cap runs ``mark_failed`` (so blocked peers
      stop waiting) and then gives up.

    ``spawn``/``fence``/``mark_failed``/``on_give_up``/``sleep`` are
    injectable: :class:`Coordinator` passes a ``spawn`` that runs the
    ssh command line, the test harnesses one that starts a fresh
    interpreter (a CUDA context does not survive ``fork``).
    """

    def __init__(self, address, spawn, policy='fail', max_restarts=0,
                 fence=None, mark_failed=None, on_give_up=None,
                 is_shutting_down=None, backoff_base_s=0.5,
                 backoff_cap_s=30.0, sleep=time.sleep):
        self.address = address
        self.proc = None
        self.restarts = 0
        self._spawn = spawn
        self._policy = policy
        self._max_restarts = max_restarts
        self._fence = fence
        self._mark_failed = mark_failed
        self._on_give_up = on_give_up or (lambda code: None)
        self._is_shutting_down = is_shutting_down or (lambda: False)
        self._backoff_base_s = backoff_base_s
        self._backoff_cap_s = backoff_cap_s
        self._sleep = sleep
        self._thread = None
        # serializes respawn against terminate(): either the respawn
        # sees the shutdown flag inside the lock, or terminate() sees
        # (and kills) the freshly assigned proc — a terminate landing
        # between the shutdown check and the Popen cannot orphan a
        # respawned worker nobody will ever stop
        self._spawn_lock = threading.Lock()

    def backoff_s(self, attempt):
        """Backoff before restart ``attempt`` (1-based): exponential
        from the base, capped."""
        return min(self._backoff_cap_s,
                   self._backoff_base_s * (2.0 ** (attempt - 1)))

    def start(self):
        self.proc = self._spawn()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name='autodist-supervise-%s' % self.address)
        self._thread.start()
        return self

    def _run(self):
        while True:
            code = self.proc.wait()
            if code == 0 or self._is_shutting_down():
                return
            if self._policy == 'exclude':
                logging.warning(
                    'Worker %s exited with code %s; policy=exclude '
                    'leaves recovery to the surviving peers (they '
                    'fence its generation and shrink the gate '
                    'membership)', self.address, code)
                return
            if self._policy == 'restart' and \
                    self.restarts < self._max_restarts:
                self.restarts += 1
                delay = self.backoff_s(self.restarts)
                logging.warning(
                    'Worker %s exited with code %s; supervised restart '
                    '%d/%d in %.1fs', self.address, code,
                    self.restarts, self._max_restarts, delay)
                self._sleep(delay)
                # a shutdown that began during the backoff (Ctrl-C,
                # clean teardown) must not be followed by a respawn
                # nobody will ever terminate — and a fence failure
                # against an already-torn-down coord service is not a
                # reason to hard-abort the chief
                if self._is_shutting_down():
                    return
                try:
                    if self._fence is not None:
                        self._fence()
                except Exception as e:  # noqa: BLE001 - retried below
                    if self._is_shutting_down():
                        return
                    # an unfenced respawn is still refused — but a
                    # transient fence failure (network blip to one PS
                    # endpoint, the dead worker's co-hosted endpoint
                    # rebooting) burns ONE restart attempt and retries
                    # under the growing backoff instead of hard-killing
                    # the whole chief on the first miss
                    logging.warning(
                        'cannot fence dead worker %s (%s: %s); '
                        'refusing an unfenced respawn — retrying the '
                        'fence (attempt %d/%d)', self.address,
                        type(e).__name__, e, self.restarts,
                        self._max_restarts)
                    continue
                try:
                    with self._spawn_lock:
                        if self._is_shutting_down():
                            return
                        self.proc = self._spawn()
                    from autodist_tpu_torch.telemetry import flight as _flight
                    _flight.recorder().record(
                        'worker_respawn', address=str(self.address),
                        attempt=self.restarts)
                except Exception as e:  # noqa: BLE001 - abort below
                    logging.error('respawn of worker %s failed: %s: %s',
                                  self.address, type(e).__name__, e)
                    self._on_give_up(code)
                    return
                continue
            if self._policy == 'restart':
                logging.error(
                    'Worker %s exhausted %d supervised restarts; '
                    'marking it permanently failed', self.address,
                    self._max_restarts)
                try:
                    if self._mark_failed is not None:
                        self._mark_failed()
                except Exception as e:  # noqa: BLE001 - best effort
                    logging.warning(
                        'could not mark worker %s failed on the coord '
                        'service: %s: %s', self.address,
                        type(e).__name__, e)
            else:
                logging.error(
                    'Worker %s exited with code %s; aborting chief',
                    self.address, code)
            self._on_give_up(code)
            return

    def join(self, timeout=None):
        if self._thread is not None:
            self._thread.join(timeout)

    def terminate(self):
        with self._spawn_lock:
            if self.proc is not None and self.proc.poll() is None:
                self.proc.terminate()


def autoscale_policy(step_time_target_s=None, queue_depth_max=None,
                     grow_by=1):
    """The built-in autoscale policy: grow when the observed per-step
    wall time exceeds ``step_time_target_s`` or the input queue depth
    exceeds ``queue_depth_max`` (either signal suffices; unset signals
    are ignored). Returns a policy callable
    ``policy(metrics, current_world) -> desired world | None`` for
    :class:`AutoscaleController` — ``None`` means "no opinion, keep
    the current size".

    The policy may assume: ``metrics`` is a plain dict sampled by the
    caller (``step_time_s``, ``queue_depth`` — both optional), and the
    returned size is a TARGET the controller clamps and executes. It
    may NOT assume its decision is applied (``AUTODIST_MAX_WORKERS``
    caps it, scale-down is recorded-but-unsupported) or that admitted
    capacity arrives synchronously (a joiner takes an admit handshake
    plus its first step to contribute).
    """
    def policy(metrics, current_world):
        step_s = metrics.get('step_time_s')
        depth = metrics.get('queue_depth')
        if step_time_target_s is not None and step_s is not None \
                and step_s > step_time_target_s:
            return current_world + grow_by
        if queue_depth_max is not None and depth is not None \
                and depth > queue_depth_max:
            return current_world + grow_by
        return None
    return policy


class AutoscaleController:
    """The injectable autoscale policy hook (elastic scale-up's
    decision layer): each :meth:`tick` samples caller-provided metrics,
    asks the ``policy`` for a desired world size, clamps it to
    ``AUTODIST_MAX_WORKERS`` and executes growth through the injected
    ``scale_up`` callable (a launcher's, or a ``ServingFleet``'s
    ``scale_up``). Every decision — taken, skipped, capped or
    failed — is recorded on :attr:`decisions` so
    ``profiling.health_report`` can audit the autoscaler alongside the
    recovery machinery.

    Scale-DOWN is recorded as skipped, not executed: membership only
    grows (the world counter is monotone); shrinking rides the
    exclude-policy path when a worker actually leaves.
    """

    def __init__(self, policy, scale_up, current_world,
                 max_workers=None, live_world=None,
                 metrics_source=None):
        self._policy = policy
        self._scale_up = scale_up
        self.world = current_world
        self._max = max_workers if max_workers is not None \
            else ENV.AUTODIST_MAX_WORKERS.val
        # optional zero-arg callable returning live membership: each
        # tick resyncs from it, so deaths hand their headroom back —
        # a local-only world at the cap would otherwise skip forever
        # after churn, and a launched-but-refused joiner would count
        # as phantom capacity permanently
        self._live_world = live_world
        # optional zero-arg callable returning sampled metrics merged
        # under each tick's explicit metrics (explicit wins), e.g. a
        # ServingFleet's metrics
        self._metrics_source = metrics_source
        self.decisions = []

    @property
    def taken(self):
        return sum(1 for d in self.decisions
                   if d['action'] == 'scale_up')

    @property
    def skipped(self):
        """Deliberate skips only — a FAILED scale-up is an
        infrastructure error, not a policy decision, and the audit
        trail must not launder one into the other."""
        return sum(1 for d in self.decisions
                   if d['action'] == 'skipped')

    @property
    def failed(self):
        return sum(1 for d in self.decisions
                   if d['action'] == 'failed')

    def tick(self, metrics=None):
        """One autoscale evaluation; returns the decision record.
        ``metrics`` (optional) overlays the ``metrics_source`` sample —
        callers can still force a signal for a single tick."""
        explicit = dict(metrics or {})
        metrics = {}
        if self._metrics_source is not None:
            try:
                metrics = dict(self._metrics_source() or {})
            except Exception as e:  # noqa: BLE001 - the sampled
                # signal is advisory; a monitor hiccup must not kill
                # the autoscale loop
                logging.warning('autoscale metrics_source failed: '
                                '%s: %s', type(e).__name__, e)
        metrics.update(explicit)
        if self._live_world is not None:
            try:
                live = self._live_world()
                if live:
                    self.world = live
            except Exception as e:  # noqa: BLE001 - resync is advisory
                logging.warning('autoscale live-world resync failed: '
                                '%s: %s', type(e).__name__, e)
        desired = self._policy(metrics, self.world)
        rec = {'world': self.world, 'metrics': metrics,
               'desired': desired}
        if desired is None or desired == self.world:
            rec.update(action='skipped',
                       reason='no_opinion' if desired is None
                       else 'at_target')
        elif desired < self.world:
            rec.update(action='skipped',
                       reason='scale_down_unsupported')
        else:
            granted = min(desired, self._max)
            if granted <= self.world:
                rec.update(action='skipped',
                           reason='AUTODIST_MAX_WORKERS')
            else:
                try:
                    asked = granted - self.world
                    got = self._scale_up(asked)
                    # believe what was actually LAUNCHED, not what was
                    # asked: a launcher's scale_up may clamp against
                    # its own live-membership room (possibly to zero)
                    # and returns the supervisors it started — advancing
                    # `world` past reality would make the controller
                    # see phantom capacity and never fire again.
                    # Contract: scale_up returns the launched
                    # supervisors (list) or a count; a bare-None
                    # return (a void callable) is trusted as fully
                    # launched — pair such a callable with live_world
                    # so reality resyncs each tick.
                    launched = len(got) if isinstance(
                        got, (list, tuple)) else (
                        got if isinstance(got, int) else asked)
                    if launched <= 0:
                        rec.update(action='skipped',
                                   reason='scale_up_launched_nothing')
                    else:
                        self.world += launched
                        rec.update(action='scale_up',
                                   granted=self.world,
                                   launched=launched)
                except Exception as e:  # noqa: BLE001 - recorded, the
                    # autoscaler advising must not kill the run
                    rec.update(action='failed',
                               error='%s: %s' % (type(e).__name__, e))
                    logging.warning('autoscale scale_up to %d failed: '
                                    '%s', granted, rec['error'])
        self.decisions.append(rec)
        from autodist_tpu_torch.telemetry import core as _core, flight as _flight
        if rec['action'] != 'skipped':
            # only decisions that DID something (or failed trying)
            # enter the bounded crash ring — a per-step no-op tick
            # would otherwise scroll the post-mortem window the
            # flight recorder exists to preserve
            _flight.recorder().record(
                'autoscale', action=rec['action'],
                reason=rec.get('reason', ''), world=rec['world'],
                desired=desired)
        _core.get().count('autoscale/%s' % rec['action'])
        if rec['action'] == 'scale_up':
            logging.info('autoscale: world %d -> %d (%s)',
                         rec['world'], rec['granted'], metrics)
        return rec


# AUTODIST_COORD_TOKEN is deliberately NOT in _FORWARDED_FLAGS: env
# assignments ride the remote ssh command line, which is world-readable
# in `ps` on the worker host. The secret ships as a mode-0600 file
# instead (_copy_token), referenced via AUTODIST_COORD_TOKEN_FILE.


class Coordinator:
    """Launch the current program on every worker host and babysit it
    (JAX ``coordinator.py:453-842``)."""

    def __init__(self, strategy, resource_spec, cluster=None):
        self._strategy = strategy
        self._resource_spec = resource_spec
        self._cluster = cluster
        self._shutting_down = False
        self.supervisors = []
        self._token_path = ''

    def _worker_env(self, worker_addr, process_id):
        env = {
            ENV.AUTODIST_WORKER.name: worker_addr,
            ENV.AUTODIST_STRATEGY_ID.name: self._strategy.id,
            ENV.AUTODIST_PROCESS_ID.name: str(process_id),
            ENV.AUTODIST_NUM_PROCESSES.name:
                str(launch_world(self._resource_spec)),
            # where torch.distributed forms a lock-step run's group
            ENV.AUTODIST_COORDINATOR_ADDR.name:
                ENV.AUTODIST_COORDINATOR_ADDR.val or
                ('%s:%d' % (self._resource_spec.chief,
                            DEFAULT_JAX_COORD_PORT)),
            ENV.AUTODIST_COORD_SERVICE_ADDR.name:
                ENV.AUTODIST_COORD_SERVICE_ADDR.val or
                ('%s:%d' % (self._resource_spec.chief,
                            DEFAULT_COORD_PORT)),
        }
        for flag in _FORWARDED_FLAGS:
            raw = os.environ.get(flag.name)
            if raw:
                env[flag.name] = raw
        if self._token_path:
            env[ENV.AUTODIST_COORD_TOKEN_FILE.name] = self._token_path
        return env

    def _ssh_base(self, ssh_config, scp=False):
        cmd = ['scp' if scp else 'ssh', '-o',
               'StrictHostKeyChecking=no']
        if ssh_config and ssh_config.key_file:
            cmd += ['-i', ssh_config.key_file]
        if ssh_config and ssh_config.port != 22:
            cmd += ['-P' if scp else '-p', str(ssh_config.port)]
        return cmd

    @staticmethod
    def _target(address, ssh_config):
        return address if not (ssh_config and ssh_config.username) \
            else '%s@%s' % (ssh_config.username, address)

    @staticmethod
    def _run_remote(cmd, what, timeout_s=60.0, retries=1,
                    retry_wait_s=1.0):
        """Run one ssh/scp shipping command with a timeout and a single
        retried attempt: a transient SSH hiccup (dropped handshake,
        momentary DNS stall) must not abort the whole multi-host
        launch, and a wedged transfer must not hang it forever."""
        for attempt in range(retries + 1):
            try:
                subprocess.run(cmd, check=True, timeout=timeout_s)
                return
            except (subprocess.SubprocessError, OSError) as e:
                if attempt >= retries:
                    raise
                logging.warning('%s failed (%s: %s); retrying in %.0fs',
                                what, type(e).__name__, e, retry_wait_s)
                time.sleep(retry_wait_s)

    def _ship(self, src, address, ssh_config, what, remote_prefix=''):
        """scp ``src`` to a temporary name on ``address``, then rename it
        over ``src`` there (``remote_prefix`` runs first on the temporary
        name): atomic placement, and safe when chief and worker share a
        filesystem (scp'ing a file onto its own path truncates it before
        reading)."""
        tmp = '%s.ship.%d' % (src, os.getpid())
        target = self._target(address, ssh_config)
        scp_cmd = self._ssh_base(ssh_config, scp=True) + \
            [src, '%s:%s' % (target, tmp)]
        mv_cmd = self._ssh_base(ssh_config) + \
            [target, '%smv -f %s %s' % (remote_prefix, shlex.quote(tmp),
                                        shlex.quote(src))]
        if ENV.AUTODIST_DEBUG_REMOTE.val:
            logging.info('[debug-remote] %s', ' '.join(scp_cmd))
            logging.info('[debug-remote] %s', ' '.join(mv_cmd))
            return
        self._run_remote(scp_cmd, '%s scp to %s' % (what, address))
        self._run_remote(mv_cmd, '%s rename on %s' % (what, address))

    def _copy_strategy(self, address, ssh_config):
        """Ship the serialized strategy file to a worker host (reference
        coordinator.py:56-64 SFTP copy)."""
        self._ship(self._strategy.path, address, ssh_config, 'strategy')

    def _copy_token(self, address, ssh_config):
        """Ship the coord-service shared secret to a worker host as a
        mode-0600 file (env assignments ride the remote command line,
        world-readable in `ps`, so the secret goes by file)."""
        from autodist_tpu_torch.runtime.coord_client import coord_token
        token = coord_token()
        if not token:
            self._token_path = ''
            return
        path = os.path.join(os.path.dirname(self._strategy.path),
                            'coord_token')
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, 'w') as f:
            f.write(token)
        self._token_path = path
        tmp = '%s.ship.%d' % (path, os.getpid())
        self._ship(path, address, ssh_config, 'coord token',
                   remote_prefix='chmod 600 %s && ' % shlex.quote(tmp))

    @property
    def procs(self):
        """Live worker processes (the current incarnation under each
        supervisor: restarts swap the entries in place)."""
        return [s.proc for s in self.supervisors if s.proc is not None]

    def _coord_service_targets(self):
        """Every service holding fence counters: the coord service plus
        each PS endpoint (each keeps its own counter map, so a fence
        bump must land on all of them). Local spellings are normalized
        ('localhost' and friends -> 127.0.0.1) before the dedup: one
        service named two ways would otherwise get a double generation
        bump per death, skewing its counter ahead of the generation the
        replacement reads from the coord service."""
        from autodist_tpu_torch.runtime.cluster import is_local_address
        from autodist_tpu_torch.runtime.coord_client import ps_endpoints
        addr = ENV.AUTODIST_COORD_SERVICE_ADDR.val or \
            '%s:%d' % (self._resource_spec.chief, DEFAULT_COORD_PORT)
        host, port = addr.rsplit(':', 1)

        def norm(h, p):
            return ('127.0.0.1' if is_local_address(h) else h, int(p))

        targets = [norm(host, port)]
        for h, p in ps_endpoints():
            ep = norm(h, p)
            if ep not in targets:
                targets.append(ep)
        return targets

    def _fence_worker(self, process_id):
        """Bump the dead worker's fencing generation everywhere it could
        write; its replacement reads the new generation at session init
        and joins under it. The counters live outside the run namespace,
        so the run-end purge never unfences a zombie."""
        from autodist_tpu_torch.runtime import coord_client as cc
        key = 'fence/%s/p%d' % (self._strategy.id, process_id)
        for host, port in self._coord_service_targets():
            client = cc.connect_with_retry((host, port), deadline_s=15.0)
            try:
                gen = client.incr(key, 1)
            finally:
                client.close()
        logging.info('fenced dead worker p%d at generation %d',
                     process_id, gen)

    def _mark_worker_failed(self, process_id):
        """Record permanent failure (restart budget exhausted) so peers
        blocked on the staleness gate stop waiting and raise."""
        from autodist_tpu_torch.runtime import coord_client as cc
        host, port = self._coord_service_targets()[0]
        client = cc.connect_with_retry((host, port), deadline_s=15.0)
        try:
            client.set('%s/failed/p%d' % (self._strategy.id,
                                          process_id), '1')
        finally:
            client.close()

    @staticmethod
    def _abort_chief(code):
        os._exit(1)

    def _effective_policy(self):
        """The peer-failure policy workers are supervised under.
        ``exclude``/``restart`` recovery lives in the loose PS plane
        (heartbeats, the staleness gate, fenced rejoin); a lock-step run
        has none of it (survivors would block in a collective forever),
        so a strategy that is not loose keeps the fail-fast guarantee."""
        policy = ENV.AUTODIST_PEER_FAILURE_POLICY.val
        if policy == 'fail':
            return policy
        from autodist_tpu_torch.autodist import AutoDist
        if AutoDist._strategy_is_loose(self._strategy):
            return policy
        logging.warning(
            'AUTODIST_PEER_FAILURE_POLICY=%s only applies to relaxed-'
            'consistency (loose-mode) PS strategies; this strategy '
            'runs lock-step, where a lost worker cannot be excluded or '
            'rejoined — supervising workers under the fail policy '
            'instead', policy)
        return 'fail'

    def _launch_supervised(self, address, pid, policy, extra_env=None):
        """Ship prerequisites to ``address`` and start ONE worker
        process there (process id ``pid``) under a policy-aware
        :class:`WorkerSupervisor`. Returns the supervisor (None in
        debug-remote mode)."""
        script = ' '.join(shlex.quote(a) for a in
                          [sys.executable] + sys.argv)
        max_restarts = ENV.AUTODIST_MAX_WORKER_RESTARTS.val
        ssh_config = self._resource_spec.ssh_config(address)
        self._copy_strategy(address, ssh_config)
        self._copy_token(address, ssh_config)
        env = self._worker_env(address, pid)
        if extra_env:
            env.update(extra_env)
        env_str = ' '.join('%s=%s' % (k, shlex.quote(v))
                           for k, v in env.items())
        venv = ''
        if ssh_config and ssh_config.python_venv:
            venv = '. %s/bin/activate && ' % ssh_config.python_venv
        remote_cmd = 'cd %s && %s%s %s' % (
            shlex.quote(os.getcwd()), venv, env_str, script)
        cmd = self._ssh_base(ssh_config) + \
            [self._target(address, ssh_config), remote_cmd]
        if ENV.AUTODIST_DEBUG_REMOTE.val:
            logging.info('[debug-remote] %s', ' '.join(cmd))
            return None

        def spawn(cmd=cmd, address=address):
            logging.info('Launching worker on %s', address)
            return subprocess.Popen(cmd)

        sup = WorkerSupervisor(
            address, spawn, policy=policy,
            max_restarts=max_restarts,
            fence=lambda pid=pid: self._fence_worker(pid),
            mark_failed=lambda pid=pid: self._mark_worker_failed(pid),
            on_give_up=self._abort_chief,
            is_shutting_down=lambda: self._shutting_down).start()
        self.supervisors.append(sup)
        from autodist_tpu_torch.telemetry import flight as _flight
        _flight.recorder().record(
            'worker_launch', worker='p%d' % pid, address=str(address),
            policy=policy,
            elastic_join=bool(extra_env and
                              ENV.AUTODIST_ELASTIC_JOIN.name
                              in extra_env))
        return sup

    def launch_clients(self):
        """Re-run ``sys.argv`` on every non-chief host, each under a
        policy-aware :class:`WorkerSupervisor`."""
        chief = self._resource_spec.chief
        workers = [n for n in self._resource_spec.nodes if n != chief]
        policy = self._effective_policy()
        for i, address in enumerate(workers, start=1):
            self._launch_supervised(address, i, policy)
        self._next_pid = len(workers) + 1
        return self

    def scale_up(self, count, addresses=None):
        """Launch ``count`` ADDITIONAL workers into the running job, the
        supervised half of elastic scale-up. Each new process carries
        ``AUTODIST_ELASTIC_JOIN=1`` and admits itself at the control
        plane (:func:`~autodist_tpu_torch.runtime.loose_session.
        admit_worker` claims its definitive slot; the env process id is
        advisory). ``addresses`` defaults to cycling the spec's nodes
        (non-chief first).

        Capped by ``AUTODIST_MAX_WORKERS`` against the live membership
        (claimed ordinals minus exclusions, read from the coord
        service); the joiner's own admit claim enforces the ceiling
        authoritatively.

        A scale-up worker is supervised under ``exclude`` semantics
        whenever recovery is enabled: the monotone world counter never
        re-issues a slot, so a rebinding restart would leave survivors
        waiting on a counter no replacement advances. ``fail`` stays
        fail-fast. Returns the new supervisors.
        """
        policy = self._effective_policy()
        if policy == 'restart':
            logging.info('scale-up workers are supervised under '
                         'exclude semantics (a dead joiner re-admits '
                         'as a fresh slot; its old slot is excluded '
                         'by the peers)')
            policy = 'exclude'
        max_workers = ENV.AUTODIST_MAX_WORKERS.val
        next_pid = getattr(self, '_next_pid',
                           len(list(self._resource_spec.nodes)))
        room = max(0, max_workers - self._live_world_estimate(next_pid))
        if count > room:
            logging.warning(
                'scale_up(%d) clamped to %d: AUTODIST_MAX_WORKERS=%d '
                'bounds the LIVE membership', count, room, max_workers)
            count = room
        if addresses is None:
            chief = self._resource_spec.chief
            nodes = list(self._resource_spec.nodes)
            pool = [n for n in nodes if n != chief] or nodes
            addresses = [pool[i % len(pool)] for i in range(count)]
        new = []
        for address in addresses[:count]:
            pid = next_pid
            next_pid += 1
            sup = self._launch_supervised(
                address, pid, policy,
                extra_env={ENV.AUTODIST_ELASTIC_JOIN.name: '1'})
            if sup is not None:
                new.append(sup)
        self._next_pid = next_pid
        return new

    def _live_world_estimate(self, fallback):
        """Live membership (claimed ordinals minus excluded) read from
        the coord service, so exclusions hand their cap headroom back;
        the issued-pid count when the service is unreachable."""
        from autodist_tpu_torch.runtime import coord_client as cc
        from autodist_tpu_torch.runtime.loose_session import \
            live_members_on_plane
        try:
            host, port = self._coord_service_targets()[0]
            client = cc.CoordClient((host, port), timeout=2.0)
            try:
                live, world, _ = live_members_on_plane(
                    client, self._strategy.id)
                return live if world > 0 else fallback
            finally:
                client.close()
        except OSError:
            return fallback

    def autoscaler(self, policy, metrics_source=None):
        """An :class:`AutoscaleController` wired to this coordinator:
        its decisions execute through :meth:`scale_up`, starting from
        the worker ordinals already issued. Pass the chief session's
        ``monitor.metrics`` as ``metrics_source`` so the built-in
        ``step_time_target_s`` policy runs on the cohort's measured
        step time."""
        fallback = getattr(self, '_next_pid',
                           len(list(self._resource_spec.nodes)))
        return AutoscaleController(
            policy, self.scale_up, current_world=fallback,
            live_world=lambda: self._live_world_estimate(
                getattr(self, '_next_pid', fallback)),
            metrics_source=metrics_source)

    def join(self):
        for s in self.supervisors:
            s.join()

    def terminate(self):
        self._shutting_down = True
        for s in self.supervisors:
            s.terminate()


def launch_cli(argv=None):
    """``python -m autodist_tpu_torch.launch [--spec r.yml] script.py
    args...``

    Starts one process per node of the resource spec (locally through
    subprocess, remotely through ssh) with the identity env set and a
    fresh ``AUTODIST_RUN_ID``: the same-program-everywhere model, where
    :class:`Coordinator` covers the reference's chief-re-runs-your-script
    model. The launcher owns the coord service and the local PS endpoint
    services: they must outlive every process (a fast chief may finish
    while slow workers still push). Returns the first nonzero exit code,
    else 0.
    """
    import argparse
    import uuid
    parser = argparse.ArgumentParser(prog='autodist_tpu_torch.launch')
    parser.add_argument('--spec', help='resource spec YAML',
                        default=ENV.SYS_RESOURCE_PATH.val or None)
    parser.add_argument('--coordinator-port', type=int,
                        default=DEFAULT_JAX_COORD_PORT)
    parser.add_argument('script')
    parser.add_argument('args', nargs=argparse.REMAINDER)
    ns = parser.parse_args(argv)

    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.runtime import coord_client
    from autodist_tpu_torch.runtime.cluster import is_local_address
    spec = ResourceSpec(resource_file=ns.spec) if ns.spec else None
    nodes = list(spec.nodes) if spec else ['localhost']
    chief = spec.chief if spec else 'localhost'
    nodes = [chief] + [n for n in nodes if n != chief]
    coord = '%s:%d' % (chief, ns.coordinator_port)
    coord_service = ENV.AUTODIST_COORD_SERVICE_ADDR.val or \
        '%s:%d' % (chief, DEFAULT_COORD_PORT)

    os.makedirs(DEFAULT_WORKING_DIR, exist_ok=True)
    service_procs = []
    cs_host, cs_port = coord_service.rsplit(':', 1)
    all_local = all(is_local_address(n) for n in nodes)
    bind = '127.0.0.1' if all_local else '0.0.0.0'
    if is_local_address(cs_host):
        service_procs.append(coord_client.ensure_service(int(cs_port),
                                                         bind=bind))
        if all_local:
            # bound to loopback: children connect through loopback, even
            # when the spec names this host by its NIC address
            coord_service = '127.0.0.1:%s' % cs_port
        for ep_host, ep_port in coord_client.ps_endpoints():
            if is_local_address(ep_host):
                service_procs.append(coord_client.ensure_service(
                    ep_port, bind=bind))
    run_id = uuid.uuid4().hex[:12]
    procs = []
    for i, address in enumerate(nodes):
        env = dict(os.environ)
        env.update({
            ENV.AUTODIST_PROCESS_ID.name: str(i),
            ENV.AUTODIST_NUM_PROCESSES.name: str(len(nodes)),
            ENV.AUTODIST_COORDINATOR_ADDR.name: coord,
            ENV.AUTODIST_COORD_SERVICE_ADDR.name: coord_service,
            ENV.AUTODIST_RUN_ID.name: run_id,
        })
        if i > 0:
            env[ENV.AUTODIST_WORKER.name] = address
        cmd = [sys.executable, ns.script] + ns.args
        if is_local_address(address):
            procs.append(subprocess.Popen(cmd, env=env))
            continue
        ssh_config = spec.ssh_config(address) if spec else None
        env_str = ' '.join('%s=%s' % (k, shlex.quote(v))
                           for k, v in env.items()
                           if k.startswith('AUTODIST_'))
        remote = 'cd %s && %s %s' % (shlex.quote(os.getcwd()), env_str,
                                     ' '.join(shlex.quote(a) for a in cmd))
        ssh_cmd = ['ssh', '-o', 'StrictHostKeyChecking=no']
        if ssh_config and ssh_config.key_file:
            ssh_cmd += ['-i', ssh_config.key_file]
        target = address if not (ssh_config and ssh_config.username) \
            else '%s@%s' % (ssh_config.username, address)
        ssh_cmd += [target, remote]
        if ENV.AUTODIST_DEBUG_REMOTE.val:
            logging.info('[debug-remote] %s', ' '.join(ssh_cmd))
            continue
        procs.append(subprocess.Popen(ssh_cmd, env=env))
    rc = 0
    try:
        for p in procs:
            rc = p.wait() or rc
    finally:
        for sp in service_procs:
            if sp is not None:
                sp.terminate()
                sp.wait()
    return rc
