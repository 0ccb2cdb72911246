"""Worker supervision and the autoscale decision layer of the loose PS
plane: :class:`WorkerSupervisor`, :func:`autoscale_policy` and
:class:`AutoscaleController` (the counterpart of
``autodist_tpu/runtime/coordinator.py:117-452``). Every side effect —
spawning a worker, fencing a dead one's generation, marking it failed,
growing the cohort — is a callable the launcher injects; the JAX
package's ``Coordinator`` (the ssh launch and its ``scale_up``) is not
ported yet (ROADMAP.md Queue 1).
"""
import threading
import time

from autodist_tpu_torch.const import ENV
from autodist_tpu_torch.utils import logging


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
    injectable: the port's launchers (``chip_smoke.py``,
    ``tests/torch_loose_worlds.py``) pass a ``spawn`` that starts a
    fresh interpreter (a CUDA context does not survive ``fork``).
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
                    from autodist_tpu_torch.telemetry import core as _core, flight as _flight
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
