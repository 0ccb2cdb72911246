"""The port's cohort monitor against the JAX package's
(``autodist_tpu/telemetry/monitor.py``), and the loose session's
telemetry half.

**Parity.** Every case of ``tests/test_monitor.py``'s verdict,
recalibration and autoscale sections runs the same synthetic cohort
(span records built by one helper) through a JAX ``CohortMonitor`` and
a port one, each with a fresh flight recorder of its own package: the
verdicts, the monitor's transition audit, the flight events (their
wall-clock fields ``t`` and ``wall`` dropped) and ``snapshot()`` must be
equal, and the port's side must also meet the JAX test's own
expectations. The refit link constants are held to 1e-9 relative
(both fit with numpy's least squares on the same samples; they agree to
the last bits, the bound allows for a different BLAS order).

**Session.** A loose pair on the CPU with ``AUTODIST_TELEMETRY`` on: the
chief's ``health_stats['perf']`` has both workers' rolling stats and its
exported Chrome trace both workers' rows with the four phase spans; the
twins of ``test_back_to_back_sessions_do_not_replay_stale_batches`` and
``test_chief_init_clears_stale_telemetry_namespace``; and the re-rank's
audit entry reads ``'measured'`` with the monitor's constants.
"""
import json
import math
import threading
import types

import numpy as np
import pytest

from autodist_tpu.telemetry import flight as jflight
from autodist_tpu.telemetry import monitor as jmon
from autodist_tpu_torch.telemetry import flight as pflight
from autodist_tpu_torch.telemetry import monitor as pmon
from autodist_tpu_torch.utils.loose_harness import start_service, stop_service

FIT_REL = 1e-9


def _pkg(name):
    if name == 'jax':
        from autodist_tpu.runtime import coordinator as co
        from autodist_tpu.simulator import cost_model as cm
        return types.SimpleNamespace(mon=jmon, flight=jflight, co=co, cm=cm)
    from autodist_tpu_torch.runtime import coordinator as co
    from autodist_tpu_torch.simulator import cost_model as cm
    return types.SimpleNamespace(mon=pmon, flight=pflight, co=co, cm=cm)


def _step_records(worker, steps, wall, gate=0.001, pull=0.0,
                  push=0.002, start=1, t0=1000.0):
    """``tests/test_monitor.py``'s helper: span records for ``worker``
    over ``steps`` consecutive steps; wall/gate/pull/push may be
    callables of the step id."""
    out = []

    def val(v, st):
        return v(st) if callable(v) else v
    for st in range(start, start + steps):
        for name, v in (('step', wall), ('staleness_gate', gate),
                        ('pull_vars', pull), ('push_deltas', push)):
            d = val(v, st)
            if d <= 0:
                continue
            out.append({'name': name, 't0': t0 + st, 'dur': d,
                        'tags': {'step': st, 'worker': worker},
                        'worker': worker})
    return out


def _events(flight):
    return [{k: v for k, v in e.items() if k not in ('t', 'wall')}
            for e in flight.events()]


def _state(mon, flight, verdicts=None):
    return {'verdicts': verdicts, 'audit': [dict(e) for e in mon.events],
            'flight': _events(flight), 'snapshot': mon.snapshot()}


# -- the cohorts of tests/test_monitor.py:83-457 ------------------------------
def case_culprit_push(p):
    fl = p.flight.FlightRecorder()
    mon = p.mon.CohortMonitor(policy='advise', warmup_steps=1,
                              confirmations=1, flight=fl)
    mon.ingest(_step_records('p0', 10, wall=0.010))
    mon.ingest(_step_records('p1', 10, wall=lambda st: 0.010
                             if st < 5 else 0.060,
                             push=lambda st: 0.002 if st < 5 else 0.052))
    out = {'issued': _state(mon, fl, mon.update_verdicts())}
    mon.ingest(_step_records('p1', 8, wall=0.010, start=11))
    mon.ingest(_step_records('p0', 8, wall=0.010, start=11))
    out['recovered'] = _state(mon, fl, mon.update_verdicts())
    warn = p.mon.CohortMonitor(policy='warn', warmup_steps=1,
                               confirmations=1, flight=fl)
    warn.ingest(_step_records('p0', 8, wall=0.010))
    warn.ingest(_step_records('p1', 8, wall=0.060, push=0.052))
    out['warn'] = _state(warn, fl, warn.update_verdicts())
    return out


def check_culprit_push(out):
    (v,) = out['issued']['verdicts']
    assert v['worker'] == 'p1' and v['statistic'] == 'work'
    assert v['attributed_phase'] == 'push'
    assert v['classification'] == 'link_or_host'
    assert v['exclude_candidate'] is True and \
        v['phase_shares']['push'] > 0.8
    assert out['recovered']['verdicts'] == []
    assert [e['kind'] for e in out['recovered']['audit']] == \
        ['slowdown', 'recovered']
    (w,) = out['warn']['verdicts']
    assert w['exclude_candidate'] is False


def case_warmup(p):
    fl = p.flight.FlightRecorder()
    mon = p.mon.CohortMonitor(policy='warn', warmup_steps=3,
                              confirmations=1, flight=fl)
    mon.ingest(_step_records('p0', 10, wall=0.010))
    mon.ingest(_step_records('p1', 10, wall=lambda st: 2.0 if st <= 3
                             else 0.010))
    return dict(_state(mon, fl, mon.update_verdicts()),
                samples=mon.worker_stats()['p1']['samples'])


def check_warmup(out):
    assert out['verdicts'] == [] and out['samples'] == 7


def case_single_worker(p):
    fl = p.flight.FlightRecorder()
    mon = p.mon.CohortMonitor(policy='advise', warmup_steps=0,
                              confirmations=1, flight=fl)
    mon.ingest(_step_records('p0', 12, wall=lambda st: 0.010 * st))
    return _state(mon, fl, mon.update_verdicts())


def check_single_worker(out):
    assert out['verdicts'] == [] and out['audit'] == []


def case_policy_off(p):
    fl = p.flight.FlightRecorder()
    mon = p.mon.CohortMonitor(policy='off', warmup_steps=1,
                              confirmations=1, flight=fl)
    mon.ingest(_step_records('p0', 8, wall=0.010))
    mon.ingest(_step_records('p1', 8, wall=0.060, push=0.052))
    return dict(_state(mon, fl, mon.update_verdicts()),
                metrics=mon.metrics())


def check_policy_off(out):
    assert out['verdicts'] == [] and out['flight'] == []
    assert out['metrics']['step_time_s'] > 0


def case_victim_needs_culprit(p):
    fast = dict(wall=0.006, gate=0.001, push=0.001)
    waiting = dict(wall=0.060, gate=0.055, push=0.001)
    out = {}
    for name, culprit in (('alone', False), ('with_culprit', True)):
        fl = p.flight.FlightRecorder()
        mon = p.mon.CohortMonitor(policy='advise', warmup_steps=0,
                                  confirmations=1, flight=fl)
        mon.ingest(_step_records('p0', 8, **fast))
        mon.ingest(_step_records('p1', 8, **waiting))
        mon.ingest(_step_records('p3', 8, **fast))
        if culprit:
            mon.ingest(_step_records('p2', 8, wall=0.060, gate=0.001,
                                     push=0.052))
        out[name] = _state(mon, fl, mon.update_verdicts())
    return out


def check_victim_needs_culprit(out):
    assert out['alone']['verdicts'] == []
    by = {v['worker']: v for v in out['with_culprit']['verdicts']}
    assert by['p2']['classification'] == 'link_or_host'
    assert by['p2']['exclude_candidate'] is True
    assert by['p1']['classification'] == 'upstream_victim'
    assert by['p1']['exclude_candidate'] is False
    assert by['p1']['attributed_phase'] == 'gate'


def case_hysteresis(p):
    fl = p.flight.FlightRecorder()
    mon = p.mon.CohortMonitor(policy='warn', warmup_steps=0,
                              confirmations=2, flight=fl)
    rounds = []
    mon.ingest(_step_records('p0', 8, wall=0.010))
    mon.ingest(_step_records('p1', 8, wall=0.060, push=0.052))
    rounds.append(_state(mon, fl, mon.update_verdicts()))
    mon.ingest(_step_records('p1', 8, wall=0.010, start=9))
    mon.ingest(_step_records('p0', 8, wall=0.010, start=9))
    rounds.append(_state(mon, fl, mon.update_verdicts()))
    mon.ingest(_step_records('p1', 6, wall=0.060, push=0.052, start=17))
    mon.ingest(_step_records('p0', 6, wall=0.010, start=17))
    rounds.append(_state(mon, fl, mon.update_verdicts()))
    mon.ingest(_step_records('p1', 2, wall=0.060, push=0.052, start=23))
    mon.ingest(_step_records('p0', 2, wall=0.010, start=23))
    rounds.append(_state(mon, fl, mon.update_verdicts()))
    return rounds


def check_hysteresis(rounds):
    assert [len(r['verdicts']) for r in rounds] == [0, 0, 0, 1]
    assert [e['kind'] for e in rounds[-1]['audit']] == ['slowdown']


def case_reset(p):
    fl = p.flight.FlightRecorder()
    mon = p.mon.CohortMonitor(policy='warn', warmup_steps=0,
                              confirmations=1, flight=fl)
    mon.ingest(_step_records('p0', 8, wall=0.010))
    mon.ingest(_step_records('p1', 8, wall=0.060, push=0.052))
    before = _state(mon, fl, mon.update_verdicts())
    mon.reset_baselines()
    return {'before': before,
            'after': dict(_state(mon, fl, mon.verdicts()),
                          stats=mon.worker_stats())}


def check_reset(out):
    assert out['before']['verdicts']
    assert out['after']['verdicts'] == [] and out['after']['stats'] == {}


def _slow_link_samples(mon, n=16):
    """A slow link: about 0.5 GB/s with 10 us setup, distinct sizes."""
    for i in range(n):
        nbytes = 4096 * (1 + i % 4)
        mon.add_link_sample(nbytes, 1e-5 + nbytes * 2e-9)


def case_recalibration(p):
    fl = p.flight.FlightRecorder()
    analytic = p.cm.CostModelParams(beta_ici_s_per_byte=1e-12)
    mon = p.mon.CohortMonitor(policy='warn', flight=fl)
    _slow_link_samples(mon)
    measured = mon.recalibrate(analytic, num_replicas=8, cross_node=False,
                               step=40)
    dcn = p.mon.CohortMonitor(policy='warn', flight=fl)
    _slow_link_samples(dcn)
    dcn_params = dcn.recalibrate(analytic, num_replicas=4,
                                 cross_node=True, step=8)
    snap = mon.snapshot()
    return {'fit': (measured.alpha_ici_s, measured.beta_ici_s_per_byte,
                    dcn_params.alpha_dcn_s, dcn_params.beta_dcn_s_per_byte),
            'calibrated': (measured.calibrated, dcn_params.calibrated),
            'recalibrations': snap.pop('recalibrations') +
            dcn.snapshot()['recalibrations'],
            'snapshot': snap, 'kept': mon.calibrated_params() is measured}


def check_recalibration(out):
    assert out['calibrated'] == (True, True) and out['kept']
    assert out['fit'][1] > 100 * 1e-12
    assert out['recalibrations'][0]['tier'] == 'ICI'
    assert out['recalibrations'][1]['tier'] == 'DCN'


def case_degrades(p):
    fl = p.flight.FlightRecorder()
    mon = p.mon.CohortMonitor(policy='warn', flight=fl)
    base = p.cm.CostModelParams()
    mon.add_link_sample(4096, 1e-4)
    few = mon.recalibrate(base)
    for _ in range(16):
        mon.add_link_sample(4096, 1e-4)
    same_size = mon.recalibrate(base)
    return {'few': few, 'same_size': same_size,
            'recalibrations': len(mon.recalibrations),
            'default_kept': mon.calibrated_params(default=base) is base}


def check_degrades(out):
    assert out == {'few': None, 'same_size': None, 'recalibrations': 0,
                   'default_kept': True}


def case_autoscale_source(p):
    fl = p.flight.FlightRecorder()
    mon = p.mon.CohortMonitor(policy='warn', warmup_steps=0, flight=fl)
    launched = []
    ctl = p.co.AutoscaleController(
        p.co.autoscale_policy(step_time_target_s=0.02),
        scale_up=lambda n: launched.append(n) or n,
        current_world=2, max_workers=8, metrics_source=mon.metrics)
    ticks = [ctl.tick()]
    for st in range(1, 6):
        mon.observe_step('p0', st, 0.05)
        mon.observe_step('p1', st, 0.05)
    ticks.append(ctl.tick())
    ticks.append(ctl.tick(metrics={'step_time_s': 0.001}))
    return {'ticks': ticks, 'launched': launched,
            'snapshot': mon.snapshot()}


def check_autoscale_source(out):
    assert [t['action'] for t in out['ticks']] == \
        ['skipped', 'scale_up', 'skipped']
    assert out['launched'] == [1]
    assert out['ticks'][1]['metrics']['step_time_s'] == pytest.approx(0.05)


CASES = ['culprit_push', 'warmup', 'single_worker', 'policy_off',
         'victim_needs_culprit', 'hysteresis', 'reset', 'recalibration',
         'degrades', 'autoscale_source']


def _rel_equal(a, b):
    return abs(a - b) <= FIT_REL * max(abs(a), abs(b))


@pytest.mark.parametrize('case', CASES)
def test_cohort_matches_jax(case):
    got = globals()['case_' + case](_pkg('port'))
    want = globals()['case_' + case](_pkg('jax'))
    globals()['check_' + case](got)
    if case == 'recalibration':
        for g, w in zip(got.pop('fit'), want.pop('fit')):
            assert _rel_equal(g, w), (g, w)
        for g, w in zip(got.pop('recalibrations'),
                        want.pop('recalibrations')):
            assert set(g) == set(w)
            for k in g:
                if isinstance(g[k], float):
                    assert _rel_equal(g[k], w[k]), (k, g[k], w[k])
                else:
                    assert g[k] == w[k], k
    assert json.dumps(got, sort_keys=True, default=repr) == \
        json.dumps(want, sort_keys=True, default=repr)


def test_phase_splits_and_medians_match_jax():
    recs = _step_records('p0', 6, wall=lambda st: 1.0 if st <= 2
                         else 0.010, pull=0.002, push=0.003) + \
        _step_records('p1', 6, wall=0.020, push=0.012) + \
        [{'name': 'step'}, {'name': 'rpc', 'tags': {'cmd': 'INCR'}}]
    assert pmon.phase_splits(recs) == jmon.phase_splits(recs)
    for warm in (0, 2):
        assert pmon.phase_medians(recs, warm) == \
            jmon.phase_medians(recs, warm)
    assert pmon.phase_medians(recs, 2)['p0']['steps'] == 4
    assert pmon.PHASE_OF == jmon.PHASE_OF and pmon.PHASES == jmon.PHASES


def test_format_snapshot_matches_jax():
    snaps = []
    for p in (_pkg('jax'), _pkg('port')):
        mon = p.mon.CohortMonitor(policy='advise', warmup_steps=1,
                                  confirmations=1,
                                  flight=p.flight.FlightRecorder())
        mon.ingest(_step_records('p0', 8, wall=0.010))
        mon.ingest(_step_records('p1', 8, wall=0.060, push=0.052))
        mon.update_verdicts()
        snaps.append(mon.snapshot())
    assert pmon.format_snapshot(snaps[1]) == jmon.format_snapshot(snaps[0])
    assert 'VERDICT p1' in pmon.format_snapshot(snaps[1])
    assert pmon.format_snapshot({}) == '(no monitor samples)'


# -- the re-rank prices with the monitor's constants -------------------------
def test_rerank_audit_records_measured_constants(monkeypatch):
    """Analytic constants pick plan A, the monitor's live refit plan B
    (``test_recalibration_changes_the_rerank_and_audit``), and the port
    session's re-rank audit names the constants that priced it."""
    from torch_sim_cases import make_gi, make_rs

    from autodist_tpu_torch.runtime.loose_session import LooseSession
    from autodist_tpu_torch.simulator import search
    from autodist_tpu_torch.simulator.cost_model import CostModelParams
    from autodist_tpu_torch.strategy import builders as b
    gi = make_gi({'w': (1024, 1024), 'v': (512, 512)})
    rs = make_rs(8, topology={'ici_bandwidth_gbps': 1000})
    analytic = CostModelParams.from_topology(rs.topology)
    cands = [('AllReduce(f32)', lambda: b.AllReduce(chunk_size=128)),
             ('AllReduce(int8-wire)',
              lambda: b.AllReduce(compressor='Int8RingCompressor'))]
    plan_a, _ = search.rank(gi, rs, candidates=list(cands),
                            params=analytic, num_replicas=8)
    assert plan_a[0].name == 'AllReduce(f32)'
    mon = pmon.CohortMonitor(policy='warn', flight=pflight.FlightRecorder())
    _slow_link_samples(mon)
    measured = mon.recalibrate(analytic, num_replicas=8, step=40)
    plan_b, _ = search.rank(gi, rs, candidates=list(cands),
                            params=measured, num_replicas=8)
    assert plan_b[0].name == 'AllReduce(int8-wire)'
    stub = LooseSession.__new__(LooseSession)
    stub._plan = types.SimpleNamespace(
        strategy=types.SimpleNamespace(cost={'builder': 'PS'}))
    stub._resource_spec = rs
    stub._graph_item = gi
    stub._health = {'replans': []}
    stub._flight = pflight.FlightRecorder()
    stub._monitor = None
    monkeypatch.delenv('AUTODIST_EXECUTE_REPLAN', raising=False)
    stub._replan_for_world(8)
    entry = stub._health['replans'][-1]
    assert entry.get('error') is None and \
        entry['cost_constants'] == 'analytic', entry
    assert 'cost_alpha_beta' not in entry
    stub._monitor = mon
    stub._replan_for_world(8)
    entry = stub._health['replans'][-1]
    assert entry.get('error') is None, entry
    assert entry['cost_constants'] == 'measured'
    ab = entry['cost_alpha_beta']
    assert ab['beta_s_per_byte'] == measured.beta_ici_s_per_byte
    assert ab['alpha_s'] == measured.alpha_ici_s and math.isfinite(
        ab['alpha_s'])


# -- the session's telemetry half --------------------------------------------
@pytest.fixture(scope='module')
def service():
    port, proc = start_service()
    yield port
    stop_service(port, proc)


TELEMETRY_ENV = {'AUTODIST_PEER_FAILURE_POLICY': 'fail',
                 'AUTODIST_HEARTBEAT_TIMEOUT': '0',
                 'AUTODIST_TELEMETRY': '1',
                 'AUTODIST_TELEMETRY_PUSH_EVERY': '2'}


def _single_run(port, tag, monkeypatch, tmp_path, seed_stale=False):
    """One chief alone at depth 1 (``single_process_loose_env``) beside a
    simulated peer p1 on raw clients: the JAX tests' harness. p1 pushes
    one span batch tagged ``run=tag`` and never bumps ``closed``, so the
    close quorum's purge never runs. With ``seed_stale`` a crashed
    earlier run's batch sits under this run's namespace before the
    session exists. Returns (ns, cohort records seen before close,
    stale batches left at session init)."""
    import autodist_tpu_torch as ad
    from autodist_tpu_torch import telemetry
    from autodist_tpu_torch.runtime.coord_client import CoordClient
    from autodist_tpu_torch.utils.loose_harness import \
        single_process_loose_env
    for k, v in dict(TELEMETRY_ENV,
                     AUTODIST_TELEMETRY_DIR=str(tmp_path)).items():
        monkeypatch.setenv(k, v)
    telemetry.reset()
    telemetry.reset_recorder()
    checked = threading.Event()
    with single_process_loose_env(port, depth=1):
        autodist = ad.AutoDist(
            resource_info={'nodes': [{'address': 'localhost', 'gpus': [0],
                                      'chief': True,
                                      'network_bandwidth': 100}]},
            strategy_builder=ad.PS(staleness=2), device='cpu')
        rng = np.random.RandomState(0)
        W0 = rng.randn(32, 2).astype(np.float32)
        feed = rng.randn(4, 32).astype(np.float32)
        with autodist.scope():
            x = ad.placeholder(shape=[None, 32], dtype=np.float32,
                               name='x')
            W = ad.Variable(W0, name='W')
            loss = ad.ops.reduce_mean(ad.ops.square(ad.ops.matmul(x, W)))
            train_op = ad.optimizers.SGD(0.01).minimize(loss, [W])
        # the build and the session both see two processes: the chief
        # and the simulated p1
        autodist._build()
        ns = autodist._transformed[0].id
        seeder = CoordClient(('127.0.0.1', port))
        if seed_stale:
            telemetry.push_records(seeder, ns, 'p1', [
                {'name': 'step', 't0': 1.0, 'dur': 0.01,
                 'tags': {'step': 1, 'run': 'stale'}}])
            assert seeder.incr('%s/telemetry/p1/batches' % ns, 0) == 1

        def peer():
            c = CoordClient(('127.0.0.1', port))
            try:
                gen = c.incr('fence/%s/p1' % ns, 0)
                c.fence('fence/%s/p1' % ns, gen)
                c.heartbeat('%s/p1' % ns)
                c.barrier('%s/session/init' % ns, 2, timeout_s=60.0)
                for st in range(1, 8):
                    c.publish_step('p1', st, prefix='%s/step/' % ns)
                # pushed once the chief's init purge has been read
                assert checked.wait(60.0)
                telemetry.push_records(c, ns, 'p1', [
                    {'name': 'step', 't0': 1.0, 'dur': 0.01,
                     'tags': {'step': 1, 'run': tag}}])
                c.set('done/%s/p1' % ns, '1')
                c.publish_step('p1', 1 << 30, prefix='%s/step/' % ns)
            finally:
                c.close()

        t = threading.Thread(target=peer, daemon=True)
        t.start()
        sess = autodist.create_distributed_session()
        stale_left = seeder.incr('%s/telemetry/p1/batches' % ns, 0)
        checked.set()
        for _ in range(3):
            sess.run(train_op, {x: feed})
        t.join(timeout=20.0)
        cohort = sess.cohort_telemetry()
        sess.close()
        seeder.close()
    telemetry.reset()
    return ns, cohort, stale_left


def test_back_to_back_sessions_do_not_replay_stale_batches(
        service, monkeypatch, tmp_path):
    """Batch keys and the batch counter do not survive the run's close
    even when the close quorum's purge never runs, so a second run on
    the same service sees none of the first's spans."""
    from autodist_tpu_torch.runtime.coord_client import CoordClient
    ns_a, cohort_a, _ = _single_run(service, 'A', monkeypatch, tmp_path)
    assert any((r.get('tags') or {}).get('run') == 'A' for r in cohort_a)
    c = CoordClient(('127.0.0.1', service))
    try:
        assert c.incr('%s/telemetry/p1/batches' % ns_a, 0) == 0
        assert c.vget('%s/telemetry/p1/b1' % ns_a, None) is None
    finally:
        c.close()
    _, cohort_b, _ = _single_run(service, 'B', monkeypatch, tmp_path)
    assert not any((r.get('tags') or {}).get('run') == 'A'
                   for r in cohort_b)
    assert any((r.get('tags') or {}).get('run') == 'B' for r in cohort_b)


def test_chief_init_clears_stale_telemetry_namespace(service, monkeypatch,
                                                     tmp_path):
    """A crashed earlier run's batch under this namespace is gone once
    the chief's session exists, before any push."""
    _, cohort, stale_left = _single_run(service, 'C', monkeypatch,
                                        tmp_path, seed_stale=True)
    assert stale_left == 0
    assert not any((r.get('tags') or {}).get('run') == 'stale'
                   for r in cohort)
    assert any((r.get('tags') or {}).get('run') == 'C' for r in cohort)


def test_loose_pair_perf_section_and_cohort_trace(tmp_path):
    """Two loose worker processes at depth 2 with telemetry on: the
    chief's ``health_stats['perf']`` holds both workers' rolling stats
    (phases included), its exported trace a row for each worker with
    the four phase spans, both workers pushed span bytes, and the
    telemetry namespace is empty after both closed."""
    from torch_loose_worlds import run_loose
    out = run_loose(2, [('tel', 'torch_loose_cases:telemetry_pair',
                         {'steps': 8, 'env': {
                             'AUTODIST_TELEMETRY_DIR': str(tmp_path)}})],
                    extra_env={'AUTODIST_TELEMETRY': '1',
                               'AUTODIST_TELEMETRY_PUSH_EVERY': '2',
                               'AUTODIST_PS_PIPELINE_DEPTH': '2',
                               'AUTODIST_STRAGGLER_POLICY': 'advise',
                               'AUTODIST_HEARTBEAT_TIMEOUT': '1'})['tel']
    chief, worker = out
    perf = chief['perf']
    assert set(perf['workers']) == {'p0', 'p1'}, perf
    for w in ('p0', 'p1'):
        assert perf['workers'][w]['samples'] >= 3
        assert {'gate', 'pull', 'push', 'compute'} <= \
            set(perf['workers'][w]['phases'])
    assert perf['policy'] == 'advise' and perf['polls'] >= 4
    assert perf['records_ingested'] > 0
    assert 'perf' not in worker and worker['monitor'] is None
    with open(chief['trace_path']) as f:
        trace = json.load(f)
    rows = {e['pid']: e['args']['name'] for e in trace['traceEvents']
            if e['ph'] == 'M'}
    assert sorted(rows.values()) == ['worker p0', 'worker p1']
    for pid in rows:
        spans = {e['name'] for e in trace['traceEvents']
                 if e['pid'] == pid and e['ph'] == 'X'}
        assert {'staleness_gate', 'pull_vars', 'push_deltas',
                'pipeline_wait', 'step'} <= spans, (rows[pid], spans)
    assert chief['pushed_bytes'] > 0 and worker['pushed_bytes'] > 0
    assert chief['left_after_close'] == 0
