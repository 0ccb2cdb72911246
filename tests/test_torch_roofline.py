"""The port's roofline observatory against the JAX package's
(``tests/test_roofline.py``): the peak table (with the H100 row), the
FLOP and byte count of a step callable (``cost_of``), the regime
classification and the tracker, the memory drift join, schedule entry
ids, the per-entry drift table — equal to the JAX table on equal
schedules and timelines — and the entry-labeled calibration fit.

``cost_of`` of a stack of Linear products counts exactly 2mnk FLOPs a
product, the figure the JAX package's ``cost_analysis`` gives the same
``jnp.dot`` chain; flash attention on the CPU runs its plain version,
whose products the counter sees once, and no kernel work is added.
"""
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from autodist_tpu_torch.resource_spec import PEAKS_BY_KIND, ResourceSpec
from autodist_tpu_torch.telemetry import roofline as rl
from autodist_tpu_torch.utils.profiling import Collective


def _spec(topology=None, gpus=8, cls=ResourceSpec):
    info = {'nodes': [{'address': 'localhost', 'chief': True,
                       'cpus': [0], 'gpus': list(range(gpus)),
                       'network_bandwidth': 100}]}
    if topology is not None:
        info['topology'] = topology
    return cls(resource_info=info)


# -- the peak table -----------------------------------------------------------
def test_h100_device_name_resolves_to_the_h100_row():
    """The card's own name, as ``torch.cuda.get_device_name()`` gives it,
    selects NVIDIA's published H100 SXM figures: 989 TFLOP/s dense bf16,
    3.35 TB/s, and NVLink 4's 450 GB/s a direction."""
    topo = _spec({'device_kind': 'NVIDIA H100 80GB HBM3'}).topology
    assert topo.peaks() == (989e12, 3.35e12)
    assert PEAKS_BY_KIND['h100'] == (989e12, 3350.0)
    bw, lat = topo.link(cross_node=False)
    assert bw == 450e9 and lat == pytest.approx(3e-6)
    # the generic row stays for other cards
    assert _spec({'device_kind': 'gpu'}).topology.peaks() == \
        (125e12, 900e9)


def test_topology_peak_defaults_per_kind():
    topo = _spec({'device_kind': 'v5e'}).topology
    assert topo.peak_flops == PEAKS_BY_KIND['v5e'][0]
    assert topo.peaks() == (PEAKS_BY_KIND['v5e'][0],
                            PEAKS_BY_KIND['v5e'][1] * 1e9)


def test_topology_cpu_kind_resolves_to_none_peaks():
    assert _spec({'device_kind': 'cpu'}).topology.peaks() == (None, None)


def test_topology_explicit_peaks_override_table():
    topo = _spec({'device_kind': 'h100', 'peak_flops': 1e14,
                  'peak_hbm_gbps': 500}).topology
    assert topo.peak_flops == 1e14 and topo.peak_hbm_gbps == 500.0


def test_topology_rejects_bad_peaks_and_kinds():
    with pytest.raises(ValueError, match='peak_flops'):
        _spec({'peak_flops': 0})
    with pytest.raises(ValueError, match='peak_hbm_gbps'):
        _spec({'peak_hbm_gbps': -3})
    with pytest.raises(ValueError, match='peak_flops'):
        _spec({'peak_flops': float('nan')})
    with pytest.raises(ValueError, match='device_kind'):
        _spec({'device_kind': 'abacus9000'})


def test_env_peak_override_wins(monkeypatch):
    monkeypatch.setenv('AUTODIST_ROOFLINE_PEAKS',
                       'flops=2e14,hbm_gbps=1000')
    assert _spec({'device_kind': 'h100'}).topology.peaks() == (2e14, 1e12)


# -- cost_of ------------------------------------------------------------------
def test_cost_of_linear_stack_is_2mnk_and_equals_jax():
    rng = np.random.RandomState(0)
    m, dims = 4, (16, 32, 8, 24)
    ws = [rng.randn(a, b).astype('f4') for a, b in zip(dims, dims[1:])]
    x = rng.randn(m, dims[0]).astype('f4')
    tws = [torch.from_numpy(w) for w in ws]

    def stack(h):
        for w in tws:
            h = h @ w
        return h
    cost = rl.cost_of(stack, torch.from_numpy(x))
    want = sum(2 * m * a * b for a, b in zip(dims, dims[1:]))
    assert cost['flops'] == want
    assert cost['kernel_launches'] == 0
    # each product's operands read once and its result written once
    assert cost['bytes_accessed'] == 4 * sum(
        m * a + a * b + m * b for a, b in zip(dims, dims[1:]))

    def jstack(h, *w):
        for wi in w:
            h = jnp.dot(h, wi)
        return h
    lowered = jax.jit(jstack).lower(x, *ws)
    jcost = lowered.cost_analysis()
    if isinstance(jcost, (list, tuple)):
        jcost = jcost[0]
    assert cost['flops'] == jcost['flops']


def test_cost_of_is_cached_per_callable():
    calls = []

    def step(x):
        calls.append(1)
        return x @ x
    x = torch.ones(8, 8)
    a = rl.cost_of(step, x)
    b = rl.cost_of(step, x)
    assert a == b and len(calls) == 1
    assert a['flops'] == 2 * 8 ** 3


def test_cost_of_caches_a_bound_method_by_its_owner():
    class Trainer:
        calls = 0

        def step(self, x):
            Trainer.calls += 1
            return x.sum()
    t = Trainer()
    rl.cost_of(t.step, torch.ones(4))
    rl.cost_of(t.step, torch.ones(4))   # a new bound-method object
    assert Trainer.calls == 1


def test_cost_of_follows_the_batch_shape_of_one_step_callable():
    """``Trainer.compile_step`` hands back the same bound method for every
    batch, so a cache keyed by the callable alone gave [8, 32] the cost
    of [2, 32] (4.7186e7 FLOP both times, where a cleared cache gives
    1.8874e8 at [8, 32]). Keyed on the arguments' shapes and dtypes too,
    the FLOPs follow the batch (4x, exactly: every product scales with
    the rows); a repeat at one shape still runs nothing."""
    from autodist_tpu_torch import optim
    from autodist_tpu_torch.api import Trainer
    from autodist_tpu_torch.models.transformer import (TransformerConfig,
                                                       TransformerLM)
    tr = Trainer(TransformerLM(TransformerConfig.tiny(), device='cpu'),
                 optim.sgd(0.1))
    state = tr.init(seed=0)
    rng = np.random.RandomState(0)

    def batch(b):
        return tr.shard_batch({k: rng.randint(0, 256, (b, 32),
                                              dtype=np.int32)
                               for k in ('tokens', 'targets')})
    small, large = batch(2), batch(8)
    first = rl.cost_of(tr.compile_step(state, small), state, small)
    second = rl.cost_of(tr.compile_step(state, large), state, large)
    assert first['flops'] == pytest.approx(4.7186e7, rel=1e-4)
    assert second['flops'] == pytest.approx(1.8874e8, rel=1e-4)
    assert second['flops'] == 4 * first['flops']
    steps = state.step
    again = rl.cost_of(tr.compile_step(state, large), state, large)
    assert again == second and state.step == steps


def test_cost_of_counts_cpu_attention_once():
    """On the CPU flash attention runs its plain version: the counter
    sees those products (the scores and P·V forward, their gradients in
    the backward) and no kernel reports work, so nothing is counted
    twice; the kernels' own formula is reported only by a launch."""
    from autodist_tpu_torch.kernels import flash_attention as fa
    from autodist_tpu_torch.kernels import work
    b, h, s, d = 1, 2, 64, 16
    q = torch.randn(b, h, s, d, requires_grad=True)

    def step(q):
        fa.flash_attention(q, q, q, causal=True).sum().backward()
    with work.recording() as launched:
        cost = rl.cost_of(step, q)
    assert launched['launches'] == 0 and cost['kernel_launches'] == 0
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        step(q)
    assert cost['flops'] == fc.get_total_flops()
    # the plain forward materializes the whole score matrix: 2 products
    # of 2 s^2 d each, at least
    assert cost['flops'] >= 2 * 2 * b * h * s * s * d


def test_kernel_work_reaches_every_open_counter():
    from autodist_tpu_torch.kernels import work
    shape = (4, 12, 4096, 64)
    flops, nbytes = work.attention('fwd', shape, torch.bfloat16, True)
    assert flops == 2 * 64 * 4 * 12 * (4096 * 4097 // 2) * 2
    with work.recording() as outer:
        with work.recording() as inner:
            work.record(flops, nbytes)
        work.record(1, 2)
    assert inner == {'flops': flops, 'bytes': nbytes, 'launches': 1}
    assert outer == {'flops': flops + 1, 'bytes': nbytes + 2,
                     'launches': 2}
    work.record(5, 5)   # no counter open: nothing to add to


def test_memory_of_is_none_off_cuda():
    assert rl.memory_of('cpu') is None


# -- regime classification and the tracker ------------------------------------
def test_classify_regime_cpu_is_well_formed():
    rec = rl.classify_regime(None, None, 0.1, None, None)
    assert rec['mfu'] is None and rec['mfu_null_reason']
    assert rec['roofline_regime'] is None and rec['regime_reason']
    rec = rl.classify_regime(1e9, None, 0.1, None, None)
    assert 'peak' in rec['mfu_null_reason']


def test_classify_regime_picks_dominant_bound_as_jax():
    from autodist_tpu.telemetry import roofline as jrl
    for args, kw, regime in (((9e13, 1e9, 1.0, 1e14, 1e12), {}, 'compute'),
                             ((1e12, 8e11, 1.0, 1e14, 1e12), {}, 'memory'),
                             ((1e12, 1e9, 1.0, 1e14, 1e12),
                              {'comms_s': 0.9}, 'comms')):
        rec = rl.classify_regime(*args, **kw)
        assert rec['roofline_regime'] == regime
        assert rec == jrl.classify_regime(*args, **kw)


def test_tracker_records_mfu_regression():
    from autodist_tpu_torch.telemetry.core import Telemetry

    class Flight:
        def __init__(self):
            self.events = []

        def record(self, kind, **fields):
            self.events.append(dict(fields, kind=kind))
    flight = Flight()
    tr = rl.RooflineTracker(peak_flops=1e14, peak_hbm_bps=1e12, every=1,
                            tel=Telemetry(enabled=False), flight=flight,
                            worker='p7')
    cost = {'flops': 5e13, 'bytes_accessed': 1e9}
    for s in range(1, 7):
        tr.observe_step(s, 1.0, cost=cost)
    rec = tr.observe_step(7, 4.0, cost=cost)
    assert rec['mfu'] == pytest.approx(0.125)
    assert tr.regressions == 1
    ev = [e for e in flight.events if e['kind'] == 'mfu_regression'][0]
    assert ev['worker'] == 'p7' and ev['step'] == 7
    # without a recorder of its own the regression lands in the
    # process's flight recorder
    from autodist_tpu_torch.telemetry import flight as fl
    fl.reset()
    quiet = rl.RooflineTracker(peak_flops=1e14, every=1,
                               tel=Telemetry(enabled=False))
    for s in range(1, 7):
        quiet.observe_step(s, 1.0, cost=cost)
    quiet.observe_step(7, 4.0, cost=cost)
    assert quiet.regressions == 1 and quiet.snapshot()['samples'] == 7
    ev = [e for e in fl.recorder().events()
          if e['kind'] == 'mfu_regression']
    assert len(ev) == 1 and ev[0]['step'] == 7
    fl.reset()


def test_memory_drift_classes_and_unavailable_path():
    from autodist_tpu.telemetry import roofline as jrl
    est = {'params_bytes': 100, 'grads_bytes': 50, 'optimizer_bytes': 200,
           'bucket_staging_bytes': 50, 'total_bytes': 400}
    out = rl.memory_drift(None, est)
    assert out['available'] is False and out['drift_ratio'] is None
    measured = {'argument_size_in_bytes': 330, 'temp_size_in_bytes': 80,
                'live_bytes': 410}
    out = rl.memory_drift(measured, est)
    assert out['classes']['state']['drift_ratio'] == \
        pytest.approx(330 / 300, abs=1e-3)
    assert out['classes']['transient']['drift_ratio'] == \
        pytest.approx(80 / 100, abs=1e-3)
    assert out['drift_ratio'] == pytest.approx(410 / 400, abs=1e-3)
    assert out == jrl.memory_drift(measured, est)


# -- entry ids and the drift table --------------------------------------------
def _schedules(n=8, n_vars=6, dim=64, chunk=2):
    """The static schedule of the JAX test's bucketed plan in both
    packages: (port, JAX)."""
    from autodist_tpu.parallel.plan import \
        static_collective_schedule as jax_schedule
    from autodist_tpu.resource_spec import ResourceSpec as JaxSpec
    from autodist_tpu.strategy import AllReduce as JaxAllReduce
    from autodist_tpu.strategy.adapter import (FunctionalModel,
                                               PytreeGraphItem as JaxGI)
    from autodist_tpu_torch.parallel.plan import static_collective_schedule
    from autodist_tpu_torch.strategy import AllReduce, PytreeGraphItem
    from torch_sim_cases import shapes_model
    shapes = {'v%02d' % i: (dim, dim) for i in range(n_vars)}
    gi = PytreeGraphItem(shapes_model(shapes))
    jgi = JaxGI(FunctionalModel(
        lambda rng: {k: jnp.zeros(s, jnp.float32)
                     for k, s in shapes.items()}, lambda p, b: 0.0))
    port = static_collective_schedule(
        AllReduce(chunk_size=chunk).build(gi, _spec(gpus=n)), gi, n)
    jax_s = jax_schedule(
        JaxAllReduce(chunk_size=chunk).build(jgi, _spec(gpus=n, cls=JaxSpec)),
        jgi, n)
    return port, jax_s


def _timelines(schedule, n, alpha, beta, multi_node=False):
    """Timeline rows priced at known (α, β) for every expected
    sub-collective of the schedule: (port rows, the same as JAX HLO
    rows)."""
    rows, jrows = [], []
    for i, e in enumerate(schedule):
        for hk, result_b, _tier, grp, full_b in rl.expected_subrows(
                e, n, multi_node=multi_node):
            hops = (2 if hk == 'all-reduce' else 1) * (grp - 1)
            frac = (2.0 if hk == 'all-reduce' else 1.0) * (grp - 1) / grp
            t = hops * alpha + frac * full_b * beta
            elems = max(1, result_b // 4)
            rows.append((Collective(hk, elems * 4, 'float', None), t * 1e9,
                         1))
            jrows.append(('%%x.%d = f32[%d]{0} %s(f32[%d]{0} %%p0), '
                          'replica_groups={}' % (i, elems, hk, elems),
                          t * 1e9, 1))
    return rows, jrows


def test_entry_ids_match_the_jax_schedule():
    port, jax_s = _schedules()
    assert [e['entry_id'] for e in port] == [e['entry_id'] for e in jax_s]
    assert len({e['entry_id'] for e in port}) == len(port)


def test_entry_ids_distinguish_identical_chunks():
    from autodist_tpu_torch.parallel.plan import assign_entry_ids
    entries = [{'kind': 'psum_scatter', 'dtype': 'float32',
                'compressor': None, 'bytes': 1024, 'members': ['w']}
               for _ in range(3)]
    ids = [e['entry_id'] for e in assign_entry_ids(entries)]
    assert len(set(ids)) == 3
    assert ids[1].endswith('#1') and ids[2].endswith('#2')


def test_drift_table_joins_and_equals_jax():
    from autodist_tpu.telemetry import roofline as jrl
    port, jax_s = _schedules()
    n = 8
    rows, jrows = _timelines(port, n, 2e-6, 1e-9)
    table = rl.drift_table(port, rows, n)
    assert table['unmatched_rows'] == 0
    for row in table['entries']:
        assert row['achieved_s'] is not None and row['drift_ratio'] > 0
    assert table['tiers']['ici']['achieved_bytes_per_s'] > 0
    want = jrl.drift_table(jax_s, jrows, n)
    assert table == want


def test_drift_table_degrades_on_empty_timeline():
    port, _ = _schedules()
    table = rl.drift_table(port, [], 8)
    assert all(r['achieved_s'] is None and r.get('note')
               for r in table['entries'])
    assert table['worst_drift_ratio'] is None


def _ar(nbytes, name):
    return {'kind': 'all_reduce', 'dtype': 'float32',
            'compressor': 'NoneCompressor', 'bytes': nbytes, 'vars': 1,
            'members': [name], 'phase': 'grad', 'hier': 0, 'spec': 'AUTO',
            'wus': False}


def test_partial_join_tier_aggregate_covers_matched_rows_only():
    from autodist_tpu_torch.simulator.cost_model import CostModelParams
    n = 4
    schedule = [_ar(1 << 10, 'small'), _ar(1 << 20, 'big')]
    rows = [(Collective('all-reduce', 1 << 10, 'float', None), 1e5, 1)]
    table = rl.drift_table(schedule, rows, n)
    by = {r['entry_id'].rsplit(':', 1)[1]: r for r in table['entries']}
    assert by['small+1']['achieved_s'] is not None
    assert by['big+1']['achieved_s'] is None and \
        'no matching' in by['big+1']['note']
    tier = table['tiers']['ici']
    assert tier['rows'] == 1
    moved, pred = rl._subrow_link_model('all-reduce', n, 1 << 10, 'ici',
                                        CostModelParams())
    assert tier['wire_bytes'] == int(moved)
    assert tier['predicted_bytes_per_s'] == \
        pytest.approx(moved / pred, rel=1e-6)


def test_drift_table_marks_unjoinable_kinds():
    entries = [dict(_ar(4096, 'emb'), kind='sparse_all_gather',
                    compressor=None),
               dict(_ar(4096, 'w'), compressor='Int8RingCompressor')]
    for row in rl.drift_table(entries, [], 2)['entries']:
        assert row['achieved_s'] is None and 'joinable' in row['note']


def test_hier_entry_expands_to_two_tier_subrows():
    subs = rl.expected_subrows(dict(_ar(1 << 20, 'w'), hier=2), 8,
                               multi_node=True)
    assert [s[0] for s in subs] == ['reduce-scatter', 'all-reduce',
                                    'all-gather']
    assert {s[2] for s in subs} == {'ici', 'dcn'}


def test_format_drift_table_renders():
    port, _ = _schedules()
    rows, _ = _timelines(port, 8, 2e-6, 1e-9)
    text = rl.format_drift_table(rl.drift_table(port, rows, 8))
    assert 'ICI: achieved' in text and 'worst per-entry drift' in text


# -- the calibration pin: entry-labeled beats unlabeled -----------------------
def test_entry_labeled_fit_fixes_reduce_scatter_beta():
    """Unlabeled rows carry a reduce-scatter's RESULT (the 1/n shard)
    into a cost shape priced over the full buffer, inflating β ~n-fold;
    the drift table's entry-labeled samples carry the full bytes and
    recover the true β."""
    from autodist_tpu_torch.simulator.calibrate import (
        calibrate_from_drift, calibrate_from_timeline, fit_alpha_beta,
        samples_from_timeline)
    from autodist_tpu_torch.simulator.cost_model import CostModelParams
    n = 4
    alpha, beta = 1e-6, 2e-9
    schedule = [dict(_ar(nbytes, 'w%d' % i), kind='psum_scatter',
                     compressor=None)
                for i, nbytes in enumerate((1 << 18, 1 << 20, 1 << 22))]
    rows = []
    for e in schedule:
        t = (n - 1) * alpha + (n - 1) / n * e['bytes'] * beta
        rows.append((Collective('reduce-scatter', e['bytes'] // n, 'float',
                                None), t * 1e9, 1))
    old = fit_alpha_beta(samples_from_timeline(rows), n)
    assert old[1] == pytest.approx(n * beta, rel=0.05)
    params_old = calibrate_from_timeline(CostModelParams(), rows, n)
    assert params_old.beta_ici_s_per_byte == \
        pytest.approx(n * beta, rel=0.05)
    table = rl.drift_table(schedule, rows, n)
    params_new = calibrate_from_drift(CostModelParams(), table, n)
    assert params_new.calibrated
    assert params_new.beta_ici_s_per_byte == pytest.approx(beta, rel=0.05)
    assert math.isfinite(params_new.alpha_ici_s)


# -- the silent-empty timeline ------------------------------------------------
def test_collective_timeline_logs_emitted_vs_empty_mismatch(tmp_path,
                                                            monkeypatch):
    from autodist_tpu_torch.utils import profiling
    calls = []
    monkeypatch.setattr(profiling.logging, 'warning',
                        lambda msg, *a: calls.append(msg % a))
    assert profiling.collective_timeline(str(tmp_path),
                                         expected_collectives=7) == []
    assert any('7 collective(s)' in c for c in calls), calls
    calls.clear()
    assert profiling.collective_timeline(str(tmp_path)) == []
    assert not any('collective(s)' in c for c in calls), calls


def test_calibrate_from_trace_threads_expected_count(tmp_path, monkeypatch):
    from autodist_tpu_torch.simulator import calibrate
    from autodist_tpu_torch.simulator.cost_model import CostModelParams
    from autodist_tpu_torch.utils import profiling
    seen = {}

    def fake_timeline(trace_dir, expected_collectives=0):
        seen['expected'] = expected_collectives
        return []
    monkeypatch.setattr(profiling, 'collective_timeline', fake_timeline)
    params = calibrate.calibrate_from_trace(
        CostModelParams(), str(tmp_path), 4, expected_collectives=3)
    assert seen['expected'] == 3 and not params.calibrated


def _trace(tmp_path, events, world=4, rank=0):
    import json
    path = tmp_path / ('rank%d.pt.trace.json' % rank)
    path.write_text(json.dumps({'traceEvents': events, 'distributedInfo': {
        'backend': 'nccl', 'rank': 0, 'world_size': world}}))
    return str(tmp_path)


def _nccl(name, coll, n_in, n_out, ts, dur, size=4, pg='0',
          ranks='[0, 1, 2, 3]'):
    return {'ph': 'X', 'cat': 'kernel', 'name': name, 'ts': ts, 'dur': dur,
            'args': {'Collective name': coll, 'In msg nelems': n_in,
                     'Out msg nelems': n_out, 'Group size': size,
                     'dtype': 'Float', 'Process Group Name': pg,
                     'Process Group Ranks': ranks}}


def test_collective_timeline_reads_nccl_kernels(tmp_path):
    """The device records a card's trace carries (``ncclDevKernel_*``
    with the collective's args), over two steps of one program: one row
    per collective of the step (two equal all-reduces stay two rows),
    counted once a step, result bytes as an HLO result shape counts
    them, subgroup ranks kept, host records ignored when device ones
    exist."""
    from autodist_tpu_torch.utils.profiling import (collective_timeline,
                                                    per_op_breakdown)
    ar = 'ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)'
    step = [(ar, 'allreduce', 1024, 1024, 10.0, {}),
            (ar, 'allreduce', 1024, 1024, 12.0, {}),
            ('ncclDevKernel_ReduceScatter_Sum_f32_RING_LL(x)',
             '_reduce_scatter_base', 1024, 256, 5.0, {}),
            ('ncclDevKernel_AllGather_RING_LL(x)', '_allgather_base', 256,
             1024, 6.0, {}),
            (ar, 'allreduce', 64, 64, 3.0,
             {'size': 2, 'pg': '1', 'ranks': '[0, 1]'})]
    events = []
    for s in range(2):
        for i, (name, coll, n_in, n_out, dur, kw) in enumerate(step):
            events.append(_nccl(name, coll, n_in, n_out, 100.0 * s + 10 * i,
                                dur, **kw))
    events += [
        {'ph': 'X', 'cat': 'cpu_op', 'name': 'record_param_comms', 'ts': 0.0,
         'dur': 99.0, 'args': {'Collective name': 'allreduce',
                               'In msg nelems': 1024, 'Out msg nelems': 1024,
                               'Group size': 4, 'dtype': 'Float'}},
        {'ph': 'X', 'cat': 'kernel', 'name': 'void gemm_kernel()', 'ts': 0.0,
         'dur': 40.0}]
    rows = collective_timeline(_trace(tmp_path, events))
    assert rows == [
        (Collective('all-reduce', 4096, 'float', None), 24000, 2),
        (Collective('all-reduce', 4096, 'float', None), 20000, 2),
        (Collective('all-gather', 4096, 'float', None), 12000, 2),
        (Collective('reduce-scatter', 1024, 'float', None), 10000, 2),
        (Collective('all-reduce', 256, 'float', (0, 1)), 6000, 2)]
    rep = per_op_breakdown(str(tmp_path))
    assert rep['by_category']['collective'] == 72000
    assert rep['by_category']['gemm'] == 40000


def test_collective_timeline_takes_the_rank_that_waited_least(tmp_path):
    """Each row's time is the median of its occurrences, and, over the
    ranks' traces in the directory, the least: a rank that reached a
    bucket first waited for the others inside its kernel, the last one
    did not."""
    from autodist_tpu_torch.utils.profiling import collective_timeline
    ar = 'ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)'

    def steps(first_bucket_us):
        events = []
        for s, wait in enumerate(first_bucket_us):
            events.append(_nccl(ar, 'allreduce', 512, 512, 100.0 * s,
                                wait))
            events.append(_nccl(ar, 'allreduce', 131072, 131072,
                                100.0 * s + 50, 12.0))
        return events
    # rank 0 waited in two of three steps, rank 1 never
    _trace(tmp_path, steps([180.0, 8.0, 150.0]), rank=0)
    d = _trace(tmp_path, steps([8.0, 9.0, 8.0]), rank=1)
    assert collective_timeline(d) == [
        (Collective('all-reduce', 524288, 'float', None), 36000, 3),
        (Collective('all-reduce', 2048, 'float', None), 24000, 3)]
    os.remove(os.path.join(d, 'rank1.pt.trace.json'))
    # rank 0's trace alone: the median of 180, 8 and 150 us
    assert collective_timeline(d)[0] == \
        (Collective('all-reduce', 2048, 'float', None), 450000, 3)


def test_collective_timeline_drops_one_rank_collectives(tmp_path):
    """A collective over one rank moves nothing over a link (NCCL runs no
    kernel for it; its host record says group size 1): no row, so
    calibration at one rank keeps the analytic constants."""
    from autodist_tpu_torch.simulator.calibrate import calibrate_from_trace
    from autodist_tpu_torch.simulator.cost_model import CostModelParams
    from autodist_tpu_torch.utils.profiling import collective_timeline
    rec = {'ph': 'X', 'cat': 'cpu_op', 'name': 'record_param_comms',
           'ts': 0.0, 'dur': 40.0,
           'args': {'Collective name': 'allreduce', 'In msg nelems': 1024,
                    'Out msg nelems': 1024, 'Group size': 1,
                    'dtype': 'Float', 'Process Group Name': '0',
                    'Process Group Ranks': '[0]'}}
    d = _trace(tmp_path, [rec, dict(rec, dur=50.0)], world=1)
    assert collective_timeline(d) == []
    base = CostModelParams()
    assert calibrate_from_trace(base, d, 1) is base
