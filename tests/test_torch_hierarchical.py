"""The port's two-level (hierarchical) schedules against the JAX
package's (``tests/test_hierarchical.py``, and the three-level,
``entry_program`` and ``format_program`` cases of
``tests/test_schedule_ir.py``): the two-tier cost model and the shared
per-bucket decision, node-group inference, the two-level collectives and
every two-level lowering of ``schedule_ir.execute`` against flat, the
int8 two-level all-reduce against the JAX function on the same rows, the
execution plan's emission under ``AUTODIST_HIERARCHY_NODES=2`` (static
== traced included), a DSL program that trains over it, per-tier
calibration and the Topology guard.

The world-4 cases run in one gloo group of 4 processes
(``torch_dsl_worlds.run_group``), node groups [[0, 1], [2, 3]].
Tolerances: bitwise on integer-valued inputs (every partial sum exact,
as the JAX test holds it); on random f32 rows, 1e-6 of the largest
magnitude — gloo sums the two levels in another order than the flat
ring, and the largest difference found is 2.4e-7 of 3.4 (7e-8
relative); the int8 path within the JAX test's quantization bounds, and
against the JAX function 1e-6 of the largest sum.
"""
import numpy as np
import pytest
import torch

import jax

from autodist_tpu_torch.parallel import schedule_ir as sir
from autodist_tpu_torch.parallel.mesh import ReplicaGroup, \
    data_axis_node_groups
from autodist_tpu_torch.resource_spec import ResourceSpec, Topology
from autodist_tpu_torch.simulator import calibrate, search
from autodist_tpu_torch.simulator.cost_model import (
    CostModelParams, choose_hierarchical, collective_time,
    hierarchical_time, num_node_groups, predict)
from autodist_tpu_torch.strategy import AllReduce
from autodist_tpu_torch.utils.profiling import Collective
import torch_sim_cases as cases
from torch_sim_cases import make_gi, make_rs as _make_rs
from torch_dsl_worlds import run_group

MiB = 1 << 20
REL = 1e-6


def make_rs(n=8, nodes=1):
    return _make_rs(n, 'gpus', nodes=nodes)


@pytest.fixture(scope='module')
def world4():
    env = {'AUTODIST_HIERARCHY_NODES': 2}
    return run_group(4, [
        ('coll', 'torch_sim_cases:hier_collectives', {}),
        ('plan', 'torch_sim_cases:hier_plan', {'env': dict(env)}),
        ('c0', 'torch_sim_cases:hier_c0', {'env': dict(env)}),
    ])


# -- cost model: the two-tier formula and the shared decision ----------------
def test_hierarchical_time_degenerates_to_flat():
    p = CostModelParams()
    assert hierarchical_time(4 * MiB, 8, 1, p) == pytest.approx(
        collective_time('all_reduce', 4 * MiB, 8,
                        p.alpha_ici_s, p.beta_ici_s_per_byte))
    assert hierarchical_time(4 * MiB, 1, 1, p) == 0.0


def test_hierarchical_time_golden_two_node():
    from autodist_tpu.simulator.cost_model import \
        CostModelParams as JaxParams, hierarchical_time as jax_time
    p = CostModelParams()
    B = 4 * MiB
    expect = (2 * 3 * p.alpha_ici_s +
              2 * 3 / 4 * B * p.beta_ici_s_per_byte +
              2 * 1 * p.alpha_dcn_s +
              2 * 1 / 2 * (B / 4) * p.beta_dcn_s_per_byte +
              B * p.hier_boundary_s_per_byte)
    assert hierarchical_time(B, 8, 2, p) == pytest.approx(expect,
                                                          rel=1e-12)
    assert hierarchical_time(B, 8, 2, p) == jax_time(B, 8, 2, JaxParams())


def test_choose_hierarchical_flips_on_topology():
    p = CostModelParams()
    assert choose_hierarchical(4 * MiB, 'float32', None, 8, 2, p)
    assert not choose_hierarchical(4 * MiB, 'float32', None, 8, 1, p)
    assert not choose_hierarchical(4 * MiB, 'float32', None, 8, 3, p)
    assert not choose_hierarchical(4 * MiB, 'float32', None, 8, 8, p)
    assert not choose_hierarchical(4 * MiB, 'float32', None, 8, 2, p,
                                   spec='RING')
    assert not choose_hierarchical(4 * MiB, 'float32', None, 8, 2, p,
                                   knob='never')
    assert choose_hierarchical(16, 'float32', None, 8, 2, p, knob='always')
    flat_p = CostModelParams(
        alpha_dcn_s=CostModelParams().alpha_ici_s,
        beta_dcn_s_per_byte=CostModelParams().beta_ici_s_per_byte)
    assert not choose_hierarchical(4 * MiB, 'float32', None, 8, 2, flat_p)


def test_num_node_groups_from_replica_hosts():
    gi = make_gi({'w': (64, 64)})
    s2 = AllReduce().build(gi, make_rs(8, nodes=2))
    assert num_node_groups(s2, None, 8) == 2
    assert num_node_groups(AllReduce().build(gi, make_rs(8)), None, 8) == 1
    assert num_node_groups(s2, None, 7) == 1


def test_num_node_groups_requires_equal_per_host_split():
    gi = make_gi({'w': (64, 64)})
    rs = ResourceSpec(resource_info={'nodes': [
        {'address': 'host0', 'chief': True, 'cpus': [0],
         'gpus': [0, 1, 2], 'network_bandwidth': 100},
        {'address': 'host1', 'cpus': [0], 'gpus': [0],
         'network_bandwidth': 100}]})
    assert num_node_groups(AllReduce().build(gi, rs), None, 4) == 1
    rep = predict(AllReduce(hierarchical='auto').build(gi, rs), gi, rs,
                  num_replicas=4)
    assert all(b['hier'] == 0 for b in rep.breakdown)


def test_num_node_groups_honors_forced_override(monkeypatch):
    monkeypatch.setenv('AUTODIST_HIERARCHY_NODES', '2')
    gi = make_gi({'w': (1024, 1024)})
    rs1 = make_rs(8)
    s = AllReduce().build(gi, rs1)
    assert num_node_groups(s, None, 8) == 2
    assert predict(s, gi, rs1, num_replicas=8).breakdown[0]['hier'] == 2
    monkeypatch.setenv('AUTODIST_HIERARCHY_NODES', '3')
    assert num_node_groups(s, None, 8) == 1


def test_int8_hierarchical_prices_ici_at_raw_bytes():
    base = CostModelParams()
    p = CostModelParams(alpha_ici_s=base.alpha_dcn_s,
                        beta_ici_s_per_byte=base.beta_dcn_s_per_byte / 2,
                        alpha_dcn_s=base.alpha_dcn_s,
                        beta_dcn_s_per_byte=base.beta_dcn_s_per_byte)
    B = 4 * MiB
    assert choose_hierarchical(B, 'float32', None, 8, 2, p)
    assert not choose_hierarchical(B, 'float32', 'Int8RingCompressor',
                                   8, 2, p)
    assert hierarchical_time(B // 4, 8, 2, p, ici_bytes=B) > \
        hierarchical_time(B // 4, 8, 2, p)


def test_predict_ranks_hierarchical_above_flat_ring_on_two_nodes():
    gi = make_gi({'w': (1024, 1024)})
    rs2 = make_rs(8, nodes=2)
    hier = predict(AllReduce(hierarchical='always').build(gi, rs2), gi,
                   rs2, num_replicas=8)
    flat = predict(AllReduce(all_reduce_spec='RING').build(gi, rs2), gi,
                   rs2, num_replicas=8)
    assert hier.breakdown[0]['hier'] == 2 and flat.breakdown[0]['hier'] == 0
    assert hier.predicted_step_time_s < flat.predicted_step_time_s
    rs1 = make_rs(8)
    h1 = predict(AllReduce(hierarchical='always').build(gi, rs1), gi, rs1,
                 num_replicas=8)
    f1 = predict(AllReduce().build(gi, rs1), gi, rs1, num_replicas=8)
    assert h1.breakdown[0]['hier'] == 0
    assert h1.predicted_step_time_s == pytest.approx(
        f1.predicted_step_time_s)
    names = [c.name for c in search.rank(gi, rs1)[0]]
    assert names.index('AllReduce(chunk=128)') < \
        names.index('AllReduce(hierarchical)')


def test_rank_two_nodes_hierarchical_beats_flat_control():
    gi = make_gi({'w': (1024, 1024)})
    by_name = {c.name: c.report.predicted_step_time_s
               for c in search.rank(gi, make_rs(8, nodes=2))[0]}
    assert by_name['AllReduce(hierarchical)'] < \
        by_name['AllReduce(flat-only)']
    assert by_name['AllReduce(hierarchical)'] < by_name['AllReduce(RING)']


# -- node-group inference ---------------------------------------------------
def test_data_axis_node_groups_forced_and_degenerate():
    group = ReplicaGroup(8, 0)
    assert data_axis_node_groups(group, forced_nodes=2) == \
        [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert data_axis_node_groups(group, forced_nodes=4) == \
        [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert data_axis_node_groups(group, forced_nodes=3) is None
    assert data_axis_node_groups(group, forced_nodes=8) is None
    assert data_axis_node_groups(group) is None
    assert data_axis_node_groups(group, ranks_per_node=[4, 4]) == \
        [[0, 1, 2, 3], [4, 5, 6, 7]]


# -- the two-level collectives over gloo ------------------------------------
def test_two_level_collectives_equal_flat(world4):
    """Integer rows: bitwise. Random rows: within 1e-6 of the largest
    magnitude. Every two-level lowering of ``execute`` ran (the tags
    name the lowering each program took), and a three-level program
    through the generic interpreter equals the flat mean."""
    tags = set()
    for res in world4['coll']:
        for label, (two, flat) in res.items():
            if label.startswith('int8/'):
                continue
            tags.add(label.rsplit('/', 1)[1] if '/execute/' in label
                     else None)
            assert two.shape == flat.shape, label
            if label.startswith('int/'):
                assert np.array_equal(two, flat), label
            else:
                np.testing.assert_allclose(
                    two, flat, rtol=0,
                    atol=REL * float(np.abs(flat).max()), err_msg=label)
    assert {'hier', 'hier_scatter', 'hier_gather', 'generic'} <= tags


def test_int8_two_level_matches_jax_and_the_sum(world4):
    """The port's int8 two-level all-reduce equals the JAX package's
    ``int8_hierarchical_all_reduce`` over the same four rows and node
    groups (the same quantizer, tier boundary and rings), and stays
    within the quantization bound of the exact sum; ``execute`` lowers
    the int8 two-level program to it."""
    from jax.sharding import Mesh, PartitionSpec as P
    from autodist_tpu.parallel.axes import shard_map_compat
    from autodist_tpu.parallel.compressor import \
        int8_hierarchical_all_reduce
    x = cases.rows(2, (1000,), 4)
    mesh = Mesh(np.array(jax.devices()[:4]), ('data',))
    want = np.asarray(jax.jit(shard_map_compat(
        lambda v: int8_hierarchical_all_reduce(v[0], 'data',
                                               cases.NODE_GROUPS)[None],
        mesh, P('data'), P('data')))(x))
    scale = float(np.abs(want).max())
    gmax = float(np.abs(x).max())
    for rank, res in enumerate(world4['coll']):
        got, exact = res['int8/hierarchical']
        np.testing.assert_allclose(got, want[rank], rtol=0,
                                   atol=REL * scale)
        assert float(np.abs(got - exact).max()) <= 4 * 6 * gmax / 127.0
        lowered, mean = res['int8/execute/int8_hier']
        np.testing.assert_allclose(lowered, got / 4, rtol=0,
                                   atol=REL * scale)


@pytest.mark.parametrize('dtype,compressor', [
    ('float32', 'NoneCompressor'),
    ('bfloat16', 'NoneCompressor'),
    ('float32', 'HorovodCompressor'),
])
def test_hierarchical_bit_identical_vs_flat(world4, dtype, compressor):
    """The plan's two-level emission is a re-association of the same
    sum: on integer gradients (every sum exact in bf16 too) BIT-identical
    to flat, for the plain f32 wire, a bf16 tensor dtype and the bf16
    cast wire; every bucket went two-level over [[0, 1], [2, 3]]."""
    for res in world4['plan']:
        flat, flat_dt, flat_hier, groups = \
            res['%s/%s/never' % (dtype, compressor)]
        hier, hier_dt, hier_hier, _ = \
            res['%s/%s/always' % (dtype, compressor)]
        assert groups == [[0, 1], [2, 3]]
        assert flat_hier and all(h == 0 for h in flat_hier)
        assert hier_hier and all(h == 2 for h in hier_hier)
        assert all(flat_dt) and all(hier_dt)
        for a, b in zip(flat, hier):
            assert np.array_equal(a, b)


def test_hierarchical_int8_bucket_exact_on_block_constant(world4):
    for res in world4['plan']:
        f32 = res['int8/const/f32'][0]
        flat8, hier8 = res['int8/const/flat8'], res['int8/const/hier8']
        assert all(b == (2, 'Int8RingCompressor') for b in hier8[1])
        for key in (flat8, hier8):
            for a, b in zip(f32, key[0]):
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        for a, b in zip(flat8[0], hier8[0]):
            assert np.array_equal(a, b)


def test_hierarchical_int8_within_compressor_bound(world4):
    gmax = max(float(np.abs(cases.rows(30 + i, (64, 64), 4)).max())
               for i in range(4))
    for res in world4['plan']:
        exact = res['int8/randn/f32'][0]
        errs = {}
        for key in ('flat8', 'hier8'):
            errs[key] = max(float(np.abs(a - b).max())
                            for a, b in zip(exact,
                                            res['int8/randn/' + key][0]))
            assert errs[key] <= 6 * gmax / 127.0 + 1e-6
        assert errs['hier8'] <= 4 * errs['flat8'] + 1e-6


def test_static_schedule_matches_traced_hierarchical(world4):
    for res in world4['plan']:
        static, traced = res['static_vs_traced']
        assert static == traced
        assert any(h == 2 for _, _, h in static)


def test_dsl_program_trains_over_two_levels(world4):
    """The c0 program under AllReduce(hierarchical='always') at 4
    replicas in two node groups: b after one step is the reference's,
    W agrees on every rank, and the bucket went two-level."""
    Ws = set()
    for (loss, W, b), groups, hiers in world4['c0']:
        assert abs(b - 0.01 * 4.17503) <= 1e-5
        assert groups == [[0, 1], [2, 3]]
        assert hiers and all(h == 2 for h in hiers)
        Ws.add(W)
    assert len(Ws) == 1


# -- per-tier calibration -----------------------------------------------------
def _row(nbytes, seconds, ranks, count=3):
    return (Collective('all-reduce', nbytes, 'float', ranks),
            seconds * count * 1e9, count)


def test_replica_groups_of_a_descriptor():
    assert calibrate._replica_groups(
        Collective('all-reduce', 4096, 'float', (0, 1, 2, 3))) == \
        [[0, 1, 2, 3]]
    assert calibrate._replica_groups(
        Collective('all-reduce', 4096, 'float', None)) is None


def _tier_rows(a_i, b_i, a_d, b_d):
    rows = []
    for nbytes in (1 << 16, 1 << 20, 1 << 24):
        t = collective_time('all_reduce', nbytes, 4, a_i, b_i)
        rows += [_row(nbytes, t, (0, 1, 2, 3)), _row(nbytes, t, (4, 5, 6, 7))]
        t = collective_time('all_reduce', nbytes, 2, a_d, b_d)
        rows += [_row(nbytes, t, (r, r + 4)) for r in range(4)]
    return rows


def test_calibration_fits_tiers_separately():
    a_i, b_i, a_d, b_d = 2e-6, 2e-11, 40e-6, 6e-9
    params = calibrate.calibrate_from_timeline(
        CostModelParams(), _tier_rows(a_i, b_i, a_d, b_d), 8,
        devices_per_node=4)
    assert params.calibrated
    assert params.alpha_ici_s == pytest.approx(a_i, rel=1e-3)
    assert params.beta_ici_s_per_byte == pytest.approx(b_i, rel=1e-3)
    assert params.alpha_dcn_s == pytest.approx(a_d, rel=1e-3)
    assert params.beta_dcn_s_per_byte == pytest.approx(b_d, rel=1e-3)


def test_calibration_tier_falls_back_to_shared_fit():
    base = CostModelParams()
    a_i, b_i, a_d, b_d = 2e-6, 2e-11, 40e-6, 6e-9
    dcn_rows = [r for r in _tier_rows(a_i, b_i, a_d, b_d)
                if len(r[0].ranks) == 2]
    params = calibrate.calibrate_from_timeline(
        CostModelParams(), dcn_rows, 8, devices_per_node=4)
    assert params.calibrated
    assert params.alpha_dcn_s == pytest.approx(a_d, rel=1e-3)
    assert params.alpha_ici_s == base.alpha_ici_s
    assert params.beta_ici_s_per_byte == base.beta_ici_s_per_byte
    t = collective_time('all_reduce', 1 << 20, 4, a_i, b_i)
    rows = [_row(1 << 20, t, (0, 1, 2, 3))] + dcn_rows
    ici, dcn = calibrate.tiered_samples_from_timeline(rows, 4)
    expected = calibrate.fit_alpha_beta(ici + dcn, 8)
    params = calibrate.calibrate_from_timeline(
        CostModelParams(), rows, 8, devices_per_node=4)
    assert params.alpha_ici_s == pytest.approx(expected[0], rel=1e-9)
    assert params.beta_ici_s_per_byte == pytest.approx(expected[1],
                                                       rel=1e-9)


def test_calibration_without_devices_per_node_unchanged():
    alpha, beta = 5e-6, 4e-11
    rows = [_row(b, collective_time('all_reduce', b, 8, alpha, beta), None)
            for b in (1 << 16, 1 << 20, 1 << 24)]
    params = calibrate.calibrate_from_timeline(CostModelParams(), rows, 8)
    assert params.alpha_ici_s == pytest.approx(alpha, rel=1e-3)


# -- Topology guard -----------------------------------------------------------
@pytest.mark.parametrize('field,val', [
    ('ici_bandwidth_gbps', float('nan')),
    ('dcn_bandwidth_gbps', float('nan')),
    ('ici_latency_us', float('inf')),
])
def test_topology_rejects_non_finite_resolved_values(field, val):
    with pytest.raises(ValueError, match='topology.%s' % field):
        ResourceSpec(resource_info={
            'nodes': [{'address': 'h', 'chief': True, 'cpus': [0],
                       'gpus': [0, 1], 'network_bandwidth': 100}],
            'topology': {field: val}})


def test_topology_guard_direct_construction():
    from autodist_tpu_torch.resource_spec import DeviceType
    with pytest.raises(ValueError, match='dcn_bandwidth_gbps'):
        Topology({'dcn_bandwidth_gbps': float('nan')}, DeviceType.TPU, 1,
                 multi_node=True)
    t = Topology({}, DeviceType.TPU, 1, multi_node=False)
    assert t.link(cross_node=True)[0] > 0


# -- schedule IR: three levels, entry programs, formatting --------------------
@pytest.mark.parametrize('elems', (1024, 1000, 197))
@pytest.mark.parametrize('build', [
    lambda e: sir.two_level_program(e, 'float32', (4, 4), name='two'),
    lambda e: sir.two_level_program(e, 'float32', (4, 2, 2), name='waves'),
    lambda e: sir.three_level_program(e, 'float32', 2, 2, 2, name='three'),
    lambda e: sir.three_level_program(e, 'float32', 2, 2, 2,
                                      wires=('f32', 'bf16', 'i8'),
                                      name='three-wires'),
], ids=['two-level', 'waves', 'three-level', 'three-level-wires'])
def test_partition_exactness(build, elems):
    prog = build(elems)
    assert sir.verify(prog) == []
    assert prog.elems >= elems
    for s in prog.steps:
        if s.op != 'reduce_scatter':
            continue
        for g, chs in zip(s.groups, s.chunks):
            ivs = sorted((int(lo), int(hi)) for lo, hi in chs)
            assert len(ivs) == len(g)
            assert all(a[1] == b[0] for a, b in zip(ivs, ivs[1:]))


def test_three_level_program_and_staging_equal_jax():
    from autodist_tpu.parallel import schedule_ir as jsir
    for wires in (None, ('f32', 'f32', 'i8'), ('f32', 'bf16', 'i8')):
        prog = sir.three_level_program(1000, 'float32', 2, 2, 2,
                                       wires=wires)
        want = jsir.three_level_program(1000, 'float32', 2, 2, 2,
                                        wires=wires)
        assert prog.to_dict() == want.to_dict()
        assert sir.staging_bytes(prog) == jsir.staging_bytes(want)
        assert sir.lowering_of(prog) == 'generic'
    assert sir.staging_bytes(sir.flat_program(1000, 'float32', n=8)) == 0


def test_entry_program_inverts_schedule_entry():
    from autodist_tpu.parallel import schedule_ir as jsir
    for kind, hier, comp in (('all_reduce', 0, None),
                             ('all_reduce', 2, 'Int8RingCompressor'),
                             ('psum_scatter', 2, None),
                             ('all_gather', 2, None)):
        prog = sir.bucket_program(kind, 4096, 'float32', comp, 'AUTO', 8,
                                  hier=hier)
        entry = sir.schedule_entry(prog, group=0, members=['w'])
        entry['entry_id'] = 'e0'
        back = sir.entry_program(entry, 8)
        assert back.meta['entry_id'] == 'e0'
        assert [(s.op, s.groups) for s in back.steps] == \
            [(s.op, s.groups) for s in prog.steps]
        assert back.to_dict() == jsir.entry_program(entry, 8).to_dict()
        if hier:
            assert sir.node_groups_of(back) == [[0, 1, 2, 3],
                                                [4, 5, 6, 7]]


def test_format_program_lists_steps_and_times():
    from autodist_tpu.parallel import schedule_ir as jsir
    from autodist_tpu.simulator.cost_model import \
        CostModelParams as JaxParams
    prog = sir.three_level_program(4096, 'float32', 2, 2, 2, name='t3')
    text = sir.format_program(prog, CostModelParams())
    assert text.splitlines()[0].startswith('t3: n=8')
    assert text.count('us') == 5
    assert text == jsir.format_program(
        jsir.three_level_program(4096, 'float32', 2, 2, 2, name='t3'),
        JaxParams())
    assert 'us' not in sir.format_program(prog)


def test_schedule_search_equals_jax():
    """Synthesis over an asymmetric 3-tier topology: the same candidates
    in the same order at the same predicted times as the JAX package,
    and a synthesized shape undercuts the best hand-written one."""
    from autodist_tpu.simulator import search as jsearch
    links = {'dcn': (5e-5, 2e-9)}
    topo = search.ScheduleTopo(slices=((4, 4), (4, 2)), links=links)
    feasible, _ = search.rank_schedules(64 << 20, 'float32', topo)
    want, _ = jsearch.rank_schedules(
        64 << 20, 'float32',
        jsearch.ScheduleTopo(slices=((4, 4), (4, 2)), links=links))
    assert [c.name for c in feasible] == [c.name for c in want]
    for c, w in zip(feasible, want):
        assert c.predicted_s == pytest.approx(w.predicted_s, rel=1e-12)
        assert c.tier_bytes == w.tier_bytes
        assert c.staging_bytes == w.staging_bytes
    hand, synth = search.best_schedules(feasible)
    assert synth.predicted_s < hand.predicted_s
    assert search.format_schedule_table(feasible) == \
        jsearch.format_schedule_table(want)


def test_staging_budget_prunes_wire_changing_candidates():
    feasible, pruned = search.rank_schedules(
        4 << 20, 'float32', search.ScheduleTopo(slices=((4, 4),)),
        staging_budget_bytes=1)
    assert feasible and all(c.staging_bytes == 0 for c in feasible)
    assert pruned and all('staging' in c.error for c in pruned)


def test_unequal_hosts_rank_as_synthesized_waves():
    feasible, _ = search.rank_schedules(
        1 << 20, 'float32', search.ScheduleTopo(slices=((4, 2),)))
    waves = [c for c in feasible if 'waves' in c.name]
    assert waves and all(not c.handwritten for c in waves)


def test_generic_interpreter_on_three_level_needs_uniform_groups():
    prog = sir.three_level_program(128, 'float32', 2, 1, 2)
    assert prog.n == 4 and sir.executable_generic(prog)
    wires = sir.three_level_program(128, 'float32', 2, 1, 2,
                                    wires=('f32', 'f32', 'i8'))
    assert not sir.executable_generic(wires)
    with pytest.raises(ValueError, match='not generically executable'):
        sir.execute_generic(wires, torch.zeros(128), ReplicaGroup(4, 0))
