"""The port's strategy simulator against the JAX package's
(``tests/test_simulator.py``): the golden α-β costs, ``predict``, rank
consistency, multi-node pricing, ``AutoStrategy`` (its budget pruning,
its failure when nothing fits, its cost metadata, a captured DSL graph),
the static schedule against the traced bucket layout, the calibration
fits and their degradations, ``serve_wire_cost`` and the simulate CLI
(``python -m autodist_tpu_torch.simulator``, whose ``--json`` record
equals ``tools/simulate.py``'s).

The parity cases price ``TransformerConfig.tiny``, a small ``NCF`` and
``LSTMLM(vocab=2000, dim=64, hidden=128)`` over specs of 1x1, 1x4, 1x8
and 2 nodes x 4 in both packages: the same candidate names in the same
order, predicted step time, peak bytes and collective count within 1e-9
relative, and the picked strategy's ``node_config`` serialized the same.

The measured mode runs in one gloo group of 2 processes
(``torch_dsl_worlds.run_group``): a ``Trainer.profile`` trace gives
``collective_timeline`` one row per gradient bucket (the Trainer
all-reduces its gradients as one flat bucket) and one for the loss, each
counted once a step, and ``calibrate_from_trace`` a finite, fitted α and
β.
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import autodist_tpu_torch as ad
from autodist_tpu_torch.simulator import calibrate, cost_model, search
from autodist_tpu_torch.simulator.cost_model import (CostModelParams,
                                                     collective_time,
                                                     predict, wire_bytes)
from autodist_tpu_torch.strategy import (AllReduce, AutoStrategy,
                                         PartitionedPS, Strategy)
from autodist_tpu_torch.strategy.adapter import PytreeGraphItem
from autodist_tpu_torch.utils.profiling import Collective
from torch_dsl_worlds import run_group
from torch_sim_cases import META, make_gi, make_rs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MiB = 1 << 20


# -- golden costs (the JAX tests' pinned numbers) ----------------------------
def test_collective_time_golden_ring_allreduce():
    t = collective_time('all_reduce', 4 * MiB, 8, 1e-6, 1e-11)
    assert t == pytest.approx(8.740032e-05, rel=1e-9)


def test_collective_time_golden_reduce_scatter_half():
    t = collective_time('psum_scatter', 4 * MiB, 8, 1e-6, 1e-11)
    assert t == pytest.approx(4.3700160e-05, rel=1e-9)
    assert collective_time('all_gather', 4 * MiB, 8, 1e-6, 1e-11) == t
    assert 2 * t == pytest.approx(
        collective_time('all_reduce', 4 * MiB, 8, 1e-6, 1e-11))


def test_collective_time_single_device_is_free():
    assert collective_time('all_reduce', 4 * MiB, 1, 1e-6, 1e-11) == 0.0


def test_predict_golden_single_var_allreduce():
    gi = make_gi({'w': (1024, 1024)})
    rs = make_rs(8)
    s = AllReduce().build(gi, rs)
    rep = predict(s, gi, rs, num_replicas=8, optimizer_slots=2)
    assert rep.num_collectives == 1
    assert rep.predicted_step_time_s == pytest.approx(8.740032e-05,
                                                      rel=1e-9)
    assert rep.predicted_peak_bytes == 16 * MiB
    assert rep.memory['bucket_staging_bytes'] == 0
    assert rep.schedule_verified is True
    assert rep.summary()['schedule_verified'] is True


def test_wire_bytes_compressors():
    assert wire_bytes(4096, 'float32', 'NoneCompressor') == 4096
    assert wire_bytes(4096, 'float32', 'HorovodCompressor') == 2048
    assert wire_bytes(4096, 'float32', 'Int8RingCompressor') == \
        1024 + 4 * 4
    assert wire_bytes(2048, 'bfloat16', 'HorovodCompressor') == 2048


def test_zero_sharding_prices_scatter_plus_gather():
    gi = make_gi({'w': (1024, 64)})
    rs = make_rs(8)
    rep = predict(PartitionedPS().build(gi, rs), gi, rs, num_replicas=8)
    kinds = [b['kind'] for b in rep.breakdown]
    assert 'psum_scatter' in kinds and 'all_gather' in kinds
    full = 1024 * 64 * 4
    assert rep.memory['grads_bytes'] == full // 8
    assert rep.memory['params_bytes'] == full


# -- rank consistency ---------------------------------------------------------
@pytest.mark.parametrize('kind', ['all_reduce', 'psum_scatter',
                                  'all_gather'])
def test_monotone_in_bytes(kind):
    sizes = [1 << k for k in range(8, 28, 4)]
    times = [collective_time(kind, b, 8, 1e-6, 1e-11) for b in sizes]
    assert all(t2 > t1 for t1, t2 in zip(times, times[1:]))


def test_monotone_in_link_speed():
    base = collective_time('all_reduce', 4 * MiB, 8, 1e-6, 1e-11)
    assert collective_time('all_reduce', 4 * MiB, 8, 1e-6, 1e-9) > base
    assert collective_time('all_reduce', 4 * MiB, 8, 1e-4, 1e-11) > base


def test_rank_consistency_end_to_end():
    """4x the bytes on a 10x slower link is never predicted cheaper, for
    every candidate builder."""
    gi_small = make_gi({'w': (512, 512), 'b': (512,)})
    gi_big = make_gi({'w': (1024, 1024), 'b': (1024,)})
    fast, _ = search.rank(gi_small,
                          make_rs(8, topology={'ici_bandwidth_gbps': 100}))
    slow, _ = search.rank(gi_big,
                          make_rs(8, topology={'ici_bandwidth_gbps': 10}))
    fast_by_name = {c.name: c for c in fast}
    for c in slow:
        assert c.report.predicted_step_time_s >= \
            fast_by_name[c.name].report.predicted_step_time_s, c.name


def test_multi_node_prices_dcn_link():
    gi = make_gi({'w': (1024, 1024)})
    one = predict(AllReduce().build(gi, make_rs(8)), gi, make_rs(8),
                  num_replicas=8)
    rs2 = make_rs(8, nodes=2)
    two = predict(AllReduce().build(gi, rs2), gi, rs2, num_replicas=8)
    assert two.cross_node and not one.cross_node
    assert two.predicted_step_time_s > one.predicted_step_time_s


# -- AutoStrategy -------------------------------------------------------------
def test_auto_strategy_picks_and_annotates():
    gi = make_gi({'w': (256, 256), 'b': (256,)})
    builder = AutoStrategy()
    s = builder.build(gi, make_rs(8))
    assert s.cost['rank'] == 0 and s.cost['predicted_step_time_s'] > 0
    assert builder.last_ranked[0].strategy is s
    times = [c.report.predicted_step_time_s for c in builder.last_ranked]
    assert times == sorted(times)


def test_auto_strategy_never_exceeds_memory_budget():
    gi = make_gi({'emb': (4096, 64), 'w1': (64, 256), 'w2': (256, 64)})
    rs = make_rs(8)
    all_ranked, _ = search.rank(gi, rs)
    peaks = sorted(c.report.predicted_peak_bytes for c in all_ranked)
    for budget in [peaks[-1], (peaks[0] + peaks[-1]) // 2, peaks[0]]:
        builder = AutoStrategy(memory_budget_bytes=budget)
        s = builder.build(gi, rs)
        assert s.cost['predicted_peak_bytes'] <= budget
        for cand in builder.last_ranked:
            assert cand.report.predicted_peak_bytes <= budget


def test_auto_strategy_raises_when_nothing_fits():
    gi = make_gi({'w': (1024, 1024)})
    with pytest.raises(ValueError, match='memory'):
        AutoStrategy(memory_budget_bytes=1024).build(gi, make_rs(8))


def test_cost_metadata_serialization_roundtrip():
    gi = make_gi({'w': (256, 256)})
    rs = make_rs(8)
    s = AutoStrategy().build(gi, rs)
    assert Strategy.from_dict(s.to_dict()).cost == s.cost
    plain = AllReduce().build(gi, rs)
    assert plain.cost is None and 'cost' not in plain.to_dict()


def _captured_graph(pkg):
    """The JAX test's session-path graph (scalar + sparse vars) in
    ``pkg`` (either package's DSL)."""
    from importlib import import_module
    fe = import_module(pkg.__name__ + '.frontend.graph')
    gi = import_module(pkg.__name__ + '.graph_item').GraphItem(
        graph=fe.Graph())
    with gi.graph:
        w = pkg.Variable(np.zeros((12, 4), np.float32), name='w')
        emb = pkg.Variable(np.zeros((10, 4), np.float32), name='emb')
        s = pkg.Variable(0.5, name='s')
        x = pkg.placeholder(shape=[None], dtype=np.int32, name='x')
        looked = pkg.ops.embedding_lookup(emb, x)
        loss = pkg.ops.reduce_mean(
            pkg.ops.square(looked @ w.read().T)) + s
        pkg.optimizers.SGD(0.1).minimize(loss, [w, emb, s])
    gi.prepare()
    return gi


def test_auto_strategy_on_captured_graph():
    """The tenth builder speaks the GraphItem protocol of the other
    nine: a captured DSL graph builds, annotates, and picks what the JAX
    package picks with the same prediction."""
    import autodist_tpu as jad
    from autodist_tpu.resource_spec import ResourceSpec as JaxSpec
    from autodist_tpu.strategy import AutoStrategy as JaxAuto
    strategy = AutoStrategy().build(_captured_graph(ad),
                                    make_rs(4, device='gpus'))
    assert strategy.cost['predicted_step_time_s'] > 0
    assert len(strategy.node_config) == 3
    want = JaxAuto().build(_captured_graph(jad),
                           make_rs(4, device='gpus', cls=JaxSpec))
    assert strategy.cost['builder'] == want.cost['builder']
    assert strategy.cost['predicted_step_time_s'] == pytest.approx(
        want.cost['predicted_step_time_s'], rel=1e-9)


# -- parity of the ranking with the JAX package -------------------------------
SPECS = {'1x1': (1, 1), '1x4': (4, 1), '1x8': (8, 1), '2x4': (8, 2)}


def _models(which):
    """(the port's model on the meta device, the JAX package's model)."""
    if which == 'tinylm':
        from autodist_tpu.models.transformer import (
            TransformerConfig as JCfg, TransformerLM as JLM)
        from autodist_tpu_torch.models.transformer import (TransformerConfig,
                                                           TransformerLM)
        return (TransformerLM(TransformerConfig.tiny(dtype=torch.float32),
                              device=META),
                JLM(JCfg.tiny(dtype=jnp.float32)))
    if which == 'ncf':
        from autodist_tpu.models.ncf import NCF as JNCF
        kw = dict(mf_dim=16, mlp_dims=(64, 32, 16))
        return ad.NCF(1000, 500, device=META, **kw), JNCF(1000, 500, **kw)
    from autodist_tpu.models.rnn import LSTMLM as JLSTM
    kw = dict(vocab=2000, dim=64, hidden=128)
    return ad.LSTMLM(device=META, **kw), JLSTM(**kw)


@pytest.fixture(scope='module')
def ranked_pairs():
    """{(model, spec): (port (feasible, infeasible), JAX (feasible,
    infeasible))} over the three models and four specs."""
    from autodist_tpu.resource_spec import ResourceSpec as JaxSpec
    from autodist_tpu.simulator import search as jsearch
    from autodist_tpu.strategy.adapter import PytreeGraphItem as JaxGI
    out = {}
    for which in ('tinylm', 'ncf', 'lstm'):
        port_model, jax_model = _models(which)
        gi, jgi = PytreeGraphItem(port_model), JaxGI(jax_model)
        for name, (n, nodes) in SPECS.items():
            out[which, name] = (
                search.rank(gi, make_rs(n, 'gpus', nodes=nodes)),
                jsearch.rank(jgi, make_rs(n, 'gpus', nodes=nodes,
                                          cls=JaxSpec)))
    return out


@pytest.mark.parametrize('which', ['tinylm', 'ncf', 'lstm'])
@pytest.mark.parametrize('spec', list(SPECS))
def test_rank_matches_jax(ranked_pairs, which, spec):
    (feasible, infeasible), (jfeasible, jinfeasible) = \
        ranked_pairs[which, spec]
    assert [c.name for c in feasible] == [c.name for c in jfeasible]
    assert [c.name for c in infeasible] == [c.name for c in jinfeasible]
    assert len(feasible) >= 9
    for c, j in zip(feasible, jfeasible):
        for key in ('predicted_step_time_s', 'predicted_peak_bytes',
                    'num_collectives'):
            got, want = getattr(c.report, key), getattr(j.report, key)
            assert got == pytest.approx(want, rel=1e-9, abs=1e-15), \
                (c.name, key)
        assert c.report.schedule_verified == j.report.schedule_verified
    assert feasible[0].strategy.to_dict()['node_config'] == \
        jfeasible[0].strategy.to_dict()['node_config']


# -- static schedule against the traced bucket layout -------------------------
@pytest.fixture(scope='module')
def world2(tmp_path_factory):
    return run_group(2, [
        ('svt', 'torch_sim_cases:static_vs_traced', {}),
        ('profile', 'torch_sim_cases:trainer_profile',
         {'trace_dir': str(tmp_path_factory.mktemp('traces'))}),
    ])


def test_static_schedule_matches_traced_bucket_layout(world2):
    for static, traced in world2['svt']:
        assert static == traced
        assert len(static) == 3


# -- calibration --------------------------------------------------------------
def _row(kind, nbytes, seconds, count=3, ranks=None):
    return (Collective(kind, nbytes, 'float', ranks), seconds * count * 1e9,
            count)


def _jax_row(kind, nbytes, seconds, count=3):
    return ('%%%s.1 = f32[%d]{0} %s(f32[%d]{0} %%p), replica_groups={}'
            % (kind, nbytes // 4, kind, nbytes // 4),
            seconds * count * 1e9, count)


def test_calibration_recovers_alpha_beta():
    alpha, beta = 5e-6, 4e-11
    rows = [_row('all-reduce', b, collective_time('all_reduce', b, 8, alpha,
                                                  beta))
            for b in (1 << 16, 1 << 20, 1 << 24)]
    params = calibrate.calibrate_from_timeline(CostModelParams(), rows, 8)
    assert params.calibrated
    assert params.alpha_ici_s == pytest.approx(alpha, rel=1e-3)
    assert params.beta_ici_s_per_byte == pytest.approx(beta, rel=1e-3)


def test_calibration_is_kind_aware_and_matches_jax():
    """Reduce-scatter + all-gather rows recover the all-reduce constants
    (each kind through its own cost shape), and the port's fit of
    descriptor rows equals the JAX package's fit of the same rows as HLO
    text; rows of a kind the cost shapes do not know are dropped."""
    from autodist_tpu.simulator import calibrate as jcal
    from autodist_tpu.simulator.cost_model import \
        CostModelParams as JaxParams
    alpha, beta = 5e-6, 4e-11
    rows, jrows = [], []
    for nbytes in (1 << 16, 1 << 20, 1 << 24):
        for kind, skind in (('reduce-scatter', 'psum_scatter'),
                            ('all-gather', 'all_gather')):
            t = collective_time(skind, nbytes, 8, alpha, beta)
            rows.append(_row(kind, nbytes, t))
            jrows.append(_jax_row(kind, nbytes, t))
    rows.append((Collective('broadcast', 999, 'float', None), 5.0, 3))
    params = calibrate.calibrate_from_timeline(CostModelParams(), rows, 8)
    want = jcal.calibrate_from_timeline(JaxParams(), jrows, 8)
    assert params.calibrated and want.calibrated
    assert params.alpha_ici_s == pytest.approx(alpha, rel=1e-3)
    assert params.beta_ici_s_per_byte == pytest.approx(beta, rel=1e-3)
    assert params.alpha_ici_s == pytest.approx(want.alpha_ici_s, rel=1e-9)
    assert params.beta_ici_s_per_byte == pytest.approx(
        want.beta_ici_s_per_byte, rel=1e-9)


def test_calibration_degrades_on_empty_timeline():
    base = CostModelParams()
    out = calibrate.calibrate_from_timeline(base, [], 8)
    assert out is base and not out.calibrated
    out = calibrate.calibrate_from_timeline(
        base, [_row('all-reduce', 4096, 1e-5)], 8)
    assert out is base


def test_calibration_from_missing_trace_dir(tmp_path):
    base = CostModelParams()
    assert calibrate.calibrate_from_trace(base, str(tmp_path), 8) is base


def test_trainer_profile_timeline_and_calibration(world2):
    """Both ranks' traces of 3 steps, in one directory: one row for the
    gradients (the Trainer all-reduces them as one flat bucket, over the
    default group) and one for the loss, each counted once a step, each
    row's time the least over the ranks (so both ranks read the same
    rows). The fit is held on what does not depend on the host's clock:
    the traced rows, timed by a known α and β, give that α and β back;
    the fit of the measured times is either a finite α >= 0 with a
    positive β, or, where a loaded CPU timed the 4-byte all-reduce
    slower than the gradients' (a non-positive β), the analytic
    constants kept. The fit of measured NCCL times is
    ``tests/test_torch_simulator_cuda.py``'s."""
    assert world2['profile'][0] == world2['profile'][1]
    base = CostModelParams()
    for rows, grad_bytes, (fitted, alpha, beta) in world2['profile']:
        assert sorted((kind, nbytes, ranks, count)
                      for kind, nbytes, ranks, _, count in rows) == \
            [('all-reduce', 4, None, 3), ('all-reduce', grad_bytes, None, 3)]
        assert all(ns > 0 for *_, ns, _ in rows)
        want_alpha, want_beta = 5e-6, 4e-11
        timed = [_row(kind, nbytes,
                      collective_time('all_reduce', nbytes, 2, want_alpha,
                                      want_beta), count=count, ranks=ranks)
                 for kind, nbytes, ranks, _, count in rows]
        params = calibrate.calibrate_from_timeline(base, timed, 2)
        assert params.calibrated
        assert params.alpha_ici_s == pytest.approx(want_alpha, rel=1e-3)
        assert params.beta_ici_s_per_byte == pytest.approx(want_beta,
                                                           rel=1e-3)
        if fitted:
            assert math.isfinite(alpha) and alpha >= 0
            assert math.isfinite(beta) and beta > 0
        else:
            assert (alpha, beta) == (base.alpha_ici_s,
                                     base.beta_ici_s_per_byte)


# -- the simulate CLI ---------------------------------------------------------
def _cli(*args, jax_tool=False):
    cmd = [sys.executable, os.path.join(REPO, 'tools', 'simulate.py')] \
        if jax_tool else [sys.executable, '-m', 'autodist_tpu_torch.simulator']
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    out = subprocess.run(cmd + list(args), capture_output=True, text=True,
                         timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_simulate_cli_smoke_equals_the_jax_tool():
    rec = json.loads(_cli('--model', 'tinylm', '--json')
                     .strip().splitlines()[-1])
    cands = [c for c in rec['candidates'] if c.get('feasible')]
    assert len(cands) >= 9
    times = [c['predicted_step_time_s'] for c in cands]
    assert times == sorted(times)
    assert all(c['predicted_peak_bytes'] > 0 for c in cands)
    want = json.loads(_cli('--model', 'tinylm', '--json', jax_tool=True)
                      .strip().splitlines()[-1])
    assert rec == want


def test_simulate_cli_table_and_budget():
    assert 'pruned' in _cli('--model', 'tinylm', '--budget-gb', '0.000001')


def test_simulate_cli_serving_block():
    rec = json.loads(_cli('--model', 'tinylm', '--json', '--serve-replicas',
                          '2', '--serve-qps', '100', '--serve-wire', 'bf16')
                     .strip().splitlines()[-1])
    srv = rec['serving']
    assert srv['replicas'] == 2 and srv['wire'] == 'bf16'
    assert 0 < srv['dcn_link_frac'] < 1
    assert srv['serve_bytes_per_s'] >= srv['snapshot_bytes_per_s']


# -- serving-tier wire model --------------------------------------------------
def test_serve_wire_cost_scales_and_casts():
    from autodist_tpu.simulator.cost_model import \
        serve_wire_cost as jax_serve
    serve = cost_model.serve_wire_cost
    dense = 100 << 20
    one = serve(dense, replicas=1, poll_hz=2.0)
    four = serve(dense, replicas=4, poll_hz=2.0)
    assert four['snapshot_bytes_per_s'] == pytest.approx(
        4 * one['snapshot_bytes_per_s'])
    assert one['snapshot_wire_bytes'] == dense
    assert one['dcn_link_frac'] > 0
    hot = serve(dense, qps=100.0, rows_per_query=64, row_bytes=256,
                row_cache_hit_rate=1.0)
    cold = serve(dense, qps=100.0, rows_per_query=64, row_bytes=256,
                 row_cache_hit_rate=0.0)
    assert hot['row_bytes_per_s'] == 0.0
    assert cold['row_bytes_per_s'] == pytest.approx(100 * 64 * 256)
    i8 = serve(dense, compressor='Int8RingCompressor')
    assert dense / 4 <= i8['snapshot_wire_bytes'] < dense / 3.8
    assert i8 == jax_serve(dense, compressor='Int8RingCompressor')
    assert cold == jax_serve(dense, qps=100.0, rows_per_query=64,
                             row_bytes=256, row_cache_hit_rate=0.0)
