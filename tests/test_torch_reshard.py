"""The port's resharding (``autodist_tpu_torch/parallel/reshard.py``)
against ``tests/test_reshard.py``'s JAX module on the same plans.

The planning half is the JAX arithmetic: on the layouts of
``tests/test_reshard.py`` at 2, 4 and 8 replicas, ``plan_reshard`` picks
the same kind and wire bytes for every variable, and the same cost
estimate to 1e-12 (relative). The moves run on gloo worlds of 2 and 4
processes: rank r's tensors under layout B equal, bit for bit, device
r's shard of the JAX ``apply_reshard`` result on as many CPU devices,
and the round trip A -> B -> A returns every rank's tensors bit for bit
(optimizer slots riding the same op included). Every move is a data
movement, so there is no tolerance.
"""
import numpy as np
import pytest

import torch_reshard_cases as cases
from torch_dsl_worlds import run_group

LAYOUTS = [('main', cases.A_CFG, cases.B_CFG),
           ('padded', cases.PAD_A, cases.PAD_B)]


def _jax_plans(n, cfg_a, cfg_b):
    import jax
    from jax.sharding import Mesh

    from autodist_tpu.const import AXIS_DATA
    from autodist_tpu.parallel.plan import ExecutionPlan
    from test_reshard import make_gi, make_strategy
    mesh = Mesh(np.asarray(jax.devices()[:n]), (AXIS_DATA,))
    gi = make_gi()
    return (ExecutionPlan(make_strategy(cfg_a), gi, mesh),
            ExecutionPlan(make_strategy(cfg_b), gi, mesh))


def _jax_b_shards(n, cfg_a, cfg_b, seed=0):
    """Per device, each variable's physical array under B after the JAX
    package's apply_reshard of the same seeded values."""
    import jax
    import jax.numpy as jnp

    from autodist_tpu.parallel import reshard
    pa, pb = _jax_plans(n, cfg_a, cfg_b)
    host = cases.host_values(seed)
    arrays = {k: jax.device_put(pa.pad_host(k, jnp.asarray(v)),
                                pa.var_sharding(k))
              for k, v in host.items()}
    b_arrays, _, _ = reshard.apply_reshard(pa, pb, arrays)
    out = [dict() for _ in range(n)]
    for k, arr in b_arrays.items():
        shards = sorted(arr.addressable_shards, key=lambda s: s.device.id)
        for d, shard in enumerate(shards):
            out[d][k] = np.asarray(shard.data)
    return out


@pytest.mark.parametrize('n', [2, 4, 8])
@pytest.mark.parametrize('layout', LAYOUTS, ids=[l[0] for l in LAYOUTS])
def test_plan_reshard_matches_jax(n, layout):
    from autodist_tpu.parallel import reshard as jreshard
    from autodist_tpu_torch.parallel import reshard
    _, cfg_a, cfg_b = layout
    for a, b in ((cfg_a, cfg_b), (cfg_b, cfg_a)):
        # each package lists the variables in its own graph order
        ops = sorted(reshard.plan_reshard(*cases.make_plans(n, 0, a, b)),
                     key=lambda o: o.var_name)
        jops = sorted(jreshard.plan_reshard(*_jax_plans(n, a, b)),
                      key=lambda o: o.var_name)
        assert [(o.var_name, o.kind, o.src, o.dst, o.wire_bytes)
                for o in ops] == \
            [(o.var_name, o.kind, o.src, o.dst, o.wire_bytes)
             for o in jops]
        np.testing.assert_allclose([o.est_time_s for o in ops],
                                   [o.est_time_s for o in jops],
                                   rtol=1e-12)
        assert reshard.summarize(ops)['kinds'] == \
            jreshard.summarize(jops)['kinds']


def test_plan_reshard_picks_expected_collectives():
    """tests/test_reshard.py's table at 8 replicas, and the padded axis
    change taking gather_scatter."""
    from autodist_tpu_torch.parallel import reshard
    ops = {o.var_name: o for o in reshard.plan_reshard(
        *cases.make_plans(8, 0, cases.A_CFG, cases.B_CFG))}
    assert {k: o.kind for k, o in ops.items()} == {
        'w': 'all_to_all', 'u': 'all_gather', 'b': 'shard', 's': 'noop'}
    assert ops['s'].wire_bytes == 0 and ops['b'].wire_bytes == 0
    assert ops['w'].wire_bytes > 0 and ops['w'].est_time_s > 0
    kinds = {o.var_name: o.kind for o in reshard.plan_reshard(
        *cases.make_plans(8, 0, cases.PAD_A, cases.PAD_B))}
    assert kinds['u'] == 'gather_scatter'


def test_mismatched_groups_refused():
    from autodist_tpu_torch.parallel import reshard
    pa, _ = cases.make_plans(2, 0, cases.A_CFG, cases.B_CFG)
    _, pb = cases.make_plans(4, 0, cases.A_CFG, cases.B_CFG)
    with pytest.raises(ValueError, match='one replica group'):
        reshard.apply_reshard(pa, pb, {})


@pytest.fixture(scope='module', params=[2, 4])
def gloo(request):
    world = request.param
    got = run_group(world, [
        (name, 'torch_reshard_cases:roundtrip',
         {'cfg_a': a, 'cfg_b': b, 'seed': 0, 'slots': True})
        for name, a, b in LAYOUTS])
    return world, got


@pytest.mark.parametrize('layout', LAYOUTS, ids=[l[0] for l in LAYOUTS])
def test_apply_reshard_on_gloo_equals_jax(gloo, layout):
    world, got = gloo
    name, cfg_a, cfg_b = layout
    want = _jax_b_shards(world, cfg_a, cfg_b)
    for rank, rec in enumerate(got[name]):
        for k, arr in rec['b'].items():
            np.testing.assert_array_equal(arr, want[rank][k].reshape(
                arr.shape), err_msg='%s rank %d' % (k, rank))
            assert arr.shape == want[rank][k].shape, (k, rank)


@pytest.mark.parametrize('layout', LAYOUTS, ids=[l[0] for l in LAYOUTS])
def test_roundtrip_on_gloo_is_bit_identical(gloo, layout):
    world, got = gloo
    name = layout[0]
    for rec in got[name]:
        assert rec['back_equal'] and rec['slots_equal']
        for k, arr in rec['b'].items():
            np.testing.assert_array_equal(arr, rec['want_b'][k])
    kinds = set(got[name][0]['kinds'])
    if name == 'main':
        assert {'all_to_all', 'all_gather', 'shard', 'noop'} <= kinds
    else:
        # 30 rows split evenly over 2 ranks; over 4 they pad to 32
        assert kinds == ({'gather_scatter'} if world == 4
                         else {'all_to_all'}) | {'noop'}
