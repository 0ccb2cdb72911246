"""Sharded training state of the port against the JAX package, on the CPU:
ZeRO 2 and 3 and the strategy-partitioned variables that
``apply_strategy_to_shardings`` lays over the data axis.

Every port case runs in one gloo group of 4 processes
(``torch_dsl_worlds.run_group``) at dp = 4, against the JAX ``Trainer``
at dp = 4 on the CPU devices ``tests/conftest.py`` sets up
(``AUTODIST_IS_TESTING`` is on there, so PartitionedPS partitions with
one PS device in both packages).

- Trainer level: ``TransformerConfig.tiny`` in f32 from the JAX init, 3
  steps on batch 8 x 32 with the uneven mask, for zero 2, zero 3 and
  ``trainer_from_strategy(PartitionedPS())`` under sgd(0.1) and under
  adam(1e-2), and PartitionedAR, UnevenPartitionedPS and
  RandomAxisPartitionAR(seed=0) under sgd(0.1). Losses within 1e-5
  relative; params within 2e-6 absolute under sgd and a tenth of the
  learning rate (1e-3) under adam, as ``tests/test_torch_seq_parallel.py``
  states.
- Layout: each variable's shard dim, for the parameter and for Adam's
  slots, equals the position of ``'data'`` in the JAX trainer's
  ``state_sharding`` (zero 2, zero 3, PartitionedPS).
- Checkpoints: a port ``save_state`` at zero 3, dp 4 (after 2 adam(1e-3)
  steps) is restored by a JAX trainer at dp 1, and a JAX save at dp 1 by
  a port trainer at zero 3, dp 4: the restored leaves are the saved
  bits, and the next step of both agrees (losses 1e-5 relative, params
  1e-4, a tenth of adam(1e-3)'s lr, as ``tests/test_torch_checkpoint.py``
  holds it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torch_trainer_cases as cases
from autodist_tpu.api import Trainer as JTrainer
from autodist_tpu.checkpoint.saver import CheckpointManager as JManager
from autodist_tpu.checkpoint.saver import _leaf_paths as j_leaf_paths
from autodist_tpu.models.transformer import TransformerConfig as JConfig
from autodist_tpu.models.transformer import TransformerLM as JLM
from autodist_tpu.parallel.axes import ParallelSpec as JSpec
from autodist_tpu.strategy import builders as jbuilders
from autodist_tpu.strategy.adapter import \
    trainer_from_strategy as j_trainer_from_strategy
from torch_dsl_worlds import run_group

LOSS = dict(rtol=1e-5, atol=0)
PARAMS = {'sgd': dict(atol=2e-6, rtol=0), 'adam': dict(atol=1e-3, rtol=0),
          'ckpt': dict(atol=1e-4, rtol=0)}
OPTS = {'sgd': ('sgd', 0.1), 'adam': ('adam', 1e-2),
        'ckpt': ('adam', 1e-3)}

# key -> (spec, builder, optimizer)
TRAINER_CASES = {
    '%s_%s' % (name, opt): (spec, builder, opt)
    for name, spec, builder in (('zero2', dict(zero=2), None),
                                ('zero3', dict(zero=3), None),
                                ('partitioned_ps', {}, 'PartitionedPS'))
    for opt in ('sgd', 'adam')}
TRAINER_CASES.update({
    'partitioned_ar_sgd': ({}, 'PartitionedAR', 'sgd'),
    'uneven_partitioned_ps_sgd': ({}, 'UnevenPartitionedPS', 'sgd'),
    'random_axis_partition_ar_sgd': (
        {}, ('RandomAxisPartitionAR', {'seed': 0}), 'sgd'),
})
LAYOUTS = ['zero2_adam', 'zero3_adam', 'partitioned_ps_adam']


def _jax_trainer(spec, builder, opt):
    jm = JLM(JConfig.tiny(dtype=jnp.float32))
    name, lr = OPTS[opt]
    jspec = JSpec(dp=4, **spec)
    if builder is None:
        return JTrainer(jm, getattr(optax, name)(lr), spec=jspec)
    bname, bkw = (builder, {}) if isinstance(builder, str) else builder
    return j_trainer_from_strategy(jm, getattr(optax, name)(lr),
                                   getattr(jbuilders, bname)(**bkw),
                                   spec=jspec)


def _data_dims(tree):
    """{path: the position of 'data' in each NamedSharding, or None}."""
    out = {}
    for k, sh in cases.flat(tree).items():
        spec = tuple(sh.spec)
        out[k] = next((i for i, a in enumerate(spec)
                       if a == 'data' or (isinstance(a, tuple) and
                                          'data' in a)), None)
    return out


def _jax_leaves(state):
    flat, _ = j_leaf_paths(state)
    return {n: np.asarray(v) for n, v in flat}


def _jax_steps(jtr, init, batches):
    state = jtr.init(jax.random.PRNGKey(0), params=init)
    losses = []
    for b in batches:
        state, m = jtr.step(state, b)
        losses.append(float(m['loss']))
    return state, losses


@pytest.fixture(scope='module')
def world4(tmp_path_factory):
    """Every port case in one gloo group of 4, beside the JAX values."""
    init = jax.tree.map(np.asarray, JLM(JConfig.tiny(
        dtype=jnp.float32)).init(jax.random.PRNGKey(0)))
    batches = [cases.lm_batch(b=8, mask='uneven')] * 3
    runs, want = [], {}
    for key, (spec, builder, opt) in TRAINER_CASES.items():
        runs.append((key, 'torch_trainer_cases:train', dict(
            kind='lm', init=init, batches=batches, opt=OPTS[opt],
            spec=dict(spec, dp=4), builder=builder)))
        jtr = _jax_trainer(spec, builder, opt)
        state, losses = _jax_steps(jtr, init, batches)
        sh = jtr.state_sharding(state)
        want[key] = (losses, cases.flat(jtr.get_params(state)),
                     {'params': _data_dims(sh.params),
                      'opt_state': _data_dims(sh.opt_state[0].mu)
                      if opt == 'adam' else None})
    # checkpoints across packages at zero 3, dp 4 <-> dp 1
    ckpt = [cases.lm_batch(b=8, seed=i) for i in range(3)]
    port_dir = str(tmp_path_factory.mktemp('port_zero3'))
    jax_dir = str(tmp_path_factory.mktemp('jax_dp1'))
    zero3 = dict(dp=4, zero=3)
    runs.append(('save', 'torch_grid_cases:save_then_step', dict(
        init=init, batches=ckpt, path=port_dir, opt=OPTS['ckpt'],
        spec=zero3)))
    jtr = _jax_trainer({}, None, 'ckpt')
    jtr = JTrainer(jtr.model, jtr.optimizer, spec=JSpec(dp=1))
    state, _ = _jax_steps(jtr, init, ckpt[:-1])
    jtr.save_state(JManager(jax_dir), state)
    saved = _jax_leaves(state)
    state, m = jtr.step(state, ckpt[-1])
    want['restore'] = (saved, float(m['loss']),
                       cases.flat(jtr.get_params(state)))
    runs.append(('restore', 'torch_grid_cases:restore_then_step', dict(
        path=jax_dir, batch=ckpt[-1], opt=OPTS['ckpt'], spec=zero3)))
    got = run_group(4, runs)
    # the JAX trainer at dp 1 restores the port's zero-3 checkpoint
    template = jtr.init(jax.random.PRNGKey(1), params=jax.tree.map(
        lambda x: np.zeros_like(x), init))
    jstate, step = jtr.restore_state(JManager(port_dir), template)
    restored = _jax_leaves(jstate)
    jstate, m = jtr.step(jstate, ckpt[-1])
    want['save'] = (restored, step, float(m['loss']),
                    cases.flat(jtr.get_params(jstate)))
    return got, want


@pytest.mark.parametrize('key', list(TRAINER_CASES))
def test_trainer_matches_jax_trainer_at_dp4(world4, key):
    got, want = world4
    losses, params, _ = want[key]
    opt = TRAINER_CASES[key][2]
    for r, rank in enumerate(got[key]):
        np.testing.assert_allclose(rank['losses'], losses, err_msg=str(r),
                                   **LOSS)
        assert rank['params'].keys() == params.keys()
        for k in params:
            np.testing.assert_allclose(rank['params'][k], params[k],
                                       err_msg='%s rank %d' % (k, r),
                                       **PARAMS[opt])
    assert losses[-1] < losses[0]


@pytest.mark.parametrize('key', LAYOUTS)
def test_shard_dims_equal_the_jax_shardings(world4, key):
    got, want = world4
    _, _, dims = want[key]
    sharding = got[key][0]['sharding']
    assert sharding['params'] == dims['params']
    assert sharding['opt_state'] == dims['opt_state']
    # something is sharded, and each rank lays its state out alike
    assert any(d is not None for d in sharding['opt_state'].values())
    assert all(r['sharding'] == sharding for r in got[key])


def _assert_bitwise(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_zero3_checkpoint_restores_in_jax_at_dp1(world4):
    got, want = world4
    restored, step, loss, params = want['save']
    rank0 = got['save'][0]
    assert step == 2
    _assert_bitwise(restored, rank0['tree'])
    np.testing.assert_allclose(rank0['loss'], loss, **LOSS)
    for k in params:
        np.testing.assert_allclose(rank0['params'][k], params[k],
                                   err_msg=k, **PARAMS['ckpt'])


def test_jax_dp1_checkpoint_restores_in_port_zero3(world4):
    got, want = world4
    saved, loss, params = want['restore']
    for r, rank in enumerate(got['restore']):
        assert rank['step'] == 2
        _assert_bitwise(rank['tree'], saved)
        np.testing.assert_allclose(rank['loss'], loss, err_msg=str(r),
                                   **LOSS)
        for k in params:
            np.testing.assert_allclose(rank['params'][k], params[k],
                                       err_msg='%s rank %d' % (k, r),
                                       **PARAMS['ckpt'])
