"""Checkpoints between the port and the JAX package, on the CPU.

A checkpoint is a directory of ``manifest.json`` plus one ``.npy`` per
leaf, named by the leaf's path; both packages write and read the same
layout, so each restores what the other wrote:

- ``Trainer.save_state`` / ``restore_state``: the JAX ``TrainState``'s
  leaves (``.params/...``, optax's ``.opt_state/0/.count|.mu|.nu`` for
  Adam and AdamW, ``.opt_state/0/.trace`` for SGD with momentum,
  ``.step``). After a restore the params and slots are the saved bits,
  and the next step of both packages from there agrees as their steps
  do (tests/test_torch_sparse_models.py): losses 1e-5 relative, params
  2e-6 absolute under sgd (linear in the gradient) and 1e-4 under Adam
  (a tenth of one step's largest move).
- The DSL ``Saver``: one leaf per variable, written by a session under
  one strategy and restored under another, in either package.

The rest mirrors tests/test_checkpoint.py for the npy backend:
retention, async saves and their errors, shape checks; the orbax
backend, which the port has no library for, raises.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import autodist_tpu as jad
import autodist_tpu_torch as ad
import chip_smoke as cs
import torch_trainer_cases as cases
from autodist_tpu import autodist as jad_mod
from autodist_tpu.api import Trainer as JTrainer
from autodist_tpu.checkpoint.saver import CheckpointManager as JManager
from autodist_tpu.checkpoint.saver import Saver as JSaver
from autodist_tpu.checkpoint.saver import _leaf_paths as j_leaf_paths
from autodist_tpu.models.ncf import NCF as JNCF
from autodist_tpu.parallel.axes import ParallelSpec as JSpec
from autodist_tpu_torch.checkpoint.saver import (CheckpointManager, Saver,
                                                 load_pytree, save_pytree)

OPTS = {'sgd_momentum': (optax.sgd(0.1, momentum=0.9),
                         dict(opt=('sgd', 0.1), momentum=0.9)),
        'adam': (optax.adam(1e-3), dict(opt=('adam', 1e-3))),
        'adamw': (optax.adamw(1e-3), dict(opt=('adamw', 1e-3)))}
LOSS = dict(rtol=1e-5, atol=0)


def _tol(name):
    return dict(atol=2e-6 if name == 'sgd_momentum' else 1e-4, rtol=0)


def _jax_setup(name):
    jm = JNCF(**cases.NCF_TINY)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    jtr = JTrainer(jm, OPTS[name][0], spec=JSpec(dp=1))
    return jtr, jtr.init(jax.random.PRNGKey(0), params=jp), jp


def _jax_leaves(state):
    flat, _ = j_leaf_paths(state)
    return {n: np.asarray(v) for n, v in flat}


def _port_leaves(tr, state):
    from autodist_tpu_torch.checkpoint.saver import _leaf_paths
    return {n: np.asarray(v) for n, v in _leaf_paths(
        tr._state_tree(state))}


def _assert_bitwise(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k


@pytest.mark.parametrize('name', list(OPTS))
def test_trainer_state_from_jax_restores_in_the_port(name, tmp_path):
    jtr, jstate, jp = _jax_setup(name)
    for i in range(2):
        jstate, _ = jtr.step(jstate, cases.ncf_batch(seed=i))
    jtr.save_state(JManager(str(tmp_path)), jstate)
    tr = cases.make_trainer('ncf', **OPTS[name][1])
    state = tr.init(seed=1)     # other params: the restore replaces them
    state, step = tr.restore_state(CheckpointManager(str(tmp_path)), state)
    assert step == 2 and state.step == 2
    _assert_bitwise(_port_leaves(tr, state), _jax_leaves(jstate))
    jstate, jm = jtr.step(jstate, cases.ncf_batch(seed=2))
    state, m = tr.step(state, cases.ncf_batch(seed=2))
    np.testing.assert_allclose(float(m['loss']), float(jm['loss']), **LOSS)
    want = cases.flat(jtr.get_params(jstate))
    got = cases.flat(tr.get_params(state))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **_tol(name))


@pytest.mark.parametrize('name', list(OPTS))
def test_trainer_state_from_the_port_restores_in_jax(name, tmp_path):
    jtr, jstate, jp = _jax_setup(name)
    tr = cases.make_trainer('ncf', **OPTS[name][1])
    state = tr.init(params=jp)
    for i in range(2):
        state, _ = tr.step(state, cases.ncf_batch(seed=i))
    tr.save_state(CheckpointManager(str(tmp_path)), state)
    jstate, step = jtr.restore_state(JManager(str(tmp_path)), jstate)
    assert step == 2 and int(jstate.step) == 2
    _assert_bitwise(_jax_leaves(jstate), _port_leaves(tr, state))
    jstate, jm = jtr.step(jstate, cases.ncf_batch(seed=2))
    state, m = tr.step(state, cases.ncf_batch(seed=2))
    np.testing.assert_allclose(float(m['loss']), float(jm['loss']), **LOSS)
    want = cases.flat(jtr.get_params(jstate))
    got = cases.flat(tr.get_params(state))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **_tol(name))


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_moe_trainer_state_round_trips_bitwise(writer, tmp_path):
    """The MoE TransformerLM's TrainState (4-D stacked expert leaves and
    their AdamW slots) after 2 steps, written by one package and restored
    by the other bit for bit; the next step of both agrees."""
    from autodist_tpu.models.transformer import TransformerConfig as JConfig
    from autodist_tpu.models.transformer import TransformerLM as JLM
    jm = JLM(JConfig.tiny(dtype=jnp.float32, **cases.MOE_TINY))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    jtr = JTrainer(jm, optax.adamw(1e-3), spec=JSpec(dp=1))
    jstate = jtr.init(jax.random.PRNGKey(0), params=jp)
    tr = cases.make_trainer('moe', opt=('adamw', 1e-3))
    state = tr.init(params=jp)
    batches = [cases.lm_batch(seed=i) for i in range(3)]
    if writer == 'jax':
        for b in batches[:2]:
            jstate, _ = jtr.step(jstate, b)
        jtr.save_state(JManager(str(tmp_path)), jstate)
        state, step = tr.restore_state(CheckpointManager(str(tmp_path)),
                                       state)
        assert step == 2 and state.step == 2
    else:
        for b in batches[:2]:
            state, _ = tr.step(state, b)
        tr.save_state(CheckpointManager(str(tmp_path)), state)
        jstate, step = jtr.restore_state(JManager(str(tmp_path)), jstate)
        assert step == 2 and int(jstate.step) == 2
    leaves = _port_leaves(tr, state)
    assert leaves['.params/blocks/mlp/up'].shape == (2, 4, 64, 256)
    assert '.opt_state/0/.mu/blocks/mlp/router/kernel' in leaves
    _assert_bitwise(leaves, _jax_leaves(jstate))
    jstate, jm_out = jtr.step(jstate, batches[2])
    state, m = tr.step(state, batches[2])
    np.testing.assert_allclose(float(m['loss']), float(jm_out['loss']),
                               **LOSS)
    want = cases.flat(jtr.get_params(jstate))
    got = cases.flat(tr.get_params(state))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                   **_tol('adamw'))


def test_state_at_step_0_and_sgd_without_slots(tmp_path):
    """Before any step Adam's slots are zeros and its count 0; plain SGD
    has no slots at all, in both packages."""
    for name, jopt, kw in (('adam', optax.adam(1e-3), dict(opt=('adam',
                                                                1e-3))),
                           ('sgd', optax.sgd(0.1), dict(opt=('sgd', 0.1)))):
        jm = JNCF(**cases.NCF_TINY)
        jtr = JTrainer(jm, jopt, spec=JSpec(dp=1))
        jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
        jstate = jtr.init(jax.random.PRNGKey(0), params=jp)
        tr = cases.make_trainer('ncf', **kw)
        state = tr.init(params=jp)
        _assert_bitwise(_port_leaves(tr, state), _jax_leaves(jstate))
        mgr = CheckpointManager(str(tmp_path / name))
        tr.save_state(mgr, state)
        assert tr.restore_state(mgr, state)[1] == 0
    empty = CheckpointManager(str(tmp_path / 'empty'))
    assert tr.restore_state(empty, state) == (state, None)


# -- the DSL Saver ------------------------------------------------------------
def _dsl_program(pkg, builder, saver_cls):
    with _scope(pkg, builder) as (autodist, _):
        x = pkg.placeholder(shape=[None, 4], dtype=np.float32, name='x')
        W = pkg.Variable(np.arange(8, dtype=np.float32).reshape(4, 2),
                         name='W')
        b = pkg.Variable(np.zeros(2, np.float32), name='b')
        loss = pkg.ops.reduce_mean(pkg.ops.square(
            pkg.ops.matmul(x, W) + b))
        train_op = pkg.optimizers.SGD(0.1).minimize(loss)
        saver = saver_cls()
        sess = autodist.create_distributed_session()
    return sess, saver, (x, loss, train_op)


class _scope:
    """A fresh AutoDist of ``pkg`` (one per process) and its scope."""

    def __init__(self, pkg, builder):
        if pkg is jad:
            jad_mod._DEFAULT_AUTODIST.clear()
            self.autodist = jad.AutoDist(resource_info={'nodes': [{
                'address': 'localhost', 'gpus': list(range(8)),
                'chief': True, 'network_bandwidth': 100}]},
                strategy_builder=builder)
        else:
            self.autodist = cs.fresh_autodist(builder, 'cpu')
        self.graph = self.autodist.scope()

    def __enter__(self):
        self.graph.__enter__()
        return self.autodist, self.graph

    def __exit__(self, *exc):
        return self.graph.__exit__(*exc)


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_dsl_saver_crosses_between_packages(writer, tmp_path):
    """Saved after one step under PartitionedPS by one package, restored
    under AllReduce by the other: the same values, bit for bit."""
    pkgs = {'jax': (jad, jad.PartitionedPS, jad.AllReduce, JSaver),
            'port': (ad, ad.PartitionedPS, ad.AllReduce, Saver)}
    reader = 'port' if writer == 'jax' else 'jax'
    pkg, part, _, saver_cls = pkgs[writer]
    sess, saver, (x, loss, train_op) = _dsl_program(pkg, part(), saver_cls)
    sess.run([loss, train_op], {x: np.ones((8, 4), np.float32)})
    want = {n: np.asarray(sess.get_variable_value(n)) for n in ('W', 'b')}
    path = saver.save(sess, str(tmp_path / 'ckpt'), global_step=1)
    sess.close()
    pkg, _, allreduce, saver_cls = pkgs[reader]
    sess, saver, _ = _dsl_program(pkg, allreduce(), saver_cls)
    saver.restore(sess, path)
    for n, v in want.items():
        np.testing.assert_array_equal(np.asarray(sess.get_variable_value(n)),
                                      v)
    assert not np.array_equal(want['W'], np.arange(8).reshape(4, 2))
    sess.close()


def test_dsl_saver_writes_logical_npy(tmp_path):
    sess, saver, _ = _dsl_program(ad, ad.PartitionedPS(), Saver)
    saver.save(sess, str(tmp_path / 'ckpt'), global_step=7)
    tensors, step = load_pytree(str(tmp_path / 'ckpt-7'))
    assert step == 7 and tensors['W'].shape == (4, 2)
    sess.close()


# -- the manager ---------------------------------------------------------------
def test_checkpoint_manager_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path / 'ckpts'), max_to_keep=2)
    for s in (1, 2, 3):
        mgr.save(s, {'a': np.full((2,), s, np.float32)})
    assert mgr.all_steps() == [2, 3]
    tree, step = mgr.restore(like={'a': np.zeros((2,), np.float32)})
    assert step == 3 and np.allclose(tree['a'], 3)
    assert mgr.restore(step=2)[0]['a'].tolist() == [2.0, 2.0]


def test_shape_mismatch_raises(tmp_path):
    path = str(tmp_path / 'ckpt')
    save_pytree(path, {'a': np.zeros((2, 3), np.float32)})
    with pytest.raises(ValueError, match='Shape mismatch'):
        load_pytree(path, like={'a': np.zeros((3, 2), np.float32)})
    with pytest.raises(KeyError):
        load_pytree(path, like={'b': np.zeros((2, 3), np.float32)})


def test_async_save_roundtrip_and_retention(tmp_path):
    """async_save=True: values are a snapshot at call time (a later
    in-place update is invisible), retention holds, and restore drains
    the in-flight write first."""
    import torch
    mgr = CheckpointManager(str(tmp_path / 'ck'), max_to_keep=2,
                            async_save=True)
    w = torch.zeros(4)
    for step in (1, 2, 3):
        w.fill_(float(step))
        mgr.save(step, {'w': w, 'b': {'x': np.arange(3.0) * step}})
        w.fill_(-1.0)
    mgr.wait_until_finished()
    assert mgr.all_steps() == [2, 3]
    got, step = mgr.restore(like={'w': np.zeros(4), 'b': {'x': np.zeros(3)}})
    assert step == 3 and got['w'].tolist() == [3.0] * 4
    assert got['b']['x'].tolist() == [0.0, 3.0, 6.0]
    mgr.close()
    mgr.close()


def test_async_save_error_surfaces_on_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path / 'ck'), async_save=True)
    target = mgr._ckpt_path(7)
    with open(target, 'w') as f:      # a file where the rename must land
        f.write('in the way')
    mgr.save(7, {'w': np.zeros(2)})
    with pytest.raises(Exception):
        mgr.wait_until_finished()


def test_orbax_backend_raises_naming_the_reason(tmp_path):
    with pytest.raises(NotImplementedError, match='orbax is not installed'):
        CheckpointManager(str(tmp_path), backend='orbax')
    with pytest.raises(ValueError):
        CheckpointManager(str(tmp_path), backend='zarr')


def test_fit_with_async_checkpointing(tmp_path):
    """fit(save_every=...) with an async manager trains, saves, and the
    final drain leaves a restorable full state."""
    tr = cases.make_trainer('lm', opt=('sgd', 0.1))
    mgr = CheckpointManager(str(tmp_path / 'ck'), async_save=True)
    state = tr.init(seed=0)
    data = [cases.lm_batch(seed=i) for i in range(5)]
    state, hist = tr.fit(state, data, checkpoint_manager=mgr, save_every=2)
    assert mgr.all_steps() == [2, 4, 5] and len(hist['loss']) == 5
    fresh = cases.make_trainer('lm', opt=('sgd', 0.1))
    restored, got = fresh.restore_state(mgr, fresh.init(seed=1))
    assert got == 5 and restored.step == 5
    np.testing.assert_array_equal(
        fresh.get_params(restored)['embed']['table'],
        tr.get_params(state)['embed']['table'])
    assert os.path.exists(os.path.join(str(tmp_path / 'ck'), 'ckpt-5',
                                       'manifest.json'))
