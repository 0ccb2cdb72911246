"""The sparse family of the port (NCF, LSTMLM) and ``optim.adam``
against the JAX package, on the CPU in f32.

The JAX package initializes the params; ``load_params`` carries them
into the port, and both run the same numpy-seeded batches. Tolerances
(f32): losses 1e-5 relative; logits 2e-5 absolute; gradients 1e-5
absolute (a few chained products summed in other orders; the largest
gradients here are about 1e-1). Params after 3 Adam(1e-3) steps: 1e-4
absolute, a tenth of the largest move of one step: Adam moves a param
by lr * g / (|g| + eps) whatever the size of g, so an element whose
gradient is rounding-sized moves by a rounding-dependent share of lr
(tests/test_torch_trainer_surface.py names one). At gloo world 2 the
same tolerances hold against the JAX Trainer at dp = 2; the strategies
are ``bench.py:bench_sparse``'s (PSLoadBalancing for NCF, PartitionedPS
for LSTMLM at dp = 1) and AllReduce.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_trainer_cases as cases
from autodist_tpu.api import Trainer as JTrainer
from autodist_tpu.models.ncf import NCF as JNCF
from autodist_tpu.models.rnn import LSTMLM as JLSTMLM
from autodist_tpu.parallel.axes import ParallelSpec as JSpec
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu.strategy import builders as jbuilders
from autodist_tpu.strategy.adapter import PytreeGraphItem as JGraphItem
from autodist_tpu.strategy.adapter import \
    grad_bucket_layout as j_grad_bucket_layout
from autodist_tpu_torch import optim
from autodist_tpu_torch.models.ncf import NCF
from autodist_tpu_torch.models.rnn import LSTMLM
from autodist_tpu_torch.models.weights import (load_params, params_to_jax,
                                               tree_to_numpy)
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy import builders
from autodist_tpu_torch.strategy.adapter import (PytreeGraphItem,
                                                 grad_bucket_layout)
from torch_dsl_worlds import run_group

LOSS = dict(rtol=1e-5, atol=0)
PARAMS = dict(atol=1e-4, rtol=0)


def _jax_model(kind, tied=False):
    if kind == 'ncf':
        return JNCF(**cases.NCF_TINY)
    return JLSTMLM(**cases.LSTM_TINY, tied=tied)


def _jax_init(kind, tied=False, seed=0):
    jm = _jax_model(kind, tied)
    return jm, jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))


def _batches(kind, n=3, mask=False):
    if kind == 'ncf':
        return [cases.ncf_batch(seed=i) for i in range(n)]
    return [cases.lstm_batch(seed=i, mask=mask) for i in range(n)]


def _jax_train(kind, jp, batches, dp=1, tied=False):
    jtr = JTrainer(_jax_model(kind, tied), optax.adam(1e-3),
                   spec=JSpec(dp=dp))
    state = jtr.init(jax.random.PRNGKey(0), params=jp)
    losses = []
    for b in batches:
        state, m = jtr.step(state, b)
        losses.append(float(m['loss']))
    return losses, cases.flat(jtr.get_params(state))


def _assert_flat_close(got, want, **tol):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _grad_tree(tree):
    return {k: _grad_tree(v) if isinstance(v, dict) else v.grad
            for k, v in tree.items()}


def _forward_pair(kind, tied=False, mask=False):
    """(JAX loss, JAX grads, port loss, port grads) of one batch."""
    jm, jp = _jax_init(kind, tied)
    tm = cases.make_model(kind, tied)
    load_params(tm, jp)
    batch = _batches(kind, 1, mask)[0]
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    params = tm.params()
    loss = tm.loss(params, {k: torch.from_numpy(v)
                            for k, v in batch.items()})
    loss.backward()
    return (float(jloss), cases.flat(jax.tree.map(np.asarray, jgrads)),
            float(loss.detach()), cases.flat(tree_to_numpy(
                _grad_tree(params))))


@pytest.mark.parametrize('kind,tied,mask', [
    ('ncf', False, False), ('lstm', False, False), ('lstm', True, False),
    ('lstm', False, True)], ids=['ncf', 'lstm', 'lstm_tied', 'lstm_masked'])
def test_loss_and_every_gradient_match_jax(kind, tied, mask):
    jloss, jgrads, loss, grads = _forward_pair(kind, tied, mask)
    np.testing.assert_allclose(loss, jloss, **LOSS)
    _assert_flat_close(grads, jgrads, atol=1e-5, rtol=0)


def test_ncf_logits_and_lstm_logits_match_jax():
    jm, jp = _jax_init('ncf')
    tm = NCF(**cases.NCF_TINY, device='cpu')
    load_params(tm, jp)
    b = cases.ncf_batch()
    got = tm.apply(tm.params(), torch.from_numpy(b['users']),
                   torch.from_numpy(b['items']))
    want = jm.apply(jp, jnp.asarray(b['users']), jnp.asarray(b['items']))
    assert got.dtype == torch.float32 and got.shape == (32,)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-5, rtol=0)
    jm, jp = _jax_init('lstm')
    tm = LSTMLM(**cases.LSTM_TINY, device='cpu')
    load_params(tm, jp)
    b = cases.lstm_batch()
    got = tm.apply(tm.params(), torch.from_numpy(b['tokens']))
    want = jm.apply(jp, jnp.asarray(b['tokens']))
    assert got.shape == (4, 6, cases.LSTM_TINY['vocab'])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize('kind,tied', [('ncf', False), ('lstm', False),
                                       ('lstm', True)],
                         ids=['ncf', 'lstm', 'lstm_tied'])
def test_weights_round_trip_by_jax_path(kind, tied):
    """The port's parameter paths are the JAX tree's, both ways."""
    _, jp = _jax_init(kind, tied)
    tm = cases.make_model(kind, tied)
    load_params(tm, jp)
    back = params_to_jax(tm)
    _assert_flat_close(cases.flat(back), cases.flat(jp), atol=0, rtol=0)


@pytest.mark.parametrize('kind,tied,builder', [
    ('ncf', False, 'PSLoadBalancing'), ('lstm', False, 'PartitionedPS'),
    ('lstm', True, 'AllReduce')],
    ids=['ncf-PSLoadBalancing', 'lstm-PartitionedPS', 'lstm_tied-AllReduce'])
def test_adam_steps_match_jax_trainer(kind, tied, builder):
    """3 Adam(1e-3) steps through ``trainer_from_strategy`` at dp = 1
    (a partitioned strategy is a no-op there, in both packages) against
    the JAX Trainer: losses and every param."""
    _, jp = _jax_init(kind, tied)
    batches = _batches(kind)
    want, want_params = _jax_train(kind, jp, batches, tied=tied)
    got = cases.train(0, 1, kind, jp, batches, builder=builder, tied=tied)
    np.testing.assert_allclose(got['losses'], want, **LOSS)
    _assert_flat_close(got['params'], want_params, **PARAMS)


def test_adam_is_optax_adam():
    """``optim.adam`` states every hyperparameter as optax.adam has it."""
    p = torch.nn.Parameter(torch.zeros(2))
    opt = optim.adam(1e-3)([p])
    g = opt.param_groups[0]
    assert isinstance(opt, torch.optim.Adam)
    assert (g['lr'], g['betas'], g['eps'], g['weight_decay']) == \
        (1e-3, (0.9, 0.999), 1e-8, 0.0)


_WORLD_CASES = [('ncf', False, 'PSLoadBalancing', False),
                ('lstm', False, 'AllReduce', True)]


@pytest.fixture(scope='module')
def world2():
    """Both world-2 cases in one gloo group of 2 processes, and the JAX
    Trainer at dp = 2 on the same global batches."""
    runs, want = [], {}
    for kind, tied, builder, mask in _WORLD_CASES:
        _, jp = _jax_init(kind, tied)
        batches = _batches(kind, mask=mask)
        want[kind] = _jax_train(kind, jp, batches, dp=2, tied=tied)
        runs.append((kind, 'torch_trainer_cases:train', dict(
            kind=kind, init=jp, batches=batches, builder=builder,
            tied=tied)))
    return run_group(2, runs), want


@pytest.mark.parametrize('kind', ['ncf', 'lstm'],
                         ids=['ncf-PSLoadBalancing', 'lstm-AllReduce-masked'])
def test_gloo_dp2_matches_jax_trainer_dp2(world2, kind):
    got, want = world2
    losses, params = want[kind]
    for rank_out in got[kind]:
        np.testing.assert_allclose(rank_out['losses'], losses, **LOSS)
        _assert_flat_close(rank_out['params'], params, **PARAMS)


_RESOURCES = {'nodes': [{'address': 'localhost', 'chief': True,
                         'cpus': [0], 'gpus': [0, 1],
                         'network_bandwidth': 100}]}


@pytest.mark.parametrize('kind,tied,builder', [
    ('ncf', False, 'AllReduce'), ('ncf', False, 'PSLoadBalancing'),
    ('ncf', False, 'Parallax'), ('lstm', False, 'AllReduce'),
    ('lstm', True, 'PartitionedAR')])
def test_grad_bucket_layout_matches_jax(kind, tied, builder, monkeypatch):
    """The same strategy over the same model gives the JAX function's
    buckets, at the default cap and at a cap of 4 KiB that splits the
    groups."""
    jm = _jax_model(kind, tied)
    tm = cases.make_model(kind, tied)
    jgi, gi = JGraphItem(jm), PytreeGraphItem(tm)
    jst = getattr(jbuilders, builder)().build(
        jgi, JResourceSpec(resource_info=_RESOURCES))
    st = getattr(builders, builder)().build(
        gi, ResourceSpec(resource_info=_RESOURCES))
    assert [dataclasses.asdict(n) for n in st.node_config] == \
        [dataclasses.asdict(n) for n in jst.node_config]
    for cap in (None, '4096'):
        if cap:
            monkeypatch.setenv('AUTODIST_BUCKET_BYTES', cap)
        want = j_grad_bucket_layout(jst, jgi)
        assert grad_bucket_layout(st, gi) == want
    if builder == 'AllReduce':
        assert want and sum(len(b['vars']) for b in want) == \
            len(st.node_config)


def test_trainer_from_strategy_carries_the_buckets():
    tr = cases.make_trainer('ncf', builder='AllReduce')
    assert tr.grad_buckets == grad_bucket_layout(tr.strategy,
                                                 PytreeGraphItem(tr.model))
    assert tr.grad_buckets
