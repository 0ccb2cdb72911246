"""The zero-touch adapter (``strategy/adapter.FunctionalModel``) and
``models.core.Sequential`` against the JAX package's, on the CPU.

One small functional model, written once in each package on the same
shapes (an embedding table with a ``vocab`` axis, a dense layer, an
output layer): the ``PytreeGraphItem`` variable names and every
builder's ``node_config`` are the JAX adapter's; 3 sgd steps of the same
loss through the port's ``Trainer`` and the JAX ``Trainer`` agree within
1e-5 (losses, relative) and 2e-6 (params, absolute: sgd's update is
linear in the gradient, as in tests/test_torch_trainer_surface.py); and
``Sequential`` applies the JAX ``Sequential``'s params through
``models/weights.py`` to the same outputs within 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from autodist_tpu import strategy as jbuilders
from autodist_tpu.api import Trainer as JTrainer
from autodist_tpu.models import core as jcore
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu.strategy.adapter import FunctionalModel as JFunctionalModel
from autodist_tpu.strategy.adapter import PytreeGraphItem as JGraphItem
from autodist_tpu_torch import optim
from autodist_tpu_torch import strategy as builders
from autodist_tpu_torch.models import core
from autodist_tpu_torch.models.weights import (flatten_tree, load_params,
                                               params_to_jax)
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.adapter import (FunctionalModel,
                                                 PytreeGraphItem,
                                                 trainer_from_strategy)

SHAPES = {'embed': {'table': (64, 16)},
          'dense': {'kernel': (16, 8), 'bias': (8,)},
          'out': {'kernel': (8, 4)}}
AXES = {'embed': {'table': ('vocab', 'embed')},
        'dense': {'kernel': ('embed', 'mlp'), 'bias': ('mlp',)},
        'out': {'kernel': ('mlp', None)}}
BUILDERS = ('AllReduce', 'PS', 'PSLoadBalancing', 'PartitionedPS',
            'UnevenPartitionedPS', 'PartitionedAR', 'RandomAxisPartitionAR',
            'Parallax')
RESOURCES = {'nodes': [{'address': 'localhost', 'chief': True, 'cpus': [0],
                        'gpus': [0, 1], 'network_bandwidth': 100}]}


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _jax_model(axes=AXES):
    def init_fn(rng):
        return _map(lambda s: 0.1 * jax.random.normal(rng, s), SHAPES)

    def loss_fn(p, b):
        h = jnp.take(p['embed']['table'], b['tokens'], axis=0).mean(1)
        h = jnp.tanh(h @ p['dense']['kernel'] + p['dense']['bias'])
        logits = h @ p['out']['kernel']
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, b['labels']).mean()
    return JFunctionalModel(init_fn, loss_fn, axes=axes)


def _port_model(axes=AXES, pair=False):
    def init_fn(generator):
        return _map(lambda s: 0.1 * torch.randn(s, generator=generator),
                    SHAPES)

    def apply_fn(p, tokens):
        h = F.embedding(tokens.long(), p['embed']['table']).mean(1)
        h = torch.tanh(h @ p['dense']['kernel'] + p['dense']['bias'])
        return h @ p['out']['kernel']

    def loss_fn(p, b):
        logits = apply_fn(p, b['tokens'])
        labels = b['labels'].long()
        if pair:
            return F.cross_entropy(logits, labels, reduction='sum'), \
                labels.numel()
        return F.cross_entropy(logits, labels)
    return FunctionalModel(init_fn, loss_fn, axes=axes, apply_fn=apply_fn,
                           device='cpu')


def _batch(seed):
    rng = np.random.RandomState(seed)
    return {'tokens': rng.randint(0, 64, (8, 5), dtype=np.int32),
            'labels': rng.randint(0, 4, (8,), dtype=np.int32)}


def test_params_are_the_tree_under_jax_paths():
    model = _port_model()
    assert list(model.state_dict()) == [
        'dense.bias', 'dense.kernel', 'embed.table', 'out.kernel']
    assert [p for p, _ in flatten_tree(model.params())] == \
        [tuple(k.split('.')) for k in model.state_dict()]
    assert all(isinstance(v, torch.nn.Parameter)
               for _, v in flatten_tree(model.params()))
    assert model.axes() == AXES and not model.has_state()
    with pytest.raises(ValueError, match='neither'):
        FunctionalModel(lambda g: {'a.b': torch.zeros(2)}, None,
                        device='cpu')


def test_default_axes_are_unannotated_as_in_jax():
    port, jm = _port_model(axes=None), _jax_model(axes=None)
    jaxes = jm.axes()
    assert port.axes() == jax.tree.map(
        lambda a: a, jaxes, is_leaf=lambda x: isinstance(x, tuple))


def test_reset_parameters_reruns_init_fn():
    model = _port_model()
    model.reset_parameters(torch.Generator().manual_seed(7))
    fresh = dict(flatten_tree(
        model._init_fn(torch.Generator().manual_seed(7))))
    for path, p in flatten_tree(model.params()):
        assert torch.equal(p.detach(), fresh[path])


@pytest.mark.parametrize('builder', BUILDERS)
def test_graph_item_and_node_config_match_jax(builder):
    gi, jgi = PytreeGraphItem(_port_model()), JGraphItem(_jax_model())
    assert sorted(gi.trainable_var_op_to_var) == \
        sorted(jgi.trainable_var_op_to_var)
    for name, var in gi.trainable_var_op_to_var.items():
        jvar = jgi.trainable_var_op_to_var[name]
        assert (var.shape, var.sparse_read) == (jvar.shape, jvar.sparse_read)
    # the random axes drawn from one seed in both packages
    kw = {'seed': 0} if builder == 'RandomAxisPartitionAR' else {}
    st = getattr(builders, builder)(**kw).build(
        gi, ResourceSpec(resource_info=RESOURCES))
    jst = getattr(jbuilders, builder)(**kw).build(
        jgi, JResourceSpec(resource_info=RESOURCES))
    assert [dataclasses.asdict(n) for n in st.node_config] == \
        [dataclasses.asdict(n) for n in jst.node_config]


@pytest.mark.parametrize('pair', [False, True])
def test_three_sgd_steps_match_the_jax_trainer(pair):
    """From the JAX init, 3 sgd(0.1) steps; the port's loss as a scalar
    mean and as the (sum, count) pair, the same at one rank."""
    jm = _jax_model()
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    jtr = JTrainer(jm, optax.sgd(0.1))
    jstate = jtr.init(jax.random.PRNGKey(0), params=jp)
    tr = trainer_from_strategy(_port_model(pair=pair), optim.sgd(0.1),
                               builders.PS())
    state = tr.init(params=jp)
    for seed in range(3):
        jstate, jm_ = jtr.step(jstate, _batch(seed))
        state, m = tr.step(state, _batch(seed))
        np.testing.assert_allclose(float(m['loss']), float(jm_['loss']),
                                   rtol=1e-5)
    got = dict(flatten_tree(params_to_jax(tr.model)))
    for path, want in flatten_tree(jax.tree.map(np.asarray,
                                                jtr.get_params(jstate))):
        np.testing.assert_allclose(got[path], want, atol=2e-6, rtol=0,
                                   err_msg=str(path))


def test_sequential_matches_jax_through_weights():
    layers = [(4, 8), (8, 8), (8, 3)]
    jseq = jcore.Sequential([jcore.Dense(i, o) for i, o in layers])
    seq = core.Sequential([core.Dense(i, o, device='cpu')
                           for i, o in layers])
    jp = jax.tree.map(np.asarray, jseq.init(jax.random.PRNGKey(0)))
    assert sorted(jp) == ['layer_000', 'layer_001', 'layer_002']
    load_params(seq, jp)
    assert list(seq.state_dict())[:2] == ['layer_000.kernel',
                                          'layer_000.bias']
    assert seq.axes() == jax.tree.map(
        lambda a: a, jseq.axes(), is_leaf=lambda x: isinstance(x, tuple))
    x = np.random.RandomState(0).randn(5, 4).astype(np.float32)
    with torch.no_grad():
        got = seq(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jseq.apply(jp, x)),
                               atol=1e-6)
    round_trip = dict(flatten_tree(params_to_jax(seq)))
    for path, v in flatten_tree(jp):
        np.testing.assert_array_equal(round_trip[path], v)
