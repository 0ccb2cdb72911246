"""Model cases and the TF2-style ``autodist.function`` through the port's
DSL, against the JAX package.

- c4 (``while_loop`` with ``max_iters``, trained through the loop), c6
  (a dynamic LSTM lifted as a function, Adam) and the conv/pool CNN of
  ``tests/integration/test_model_cases.py``: the JAX file's programs
  give the single-device truth; the port runs each under all 14
  builder entries in one gloo group of 2 processes (rank r feeding
  replica r's share) and in this process at world 1. c6's loss reads
  the batch mean of the LSTM state, so its world-2 truth is the JAX
  package's 2-replica run. Tolerances as the
  JAX file holds its strategies to the truth: 1e-5 (2e-3 on the
  bfloat16 wires) for c4, ten times that for c6 and the CNN.
- ``tests/test_function_api.py``: the same functions, world 1, losses
  against the JAX package's to 1e-5.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import autodist_tpu as jad
import autodist_tpu_torch as ad
import chip_smoke as cs
import torch_dsl_cases as cases
from torch_dsl_worlds import run_group

HERE = os.path.dirname(os.path.abspath(__file__))
STRATEGIES = [name for name, _ in cs.C0_STRATEGIES]


def _load(relpath, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_CASES = _load('integration/test_model_cases.py', 'jax_model_cases')


@pytest.fixture(scope='module')
def truths():
    """The JAX package's single-device runs of c4, c6 and the CNN."""
    out = {}
    for model in ('c4', 'c6', 'cnn'):
        autodist = JAX_CASES._fresh(1, JAX_CASES.AllReduce)
        out[model] = getattr(JAX_CASES, 'run_' + model)(autodist)
    # c6's loss is not a mean over examples (the head reads the batch
    # mean of the LSTM state), so a batch split over 2 replicas changes
    # it: at world 2 the truth is the JAX package's 2-replica run
    out['c6@2'] = JAX_CASES.run_c6(JAX_CASES._fresh(2, JAX_CASES.AllReduce))
    from autodist_tpu import autodist as jad_mod
    jad_mod._DEFAULT_AUTODIST.clear()
    return out


@pytest.fixture(scope='module')
def world2():
    return run_group(2, [(m, 'torch_dsl_cases:model_matrix', {'model': m})
                         for m in ('c4', 'c6', 'cnn')])


def _check(model, name, got, truth):
    tol = cs.c0_tol(name) * (1 if model == 'c4' else 10)
    if model == 'c4':
        losses, W, b = got
        assert abs(W - truth[1]) <= tol and abs(b - truth[2]) <= tol, \
            (name, (W, b), truth[1:])
        assert losses[-1] <= losses[0]
        return
    if model == 'cnn':
        losses, got = got
        assert losses[-1] <= losses[0]
        truth = truth[1]
    for g, t in zip(got, truth):
        np.testing.assert_allclose(g, np.asarray(t), atol=tol, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize('model', ['c4', 'c6', 'cnn'])
@pytest.mark.parametrize('name', STRATEGIES)
def test_model_case_gloo_world2(model, name, world2, truths):
    truth = truths['c6@2' if model == 'c6' else model]
    for per_rank in world2[model]:
        _check(model, name, per_rank[name], truth)


@pytest.mark.parametrize('model', ['c4', 'c6', 'cnn'])
def test_model_case_world1(model, truths):
    _check(model, 'AllReduce', cases.model_case(0, 1, model),
           truths[model])
    if model == 'c4':
        # the JAX c4 losses, step for step
        np.testing.assert_allclose(cases.model_case(0, 1, model)[0],
                                   truths[model][0], rtol=1e-6)


def test_while_loop_without_max_iters_is_forward_only():
    """As ``lax.while_loop``: it runs forward, and refuses a gradient."""
    autodist = cases.fresh(ad.AllReduce())
    with autodist.scope():
        W = ad.Variable(2.0, name='W')
        out = ad.ops.while_loop(lambda c: c[0] < 3,
                                lambda c: (c[0] + 1, c[1] * c[2], c[2]),
                                (ad.ops.constant(0), ad.ops.constant(1.0),
                                 W))
        loss = out[1]
        train_op = ad.optimizers.SGD(0.1).minimize(loss, [W])
        sess = autodist.create_distributed_session()
        assert float(sess.run(loss)) == 8.0
        with pytest.raises(ValueError, match='forward-only'):
            sess.run(train_op)


# -- autodist.function -------------------------------------------------------
def _spec(n):
    return {'nodes': [{'address': 'localhost', 'gpus': list(range(n)),
                       'chief': True, 'network_bandwidth': 100}]}


def _both():
    """(JAX package at 1 replica, the port at world 1), fresh."""
    from autodist_tpu import autodist as jad_mod
    jad_mod._DEFAULT_AUTODIST.clear()
    return (jad.AutoDist(resource_info=_spec(1),
                         strategy_builder=jad.AllReduce()),
            cases.fresh(ad.AllReduce()))


def _train_fn(pkg, autodist):
    rng = np.random.RandomState(0)
    true_w = np.array([1.0, -2.0, 3.0, 0.5], np.float32)
    xs = rng.randn(256, 4).astype(np.float32)
    ys = xs @ true_w
    with autodist.scope():
        W = pkg.Variable(np.zeros(4, np.float32), name='W')
        opt = pkg.optimizers.SGD(0.05)

        @autodist.function
        def train_step(x, y):
            pred = pkg.ops.squeeze(
                pkg.ops.matmul(x, pkg.ops.reshape(W, (4, 1))), axis=1)
            loss = pkg.ops.reduce_mean(pkg.ops.square(pred - y))
            return loss, opt.minimize(loss)

        losses = [float(train_step(xs, ys)[0]) for _ in range(20)]
        l_half = float(train_step(xs[:128], ys[:128])[0])
    return losses, l_half


def test_function_trains_and_feeds_rebind():
    jax_ad, port_ad = _both()
    want = _train_fn(jad, jax_ad)
    losses, l_half = _train_fn(ad, port_ad)
    assert losses[-1] < losses[0] * 0.1, losses
    np.testing.assert_allclose(losses, want[0], rtol=1e-5)
    assert abs(l_half - want[1]) <= 1e-5 * max(1.0, abs(want[1]))


def test_multiple_functions_share_session():
    autodist = cases.fresh(ad.AllReduce())
    rng = np.random.RandomState(0)
    xs = rng.randn(64).astype(np.float32)
    ys = 3.0 * xs
    with autodist.scope():
        w = ad.Variable(0.0, name='w')
        opt = ad.optimizers.SGD(0.1)

        @autodist.function
        def train(x, y):
            loss = ad.ops.reduce_mean(ad.ops.square(w * x - y))
            return loss, opt.minimize(loss)

        @autodist.function
        def mse(x, y):
            return ad.ops.reduce_mean(ad.ops.square(w * x - y))

        l0 = float(mse(xs, ys))
        for _ in range(10):
            train(xs, ys)
        l1 = float(mse(xs, ys))
        assert l1 < l0 * 0.2, (l0, l1)
        assert float(mse(xs, ys)) == l1
        assert autodist._session.step_count == 10


def test_later_function_with_new_variable_rejected():
    autodist = cases.fresh(ad.AllReduce())
    with autodist.scope():
        v = ad.Variable(1.0, name='v')

        @autodist.function
        def f(x):
            return ad.ops.reduce_mean(x * v.read())

        x = np.ones(8, np.float32)
        f(x)

        @autodist.function
        def g(x):
            u = ad.Variable(2.0, name='u')
            return ad.ops.reduce_sum(x * u.read())

        before = float(f(x))
        with pytest.raises(ValueError, match='new variables'):
            g(x)
        assert float(f(x)) == before


def test_failing_later_trace_rolls_back():
    autodist = cases.fresh(ad.AllReduce())
    with autodist.scope():
        v = ad.Variable(1.0, name='v')

        @autodist.function
        def f(x):
            return ad.ops.reduce_mean(x * v.read())

        x = np.ones(8, np.float32)
        before = float(f(x))

        @autodist.function
        def bad(x):
            x * 2.0 + v.read()
            raise RuntimeError('boom')

        with pytest.raises(RuntimeError, match='boom'):
            bad(x)
        assert float(f(x)) == before


def test_failing_first_trace_rolls_back():
    autodist = cases.fresh(ad.AllReduce())
    with autodist.scope():
        state = {'boom': True}

        @autodist.function
        def f(x):
            w = ad.Variable(0.5, name='w')
            if state['boom']:
                raise RuntimeError('first try fails')
            return ad.ops.reduce_mean(x * w.read())

        x = np.ones(8, np.float32)
        with pytest.raises(RuntimeError, match='first try fails'):
            f(x)
        state['boom'] = False
        autodist._fn_cache.clear()
        assert abs(float(f(x)) - 0.5) < 1e-6


def test_gradients_fetch_and_lifted_op_match_jax():
    """A Gradients node fetched directly (a list) and a lifted function,
    against the JAX package."""
    rng = np.random.RandomState(3)
    xs = rng.randn(16, 3).astype(np.float32)
    w0 = rng.randn(3, 2).astype(np.float32)
    out = {}
    for pkg, autodist, fn in zip(
            (jad, ad), _both(),
            (lambda v: __import__('jax').numpy.tanh(v) * 2.0,
             lambda v: torch.tanh(v) * 2.0)):
        with autodist.scope():
            x = pkg.placeholder(shape=[None, 3], dtype=np.float32, name='x')
            W = pkg.Variable(w0, name='W')
            h = pkg.ops.lift(fn)(pkg.ops.matmul(x, W))
            loss = pkg.ops.reduce_sum(pkg.ops.softmax(h, axis=-1) *
                                      pkg.ops.log(pkg.ops.sqrt(
                                          pkg.ops.exp(h) + 1.0)))
            grads = pkg.gradients(loss, [W])
            sess = autodist.create_distributed_session()
            out[pkg] = sess.run([loss, grads], {x: xs})
    (jl, jg), (pl, pg) = out[jad], out[ad]
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    np.testing.assert_allclose(pg[0], np.asarray(jg[0]), atol=1e-5)


def test_scan_and_its_gradient_match_jax():
    """``ops.scan`` (a linear recurrence whose carry holds the state and
    the weight, each package's body in its own language): the carry,
    the stacked outputs and the gradient through the scan, against the
    JAX package."""
    import jax.numpy as jnp

    def body(stack):
        def fn(carry, xt):
            h = carry[0] * carry[1] + xt
            return stack([h, carry[1]]), h ** 2
        return fn

    rng = np.random.RandomState(4)
    xs = rng.randn(5, 3).astype(np.float32)
    w0 = rng.randn(3).astype(np.float32)
    out = {}
    for pkg, autodist, stack in zip((jad, ad), _both(),
                                    (jnp.stack, torch.stack)):
        with autodist.scope():
            x = pkg.placeholder(shape=[None, 3], dtype=np.float32, name='x')
            W = pkg.Variable(w0, name='W')
            init = pkg.ops.stack([pkg.ops.constant(np.zeros(3, np.float32)),
                                  W.read()])
            res = pkg.ops.scan(body(stack), init, x)
            carry, ys = res[0], res[1]
            loss = pkg.ops.reduce_mean(ys) + pkg.ops.reduce_sum(carry[0])
            grads = pkg.gradients(loss, [W])
            sess = autodist.create_distributed_session()
            out[pkg] = sess.run([carry, ys, loss, grads], {x: xs})
    for got, want in zip(out[ad][:3], out[jad][:3]):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    assert np.abs(np.asarray(out[jad][3][0])).max() > 0
    np.testing.assert_allclose(out[ad][3][0], np.asarray(out[jad][3][0]),
                               rtol=1e-5, atol=1e-6)
