"""The port Trainer's surface against the JAX Trainer, on the CPU in f32:
the global masked mean at dp > 1, ``grad_accum`` (at dp = 2 too, with
uneven masks), ``remat='full'``, ``fit`` / ``evaluate`` (with a
``metrics_fn``), ``profile``, ``ParallelSpec``'s serialization, the
placement of a batch, and device prefetch.

Tolerances (f32). Losses 1e-5 relative. Params after sgd steps, whose
update is linear in the gradient: 2e-6 absolute for the Transformer
(sgd 0.1), 2e-5 for the small ResNet (sgd 0.1, momentum 0.9, through
BatchNorm), as in tests/test_torch_trainer.py. Params after adamw(1e-3)
steps: 1e-4 absolute, a tenth of the largest move of one step. Adam
moves a param by lr * g / (|g| + eps) whatever the size of g, so an
element whose gradient is rounding-sized moves by a rounding-dependent
share of lr: in blocks/mlp/up/kernel one gradient reads -5.28e-9 in the
JAX package and -5.77e-9 in the port (typical |g| 6.7e-4), and after 3
steps that element stands 3.6e-5 apart, at dp = 1 with no collective.
The dp = 2 defect this file pins moved params by 6.0e-3 under adamw.
``remat='full'`` recomputes the same ops on the same inputs, so the
port's own runs with and without it agree bit for bit, and ``profile``
restores the state bit for bit.
"""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_trainer_cases as cases
from autodist_tpu.api import Trainer as JTrainer
from autodist_tpu.checkpoint.saver import CheckpointManager as JManager
from autodist_tpu.models import vision as jv
from autodist_tpu.models.transformer import TransformerConfig as JConfig
from autodist_tpu.models.transformer import TransformerLM as JLM
from autodist_tpu.parallel.axes import ParallelSpec as JSpec
from autodist_tpu_torch.checkpoint.saver import CheckpointManager
from autodist_tpu_torch.data.prefetch import prefetch_to_device
from autodist_tpu_torch.parallel.axes import ParallelSpec
from torch_dsl_worlds import run_group

LOSS = dict(rtol=1e-5, atol=0)
PARAMS_SGD = dict(atol=2e-6, rtol=0)
PARAMS_ADAM = dict(atol=1e-4, rtol=0)
PARAMS_RESNET = dict(atol=2e-5, rtol=0)


def _jax_lm():
    return JLM(JConfig.tiny(dtype=jnp.float32))


def _init(jm):
    return jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))


def _jax_masked_loss(jm):
    """The JAX ``loss_fn`` of ``cases.masked_loss``: the masked mean of
    the global batch, which GSPMD hands it whole."""
    def loss_fn(params, batch):
        nll = jm.per_token_loss(params, batch)
        mask = jnp.asarray(batch['mask'], nll.dtype)
        return jnp.sum(nll * mask) / jnp.maximum(jnp.sum(mask), 1.0)
    return loss_fn


def _jax_train(jm, opt, jp, batches, jtr=None, loss_fn=None, **spec):
    """Steps of the JAX Trainer from ``jp``; pass ``jtr`` to reuse a
    trainer (and its compiled step) on batches of the same signature."""
    jtr = jtr or JTrainer(jm, opt, spec=JSpec(**spec), loss_fn=loss_fn)
    state = jtr.init(jax.random.PRNGKey(0), params=jp)
    losses = []
    for b in batches:
        state, m = jtr.step(state, b)
        losses.append(float(m['loss']))
    return jtr, state, losses, cases.flat(jtr.get_params(state))


def _assert_flat_close(got, want, **tol):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


# -- the global masked mean, and grad_accum, at gloo world 2 ----------------
@pytest.fixture(scope='module')
def world2():
    """Eleven cases in one gloo group of 2 processes, each against the JAX
    Trainer at dp = 2 on the same global batches, each with an eval
    batch: the uneven mask of the ROADMAP's input
    (``TransformerConfig.tiny``, batch 4 x 32 from RandomState(0), rows
    0-1 masked from column 4, 3 steps) under adamw(1e-3) and under
    sgd(0.1); the all-ones control under adamw(1e-3); grad_accum=2 on a
    batch of 8 with the uneven mask under sgd(0.1); and the MoE model
    (``moe_experts=4, moe_aux_coef=1.0``) without a mask and with the
    uneven one under sgd(0.1), with it under adamw(1e-3), at
    grad_accum=2 under sgd(0.1), and with it under remat=True and
    sgd(0.1); and a user ``loss_fn`` of the masked mean on the uneven
    mask under sgd(0.1), returning ``(sum, count)`` and returning the
    rank's scalar mean, both against the JAX ``loss_fn`` of the global
    masked mean (the pair case's ``evaluate`` with a pair metric)."""
    models = {kind: JLM(JConfig.tiny(dtype=jnp.float32,
                                     **cases.lm_config(kind)))
              for kind in ('lm', 'moe', 'moe_remat')}
    inits = {kind: _init(jm) for kind, jm in models.items()}
    eval_batch = cases.lm_batch(seed=1, mask='uneven')
    adamw, sgd = ('adamw', 1e-3), ('sgd', 0.1)
    uneven = [cases.lm_batch(mask='uneven')] * 3
    accum = [cases.lm_batch(b=8, mask='uneven')] * 2
    specs = {
        'uneven': ('lm', uneven, dict(dp=2), adamw),
        'uneven_sgd': ('lm', uneven, dict(dp=2), sgd),
        'ones': ('lm', [cases.lm_batch(mask='ones')] * 3, dict(dp=2),
                 adamw),
        'accum_sgd': ('lm', accum, dict(dp=2, grad_accum=2), sgd),
        'moe_sgd': ('moe', [cases.lm_batch()] * 3, dict(dp=2), sgd),
        'moe_uneven_sgd': ('moe', uneven, dict(dp=2), sgd),
        'moe_uneven': ('moe', uneven, dict(dp=2), adamw),
        'moe_accum_sgd': ('moe', accum, dict(dp=2, grad_accum=2), sgd),
        'moe_remat_sgd': ('moe_remat', uneven, dict(dp=2), sgd),
        'pair_sgd': ('lm', uneven, dict(dp=2), sgd, 'pair'),
        'scalar_sgd': ('lm', uneven, dict(dp=2), sgd, 'scalar'),
    }
    runs, want, trainers = [], {}, {}
    for key, (kind, batches, spec, opt, *loss) in specs.items():
        loss = loss[0] if loss else None
        loss_fn = None if loss is None else _jax_masked_loss(models[kind])
        # one JAX trainer (one compile) per model, optimizer, spec, loss
        tkey = (kind, opt, tuple(sorted(spec.items())), loss is None)
        jtr, state, losses, params = _jax_train(
            models[kind], getattr(optax, opt[0])(opt[1]), inits[kind],
            batches, jtr=trainers.get(tkey), loss_fn=loss_fn, **spec)
        trainers[tkey] = jtr
        metrics = None if loss is None else (
            lambda p, b, f=loss_fn: {'masked_nll': f(p, b)})
        want[key] = (losses, params,
                     jtr.evaluate(state, [eval_batch], metrics_fn=metrics))
        kw = {} if loss is None else {'loss': loss}
        runs.append((key, 'torch_trainer_cases:train', dict(
            kind=kind, init=inits[kind], batches=batches, opt=opt,
            spec=spec, eval_batches=[eval_batch], **kw)))
    return run_group(2, runs), want


@pytest.mark.parametrize('key', ['uneven', 'uneven_sgd', 'ones',
                                 'accum_sgd'])
def test_gloo_dp2_masked_loss_matches_jax_trainer_dp2(world2, key):
    """The loss is the global masked mean: with ranks holding 8 and 64
    counted tokens, the mean of the ranks' means (the Trainer before
    this repair) read 5.51795 / 5.26735 / 5.10233 against the JAX
    5.52578 / 5.32525 / 5.16938, with params 6.0e-3 apart after 3 adamw
    steps and 3.8e-2 after 3 sgd steps. ``evaluate`` takes the same
    global mean. Under grad_accum each chunk is the JAX chunk: rank r
    holds the r-th dp-slice of each."""
    got, want = world2
    losses, params, eval_loss = want[key]
    tol = PARAMS_SGD if key.endswith('sgd') else PARAMS_ADAM
    for rank_out in got[key]:
        np.testing.assert_allclose(rank_out['losses'], losses, **LOSS)
        _assert_flat_close(rank_out['params'], params, **tol)
        np.testing.assert_allclose(rank_out['eval'], eval_loss, **LOSS)


@pytest.mark.parametrize('key', ['moe_sgd', 'moe_uneven_sgd', 'moe_uneven',
                                 'moe_accum_sgd', 'moe_remat_sgd'])
def test_gloo_dp2_moe_matches_jax_trainer_dp2(world2, key):
    """The MoE load-balance loss at dp = 2 is the JAX package's: a product
    of two global-batch means, with the ranks' first-choice fractions
    averaged over the group in the model, in every loss the Trainer
    takes (plain mean, global masked mean, each grad_accum chunk,
    ``evaluate``), and in the backward's recompute under per-block remat
    (``moe_remat_sgd``). Averaging each rank's own aux instead (each rank's
    fractions its own) read 8.99818 / 10.07484 / 12.74832 against the JAX
    8.89599 / 10.26176 / 11.63206 without a mask under sgd, and failed
    every case here."""
    test_gloo_dp2_masked_loss_matches_jax_trainer_dp2(world2, key)


def test_gloo_dp2_pair_loss_fn_is_the_global_masked_mean(world2):
    """A user ``loss_fn`` returning ``(sum, count)`` is the global
    batch's loss, as the JAX ``loss_fn`` under GSPMD: the count is
    all-reduced, each rank differentiates its sum over it, the
    gradients are summed. Within 5.5e-7 relative of the JAX losses on
    the ROADMAP's input (the built-in masked mean's tolerance); a scalar
    ``loss_fn`` there read 5.517948 / 5.250590 / 4.947073 against the
    JAX 5.525783 / 5.305741 / 5.225269. ``evaluate`` takes the pair
    form for the loss and for a metric."""
    got, want = world2
    losses, params, eval_out = want['pair_sgd']
    for rank_out in got['pair_sgd']:
        np.testing.assert_allclose(rank_out['losses'], losses, rtol=5.5e-7,
                                   atol=0)
        _assert_flat_close(rank_out['params'], params, **PARAMS_SGD)
        assert set(rank_out['eval']) == {'loss', 'masked_nll'}
        for name in ('loss', 'masked_nll'):
            np.testing.assert_allclose(rank_out['eval'][name],
                                       eval_out[name], **LOSS)
        assert not rank_out['warned']


def test_gloo_dp2_scalar_loss_fn_stays_per_rank_and_warns(world2):
    """A scalar ``loss_fn`` stays the mean of the ranks' losses (a
    difference from the JAX package, kept: an exact global value needs
    the global batch on every rank): the fault's numbers, and a warning
    logged once, on every rank."""
    got, want = world2
    losses = want['scalar_sgd'][0]
    np.testing.assert_allclose(losses, [5.525783, 5.305741, 5.225269],
                               rtol=1e-6)
    for rank_out in got['scalar_sgd']:
        np.testing.assert_allclose(rank_out['losses'],
                                   [5.517948, 5.250590, 4.947073],
                                   rtol=1e-6)
        assert rank_out['warned']


# -- grad_accum and remat at dp = 1 ------------------------------------------
def test_grad_accum_masked_matches_jax():
    """Each chunk's loss is its own masked mean and the chunks are
    averaged, as the JAX step scans them."""
    jm = _jax_lm()
    jp = _init(jm)
    batches = [cases.lm_batch(b=8, mask='uneven')] * 2
    _, _, losses, params = _jax_train(jm, optax.adamw(1e-3), jp, batches,
                                      dp=1, grad_accum=4)
    got = cases.train(0, 1, 'lm', jp, batches, opt=('adamw', 1e-3),
                      spec=dict(grad_accum=4))
    np.testing.assert_allclose(got['losses'], losses, **LOSS)
    _assert_flat_close(got['params'], params, **PARAMS_ADAM)


def test_small_resnet_grad_accum_keeps_last_chunk_ema():
    """ResNet((1, 1)) under grad_accum=2 and remat='full': gradients
    averaged over the chunks, the BatchNorm EMAs advanced once, from the
    last chunk (each chunk's EMA starts from the pre-step state), as in
    the JAX step; the recompute in the backward records nothing."""
    remat = 'full'
    jm = jv.ResNet((1, 1), num_classes=10)
    jp = _init(jm)
    batches = [cases.images_batch(seed=i) for i in range(2)]
    _, _, losses, params = _jax_train(
        jm, optax.sgd(0.1, momentum=0.9), jp, batches, dp=1, grad_accum=2,
        remat=remat)
    got = cases.train(0, 1, 'resnet', jp, batches, opt=('sgd', 0.1),
                      momentum=0.9, spec=dict(grad_accum=2, remat=remat))
    np.testing.assert_allclose(got['losses'], losses, **LOSS)
    _assert_flat_close(got['params'], params, **PARAMS_RESNET)


def test_remat_full_matches_jax_and_is_bitwise_the_plain_step():
    jm = _jax_lm()
    jp = _init(jm)
    batches = [cases.lm_batch(mask='uneven')] * 2
    _, _, losses, params = _jax_train(jm, optax.adamw(1e-3), jp, batches,
                                      dp=1, remat='full')
    full = cases.train(0, 1, 'lm', jp, batches, opt=('adamw', 1e-3),
                       spec=dict(remat='full'))
    plain = cases.train(0, 1, 'lm', jp, batches, opt=('adamw', 1e-3))
    np.testing.assert_allclose(full['losses'], losses, **LOSS)
    _assert_flat_close(full['params'], params, **PARAMS_ADAM)
    assert full['losses'] == plain['losses']
    _assert_flat_close(full['params'], plain['params'], atol=0, rtol=0)


def test_grad_accum_rejects_indivisible_batch():
    tr = cases.make_trainer('lm', spec=dict(grad_accum=3))
    state = tr.init(seed=0)
    with pytest.raises(ValueError, match='grad_accum'):
        tr.step(state, cases.lm_batch(b=8))


# -- fit / evaluate / profile --------------------------------------------------
def _accuracy_jax(jm):
    def acc(params, b):
        logits = jm.apply(params, jnp.asarray(b['tokens']))
        hit = jnp.argmax(logits, -1) == jnp.asarray(b['targets'])
        return {'accuracy': jnp.mean(hit.astype(jnp.float32))}
    return acc


def _accuracy_port(model):
    def acc(params, b):
        logits = model.apply(params, b['tokens'])
        hit = torch.argmax(logits, -1) == b['targets'].long()
        return {'accuracy': hit.float().mean()}
    return acc


def test_fit_and_evaluate_match_jax(tmp_path):
    """fit over 5 batches with eval every 2 steps, checkpoints every 2
    and prefetch 2: the same history as the JAX Trainer's fit (eval at
    steps 2, 4 and 5; saves at 2, 4 and 5), and evaluate with a
    metrics_fn returns the same means."""
    jm = _jax_lm()
    jp = _init(jm)
    data = [cases.lm_batch(seed=i) for i in range(5)]
    eval_data = [cases.lm_batch(seed=10), cases.lm_batch(seed=11)]
    jtr = JTrainer(jm, optax.adam(1e-3), spec=JSpec(dp=1))
    jstate = jtr.init(jax.random.PRNGKey(0), params=jp)
    jstate, jhist = jtr.fit(jstate, iter(data), eval_data=eval_data,
                            eval_every=2, prefetch=2, save_every=2,
                            checkpoint_manager=JManager(
                                str(tmp_path / 'jax'), max_to_keep=2))
    tr = cases.make_trainer('lm')
    state = tr.init(params=jp)
    mgr = CheckpointManager(str(tmp_path / 'port'), max_to_keep=2)
    state, hist = tr.fit(state, iter(data), eval_data=eval_data,
                         eval_every=2, prefetch=2, save_every=2,
                         checkpoint_manager=mgr)
    np.testing.assert_allclose(hist['loss'], jhist['loss'], **LOSS)
    assert [s for s, _ in hist['eval_loss']] == [2, 4, 5]
    np.testing.assert_allclose([v for _, v in hist['eval_loss']],
                               [v for _, v in jhist['eval_loss']], **LOSS)
    assert mgr.all_steps() == [4, 5] and state.step == 5
    # steps= caps the iterator
    state, hist2 = tr.fit(state, iter(data), steps=2)
    jstate, jhist2 = jtr.fit(jstate, iter(data), steps=2)
    np.testing.assert_allclose(hist2['loss'], jhist2['loss'], **LOSS)
    out = tr.evaluate(state, eval_data, metrics_fn=_accuracy_port(tr.model))
    want = jtr.evaluate(jstate, eval_data, metrics_fn=_accuracy_jax(jm))
    assert set(out) == {'loss', 'accuracy'}
    np.testing.assert_allclose(out['loss'], want['loss'], **LOSS)
    np.testing.assert_allclose(out['accuracy'], want['accuracy'], atol=1e-7)
    assert isinstance(tr.evaluate(state, eval_data), float)


def _snapshot(tr, state):
    opt = state.opt_state
    return ([t.detach().clone() for t in tr.model.parameters()],
            [t.detach().clone() for t in tr.model.buffers()],
            {id(p): {k: v.clone() for k, v in opt.state[p].items()}
             for p in tr.model.parameters() if opt.state[p]}, state.step)


def test_profile_writes_trace_and_leaves_state_bitwise(tmp_path):
    """Adam slots and BatchNorm buffers included: after profile, the
    params, buffers, optimizer state and step are the bits they were,
    and the next step is the step that would have come without it."""
    batches = [cases.images_batch(seed=i) for i in range(2)]
    runs = []
    for profiled in (False, True):
        tr = cases.make_trainer('resnet')
        state = tr.init(seed=0)
        tr.step(state, batches[0])
        if profiled:
            before = _snapshot(tr, state)
            out = tr.profile(state, batches[1], str(tmp_path / 'tr'),
                             steps=2)
            after = _snapshot(tr, state)
            assert out == str(tmp_path / 'tr')
            assert glob.glob(os.path.join(out, '*.pt.trace.json'))
            for a, b in zip(before[0] + before[1], after[0] + after[1]):
                assert torch.equal(a, b)
            assert before[2].keys() == after[2].keys() and before[2]
            for k in before[2]:
                for name in before[2][k]:
                    assert torch.equal(before[2][k][name],
                                       after[2][k][name]), name
            assert before[3] == after[3] == 1
        tr.step(state, batches[1])
        runs.append(cases.flat(tr.get_params(state)))
    _assert_flat_close(runs[1], runs[0], atol=0, rtol=0)


# -- ParallelSpec, placement, prefetch -----------------------------------------
def test_parallel_spec_serializes_like_jax():
    spec = ParallelSpec(dp=2, grad_accum=4, remat='full')
    assert ParallelSpec.from_dict(spec.to_dict()) == spec
    # a JAX spec's dict: the port has every field
    jd = JSpec(dp=2, grad_accum=4, remat='full').to_dict()
    assert ParallelSpec.from_dict(jd) == spec
    assert set(spec.to_dict()) <= set(jd)
    assert ParallelSpec.from_dict({'dp': 1}) == ParallelSpec(dp=1)
    with pytest.raises(ValueError, match='remat'):
        ParallelSpec(remat='dots')


def test_shard_batch_takes_each_chunks_dp_slice_and_passes_placed():
    """Under grad_accum, rank r holds the r-th dp-slice of every chunk
    (the JAX chunk i is global rows [i B/accum, (i+1) B/accum), split
    over dp); a tensor already on the device passes through."""
    tr = cases.make_trainer('lm', spec=dict(grad_accum=2))
    tr.dp, tr.rank = 2, 1     # as rank 1 of a world of 2
    x = np.arange(8)[:, None] * np.ones((1, 3), np.int32)
    got = tr.shard_batch({'x': x})['x']
    assert got[:, 0].tolist() == [2, 3, 6, 7]
    placed = torch.zeros(3)
    assert tr.shard_batch({'x': placed})['x'] is placed
    tr.accum = 1
    assert tr.shard_batch({'x': x})['x'][:, 0].tolist() == [4, 5, 6, 7]


def test_prefetch_keeps_order_and_defers_errors():
    placed = []

    def place(b):
        placed.append(b)
        return b * 10

    it = prefetch_to_device(iter(range(5)), place, size=2)
    assert next(it) == 0 and placed == [0, 1, 2]   # 2 in flight
    assert list(it) == [10, 20, 30, 40]

    def source():
        yield 1
        yield 2
        raise RuntimeError('source broke')

    it = prefetch_to_device(source(), lambda b: b, size=3)
    assert next(it) == 1 and next(it) == 2     # placed batches first
    with pytest.raises(RuntimeError, match='source broke'):
        next(it)
    with pytest.raises(ValueError):
        next(prefetch_to_device([], lambda b: b, size=0))
