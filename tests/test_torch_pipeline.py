"""Pipeline parallelism of the port against the JAX package, on the CPU.

Every port case runs in one gloo group of 4 processes
(``torch_dsl_worlds.run_group``), the port's programs in the jax-free
``tests/torch_pp_cases.py`` and ``torch_trainer_cases.train``; the JAX
``Trainer`` runs at the same ``ParallelSpec`` on 8 CPU devices in a pool
of processes beside it (each JAX pipeline compiles for about 10 s, so
they run side by side while the gloo group trains).

- Trainer level: ``TransformerConfig.tiny(n_layers=4)`` in f32 from the
  JAX init, 3 steps on batch 4 x 32 with the uneven mask (batch 8 under
  grad_accum), against the JAX ``Trainer`` at the same spec: GPipe at pp
  2 x tp 2 (M 4); 1F1B remat and stash at pp 2 x tp 2 (M 4) and at pp 4
  with M 2 (ragged, M < pp); the legacy variant; the MoE model (4
  experts, aux weight 1.0, 2 layers) at pp 2, M 1 through GPipe and both
  1F1B variants, and at pp 2 x ep 2 (auto); grad_accum 2 (auto), ZeRO 3
  and ZeRO 2 with remat='full' at pp 2 x dp 2; the untied head with
  loss_chunk 16 under the 'save_attn' block remat (GPipe); pp 2 x sp 2
  (1F1B) against the JAX Trainer at sp 2, pp 1 (the JAX Trainer at pp 2
  x sp 2 gives a first loss 7e-4 relative off its own pp 1 run under
  GPipe and does not finish under 1F1B, so its pp 1 run is the
  reference); ``evaluate`` after the GPipe and 1F1B stash steps at pp 2
  x tp 2, and with a ``metrics_fn`` on ``model.apply``'s logits (top-1
  accuracy, a scalar, and the token NLL, a (sum, count) pair) after
  the GPipe steps at pp 2 x tp 2 (the logits gathered over the vocab
  shards) and the ZeRO 3 (GPipe) and grad_accum (1F1B) steps at pp 2 x
  dp 2: only the last stage's logits count (accuracy within 1e-7). Losses within 1e-5 relative; params within 2e-6 under
  sgd(0.1), an update linear in the gradient, so this holds every
  gradient (``tests/test_torch_tensor_parallel.py``'s tolerances).
- 1F1B called directly without a head (the JAX
  ``test_fused_1f1b_direct_no_head``): over 4 stages, the gradients of
  each stage's layers, of the tail params and of x against the plain
  composition on one process, remat, stash and legacy (a closure-style
  tail), within 1e-6.
- Memory: the bytes of live saved tensors on each rank
  (``saved_tensors_hooks``; the JAX test reads the compiled temp bytes)
  at pp 4 on batch 32 x 128, vocab 4096: 1F1B remat at M 16 below half of
  GPipe's, and at most 1.15x its own M 8 figure; stash below GPipe.
- Checkpoints: a port ``save_state`` at pp 2, dp 2 (after 2 adam(1e-3)
  steps) is restored by the JAX trainer at pp 1 and by the port at pp 1:
  the restored leaves are the saved bits, and the next step agrees with
  the port's (losses 1e-5 relative, params 1e-4, a tenth of the lr).
- Refusals: ``n_layers`` that pp does not divide raises ``ValueError`` in
  both packages, and so do unstacked layers (``scan_layers=False``, the
  same text); a batch that M does not divide raises (the JAX schedule
  asserts, the port raises ``ValueError``); the fused mode's refusals.
"""
import concurrent.futures
import multiprocessing
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_grid_cases as grid
import torch_pp_cases as pp_cases
import torch_trainer_cases as cases
from autodist_tpu.api import Trainer as JTrainer
from autodist_tpu.checkpoint.saver import CheckpointManager as JManager
from autodist_tpu.checkpoint.saver import _leaf_paths as j_leaf_paths
from autodist_tpu.models.transformer import TransformerConfig as JConfig
from autodist_tpu.models.transformer import TransformerLM as JLM
from autodist_tpu.parallel.axes import ParallelSpec as JSpec
from torch_dsl_worlds import run_group

LOSS = dict(rtol=1e-5, atol=0)
PARAMS = {'sgd': dict(atol=2e-6, rtol=0), 'ckpt': dict(atol=1e-4, rtol=0)}
OPTS = {'sgd': ('sgd', 0.1), 'ckpt': ('adam', 1e-3)}
FN_TOL = 1e-6


def _pp(pp, M, schedule='gpipe', variant='auto', **kw):
    return dict(pp=pp, microbatches=M, pp_schedule=schedule,
                pp_variant=variant, **kw)


# key -> (model kind, port spec, JAX spec (None: the port's), batch rows)
TRAINER_CASES = {
    'gpipe_tp2': ('lm4', _pp(2, 4, tp=2, dp=1), None, 4),
    '1f1b_remat_tp2': ('lm4', _pp(2, 4, '1f1b', 'remat', tp=2, dp=1), None,
                       4),
    '1f1b_stash_tp2': ('lm4', _pp(2, 4, '1f1b', 'stash', tp=2, dp=1), None,
                       4),
    '1f1b_remat_ragged': ('lm4', _pp(4, 2, '1f1b', 'remat', dp=1), None, 4),
    '1f1b_stash_ragged': ('lm4', _pp(4, 2, '1f1b', 'stash', dp=1), None, 4),
    '1f1b_legacy': ('lm4', _pp(2, 2, '1f1b', 'legacy', dp=2), None, 4),
    'moe_gpipe': ('moe', _pp(2, 1, dp=2), None, 4),
    'moe_1f1b_remat': ('moe', _pp(2, 1, '1f1b', 'remat', dp=2), None, 4),
    'moe_1f1b_stash': ('moe', _pp(2, 1, '1f1b', 'stash', dp=2), None, 4),
    'moe_ep2': ('moe', _pp(2, 1, '1f1b', ep=2, dp=1), None, 4),
    'accum2_dp2': ('lm4', _pp(2, 2, '1f1b', dp=2, grad_accum=2), None, 8),
    'zero3_dp2': ('lm4', _pp(2, 2, dp=2, zero=3), None, 4),
    'zero2_remat_full_dp2': ('lm4', _pp(2, 2, dp=2, zero=2, remat='full'),
                             None, 4),
    'options_tp2': ('lm4_untied_chunk_save_attn', _pp(2, 2, tp=2, dp=1),
                    None, 4),
    'sp2_1f1b': ('lm4', _pp(2, 2, '1f1b', sp=2, dp=1), dict(sp=2, dp=1), 4),
}
MOE_KINDS = ('moe',)
DIRECT = ('remat', 'stash', 'legacy')
# the cases that also run ``evaluate`` after their steps (the schedules'
# forward without a graph): key -> its metrics ('logits':
# ``torch_trainer_cases.logit_metrics``, the JAX ``_logit_metrics``)
EVAL_CASES = {'gpipe_tp2': 'logits', '1f1b_stash_tp2': None,
              'zero3_dp2': 'logits', 'accum2_dp2': 'logits'}
# key -> (TransformerConfig.tiny keywords, spec): a step that raises
STEP_REFUSALS = {'batch3': ({}, dict(pp=2, microbatches=3)),
                 'no_scan': (dict(scan_layers=False), dict(pp=2))}
JAX_WORKERS = 4
# (dp, pp, sp, ep, tp) grids of 4 ranks whose layout is checked
GRIDS = [(1, 2, 1, 1, 2), (2, 2, 1, 1, 1), (1, 4, 1, 1, 1), (1, 2, 2, 1, 1),
         (2, 1, 1, 1, 2)]


def _batches(rows):
    return [cases.lm_batch(b=rows, mask='uneven')] * 3


def _evals(key):
    """The eval batches of a case that also runs ``evaluate``."""
    return [cases.lm_batch(seed=7, mask='uneven')] \
        if key in EVAL_CASES else None


def _logit_metrics(jm):
    """The JAX twin of ``torch_trainer_cases.logit_metrics`` (the NLL as
    the batch's mean, which the port's pair gives)."""
    def metrics_fn(params, batch):
        logits = jm.apply(params, batch['tokens'])
        targets = batch['targets']
        hit = jnp.argmax(logits, -1) == targets
        nll = -jnp.take_along_axis(jax.nn.log_softmax(logits),
                                   targets[..., None], -1)
        return {'accuracy': jnp.mean(hit.astype(jnp.float32)),
                'nll': jnp.mean(nll)}
    return metrics_fn


def _init(kind):
    return jax.tree.map(np.asarray, JLM(JConfig.tiny(
        dtype=jnp.float32, **cases.lm_config(kind))).init(
            jax.random.PRNGKey(0)))


def _jax_trainer(kind, spec, opt):
    jm = JLM(JConfig.tiny(dtype=jnp.float32, **cases.lm_config(kind)))
    name, lr = OPTS[opt]
    return JTrainer(jm, getattr(optax, name)(lr), spec=JSpec(**spec))


def _jax_leaves(state):
    flat, _ = j_leaf_paths(state)
    return {n: np.asarray(v) for n, v in flat}


def _jax_cpu():
    """A pool process's JAX: the CPU, 8 devices (``tests/conftest.py``)."""
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_num_cpu_devices', 8)


def _jax_refusals():
    """The JAX Trainer's exception types: ``n_layers`` 3 at pp 2 (at
    ``init``), and ``STEP_REFUSALS`` (at the step)."""
    out = {}
    jtr = JTrainer(JLM(JConfig.tiny(n_layers=3, dtype=jnp.float32)),
                   optax.sgd(0.1), spec=JSpec(pp=2, dp=1))
    try:
        jtr.init(jax.random.PRNGKey(0))
    except Exception as e:  # noqa: BLE001 - the test reads its type
        out['layers3'] = (type(e).__name__, str(e))
    for key, (config, spec) in STEP_REFUSALS.items():
        jtr = JTrainer(JLM(JConfig.tiny(dtype=jnp.float32, **config)),
                       optax.sgd(0.1), spec=JSpec(dp=1, **spec))
        state = jtr.init(jax.random.PRNGKey(0))
        try:
            jtr.step(state, cases.lm_batch())
        except Exception as e:  # noqa: BLE001 - the test reads its type
            out[key] = (type(e).__name__, str(e))
    return out


def _jax_case(kind, spec, init, batches, eval_batches=None, metrics=None):
    """(losses, flat params, ``evaluate``'s result or None) of the JAX
    Trainer's sgd steps."""
    jtr = _jax_trainer(kind, spec, 'sgd')
    state = jtr.init(jax.random.PRNGKey(0), params=init)
    losses = []
    for b in batches:
        state, m = jtr.step(state, b)
        losses.append(float(m['loss']))
    metrics_fn = _logit_metrics(jtr.model) if metrics == 'logits' else None
    evaluated = None if eval_batches is None else \
        jtr.evaluate(state, eval_batches, metrics_fn=metrics_fn)
    return losses, cases.flat(jax.tree.map(np.asarray,
                                           jtr.get_params(state))), evaluated


@pytest.fixture(scope='module')
def world4(tmp_path_factory):
    """Every port case in one gloo group of 4, beside the JAX values."""
    kinds = {kind for kind, _, _, _ in TRAINER_CASES.values()}
    inits = {kind: _init(kind) for kind in kinds}
    runs = [('direct_%s' % v, 'torch_pp_cases:direct',
             dict(variant=v, microbatches=4)) for v in DIRECT]
    runs += [('memory_%s_%s_%d' % c, 'torch_pp_cases:memory',
              dict(schedule=c[0], variant=c[1], microbatches=c[2]))
             for c in (('gpipe', 'remat', 16), ('1f1b', 'remat', 16),
                       ('1f1b', 'remat', 8), ('1f1b', 'stash', 16))]
    runs += [('layers3', 'torch_pp_cases:indivisible_layers', {})]
    runs += [(key, 'torch_pp_cases:step_refusal', dict(
        config=config, spec=dict(spec, dp=2)))
        for key, (config, spec) in STEP_REFUSALS.items()]
    runs += [('grid_%d%d%d%d%d' % g, 'torch_tp_cases:grid_layout',
              dict(zip(('dp', 'pp', 'sp', 'ep', 'tp'), g))) for g in GRIDS]
    for key, (kind, spec, _, rows) in TRAINER_CASES.items():
        runs.append((key, 'torch_trainer_cases:train', dict(
            kind=kind, init=inits[kind], batches=_batches(rows),
            opt=OPTS['sgd'], spec=spec, eval_batches=_evals(key),
            metrics=EVAL_CASES.get(key))))
    # a port checkpoint at pp 2, dp 2, restored by JAX at pp 1 and by the
    # port at pp 1
    ckpt = [cases.lm_batch(seed=i) for i in range(3)]
    port_dir = str(tmp_path_factory.mktemp('port_pp2'))
    runs.append(('save', 'torch_grid_cases:save_then_step', dict(
        init=inits['lm4'], batches=ckpt, path=port_dir, opt=OPTS['ckpt'],
        spec=_pp(2, 2, '1f1b', dp=2), kind='lm4')))

    got = {}
    port = threading.Thread(target=lambda: got.update(run_group(4, runs)))
    port.start()
    want = {}
    try:
        with concurrent.futures.ProcessPoolExecutor(
                JAX_WORKERS, mp_context=multiprocessing.get_context('spawn'),
                initializer=_jax_cpu) as pool:
            futures = {key: pool.submit(_jax_case, kind, jspec or spec,
                                        inits[kind], _batches(rows),
                                        _evals(key), EVAL_CASES.get(key))
                       for key, (kind, spec, jspec, rows)
                       in TRAINER_CASES.items()}
            futures['refusals'] = pool.submit(_jax_refusals)
            want.update({k: f.result() for k, f in futures.items()})
    finally:
        port.join()
    assert got, 'the gloo group returned nothing'
    jtr = _jax_trainer('lm4', dict(dp=1), 'ckpt')
    template = jtr.init(jax.random.PRNGKey(1), params=jax.tree.map(
        np.zeros_like, inits['lm4']))
    jstate, step = jtr.restore_state(JManager(port_dir), template)
    restored = _jax_leaves(jstate)
    jstate, m = jtr.step(jstate, ckpt[-1])
    want['save_jax'] = (restored, step, float(m['loss']),
                        cases.flat(jtr.get_params(jstate)))
    want['save_port'] = grid.restore_then_step(
        0, 1, path=port_dir, batch=ckpt[-1], opt=OPTS['ckpt'], spec={},
        kind='lm4')
    want['inits'] = inits
    return got, want


@pytest.mark.parametrize(
    'sizes', GRIDS, ids=lambda g: 'dp%d_pp%d_sp%d_ep%d_tp%d' % g)
def test_rank_grid_lays_the_pipe_axis_in_the_jax_mesh_order(world4, sizes):
    """r = ((((d·pp + p)·sp + s)·ep + e)·tp + t), as the JAX mesh of (data,
    pipe, seq, expert, model) orders its devices; the pipe group holds
    the ranks that share the other coordinates (its positions the
    stages), and a leaf the stages share reduces over data x pipe x
    seq. At pp 1 that group and the (pipe, seq) group are the batch and
    seq groups themselves, so no second communicator spans their
    ranks."""
    got, _ = world4
    dp, pp, sp, ep, tp = sizes
    mesh = JSpec(dp=dp, pp=pp, sp=sp, ep=ep, tp=tp).build_mesh(
        jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    for r, rank in enumerate(got['grid_%d%d%d%d%d' % sizes]):
        idx = rank['coords']
        assert ids[idx] == r
        assert rank['shape'] == dict(mesh.shape)

        def along(*axes):
            return sorted(int(ids[i]) for i in np.ndindex(ids.shape)
                          if all(i[a] == idx[a] for a in range(5)
                                 if a not in axes))
        assert rank['groups']['pipe'] == along(1)
        assert rank['groups']['data'] == along(0)
        assert rank['groups']['model'] == along(4)
        assert rank['groups']['batch'] == along(0, 2)
        assert rank['parts'] == along(0, 1, 2)
        assert rank['shared'] == (pp == 1, pp == 1)


@pytest.mark.parametrize('key', list(TRAINER_CASES))
def test_pipeline_trainer_matches_jax_trainer(world4, key):
    got, want = world4
    losses, params, evaluated = want[key]
    for r, rank in enumerate(got[key]):
        np.testing.assert_allclose(rank['losses'], losses, err_msg=str(r),
                                   **LOSS)
        if EVAL_CASES.get(key) == 'logits':
            assert set(rank['eval']) == {'loss', 'accuracy', 'nll'}
            np.testing.assert_allclose(rank['eval']['accuracy'],
                                       evaluated['accuracy'], rtol=0,
                                       atol=1e-7, err_msg=str(r))
            for name in ('loss', 'nll'):
                np.testing.assert_allclose(rank['eval'][name],
                                           evaluated[name], err_msg=str(r),
                                           **LOSS)
        elif key in EVAL_CASES:
            np.testing.assert_allclose(rank['eval'], evaluated, **LOSS)
        assert rank['params'].keys() == params.keys()
        for k in params:
            np.testing.assert_allclose(rank['params'][k], params[k],
                                       err_msg='%s rank %d' % (k, r),
                                       **PARAMS['sgd'])
    kind = TRAINER_CASES[key][0]
    if kind in MOE_KINDS:
        # the router's gradient moved it (sgd holds it to 2e-6 above)
        router = 'blocks/mlp/router/kernel'
        assert np.max(np.abs(params[router] - cases.flat(
            want['inits'][kind])[router])) > 1e-4


@pytest.mark.parametrize('variant', DIRECT)
def test_fused_1f1b_direct_no_head(world4, variant):
    """1F1B without a head (a float x enters the pipe, the loss folds
    into the tail), fused (remat, stash) and legacy (the tail closes over
    its params): each stage's layers' gradients, the tail params' (the
    last stage's) and x's (the first stage's) equal the plain
    composition's, so the cotangents are scaled exactly once."""
    got, _ = world4
    ranks = got['direct_' + variant]
    want = pp_cases.direct_reference(len(ranks), 4)
    np.testing.assert_allclose(sum(r['loss'] for r in ranks), want['loss'],
                               rtol=1e-5)
    np.testing.assert_allclose(np.stack([r['w'] for r in ranks]),
                               want['w'], rtol=0, atol=FN_TOL)
    np.testing.assert_allclose(ranks[-1]['out'], want['out'], rtol=0,
                               atol=FN_TOL)
    np.testing.assert_allclose(ranks[0]['x'], want['x'], rtol=0, atol=FN_TOL)
    assert all(r['x'] is None for r in ranks[1:])
    assert all(not np.any(r['out']) for r in ranks[:-1])


def test_1f1b_bounds_live_activations_by_the_pipe_depth(world4):
    """At pp 4, M 16 on every rank: 1F1B remat holds less than half of
    GPipe's saved bytes, at most 1.15x its own figure at M 8 (the bound
    is the pipe depth, not M), and the stash variant (one boundary
    activation a microbatch) stays below GPipe; nothing is left after
    the step. The four runs train the same loss."""
    got, _ = world4
    gpipe = got['memory_gpipe_remat_16']
    remat = got['memory_1f1b_remat_16']
    remat8 = got['memory_1f1b_remat_8']
    stash = got['memory_1f1b_stash_16']
    for r in range(len(gpipe)):
        g = gpipe[r]['peak']
        assert remat[r]['peak'] < 0.5 * g, (r, remat[r]['peak'], g)
        assert remat[r]['peak'] <= 1.15 * remat8[r]['peak'], \
            (r, remat[r]['peak'], remat8[r]['peak'])
        assert stash[r]['peak'] < g, (r, stash[r]['peak'], g)
        for run in (gpipe, remat, remat8, stash):
            assert run[r]['left'] == 0
            np.testing.assert_allclose(run[r]['loss'], gpipe[0]['loss'],
                                       **LOSS)


def test_port_pp2_checkpoint_restores_in_jax_and_in_the_port_at_pp1(world4):
    got, want = world4
    rank0 = got['save'][0]
    restored, step, loss, params = want['save_jax']
    assert step == 2
    assert restored.keys() == rank0['tree'].keys()
    for k in restored:
        np.testing.assert_array_equal(restored[k], rank0['tree'][k],
                                      err_msg=k)
    port = want['save_port']
    assert port['step'] == 2
    for k in rank0['tree']:
        np.testing.assert_array_equal(port['tree'][k], rank0['tree'][k],
                                      err_msg=k)
    for other in (loss, port['loss']):
        np.testing.assert_allclose(rank0['loss'], other, **LOSS)
    for k in params:
        for other in (params[k], port['params'][k]):
            np.testing.assert_allclose(rank0['params'][k], other,
                                       err_msg=k, **PARAMS['ckpt'])


def test_indivisible_layers_raise_in_both_packages(world4):
    """``n_layers`` 3 at pp 2: the JAX ``Trainer`` raises ``ValueError``
    at ``init``, the port's when it lays the stacked blocks out."""
    got, want = world4
    assert want['refusals']['layers3'][0] == 'ValueError'
    for rank in got['layers3']:
        assert rank['raised'] == 'ValueError'
        assert "'pipe' axis" in rank['message'] and 'blocks/' in \
            rank['message']


def test_indivisible_batch_raises_in_both_packages(world4):
    """3 microbatches of a batch of 4: the JAX schedule asserts, the
    port's raises ``ValueError``."""
    got, want = world4
    raised, message = want['refusals']['batch3']
    assert raised == 'AssertionError' and 'not divisible' in message
    for rank in got['batch3']:
        assert rank['raised'] == 'ValueError'
        assert 'not divisible by microbatches 3' in rank['message']


def test_unstacked_layers_raise_the_jax_error(world4):
    """``scan_layers=False`` at pp 2: both packages raise the JAX
    ``ValueError`` at the step (the blocks must be stage-stacked)."""
    got, want = world4
    raised, message = want['refusals']['no_scan']
    assert raised == 'ValueError'
    for rank in got['no_scan']:
        assert rank['raised'] == raised and rank['message'] in message


def test_fused_refusals_match_the_jax_schedule():
    """The fused mode refuses a floating ``extra``, a closure-style tail
    beside head params, a head without head params and an unknown
    variant, as the JAX ``one_f_one_b`` does (before any stage talks to
    another)."""
    from autodist_tpu_torch.parallel import pipeline
    from autodist_tpu_torch.parallel.mesh import ReplicaGroup
    group = ReplicaGroup(2, 0)
    x = torch.zeros(4, 8)
    stack = {'w': torch.zeros(1, 8, 8)}

    def call(**kw):
        return pipeline.one_f_one_b(pp_cases.block_fn, stack, x, group, 2,
                                    **kw)
    with pytest.raises(ValueError, match='floating-point'):
        call(tail_fn=pp_cases.tail_fn, extra=torch.zeros(4, 1),
             tail_params={'out': torch.zeros(8)})
    with pytest.raises(ValueError, match='closure-style'):
        call(tail_fn=lambda h, e: h, head_params={})
    with pytest.raises(ValueError, match='head_fn requires'):
        call(head_fn=lambda p, v: v)
    with pytest.raises(ValueError, match='unknown 1F1B variant'):
        call(tail_params={}, variant='zb')
    with pytest.raises(ValueError, match='not divisible by microbatches'):
        pipeline.one_f_one_b(pp_cases.block_fn, stack, x, group, 3)


def test_auto_stash_bytes_is_the_jax_rule():
    """'auto' stashes while M boundary activations fit
    ``AUTODIST_PP_STASH_LIMIT_MB``: the bytes are the JAX
    ``M * prod(head output shape) * itemsize``."""
    from autodist_tpu_torch.parallel.pipeline import stash_bytes
    assert stash_bytes((2, 4096, 768), torch.bfloat16, 4) == \
        4 * 2 * 4096 * 768 * 2
    assert stash_bytes((2, 32, 64), torch.float32, 16) == 16 * 2 * 32 * 64 * 4
