"""Sequence parallelism of the port against the JAX package, on the CPU.

Every port case runs in one gloo group of 4 processes
(``torch_dsl_worlds.run_group``); the JAX side runs under ``shard_map``
on the CPU devices ``tests/conftest.py`` sets up.

- Function level: ``ring_attention`` and ``ulysses_attention`` over a
  seq group of 4 against the JAX functions over a ``seq`` mesh axis of
  4, causal and not, on q, k, v [2, 4, 64, 16] from ``RandomState(0)``:
  the output within 1e-5 and the gradients of sum(out ** 2) within 1e-4
  (absolute), the tolerances of ``tests/test_functional_api.py``'s ring
  and Ulysses tests. Ulysses with 3 heads over 4 ranks raises the JAX
  ``ValueError``.
- Trainer level: ``TransformerConfig.tiny`` in f32 from the JAX init,
  3 steps on batch 4 x 32 with the uneven mask (rows 0-1 masked from
  column 4), against the JAX ``Trainer`` at the same spec: ring and
  Ulysses at sp 4 x dp 1 and at sp 2 x dp 2, under sgd(0.1) and under
  adam(1e-2); ring at sp 2 x dp 2 with grad_accum 2 and remat='full';
  and the MoE model (4 experts, aux weight 1.0) at sp 2 x dp 2, ring,
  and under per-block remat with Ulysses, under sgd(0.1): the MoE
  fractions reduce over the data group and the aux over the seq group.
  Losses within 1e-5 relative; params within 2e-6 absolute under sgd
  (an update linear in the gradient), the bound
  ``tests/test_torch_trainer_surface.py`` holds dp = 2 to, and under
  adam within a tenth of the learning rate, the rule that file's 1e-4
  at adamw(1e-3) follows: 1e-3 here. Adam moves an element by about lr
  whatever the size of its gradient, so a rounding-sized gradient moves
  by a rounding-dependent share of lr: after these 3 adam(1e-2) steps
  the JAX package's own dp 1 and sp 4 runs stand 2.3e-4 apart in
  blocks/mlp/up/kernel, and the port's dp 1 run 3.6e-4 from the JAX
  dp 1 run, with no collective.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import torch_grid_cases as grid
import torch_trainer_cases as cases
from autodist_tpu.api import Trainer as JTrainer
from autodist_tpu.models.transformer import TransformerConfig as JConfig
from autodist_tpu.models.transformer import TransformerLM as JLM
from autodist_tpu.parallel.axes import ParallelSpec as JSpec
from autodist_tpu.parallel.ring_attention import (
    local_flash_attention as j_local, ring_attention as j_ring)
from autodist_tpu.parallel.ulysses import ulysses_attention as j_ulysses
from autodist_tpu_torch.parallel.mesh import ReplicaGroup
from autodist_tpu_torch.parallel.ulysses import ulysses_attention
from torch_dsl_worlds import run_group

ATTN_SHAPE = (2, 4, 64, 16)
FWD_TOL = 1e-5
GRAD_TOL = 1e-4
LOSS = dict(rtol=1e-5, atol=0)
PARAMS = {'sgd': dict(atol=2e-6, rtol=0), 'adam': dict(atol=1e-3, rtol=0)}
OPTS = {'sgd': ('sgd', 0.1), 'adam': ('adam', 1e-2)}

# key -> (model kind, spec, optimizer)
TRAINER_CASES = {
    '%s_sp%d_dp%d_%s' % (mode, sp, dp, opt):
        ('lm', dict(sp=sp, dp=dp, sp_mode=mode), opt)
    for mode in ('ring', 'ulysses') for sp, dp in ((4, 1), (2, 2))
    for opt in ('sgd', 'adam')}
TRAINER_CASES.update({
    'ring_sp2_dp2_accum_remat_sgd': (
        'lm', dict(sp=2, dp=2, grad_accum=2, remat='full'), 'sgd'),
    'moe_ring_sp2_dp2_sgd': ('moe', dict(sp=2, dp=2), 'sgd'),
    'moe_remat_ulysses_sp2_dp2_sgd': (
        'moe_remat', dict(sp=2, dp=2, sp_mode='ulysses'), 'sgd'),
})
ATTN_CASES = [(mode, causal) for mode in ('ring', 'ulysses')
              for causal in (True, False)]


def _jax_attention(mode, causal):
    """The JAX function over a seq axis of 4: (out, grads of
    sum(out ** 2) with respect to q, k, v)."""
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(4), ('seq',))
    fn = j_ring if mode == 'ring' else j_ulysses
    mapped = jax.shard_map(
        lambda q, k, v: fn(q, k, v, 'seq', causal=causal), mesh=mesh,
        in_specs=(P(None, None, 'seq'),) * 3,
        out_specs=P(None, None, 'seq'))
    q, k, v = (jnp.asarray(x) for x in grid.qkv(ATTN_SHAPE, 0))
    out = jax.jit(mapped)(q, k, v)
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(jnp.square(mapped(*a))),
                             argnums=(0, 1, 2)))(q, k, v)
    ref = j_local(q, k, v, causal=causal)
    assert float(jnp.max(jnp.abs(out - ref))) < FWD_TOL
    return np.asarray(out), [np.asarray(g) for g in grads]


def _jax_train(kind, spec, opt, init, batches):
    jm = JLM(JConfig.tiny(dtype=jnp.float32, **cases.lm_config(kind)))
    name, lr = OPTS[opt]
    jtr = JTrainer(jm, getattr(optax, name)(lr), spec=JSpec(**spec))
    state = jtr.init(jax.random.PRNGKey(0), params=init)
    losses = []
    for b in batches:
        state, m = jtr.step(state, b)
        losses.append(float(m['loss']))
    return losses, cases.flat(jtr.get_params(state))


@pytest.fixture(scope='module')
def world4():
    """Every port case in one gloo group of 4, beside the JAX values."""
    inits = {kind: jax.tree.map(np.asarray, JLM(JConfig.tiny(
        dtype=jnp.float32, **cases.lm_config(kind))).init(
            jax.random.PRNGKey(0)))
        for kind in ('lm', 'moe', 'moe_remat')}
    batches = [cases.lm_batch(mask='uneven')] * 3
    runs, want = [], {}
    for mode, causal in ATTN_CASES:
        key = 'attn_%s_%s' % (mode, causal)
        runs.append((key, 'torch_grid_cases:attention', dict(
            mode=mode, shape=ATTN_SHAPE, seed=0, causal=causal)))
        want[key] = _jax_attention(mode, causal)
    for key, (kind, spec, opt) in TRAINER_CASES.items():
        runs.append((key, 'torch_trainer_cases:train', dict(
            kind=kind, init=inits[kind], batches=batches, opt=OPTS[opt],
            spec=spec)))
        want[key] = _jax_train(kind, spec, opt, inits[kind], batches)
    return run_group(4, runs), want


@pytest.mark.parametrize('mode,causal', ATTN_CASES)
def test_attention_matches_jax_over_a_seq_group_of_4(world4, mode, causal):
    got, want = world4
    ranks = got['attn_%s_%s' % (mode, causal)]
    out, grads = want['attn_%s_%s' % (mode, causal)]
    port_out = np.concatenate([r['out'] for r in ranks], axis=2)
    assert np.max(np.abs(port_out - out)) < FWD_TOL
    for i, g in enumerate(grads):
        port_g = np.concatenate([r['grads'][i] for r in ranks], axis=2)
        assert np.max(np.abs(port_g - g)) < GRAD_TOL, 'qkv'[i]


def test_ulysses_rejects_indivisible_heads():
    t = torch.zeros((1, 3, 8, 8))
    with pytest.raises(ValueError, match='heads'):
        ulysses_attention(t, t, t, ReplicaGroup(4, 0))


@pytest.mark.parametrize('key', list(TRAINER_CASES))
def test_trainer_matches_jax_trainer(world4, key):
    got, want = world4
    losses, params = want[key]
    opt = TRAINER_CASES[key][2]
    for r, rank in enumerate(got[key]):
        np.testing.assert_allclose(rank['losses'], losses, err_msg=str(r),
                                   **LOSS)
        assert rank['params'].keys() == params.keys()
        for k in params:
            np.testing.assert_allclose(rank['params'][k], params[k],
                                       err_msg='%s rank %d' % (k, r),
                                       **PARAMS[opt])
    if TRAINER_CASES[key][0] == 'lm':
        assert losses[-1] < losses[0]
