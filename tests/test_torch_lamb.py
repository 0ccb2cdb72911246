"""``optim.lamb`` against ``optax.lamb``: the update on a small pytree,
the Trainer against the JAX Trainer, a leaf sharded over two ranks
(ZeRO 3, so the trust ratio needs the whole leaf's norms) against one
process, and the checkpoint layout (optax's ``ScaleByAdamState``)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from autodist_tpu.api import Trainer as JTrainer
from autodist_tpu.models.transformer import TransformerConfig as JConfig
from autodist_tpu.models.transformer import TransformerLM as JLM
from autodist_tpu.parallel.axes import ParallelSpec as JSpec
from autodist_tpu_torch import optim
from autodist_tpu_torch.checkpoint.saver import (CheckpointManager,
                                                 _leaf_paths)

import torch_trainer_cases as cases
from torch_dsl_worlds import run_group

LR = 1e-3


def _tree(rng):
    return {'w': rng.randn(4, 3).astype(np.float32),
            'b': rng.randn(5).astype(np.float32),
            'zero': np.zeros(3, np.float32)}     # ||p|| = 0: ratio 1


@pytest.mark.parametrize('kw', [{}, {'weight_decay': 1e-2},
                                {'b1': 0.8, 'b2': 0.99, 'eps': 1e-4}],
                         ids=['defaults', 'weight_decay', 'moments'])
def test_lamb_is_optax_lamb_over_five_steps(kw):
    rng = np.random.RandomState(0)
    init = _tree(rng)
    grads = [_tree(rng) for _ in range(5)]
    tx = optax.lamb(1e-2, **kw)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in init.items()}
    opt = optim.lamb(1e-2, **kw)(list(tp.values()))
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st,
                            jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.tensor(g[k])
        opt.step()
        for k in init:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=0,
                                       atol=1e-6, err_msg=k)
    assert int(opt.state[tp['w']]['step']) == 5


def _batches(n=3):
    rng = np.random.RandomState(1)
    return [{'tokens': rng.randint(0, 256, (4, 32), dtype=np.int32),
             'targets': rng.randint(0, 256, (4, 32), dtype=np.int32)}
            for _ in range(n)]


def _jax_run(batches):
    jm = JLM(JConfig.tiny(dtype=jnp.float32))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    jtr = JTrainer(jm, optax.lamb(LR), spec=JSpec(dp=1))
    state = jtr.init(jax.random.PRNGKey(0), params=jp)
    losses = []
    for b in batches:
        state, m = jtr.step(state, b)
        losses.append(float(m['loss']))
    return jp, losses, cases.flat(jtr.get_params(state))


def test_lamb_trainer_matches_jax_trainer():
    """3 LAMB steps of the tiny Transformer: losses to 1e-5 relative,
    every param to 2e-6 (1.4e-7 measured on the CPU; LAMB, like Adam,
    can turn a rounding-sized gradient difference into a step-sized one
    where a gradient is near zero, none here)."""
    batches = _batches()
    jp, want, want_params = _jax_run(batches)
    got = cases.train(0, 1, 'lm', jp, batches, opt=('lamb', LR))
    np.testing.assert_allclose(got['losses'], want, rtol=1e-5)
    assert got['params'].keys() == want_params.keys()
    for path, ref in want_params.items():
        np.testing.assert_allclose(got['params'][path], ref, rtol=0,
                                   atol=2e-6, err_msg=path)


def test_lamb_over_sharded_leaves_equals_one_process():
    """ZeRO 3 at dp 2: each rank holds half of every leaf and LAMB steps
    its half. With the Trainer's shard groups the trust ratio is the
    whole leaf's, so both ranks end where one process does: params to
    2e-6 (6e-8 measured; a ratio from each half's own norms moved them
    by 1.3e-4)."""
    batches = _batches()
    jp, _, _ = _jax_run(batches[:0])
    one = cases.train(0, 1, 'lm', jp, batches, opt=('lamb', LR))
    got = run_group(2, [('zero3', 'torch_trainer_cases:train', dict(
        kind='lm', init=jp, batches=batches, opt=('lamb', LR),
        spec={'dp': 2, 'zero': 3}))])['zero3']
    sharded = [k for k, d in got[0]['sharding']['params'].items()
               if d is not None]
    assert sharded, got[0]['sharding']
    for rank_out in got:
        np.testing.assert_allclose(rank_out['losses'], one['losses'],
                                   rtol=1e-5)
        for path, ref in one['params'].items():
            np.testing.assert_allclose(rank_out['params'][path], ref,
                                       rtol=0, atol=2e-6, err_msg=path)


def test_lamb_state_saves_in_the_optax_layout(tmp_path):
    """LAMB's slots are Adam's: ``save_state`` writes ``.opt_state/0``
    with ``.count``, ``.mu`` and ``.nu``, and ``restore_state`` puts them
    back bit for bit."""
    batches = _batches(2)
    jp, _, _ = _jax_run(batches[:0])
    tr = cases.make_trainer('lm', opt=('lamb', LR))
    state = tr.init(params=jp)
    for b in batches:
        state, _ = tr.step(state, b)
    mgr = CheckpointManager(str(tmp_path))
    tr.save_state(mgr, state)
    tree = tr._state_tree(state)
    slots = tree['.opt_state'][0]
    assert int(slots['.count']) == 2 and set(slots) == {'.count', '.mu',
                                                         '.nu'}
    fresh = cases.make_trainer('lm', opt=('lamb', LR))
    back, step = fresh.restore_state(mgr, fresh.init(params=jp))
    assert step == 2
    got = dict(_leaf_paths(fresh._state_tree(back)))
    for path, want in _leaf_paths(tree):
        np.testing.assert_array_equal(got[path], want, err_msg=str(path))
