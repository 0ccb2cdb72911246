"""Port models against the JAX package, on the CPU in f32.

The JAX package initializes the params; ``params_from_jax`` carries them
into the port, and both run the same numpy-seeded inputs. Tolerances
(f32): outputs and losses 1e-5 relative / 2e-5 absolute, which covers
products summed in other orders; gradients 1e-4 absolute, since they
chain a dozen such products through LayerNorm and softmax. At S = 512
both packages take the flash kernel branch (Pallas interpret mode in
JAX, the kernels' plain versions in the port), so the comparison there
is held to the flash test's 5e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu.kernels import flash_attention as jfa
from autodist_tpu.models.attention import MultiHeadAttention as JMHA
from autodist_tpu.models.transformer import Block as JBlock
from autodist_tpu.models.transformer import TransformerConfig as JConfig
from autodist_tpu.models.transformer import TransformerLM as JLM
from autodist_tpu_torch.kernels import flash_attention as fa
from autodist_tpu_torch.models.attention import MultiHeadAttention
from autodist_tpu_torch.models.transformer import (Block, TransformerConfig,
                                                   TransformerLM)
from autodist_tpu_torch.models.weights import (load_params, params_from_jax,
                                               params_to_jax, tree_to_numpy)

F32 = dict(atol=2e-5, rtol=1e-5)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(cfg_vocab, b, s, seed=0):
    rng = np.random.RandomState(seed)
    return {'tokens': rng.randint(0, cfg_vocab, (b, s), dtype=np.int32),
            'targets': rng.randint(0, cfg_vocab, (b, s), dtype=np.int32)}


def _grads(module):
    return tree_to_numpy(_grad_tree(module.params()))


def _grad_tree(tree):
    return {k: _grad_tree(v) if isinstance(v, dict) else v.grad
            for k, v in tree.items()}


def _assert_trees_close(got, want, **tol):
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert flat_g.keys() == flat_w.keys()
    for path in flat_w:
        np.testing.assert_allclose(flat_g[path], flat_w[path],
                                   err_msg=str(path), **tol)


@pytest.mark.parametrize('causal', [True, False])
def test_mha_matches_jax(causal):
    jm = JMHA(64, 4, causal=causal, dtype=jnp.float32)
    jp = _np_tree(jm.init(jax.random.PRNGKey(1)))
    x = np.random.RandomState(1).randn(2, 16, 64).astype(np.float32)
    tm = MultiHeadAttention(64, 4, causal=causal, dtype=torch.float32,
                            device='cpu')
    load_params(tm, jp)
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jm.apply(jp, jnp.asarray(x))),
                               **F32)


def test_block_matches_jax():
    jc = JConfig.tiny(dtype=jnp.float32)
    jb = JBlock(jc)
    jp = _np_tree(jb.init(jax.random.PRNGKey(2)))
    x = np.random.RandomState(2).randn(2, 16, 64).astype(np.float32)
    tb = Block(TransformerConfig.tiny(dtype=torch.float32), device='cpu')
    load_params(tb, jp)
    want, _ = jb.apply(jp, jnp.asarray(x))
    np.testing.assert_allclose(tb(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(want), **F32)


def _lm_pair(seq, remat=False, scan_layers=True):
    kw = dict(max_len=max(seq, 128), scan_layers=scan_layers)
    jm = JLM(JConfig.tiny(dtype=jnp.float32, **kw))
    jp = _np_tree(jm.init(jax.random.PRNGKey(0)))
    tm = TransformerLM(TransformerConfig.tiny(dtype=torch.float32,
                                              remat=remat, **kw),
                       device='cpu')
    load_params(tm, jp)
    return jm, jp, tm


def _run_port(tm, batch):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    params = tm.params()
    logits = tm.apply(params, tb['tokens'])
    loss = tm.loss(params, tb)
    loss.backward()
    return logits.detach().numpy(), float(loss.detach()), _grads(tm)


@pytest.mark.parametrize('scan_layers', [True, False])
def test_lm_logits_loss_grads_match_jax(scan_layers):
    jm, jp, tm = _lm_pair(32, scan_layers=scan_layers)
    batch = _tokens(256, 2, 32)
    logits, loss, grads = _run_port(tm, batch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    assert logits.dtype == np.float32
    np.testing.assert_allclose(logits, np.asarray(jm.apply(jp, jb['tokens'])),
                               **F32)
    jloss, jgrads = jax.value_and_grad(jm.loss)(jp, jb)
    np.testing.assert_allclose(loss, float(jloss), **F32)
    _assert_trees_close(grads, _np_tree(jgrads), atol=1e-4, rtol=1e-4)


def test_masked_loss_matches_jax():
    jm, jp, tm = _lm_pair(16)
    batch = _tokens(256, 2, 16, seed=3)
    batch['mask'] = (np.random.RandomState(3).rand(2, 16) > 0.4) \
        .astype(np.float32)
    want = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    got = tm.loss(tm.params(), {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    np.testing.assert_allclose(float(got.detach()), float(want), **F32)


def test_kernel_branch_at_seq_512_matches_jax():
    """Tiny widths at S = 512: the flash branch in both packages."""
    jm, jp, tm = _lm_pair(512)
    assert jfa.preferred((1, 4, 512, 16)) and fa.preferred((1, 4, 512, 16))
    batch = _tokens(256, 1, 512, seed=4)
    _, loss, grads = _run_port(tm, batch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(jm.loss)(jp, jb)
    np.testing.assert_allclose(loss, float(jloss), **F32)
    _assert_trees_close(grads, _np_tree(jgrads), atol=5e-4, rtol=5e-4)


def test_remat_gives_identical_numbers():
    _, _, plain = _lm_pair(32)
    _, _, remat = _lm_pair(32, remat=True)
    batch = _tokens(256, 2, 32, seed=5)
    l1, loss1, g1 = _run_port(plain, batch)
    l2, loss2, g2 = _run_port(remat, batch)
    assert loss1 == loss2
    np.testing.assert_array_equal(l1, l2)
    _assert_trees_close(g2, g1, atol=0, rtol=0)


def test_weights_round_trip_and_paths():
    jm, jp, tm = _lm_pair(16)
    back = params_to_jax(tm)
    _assert_trees_close(back, jp, atol=0, rtol=0)
    sd = params_from_jax(jp)
    assert sd['blocks.attn.qkv.kernel'].shape == (2, 64, 192)
    assert set(sd) == set(tm.state_dict())


def test_unported_options_raise():
    for kw in (dict(remat='save_attn'), dict(loss_chunk=64),
               dict(moe_experts=2)):
        with pytest.raises(NotImplementedError):
            TransformerLM(TransformerConfig.tiny(**kw), device='cpu')
