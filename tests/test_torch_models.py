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
    want, want_aux = jb.apply(jp, jnp.asarray(x))
    got, aux = tb(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32)
    assert aux is None and float(want_aux) == 0.0   # a dense block


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


# the JAX package's variants (tests/test_models.py), each against the JAX
# model under the same config
REMAT_VARIANTS = {
    'plain': dict(),
    'chunked': dict(loss_chunk=64),
    'save_attn': dict(remat='save_attn', loss_chunk=64),
    'full_remat': dict(remat=True, loss_chunk=64),
    'dots': dict(remat='dots', loss_chunk=64),
    'dots_no_batch': dict(remat='dots_no_batch', loss_chunk=64),
    'dots_moe': dict(remat='dots', moe_experts=4, moe_aux_coef=1.0),
    'save_attn_moe': dict(remat='save_attn', moe_experts=4,
                          moe_aux_coef=1.0, loss_chunk=64),
}


@pytest.mark.parametrize('name', list(REMAT_VARIANTS))
def test_remat_policies_and_loss_chunk_match_jax(name):
    """Every remat policy and ``loss_chunk`` (4 chunks of 128 rows here)
    against the JAX model under the same config: loss 1e-5, gradients
    5e-5 (tests/test_models.py's bounds); and the port's own numbers equal
    the port's plain forward's bit for bit (the policies recompute the
    same ops on the same inputs; the chunked head is the same products
    on row slices, equal to 1e-6)."""
    kw = REMAT_VARIANTS[name]
    jm = JLM(JConfig.tiny(dtype=jnp.float32, **kw))
    jp = _np_tree(jm.init(jax.random.PRNGKey(0)))
    batch = _tokens(256, 4, 128)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    runs = {}
    for key, cfg_kw in (('variant', kw),
                        ('plain', {k: v for k, v in kw.items()
                                   if k not in ('remat', 'loss_chunk')})):
        tm = TransformerLM(TransformerConfig.tiny(dtype=torch.float32,
                                                  **cfg_kw), device='cpu')
        load_params(tm, jp)
        runs[key] = _run_port(tm, batch)[1:]
    loss, grads = runs['variant']
    assert abs(loss - float(jloss)) < 1e-5, (loss, float(jloss))
    _assert_trees_close(grads, _np_tree(jgrads), atol=5e-5, rtol=0)
    plain_loss, plain_grads = runs['plain']
    if 'loss_chunk' in kw:
        assert abs(loss - plain_loss) < 1e-6
        _assert_trees_close(grads, plain_grads, atol=1e-6, rtol=0)
    else:
        assert loss == plain_loss
        _assert_trees_close(grads, plain_grads, atol=0, rtol=0)


def test_loss_chunk_counts_and_indivisible_fallback():
    """``loss_chunk`` that cannot split the sequence evenly runs unchunked
    (n = 1) with the plain numbers, as in the JAX package; the chunk
    count is the JAX ``_ce_chunks``'s."""
    jchunked = JLM(JConfig.tiny(dtype=jnp.float32, loss_chunk=4))
    tchunked = TransformerLM(TransformerConfig.tiny(dtype=torch.float32,
                                                    loss_chunk=4),
                             device='cpu')
    for s, rows in ((7, 14), (128, 512), (96, 384), (64, 4), (5, 1000)):
        assert tchunked._ce_chunks(s, rows) == jchunked._ce_chunks(s, rows)
    jp = _np_tree(jchunked.init(jax.random.PRNGKey(0)))
    batch = _tokens(256, 2, 7, seed=1)
    load_params(tchunked, jp)
    plain = TransformerLM(TransformerConfig.tiny(dtype=torch.float32),
                          device='cpu')
    load_params(plain, jp)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    l1 = float(tchunked.loss(tchunked.params(), tb))
    l0 = float(plain.loss(plain.params(), tb))
    assert l0 == l1
    want = float(jax.jit(jchunked.loss)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}))
    assert abs(l1 - want) < 1e-5


def test_unknown_remat_mode_raises():
    """The JAX package's ValueError (message included) for a remat name
    it does not know; every option it takes builds."""
    with pytest.raises(ValueError, match=r"unknown remat mode 'attn' "
                       r"\(expected False, True, or one of \['dots', "
                       r"'dots_no_batch', 'save_attn'\]\)"):
        TransformerLM(TransformerConfig.tiny(remat='attn'), device='cpu')
    for kw in (dict(remat='save_attn'), dict(loss_chunk=64),
               dict(moe_experts=2, moe_top_k=1, moe_aux_coef=0.1)):
        TransformerLM(TransformerConfig.tiny(**kw), device='cpu')
