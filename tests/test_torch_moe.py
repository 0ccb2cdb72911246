"""The port's Mixture-of-Experts against the JAX package, on the CPU.

The JAX package initializes the params; ``load_params`` carries them into
the port, and both run the same numpy-seeded inputs. Routing is compared
as well as the numbers (the expert each choice picks and its buffer
position), so a top-k choice that flips between the frameworks shows as
a routing mismatch, not as a loose tolerance.

Tolerances. ``MoeMlp`` in f32: output 1e-5, gradients 5e-5 (absolute and
relative), products summed in other orders. In bf16: 2e-2 of the
largest magnitude of each output and gradient (a bf16 ulp is 2^-8 of
the value; the expert products round their operands and outputs to
bf16 in both packages, at different points of the sums). The MoE
``TransformerLM`` (f32): loss and aux 1e-5 relative, gradients 1e-4 as
in tests/test_torch_models.py, and 5e-4 at S = 512, where both packages
take the flash kernel branch (Pallas interpret mode in JAX).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_trainer_cases as cases
from autodist_tpu.models.moe import MoeMlp as JMoeMlp
from autodist_tpu.models.transformer import TransformerConfig as JConfig
from autodist_tpu.models.transformer import TransformerLM as JLM
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu.strategy import builders as jbuilders
from autodist_tpu.strategy.adapter import PytreeGraphItem as JGraphItem
from autodist_tpu.strategy.adapter import \
    grad_bucket_layout as j_grad_bucket_layout
from autodist_tpu.strategy.adapter import \
    trainer_from_strategy as j_trainer_from_strategy
from autodist_tpu_torch import optim
from autodist_tpu_torch.models.moe import MoeMlp
from autodist_tpu_torch.models.transformer import (TransformerConfig,
                                                   TransformerLM)
from autodist_tpu_torch.models.weights import (load_params, params_from_jax,
                                               params_to_jax, tree_to_numpy)
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy import builders
from autodist_tpu_torch.strategy.adapter import (PytreeGraphItem,
                                                 grad_bucket_layout,
                                                 trainer_from_strategy)

DIM, HIDDEN, EXPERTS = 32, 64, 4
DTYPES = {'f32': (jnp.float32, torch.float32),
          'bf16': (jnp.bfloat16, torch.bfloat16)}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    return {'/'.join(str(getattr(k, 'key', k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _grad_tree(tree):
    return {k: _grad_tree(v) if isinstance(v, dict) else v.grad
            for k, v in tree.items()}


def _jax_route(jm, jp, x):
    """The JAX MoeMlp's routing of ``x`` (moe.py's own ops): (gate values,
    expert index, buffer position), each [b, s, k]."""
    b, s, _ = x.shape
    e, k = jm.n_experts, jm.top_k
    probs = jax.nn.softmax(jm.router.apply(jp['router'],
                                           x.astype(jnp.float32)), axis=-1)
    gate_vals, gate_idx = jax.lax.top_k(probs, k)
    gate_vals = gate_vals / jnp.maximum(
        jnp.sum(gate_vals, -1, keepdims=True), 1e-9)
    flat = jax.nn.one_hot(gate_idx, e, dtype=jnp.int32).reshape(b, s * k, e)
    pos = jnp.cumsum(flat, axis=1) - flat
    pos = jnp.sum(pos * flat, axis=-1).reshape(b, s, k)
    return np.asarray(gate_vals), np.asarray(gate_idx), np.asarray(pos)


def _assert_routes_equal(got, want, cap=None):
    """Same expert and buffer position for every (token, choice); gate
    values to f32 rounding."""
    g_vals, g_idx, g_pos = (t.detach().cpu().numpy() for t in got)
    w_vals, w_idx, w_pos = want
    flips = int((g_idx != w_idx).sum())
    assert flips == 0, '%d top-k choices flipped between the packages' \
        % flips
    np.testing.assert_array_equal(g_pos, w_pos)
    np.testing.assert_allclose(g_vals, w_vals, atol=1e-6, rtol=1e-6)
    if cap is not None:
        return int((w_pos >= cap).sum())


def _close(got, want, dtype, what, f32=5e-5):
    if dtype == 'f32':
        np.testing.assert_allclose(got, want, atol=f32, rtol=f32,
                                   err_msg=what)
    else:
        err = float(np.max(np.abs(got - want)))
        assert err <= 2e-2 * float(np.max(np.abs(want))), (what, err)


@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('top_k,capacity_factor', [
    (1, 2.0), (2, 2.0), (1, 0.25), (2, 0.25)])
def test_moe_mlp_matches_jax(top_k, capacity_factor, dtype):
    """Output, aux, routing and every gradient (params and input), at
    top-1 and top-2, at the default capacity and at one that drops
    tokens."""
    jdt, tdt = DTYPES[dtype]
    jm = JMoeMlp(DIM, HIDDEN, EXPERTS, top_k=top_k,
                 capacity_factor=capacity_factor, dtype=jdt)
    jp = _np_tree(jm.init(jax.random.PRNGKey(3)))
    tm = MoeMlp(DIM, HIDDEN, EXPERTS, top_k=top_k,
                capacity_factor=capacity_factor, dtype=tdt, device='cpu')
    load_params(tm, jp)
    rng = np.random.RandomState(top_k)
    b, s = 2, 48
    # the input in the model dtype (a bf16 block hands the MLP bf16)
    x = np.asarray(jnp.asarray(rng.randn(b, s, DIM), jdt).astype(
        jnp.float32))
    ct = rng.randn(b, s, DIM).astype(np.float32)

    def jloss(p, xx):
        y, aux = jm.apply(p, xx.astype(jdt))
        return jnp.sum(y.astype(jnp.float32) * ct) + aux, (y, aux)

    (_, (jy, jaux)), (jg, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    tx = torch.tensor(x).to(tdt).requires_grad_(True)
    y, aux = tm(tx)
    (torch.sum(y.float() * torch.from_numpy(ct)) + aux).backward()

    cap = tm.capacity(s)
    assert cap == max(1, int(capacity_factor * s * top_k / EXPERTS))
    dropped = _assert_routes_equal(tm.route(tm.params(), tx)[1:],
                                   _jax_route(jm, jp, jnp.asarray(x, jdt)),
                                   cap)
    # the dropping capacity really drops: 0.25 keeps a quarter of what
    # perfect balance would need
    assert (dropped > 0) == (capacity_factor < 1), dropped
    assert y.dtype == tdt
    _close(y.detach().float().numpy(), np.asarray(jy, np.float32), dtype,
           'y', f32=1e-5)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-5)
    _close(tx.grad.float().numpy(), np.asarray(jgx, np.float32), dtype, 'dx')
    got = _flat(tree_to_numpy(_grad_tree(tm.params())))
    for k, v in _flat(jg).items():
        _close(got[k], v, dtype, k)


def test_moe_mlp_drops_every_choice_past_capacity():
    """A router that sends every token to expert 0 first: with capacity c
    only the first c tokens reach it, the rest are dropped (output 0 from
    that choice), not clipped into the last slot."""
    tm = MoeMlp(8, 16, 2, top_k=1, capacity_factor=0.5, device='cpu')
    tm.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        tm.router.kernel.zero_()
        tm.router.kernel[:, 0] = 1.0
    x = torch.ones(1, 8, 8)
    cap = tm.capacity(8)
    assert cap == 2
    _, _, idx, pos = tm.route(tm.params(), x)
    assert idx.flatten().tolist() == [0] * 8
    assert pos.flatten().tolist() == list(range(8))
    y, _ = tm(x)
    assert torch.all(y[0, cap:] == 0) and torch.all(y[0, :cap] != 0)


def _moe_cfg(pkg, seq, **kw):
    cfg = JConfig if pkg == 'jax' else TransformerConfig
    dtype = jnp.float32 if pkg == 'jax' else torch.float32
    return cfg.tiny(dtype=dtype, moe_experts=4, moe_aux_coef=1.0,
                    max_len=max(seq, 128), **kw)


def _jax_layer_routes(jm, jp, tokens):
    """Each layer's routing in the JAX model, block by block."""
    blk = jm.block
    x = jm._embedded(jp, tokens)
    routes = []
    for i in range(jm.cfg.n_layers):
        p = jax.tree.map(lambda a: a[i], jp['blocks'])
        h = x + blk.attn.apply(p['attn'], blk.ln1.apply(p['ln1'], x))
        routes.append(_jax_route(blk.mlp, p['mlp'],
                                 blk.ln2.apply(p['ln2'], h)))
        x, _ = blk.apply(p, x)
    return routes


@pytest.mark.parametrize('seq', [64, 512])
def test_moe_lm_loss_aux_grads_and_routing_match_jax(seq, monkeypatch):
    """``TransformerConfig.tiny(moe_experts=4, moe_aux_coef=1.0)``: the
    loss, the summed aux, every gradient, and each layer's routing. At
    S = 512 the attention takes the flash kernel branch in both."""
    jm = JLM(_moe_cfg('jax', seq))
    jp = _np_tree(jm.init(jax.random.PRNGKey(0)))
    tm = TransformerLM(_moe_cfg('torch', seq), device='cpu')
    load_params(tm, jp)
    batch = cases.lm_batch(b=2, s=seq, seed=7)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    routes = []
    route = MoeMlp.route

    def recording(self, params, x):
        out = route(self, params, x)
        routes.append(out[1:])
        return out
    monkeypatch.setattr(MoeMlp, 'route', recording)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    params = tm.params()
    nll, aux = tm.per_token_loss_with_aux(params, tb)
    loss = tm.loss(params, tb)
    loss.backward()
    jloss, jg = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
    _, jaux = jax.jit(jm.per_token_loss_with_aux)(jp, jb)
    assert len(routes) == 2 * 2      # per_token_loss_with_aux, then loss
    for got, want in zip(routes[:2], _jax_layer_routes(jm, jp,
                                                       jb['tokens'])):
        _assert_routes_equal(got, want)
    assert float(aux.detach()) > 1e-3      # the aux term is really there
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    tol = 5e-4 if seq >= 512 else 1e-4
    got = _flat(tree_to_numpy(_grad_tree(tm.params())))
    for k, v in _flat(jg).items():
        np.testing.assert_allclose(got[k], v, atol=tol, rtol=tol, err_msg=k)


def test_moe_weights_round_trip_bitwise_and_paths():
    """A JAX-initialized MoE TransformerLM crosses into the port and back
    bit for bit; the expert leaves stack under blocks/mlp."""
    jm = JLM(_moe_cfg('jax', 64))
    jp = _np_tree(jm.init(jax.random.PRNGKey(1)))
    tm = TransformerLM(_moe_cfg('torch', 64), device='cpu')
    load_params(tm, jp)
    back = params_to_jax(tm)
    flat_b, flat_j = _flat(back), _flat(jp)
    assert flat_b.keys() == flat_j.keys()
    for k in flat_j:
        np.testing.assert_array_equal(flat_b[k], flat_j[k], err_msg=k)
    sd = params_from_jax(jp)
    assert sd['blocks.mlp.up'].shape == (2, 4, 64, 256)
    assert sd['blocks.mlp.down'].shape == (2, 4, 256, 64)
    assert sd['blocks.mlp.router.kernel'].shape == (2, 64, 4)
    assert set(sd) == set(tm.state_dict())


def test_moe_init_scales_follow_fan_in():
    """The port's own init: ``up`` [e, dim, hidden] and ``down`` draw with
    std 1/sqrt(e * fan-in dims), as the JAX ParamDef's fan_in does."""
    tm = TransformerLM(TransformerConfig.tiny(dtype=torch.float32,
                                              moe_experts=8), device='cpu')
    mlp = tm.params()['blocks']['mlp']
    for name, fan in (('up', 8 * 64), ('down', 8 * 256)):
        std = float(mlp[name].std())
        assert abs(std * np.sqrt(fan) - 1) < 0.05, (name, std)


_RESOURCES = {'nodes': [{'address': 'localhost', 'chief': True,
                         'cpus': [0], 'gpus': [0], 'network_bandwidth': 100}]}


@pytest.mark.parametrize('builder', ['AllReduce', 'PartitionedPS'])
def test_moe_strategy_and_buckets_match_jax(builder, monkeypatch):
    """The 4-D stacked expert leaves through the strategy builders: the
    same node_config and gradient buckets as the JAX adapter (at the
    default cap and at 4 KiB), and a step of ``trainer_from_strategy``
    equal to the JAX one."""
    jm = JLM(_moe_cfg('jax', 32))
    jp = _np_tree(jm.init(jax.random.PRNGKey(0)))
    tm = TransformerLM(_moe_cfg('torch', 32), device='cpu')
    jgi, gi = JGraphItem(jm), PytreeGraphItem(tm)
    jst = getattr(jbuilders, builder)().build(
        jgi, JResourceSpec(resource_info=_RESOURCES))
    st = getattr(builders, builder)().build(
        gi, ResourceSpec(resource_info=_RESOURCES))
    assert [dataclasses.asdict(n) for n in st.node_config] == \
        [dataclasses.asdict(n) for n in jst.node_config]
    assert 'blocks/mlp/up' in [n.var_name for n in st.node_config]
    for cap in (None, '4096'):
        if cap:
            monkeypatch.setenv('AUTODIST_BUCKET_BYTES', cap)
        assert grad_bucket_layout(st, gi) == j_grad_bucket_layout(jst, jgi)
    monkeypatch.delenv('AUTODIST_BUCKET_BYTES')
    batch = cases.lm_batch(b=8, s=32)    # the JAX mesh's 8 data shards
    jtr = j_trainer_from_strategy(
        jm, optax.sgd(0.1), getattr(jbuilders, builder)(),
        resource_spec=JResourceSpec(resource_info=_RESOURCES))
    jstate = jtr.init(jax.random.PRNGKey(0), params=jp)
    jstate, jmet = jtr.step(jstate, batch)
    tr = trainer_from_strategy(
        tm, optim.sgd(0.1), getattr(builders, builder)(),
        resource_spec=ResourceSpec(resource_info=_RESOURCES))
    state = tr.init(params=jp)
    state, met = tr.step(state, batch)
    np.testing.assert_allclose(float(met['loss']), float(jmet['loss']),
                               rtol=1e-5)
    got, want = _flat(tr.get_params(state)), _flat(jtr.get_params(jstate))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=2e-6, rtol=0,
                                   err_msg=k)
