"""Weights carried across between the JAX package and the port.

A port parameter's ``state_dict`` key is its JAX pytree path with ``.``
for ``/`` (``blocks/attn/qkv/kernel``, stacked ``[L, dim, 3 * dim]``, is
``blocks.attn.qkv.kernel``), so the mapping is by name, and
``PytreeGraphItem`` names variables identically in both packages. Trees
are nested dicts of numpy arrays; no JAX type crosses over. Every model
of the port keeps the JAX paths (``NCF``'s ``mf_user/table``,
``LSTMLM``'s ``lstm_0/kernel``, the MoE ``TransformerLM``'s stacked
experts ``blocks/mlp/up`` [L, e, dim, hidden] and router
``blocks/mlp/router/kernel``), so these functions serve them all, in f32
bit for bit both ways.

State leaves (BatchNorm's ``ema_mean``/``ema_var``) are buffers in the
port and cross over with the parameters: ``state_dict`` and ``params()``
hold both. Conv kernels keep the JAX HWIO shape as the port's parameter,
so the map stays by name with no transpose.
"""
import numpy as np
import torch


def flatten_tree(tree, prefix=()):
    """[(path tuple, leaf)] of a nested dict, keys sorted at each level
    (the order ``jax.tree`` flattens a dict in)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(flatten_tree(v, prefix + (k,)))
        else:
            out.append((prefix + (k,), v))
    return out


def params_from_jax(tree):
    """JAX params (nested dict of arrays) -> port ``state_dict`` of f32
    CPU tensors."""
    return {'.'.join(path): torch.from_numpy(
                np.array(leaf, dtype=np.float32, copy=True))
            for path, leaf in flatten_tree(tree)}


def params_to_jax(module):
    """The port module's params and state buffers -> JAX-layout nested
    dict of numpy."""
    return tree_to_numpy(module.params())


def tree_to_numpy(tree):
    """Nested dict of tensors -> the same nesting of f32 numpy arrays."""
    return {k: tree_to_numpy(v) if isinstance(v, dict)
            else v.detach().float().cpu().numpy()
            for k, v in tree.items()}


def load_params(module, tree):
    """Copy JAX-layout params (state leaves included) into ``module``, in
    place, on its device. Every parameter and buffer must be present and
    match in shape."""
    module.load_state_dict(params_from_jax(tree), strict=True)
