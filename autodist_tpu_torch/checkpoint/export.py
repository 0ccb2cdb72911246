"""Servable export on ``torch.export``.

The counterpart of ``autodist_tpu/checkpoint/export.py``, with the same
bundle layout (reference ``autodist/checkpoint/saved_model_builder.py``):

    export_dir/
      saved_model.json            # format, tags, per-signature metadata
      module.<signature>.pt2      # torch.export.save of the program
      variables/                  # logical-layout params (manifest + .npy)

``variables/`` is written by :func:`checkpoint.saver.save_pytree`, the
npy layout both packages read. The ``.pt2`` program takes the params as
an input, not as constants baked into it: serving needs only ``torch``
+ ``numpy`` (plus ``import autodist_tpu_torch.kernels`` when the program
calls the port's kernels, which the metadata's ``custom_ops`` lists)::

    module = torch.export.load(blob).module()
    outs = module(flat_params_dict, *inputs)

where ``flat_params_dict`` is ``{name: tensor}`` from ``variables/``,
keys sorted (the manifest's names: tree paths joined with ``/``); the
program rebuilds the nested tree inside. Input dims declared ``None``
are exported as symbolic ``torch.export.Dim``s, so the served program
takes any size there.
"""
import json
import os

import numpy as np
import torch

from autodist_tpu_torch.checkpoint.saver import (_leaf_paths, load_pytree,
                                                 save_pytree)
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.utils.device import resolve_device

FORMAT = 'autodist_tpu_torch.saved_model.v1'
#: custom-operator namespaces a bundle may call, and the module whose
#: import registers each
_OP_MODULES = {'autodist_tpu_torch': 'autodist_tpu_torch.kernels'}
#: operator namespaces every torch install has
_BUILTIN_NAMESPACES = {'aten', 'prims', 'prim', 'higher_order'}


def _unflatten(flat):
    """{'a/b': t} -> {'a': {'b': t}}."""
    tree = {}
    for name, leaf in flat.items():
        node = tree
        *head, last = name.split('/')
        for key in head:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


class _Program(torch.nn.Module):
    """``fn(params tree, *inputs)`` as a module of (flat params dict,
    *inputs), the exported call convention."""

    def __init__(self, fn, nested):
        super().__init__()
        self.fn, self.nested = fn, nested

    def forward(self, params, *inputs):
        return self.fn(_unflatten(params) if self.nested else params,
                       *inputs)


def _input_spec(shape, dtype, index, shared_batch_dim, dims, device):
    """(example tensor, dynamic-shape spec) of one input. A ``None`` dim
    becomes a ``Dim``: the leading one ``b`` for every input with
    ``shared_batch_dim``, else ``b<input index>``; later ones ``d<n>``.
    Each symbol's example size is its own (2, 3, ...), so no two
    symbols look equal to the tracer."""
    sizes, spec = [], {}
    for i, d in enumerate(tuple(shape or ())):
        if d is None:
            if i == 0:
                name = 'b' if shared_batch_dim else 'b%d' % index
            else:
                name = 'd%d' % len(dims)
            if name not in dims:
                dims[name] = (torch.export.Dim(name), 2 + len(dims))
            spec[i], size = dims[name]
            sizes.append(size)
        else:
            sizes.append(int(d))
    dt = _torch_dtype(dtype)
    return torch.zeros(sizes, dtype=dt, device=device), (spec or None)


def _torch_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) == 'bfloat16':
        return torch.bfloat16
    return torch.from_numpy(np.zeros((), np.dtype(dtype))).dtype


def _custom_namespaces(program):
    """Namespaces of the operators ``program`` calls beyond torch's
    own (the port's kernels: ``autodist_tpu_torch``)."""
    out = set()
    for node in program.graph.nodes:
        ns = getattr(node.target, 'namespace', None)
        if node.op == 'call_function' and ns and \
                ns not in _BUILTIN_NAMESPACES:
            out.add(ns)
    return sorted(out)


def _host(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def export_servable(fn, params, input_shapes, path,
                    signature='serving_default', tags=('serve',),
                    input_names=None, write_params=True,
                    shared_batch_dim=True):
    """Export ``fn(params, *inputs) -> outputs`` as a servable bundle.

    Args:
        fn: pure function of (params tree, *input tensors).
        params: nested dict of tensors (saved to ``variables/``); the
            program is traced on their device, which the metadata
            records.
        input_shapes: list of (shape, dtype); ``None`` dims symbolic.
        path: export directory (created; existing signatures preserved).
        signature: name of this entry point.
        input_names: optional names recorded in the metadata.
        write_params: False for a later signature of the same bundle.
        shared_batch_dim: True (default): every input's leading ``None``
            dim is the SAME batch dimension (they must agree at call
            time). False: each input's leading dim is its own.

    Returns ``path``.
    """
    os.makedirs(path, exist_ok=True)
    flat = {name: leaf for name, leaf in sorted(_leaf_paths(params))}
    nested = any(isinstance(v, dict) for v in params.values())
    tensors = {name: torch.as_tensor(leaf) for name, leaf in flat.items()}
    device = next(iter(tensors.values())).device if tensors else \
        torch.device('cpu')
    dims = {}
    specs = [_input_spec(s, d, i, shared_batch_dim, dims, device)
             for i, (s, d) in enumerate(input_shapes)]
    examples = tuple(x for x, _ in specs)
    # by forward's signature: (params, inputs), inputs the *varargs
    dynamic = ({name: None for name in tensors},
               tuple(spec for _, spec in specs))
    with torch.no_grad():
        program = torch.export.export(_Program(fn, nested),
                                      (tensors,) + examples,
                                      dynamic_shapes=dynamic)
    module_file = 'module.%s.pt2' % signature
    torch.export.save(program, os.path.join(path, module_file))
    if write_params:
        # variables/ is signature-independent; multi-signature bundles
        # pass write_params=False after the first export
        save_pytree(os.path.join(path, 'variables'),
                    {name: _host(t) for name, t in tensors.items()})

    meta_path = os.path.join(path, 'saved_model.json')
    meta = {'format': FORMAT, 'tags': list(tags), 'signatures': {}}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            old = json.load(f)
        if old.get('format') == FORMAT:
            meta['signatures'] = old.get('signatures', {})
    meta['signatures'][signature] = {
        'module_file': module_file,
        'device': device.type,
        'custom_ops': _custom_namespaces(program),
        'inputs': [{'name': (input_names[i] if input_names else
                             'input_%d' % i),
                    'shape': [None if d is None else int(d)
                              for d in tuple(shape or ())],
                    'dtype': str(_torch_dtype(dtype)).replace('torch.', '')}
                   for i, (shape, dtype) in enumerate(input_shapes)],
        'call_convention':
            'module(flat_params_dict, *inputs) -> outputs',
        'shared_batch_dim': bool(shared_batch_dim),
    }
    with open(meta_path, 'w') as f:
        json.dump(meta, f, indent=1, sort_keys=True)
    logging.info('Exported servable signature %r to %s', signature, path)
    return path


def load_servable(path, signature='serving_default', device=None):
    """Load a servable bundle; returns ``serve(*inputs)`` with the saved
    params bound, on ``device`` (the card unless the caller passes
    ``'cpu'``). Inputs may be numpy arrays or tensors; outputs are
    tensors on that device. A program traced on another device is moved
    (``torch.export.passes.move_to_device_pass``)."""
    with open(os.path.join(path, 'saved_model.json')) as f:
        meta = json.load(f)
    if meta.get('format') != FORMAT:
        raise ValueError('%s is a %r bundle, not %r: a bundle of the JAX '
                         'package is served by autodist_tpu.checkpoint.'
                         'export.load_servable' % (path, meta.get('format'),
                                                   FORMAT))
    sig = meta['signatures'][signature]
    for ns in sig['custom_ops']:
        if ns not in _OP_MODULES:
            raise ValueError('%s calls operators of %r, which this package '
                             'does not register' % (path, ns))
        __import__(_OP_MODULES[ns])
    dev = resolve_device(device)
    program = torch.export.load(os.path.join(path, sig['module_file']))
    if sig['device'] != dev.type:
        from torch.export.passes import move_to_device_pass
        program = move_to_device_pass(program, dev)
    module = program.module()
    flat, _ = load_pytree(os.path.join(path, 'variables'))
    params = {name: torch.from_numpy(np.ascontiguousarray(flat[name]))
              .to(dev) for name in sorted(flat)}

    def serve(*inputs):
        with torch.no_grad():
            return module(params, *[torch.as_tensor(x, device=dev)
                                    for x in inputs])

    return serve
