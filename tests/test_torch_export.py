"""Servable export of the port (``checkpoint/export.py``,
``SavedModelBuilder``) against the JAX package's, on the CPU.

Mirrors the export cases of ``tests/test_checkpoint.py``: the
multi-signature round trip, independent batch dimensions,
``SavedModelBuilder`` on a DSL graph with and without signatures, and a
fresh ``python`` process that serves the bundle with torch + numpy
(without the port on its path when the program calls no kernel) and
never imports jax. Adds: the same ``TransformerConfig.tiny`` params (f32)
served by the JAX ``export_servable`` and by the port's, on the plain
attention arm (S 128) and the flash arm (``max_len=512``, S 512; Pallas
interpret mode in JAX, ``autodist_tpu_torch::flash_fwd`` on its plain
version in the port), within 1e-5; the exported program holding the
``flash_fwd`` node; and the JAX ``load_pytree`` reading a port bundle's
``variables/``.

Tolerances: the linear programs compute the same f32 products in both
packages, 1e-6 (1e-5 for the product of two products); the LM's logits
(largest about 0.72) 1e-5 absolute, the parity tests' loss tolerance
(they differ by at most 6.3e-7).
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from autodist_tpu.checkpoint.export import export_servable as jexport
from autodist_tpu.checkpoint.export import load_servable as jload
from autodist_tpu.checkpoint.saver import load_pytree as jload_pytree
from autodist_tpu.models.transformer import TransformerConfig as JConfig
from autodist_tpu.models.transformer import TransformerLM as JLM
import autodist_tpu_torch as ad
from autodist_tpu_torch.checkpoint.export import (FORMAT, export_servable,
                                                  load_servable)
from autodist_tpu_torch.checkpoint.saver import SavedModelBuilder
from autodist_tpu_torch.models.transformer import (TransformerConfig,
                                                   TransformerLM)
from autodist_tpu_torch.models.weights import flatten_tree, load_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = 'cpu'


def test_export_servable_roundtrip_and_multi_signature(tmp_path):
    """load_servable reproduces fn(params, x); a second signature joins
    the same bundle without clobbering the first."""
    rng = np.random.RandomState(1)
    params = {'w': rng.randn(4, 2).astype(np.float32),
              'b': rng.randn(2).astype(np.float32)}

    def fn(p, x):
        return [x @ p['w'] + p['b']]

    def fn2(p, x):
        return [torch.tanh(x @ p['w'])]

    path = str(tmp_path / 'bundle')
    export_servable(fn, params, [((None, 4), np.float32)], path)
    export_servable(fn2, params, [((None, 4), np.float32)], path,
                    signature='tanh', write_params=False)
    x = rng.randn(6, 4).astype(np.float32)
    serve = load_servable(path, device=CPU)
    np.testing.assert_allclose(serve(x)[0].numpy(),
                               x @ params['w'] + params['b'], atol=1e-6)
    serve2 = load_servable(path, signature='tanh', device=CPU)
    np.testing.assert_allclose(serve2(x)[0].numpy(),
                               np.tanh(x @ params['w']), atol=1e-6)
    meta = json.load(open(os.path.join(path, 'saved_model.json')))
    assert meta['format'] == FORMAT
    assert set(meta['signatures']) == {'serving_default', 'tanh'}
    sig = meta['signatures']['serving_default']
    assert sig['inputs'] == [{'name': 'input_0', 'shape': [None, 4],
                              'dtype': 'float32'}]
    assert sig['custom_ops'] == [] and sig['device'] == CPU
    # the symbolic batch: a size never seen at export time, and one
    np.testing.assert_allclose(serve(x[:1])[0].numpy(),
                               x[:1] @ params['w'] + params['b'], atol=1e-6)


def test_export_independent_batch_dims(tmp_path):
    """shared_batch_dim=False: two inputs with independent leading dims
    serve with different batch sizes."""
    rng = np.random.RandomState(2)
    params = {'w': rng.randn(4, 3).astype(np.float32)}

    def fn(p, queries, keys):
        return [(queries @ p['w']) @ (keys @ p['w']).T]

    path = str(tmp_path / 'bundle_ind')
    export_servable(fn, params,
                    [((None, 4), np.float32), ((None, 4), np.float32)],
                    path, shared_batch_dim=False)
    q = rng.randn(5, 4).astype(np.float32)
    k = rng.randn(9, 4).astype(np.float32)
    out = load_servable(path, device=CPU)(q, k)[0].numpy()
    np.testing.assert_allclose(out, (q @ params['w']) @ (k @ params['w']).T,
                               atol=1e-5)
    meta = json.load(open(os.path.join(path, 'saved_model.json')))
    assert meta['signatures']['serving_default'][
        'shared_batch_dim'] is False


def _dsl_session(rng):
    """The JAX test's DSL program after one SGD step, on the CPU: (session,
    pred, x, train_op)."""
    autodist = cs.fresh_autodist(ad.AllReduce(), CPU)
    with autodist.scope():
        x = ad.placeholder(shape=[None, 4], dtype=np.float32, name='x')
        W = ad.Variable(rng.randn(4, 2).astype(np.float32), name='W')
        b = ad.Variable(np.zeros(2, np.float32), name='b')
        pred = x @ W + b
        loss = ad.ops.reduce_mean(ad.ops.square(pred))
        train_op = ad.optimizers.SGD(0.1).minimize(loss)
        sess = autodist.create_distributed_session()
        sess.run(train_op, {x: rng.randn(8, 4).astype(np.float32)})
    return sess, pred, x, train_op


def test_saved_model_builder_without_signatures(tmp_path):
    """Variables and metadata only, the variables in the npy layout the
    JAX ``load_pytree`` reads."""
    sess, _, _, _ = _dsl_session(np.random.RandomState(0))
    export = str(tmp_path / 'export')
    SavedModelBuilder(export).add_meta_graph_and_variables(
        sess, tags=['serve']).save()
    meta = json.load(open(os.path.join(export, 'saved_model.json')))
    assert meta == {'format': FORMAT, 'tags': ['serve'], 'signatures': {}}
    tensors, _ = jload_pytree(os.path.join(export, 'variables'))
    assert set(tensors) == {'W', 'b'}
    np.testing.assert_array_equal(tensors['W'], sess.get_variable_value('W'))
    sess.close()


def test_saved_model_builder_refuses_a_train_op(tmp_path):
    sess, _, x, train_op = _dsl_session(np.random.RandomState(0))
    builder = SavedModelBuilder(str(tmp_path / 'export'))
    builder.add_meta_graph_and_variables(
        sess, tags=['serve'],
        signature_def_map={'serving_default': (train_op, [x])})
    with pytest.raises(ValueError, match='forward-only'):
        builder.save()
    sess.close()


# a bundle served from its documented layout, with torch + numpy only
_FRESH_LOADER = """
import json, os, sys
import numpy as np
import torch

d, x_path, out_path = sys.argv[1], sys.argv[2], sys.argv[3]
meta = json.load(open(os.path.join(d, 'saved_model.json')))
sig = meta['signatures']['serving_default']
program = torch.export.load(os.path.join(d, sig['module_file']))
man = json.load(open(os.path.join(d, 'variables', 'manifest.json')))
params = {k: torch.from_numpy(np.load(os.path.join(d, 'variables',
                                                   man['tensors'][k]['file'])))
          for k in sorted(man['tensors'])}
with torch.no_grad():
    out = program.module()(params, torch.from_numpy(np.load(x_path)))
out = out[0] if isinstance(out, (list, tuple)) else out
np.save(out_path, out.numpy())
assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)
"""


# a bundle served by the port's load_servable, which imports the port's
# kernels when the metadata lists their namespace
_PORT_LOADER = """
import sys
import numpy as np
from autodist_tpu_torch.checkpoint.export import load_servable

d, x_path, out_path = sys.argv[1], sys.argv[2], sys.argv[3]
out = load_servable(d, device='cpu')(np.load(x_path))
np.save(out_path, out.numpy())
assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)
"""


def _serve_fresh(tmp_path, export, batches, with_port):
    """Serve ``export`` on every batch in a fresh ``python``: with
    ``with_port``, through the port's ``load_servable``; without, from the
    documented layout with torch + numpy, the port not on the path."""
    loader = tmp_path / 'loader.py'
    loader.write_text(_PORT_LOADER if with_port else _FRESH_LOADER)
    env = dict(os.environ)
    env.pop('PYTHONPATH', None)
    if with_port:
        env['PYTHONPATH'] = REPO
    outs = {}
    for n, batch in batches.items():
        x_path = str(tmp_path / ('x%d.npy' % n))
        out_path = str(tmp_path / ('out%d.npy' % n))
        np.save(x_path, batch)
        subprocess.run([sys.executable, str(loader), export, x_path,
                        out_path], check=True, env=env, timeout=300,
                       cwd=str(tmp_path))
        outs[n] = np.load(out_path)
    return outs


def test_saved_model_serves_in_fresh_process(tmp_path):
    """A fresh process that cannot import the port (no ``PYTHONPATH``, run
    outside the repo) serves the DSL bundle with torch + numpy, bit for
    bit the live session's prediction, at a batch size never seen at
    export time."""
    rng = np.random.RandomState(0)
    sess, pred, x, _ = _dsl_session(rng)
    export = str(tmp_path / 'export')
    SavedModelBuilder(export).add_meta_graph_and_variables(
        sess, tags=['serve'],
        signature_def_map={'serving_default': (pred, [x])}).save()
    batches = {8: rng.randn(8, 4).astype(np.float32),
               3: rng.randn(3, 4).astype(np.float32)}
    want = {n: sess.run(pred, {x: v}) for n, v in batches.items()}
    sess.close()
    got = _serve_fresh(tmp_path, export, batches, with_port=False)
    for n in batches:
        assert got[n].shape == (n, 2)
        np.testing.assert_array_equal(got[n], want[n])


def _lm_pair(max_len):
    kw = dict(max_len=max_len)
    jm = JLM(JConfig.tiny(dtype=jnp.float32, **kw))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = TransformerLM(TransformerConfig.tiny(dtype=torch.float32, **kw),
                       device=CPU)
    load_params(tm, jp)
    return jm, jp, tm


@pytest.mark.parametrize('seq', [128, 512])
def test_lm_served_by_both_packages_agrees(tmp_path, seq):
    """``TransformerConfig.tiny`` f32 with the JAX init, exported by each
    package with tokens [None, S] and served at batch 2: S 128 takes the
    plain attention arm in both, S 512 (``max_len=512``) the flash arm.
    The port's program holds the ``flash_fwd`` operator exactly at S 512,
    and its metadata names the namespace."""
    jm, jp, tm = _lm_pair(max(seq, 256))
    flat = {'/'.join(path): v for path, v in flatten_tree(jp)}

    def jfn(params, tokens):
        tree = {}
        for name, leaf in params.items():
            node = tree
            *head, last = name.split('/')
            for key in head:
                node = node.setdefault(key, {})
            node[last] = leaf
        return [jm.apply(tree, tokens)]

    jpath, path = str(tmp_path / 'jax'), str(tmp_path / 'port')
    jexport(jfn, flat, [((None, seq), np.int32)], jpath, platforms=('cpu',))
    export_servable(tm.apply, tm.params(), [((None, seq), np.int32)], path)
    tokens = np.random.RandomState(3).randint(0, 256, (2, seq),
                                              dtype=np.int32)
    want = np.asarray(jload(jpath)(tokens)[0])
    got = load_servable(path, device=CPU)(tokens).numpy()
    assert got.shape == want.shape == (2, seq, 256)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    meta = json.load(open(os.path.join(path, 'saved_model.json')))
    program = torch.export.load(os.path.join(path, 'module.serving_default'
                                                   '.pt2'))
    flash = [n for n in program.graph.nodes if n.op == 'call_function' and
             n.target is torch.ops.autodist_tpu_torch.flash_fwd.default]
    n_layers = tm.cfg.n_layers
    assert len(flash) == (n_layers if seq == 512 else 0)
    assert meta['signatures']['serving_default']['custom_ops'] == \
        (['autodist_tpu_torch'] if seq == 512 else [])


def test_bundle_with_kernels_serves_in_fresh_process(tmp_path):
    """The flash arm's bundle in a fresh process through
    ``load_servable``, which imports ``autodist_tpu_torch.kernels``
    because the metadata lists the namespace, and no jax; the logits
    equal the in-process serve."""
    _, _, tm = _lm_pair(512)
    path = str(tmp_path / 'port')
    export_servable(tm.apply, tm.params(), [((None, 512), np.int32)], path)
    tokens = np.random.RandomState(4).randint(0, 256, (1, 512),
                                              dtype=np.int32)
    want = load_servable(path, device=CPU)(tokens).numpy()
    got = _serve_fresh(tmp_path, path, {1: tokens}, with_port=True)[1]
    np.testing.assert_array_equal(got, want)


def test_jax_load_pytree_reads_a_port_bundle(tmp_path):
    """The JAX ``load_pytree`` reads the port bundle's ``variables/`` to
    identical arrays, named by the JAX tree paths."""
    _, jp, tm = _lm_pair(256)
    path = str(tmp_path / 'port')
    export_servable(tm.apply, tm.params(), [((None, 32), np.int32)], path)
    tensors, _ = jload_pytree(os.path.join(path, 'variables'))
    want = {'/'.join(p): v for p, v in flatten_tree(jp)}
    assert set(tensors) == set(want)
    for name, v in want.items():
        np.testing.assert_array_equal(tensors[name], v, err_msg=name)


def test_load_servable_refuses_a_jax_bundle(tmp_path):
    path = str(tmp_path / 'jax')
    jexport(lambda p, x: [x @ p['w']], {'w': np.ones((4, 2), np.float32)},
            [((None, 4), np.float32)], path, platforms=('cpu',))
    with pytest.raises(ValueError, match='autodist_tpu.saved_model.v1'):
        load_servable(path, device=CPU)
