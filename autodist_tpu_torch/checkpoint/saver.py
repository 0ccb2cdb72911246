"""Checkpointing in logical (unsharded) layout.

The counterpart of ``autodist_tpu/checkpoint/saver.py``, in the same
format: a directory with ``manifest.json`` (format
``autodist_tpu.ckpt.v1``, the step, and each tensor's file, shape and
dtype) and one ``.npy`` per leaf, named by the leaf's path joined with
``/`` (``.params/mf_user/table``). A tree is nested dicts (keys sorted,
as ``jax.tree`` flattens them), lists and tuples (by index). So a
checkpoint written by either package loads in the other:
``Trainer.save_state`` writes the JAX ``TrainState``'s leaf names
(``api.py``), and the DSL ``Saver`` one leaf per variable name.

``CheckpointManager`` keeps step-numbered checkpoints with retention,
written synchronously or from a writer thread (``async_save``). The JAX
package's ``orbax`` backend has no counterpart: orbax is not installed
with the port (and ``import orbax.checkpoint`` loads jax), so
``backend='orbax'`` raises. ``SavedModelBuilder`` writes a servable
bundle of the DSL session (:mod:`autodist_tpu_torch.checkpoint.export`).
"""
import json
import os
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist

from autodist_tpu_torch.utils import logging

FORMAT = 'autodist_tpu.ckpt.v1'


def _to_host(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _leaf_paths(tree, prefix=()):
    """[(name, leaf)] in ``jax.tree``'s order: dict keys sorted, lists
    and tuples by index; the name is the path joined with ``/``."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [('/'.join(prefix), tree)]
    out = []
    for k, v in items:
        out.extend(_leaf_paths(v, prefix + (k,)))
    return out


def _rebuild(like, leaves, prefix=()):
    """``like``'s structure with each leaf taken from ``leaves`` (a
    {name: array} dict)."""
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves, prefix + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves, prefix + (str(i),))
                          for i, v in enumerate(like))
    return leaves['/'.join(prefix)]


def save_pytree(path, tree, step=None, overwrite=True):
    """Write a tree of arrays (numpy or tensors) to ``path`` in logical
    layout; the directory appears whole (written as ``path.tmp``, then
    renamed)."""
    tmp = path + '.tmp'
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {'format': FORMAT, 'step': step, 'tensors': {}}
    for name, leaf in _leaf_paths(tree):
        host = _to_host(leaf)
        fname = name.replace('/', '.') + '.npy'
        np.save(os.path.join(tmp, fname), host)
        manifest['tensors'][name] = {
            'file': fname, 'shape': list(host.shape),
            'dtype': str(host.dtype)}
    with open(os.path.join(tmp, 'manifest.json'), 'w') as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    if os.path.exists(path):
        if not overwrite:
            raise FileExistsError(path)
        shutil.rmtree(path)
    os.rename(tmp, path)
    logging.info('Saved checkpoint (%d tensors) to %s',
                 len(manifest['tensors']), path)
    return path


def load_pytree(path, like=None):
    """Load a checkpoint directory: ``(tree, step)``. With ``like`` (a
    template tree whose leaves have ``.shape``), the tree has its
    structure; without it, a flat {name: array} dict."""
    with open(os.path.join(path, 'manifest.json')) as f:
        manifest = json.load(f)
    tensors = {name: np.load(os.path.join(path, meta['file']))
               for name, meta in manifest['tensors'].items()}
    if like is None:
        return tensors, manifest.get('step')
    for name, leaf in _leaf_paths(like):
        if name not in tensors:
            raise KeyError('Checkpoint %s missing tensor %r' % (path, name))
        want = tuple(getattr(leaf, 'shape', ()))
        got = tensors[name].shape
        if want and tuple(got) != want:
            raise ValueError('Shape mismatch for %r: ckpt %s vs model %s'
                             % (name, got, want))
    return _rebuild(like, tensors), manifest.get('step')


class CheckpointManager:
    """Step-numbered checkpoints with retention (keep the latest
    ``max_to_keep``), in the npy layout of :func:`save_pytree`.

    ``async_save=True`` makes ``save`` non-blocking: the values are
    copied to the host at once and a writer thread writes them while
    training goes on. At most one save is in flight; a new ``save``,
    ``restore`` or ``wait_until_finished`` drains the previous one first,
    and a failed write raises there.
    """

    def __init__(self, directory, max_to_keep=3, backend='npy',
                 async_save=False):
        if backend == 'orbax':
            raise NotImplementedError(
                "CheckpointManager(backend='orbax'): orbax is not installed "
                "with the PyTorch port; use backend='npy', which writes the "
                "same logical layout")
        if backend != 'npy':
            raise ValueError('backend must be npy or orbax: %r' % backend)
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.backend = backend
        self.async_save = async_save
        self._pending = None       # writer thread
        self._pending_error = None
        os.makedirs(directory, exist_ok=True)

    def _ckpt_path(self, step):
        return os.path.join(self.directory, 'ckpt-%d' % step)

    def all_steps(self):
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith('ckpt-') and not name.endswith('.tmp'):
                try:
                    steps.append(int(name.split('-', 1)[1]))
                except ValueError:
                    pass
        return sorted(steps)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step, tree):
        if self.async_save:
            return self._save_async(step, tree)
        path = save_pytree(self._ckpt_path(step), tree, step=step)
        self._retain()
        return path

    def _retain(self):
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._ckpt_path(old))

    def _save_async(self, step, tree):
        self.wait_until_finished()   # one save in flight at a time
        path = self._ckpt_path(step)
        # snapshot NOW, as copies: later steps update the tensors in place
        # (a CPU tensor's numpy view would follow them)
        host = _rebuild(tree, {name: np.array(_to_host(leaf), copy=True)
                               for name, leaf in _leaf_paths(tree)})

        def write():
            try:
                save_pytree(path, host, step=step)
            except Exception as e:   # noqa: BLE001 - raised on the drain
                logging.error('async checkpoint write to %s failed: %s',
                              path, e)
                self._pending_error = e
        # non-daemon: an undrained save still completes at interpreter exit
        self._pending = threading.Thread(target=write, daemon=False)
        self._pending.start()
        # retention sees only finished checkpoints, so max_to_keep + 1 may
        # exist until the drain
        self._retain()
        return path

    def wait_until_finished(self):
        """Drain an in-flight async save (raising its error, if any),
        then apply retention again: the drained save was invisible to
        the retention pass that ran when it started."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
            if self._pending_error is not None:
                err, self._pending_error = self._pending_error, None
                raise err
        if self.async_save:
            self._retain()

    def close(self):
        """Drain in-flight saves. Safe to call more than once."""
        self.wait_until_finished()

    def restore(self, like=None, step=None):
        """``(tree, step)`` of the checkpoint at ``step`` (the latest when
        None), or ``(None, None)`` when there is none."""
        self.wait_until_finished()
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        tree, _ = load_pytree(self._ckpt_path(step), like=like)
        return tree, step


# -- reference-parity Saver over the DSL Session --------------------------

class Saver:
    """tf.train.Saver-shaped facade for the DSL/session path.

    Built inside ``AutoDist.scope()`` before the session; ``save`` and
    ``restore`` run against the session's variables through
    ``Session.get_variable_value`` / ``load_variable_value``, so the
    files hold each variable in its single-device layout whatever the
    strategy. ``max_to_keep`` is kept for the reference's signature, as
    the JAX package keeps it."""

    def __init__(self, var_list=None, max_to_keep=5):
        from autodist_tpu_torch.frontend import graph as fe
        self._graph = fe.get_default_graph()
        self._vars = ({v.name: v for v in var_list} if var_list
                      else dict(self._graph.variables))
        self._max_to_keep = max_to_keep
        self._graph.savers.append(self)

    def save(self, sess, save_path, global_step=None):
        """Write every variable's value; returns the path. Every replica
        calls it (gathering a sharded variable is a collective); rank 0
        of the default group writes."""
        tree = {name: sess.get_variable_value(name)
                for name in self._vars}
        path = save_path if global_step is None \
            else '%s-%d' % (save_path, global_step)
        if dist.is_available() and dist.is_initialized() and \
                dist.get_rank() != 0:
            return path
        return save_pytree(path, tree, step=global_step)

    def restore(self, sess, save_path):
        tensors, _ = load_pytree(save_path)
        for name in self._vars:
            if name not in tensors:
                raise KeyError('Checkpoint missing variable %r' % name)
            sess.load_variable_value(name, tensors[name])
        logging.info('Restored %d variables from %s',
                     len(self._vars), save_path)


class SavedModelBuilder:
    """Export a servable bundle (reference saved_model_builder.py:24-64).

    ``signature_def_map`` maps a signature name to ``(outputs, inputs)``:
    ``outputs`` a fetch node (or list of them) from the captured graph,
    ``inputs`` the placeholders it consumes. Each signature's forward
    subgraph is re-traced through ``frontend.graph.evaluate`` as a pure
    function of (params, *inputs) and exported with ``torch.export``
    beside the variables, on the session's device
    (:mod:`autodist_tpu_torch.checkpoint.export`): a fresh process
    reloads and serves it with torch + numpy. A train op in a signature
    raises. Without signatures only the variables and the metadata are
    written. Every replica calls ``save`` (reading a sharded variable is
    a collective); rank 0 of the default group writes.
    """

    def __init__(self, export_dir):
        self.export_dir = export_dir
        self._saved = False

    def add_meta_graph_and_variables(self, sess, tags,
                                     signature_def_map=None):
        self._sess = sess
        self._tags = list(tags)
        self._signatures = signature_def_map or {}
        return self

    def save(self):
        if self._saved:
            raise RuntimeError('SavedModelBuilder.save called twice')
        from autodist_tpu_torch.checkpoint.export import (FORMAT,
                                                          export_servable)
        from autodist_tpu_torch.frontend import graph as fe
        sess = self._sess
        names = sorted(sess._graph_item.graph.variables)
        tree = {name: torch.as_tensor(sess.get_variable_value(name),
                                      device=sess._device)
                for name in names}
        if dist.is_available() and dist.is_initialized() and \
                dist.get_rank() != 0:
            self._saved = True
            return self.export_dir
        for i, (sig_name, (outputs, inputs)) in \
                enumerate(self._signatures.items()):
            out_nodes = outputs if isinstance(outputs, (list, tuple)) \
                else [outputs]
            out_nodes = [o.read() if isinstance(o, fe.Variable) else o
                         for o in out_nodes]
            for o in out_nodes:
                if isinstance(o, fe.ApplyGradients):
                    raise ValueError(
                        'signature %r exports a train op; servable '
                        'signatures must be forward-only' % sig_name)
            in_phs = list(inputs)

            def make_fn(nodes, phs):
                def fn(params, *feeds):
                    env = fe.Env(dict(params), dict(zip(phs, feeds)))
                    env.device = sess._device
                    return [fe.evaluate(n, env) for n in nodes]
                return fn

            export_servable(
                make_fn(out_nodes, in_phs), tree,
                [(ph.shape, ph.dtype) for ph in in_phs],
                self.export_dir, signature=sig_name, tags=self._tags,
                input_names=[ph.name for ph in in_phs],
                write_params=(i == 0))
        if not self._signatures:
            save_pytree(os.path.join(self.export_dir, 'variables'), tree)
            meta = {'format': FORMAT, 'tags': self._tags, 'signatures': {}}
            with open(os.path.join(self.export_dir, 'saved_model.json'),
                      'w') as f:
                json.dump(meta, f, indent=1, sort_keys=True)
        self._saved = True
        return self.export_dir
