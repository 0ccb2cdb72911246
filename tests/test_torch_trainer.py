"""Port Trainer against the JAX Trainer, and data parallelism over gloo.

Tolerances (f32): losses 1e-5 relative. Params after adamw steps 2e-6
absolute: each step moves a param by about lr = 1e-4 (Adam normalizes
the gradient), so gradient differences at the 1e-6 relative level move
params by far less than that. The small ResNet under sgd(0.1, momentum
0.9): params and EMA buffers after 3 steps 2e-5 absolute; a step moves a
param by lr times its gradient, and the gradients agree to about 1e-5
of their size (tests/test_torch_vision.py), carried over 3 steps.
"""
import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from autodist_tpu.api import Trainer as JTrainer
from autodist_tpu.models import vision as jv
from autodist_tpu.models.transformer import TransformerConfig as JConfig
from autodist_tpu.models.transformer import TransformerLM as JLM
from autodist_tpu.parallel.axes import ParallelSpec as JSpec
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu.strategy import builders as jbuilders
from autodist_tpu.strategy.adapter import \
    trainer_from_strategy as j_trainer_from_strategy
from autodist_tpu_torch import optim
from autodist_tpu_torch.api import Trainer
from autodist_tpu_torch.models import vision as tv
from autodist_tpu_torch.models.transformer import (TransformerConfig,
                                                   TransformerLM)
from autodist_tpu_torch.models.weights import flatten_tree
from autodist_tpu_torch.parallel.axes import ParallelSpec
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy import builders
from autodist_tpu_torch.strategy.adapter import trainer_from_strategy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _batch(b=4, s=32, seed=0):
    rng = np.random.RandomState(seed)
    return {'tokens': rng.randint(0, 256, (b, s), dtype=np.int32),
            'targets': rng.randint(0, 256, (b, s), dtype=np.int32)}


def _port_run(steps, params=None, seed=0):
    model = TransformerLM(TransformerConfig.tiny(dtype=torch.float32),
                          device='cpu')
    tr = Trainer(model, optim.adamw(1e-4))
    state = tr.init(seed=seed, params=params)
    losses = []
    for _ in range(steps):
        state, m = tr.step(state, _batch())
        losses.append(float(m['loss']))
    assert state.step == steps
    return losses, tr.get_params(state)


def test_adamw_steps_match_jax_trainer():
    jm = JLM(JConfig.tiny(dtype=jnp.float32))
    jtr = JTrainer(jm, optax.adamw(1e-4), spec=JSpec(dp=1))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    state = jtr.init(jax.random.PRNGKey(0), params=jp)
    want = []
    for _ in range(3):
        state, m = jtr.step(state, _batch())
        want.append(float(m['loss']))
    want_params = jtr.get_params(state)

    losses, params = _port_run(3, params=jp)
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    got, ref = dict(flatten_tree(params)), dict(flatten_tree(want_params))
    assert got.keys() == ref.keys()
    for path in ref:
        np.testing.assert_allclose(got[path], ref[path], atol=2e-6,
                                   rtol=0, err_msg='/'.join(path))


_DP_WORKER = r'''
import sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group('gloo', init_method='tcp://127.0.0.1:' + port,
                        world_size=2, rank=rank)
from autodist_tpu_torch import optim
from autodist_tpu_torch.api import Trainer
from autodist_tpu_torch.models import vision as tv
from autodist_tpu_torch.models.transformer import (TransformerConfig,
                                                   TransformerLM)
from autodist_tpu_torch.models.weights import flatten_tree
from autodist_tpu_torch.parallel.axes import ParallelSpec
model = TransformerLM(TransformerConfig.tiny(dtype=torch.float32),
                      device='cpu', seed=rank)   # rank 0's init wins
tr = Trainer(model, optim.adamw(1e-4), spec=ParallelSpec(dp=2))
state = tr.init(seed=0)
rng = np.random.RandomState(0)
batch = {'tokens': rng.randint(0, 256, (4, 32), dtype=np.int32),
         'targets': rng.randint(0, 256, (4, 32), dtype=np.int32)}
assert tr.shard_batch(batch)['tokens'].shape == (2, 32)
losses = [float(tr.step(state, batch)[1]['loss']) for _ in range(3)]
flat = {'/'.join(p): v for p, v in flatten_tree(tr.get_params(state))}
np.savez(out % rank, losses=np.asarray(losses), **flat)
dist.destroy_process_group()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def test_gloo_dp2_equals_single_process(tmp_path):
    out = str(tmp_path / 'rank%d.npz')
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, '-c', _DP_WORKER, str(r),
                               port, out], env=env, cwd=str(tmp_path))
             for r in range(2)]
    for p in procs:
        assert p.wait(timeout=120) == 0
    losses, params = _port_run(3)
    ranks = [np.load(out % r) for r in range(2)]
    for r in ranks:
        np.testing.assert_allclose(r['losses'], losses, rtol=1e-5)
        for path, v in flatten_tree(params):
            np.testing.assert_allclose(r['/'.join(path)], v, atol=2e-6,
                                       rtol=0, err_msg='/'.join(path))


def _images_batch(b=4, seed=0):
    rng = np.random.RandomState(seed)
    return {'images': rng.randn(b, 32, 32, 3).astype(np.float32),
            'labels': rng.randint(0, 10, (b,)).astype(np.int32)}


def _jax_resnet_run(dp, steps=3):
    """The JAX Trainer on ResNet((1, 1)) at ``dp`` (GSPMD over the CPU
    mesh: its BatchNorm statistics are over the global batch)."""
    jm = jv.ResNet((1, 1), num_classes=10)
    jtr = JTrainer(jm, optax.sgd(0.1, momentum=0.9), spec=JSpec(dp=dp))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    state = jtr.init(jax.random.PRNGKey(0), params=jp)
    losses = []
    for _ in range(steps):
        state, m = jtr.step(state, _images_batch())
        losses.append(float(m['loss']))
    return jp, losses, jtr.get_params(state)


def _assert_params_close(got, want, atol):
    got, want = dict(flatten_tree(got)), dict(flatten_tree(want))
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=atol, rtol=0,
                                   err_msg='/'.join(path))


@pytest.mark.parametrize('fused', ['0', '1'], ids=['unfused', 'fused'])
def test_sgd_steps_small_resnet_match_jax_trainer(fused, monkeypatch):
    """3 steps of sgd(0.1, momentum=0.9): losses, params and the EMA
    buffers, which advance through the state channel."""
    monkeypatch.setenv('AUTODIST_FUSED_CONV', fused)
    jp, want, want_params = _jax_resnet_run(dp=1)
    model = tv.ResNet((1, 1), num_classes=10, device='cpu')
    tr = Trainer(model, optim.sgd(0.1, momentum=0.9))
    state = tr.init(params=jp)
    assert not any(b.requires_grad for b in model.buffers())
    losses = [float(tr.step(state, _images_batch())[1]['loss'])
              for _ in range(3)]
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    got = tr.get_params(state)
    assert not np.allclose(
        got['block_000']['a']['bn']['ema_var'],
        jp['block_000']['a']['bn']['ema_var'])   # the EMAs did move
    _assert_params_close(got, want_params, 2e-5)


_RESNET_DP_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, port, params, out = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                           sys.argv[4])
dist.init_process_group('gloo', init_method='tcp://127.0.0.1:' + port,
                        world_size=2, rank=rank)
from autodist_tpu_torch import optim
from autodist_tpu_torch.api import Trainer
from autodist_tpu_torch.models import vision
from autodist_tpu_torch.models.weights import flatten_tree
from autodist_tpu_torch.parallel.axes import ParallelSpec
flat = np.load(params)
tree = {}
for name in flat.files:
    node = tree
    *head, leaf = name.split('/')
    for k in head:
        node = node.setdefault(k, {})
    node[leaf] = flat[name]
model = vision.ResNet((1, 1), num_classes=10, device='cpu', seed=rank)
tr = Trainer(model, optim.sgd(0.1, momentum=0.9), spec=ParallelSpec(dp=2))
state = tr.init(params=tree if rank == 0 else None)   # rank 0's params win
rng = np.random.RandomState(0)
batch = {'images': rng.randn(4, 32, 32, 3).astype(np.float32),
         'labels': rng.randint(0, 10, (4,)).astype(np.int32)}
losses = [float(tr.step(state, batch)[1]['loss']) for _ in range(3)]
flat = {'/'.join(p): v for p, v in flatten_tree(tr.get_params(state))}
np.savez(out % rank, losses=np.asarray(losses), **flat)
dist.destroy_process_group()
"""


@pytest.mark.parametrize('fused', ['0', '1'], ids=['unfused', 'fused'])
def test_gloo_dp2_small_resnet_matches_jax_trainer_dp2(fused, tmp_path):
    """Two gloo ranks, each on half of the batch, against the JAX Trainer
    at dp = 2. The JAX BatchNorm normalizes over the global batch, so
    this holds only if the port sums its moments over the group (both
    arms: the reduction's and the fused kernel's)."""
    jp, want, want_params = _jax_resnet_run(dp=2)
    params = str(tmp_path / 'init.npz')
    np.savez(params, **{'/'.join(p): v for p, v in flatten_tree(jp)})
    out = str(tmp_path / 'rank%d.npz')
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=REPO, AUTODIST_FUSED_CONV=fused)
    procs = [subprocess.Popen([sys.executable, '-c', _RESNET_DP_WORKER,
                               str(r), port, params, out], env=env,
                              cwd=str(tmp_path)) for r in range(2)]
    for p in procs:
        assert p.wait(timeout=120) == 0
    for r in range(2):
        got = np.load(out % r)
        np.testing.assert_allclose(got['losses'], want, rtol=1e-5)
        for path, v in flatten_tree(want_params):
            np.testing.assert_allclose(got['/'.join(path)], v, atol=2e-5,
                                       rtol=0, err_msg='/'.join(path))


_RESOURCES = {'nodes': [{'address': 'localhost', 'chief': True,
                         'cpus': [0], 'gpus': [0], 'network_bandwidth': 100}]}


_MODELS = {
    'lm': (lambda: JLM(JConfig.tiny(dtype=jnp.float32)),
           lambda: TransformerLM(TransformerConfig.tiny(dtype=torch.float32),
                                 device='cpu')),
    'resnet': (lambda: jv.ResNet((1, 1), num_classes=10),
               lambda: tv.ResNet((1, 1), num_classes=10, device='cpu')),
}


@pytest.mark.parametrize('builder,model', [
    pytest.param(b, m, id=b if m == 'lm' else '%s-%s' % (b, m))
    for m in ('lm', 'resnet')
    for b in ('AllReduce', 'PartitionedPS', 'Parallax')])
def test_strategy_node_config_matches_jax(builder, model):
    """Same model, same resources: the same node_config (strategy id
    aside). A partitioned placement is a no-op at dp = 1 in both. The
    small ResNet's BatchNorm running statistics are variables in both."""
    make_jax, make_port = _MODELS[model]
    jtr = j_trainer_from_strategy(
        make_jax(), optax.adamw(1e-4), getattr(jbuilders, builder)(),
        resource_spec=JResourceSpec(resource_info=_RESOURCES))
    tr = trainer_from_strategy(
        make_port(), optim.adamw(1e-4), getattr(builders, builder)(),
        resource_spec=ResourceSpec(resource_info=_RESOURCES))
    got = [dataclasses.asdict(n) for n in tr.strategy.node_config]
    want = [dataclasses.asdict(n) for n in jtr.strategy.node_config]
    assert got == want
    assert tr.strategy.graph_config.replicas == \
        jtr.strategy.graph_config.replicas
    assert tr.strategy.id != ''


def test_spec_beyond_dp_raises():
    """Every axis constructs and resolves (the pipeline too, with its
    schedule options); an unknown pipeline schedule or 1F1B variant
    raises and names the option."""
    spec = ParallelSpec(pp=2, microbatches=4, pp_schedule='1f1b',
                        pp_variant='stash')
    assert spec.resolve_dp(8) == 4
    with pytest.raises(ValueError, match='pp_schedule'):
        ParallelSpec(pp=2, pp_schedule='interleaved')
    with pytest.raises(ValueError, match='pp_variant'):
        ParallelSpec(pp=2, pp_variant='zb')
    spec = ParallelSpec(tp=2, ep=2, dcn_dp=2)
    assert (spec.tp, spec.ep, spec.dcn_dp) == (2, 2, 2)
    assert spec.resolve_dp(8) == 2
    assert ParallelSpec(tp=4).resolve_dp(4) == 1
    with pytest.raises(ValueError):
        ParallelSpec(tp=3).resolve_dp(4)
    spec = ParallelSpec(sp=2, sp_mode='ulysses', zero=3)
    assert (spec.sp, spec.sp_mode, spec.zero) == (2, 'ulysses', 3)
    assert spec.resolve_dp(4) == 2
    with pytest.raises(ValueError):
        ParallelSpec(dp=2).resolve_dp(1)
    with pytest.raises(ValueError):
        ParallelSpec(sp=3).resolve_dp(4)
    with pytest.raises(ValueError, match='sp_mode'):
        ParallelSpec(sp_mode='tree')
    assert ParallelSpec().resolve_dp(3) == 3


def test_spec_for_axes_matches_jax_on_a_data_seq_grid():
    """The logical-axis rules bind as the JAX package's do, over the
    grid's axis sizes in place of a mesh."""
    from autodist_tpu.parallel.axes import DEFAULT_RULES as J_RULES
    from autodist_tpu.parallel.axes import spec_for_axes as j_spec_for_axes
    from autodist_tpu_torch.parallel.axes import (DEFAULT_RULES,
                                                  spec_for_axes)
    assert DEFAULT_RULES == J_RULES
    mesh = JSpec(dp=2, sp=2).build_mesh(jax.devices()[:4])
    rules = [list(r) for r in DEFAULT_RULES]
    for axes in (('batch', 'seq', 'embed'), ('embed', 'mlp'),
                 ('seq', 'seq'), ('vocab', 'embed'), ('batch',), None):
        assert spec_for_axes(axes, rules, dict(mesh.shape)) == \
            tuple(j_spec_for_axes(axes, rules, mesh)), axes


def test_spec_round_trips_with_the_jax_spec(monkeypatch):
    """A JAX spec's dict loads in the port with no field dropped, and the
    port's dict loads in JAX, field for field."""
    from autodist_tpu_torch.parallel import axes
    dropped = []
    monkeypatch.setattr(axes.logging, 'warning',
                        lambda *a, **k: dropped.append(a))
    jd = JSpec(dp=2, sp=2, sp_mode='ulysses', zero=3, microbatches=4,
               grad_accum=2, remat='full').to_dict()
    spec = ParallelSpec.from_dict(jd)
    assert not dropped
    assert spec.to_dict() == jd
    assert JSpec.from_dict(spec.to_dict()) == JSpec(**jd)
    assert ParallelSpec().to_dict() == JSpec().to_dict()
