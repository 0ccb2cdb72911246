"""The port stands alone: no jax, no module of the JAX package.

A subprocess in which ``jax``, ``autodist_tpu`` and ``ml_dtypes`` cannot
be imported imports the port and ``chip_smoke.py`` and trains one step
of a Transformer and one of a small ResNet through the fused conv +
BatchNorm kernel's module on the CPU, one c0 step through the DSL
(``autodist_tpu_torch.AutoDist``), NCF and LSTMLM through ``fit`` with
prefetch and a checkpoint, restored into a fresh trainer, two loose
NCF steps on the bf16 wire, and imports the membership half's modules
and round-trips a staged swap plan (whose pickle names the JAX
package's classes) through them, and imports the launch
(``autodist_tpu_torch.launch``, ``runtime.coordinator``) and the
telemetry plane (``telemetry.aggregate``, ``telemetry.monitor``) and
round-trips a span batch and a monitor sample through them, imports
the analysis subsystem (two of its lints run clean) and steps LAMB, and
imports the sequence-parallel modules (``parallel.ring_attention``,
``parallel.ulysses``, ``parallel.mesh.RankGrid``) and runs both
attentions over a seq group of one, and imports ``parallel.pipeline``
and runs GPipe and 1F1B over a pipe group of one; an AST scan
finds no import of any of them in any of the port's files (its package,
its examples and ``chip_smoke.py``). The
scan tells ``autodist_tpu_torch`` from ``autodist_tpu`` by exact module
name, never by prefix.
"""
import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ('jax', 'jaxlib', 'autodist_tpu', 'ml_dtypes')

_NO_JAX = r'''
import sys
for name in ('jax', 'jaxlib', 'autodist_tpu', 'ml_dtypes'):
    sys.modules[name] = None      # any import of them now raises
import torch
import autodist_tpu_torch
import chip_smoke
import os
from autodist_tpu_torch import optim
from autodist_tpu_torch.kernels import conv_bn
from autodist_tpu_torch.models import vision
from autodist_tpu_torch.models.transformer import (TransformerConfig,
                                                   TransformerLM)
from autodist_tpu_torch.strategy import AllReduce, trainer_from_strategy
cfg = TransformerConfig.tiny(dtype=torch.float32)
trainer = trainer_from_strategy(TransformerLM(cfg, device='cpu'),
                                optim.adamw(1e-4), AllReduce())
_, losses, _ = chip_smoke.train_steps(
    trainer, chip_smoke.make_batch(cfg.vocab, 2, 16), 1)
assert len(losses) == 1 and losses[0] == losses[0]
os.environ['AUTODIST_FUSED_CONV'] = '1'
trainer = trainer_from_strategy(
    vision.ResNet((1, 1), num_classes=10, device='cpu'),
    optim.sgd(0.1, momentum=0.9), AllReduce())
_, losses, _ = chip_smoke.train_steps(
    trainer, chip_smoke.make_images(2, 32, 10), 1)
assert len(losses) == 1 and losses[0] == losses[0]
import autodist_tpu_torch as ad
loss, W, b = chip_smoke.run_linear_regression(
    chip_smoke.fresh_autodist(ad.AllReduce(), 'cpu'))
assert abs(b - chip_smoke.EXPECTED_B) <= 1e-5, b
import tempfile
from autodist_tpu_torch import LSTMLM, NCF
from autodist_tpu_torch.checkpoint.saver import CheckpointManager, Saver
from autodist_tpu_torch.data.prefetch import prefetch_to_device
import numpy as np
rng = np.random.RandomState(0)
for model, batch in (
        (NCF(16, 12, mf_dim=4, mlp_dims=(8, 4), device='cpu'),
         {'users': rng.randint(0, 16, (8,)), 'items': rng.randint(0, 12, (8,)),
          'labels': rng.randint(0, 2, (8,)).astype(np.float32)}),
        (LSTMLM(32, 8, 8, 1, device='cpu'),
         {'tokens': rng.randint(0, 32, (2, 4)),
          'targets': rng.randint(0, 32, (2, 4))})):
    trainer = trainer_from_strategy(model, optim.adam(1e-3),
                                    ad.PSLoadBalancing())
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp)
        state, hist = trainer.fit(trainer.init(seed=0), [batch] * 2,
                                  prefetch=2, checkpoint_manager=mgr)
        assert len(hist['loss']) == 2 and mgr.all_steps() == [2]
        assert trainer.restore_state(mgr, state)[1] == 2
# the loose plane on the bf16 wire, which the JAX client takes from
# ml_dtypes: one worker, two steps at pipeline depth 2
services = chip_smoke.start_services(1)
os.environ['AUTODIST_PS_WIRE_DTYPE'] = 'bf16'
try:
    losses, _, _, stats = chip_smoke.loose_single_run(
        chip_smoke.NCF_SMALL, 2, 'cpu', services[0][0], 2)
    assert len(losses) == 2 and stats['pull_bytes'] % 2 == 0
finally:
    chip_smoke.stop_services(services)
# the membership half: a staged plan names the JAX package's classes and
# decodes into the port's without importing it
from autodist_tpu_torch.parallel import reshard
from autodist_tpu_torch.runtime import coordinator, swap_keys
from autodist_tpu_torch.runtime.loose_session import admit_worker
from autodist_tpu_torch.serving import RowCache, ServingFleet
from autodist_tpu_torch.strategy.base import (PSSynchronizer, Strategy,
                                              StrategyNode)
from autodist_tpu_torch.telemetry import flight
from autodist_tpu_torch.utils import faultline, profiling
strat = Strategy('nojax')
strat.node_config.append(StrategyNode(
    var_name='w', synchronizer=PSSynchronizer(staleness=2)))
payload = swap_keys.encode_plan(1, 2, strat)
assert '"gen":1' in payload
_, _, back = swap_keys.decode_plan(payload)
assert type(back) is Strategy and back.to_dict() == strat.to_dict()
plan = faultline.FaultPlan.random(3, ['p0', 'p1'], 5,
                                  kinds=faultline.FAULT_KINDS)
assert len(plan.faults) == len(faultline.FAULT_KINDS)
flight.recorder().record('nojax', ok=True)
# the launch and the telemetry plane
import autodist_tpu_torch.launch
from autodist_tpu_torch.runtime.coordinator import Coordinator, launch_cli
from autodist_tpu_torch.telemetry import aggregate, monitor
recs = [{'name': 'step', 't0': 1.0, 'dur': 0.5, 'tags': {'step': 3}}]
assert aggregate.decode_records(aggregate.encode_records(recs)) == recs
mon = monitor.CohortMonitor(policy='warn', warmup_steps=0)
mon.ingest([dict(r, worker='p0') for r in recs])
assert mon.snapshot()['workers']['p0']['samples'] == 1
# sequence parallelism and sharded state: both attentions over a seq
# group of one, and the spec of a (data, seq) grid with ZeRO 3
from autodist_tpu_torch.parallel import mesh, ring_attention, ulysses
from autodist_tpu_torch.parallel.axes import ParallelSpec
q = torch.randn(1, 2, 16, 8)
one = mesh.ReplicaGroup(1, 0)
assert torch.allclose(ulysses.ulysses_attention(q, q, q, one),
                      ring_attention.ring_attention(q, q, q, one),
                      atol=1e-5)
assert mesh.RankGrid(1, 1, 0).shape['seq'] == 1
assert ParallelSpec(sp=2, sp_mode='ulysses', zero=3).resolve_dp(4) == 2
# pipeline parallelism: both schedules over a pipe group of one (the
# plain composition), and the spec of a pipe axis
from autodist_tpu_torch.parallel import pipeline
w = torch.randn(2, 8, 8, requires_grad=True)
x = torch.randn(4, 8)
block = lambda p, h: (torch.tanh(h @ p['w']), None)
outs = [pipeline.gpipe(block, {'w': w}, x, one, 2)[0],
        pipeline.one_f_one_b(block, {'w': w}, x, one, 2,
                             variant='remat')[0]]
assert torch.equal(outs[0], outs[1])
outs[0].sum().backward()
assert w.grad is not None
assert ParallelSpec(pp=2, microbatches=4, pp_schedule='1f1b').resolve_dp(4) \
    == 2
assert mesh.RankGrid(1, 1, 0).shape['pipe'] == 1
# the analysis subsystem and LAMB
from autodist_tpu_torch.analysis import (conformance, data_plane_model,
                                         env_lint, epoch_swap_model, explore,
                                         fence_lint, protocol_model,
                                         schedule_lint, swap_conformance)
assert fence_lint.analyze() == [] and swap_conformance.analyze() == []
p = torch.nn.Parameter(torch.ones(3))
opt = optim.lamb(1e-2)([p])
p.grad = torch.ones(3)
opt.step()
assert torch.allclose(p.detach(), torch.full((3,), 0.99))
leaked = sorted(m for m in sys.modules if m.split('.')[0] in
                ('jax', 'jaxlib', 'autodist_tpu', 'ml_dtypes') and
                sys.modules[m])
assert not leaked, leaked
print('OK')
'''


def test_port_runs_without_jax():
    out = subprocess.run([sys.executable, '-c', _NO_JAX], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith('OK')


def _port_files():
    files = [os.path.join(REPO, 'chip_smoke.py')]
    for root in ('autodist_tpu_torch', 'examples_torch'):
        for dirpath, _, names in os.walk(os.path.join(REPO, root)):
            files += [os.path.join(dirpath, n) for n in names
                      if n.endswith('.py')]
    return files


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module


def test_no_jax_or_jax_package_import_anywhere_in_the_port():
    files = _port_files()
    assert len(files) > 15
    bad = [(os.path.relpath(p, REPO), m) for p in files
           for m in _imported_modules(p) if m.split('.')[0] in FORBIDDEN]
    assert not bad, bad
    # the port's own imports are found, so the scan does see imports
    assert any(m.split('.')[0] == 'autodist_tpu_torch'
               for m in _imported_modules(files[0]))
