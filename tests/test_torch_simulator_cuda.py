"""The simulator's measured mode on four cards over NCCL.

The file imports no jax, so it runs on a machine with the cards:

    python -m pytest --noconftest -m cuda tests/test_torch_simulator_cuda.py

It skips below four CUDA cards. One worker process per card runs the
program of ``bench.py:_bench_roofline_inner`` at dp = 4: eight [256, 256]
f32 weights and their [256] biases (two byte classes, so a fit can
separate α from β) under ``AllReduce(chunk_size=2)``, the gradients
synced by ``ExecutionPlan.sync_gradients`` and applied by an Adam-style
update, 10 profiled steps after 3 warm-up steps and 3 more inside the
profiler. A collective's kernel time on a rank is its transfer plus its
wait for the last rank to reach it, so the ranks must reach it
together: each takes 262144 rows of the batch, so the step is
device-bound (the JAX program's 8 left it host-bound, and three of four
H100s spent 450-570 µs in each all-reduce waiting for the fourth, whose
own took 12-40 µs); the profiler's warm-up steps absorb the ranks'
different tracer start-up times (without them the first bucket waited
36 ms on three ranks); no host read stalls a queue inside the traced
steps; and the timeline reads every rank's trace, taking each bucket's
median and the least over the ranks (one card reached each step's
first bucket 55-180 µs after the other three, a median over the
steps). Checks, on every rank:

- the trace's collective timeline has one row per bucket of the static
  schedule, each counted once a step;
- ``calibrate_from_trace`` fits NVLink's α and β (finite, β > 0);
- ``drift_table`` joins every schedule entry to a timeline row;
- under ``AUTODIST_HIERARCHY_NODES=2`` the two-level AllReduce
  (``hierarchical='always'``, every bucket over node groups [[0, 1],
  [2, 3]]) trains 10 sgd steps within tolerance of the flat one: the
  two levels sum in another order than NCCL's flat ring, so losses
  agree to 1e-6 relative and params to 1e-6 absolute (sgd 0.1 moves a
  param by lr times a gradient that differs by f32 rounding).

Each rank writes its readings (fitted α and β, the drift ratios, the
timeline) as JSON under the test's temporary directory; pass
``--basetemp`` to keep them.

``python tests/test_torch_simulator_cuda.py gloo <dir>`` runs the same
program on the CPU in four gloo processes (8 rows a rank), to find
faults before a four-card run.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
STEPS = 10
ROWS = 262144      # a rank's share of the batch (see above)

_RUN = r'''
import json
import os
import shutil
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile, schedule

from autodist_tpu_torch.frontend import graph as fe
from autodist_tpu_torch.parallel.mesh import ReplicaGroup
from autodist_tpu_torch.parallel.plan import (ExecutionPlan,
                                              static_collective_schedule)
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.simulator.calibrate import (calibrate_from_drift,
                                                    calibrate_from_trace)
from autodist_tpu_torch.simulator.cost_model import CostModelParams
from autodist_tpu_torch.strategy import AllReduce, PytreeGraphItem
from autodist_tpu_torch.telemetry import roofline as rl
from autodist_tpu_torch.utils.profiling import collective_timeline

rank, world, port, out, backend, steps, rows = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
    sys.argv[5], int(sys.argv[6]), int(sys.argv[7]))
N_VARS, DIM, CHUNK, WARMUP = 8, 256, 2, 3
cuda = backend == 'nccl'
if cuda:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(rank)
    device = torch.device('cuda', rank)
    dist.init_process_group('nccl', init_method='tcp://127.0.0.1:' + port,
                            world_size=world, rank=rank, device_id=device)
    kind = torch.cuda.get_device_name(rank)
else:
    device = torch.device('cpu')
    dist.init_process_group('gloo', init_method='tcp://127.0.0.1:' + port,
                            world_size=world, rank=rank)
    kind = 'cpu'


class Layers(torch.nn.Module):
    """_bench_roofline_inner's variables: weights v00.. (normal 0.05)
    and biases zb00.. (zeros), from one seed on every rank."""

    def __init__(self):
        super().__init__()
        rng = np.random.RandomState(0)
        for i in range(N_VARS):
            self.register_parameter('v%02d' % i, torch.nn.Parameter(
                torch.from_numpy((rng.randn(DIM, DIM) * 0.05).astype('f4'))
                .to(device)))
            self.register_parameter('zb%02d' % i, torch.nn.Parameter(
                torch.zeros(DIM, device=device)))

    def params(self):
        return dict(self.named_parameters())

    def axes(self):
        return {k: (None,) * p.dim() for k, p in self.named_parameters()}


spec = ResourceSpec(resource_info={
    'nodes': [{'address': 'localhost', 'chief': True, 'cpus': [0],
               'gpus': list(range(world)), 'network_bandwidth': 100}],
    'topology': {'device_kind': kind}})
x = torch.randn(rows, DIM, generator=torch.Generator().manual_seed(1 + rank))
x = x.to(device)


def program(builder, update):
    model = Layers()
    gi = PytreeGraphItem(model)
    strategy = builder.build(gi, spec)
    plan = ExecutionPlan(strategy, gi, ReplicaGroup(world, rank,
                                                    device=device))
    sources = list(gi.trainable_var_op_to_var.values())
    params = [model.params()[v.name] for v in sources]
    slots = [(torch.zeros_like(p), torch.zeros_like(p)) for p in params]

    def step():
        h = x
        for i in range(N_VARS):
            h = h @ model.params()['v%02d' % i] + \
                model.params()['zb%02d' % i]
        loss = (h * h).mean()
        grads = torch.autograd.grad(loss, params)
        synced = plan.sync_gradients(sources, list(grads), fe.Env({}, {}))
        with torch.no_grad():
            for p, g, (m, v) in zip(params, synced, slots):
                if update == 'adam':
                    m.mul_(0.9).add_(0.1 * g)
                    v.mul_(0.999).add_(0.001 * g * g)
                    p.sub_(1e-3 * m / (v.sqrt() + 1e-8))
                else:
                    p.sub_(0.1 * g)
        return loss.detach()
    return strategy, gi, plan, params, step


res = {'kind': kind}
strategy, gi, plan, params, step = program(AllReduce(chunk_size=CHUNK),
                                           'adam')
for _ in range(3):
    float(step())
dist.barrier()
trace_dir = os.path.join(out, 'traces')
os.makedirs(trace_dir, exist_ok=True)
activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                       if cuda else [])
# the profiler's own warm-up steps (traced, then dropped) absorb the
# ranks' different tracer start-up times; no host read stalls a queue
# inside the traced steps
with profile(activities=activities, record_shapes=True,
             schedule=schedule(wait=0, warmup=WARMUP, active=steps),
             on_trace_ready=lambda p: p.export_chrome_trace(os.path.join(
                 trace_dir, 'rank%d.pt.trace.json' % rank))) as prof:
    losses = []
    for _ in range(WARMUP + steps):
        losses.append(step())
        prof.step()
    losses = [float(v) for v in losses[WARMUP:]]
dist.barrier()    # every rank's trace is written: the timeline reads all
timeline = collective_timeline(trace_dir)
schedule = static_collective_schedule(strategy, gi, world)
base = CostModelParams.from_topology(spec.topology)
fitted = calibrate_from_trace(base, trace_dir, world)
table = rl.drift_table(schedule, timeline, world, params=base)
refit = calibrate_from_drift(base, table, world)
res.update(
    losses=losses,
    timeline=[[d.kind, d.nbytes, d.ranks, ns, cnt]
              for d, ns, cnt in timeline],
    schedule=[[e['entry_id'], e['kind'], e['bytes']] for e in schedule],
    traced_ids=[e['entry_id'] for e in plan.last_bucket_stats],
    analytic_ici=list(base.link(cross_node=False)),
    fitted={'calibrated': fitted.calibrated, 'alpha_s': fitted.alpha_ici_s,
            'beta_s_per_byte': fitted.beta_ici_s_per_byte},
    refit_from_drift={'calibrated': refit.calibrated,
                      'alpha_s': refit.alpha_ici_s,
                      'beta_s_per_byte': refit.beta_ici_s_per_byte},
    drift=[{k: row[k] for k in ('entry_id', 'bytes', 'predicted_s',
                                'achieved_s', 'drift_ratio',
                                'achieved_bytes_per_s')}
           for row in table['entries']],
    drift_tiers=table['tiers'], unmatched_rows=table['unmatched_rows'],
    drift_text=rl.format_drift_table(table))

# the two-level AllReduce against flat, under AUTODIST_HIERARCHY_NODES=2
os.environ['AUTODIST_HIERARCHY_NODES'] = '2'
runs = {}
for knob in ('never', 'always'):
    _, _, plan, params, step = program(
        AllReduce(chunk_size=CHUNK, hierarchical=knob), 'sgd')
    losses = [float(step()) for _ in range(steps)]
    runs[knob] = {'losses': losses,
                  'hier': [b['hier'] for b in plan.last_bucket_stats],
                  'node_groups': plan.hier_groups,
                  'params': [p.detach().cpu().numpy().tolist()
                             for p in params]}
res['hierarchical'] = runs
with open(os.path.join(out, 'rank%d.json' % rank), 'w') as f:
    json.dump(res, f)
dist.barrier()    # every rank has read the traces (tens of MB a rank)
if rank == 0:
    shutil.rmtree(trace_dir)
dist.destroy_process_group()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def run(out, backend, world=WORLD, steps=STEPS, rows=ROWS):
    """Start the ``world`` ranks; returns their exit codes and, when all
    succeeded, each rank's readings."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, '-c', _RUN, str(r),
                               str(world), port, out, backend, str(steps),
                               str(rows)], env=env) for r in range(world)]
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(codes):
        return codes, None
    readings = []
    for r in range(world):
        with open(os.path.join(out, 'rank%d.json' % r)) as f:
            readings.append(json.load(f))
    return codes, readings


@pytest.fixture(scope='module')
def readings(tmp_path_factory):
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < WORLD:
        pytest.skip('needs %d CUDA cards' % WORLD)
    codes, out = run(str(tmp_path_factory.mktemp('sim')), 'nccl')
    assert codes == [0] * WORLD
    return out


@pytest.mark.cuda
def test_timeline_has_one_row_per_bucket(readings):
    for r in readings:
        assert len(r['timeline']) == len(r['schedule']) == 8
        assert sorted(t[1] for t in r['timeline']) == \
            sorted(e[2] for e in r['schedule'])
        assert all(t[0] == 'all-reduce' and t[4] == STEPS
                   for t in r['timeline'])
        assert sorted(r['traced_ids']) == sorted(e[0] for e in r['schedule'])


@pytest.mark.cuda
def test_calibrate_from_trace_fits_nvlink(readings):
    for r in readings:
        fit = r['fitted']
        assert fit['calibrated']
        assert np.isfinite(fit['alpha_s']) and fit['alpha_s'] >= 0
        assert np.isfinite(fit['beta_s_per_byte']) and \
            fit['beta_s_per_byte'] > 0


@pytest.mark.cuda
def test_drift_table_joins_every_entry(readings):
    for r in readings:
        assert r['unmatched_rows'] == 0
        for row in r['drift']:
            assert row['achieved_s'] is not None and row['drift_ratio'] > 0
        assert r['refit_from_drift']['calibrated']


@pytest.mark.cuda
def test_two_level_allreduce_trains_within_tolerance_of_flat(readings):
    for r in readings:
        flat, two = r['hierarchical']['never'], r['hierarchical']['always']
        assert two['node_groups'] == [[0, 1], [2, 3]]
        assert two['hier'] and all(h == 2 for h in two['hier'])
        assert all(h == 0 for h in flat['hier'])
        np.testing.assert_allclose(two['losses'], flat['losses'], rtol=1e-6)
        for a, b in zip(two['params'], flat['params']):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


if __name__ == '__main__':
    codes, out = run(sys.argv[2], sys.argv[1], rows=8)
    print(codes)
    sys.exit(1 if any(codes) else 0)
