"""One run of one cell: set-up, the measured window, the traced steps,
the reference and the result line.

The entry under test is the port's training step as the configuration's
program module builds it (``programs/<program>.py``; for
``transformer_lm``: ``trainer_from_strategy(TransformerLM(cfg),
<optimizer>, AllReduce(), spec=ParallelSpec(**cell['spec']))``), loaded
with the benchmark's seeded weights through ``Trainer.init(params=...)``,
driven through the step callable of ``Trainer.compile_step`` on batches
placed by ``Trainer.shard_batch``, each step fenced by the host read of
its loss.

A run:

1. makes the weights on the card from the seed, and a ring of distinct
   global batches from the cell's traffic file;
2. runs the first ``COMPARED_STEPS`` steps through the window's own call
   and feed, reading each loss, the first gradient (from the
   optimizer's state) and each leaf's change; then ``WARMUP_STEPS``
   more, so that nothing compiles or grows inside the window;
3. measures for ``seconds``: every step's time, and the host time of
   the step call alone;
4. with ``trace``, runs ``TRACED_STEPS`` more under ``torch.profiler``;
5. frees the program's state and runs the plain reference over the same
   weights and the first batches, then compares (``check.py``).
"""
import gc
import importlib.util
import json
import math
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from perfbench import check, trace
from perfbench import traffic as traffic_gen
from perfbench.reference import run as ref_run

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
COMPARED_STEPS = 3
WARMUP_STEPS = 2
TRACED_STEPS = 8
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'autodist_tpu')
GIB = 2 ** 30


def load_spec(workload, root=ROOT):
    """The cell's entry of ``BENCHMARK.json`` with its cell, configuration
    and traffic files, and the metrics it reports, all found by name.
    Raises where the configuration names a program, reference or
    optimizer that has no module, before anything runs."""
    with open(os.path.join(root, 'BENCHMARK.json')) as f:
        bench = json.load(f)
    entry = {w['name']: w for w in bench['workloads']}.get(workload)
    if entry is None:
        raise SystemExit('perfbench: no workload %r in BENCHMARK.json'
                         % workload)
    bench_dir = os.path.join(root, 'perfbench')

    def load(kind, name):
        with open(os.path.join(bench_dir, kind, name + '.json')) as f:
            return json.load(f)

    def mine(metrics):
        return [m for m in metrics if workload in m.get('workloads',
                                                        [workload])]
    config = load('configs', entry['config'])
    for kind, name in module_files(config):
        if not (name.isidentifier() and os.path.isfile(
                os.path.join(bench_dir, kind, name + '.py'))):
            raise SystemExit('perfbench: configuration %s names %r, which '
                             'has no perfbench/%s/%s.py'
                             % (entry['config'], name, kind, name))
    return {'name': workload, 'chips': entry['chips'],
            'cell': load('cells', workload),
            'config': config,
            'traffic': load('traffic', entry['traffic']),
            'end_to_end': mine(bench['end_to_end']),
            'per_layer': mine(bench['per_layer']),
            'bench_dir': bench_dir}


def module_files(config):
    """(directory under perfbench, module name) of each module that the
    configuration names: its program and the program's optimizer, its
    plain reference and the reference's optimizer."""
    opt = config['optimizer']['name']
    return [('programs', config['program']), ('programs/optimizers', opt),
            ('reference', config['reference']),
            ('reference/optimizers', opt)]


def reader(bench_dir, name):
    """The ``read(record)`` of ``metrics/<name>.py``."""
    path = os.path.join(bench_dir, 'metrics', name + '.py')
    mod_spec = importlib.util.spec_from_file_location(
        'perfbench_metric_' + name.replace('.', '_'), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def make_weights(config, seed, device):
    """{path: f32 numpy array} of every leaf, drawn on ``device`` from
    ``seed`` in one call and scaled by leaf (the ``param_specs`` of the
    configuration's reference model)."""
    specs = ref_run.model_module(config).param_specs(config['model'])
    sizes = [math.prod(shape) for shape, _ in specs.values()]
    g = torch.Generator(device=device)
    g.manual_seed(seed % traffic_gen.SEED_SPACE)
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out, off = {}, 0
    for (path, (shape, (law, a))), n in zip(specs.items(), sizes):
        t = flat[off:off + n].view(shape)
        off += n
        t = t * 0.02 + a if law == 'offset' else t * a
        out[path] = t.cpu().numpy()
    return out


def nest(flat):
    """{'a/b': x} -> {'a': {'b': x}}."""
    out = {}
    for path, v in flat.items():
        node = out
        keys = path.split('/')
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return out


def optimizer_module(spec):
    """The port's optimizer that the configuration names."""
    return importlib.import_module('perfbench.programs.optimizers.' +
                                   spec['config']['optimizer']['name'])


def build_program(spec, device):
    """The Trainer of the cell: the configuration's program module with
    its optimizer."""
    program = importlib.import_module('perfbench.programs.' +
                                      spec['config']['program'])
    opt = optimizer_module(spec).build(spec['config']['optimizer'])
    return program.build(spec, opt, device)


class Ranks:
    """The run's ranks: rank 0 decides when the window closes and
    gathers what the others read, over a gloo group of their own."""

    def __init__(self, rank, world):
        self.rank, self.world = rank, world
        self.host = dist.new_group(backend='gloo') if world > 1 else None

    def agree(self, flag):
        if self.world == 1:
            return flag
        t = torch.tensor([int(bool(flag))])
        dist.broadcast(t, 0, group=self.host)
        return bool(t.item())

    def gather(self, obj):
        if self.world == 1:
            return [obj]
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.host)
        return out

    def barrier(self):
        if self.world > 1:
            dist.barrier(group=self.host)


def sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def first_steps(spec, trainer, state, step, batches, weights, device):
    """Run ``batches`` through the window's call and feed; the program's
    readings: each loss, the first gradient's norm by leaf (from the
    optimizer's state after one step) and each leaf's change from
    ``weights``."""
    first_gradient = optimizer_module(spec).first_gradient
    o = spec['config']['optimizer']
    names = list(state.params)
    losses, grad1 = [], None
    for batch in batches:
        state, m = step(state, trainer.shard_batch(batch))
        losses.append(float(m['loss']))
        if grad1 is None:
            slots = state.opt_state.state
            grad1 = {n: float(first_gradient(slots[state.params[n]], o)
                              .norm()) if slots[state.params[n]] else 0.0
                     for n in names}
    with torch.no_grad():
        change = torch.stack([
            (state.params[n].detach() - torch.as_tensor(
                weights[n.replace('.', '/')], device=device)).norm()
            for n in names]).tolist()
    key = {n: n.replace('.', '/') for n in names}
    return state, {'losses': losses,
                   'grad1': {key[n]: v for n, v in grad1.items()},
                   'change': {key[n]: v for n, v in zip(names, change)}}


def window(trainer, state, step, ring, start, seconds, ranks, device):
    """The measured window: steps until ``seconds`` have passed on rank
    0's clock, each timed from its feed to its loss read."""
    sync(device)
    ranks.barrier()
    step_s, dispatch_s, losses = [], [], []
    i = start
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        placed = trainer.shard_batch(ring[i % len(ring)])
        td = time.perf_counter()
        state, m = step(state, placed)
        tr = time.perf_counter()
        losses.append(float(m['loss']))
        te = time.perf_counter()
        i += 1
        step_s.append(te - ts)
        dispatch_s.append(tr - td)
        if ranks.agree(te - t0 >= seconds):
            break
    return state, t0, {'steps': len(step_s), 'seconds': te - t0,
                       'step_s': step_s, 'dispatch_s': dispatch_s,
                       'losses': losses, 'next': i}


def traced_steps(trainer, state, step, ring, start, steps, device):
    """``steps`` more steps under ``torch.profiler``, the benchmark's
    own ranges around the feed, the step, the loss read and the
    optimizer's ``step``; returns (state, this rank's record)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from autodist_tpu_torch.kernels import flash_attention as fa
    opt = state.opt_state
    inner = opt.step

    def optimizer_step(*a, **kw):
        with record_function(trace.SPAN_PREFIX + 'optimizer'):
            return inner(*a, **kw)
    activities = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    before = dict(fa.LAUNCHES)
    opt.step = optimizer_step
    sync(device)
    try:
        with profile(activities=activities) as prof:
            for j in range(steps):
                with record_function(trace.SPAN_PREFIX + 'feed'):
                    placed = trainer.shard_batch(ring[(start + j) %
                                                      len(ring)])
                with record_function(trace.SPAN_PREFIX + 'step'):
                    state, m = step(state, placed)
                with record_function(trace.SPAN_PREFIX + 'loss_read'):
                    float(m['loss'])
    finally:
        del opt.step
    launches = {k: fa.LAUNCHES[k] - before[k] for k in before}
    return state, trace.reduce(trace.export_events(prof), steps, launches)


def process_start():
    """Epoch seconds at which this process started (Linux), else now."""
    try:
        with open('/proc/self/stat') as f:
            ticks = int(f.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/stat') as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith('btime'))
        return boot + ticks / os.sysconf('SC_CLK_TCK')
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


def run_rank(spec, seed, seconds, traced, rank=0, world=1, device=None,
             started=None, log=None):
    """One rank's part of a run. Returns the result on rank 0 (without
    the import check), None on the others."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    started = process_start() if started is None else started
    device = torch.device(device or 'cuda')
    ranks = Ranks(rank, world)
    model_cfg = spec['config']['model']
    stages = [('start', started)]

    def stage(name):
        stages.append((name, time.time()))
    torch.zeros(1, device=device)
    stage('device_ready')
    weights = make_weights(spec['config'], seed, device)
    stage('weights')
    ring = traffic_gen.ring(spec['traffic'], model_cfg['vocab'], seed)
    stage('traffic')
    trainer = build_program(spec, device)
    stage('build_program')
    state = trainer.init(params=nest(weights))
    stage('init')
    step = trainer.compile_step(state, trainer.shard_batch(ring[0]))
    stage('first_feed')
    state, prog = first_steps(spec, trainer, state, step,
                              ring[:COMPARED_STEPS], weights, device)
    stage('compared_steps')
    for i in range(COMPARED_STEPS, COMPARED_STEPS + WARMUP_STEPS):
        state, out = step(state, trainer.shard_batch(ring[i % len(ring)]))
        float(out['loss'])
    stage('warmup_steps')
    if rank == 0:
        log('perfbench: set-up s ' + ', '.join(
            '%s %.3f' % (stages[i][0], stages[i][1] - stages[i - 1][1])
            for i in range(1, len(stages))))
    if device.type == 'cuda':
        sync(device)
        torch.cuda.reset_peak_memory_stats(device)
    state, t0, win = window(trainer, state, step, ring,
                            COMPARED_STEPS + WARMUP_STEPS, seconds, ranks,
                            device)
    setup_s = time.time() - (time.perf_counter() - t0) - started
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == 'cuda' else 0
    rec = None
    if traced:
        state, rec = traced_steps(trainer, state, step, ring, win['next'],
                                  TRACED_STEPS, device)
    peaks = ranks.gather(peak)
    recs = ranks.gather(rec) if traced else None
    del trainer, state, step
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    t_ref = time.time()
    ref = ref_run.readings(weights, spec['config'], ring[:COMPARED_STEPS],
                           device, rank=rank, world=world)
    if rank == 0:
        log('perfbench: reference s %.3f' % (time.time() - t_ref))
    if rank != 0:
        return None
    return result(spec, win, setup_s, max(peaks), prog, ref, recs, world,
                  device, log)


def result(spec, win, setup_s, peak, prog, ref, recs, world, device, log):
    """The result line's object (``checks`` last)."""
    failed = sum(not math.isfinite(x) for x in win['losses'])
    nums = check.numbers(prog, ref)
    ok, checks = check.verdict(nums, spec['cell']['limits'])
    tokens = spec['traffic']['seq'] * spec['traffic']['batch']
    e2e = {'tokens_per_s': win['steps'] * tokens / win['seconds'],
           'step_ms_p95': 1e3 * float(np.percentile(win['step_s'], 95)),
           'peak_mem_gib': peak / GIB,
           'setup_s': setup_s}
    units = {m['name']: m['unit'] for m in spec['end_to_end'] +
             spec['per_layer']}
    out = {'correct': bool(ok and failed == 0),
           'attempted': win['steps'], 'failed': failed}
    dev = {'platform': 'gpu' if device.type == 'cuda' else device.type,
           'kind': torch.cuda.get_device_name(device)
           if device.type == 'cuda' else 'cpu',
           'count': world, 'memory_peak_bytes': int(peak)}
    if recs is None:
        out['metrics'] = {m['name']: {'value': e2e[m['name']],
                                      'unit': m['unit']}
                          for m in spec['end_to_end']}
    else:
        rec = {'ranks': recs, 'model': spec['config']['model'],
               'traffic': spec['traffic'], 'chips': world, 'window': win}
        metrics = {}
        for m in spec['per_layer']:
            value = reader(spec['bench_dir'], m['name'])(rec)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': units[m['name']]}
        out['metrics'] = metrics
        dev['busy_s'] = sum(trace.busy_us(r) for r in recs) / 1e6 / world
        dev['window_s'] = sum(r['window_us'][1] - r['window_us'][0]
                              for r in recs) / 1e6 / world
        out['breakdown'] = trace.breakdown(recs[0])
    out['device'] = dev
    log('perfbench: %s steps %d in %.3f s, losses %s .. %s' % (
        spec['name'], win['steps'], win['seconds'], win['losses'][0],
        win['losses'][-1]))
    log('perfbench: program losses %s, reference %s' % (prog['losses'],
                                                        ref['losses']))
    out['checks'] = checks
    return out


def forbidden_modules():
    """Top-level names of loaded modules that no run may hold."""
    return sorted({m.split('.')[0] for m in sys.modules} &
                  set(FORBIDDEN))
