"""The readings that the limits of ``correct`` are set from (not part of
a benchmark run).

    python3 perfbench/readings.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds ...] [--faults half_batch,no_exchange,frozen] \\
        [--fault-seeds ...] [--out FILE]

For each seed it runs the program's first steps as a run does (the same
weights, feed, call and readings), the plain reference, and prints the
three numbers of ``check.py`` as one JSON line; for a control seed also
the control (the reference with float8 matmuls) in the program's place;
for a fault, the program with that fault planted:

- ``half_batch``: the loss takes the mean over the first half of the
  rows, the rest left out;
- ``no_exchange``: the gradients are not summed over the cards (the
  collective left out, the division kept);
- ``frozen``: the optimizer's step does nothing, so the step returns
  its state unchanged.
"""
import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def plant(fault):
    """Plant ``fault`` in the program (see the module docstring); returns
    the undo."""
    import autodist_tpu_torch.api as api
    if fault == 'frozen':
        real = api.Trainer._step

        def frozen(self, state, batch):
            state.opt_state.step = lambda *a, **kw: None
            try:
                return real(self, state, batch)
            finally:
                del state.opt_state.step
        api.Trainer._step = frozen
        return lambda: setattr(api.Trainer, '_step', real)
    if fault == 'half_batch':
        real = api.Trainer.loss_for

        def half(self, params, batch):
            n = batch['tokens'].shape[0] // 2
            return real(self, params, {k: v[:n] for k, v in batch.items()})
        api.Trainer.loss_for = half
        return lambda: setattr(api.Trainer, 'loss_for', real)
    if fault == 'no_exchange':
        real = api._sum

        def local(group, tensors, divide=1):
            for t in tensors:
                t.div_(divide)
        api._sum = local
        return lambda: setattr(api, '_sum', real)
    raise ValueError('fault %r' % (fault,))


def readings_rank(spec, job, rank, world, device):
    import torch

    from perfbench import check, harness
    from perfbench import traffic as traffic_gen
    from perfbench.reference import control
    from perfbench.reference import run as ref_run
    device = torch.device(device)
    config = spec['config']
    trainer = harness.build_program(spec, device)
    n = harness.COMPARED_STEPS
    refs, lines = {}, []
    plan = [(None, s) for s in job['seeds']] + \
        [('control', s) for s in job.get('control_seeds', [])] + \
        [(f, s) for f in job.get('faults', []) for s in
         job.get('fault_seeds', [])]
    for variant, seed in plan:
        weights = harness.make_weights(config, seed, device)
        batches = traffic_gen.ring(spec['traffic'],
                                   config['model']['vocab'], seed)[:n]
        if seed not in refs:
            refs[seed] = ref_run.readings(weights, config, batches, device,
                                          rank=rank, world=world)
        if variant == 'control':
            got = ref_run.readings(weights, config, batches, device,
                                   mm=control.fp8_mm, rank=rank,
                                   world=world)
        else:
            state = trainer.init(params=harness.nest(weights))
            undo = plant(variant) if variant else (lambda: None)
            try:
                state, got = harness.first_steps(
                    spec, trainer, state, trainer.compile_step(state, None),
                    batches, weights, device)
            finally:
                undo()
            del state
        line = {'cell': spec['name'], 'variant': variant or 'program',
                'seed': seed, 'numbers': check.numbers(got, refs[seed]),
                'losses': got['losses'], 'ref_losses': refs[seed]['losses']}
        if rank == 0:
            print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


def main(argv=None):
    sys.path.insert(0, ROOT)
    import run
    run.fixed_caches()
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', default='')
    p.add_argument('--control-seeds', default='')
    p.add_argument('--faults', default='')
    p.add_argument('--fault-seeds', default='')
    p.add_argument('--out')
    a = p.parse_args(argv)

    def ints(s):
        return [int(x) for x in s.split(',') if x]
    from perfbench import harness
    spec = harness.load_spec(a.workload, ROOT)
    job = {'seeds': ints(a.seeds), 'control_seeds': ints(a.control_seeds),
           'faults': [f for f in a.faults.split(',') if f],
           'fault_seeds': ints(a.fault_seeds)}
    lines = run.launch({'spec': spec, 'readings': job,
                        'world': spec['chips']})
    if lines is None:
        return 5
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, 'a') as f:
            for line in lines:
                f.write(json.dumps(line) + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
