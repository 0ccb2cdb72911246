"""The port's training step records its phases through the telemetry
registry: ``record_function`` ranges ``autodist.trainer/*`` while a
profiler records, registry spans under ``AUTODIST_TELEMETRY``, nothing
otherwise; the step's arithmetic is the same in all three.

The ZeRO 2 case runs on two gloo processes (``torch_dsl_worlds``); its
worker is this module's :func:`zero2_ranges`. This module imports no
jax, so the spawned processes never load it."""
import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from autodist_tpu_torch import optim
from autodist_tpu_torch.api import Trainer
from autodist_tpu_torch.models.transformer import (TransformerConfig,
                                                   TransformerLM)
from autodist_tpu_torch.parallel.axes import ParallelSpec
from autodist_tpu_torch.telemetry import core, monitor
from torch_dsl_worlds import run_group
from torch_trainer_cases import MOE_TINY, lm_batch

TRAINER = 'autodist.trainer/'
STEPS = 3


@pytest.fixture(autouse=True)
def registry(monkeypatch):
    """Telemetry off and a fresh registry, dropped again after the
    test."""
    monkeypatch.delenv('AUTODIST_TELEMETRY', raising=False)
    core.reset()
    yield
    core.reset()


def make_trainer(**spec):
    model = TransformerLM(TransformerConfig.tiny(
        dtype=torch.float32, **spec.pop('model', {})), device='cpu')
    trainer = Trainer(model, optim.adamw(1e-3), spec=ParallelSpec(**spec))
    return trainer, trainer.init(seed=0)


def train(steps=STEPS, profiled=False, **spec):
    """(losses, {name: param}, the profiler or None) after ``steps``
    steps on batches of 4 rows."""
    trainer, state = make_trainer(**spec)
    losses = []
    prof = profile(activities=[ProfilerActivity.CPU]) if profiled \
        else contextlib.nullcontext()
    with prof:
        for i in range(steps):
            state, m = trainer.step(state, lm_batch(seed=i))
            losses.append(float(m['loss']))
    params = {n: p.detach().clone()
              for n, p in trainer.model.named_parameters()}
    return losses, params, prof if profiled else None


def ranges(prof, prefix=TRAINER):
    """[(name without the prefix, start us, end us)] of the profiler's
    ranges named ``prefix*``, by start."""
    return sorted(((e.name[len(prefix):], e.time_range.start,
                    e.time_range.end) for e in prof.events()
                   if e.name.startswith(prefix)), key=lambda r: r[1])


def phases_by_step(rs):
    """Each ``step`` range's phases, in order of start, each checked to
    lie inside it."""
    out = []
    for name, s, e in rs:
        if name == 'step':
            out.append([])
            lo, hi = s, e
            continue
        assert lo <= s <= e <= hi, (name, s, e, lo, hi)
        out[-1].append(name)
    return out


def zero2_ranges(rank, world):
    """One ZeRO 2 step at dp ``world`` under the profiler: the phases
    inside the step's range."""
    trainer, state = make_trainer(zero=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.step(state, lm_batch())
    return phases_by_step(ranges(prof))


def test_ranges_nest_in_the_step_in_phase_order():
    _, _, prof = train(profiled=True)
    assert phases_by_step(ranges(prof)) == \
        [['forward', 'backward', 'reduce', 'optimizer']] * STEPS


def test_accumulated_chunks_each_get_a_forward_and_a_backward():
    _, _, prof = train(steps=2, profiled=True, grad_accum=2)
    assert phases_by_step(ranges(prof)) == \
        [['forward', 'backward', 'forward', 'backward', 'reduce',
          'optimizer']] * 2


def test_zero2_adds_the_gather_after_the_optimizer():
    out = run_group(2, [('z2', 'test_torch_step_spans:zero2_ranges', {})])
    assert out['z2'] == [[['forward', 'backward', 'reduce', 'optimizer',
                           'gather']]] * 2


def test_moe_block_ranges_come_from_the_same_call():
    _, _, prof = train(steps=1, profiled=True, model=MOE_TINY)
    names = [r[0] for r in ranges(prof, 'autodist.moe/')]
    # two blocks, each its dispatch, experts and combine
    assert names == ['dispatch', 'experts', 'combine'] * 2
    assert not [e for e in prof.events() if e.name.startswith('moe_')]


def test_losses_and_params_are_bit_identical_whatever_records(monkeypatch):
    base_losses, base_params, _ = train()
    runs = [train(profiled=True)]
    monkeypatch.setenv('AUTODIST_TELEMETRY', '1')
    core.reset()
    runs.append(train())
    for losses, params, _ in runs:
        assert losses == base_losses
        for n, p in base_params.items():
            assert torch.equal(params[n], p), n


def test_no_range_is_entered_with_both_gates_off(monkeypatch):
    entered = []
    real = core.record_function

    def counting(name, *a, **kw):
        entered.append(name)
        return real(name, *a, **kw)
    monkeypatch.setattr(core, 'record_function', counting)
    train(steps=1)
    assert entered == []
    # the count sees the ranges when a profiler records
    train(steps=1, profiled=True)
    assert entered == ['autodist.trainer/' + n for n in
                       ('step', 'forward', 'backward', 'reduce',
                        'optimizer')]


def test_telemetry_records_each_phase_once_a_step(monkeypatch):
    monkeypatch.setenv('AUTODIST_TELEMETRY', '1')
    core.reset()
    train()
    spans = core.get().metrics_snapshot()['spans']
    assert {n: s['count'] for n, s in spans.items()} == {
        'trainer/' + n: STEPS for n in
        ('step', 'forward', 'backward', 'reduce', 'optimizer')}
    records = core.get().drain_spans()
    assert sorted(r['tags']['step'] for r in records
                  if r['name'] == 'trainer/step') == list(range(STEPS))


def test_phase_splits_ignores_the_trainer_spans(monkeypatch):
    monkeypatch.setenv('AUTODIST_TELEMETRY', '1')
    core.reset()
    train(steps=2)
    records = core.get().drain_spans()
    assert monitor.phase_splits(records) == {}
    session = {'name': 'step', 't0': 0.0, 'dur': 0.5,
               'tags': {'step': 1, 'worker': 'w0'}}
    assert monitor.phase_splits(records + [session]) == \
        {'w0': {1: {'step': 0.5, 'compute': 0.5}}}


def test_disabled_span_is_the_shared_null_span():
    tel = core.get()
    assert not tel.enabled
    assert tel.span('trainer/step') is core._NULL_SPAN
    with profile(activities=[ProfilerActivity.CPU]):
        assert tel.span('trainer/step') is not core._NULL_SPAN
    assert tel.span('trainer/step') is core._NULL_SPAN
