"""Per-phase program dumps of the port are wired into the build
pipeline, as ``tests/test_visualization.py`` checks for the JAX package
(reference visualization_util.py:24-36 + graph_transformer.py:62-90).

The program runs in a gloo group of 2 processes (the port's replicas
are processes): all five phases are dumped, and the lowered step, the
ATen graph traced on FakeTensors, names the gradient all-reduce. The
step trained as it would without the dumps (the trace runs nothing).
"""
import numpy as np
import torch

from autodist_tpu_torch.utils import visualization as viz
from torch_dsl_worlds import run_group


def test_build_pipeline_dumps_all_phases(tmp_path):
    run_dir = str(tmp_path / 'graphs')
    out = run_group(2, [('dump', 'torch_export_cases:dump_phases',
                         {'run_dir': run_dir})])['dump']
    names = set(out[0]['names'])
    for phase in ('0-original-capture', '1-strategy', '2-compiled-strategy',
                  '3-execution-plan'):
        assert phase + '.txt' in names, names
    lowered = [n for n in names if n.startswith('4-lowered-step') and
               n.endswith('.aten.txt')]
    assert lowered, names
    text = open(str(tmp_path / 'graphs' / lowered[0])).read()
    assert 'c10d.allreduce_' in text, text
    # one SGD step of mean((w x)^2) at w = 2, x = 1: w - 0.1 * 2 * 2 = 1.6
    # on both ranks (the trace did not step the state)
    assert [r['w'] for r in out] == [np.float32(1.6)] * 2


def test_dumps_are_off_by_default(tmp_path, monkeypatch):
    monkeypatch.delenv('AUTODIST_DUMP_GRAPHS', raising=False)
    monkeypatch.setattr(viz, '_RUN_DIR', str(tmp_path / 'graphs'))
    assert viz.log_text('x', 'phase') is None
    assert viz.log_program(lambda x: x + 1, (torch.ones(2),), 'p') is None
    assert not (tmp_path / 'graphs').exists()


def test_log_program_writes_the_aten_graph_and_skips_what_fails(
        tmp_path, monkeypatch):
    monkeypatch.setenv('AUTODIST_DUMP_GRAPHS', '1')
    monkeypatch.setattr(viz, '_RUN_DIR', str(tmp_path))
    base = viz.log_program(lambda x, w: torch.relu(x @ w),
                           (torch.ones(2, 3), torch.ones(3, 4)), 'mm')
    text = open(base + '.aten.txt').read()
    assert 'aten.mm' in text and 'aten.relu' in text

    def data_dependent(x):
        return x[: int(x.sum().item())]   # no fake trace of .item()
    logged = []
    monkeypatch.setattr(viz.logging, 'debug',
                        lambda msg, *a: logged.append(msg % a))
    assert viz.log_program(data_dependent, (torch.ones(3),), 'bad') is None
    assert not (tmp_path / 'bad.aten.txt').exists()
    assert len(logged) == 1 and 'bad dump failed' in logged[0]
