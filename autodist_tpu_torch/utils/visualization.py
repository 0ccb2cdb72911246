"""Per-phase program dumps (reference visualization_util.py:24-36).

The counterpart of ``autodist_tpu/utils/visualization.py``. The
reference writes the TF graph to TensorBoard after each transform phase;
the JAX package writes the jaxpr and the HLO. Here "the program at a
phase" is the ATen graph that
``torch.fx.experimental.proxy_tensor.make_fx`` traces (on FakeTensors:
nothing runs, no collective is issued), and the text artifacts of the
build (captured graph, strategy, compiled strategy, execution plan).
With ``AUTODIST_DUMP_GRAPHS`` set, each lands under
``const.DEFAULT_GRAPH_DUMP_DIR/<run>/<phase>.{txt,aten.txt}``; rank 0 of
the default group writes (every rank runs the same program). Tracing is
best effort: a program make_fx cannot trace is logged at debug level
and skipped.
"""
import os
import time

import torch.distributed as dist

from autodist_tpu_torch.const import DEFAULT_GRAPH_DUMP_DIR, ENV
from autodist_tpu_torch.utils import logging

_RUN_DIR = None


def _run_dir():
    global _RUN_DIR
    if _RUN_DIR is None:
        _RUN_DIR = os.path.join(DEFAULT_GRAPH_DUMP_DIR,
                                time.strftime('%Y%m%d-%H%M%S'))
    os.makedirs(_RUN_DIR, exist_ok=True)
    return _RUN_DIR


def _dumping():
    """True when dumps are on and this process writes them."""
    if not ENV.AUTODIST_DUMP_GRAPHS.val:
        return False
    return not (dist.is_available() and dist.is_initialized() and
                dist.get_rank() != 0)


def _write(phase, suffix, text):
    base = os.path.join(_run_dir(), phase)
    with open(base + suffix, 'w') as f:
        f.write(text)
    logging.info('Dumped %r under %s', phase, _run_dir())
    return base


def log_program(fn, args, phase, kwargs=None):
    """Dump the ATen graph of ``fn(*args, **kwargs)`` for one phase
    (``<phase>.aten.txt``), traced on FakeTensors; returns the path's
    stem, or None when dumps are off or tracing failed."""
    if not _dumping():
        return None
    from torch.fx.experimental.proxy_tensor import make_fx
    kwargs = kwargs or {}
    try:
        gm = make_fx(lambda *a: fn(*a, **kwargs),
                     tracing_mode='fake')(*args)
    except Exception as e:  # noqa: BLE001 - diagnostics must not kill runs
        logging.debug('ATen trace for the %s dump failed: %s: %s',
                      phase, type(e).__name__, e)
        return None
    return log_compiled(gm, phase)


def log_text(content, phase):
    """Dump a text artifact (captured graph, strategy, plan) for one
    build phase (the reference dumps the graph at 4 transform phases,
    graph_transformer.py:62-90)."""
    if not _dumping():
        return None
    return _write(phase, '.txt', str(content))


def log_compiled(program, phase):
    """Dump an already-traced program (an ``fx.GraphModule`` or a
    ``torch.export.ExportedProgram``) as ``<phase>.aten.txt``."""
    if not _dumping():
        return None
    gm = getattr(program, 'graph_module', program)
    return _write(phase, '.aten.txt', gm.print_readable(print_output=False))
