"""The port's examples (``examples_torch/``) as real subprocesses with
``--device cpu``, as ``tests/test_examples_smoke.py`` drives the JAX
package's: exit 0 and the demo's contract (a falling loss, the served
predictions within the example's own 0.1 of the ground truth, a records
arm that streams through the native reader, the JAX example's printed
line). No port subprocess imports jax. The two DSL examples are seeded
from numpy whole, so they print the JAX examples' values.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from autodist_tpu_torch.data.loader import write_records

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# run a script as ``python <script>`` would (its directory first on the
# path), with jax unimportable
_NO_JAX = ("import os, sys, runpy; sys.modules['jax'] = None; "
           "sys.argv = sys.argv[1:]; "
           "sys.path.insert(0, os.path.dirname(sys.argv[0])); "
           "runpy.run_path(sys.argv[0], run_name='__main__')")


def _run_example(name, *args):
    """Run ``examples_torch/<name>`` with jax made unimportable."""
    env = dict(os.environ, OMP_NUM_THREADS='2')
    proc = subprocess.run(
        [sys.executable, '-c', _NO_JAX,
         os.path.join(REPO, 'examples_torch', name), '--device', 'cpu',
         *args], capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_image_classifier_zero_touch_example():
    out = _run_example('image_classifier.py', '--steps', '12',
                       '--strategy', 'PartitionedPS')
    losses = [float(m) for m in re.findall(r'train_loss: ([0-9.]+)', out)]
    assert len(losses) == 12, out
    assert min(losses[-3:]) < losses[0], losses


def test_serving_example_serves_within_its_tolerance():
    out = _run_example('serving.py', '--epochs', '20')
    rows = re.findall(r'(-?[0-9.]+)  \(true +(-?[0-9.]+)\)', out)
    assert len(rows) == 3, out
    assert max(abs(float(a) - float(b)) for a, b in rows) < 0.1
    assert 'servable with torch + numpy only' in out


def test_imagenet_example_streams_records(tmp_path):
    """--tiny ResNet-50 on records written with ``write_records``: the
    native reader feeds the steps; then the synthetic arm."""
    rng = np.random.RandomState(0)
    write_records(str(tmp_path / 'images.records'),
                  rng.rand(8, 32, 32, 3).astype(np.float32))
    write_records(str(tmp_path / 'labels.records'),
                  rng.randint(0, 10, (8,)).astype(np.int32))
    for data in (['--data', str(tmp_path)], []):
        out = _run_example('imagenet.py', '--model', 'resnet50', '--tiny',
                           '--batch', '4', '--steps', '2', '--eval', *data)
        loss = re.search(r'img/s, loss=([0-9.]+) \(cpu\)', out)
        assert loss and np.isfinite(float(loss.group(1))), out
        assert 'eval (running stats)' in out


def _run_jax_example(name, *args):
    """Run the JAX package's ``examples/<name>`` on one CPU device (the
    port's example runs one process: one replica)."""
    env = dict(os.environ, JAX_PLATFORMS='cpu', OMP_NUM_THREADS='2',
               XLA_FLAGS='')
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, 'examples', name), *args],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _numbers(pattern, out):
    return [float(x) for x in re.findall(pattern, out)]


def test_linear_regression_example_prints_the_jax_examples_values():
    """The same numpy data and SGD steps: every epoch's loss to 1e-4
    relative and the fitted W and b to 1e-5 (the printed five places)."""
    got = _run_example('linear_regression.py', '--strategy',
                       'PartitionedPS')
    want = _run_jax_example('linear_regression.py', '--strategy',
                            'PartitionedPS')
    pat = r'epoch \d+: loss=([0-9.]+)'
    losses, ref = _numbers(pat, got), _numbers(pat, want)
    assert len(losses) == len(ref) == 10 and losses[-1] < losses[0], got
    np.testing.assert_allclose(losses, ref, rtol=1e-4)
    pat = r'W=(-?[0-9.]+) \(true 3.0\)  b=(-?[0-9.]+) \(true 2.0\)'
    (w, b), = re.findall(pat, got)
    (w0, b0), = re.findall(pat, want)
    assert abs(float(w) - float(w0)) <= 1e-5 and \
        abs(float(b) - float(b0)) <= 1e-5, (got, want)


def test_sentiment_classifier_example_prints_the_jax_examples_values():
    """Seeded from numpy whole (tokens, labels and the initial tables):
    the logged losses and the final embedding norm to 1e-4 relative."""
    got = _run_example('sentiment_classifier.py', '--steps', '20')
    want = _run_jax_example('sentiment_classifier.py', '--steps', '20')
    pat = r'train loss = ([0-9.]+)'
    losses, ref = _numbers(pat, got), _numbers(pat, want)
    assert len(losses) == len(ref) == 2 and losses[-1] < losses[0], got
    np.testing.assert_allclose(losses, ref, rtol=1e-4)
    pat = r'emb table: shape \(10000, 16\), norm ([0-9.]+)'
    np.testing.assert_allclose(_numbers(pat, got), _numbers(pat, want),
                               rtol=1e-4)


@pytest.mark.parametrize('name, args, pattern', [
    ('bert.py', ('--config', 'tiny', '--steps', '2', '--optimizer', 'lamb'),
     r"tiny \(\{'data': 1, 'pipe': 1, 'seq': 1, 'expert': 1, 'model': 1\}\)"
     r": [0-9]+ tokens/s \([0-9]+ tokens/s/chip\), loss=([0-9.]+)"),
    ('ncf.py', ('--tiny', '--steps', '2'),
     r'ncf \[PSLoadBalancing\]: [0-9]+ examples/s \([0-9]+ /chip\), '
     r'loss=([0-9.]+)'),
    ('lm1b.py', ('--tiny', '--steps', '2'),
     r'lm1b-lstm \[PartitionedPS\]: [0-9]+ tokens/s \([0-9]+ /chip\), '
     r'ppl=([0-9.]+)'),
], ids=['bert', 'ncf', 'lm1b'])
def test_trainer_example_at_tiny_width(name, args, pattern):
    """Each prints the JAX example's line with a finite loss."""
    out = _run_example(name, *args)
    value = re.search(pattern, out)
    assert value and np.isfinite(float(value.group(1))), out


def test_bert_example_spec_must_take_the_world():
    """On one process a spec whose degrees do not divide the world
    raises the grid's ValueError."""
    env = dict(os.environ, OMP_NUM_THREADS='2')
    proc = subprocess.run(
        [sys.executable, '-c', _NO_JAX,
         os.path.join(REPO, 'examples_torch', 'bert.py'), '--device', 'cpu',
         '--tp', '2', '--steps', '1'], capture_output=True, text=True,
        timeout=300, env=env)
    assert proc.returncode != 0
    assert 'ValueError' in proc.stderr and 'tp*pp*sp*ep=2' in proc.stderr
