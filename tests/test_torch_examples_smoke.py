"""The port's examples (``examples_torch/``) as real subprocesses with
``--device cpu``, as ``tests/test_examples_smoke.py`` drives the JAX
package's: exit 0 and the demo's contract (a falling loss, the served
predictions within the example's own 0.1 of the ground truth, a records
arm that streams through the native reader). No subprocess imports jax.
"""
import os
import re
import subprocess
import sys

import numpy as np

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
