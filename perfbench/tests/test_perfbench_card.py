"""On a card (``-m cuda``): each one-card cell's run prints a correct
result line of the contract's shape."""
import json
import subprocess
import sys

import pytest

from perfbench import harness


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')


@pytest.mark.cuda
@pytest.mark.parametrize('cell', ['gpt2-small.s4096.b4',
                                  'bert-large.s512.b32',
                                  'bert-large.s128.b128'])
def test_a_short_run_on_the_card(card, cell):
    out = subprocess.run([sys.executable, 'perfbench/run.py', '--workload',
                          cell, '--seed', str(2 ** 31 + 99), '--seconds',
                          '3', '--trace', '0'], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line['correct'], line['checks']
    assert line['device']['platform'] == 'gpu'
