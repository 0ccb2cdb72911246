"""Nothing the card runs loads ``jax`` or the JAX package (top-level
names compared whole), and the reference loads nothing of the port."""
import json
import os
import subprocess
import sys

import pytest

import tiny
from perfbench import harness, run

TOP = ('import json, sys; '
       'print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))')


def loaded(code):
    out = subprocess.run([sys.executable, '-c', code + '\n' + TOP],
                         cwd=harness.ROOT, capture_output=True, text=True,
                         check=True, env={'PATH': '/usr/bin:/bin',
                                          'JAX_PLATFORMS': 'cpu'})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    code = ('import sys; sys.path.insert(0, "perfbench/tests")\n'
            'import tiny, perfbench.run, perfbench.readings\n'
            'from perfbench import harness\n'
            'harness.run_rank(tiny.spec("gpt2-small.s4096.b4", seq=512,'
            ' batch=2, max_len=512), 1, 0.2, True, device="cpu",'
            ' log=lambda *a: None)')
    mods = loaded(code)
    assert 'autodist_tpu_torch' in mods
    assert not mods & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    mods = loaded('import perfbench.reference.run, '
                  'perfbench.reference.control, perfbench.check, '
                  'perfbench.traffic, perfbench.work')
    assert not mods & {'autodist_tpu_torch', 'autodist_tpu', 'jax'}


def test_the_check_names_what_it_found(monkeypatch):
    monkeypatch.setitem(sys.modules, 'jaxlib.fake', object())
    assert 'jaxlib' in harness.forbidden_modules()


def test_without_the_program_a_run_fails_and_prints_nothing(tmp_path):
    import os
    import shutil
    shutil.copy(os.path.join(harness.ROOT, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(os.path.join(harness.ROOT, 'perfbench'),
                    tmp_path / 'perfbench',
                    ignore=shutil.ignore_patterns('_cache', '__pycache__'))
    out = subprocess.run([sys.executable, 'perfbench/run.py', '--workload',
                          'bert-large.s512.b32', '--seed', '1', '--seconds',
                          '1', '--trace', '0'], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ''
    assert 'autodist_tpu_torch' in out.stderr


def test_without_a_card_a_run_fails_and_prints_nothing():
    import torch
    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, 'perfbench/run.py', '--workload',
                          'gpt2-small.s4096.b4', '--seed', '1', '--seconds',
                          '1', '--trace', '0'], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 3 and out.stdout == ''
    assert 'needs 1 CUDA device' in out.stderr


# loaded at the start of every Python process on PYTHONPATH; only the
# rank processes that ``run.launch`` starts carry ``--worker``
JAX_IN_WORKERS = (
    "import sys, types\n"
    "if '--worker' in sys.argv:\n"
    "    sys.modules['jaxlib.fake'] = types.ModuleType('jaxlib.fake')\n")


@pytest.mark.parametrize('jax_in_a_worker', [False, True])
def test_a_rank_that_loaded_jax_fails_the_run(tmp_path, monkeypatch, capfd,
                                               jax_in_a_worker):
    if jax_in_a_worker:
        (tmp_path / 'sitecustomize.py').write_text(JAX_IN_WORKERS)
    monkeypatch.setenv('PYTHONPATH', os.pathsep.join(
        p for p in (str(tmp_path), os.environ.get('PYTHONPATH')) if p))
    s = tiny.spec('bert-large.s512.b32.dp4')
    s['cell']['spec']['dp'] = 2
    out = run.launch({'spec': s, 'seed': 2 ** 31 + 13, 'seconds': 0.3,
                      'trace': 0, 'world': 2, 'device': 'cpu'})
    err = capfd.readouterr().err
    if jax_in_a_worker:
        assert out is None
        assert 'the run loaded jaxlib' in err
    else:
        assert out['correct'] and out['device']['count'] == 2
