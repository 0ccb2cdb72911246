"""BENCHMARK.json keeps to its contract, and every configuration, cell,
traffic and metric file is found by name; a cell added as files only is
found without an edit."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from perfbench import harness

ROOT = harness.ROOT
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def bench():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def test_top_level_keys_and_limits():
    b = bench()
    assert set(b) == {'command', 'paths', 'run_seconds', 'configs',
                      'workloads', 'end_to_end', 'per_layer'}
    assert b['command'] == ['python3', 'perfbench/run.py']
    assert b['paths'] == ['perfbench']
    assert 1 <= b['run_seconds'] <= 51
    runs = 2 + 14 * 24
    assert runs * (b['run_seconds'] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(b)) < 64 * 1024


def test_names_units_and_entry_keys():
    b = bench()
    names = [c['name'] for c in b['configs']] + \
        [w['name'] for w in b['workloads']] + \
        [m['name'] for m in b['end_to_end'] + b['per_layer']]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in b['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert c['file'].startswith('perfbench/configs/')
        for k in c['reduced']:
            assert NAME.match(k) and not k.endswith(('_dim', '_rank'))
    pairs = set()
    for w in b['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['chips'] in (1, 4) and len(w['why']) <= 200
        pairs.add((w['config'], w['traffic']))
    assert len(pairs) == len(b['workloads'])
    assert sum(w['chips'] == 4 for w in b['workloads']) <= \
        max(1, len(b['workloads']) // 4)
    e2e = {m['name'] for m in b['end_to_end']}
    assert e2e == {'tokens_per_s', 'step_ms_p95', 'peak_mem_gib', 'setup_s'}
    for m in b['end_to_end']:
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source',
                          'workloads'}
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    for m in b['per_layer']:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        assert m['moves'] in e2e and m['better'] in ('lower', 'higher')
        assert UNIT.match(m['unit'])
        if m['name'].endswith('_roofline') or 'mfu' in m['name']:
            assert m['unit'] == '%'


@pytest.mark.parametrize('cell', [w['name'] for w in bench()['workloads']])
def test_every_cell_loads_by_name(cell):
    s = harness.load_spec(cell)
    assert s['chips'] == s['cell']['spec'].get('dp', 1)
    assert set(s['cell']['limits']) == {'loss', 'grad1', 'change'}
    assert s['traffic']['batch'] % s['chips'] == 0
    assert s['config']['name'] in cell
    assert {m['name'] for m in s['end_to_end']} >= {'setup_s'}
    for m in s['per_layer']:
        assert callable(harness.reader(s['bench_dir'], m['name']))


# the published key of each of the port's widths, by model family
PUBLISHED = {'vocab': ('vocab_size',), 'dim': ('hidden_size', 'n_embd'),
             'n_layers': ('num_hidden_layers', 'n_layer'),
             'n_heads': ('num_attention_heads', 'n_head')}


def test_config_files_run_their_published_widths():
    for c in bench()['configs']:
        with open(os.path.join(ROOT, c['file'])) as f:
            cfg = json.load(f)
        assert cfg['source'] == c['source']
        assert sorted(cfg['reduced']) == sorted(c['reduced'])
        seen = 0
        for key, published in PUBLISHED.items():
            for p in published:
                if p in cfg and p not in cfg['reduced']:
                    assert cfg['model'][key] == cfg[p], (c['name'], p)
                    seen += 1
        assert seen == len(PUBLISHED)
        assert set(cfg['reduced']) <= set(cfg)


def copy_tree(tmp_path):
    shutil.copytree(os.path.join(ROOT, 'perfbench'),
                    tmp_path / 'perfbench',
                    ignore=shutil.ignore_patterns('_cache', '__pycache__'))


def test_a_cell_added_as_files_is_found_without_an_edit(tmp_path):
    copy_tree(tmp_path)
    b = bench()
    b['workloads'].append({'name': 'bert-large.s256.b64',
                           'config': 'bert-large',
                           'traffic': 'zipf-s256-b64', 'chips': 1,
                           'why': 'a later cell'})
    b['per_layer'].append({'name': 'later_ms', 'unit': 'ms',
                           'better': 'lower', 'source': 'device_trace',
                           'layer': 'Models', 'moves': 'tokens_per_s',
                           'workloads': ['bert-large.s256.b64']})
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(b))
    (tmp_path / 'perfbench/traffic/zipf-s256-b64.json').write_text(
        json.dumps({'seq': 256, 'batch': 64, 'zipf_exponent': 1.1,
                    'targets': 'independent', 'ring': 4}))
    (tmp_path / 'perfbench/cells/bert-large.s256.b64.json').write_text(
        json.dumps({'spec': {'dp': 1}, 'limits': {'loss': 1, 'grad1': 1,
                                                  'change': 1}}))
    (tmp_path / 'perfbench/metrics/later_ms.py').write_text(
        'def read(rec):\n    return 1.5\n')
    s = harness.load_spec('bert-large.s256.b64', root=str(tmp_path))
    assert s['traffic']['seq'] == 256
    assert [m['name'] for m in s['per_layer']][-1] == 'later_ms'
    assert harness.reader(s['bench_dir'], 'later_ms')({}) == 1.5
    old = harness.load_spec('bert-large.s512.b32', root=str(tmp_path))
    assert 'later_ms' not in [m['name'] for m in old['per_layer']]


SGD_PROGRAM = '''
def build(o):
    from autodist_tpu_torch import optim
    return optim.sgd(o['learning_rate'], momentum=o['momentum'])


def first_gradient(slot, o):
    return slot['momentum_buffer']
'''
SGD_PLAIN = '''
import torch


class Plain:
    def __init__(self, o):
        self.o, self.trace = o, {}

    @torch.no_grad()
    def step(self, params, grads):
        for k, p in params.items():
            t = self.trace.get(k)
            t = grads[k].clone() if t is None else \\
                grads[k] + self.o['momentum'] * t
            self.trace[k] = t
            p.sub_(self.o['learning_rate'] * t)
'''
ADD_CONFIG = '''
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2], sys.argv[2] + '/perfbench/tests']
import tiny
from perfbench import harness
assert harness.ROOT == sys.argv[1]
out = harness.run_rank(tiny.spec('gpt2-sgd.s64.b4'), 2 ** 31 + 5, 0.3,
                       False, device='cpu', log=lambda *a: None)
print(json.dumps(out))
'''


def add_config(tmp_path, optimizer):
    """A configuration, its traffic and cell added to a copy as files and
    entries only."""
    copy_tree(tmp_path)
    b = bench()
    with open(os.path.join(ROOT, 'perfbench/configs/gpt2-small.json')) as f:
        cfg = json.load(f)
    cfg.update(name='gpt2-sgd', optimizer={
        'name': optimizer, 'learning_rate': 0.01, 'momentum': 0.9})
    b['configs'].append({'name': 'gpt2-sgd', 'source': cfg['source'],
                         'file': 'perfbench/configs/gpt2-sgd.json',
                         'reduced': [], 'why': 'a later configuration'})
    b['workloads'].append({'name': 'gpt2-sgd.s64.b4', 'config': 'gpt2-sgd',
                           'traffic': 'zipf-s64-b4', 'chips': 1,
                           'why': 'a later cell'})
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(b))
    (tmp_path / 'perfbench/configs/gpt2-sgd.json').write_text(
        json.dumps(cfg))
    (tmp_path / 'perfbench/traffic/zipf-s64-b4.json').write_text(
        json.dumps({'seq': 64, 'batch': 4, 'zipf_exponent': 1.1,
                    'targets': 'next', 'ring': 8}))
    (tmp_path / 'perfbench/cells/gpt2-sgd.s64.b4.json').write_text(
        json.dumps({'spec': {'dp': 1}, 'limits': {'loss': 1, 'grad1': 1,
                                                  'change': 1}}))


def test_a_configuration_added_as_files_runs_without_an_edit(tmp_path):
    add_config(tmp_path, 'sgd')
    (tmp_path / 'perfbench/programs/optimizers/sgd.py').write_text(
        SGD_PROGRAM)
    (tmp_path / 'perfbench/reference/optimizers/sgd.py').write_text(
        SGD_PLAIN)
    out = subprocess.run([sys.executable, '-c', ADD_CONFIG, str(tmp_path),
                          ROOT], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line['correct'], line['checks']
    # the tiny run's SGD moves every leaf: its readings were compared
    assert 0 < line['checks']['change']['value'] < 1


def test_a_configuration_that_names_no_optimizer_module_is_refused(
        tmp_path):
    add_config(tmp_path, 'sgd')
    with pytest.raises(SystemExit, match='programs/optimizers/sgd.py'):
        harness.load_spec('gpt2-sgd.s64.b4', root=str(tmp_path))
