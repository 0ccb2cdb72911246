"""The port's analysis subsystem (``autodist_tpu_torch/analysis``) against
the JAX package's (``autodist_tpu/analysis``).

- The model checkers: on every ordering the two packages share, the
  port's exploration gives the JAX one's results exactly (per scenario:
  states, good terminals, violation kinds, counterexample traces and
  diagnoses; the analyzers' findings and ``LAST_STATS``). The port
  models two orderings of its own, both its HEAD: the depth-2
  pipeline's bounded wait before the pull-ahead (``data_plane_model``
  ``prefetch_guard='wait_then_discard'``) and the chief's wait for the
  members' steps before the boundary ahead of the epoch swap's re-key
  (``epoch_swap_model`` ``rekey='await_published'``). Each explores
  clean, each seeded bug still counterexamples, and the state counts
  that differ from the JAX model's are stated below.
- The lints: clean on the port's tree, and each flags a doctored copy
  of the port's source.
- The trace replay: doctored dumps written by the port's flight
  recorder give the same findings in both packages' checkers.
- The CLI: ``python -m autodist_tpu_torch.analysis --all --json`` with
  jax unimportable.
"""
import json
import os
import re
import subprocess
import sys
from dataclasses import replace

import pytest

from autodist_tpu.analysis import conformance as j_conf
from autodist_tpu.analysis import data_plane_model as j_dp
from autodist_tpu.analysis import epoch_swap_model as j_es
from autodist_tpu.analysis import explore as j_explore
from autodist_tpu.analysis import swap_conformance as j_swapc
from autodist_tpu_torch.analysis import conformance as t_conf
from autodist_tpu_torch.analysis import data_plane_model as t_dp
from autodist_tpu_torch.analysis import env_lint, fence_lint
from autodist_tpu_torch.analysis import epoch_swap_model as t_es
from autodist_tpu_torch.analysis import explore as t_explore
from autodist_tpu_torch.analysis import schedule_lint
from autodist_tpu_torch.analysis import swap_conformance as t_swapc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: The port's state counts where its model differs from the JAX one
#: (the JAX counts beside them): the pipeline scenario with the bounded
#: prefetch wait, and the epoch swap with the re-key.
PORT_PIPELINE_STATES = {'HEAD': 291, 'NO_FLOOR_DISCARD': 309,
                        'FLOOR_AFTER_PULL': 357}       # JAX 252, 268, 310
PORT_SWAP_STATES = {'epoch_swap': 8300, 'epoch_swap_nack': 1332,
                    'epoch_swap_nack[mixed-plan-step]': 3504,
                    'epoch_swap[mixed-plan-step]': 8904,
                    'epoch_swap[push-on-old-keys]': 8366}
# JAX: epoch_swap 8356, epoch_swap_nack 1332, [mixed-plan-step] 3480 and
# 8850 (no re-key modelled)


def _digest(result):
    return (result.scenario, result.ok, result.states, result.terminals,
            [(v.kind, v.trace, v.diagnosis) for v in result.violations])


def _recorded_analyze(explore_mod, analyze, monkeypatch):
    """Run ``analyze`` with every exploration it makes recorded: returns
    (findings, [digest per exploration, in order])."""
    seen = []
    real = explore_mod.explore

    def explore(sc, **kw):
        result = real(sc, **kw)
        seen.append(_digest(result))
        return result
    monkeypatch.setattr(explore_mod, 'explore', explore)
    return analyze(), seen


@pytest.fixture(scope='module')
def suites():
    """Both packages' three model checkers, each run once, every
    exploration recorded."""
    out = {}
    for pkg, explore_mod, dp, es in (('jax', j_explore, j_dp, j_es),
                                     ('port', t_explore, t_dp, t_es)):
        for name, analyze, stats in (
                ('protocol', explore_mod.analyze, explore_mod.LAST_STATS),
                ('data-plane', dp.analyze, dp.LAST_STATS),
                ('epoch-swap', es.analyze, es.LAST_STATS)):
            with pytest.MonkeyPatch.context() as mp:
                findings, seen = _recorded_analyze(explore_mod, analyze,
                                                   mp)
            out[pkg, name] = (findings, seen,
                              json.loads(json.dumps(stats)))
    return out


def test_protocol_model_equals_the_reference(suites):
    """The control-plane model is the JAX one: HEAD clean, every seeded
    bug's counterexample the same event sequence, the same states."""
    assert suites['jax', 'protocol'][0] == [] == \
        suites['port', 'protocol'][0]
    assert suites['port', 'protocol'][1] == suites['jax', 'protocol'][1]
    assert suites['port', 'protocol'][2] == suites['jax', 'protocol'][2]
    kinds = {d[0]: [v[0] for v in d[4]]
             for d in suites['port', 'protocol'][1][4:]}
    for scenario, kind in (('exclude', 'resurrection'), ('admit', 'stall'),
                           ('zombie', 'fenced-write-commit'),
                           ('cap_race', 'cap-slot-unretired')):
        assert kind in kinds[scenario], kinds


def test_data_plane_model_equals_the_reference_but_the_pipeline(suites):
    """Every data-plane scenario but the depth-2 pipeline explores as the
    JAX one does, seeded bugs included."""
    jax_f, jax_seen, jax_stats = suites['jax', 'data-plane']
    port_f, port_seen, port_stats = suites['port', 'data-plane']
    assert jax_f == [] == port_f
    jax_rest = [d for d in jax_seen if d[0] != 'pipeline']
    port_rest = [d for d in port_seen if d[0] != 'pipeline']
    assert port_rest == jax_rest and len(port_rest) == 15
    pipe = {k: v for k, v in port_stats['scenarios'].items()
            if k.startswith('pipeline')}
    assert pipe == {'pipeline': PORT_PIPELINE_STATES['HEAD'],
                    'pipeline[stale-prefetch]':
                        PORT_PIPELINE_STATES['NO_FLOOR_DISCARD'],
                    "pipeline[stale-prefetch]'":
                        PORT_PIPELINE_STATES['FLOOR_AFTER_PULL']}
    rest = {k: v for k, v in port_stats['scenarios'].items()
            if not k.startswith('pipeline')}
    assert rest == {k: v for k, v in jax_stats['scenarios'].items()
                    if not k.startswith('pipeline')}


@pytest.mark.parametrize('port_cfg, jax_cfg', [
    (t_dp.PULL_AT_ONCE, j_dp.HEAD),
    (replace(t_dp.HEAD, prefetch_guard='serve_always'),
     j_dp.NO_FLOOR_DISCARD),
    (replace(t_dp.FLOOR_AFTER_PULL, prefetch_guard='floor_discard'),
     j_dp.FLOOR_AFTER_PULL)], ids=['head', 'no_discard', 'floor_late'])
def test_pipeline_without_the_wait_is_the_reference(suites, port_cfg,
                                                    jax_cfg):
    """Without the prefetch wait the port's pipeline scenario is the JAX
    one, state for state (the JAX results recorded in ``suites``)."""
    got = _digest(t_explore.explore(t_dp.pipeline_scenario(port_cfg)))
    jax_pipes = [d for d in suites['jax', 'data-plane'][1]
                 if d[0] == 'pipeline']
    want = _digest(j_explore.explore(j_dp.pipeline_scenario(jax_cfg)))
    assert want in jax_pipes
    assert got == want


def test_pipeline_with_the_wait_explores_clean_and_keeps_its_guard():
    """The port's HEAD (the bounded wait, then the floor discard) is
    clean; without the discard a timed-out wait serves a stale prefetch,
    and the floor read after the pull-ahead still counterexamples."""
    runs = {name: t_explore.explore(t_dp.pipeline_scenario(cfg))
            for name, cfg in (('HEAD', t_dp.HEAD),
                              ('NO_FLOOR_DISCARD', t_dp.NO_FLOOR_DISCARD),
                              ('FLOOR_AFTER_PULL', t_dp.FLOOR_AFTER_PULL))}
    assert runs['HEAD'].ok and runs['HEAD'].terminals == 1
    assert {k: r.states for k, r in runs.items()} == PORT_PIPELINE_STATES
    for name in ('NO_FLOOR_DISCARD', 'FLOOR_AFTER_PULL'):
        assert runs[name].kinds() == ['stale-prefetch'], name
    trace = t_explore.format_violation(
        runs['NO_FLOOR_DISCARD'], runs['NO_FLOOR_DISCARD'].violations[0])
    assert 'prefetch wait times out' in trace, trace


@pytest.mark.parametrize('port_cfg, jax_cfg', [
    (t_es.NO_REKEY, j_es.VERIFIED),
    (replace(t_es.SWAP_BEFORE_ACK_QUORUM, rekey='off'),
     j_es.SWAP_BEFORE_ACK_QUORUM),
    (replace(t_es.NAIVE_BOUNDARY, rekey='off'), j_es.NAIVE_BOUNDARY)],
    ids=['verified', 'before_quorum', 'naive_boundary'])
def test_epoch_swap_without_a_rekey_is_the_reference(port_cfg, jax_cfg):
    """A swap that re-keys nothing is the JAX model's scope: the same
    results on both scenarios."""
    got = [_digest(t_explore.explore(sc)) for sc in t_es.scenarios(port_cfg)]
    want = [_digest(j_explore.explore(sc))
            for sc in j_es.scenarios(jax_cfg)]
    assert got == want


def test_epoch_swap_rekey_after_the_members_steps(suites):
    """The port's VERIFIED contract (the chief re-keys once every live
    member published the step before the boundary) explores clean; the
    reference's ordering (the re-key at the chief's own boundary check)
    loses a lagging member's push on the old keys."""
    findings, seen, stats = suites['port', 'epoch-swap']
    assert findings == [] == suites['jax', 'epoch-swap'][0]
    assert stats['scenarios'] == PORT_SWAP_STATES
    at_once = [d for d in seen if d[0] == 'epoch_swap' and d[4] and
               d[4][0][0] == 'push-on-old-keys']
    assert at_once, seen
    labels = [label for _, label in at_once[0][4][0][1]]
    rekey = next(i for i, label in enumerate(labels)
                 if label.startswith('re-keys'))
    assert any(label.endswith('under plan N') and 'push' in label
               for label in labels[rekey + 1:]), labels


# -- the lints --------------------------------------------------------------
@pytest.mark.parametrize('lint', [fence_lint, env_lint, schedule_lint,
                                  t_swapc], ids=lambda m: m.__name__)
def test_lint_clean_on_the_ports_tree(lint):
    assert lint.analyze() == []


def test_lints_read_the_ports_sources():
    assert fence_lint.SRC.endswith(os.path.join(
        'autodist_tpu_torch', 'native', 'coord_service.cc'))
    assert schedule_lint.PLAN_SRC.endswith(os.path.join(
        'autodist_tpu_torch', 'parallel', 'plan.py'))
    files = {os.path.relpath(p, REPO) for p in env_lint._iter_sources()}
    assert 'chip_smoke.py' in files and \
        'autodist_tpu_torch/const.py' in files and \
        'tests/test_torch_analysis.py' in files
    assert not any(f.startswith(('autodist_tpu/', 'examples/', 'tools/'))
                   for f in files)


_DOCTORED_CC = '''
// every mutating command (SET, BADD) is rejected with ERR fenced
std::string handle(Conn* conn, const std::string& cmd) {
  if (cmd == "SET") { return "OK"; }
  if (cmd == "GET") { return "VAL"; }
  if (cmd == "BADD") {
    if (is_fenced(*conn)) return kFencedErr;
    return "VAL";
  }
  if (cmd == "NEWCMD") { return "OK"; }
  return "ERR unknown command";
}
'''


def _cc_without(old, new):
    text = open(fence_lint.SRC).read()
    doctored = text.replace(old, new)
    assert doctored != text, old
    return doctored


@pytest.mark.parametrize('make, expect', [
    (lambda: _DOCTORED_CC,
     ('no fence check', 'reject_fenced_under_tensor_lock', 'NEWCMD',
      'writer-fencing paragraph')),
    (lambda: _cc_without(
        'reject_fenced_under_tensor_lock(conn, k, t.get(), off_decl)',
        'false'), ('under the tensor lock',)),
    (lambda: _cc_without(
        'if (in.fail() || nbytes > kMaxPayload) return kBadPayload;',
        'if (in.fail()) return kBadPayload;'), ('BSET', 'kMaxPayload')),
    (lambda: _cc_without(
        'constexpr uint64_t kMaxElems = kMaxPayload / sizeof(float);',
        'constexpr uint64_t kMaxElems = ~0ull;'), ('BGETROWS', 'reply')),
    (lambda: _cc_without(
        'if (cmd == "BSTAT") {',
        'if (cmd == "NEWBLOB") { if (payload.size()) {} return "OK"; }\n'
        '  if (cmd == "BSTAT") {'), ('NEWBLOB', 'PAYLOAD_BOUNDED')),
], ids=['dispatcher', 'under_lock', 'request_cap', 'reply_bound',
        'unbounded_payload'])
def test_fence_lint_flags_a_doctored_service(make, expect):
    findings = '\n'.join(fence_lint.analyze(make()))
    for needle in expect:
        assert needle in findings, (needle, findings)


def test_fence_lint_flags_doctored_client_and_swap_keys():
    found = '\n'.join(fence_lint.check_read_only_client(
        mutating=set(fence_lint.MUTATING) | {'BNEW'}))
    assert 'BNEW' in found and 'READ_ONLY_BLOCKED' in found
    src = fence_lint._swap_keys_source()
    doctored = src.replace("return 'swap/%d/ready' % gen",
                           "return 'swap/%d/armed' % gen")
    assert doctored != src
    found = '\n'.join(fence_lint.check_swap_keys(doctored))
    assert 'swap/<g>/armed' in found and 'SWAP_KEY_VERBS' in found


def test_env_lint_flags_reads_forwarding_and_docs(tmp_path):
    env = 'os.environ'
    bad = tmp_path / 'rogue.py'
    bad.write_text("import os\n"
                   "x = " + env + ".get('AUTODIST_TOTALLY"
                   "_NEW_KNOB', '1')\n"
                   "y = " + env + ".get(\n    'AUTODIST_WRAPPED"
                   "_READ')\n" +
                   env + "['AUTODIST_A_WRITE'] = '1'\n")
    names = '\n'.join(env_lint.analyze(files=[str(bad)]))
    assert 'AUTODIST_TOTALLY_NEW_KNOB' in names
    assert 'AUTODIST_WRAPPED_READ' in names
    assert 'AUTODIST_A_WRITE' not in names
    # the port forwards what the JAX launcher forwards (the TPU runtime's
    # own environment aside), every knob forwarded or exempt
    from autodist_tpu.runtime.coordinator import _FORWARDED_FLAGS as jfwd
    from autodist_tpu_torch.const import ENV
    fwd = env_lint.forwarded_env()
    assert fwd == {e.name for e in jfwd}
    for e in ENV:
        if e.name.startswith('AUTODIST_'):
            assert (e.name in fwd) != (e.name in env_lint.FORWARD_EXEMPT)
    probe = {'AUTODIST_STRAGGLER_POLICY': ('off', 'warn', 'advise')}
    assert env_lint.choice_sets()['AUTODIST_STRAGGLER_POLICY'] == \
        probe['AUTODIST_STRAGGLER_POLICY']
    found = '\n'.join(env_lint.check_docs(
        declared={'AUTODIST_STRAGGLER_POLICY', 'AUTODIST_GHOST_KNOB'},
        choices=probe, docs='AUTODIST_STRAGGLER_POLICY is one of '
                            'off|warn|verbose.'))
    assert 'AUTODIST_GHOST_KNOB' in found
    assert "never name the choice 'advise'" in found
    assert "'verbose'" in found and 'stale side: docs' in found


_PLAN = open(schedule_lint.PLAN_SRC).read()


@pytest.mark.parametrize('old, new, expect', [
    ("fusable.setdefault(bucket_fusion_key(plan, grad.dtype),",
     "fusable.setdefault((plan.group, str(grad.dtype)),",
     'bucket_fusion_key'),
    ('elif bucket_fusable(plan, var.dtype, size):',
     'elif plan.is_ar and plan.group is not None:', 'bucket_fusable'),
    ('return sir.execute(prog, g, self.group)',
     'return g', 'schedule_ir.execute'),
    ('spec, n, hier=hier, wus=True)', 'spec, n, hier=hier)', 'wus tag'),
    ('if self._wus_for(nbytes, dtype, cname, spec, wknob):', 'if False:',
     'choose_update_sharding'),
    ("for kind, phase in (('psum_scatter', 'grad'),\n"
     "                                ('all_gather', 'param')):",
     "for kind, phase in (('psum_scatter', 'grad'),):",
     'param-phase all-gather'),
], ids=['fusion_key', 'fusable', 'execute', 'wus_tag', 'wus_decision',
        'wus_gather'])
def test_schedule_lint_flags_a_doctored_plan(old, new, expect):
    drifted = _PLAN.replace(old, new)
    assert drifted != _PLAN, old
    found = schedule_lint.check_emission_predicates(drifted)
    assert any(expect in f for f in found), found


def test_schedule_lint_algebra_keeps_its_guard():
    """The seeded wrong schedule (the int8 requantize inside the ICI
    phase) is flagged by the port's IR algebra; reshard's preconditions
    and the wire pricing are checked over the port's modules."""
    from autodist_tpu_torch.parallel import schedule_ir as sir
    from autodist_tpu_torch.parallel.reshard import ReshardOp
    assert any('requantize' in f
               for f in sir.verify(schedule_lint.seeded_counterexample()))
    src = {'sharded': True, 'axis': 0, 'padded_dim': 10, 'pad': 1}
    dst = {'sharded': True, 'axis': 1, 'padded_dim': 4, 'pad': 0}
    op = ReshardOp(var_name='v', kind='all_to_all', src=src, dst=dst)
    assert any('cannot lower' in p for p in
               schedule_lint._check_op(op, src, dst, (9, 4), 2, 'probe'))
    from autodist_tpu_torch.parallel import compressor
    from autodist_tpu_torch.simulator import cost_model
    assert set(compressor._REGISTRY) == set(cost_model._WIRE_ITEMSIZE)


def test_swap_schema_pin_reads_the_ports_model():
    src = t_swapc._model_source()
    assert "'swap/ready'" in src
    found = '\n'.join(t_swapc.check_schema_pin(
        src.replace("'swap/ready'", "'swap/marker'")))
    assert 'swap/marker' in found and 'swap/ready' in found


# -- trace replay -----------------------------------------------------------
def _clean_events():
    """A run's control-plane events as the port's session records them:
    an exclusion, an admit, publishes and a slowdown that recovered."""
    return [('run_start', {}),
            ('fence_bind', {'worker': 'p0', 'generation': 0}),
            ('step_publish', {'worker': 'p1', 'step': 1}),
            ('fence_bump', {'worker': 'p1', 'by': 'p0'}),
            ('exclude_claim', {'worker': 'p1', 'claim': 1, 'by': 'p0'}),
            ('release', {'worker': 'p1', 'by': 'p0'}),
            ('epoch_bump', {'epoch': 1, 'by': 'p0'}),
            ('admit_claim', {'worker': 'p2', 'world': 3}),
            ('admit_fence_bind', {'worker': 'p2', 'generation': 0}),
            ('admit_epoch_bump', {'worker': 'p2', 'epoch': 2}),
            ('admit_floor_publish', {'worker': 'p2', 'floor': 2}),
            ('slowdown', {'worker': 'p2', 'step': 3}),
            ('step_publish', {'worker': 'p2', 'step': 3}),
            ('recovered', {'worker': 'p2', 'step': 5})]


#: Each doctoring of the clean trace and the finding kind it must give.
_DOCTORED_TRACES = {
    'resurrection': lambda ev: ev + [('step_publish',
                                      {'worker': 'p1', 'step': 0})],
    'fenced-write-commit': lambda ev: ev + [('step_publish',
                                             {'worker': 'p1', 'step': 2})],
    'unfenced-exclude': lambda ev: [e for e in ev if e[0] != 'fence_bump'],
    'admit-inversion': lambda ev: [e for e in ev
                                   if e[0] != 'admit_epoch_bump'],
    'step-regression': lambda ev: ev + [('step_publish',
                                         {'worker': 'p2', 'step': 2})],
    'epoch-regression': lambda ev: ev + [('epoch_adopt', {'epoch': 1})],
    'unmatched-recovery': lambda ev: [e for e in ev if e[0] != 'slowdown'],
}


def _port_dump(tmp_path, events, name):
    from autodist_tpu_torch.telemetry.flight import FlightRecorder
    rec = FlightRecorder(capacity=256)
    rec.set_context(ns='ns', worker='p0')
    for kind, fields in events:
        rec.record(kind, **fields)
    return rec.dump('doctored', path=str(tmp_path / name))


def _tags(findings):
    """(kind, event, who) of each finding; the messages name each
    package's own model configurations."""
    return [re.search(r'\[([\w-]+)\] at event #(\S+) \((.*?)\)', f).groups()
            for f in findings]


@pytest.mark.parametrize('kind', sorted(_DOCTORED_TRACES))
def test_doctored_port_dump_gives_the_references_findings(tmp_path, kind):
    clean = _port_dump(tmp_path, _clean_events(), 'clean.json')
    assert t_conf.analyze([clean]) == [] == j_conf.analyze([clean])
    path = _port_dump(tmp_path, _DOCTORED_TRACES[kind](_clean_events()),
                      'bad.json')
    got, want = t_conf.analyze([path]), j_conf.analyze([path])
    assert _tags(got) == _tags(want) and got, (got, want)
    assert kind in {k for k, _, _ in _tags(got)}, got


def test_swap_conformance_equals_the_reference():
    """The synthetic verified trace and every seeded bad trace give the
    same findings in both packages."""
    traces = [t_swapc._verified_trace()] + [
        trace for _, _, trace in t_swapc.SEEDED_TRACES]
    assert [t[2] for t in t_swapc.SEEDED_TRACES] == \
        [t[2] for t in j_swapc.SEEDED_TRACES]
    for trace in traces:
        assert t_swapc.check_swap_events(trace) == \
            j_swapc.check_swap_events(trace)


# -- the CLI ------------------------------------------------------------------
_NO_JAX = ("import sys, runpy; sys.modules['jax'] = None; "
           "sys.argv = ['analysis'] + sys.argv[1:]; "
           "runpy.run_module('autodist_tpu_torch.analysis', "
           "run_name='__main__')")


def _cli(*args):
    return subprocess.run([sys.executable, '-c', _NO_JAX, *args],
                          capture_output=True, text=True, cwd=REPO,
                          timeout=600)


def test_cli_all_json_without_jax(suites):
    r = _cli('--all', '--json')
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    report = json.loads(r.stdout)
    assert report['clean'] is True and report['findings'] == 0
    assert report['schema_version'] == 2
    assert set(report['analyzers']) == {
        'protocol', 'data-plane', 'epoch-swap', 'swap-conformance',
        'fence', 'env', 'schedule'}
    assert report['analyzers']['epoch-swap']['scenarios'] == \
        PORT_SWAP_STATES
    for name in ('protocol', 'data-plane', 'epoch-swap'):
        assert report['analyzers'][name]['scenarios'] == \
            suites['port', name][2]['scenarios'], name


def test_cli_conformance_exit_codes(tmp_path, capsys):
    from autodist_tpu_torch.analysis.__main__ import main
    good = _port_dump(tmp_path, _clean_events(), 'good.json')
    bad = _port_dump(tmp_path, _DOCTORED_TRACES['fenced-write-commit'](
        _clean_events()), 'bad.json')
    assert main(['--conformance', good, '--json']) == 0
    assert json.loads(capsys.readouterr().out)['clean'] is True
    assert main(['--conformance', good, bad]) == 1
    assert 'fenced-write-commit' in capsys.readouterr().out
    assert main(['--conformance', str(tmp_path / 'missing.json')]) == 1
    assert 'unreadable' in capsys.readouterr().out


def test_analysis_imports_no_jax():
    """The package imports neither jax nor the JAX package."""
    code = ("import sys; sys.modules['jax'] = None; "
            "import autodist_tpu_torch.analysis.__main__ as m; "
            "m._analyzers(); "
            "from autodist_tpu_torch.analysis import conformance; "
            "assert not [k for k in sys.modules "
            "if k == 'autodist_tpu' or k.startswith('autodist_tpu.')]")
    r = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
