"""Repo-wide static analysis of the port: one entry over the seven
analyzers, and the flight-recorder trace replay.

The port's counterpart of ``tools/analyze.py``, with the same flags, the
same ``--json`` record and the same exit code (0 = zero findings)::

    python -m autodist_tpu_torch.analysis --all            # everything
    python -m autodist_tpu_torch.analysis --fence --env    # just those
    python -m autodist_tpu_torch.analysis --all --json     # JSON report
    python -m autodist_tpu_torch.analysis --conformance dump.json
             # replay flight-recorder dumps through the protocol
             # invariants (and the epoch-swap orderings)

Analyzers (``autodist_tpu_torch/analysis/``):

  protocol    bounded model checking of the control-plane protocol
              (HEAD orderings explore clean; the seeded historical
              bugs must still re-derive as counterexamples)
  data-plane  bounded model checking of the PS data plane: chunked
              write sequences + torn-read parity, fence-recheck under
              the tensor lock, the depth-2 pipeline's bounded prefetch
              wait and floor discard, the telemetry batch cursor
  epoch-swap  the strategy-distribution-epoch handshake model: the
              port's stage->ack->arm->boundary->await->re-key ordering
              explores clean, the tempting-but-wrong orderings (and a
              re-key at once) counterexample
  swap-conformance
              epoch-swap trace conformance: the synthetic verified
              trace replays clean, seeded bad traces produce their
              findings, and runtime/swap_keys.py's key schema pins to
              the model's symbol table
  fence       coord_service.cc dispatcher fence-coverage + payload
              bounds + header table drift, the read-only client's
              blocked verbs and the swap key schema's verbs
  env         AUTODIST_* env reads of the port's tree declared, worker
              knobs forwarded, docs mention every knob (choice sets in
              sync)
  schedule    schedule-IR shape algebra over every emitter-reachable
              dimension combination (with a seeded wrong-schedule
              counterexample), the routes-through-the-IR drift check on
              both emission paths of parallel/plan.py, pricing parity,
              reshard shape algebra, wire-pricing drift

No devices and no processes. The report carries ``schema_version``,
per-pass wall time and, for the model checkers, states-explored counts.
"""
import argparse
import json
import sys
import time

#: Version of the --json report shape (``tools/analyze.py``'s).
SCHEMA_VERSION = 2

ANALYZER_NAMES = ('protocol', 'data-plane', 'epoch-swap',
                  'swap-conformance', 'fence', 'env', 'schedule')


def _analyzers():
    from autodist_tpu_torch.analysis import (data_plane_model, env_lint,
                                             epoch_swap_model, explore,
                                             fence_lint, schedule_lint,
                                             swap_conformance)
    # cheap lints first; the model checkers explore last
    return (('fence', fence_lint, fence_lint.analyze),
            ('env', env_lint, env_lint.analyze),
            ('swap-conformance', swap_conformance,
             swap_conformance.analyze),
            ('schedule', schedule_lint, schedule_lint.analyze),
            ('protocol', explore, explore.analyze),
            ('data-plane', data_plane_model, data_plane_model.analyze),
            ('epoch-swap', epoch_swap_model, epoch_swap_model.analyze))


def run(names=None):
    """Run the selected analyzers; returns the report dict."""
    report = {'schema_version': SCHEMA_VERSION, 'analyzers': {},
              'clean': True, 'findings': 0}
    for name, mod, fn in _analyzers():
        if names is not None and name not in names:
            continue
        t0 = time.monotonic()
        findings = fn()
        rec = {'findings': findings,
               'elapsed_s': round(time.monotonic() - t0, 3)}
        # model-checker passes publish their exploration size; the
        # lints have none
        stats = getattr(mod, 'LAST_STATS', None)
        if stats and 'states_explored' in stats:
            rec['states_explored'] = stats['states_explored']
            rec['scenarios'] = dict(stats['scenarios'])
        report['analyzers'][name] = rec
        report['findings'] += len(findings)
        if findings:
            report['clean'] = False
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog='python -m autodist_tpu_torch.analysis',
        description='repo-wide static analysis of the port (exit 0 = '
                    'zero findings)')
    ap.add_argument('--all', action='store_true',
                    help='run every analyzer')
    ap.add_argument('--protocol', action='store_true',
                    help='control-plane protocol model checker')
    ap.add_argument('--data-plane', action='store_true',
                    dest='data_plane',
                    help='PS data-plane model checker (chunk '
                         'sequences, torn reads, pipeline floors, '
                         'telemetry cursor)')
    ap.add_argument('--epoch-swap', action='store_true',
                    dest='epoch_swap',
                    help='strategy-distribution-epoch handshake model')
    ap.add_argument('--swap-conformance', action='store_true',
                    dest='swap_conformance',
                    help='epoch-swap trace conformance: synthetic '
                         'verified/seeded traces + key-schema pin '
                         'against the model symbol table')
    ap.add_argument('--fence', action='store_true',
                    help='coord_service.cc fence-coverage + '
                         'payload-bound lint')
    ap.add_argument('--env', action='store_true',
                    help='AUTODIST_* env-knob lint (declaration, '
                         'forwarding, docs drift)')
    ap.add_argument('--schedule', action='store_true',
                    help='schedule-IR shape-algebra verification + '
                         'routes-through-IR drift lint')
    ap.add_argument('--json', action='store_true',
                    help='print a machine-readable JSON report')
    ap.add_argument('--conformance', nargs='+', metavar='DUMP',
                    help='replay flight-recorder dump(s) through the '
                         'protocol-model invariants instead of the '
                         'static analyzers')
    args = ap.parse_args(argv)
    if args.conformance:
        from autodist_tpu_torch.analysis import conformance
        findings = conformance.analyze(args.conformance)
        report = {'schema_version': SCHEMA_VERSION,
                  'analyzers': {'conformance': {
                      'findings': findings, 'elapsed_s': 0.0}},
                  'clean': not findings, 'findings': len(findings)}
        if args.json:
            print(json.dumps(report, indent=2, sort_keys=True))
        else:
            for f in findings:
                print('  - ' + f)
            print('conformance %s: %d finding(s)'
                  % ('CLEAN' if not findings else 'FAILED',
                     len(findings)))
        return 0 if not findings else 1
    selected = {n for n in ANALYZER_NAMES
                if getattr(args, n.replace('-', '_'))}
    if args.all or not selected:
        selected = None
    report = run(selected)
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        for name, rec in report['analyzers'].items():
            status = 'clean' if not rec['findings'] else \
                '%d finding(s)' % len(rec['findings'])
            states = ', %d states' % rec['states_explored'] \
                if 'states_explored' in rec else ''
            print('%-11s %s (%.2fs%s)' % (name, status,
                                          rec['elapsed_s'], states))
            for f in rec['findings']:
                print('  - ' + f.replace('\n', '\n    '))
        print('analysis %s: %d finding(s)'
              % ('CLEAN' if report['clean'] else 'FAILED',
                 report['findings']))
    return 0 if report['clean'] else 1


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
