"""The port's span aggregation against the JAX package's
(``autodist_tpu/telemetry/aggregate.py``).

The same records, made from a seed with numpy, go through both
packages: a batch encoded by either decodes in the other bit for bit
(the float32 frames compared as their bytes, the records as equal
objects), and ``chrome_trace`` / ``step_timeline`` of the same records
give equal JSON. On one coord service a JAX client's pushed batch is
collected by a port client and the other way round, and the incremental
cursor of ``collect_new_records`` (``tests/test_monitor.py``'s
``test_collect_new_records_cursor``) walks the same sequence in both
packages. Tolerance: none, every comparison is exact.
"""
import json

import numpy as np
import pytest

from autodist_tpu.runtime import coord_client as jcc
from autodist_tpu.telemetry import aggregate as jagg
from autodist_tpu_torch.runtime import coord_client as pcc
from autodist_tpu_torch.telemetry import aggregate as pagg
from autodist_tpu_torch.utils.loose_harness import start_service, stop_service

PACKAGES = {'jax': (jagg, jcc), 'port': (pagg, pcc)}


@pytest.fixture(scope='module')
def port():
    port, proc = start_service()
    yield port
    stop_service(port, proc)


def make_records(seed, workers=('p0', 'p1'), steps=6):
    """Span records in the sessions' schema: a step span and the four
    phase spans a step, an rpc span, a point event and a non-ASCII tag
    (the JSON bytes must not depend on the encoder's escaping)."""
    rng = np.random.RandomState(seed)
    out = []
    for w in workers:
        for st in range(1, steps + 1):
            t0 = 1000.0 + st + float(rng.rand())
            for name in ('step', 'staleness_gate', 'pull_vars',
                         'push_deltas', 'pipeline_wait'):
                out.append({'name': name, 't0': t0,
                            'dur': float(rng.rand()) * 1e-2,
                            'tags': {'step': st, 'worker': w}})
            out.append({'name': 'rpc', 't0': t0 + 1e-3,
                        'dur': float(rng.rand()) * 1e-3,
                        'tags': {'cmd': 'BADD', 'bytes': int(
                            rng.randint(1, 1 << 20)), 'frames': 2}})
        out.append({'name': 'roofline', 't0': 1100.0,
                    'tags': {'worker': w, 'mfu': 0.25, 'note': 'µs'}})
    return out


def test_wire_bytes_are_the_jax_packages_both_ways():
    recs = make_records(0)
    jenc, penc = jagg.encode_records(recs), pagg.encode_records(recs)
    assert jenc.dtype == penc.dtype == np.float32
    assert jenc.tobytes() == penc.tobytes()
    assert pagg.decode_records(jenc) == recs
    assert jagg.decode_records(penc) == recs
    # the u32 length header reinterpreted as float32 survives as bits
    assert int(np.frombuffer(penc[:1].tobytes(), '<u4')[0]) == len(
        json.dumps(recs, separators=(',', ':')).encode('utf-8'))
    for pkg in (jagg, pagg):
        assert pkg.decode_records(None) == []
        assert pkg.decode_records(np.zeros(0, np.float32)) == []


@pytest.mark.parametrize('seed', [0, 1])
def test_chrome_trace_and_step_timeline_equal_json(seed):
    recs = make_records(seed)
    for r in recs:
        r['worker'] = r['tags'].get('worker', 'p0')
    flight = [{'kind': 'slowdown', 'wall': 1003.5, 't': 3.0, 'seq': 1,
               'worker': 'p1', 'worker_self': 'p0', 'step': 4}]
    for fe in (None, flight):
        assert json.dumps(pagg.chrome_trace(recs, fe), sort_keys=True) == \
            json.dumps(jagg.chrome_trace(recs, fe), sort_keys=True)
    assert json.dumps(pagg.step_timeline(recs), sort_keys=True) == \
        json.dumps(jagg.step_timeline(recs), sort_keys=True)
    trace = pagg.chrome_trace(recs, flight)
    names = {e['args']['name'] for e in trace['traceEvents']
             if e['ph'] == 'M'}
    assert names == {'worker p0', 'worker p1'}


@pytest.mark.parametrize('pusher,collector', [('jax', 'port'),
                                              ('port', 'jax')])
def test_pushed_batch_collected_by_the_other_package(port, pusher,
                                                      collector):
    push_agg, push_cc = PACKAGES[pusher]
    coll_agg, coll_cc = PACKAGES[collector]
    ns = 'agg-%s-%s' % (pusher, collector)
    recs = make_records(2, workers=('p1',), steps=3)
    a = push_cc.CoordClient(('127.0.0.1', port))
    b = coll_cc.CoordClient(('127.0.0.1', port))
    try:
        nbytes = push_agg.push_records(a, ns, 'p1', recs)
        assert nbytes == push_agg.encode_records(recs).size * 4
        assert push_agg.push_records(a, ns, 'p1', []) == 0
        got = coll_agg.collect_records(b, ns, ['p0', 'p1'])
        want = sorted((dict(r, worker='p1') for r in recs),
                      key=lambda r: r['t0'])
        assert got == want
        # the same bytes on the wire whichever package reads them
        assert b.vget('%s/telemetry/p1/b1' % ns, None, wire='f32') \
            .tobytes() == pagg.encode_records(recs).tobytes()
    finally:
        a.delete_namespace(ns + '/')
        a.close()
        b.close()


def _cursor_walk(agg, c, ns):
    """``test_collect_new_records_cursor``'s sequence: what each
    collection returns and the cursor after it."""
    trail = []
    agg.push_records(c, ns, 'p0', [{'name': 'step', 't0': 1.0,
                                    'dur': 0.01, 'tags': {'step': 1}}])
    cursor = {}
    trail.append((agg.collect_new_records(c, ns, ['p0', 'p1'], cursor),
                  dict(cursor)))
    trail.append((agg.collect_new_records(c, ns, ['p0', 'p1'], cursor),
                  dict(cursor)))
    agg.push_records(c, ns, 'p0', [{'name': 'step', 't0': 2.0,
                                    'dur': 0.01, 'tags': {'step': 2}}])
    trail.append((agg.collect_new_records(c, ns, ['p0', 'p1'], cursor),
                  dict(cursor)))
    # a counter bumped before its batch landed: the cursor holds
    c.incr('%s/telemetry/p0/batches' % ns, 1)
    trail.append((agg.collect_new_records(c, ns, ['p0'], cursor),
                  dict(cursor)))
    c.vset('%s/telemetry/p0/b3' % ns,
           agg.encode_records([{'name': 'step', 't0': 3.0, 'dur': 0.01,
                                'tags': {'step': 3}}]), wire='f32')
    trail.append((agg.collect_new_records(c, ns, ['p0'], cursor),
                  dict(cursor)))
    return trail


def test_collect_new_records_cursor_matches_jax(port):
    trails = {}
    for name, (agg, cc) in PACKAGES.items():
        c = cc.CoordClient(('127.0.0.1', port))
        try:
            trails[name] = _cursor_walk(agg, c, 'cursor-%s' % name)
            c.delete_namespace('cursor-%s/' % name)
        finally:
            c.close()
    assert trails['port'] == trails['jax']
    counts = [(len(recs), cur) for recs, cur in trails['port']]
    assert counts == [(1, {'p0': 1}), (0, {'p0': 1}), (1, {'p0': 2}),
                      (0, {'p0': 2}), (1, {'p0': 3})]
