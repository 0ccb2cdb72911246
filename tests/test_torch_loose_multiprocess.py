"""Loose mode across worker processes on the CPU: the loose cases of
``tests/integration/test_multiprocess.py`` through the port.

``AutoDist(strategy_builder=PS(staleness=k))`` in processes started with
``AUTODIST_PROCESS_ID`` / ``AUTODIST_NUM_PROCESSES`` /
``AUTODIST_COORD_SERVICE_ADDR`` runs in loose mode: no group, the
strategy from the chief over the coord service, the variables on its PS.
Cases that share a configuration run in one launch
(:func:`torch_loose_worlds.run_loose`); a token-protected service, four
workers and a crashing worker get launches of their own.
"""
import pytest

from torch_dsl_worlds import free_port, run_group
from torch_loose_worlds import run_loose

CASES = 'torch_loose_cases:'


@pytest.fixture(scope='module')
def pair():
    return run_loose(2, [
        ('stale', CASES + 'staleness', {'staleness': 3}),
        ('proxy', CASES + 'staleness',
         {'staleness': 3, 'local_proxy_variable': True}),
        ('async', CASES + 'staleness', {'sync': False}),
        ('bf16', CASES + 'staleness',
         {'staleness': 3, 'env': {'AUTODIST_PS_WIRE_DTYPE': 'bf16'}}),
        ('i8', CASES + 'staleness',
         {'staleness': 3, 'env': {'AUTODIST_PS_WIRE_DTYPE': 'i8'}}),
        ('momentum_shared', CASES + 'shared_optimizer', {}),
        ('momentum_local', CASES + 'shared_optimizer', {'shared': False}),
        ('adam_shared', CASES + 'shared_optimizer', {'opt': 'adam'}),
        ('adam_local', CASES + 'shared_optimizer',
         {'opt': 'adam', 'shared': False}),
        ('partitioned', CASES + 'partitioned', {}),
        ('clean', CASES + 'clean_shutdown',
         {'env': {'AUTODIST_HEARTBEAT_TIMEOUT': '4'}}),
    ], endpoints=2)


def test_staleness_bounds_fast_worker(pair):
    chief = pair['stale'][0]
    assert 2 <= max(chief['lead']) <= 3, chief['lead']
    assert chief['max_lag'] <= 3
    for r in pair['stale']:
        assert abs(r['b']) > 1e-4


def test_proxy_variable_serves_reads_from_cache(pair):
    assert max(pair['proxy'][0]['lead']) <= 3
    for r in pair['proxy']:
        # 8 steps x 2 variables: every pull after the first is a hit
        assert r['proxy_hits'] >= 14, r
        assert abs(r['b']) > 1e-4


def test_async_ps_never_blocks(pair):
    assert max(pair['async'][0]['lead']) >= 5, pair['async'][0]['lead']
    for r in pair['async']:
        assert abs(r['b']) > 1e-4


@pytest.mark.parametrize('wire', ['bf16', 'i8'])
def test_reduced_wires_end_to_end(pair, wire):
    assert max(pair[wire][0]['lead']) <= 3
    for r in pair[wire]:
        assert abs(r['b']) > 1e-4
    # two scalars a push: bf16 halves them; i8 frames carry a header
    # and a scale beside each byte, so they grow
    f32 = pair['stale'][0]['push_bytes']
    got = pair[wire][0]['push_bytes']
    assert got == (f32 // 2 if wire == "bf16" else f32 // 4 * 13)


def test_shared_optimizer_state_on_ps(pair):
    b_shared = pair['momentum_shared'][0]['b']
    b_local = pair['momentum_local'][0]['b']
    for r in pair['momentum_shared']:
        assert r['shared_pushes'] == 10, r
    for r in pair['momentum_local']:
        assert r['shared_pushes'] == 0, r
    assert abs(b_shared) > 1e-3 and abs(b_local) > 1e-3
    # the shared velocity integrates all 10 pushes
    assert abs(b_shared) > 1.15 * abs(b_local), (b_shared, b_local)


def test_shared_adam_state_on_ps(pair):
    for r in pair['adam_shared']:
        assert r['shared_pushes'] == 10, r
        assert r['stat']['steps'] == 10, r
        assert r['stat']['slot1'] and r['stat']['slot2'], r
        assert abs(r['b']) > 1e-2, r
    for r in pair['adam_local']:
        assert r['shared_pushes'] == 0 and r['stat']['steps'] == 0, r
        assert not r['stat']['slot1'] and not r['stat']['slot2'], r
        assert abs(r['b']) > 1e-2, r


def test_partitioned_var_shards_span_endpoints(pair):
    for r in pair['partitioned']:
        assert sorted(r['shard_eps']) == [0, 1], r
        assert r['moved_lo'] > 1e-5 and r['moved_hi'] > 1e-5, r
        total = sum(r['ep_bytes'])
        for b in r['ep_bytes']:
            assert 0.4 < b / total < 0.6, r


def test_clean_peer_shutdown_is_not_a_crash(pair):
    chief = pair['clean'][0]
    assert chief['failed'] == '' and chief['steps'] == 10, chief


def test_authenticated_loose_mode_end_to_end(monkeypatch):
    # this process holds the token too, to shut the service down
    monkeypatch.setenv('AUTODIST_COORD_TOKEN', 'torch-loose-secret-7')
    got = run_loose(2, [('stale', CASES + 'staleness', {'staleness': 3})])
    chief = got['stale'][0]
    assert 2 <= max(chief['lead']) <= 3, chief['lead']
    for r in got['stale']:
        assert abs(r['b']) > 1e-4


def test_four_worker_loose_staleness_and_heartbeats():
    got = run_loose(4, [('stale', CASES + 'staleness',
                         {'staleness': 2, 'steps': 6, 'sleep_s': 0.3,
                          'env': {'AUTODIST_HEARTBEAT_TIMEOUT': '30'}})])
    chief = got['stale'][0]
    assert 1 <= max(chief['lead']) <= 2, chief['lead']
    for r in got['stale']:
        assert abs(r['b']) > 1e-4


def test_dead_worker_fails_fast_not_hangs():
    got = run_loose(2, [('dead', CASES + 'dead_worker',
                         {'env': {'AUTODIST_HEARTBEAT_TIMEOUT': '4'}})],
                    required=(True, False))
    chief = got['dead'][0]
    assert 'missed heartbeats' in chief['failed'], chief
    assert chief['steps'] <= 4, chief
    assert chief['wait_s'] < 120, chief


def test_loose_mode_in_a_group_the_caller_formed():
    """Processes that formed a gloo group first (torchrun's way) run a
    relaxed PS strategy in loose mode too: each is its own worker, and
    both read the same PS value after both pushed."""
    got = run_group(2, [('loose', CASES + 'group_formed', {'env': {
        'AUTODIST_COORD_SERVICE_ADDR': '127.0.0.1:%d' % free_port()}})])
    got = got['loose']
    assert [g['worker'] for g in got] == ['p0', 'p1']
    assert all(g['session'] == 'LooseSession' and g['workers'] == 2
               for g in got)
    assert got[0]['b'] == got[1]['b'] and abs(got[0]['b']) > 1e-4
