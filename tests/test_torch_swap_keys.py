"""The port's epoch-swap key schema (``autodist_tpu_torch/runtime/
swap_keys.py``) against the JAX package's ``runtime/swap_keys.py``.

The plan codec is held in both directions: the port's encoding of a
Strategy equals the JAX encoding of the same Strategy byte for byte (the
one field that differs, the strategy's ``path`` under each package's own
working directory, is set alike first), and each package decodes the
other's payload into its own classes with an equal ``to_dict()``.
``compute_boundary`` is swept with hypothesis, and the key layout and
the stage / ack / nack / arm / cancel / purge / ready protocol are
driven with a port client and a JAX client on one coord service, each
reading what the other wrote.
"""
import threading

import pytest
from hypothesis import given, settings, strategies as st

from autodist_tpu.runtime import swap_keys as J
from autodist_tpu_torch.runtime import swap_keys as T


@pytest.fixture(scope='module')
def clients():
    from autodist_tpu.runtime.coord_client import CoordClient as JaxClient
    from autodist_tpu_torch.runtime.coord_client import CoordClient
    from autodist_tpu_torch.utils.loose_harness import (start_service,
                                                        stop_service)
    port, proc = start_service()
    port_c = CoordClient(('127.0.0.1', port))
    jax_c = JaxClient(('127.0.0.1', port))
    yield port_c, jax_c
    port_c.close()
    jax_c.close()
    stop_service(port, proc)


def _strategy(base, cost=True):
    """The same strategy built from either package's classes: a
    partitioned PS variable, a plain PS one and an AllReduce one."""
    s = base.Strategy('swapcodec0001')
    s.node_config.append(base.StrategyNode(
        var_name='emb', partitioner='2,1',
        part_config=[base.PSSynchronizer(reduction_destination='h:CPU:0',
                                         staleness=2),
                     base.PSSynchronizer(reduction_destination='h:CPU:1',
                                         staleness=2)]))
    s.node_config.append(base.StrategyNode(
        var_name='w', synchronizer=base.PSSynchronizer(
            reduction_destination='h:CPU:0', staleness=2,
            local_replication=True)))
    s.node_config.append(base.StrategyNode(
        var_name='b', synchronizer=base.AllReduceSynchronizer(
            compressor='HorovodCompressor')))
    s.graph_config.replicas = ['h:GPU:0', 'h:GPU:1']
    if cost:
        s.cost = {'builder': 'PartitionedPS',
                  'predicted_step_time_s': 0.0125}
    return s


@pytest.mark.parametrize('cost', [True, False])
@pytest.mark.parametrize('gen,world', [(1, 2), (7, 3)])
def test_plan_codec_is_the_jax_codec_byte_for_byte(cost, gen, world):
    from autodist_tpu.strategy import base as jbase
    from autodist_tpu_torch.strategy import base as tbase
    js, ts = _strategy(jbase, cost), _strategy(tbase, cost)
    ts.path = js.path
    assert T.encode_plan(gen, world, ts) == J.encode_plan(gen, world, js)
    # port reads the JAX payload into its own classes
    g, w, back = T.decode_plan(J.encode_plan(gen, world, js))
    assert (g, w) == (gen, world)
    assert type(back) is tbase.Strategy
    assert type(back.node_config[0].part_config[0]) is tbase.PSSynchronizer
    assert back.to_dict() == ts.to_dict()
    # and the JAX package reads the port's payload into its classes
    g, w, back = J.decode_plan(T.encode_plan(gen, world, ts))
    assert (g, w) == (gen, world)
    assert type(back) is jbase.Strategy
    assert back.to_dict() == js.to_dict()


def test_decoded_plan_takes_this_packages_path():
    from autodist_tpu.strategy import base as jbase
    from autodist_tpu_torch.const import DEFAULT_SERIALIZATION_DIR
    _, _, back = T.decode_plan(J.encode_plan(1, 2, _strategy(jbase)))
    assert back.path.startswith(DEFAULT_SERIALIZATION_DIR)


def test_key_layout_is_the_jax_layout():
    # the port's model also transitions on the re-key's ready marker
    assert T.MODEL_SYMBOLS == dict(J.MODEL_SYMBOLS,
                                   **{'swap/<g>/ready': 'swap/ready'})
    assert T.ready_key(7) == J.ready_key(7) and T.PREFIX == J.PREFIX
    assert T.gen_key() == J.gen_key()
    for g in (1, 2, 31):
        assert T.plan_key(g) == J.plan_key(g)
        assert T.boundary_key(g) == J.boundary_key(g)
        assert T.ready_key(g) == J.ready_key(g)
        assert T.gen_prefix(g) == J.gen_prefix(g)
        for w in (0, 3):
            assert T.ack_key(g, w) == J.ack_key(g, w)
            assert T.nack_key(g, w) == J.nack_key(g, w)


@settings(max_examples=200, deadline=None)
@given(floors=st.lists(st.integers(0, 1 << 20), min_size=1, max_size=16),
       staleness=st.integers(0, 64))
def test_compute_boundary_sweep(floors, staleness):
    b = T.compute_boundary(floors, staleness)
    assert b == J.compute_boundary(floors, staleness)
    # the safety margin: a member executing step s implies every member
    # published s - staleness - 1 or more, so none has started step b
    assert b == min(floors) + staleness + 2


def test_compute_boundary_refuses_no_members():
    with pytest.raises(ValueError, match='no live members'):
        T.compute_boundary([], 1)


def test_protocol_across_the_two_clients(clients):
    """The chief stages with one package's helpers and client, the peer
    acks, nacks and waits with the other's, and each sees the other's
    writes; a cancel withdraws the whole generation and purge_all the
    namespace."""
    from autodist_tpu.strategy import base as jbase
    from autodist_tpu_torch.strategy import base as tbase
    port_c, jax_c = clients
    for ns, (chief, cmod, base), (peer, pmod) in (
            ('swp-port-chief', (port_c, T, tbase), (jax_c, J)),
            ('swp-jax-chief', (jax_c, J, jbase), (port_c, T))):
        s = _strategy(base)
        cmod.stage_plan(chief, ns, 1, 2, s)
        assert pmod.current_gen(peer, ns) == 1
        g, w, got = pmod.read_plan(peer, ns, 1)
        assert (g, w) == (1, 2) and got.to_dict() == s.to_dict()
        pmod.write_ack(peer, ns, 1, 1)
        pmod.write_nack(peer, ns, 1, 2, 'no\nroom')
        acked, nacks = cmod.read_acks(chief, ns, 1, [1, 2])
        assert acked == {1} and nacks == {2: 'no room'}
        cmod.arm(chief, ns, 1, 9)
        assert pmod.read_boundary(peer, ns, 1) == 9
        # staging generation 2 purges generation 1's subtree
        cmod.stage_plan(chief, ns, 2, 3, s)
        assert pmod.read_plan(peer, ns, 1) is None
        assert pmod.read_boundary(peer, ns, 1) == 0
        assert pmod.current_gen(peer, ns) == 2
        waited = []
        t = threading.Thread(target=lambda: waited.append(
            pmod.wait_ready(peer, ns, 2, 30.0)))
        t.start()
        cmod.mark_ready(chief, ns, 2)
        t.join(timeout=30.0)
        assert waited and not t.is_alive()
        cmod.cancel(chief, ns, 2)
        assert pmod.read_plan(peer, ns, 2) is None
        assert pmod.current_gen(peer, ns) == 2
        cmod.purge_all(chief, ns)
        assert pmod.current_gen(peer, ns) == 0
