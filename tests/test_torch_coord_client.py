"""The port's coord client against ``tests/test_async_ps.py``'s wire and
pool tests, and against the JAX client itself.

One coord service for the module, built from the port's copy of
``coord_service.cc`` (pinned byte-identical to the JAX package's). A
JAX client and a port client on that service read each other's tensors
bit for bit on the f32, bf16 and i8 wires, and the port's ``_encode``
writes the JAX ``_encode``'s bytes on values that hold ±0, subnormals,
NaN, ±inf and rounding ties — the port encodes bf16 itself, without
``ml_dtypes``.
"""
import os
import select
import threading
import time

import numpy as np
import pytest

from autodist_tpu_torch.runtime import coord_client as pcc
from autodist_tpu_torch.utils.loose_harness import start_service, stop_service
from torch_dsl_worlds import REPO


@pytest.fixture(scope='module')
def coord():
    port, proc = start_service()
    # a running service on the port is joined, not started again
    assert pcc.ensure_service(port=port) is None
    yield lambda **kw: pcc.CoordClient(('127.0.0.1', port), **kw)
    stop_service(port, proc)


def test_coord_service_source_is_the_jax_copy():
    paths = [os.path.join(REPO, pkg, 'native', 'coord_service.cc')
             for pkg in ('autodist_tpu', 'autodist_tpu_torch')]
    jax_src, port_src = (open(p, 'rb').read() for p in paths)
    assert port_src == jax_src


def _special_values(rng):
    """f32 values that probe every branch of the codecs: signed zeros,
    subnormals, NaN with payloads and signs, infinities, the largest
    finite value (rounds to inf in bf16), exact bf16 rounding ties (both
    parities) and random normals."""
    bits = np.array([0x00000000, 0x80000000, 0x00000001, 0x80000001,
                     0x007fffff, 0x00408000, 0x7fc00000, 0xffc00000,
                     0x7f800001, 0xff812345, 0x7f800000, 0xff800000,
                     0x7f7fffff, 0x3f808000, 0x3f818000, 0xbf808000,
                     0x3f80ffff, 0x40490fdb], dtype=np.uint32)
    return np.concatenate([bits.view(np.float32),
                           rng.randn(1000).astype(np.float32) * 3.0,
                           (rng.randint(-2**15, 2**15, 500) * 2.0 ** -7)
                           .astype(np.float32)])


@pytest.mark.parametrize('wire', ['f32', 'bf16', 'i8'])
def test_encode_bytes_equal_the_jax_encoder(wire, monkeypatch):
    from autodist_tpu.runtime import coord_client as jcc
    monkeypatch.setenv('AUTODIST_QUANT_BLOCK', '64')
    x = _special_values(np.random.RandomState(0))
    if wire == 'i8':   # blockscale frames quantize finite values only
        x = x[np.isfinite(x)]
    assert bytes(pcc._encode(x, wire)) == bytes(jcc._encode(x, wire))
    raw = bytes(jcc._encode(x, wire))
    np.testing.assert_array_equal(pcc._decode(raw, wire).view(np.uint32),
                                  jcc._decode(raw, wire).view(np.uint32))


def test_bf16_bits_match_ml_dtypes_on_every_pattern_class():
    import ml_dtypes
    rng = np.random.RandomState(1)
    x = rng.randint(0, 2**32, 200000, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(pcc._to_bf16_bits(x), want)


@pytest.mark.parametrize('wire', ['f32', 'bf16', 'i8'])
def test_jax_and_port_clients_read_each_others_frames(coord, wire,
                                                      monkeypatch):
    """Port vset -> JAX vget and JAX vadd -> port vget on one service:
    the service stores what each decodes, and both read it alike."""
    from autodist_tpu.runtime import coord_client as jcc
    monkeypatch.setenv('AUTODIST_PS_CHUNK_BYTES', '4096')   # chunked
    port_c = coord()
    jax_c = jcc.CoordClient(port_c.address)
    rng = np.random.RandomState(2)
    x = _special_values(rng)[:1500]
    x = x[np.isfinite(x)]
    d = rng.randn(x.size).astype(np.float32)
    store = 'f32' if wire == 'i8' else wire    # i8 is push-only
    port_c.vset('x/%s' % wire, x, wire=store)
    got_jax = jax_c.vget('x/%s' % wire, shape=x.shape, wire=store)
    got_port = port_c.vget('x/%s' % wire, shape=x.shape, wire=store)
    np.testing.assert_array_equal(got_jax.view(np.uint32),
                                  got_port.view(np.uint32))
    np.testing.assert_array_equal(
        got_port.view(np.uint32),
        pcc.wire_roundtrip(x, store).view(np.uint32))
    jax_c.vadd('x/%s' % wire, d, wire=wire)
    port_c.vadd('x/%s' % wire, d, wire=wire)
    got_jax = jax_c.vget('x/%s' % wire, shape=x.shape)
    got_port = port_c.vget('x/%s' % wire, shape=x.shape)
    np.testing.assert_array_equal(got_jax.view(np.uint32),
                                  got_port.view(np.uint32))
    want = (pcc.wire_roundtrip(x, store) +
            pcc.wire_roundtrip(d, wire)) + pcc.wire_roundtrip(d, wire)
    np.testing.assert_array_equal(got_port, want)
    # a row-sparse push from each side lands on the same rows
    t = rng.randn(30, 8).astype(np.float32)
    port_c.vset('rows/%s' % wire, t)
    idx = np.array([1, 7, 7, 29], np.int32)
    rows = rng.randn(4, 8).astype(np.float32)
    jax_c.vsadd('rows/%s' % wire, idx, rows, wire=wire)
    port_c.vsadd('rows/%s' % wire, idx, rows, wire=wire)
    np.testing.assert_array_equal(
        jax_c.vgetrows('rows/%s' % wire, idx, 8),
        port_c.vgetrows('rows/%s' % wire, idx, 8))
    jax_c.close()


# -- pipelined multi-tensor RPCs ----------------------------------------------
@pytest.mark.parametrize('wire', ['f32', 'bf16'])
def test_vmset_vmget_multi_key_multi_chunk_exact(coord, monkeypatch, wire):
    monkeypatch.setenv('AUTODIST_PS_CHUNK_BYTES', '4096')
    c = coord()
    rng = np.random.RandomState(3)
    tensors = {'mk/a': rng.randn(5000).astype(np.float32),
               'mk/b': rng.randn(100, 7).astype(np.float32),
               'mk/c': rng.randn(3).astype(np.float32)}
    c.vmset(sorted(tensors.items()), wire=wire)
    specs = [(k, v.shape) for k, v in sorted(tensors.items())]
    for (k, _), arr in zip(specs, c.vmget(specs, wire=wire)):
        np.testing.assert_array_equal(
            arr, pcc.wire_roundtrip(tensors[k], wire), err_msg=k)
    got = c.vmget([('mk/a', (5000,)), ('mk/none', (4,)), ('mk/c', (3,))])
    assert got[1] is None
    assert got[0].shape == (5000,) and got[2].shape == (3,)


def test_vmadd_accumulates_and_counts(coord, monkeypatch):
    monkeypatch.setenv('AUTODIST_PS_CHUNK_BYTES', '4096')
    c = coord()
    rng = np.random.RandomState(4)
    a = rng.randn(5000).astype(np.float32)
    b = rng.randn(16).astype(np.float32)
    c.vmset([('ma/a', a), ('ma/b', b)])
    assert c.vmadd([('ma/a', a), ('ma/b', b)]) == {'ma/a': 1, 'ma/b': 1}
    assert c.vmadd([('ma/b', b)])['ma/b'] == 2
    np.testing.assert_allclose(c.vget('ma/a', shape=(5000,)), 2 * a,
                               rtol=1e-6)
    np.testing.assert_allclose(c.vget('ma/b', shape=(16,)), 3 * b,
                               rtol=1e-6)


def test_vmget_torn_read_interleaving(coord, monkeypatch):
    monkeypatch.setattr(pcc.CoordClient, 'STALL_TIMEOUT_S', 0.3)
    monkeypatch.setenv('AUTODIST_PS_TORN_RETRIES', '5')
    c, w = coord(), coord()
    t = np.arange(10, dtype=np.float32)
    clean = np.full(6, 7.0, np.float32)
    c.vmset([('torn/seq', t), ('torn/clean', clean)])
    half = t[:5].tobytes()
    assert w._rpc('BSET torn/seq %d f32 0 10' % len(half), half) == 'OK'
    with pytest.raises(OSError, match='mid-flight'):
        c.vmget([('torn/seq', (10,)), ('torn/clean', (6,))])
    assert w._rpc('BSET torn/seq %d f32 5 10' % len(half),
                  t[5:].tobytes()) == 'OK'
    got = c.vmget([('torn/seq', (10,)), ('torn/clean', (6,))])
    np.testing.assert_array_equal(got[0], t)
    np.testing.assert_array_equal(got[1], clean)


def test_vmget_retries_version_skew_between_chunks(coord, monkeypatch):
    monkeypatch.setenv('AUTODIST_PS_CHUNK_BYTES', '20')
    c, pusher = coord(), coord()
    base = np.arange(10, dtype=np.float32)
    c.vset('skew/k', base)
    real_send = pcc.CoordClient._send_frame
    seen, fired = [], []

    def send_with_one_push(self, line, payload=None):
        if self is c and line.startswith('BGET skew/k'):
            seen.append(line)
            if len(seen) == 2 and not fired:
                # vget writes both chunk requests before it reads a
                # reply, and the service serves each connection on its
                # own thread: hold the second request until the first
                # chunk's reply is on the socket (the first chunk was
                # served at the old version), then land the push, so the
                # skew falls between the two chunk reads by construction
                ready, _, _ = select.select([self._sock], [], [], 30.0)
                assert ready, 'first chunk reply never arrived'
                fired.append(True)
                pusher.vadd('skew/k', np.ones(10, np.float32))
        return real_send(self, line, payload)

    monkeypatch.setattr(pcc.CoordClient, '_send_frame', send_with_one_push)
    np.testing.assert_array_equal(c.vget('skew/k', shape=(10,)), base + 1)
    assert fired and len(seen) > 2


def test_stall_timeout_env_knob(coord, monkeypatch):
    from autodist_tpu_torch.const import ENV
    monkeypatch.setenv('AUTODIST_PS_STALL_TIMEOUT_S', '0.2')
    c = coord()
    assert c.stall_timeout_s == 0.2
    monkeypatch.setenv('AUTODIST_PS_STALL_TIMEOUT_S', '-1')
    with pytest.raises(ValueError, match='AUTODIST_PS_STALL_TIMEOUT_S'):
        ENV.AUTODIST_PS_STALL_TIMEOUT_S.val
    monkeypatch.delenv('AUTODIST_PS_STALL_TIMEOUT_S')
    assert c.stall_timeout_s == pcc.CoordClient.STALL_TIMEOUT_S
    t = np.arange(10, dtype=np.float32)
    c.vset('stall/knob', t)
    w = coord()
    half = t[:5].tobytes()
    assert w._rpc('BSET stall/knob %d f32 0 10' % len(half), half) == 'OK'
    monkeypatch.setenv('AUTODIST_PS_STALL_TIMEOUT_S', '0.2')
    t0 = time.monotonic()
    with pytest.raises(OSError, match='mid-flight'):
        c.vget('stall/knob', shape=(10,))
    assert time.monotonic() - t0 < 5.0
    assert w._rpc('BSET stall/knob %d f32 5 10' % len(half),
                  t[5:].tobytes()) == 'OK'


def test_encode_skips_copy_on_conforming_input():
    a = np.arange(12, dtype=np.float32)
    flat = pcc._as_f32_flat(a)
    assert flat.base is a or flat is a
    payload = pcc._encode(a, 'f32')
    assert isinstance(payload, memoryview)
    assert bytes(payload) == a.tobytes()
    b = np.arange(12, dtype=np.float64).reshape(3, 4).T
    assert bytes(pcc._encode(b, 'f32')) == \
        np.ascontiguousarray(b.astype(np.float32)).tobytes()


def test_wire_dtype_never_falls_back(monkeypatch):
    monkeypatch.setenv('AUTODIST_PS_WIRE_DTYPE', 'bf16')
    assert pcc._wire_dtype() == 'bf16' and pcc._pull_wire() == 'bf16'
    monkeypatch.setenv('AUTODIST_PS_WIRE_DTYPE', 'i8')
    assert pcc._wire_dtype() == 'i8' and pcc._pull_wire() == 'f32'
    with pytest.raises(ValueError, match='unsupported'):
        pcc._wire_dtype('fp8')


# -- TransferPool -------------------------------------------------------------
class _FakeClient:
    def close(self):
        pass


def test_transfer_pool_fifo_and_concurrency():
    order = []
    gate = threading.Event()
    pool = pcc.TransferPool([_FakeClient, _FakeClient])
    try:
        def slow(_):
            gate.wait(5.0)
            order.append('ep0-slow')

        def other(_):
            order.append('ep1')
            gate.set()

        jobs = [pool.submit(0, slow),
                pool.submit(0, lambda _: order.append('ep0-after')),
                pool.submit(1, other)]
        for j in jobs:
            j.result(timeout=10.0)
        assert order == ['ep1', 'ep0-slow', 'ep0-after']
    finally:
        pool.close()


def test_transfer_pool_submit_after_close_raises():
    pool = pcc.TransferPool([_FakeClient])
    assert pool.run([(0, lambda _: 'ok')]) == ['ok']
    pool.close()
    with pytest.raises(OSError, match='closed'):
        pool.submit(0, lambda _: 'never')


def test_transfer_pool_aggregates_endpoint_errors():
    pool = pcc.TransferPool([_FakeClient] * 3)
    try:
        def boom(tag):
            def go(_):
                raise ValueError('endpoint %s wire down' % tag)
            return go

        with pytest.raises(ValueError, match='wire down'):
            pool.run([(0, boom('A')), (1, lambda _: 1), (2, lambda _: 1)])
        with pytest.raises(RuntimeError) as ei:
            pool.run([(0, boom('A')), (1, lambda _: 1), (2, boom('C'))])
        msg = str(ei.value)
        assert 'endpoint 0' in msg and 'endpoint 2' in msg
        assert pool.run([(1, lambda _: 'fine')]) == ['fine']
    finally:
        pool.close()


def test_transfer_pool_reconnects_after_connection_error(coord):
    pool = pcc.TransferPool([lambda: coord()])
    try:
        pool.run([(0, lambda c: c.set('pool/alive', '1'))])

        def kill(c):
            c._sock.close()
            return c.get('pool/alive')

        with pytest.raises(OSError):
            pool.run([(0, kill)])
        assert pool.run([(0, lambda c: c.get('pool/alive'))]) == ['1']
    finally:
        pool.close()


# -- gate, heartbeats, auth ---------------------------------------------------
def test_staleness_gate_and_dead_workers(coord):
    c = coord()
    c.publish_step('p0', 5, prefix='g/step/')
    c.publish_step('p1', 2, prefix='g/step/')
    c.staleness_gate(4, 2, 2, prefix='g/step/', timeout_s=2.0)
    with pytest.raises(TimeoutError):
        c.staleness_gate(5, 2, 2, prefix='g/step/', timeout_s=0.3,
                         failure_check=lambda: None, slice_s=0.1)
    seen = {}
    c.heartbeat('g/p0')
    assert c.dead_workers(['g/p0', 'g/p1'], 1.0, seen, now=0.0) == []
    c.heartbeat('g/p0')
    assert c.dead_workers(['g/p0', 'g/p1'], 1.0, seen, now=5.0) == \
        ['g/p1']


def test_coord_token_challenge(monkeypatch):
    """A token-protected service admits a client holding the secret,
    refuses one without it, and a client with a token refuses an open
    service (no downgrade)."""
    monkeypatch.setenv('AUTODIST_COORD_TOKEN', 'torch-secret-1')
    port, proc = start_service()
    try:
        pcc.CoordClient(('127.0.0.1', port)).set('auth/k', 'v')
        monkeypatch.delenv('AUTODIST_COORD_TOKEN')
        with pytest.raises(OSError, match='requires authentication'):
            pcc.CoordClient(('127.0.0.1', port))
    finally:
        monkeypatch.setenv('AUTODIST_COORD_TOKEN', 'torch-secret-1')
        stop_service(port, proc)
    monkeypatch.delenv('AUTODIST_COORD_TOKEN')
    open_port, proc = start_service()
    try:
        monkeypatch.setenv('AUTODIST_COORD_TOKEN', 'torch-secret-1')
        with pytest.raises(OSError, match='UNAUTHENTICATED'):
            pcc.CoordClient(('127.0.0.1', open_port))
    finally:
        monkeypatch.delenv('AUTODIST_COORD_TOKEN')
        stop_service(open_port, proc)
