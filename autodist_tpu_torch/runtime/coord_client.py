"""Client + process manager for the native coordination service.

The port's copy of ``autodist_tpu/runtime/coord_client.py``: the same
protocol, frames and helpers, so a port client and a JAX client on one
service read each other's tensors bit for bit. Two things differ: the
imports (the port's ``const``, ``telemetry.core``, ``utils.logging`` and
``native_build``), and bf16, which the JAX client takes from
``ml_dtypes`` (a jax dependency) and this one encodes itself, rounding
the f32 bits to nearest-even with NaN kept, the bytes ``ml_dtypes``
writes (:func:`_to_bf16_bits`). There is no fallback to f32.

The service (native/coord_service.cc) provides the between-program
control plane: barriers, counters, bounded-staleness windows, heartbeats.
See the source header for the protocol. The chief starts one instance
(:func:`ensure_service`); every process connects with
:class:`CoordClient`.

Bounded staleness (reference semantics, ps_synchronizer.py:387-458 and
the c9 timing contract): each worker publishes its step counter under
``step/<worker>``; before running step ``s`` a worker calls
:meth:`staleness_gate`, which blocks until ``min(all steps) >= s -
staleness``. A fast worker can thus run at most ``staleness`` steps ahead
— the queue-capacity semantics without TF FIFO queues.

The tensor data plane (:meth:`CoordClient.vset` / ``vget`` / ``vadd`` /
``vstep``) speaks length-prefixed binary frames: a text header line
declaring the byte count, then the raw tensor bytes — f32, bf16 or
block-quantized i8 on the wire (``AUTODIST_PS_WIRE_DTYPE``), f32 at
rest on the service. This is the grpc-data-plane equivalent the
reference rode for PS traffic; base64 text framing (33% inflation,
full-line buffering) is gone.

The ``i8`` wire (EQuARX-style blockscale: ``u32 block, u32 n, f32
scales x ceil(n/block), int8 q x n`` — one f32 scale per
``AUTODIST_QUANT_BLOCK`` int8 values) is a PUSH-direction format:
deltas/gradients quantize to ~1/4 the f32 bytes, the service
accumulates at f32 rest, and the session carries a host-side
error-feedback residual per pushed delta (runtime/session.py) so loose
mode stays convergent. Pulls and authoritative stores under an ``i8``
setting ride f32 (quantizing at-rest state or reads would compound
error with no residual to absorb it) — see
docs/design/quantized-wire.md.

Row-sparse forms (:meth:`CoordClient.vsadd` / ``vgetrows`` and their
batched ``vmsadd`` / ``vmgetrows``) move only the TOUCHED rows of an
embedding-style ``[rows, cols]`` tensor: a push ships ``int32 row
indices || row data`` and the service scatter-adds it (BSADD), a fetch
requests listed rows (BGETROWS) — O(batch) wire instead of
O(vocab x dim) when a step touches few rows.

The multi-tensor variants (:meth:`CoordClient.vmget` / ``vmset`` /
``vmadd``) PIPELINE their RPCs: all request frames are written ahead of
draining the replies on the same socket, so a pull of N chunks pays one
wire round trip instead of N. The service protocol is strictly
sequential per connection (one request fully handled before the next is
read), which is exactly what makes this safe — replies come back in
request order. :class:`TransferPool` supplies the persistent
per-endpoint worker threads (one dedicated connection each) the session
drives these through.
"""
import hashlib
import hmac as hmac_mod
import os
import queue
import socket
import subprocess
import threading
import time

import numpy as np

from autodist_tpu_torch.const import DEFAULT_COORD_PORT, ENV
from autodist_tpu_torch.telemetry import core as _telemetry
from autodist_tpu_torch.utils import logging


def _to_bf16_bits(arr):
    """float32 array -> its bfloat16 bits (uint16): round to nearest
    even on the f32 bits (overflow rounds to inf), every NaN to the
    quiet NaN 0x7fc0 with its sign — what ``ml_dtypes`` writes."""
    u = np.ascontiguousarray(arr, dtype=np.float32).view(np.uint32)
    out = ((u + (np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))))
           >> 16).astype(np.uint16)
    nan = np.isnan(arr)
    if nan.any():
        out[nan] = ((u[nan] >> 16) & np.uint32(0x8000)).astype(
            np.uint16) | np.uint16(0x7FC0)
    return out


def _from_bf16_bits(raw):
    """bfloat16 bytes -> float32 array (exact: a bf16 is the top half
    of an f32)."""
    return (np.frombuffer(raw, dtype='<u2').astype(np.uint32)
            << 16).view(np.float32)


#: commands that block at the service until a condition holds (the
#: staleness gate's MINWAIT, WAITGE, BARRIER): their spans are
#: ``rpc_wait``, not ``rpc``, so the cohort monitor never takes a wait
#: for a link sample
_WAIT_CMDS = frozenset(('BARRIER', 'MINWAIT', 'WAITGE'))


class FencedWriteError(OSError):
    """A write was rejected because this connection's fencing
    generation has been superseded — this process was declared dead
    and a survivor (or its own replacement) bumped its fence counter.
    A zombie receiving this must stop writing; recovery belongs to the
    supervising coordinator, not to the fenced process."""


class ReadOnlyViolation(OSError):
    """A mutating command was attempted on a read-only connection.

    Raised LOCALLY, before the frame reaches the wire: a read-only
    client (``CoordClient(read_only=True)`` — the serving tier's data
    connection) holds the invariant that it can never perturb the
    training namespace, so the guard must not depend on server-side
    enforcement or on which keys the command happens to touch."""


#: Command verbs a read-only connection refuses locally. The mutating
#: set mirrors the server's write surface (fence_lint's MUTATING table
#: machine-checks the correspondence): SET/DEL/DELNS/INCR on the KV
#: plane, BSET/BADD/BSADD/BSTEP on the tensor plane — plus FENCE,
#: which is not a write but BINDS a writer generation: a reader taking
#: a fence would enter the cohort's zombie-detection protocol, and
#: readers must never hold writer generations.
READ_ONLY_BLOCKED = frozenset(
    {'SET', 'DEL', 'DELNS', 'INCR', 'BSET', 'BADD', 'BSADD', 'BSTEP',
     'FENCE'})


# process-wide connection-retry accounting (profiling.health_report):
# every failed connect attempt inside connect_with_retry counts here.
RETRY_STATS = {'connect_retries': 0}


def _check_fenced(resp, what):
    """Raise the typed fencing error on an `ERR fenced` reply."""
    if resp.startswith('ERR fenced'):
        raise FencedWriteError(
            '%s rejected: writer generation fenced (this process was '
            'declared dead and superseded)' % what)
    return resp


def _raise_batch(errs):
    """Raise a pipelined batch's aggregated errors, keeping the typed
    fencing error when any reply was a fence rejection (a zombie's
    whole batch dies the moment its generation is superseded)."""
    msg = '; '.join(errs)
    if any('ERR fenced' in e for e in errs):
        raise FencedWriteError(msg)
    raise OSError(msg)


def coord_token():
    """The coord-service shared secret, or '' for an open service.

    Resolution order: ``AUTODIST_COORD_TOKEN`` (direct env), then
    ``AUTODIST_COORD_TOKEN_FILE`` (the ssh coordinator ships the secret
    as a mode-0600 file because env assignments ride the remote command
    line, world-readable in ``ps``)."""
    token = ENV.AUTODIST_COORD_TOKEN.val
    if token:
        return token
    path = ENV.AUTODIST_COORD_TOKEN_FILE.val
    if path:
        try:
            with open(path) as f:
                return f.read().strip()
        except OSError:
            logging.warning('coord token file %s unreadable', path)
    return ''


def _wire_dtype(wire=None):
    """Resolve the wire dtype name ('f32'|'bf16'|'i8')."""
    wire = wire or ENV.AUTODIST_PS_WIRE_DTYPE.val
    if wire not in ('f32', 'bf16', 'i8'):
        raise ValueError('unsupported PS wire dtype %r' % wire)
    return wire


def _pull_wire(wire=None):
    """The wire dtype for PULLS and authoritative STORES: i8 is a
    push-direction (delta) format — quantizing reads or at-rest state
    would compound error with no error-feedback residual to absorb it —
    so an ``i8`` setting downgrades to f32 here; f32/bf16 pass
    through."""
    wire = _wire_dtype(wire)
    return 'f32' if wire == 'i8' else wire


def _quant_block():
    """Elements per f32 scale in i8 blockscale frames
    (``AUTODIST_QUANT_BLOCK``; each frame also carries its block size,
    so decode never depends on this process's setting)."""
    return ENV.AUTODIST_QUANT_BLOCK.val


def _as_f32_flat(value):
    """Host value -> flat contiguous float32 array WITHOUT copying when
    the input already conforms — the common hot-path case (session
    deltas and pulled buffers are contiguous float32 already). Only a
    wrong dtype or non-contiguous layout pays a copy."""
    arr = np.asarray(value)
    if arr.dtype != np.float32:
        arr = arr.astype(np.float32)
    if not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)
    return arr.reshape(-1)


def _encode(arr, wire):
    """float32 host array -> raw wire bytes.

    The f32 path returns a zero-copy memoryview over the source array
    (``tobytes`` paid a full payload copy per frame); callers must not
    mutate the source until the frame is sent. The i8 path emits the
    blockscale frame ``u32 block, u32 n, f32 scales, int8 q``
    (symmetric per-block quantization, round-half-to-even like the
    service's own encoder)."""
    arr = _as_f32_flat(arr)
    if wire == 'bf16':
        return _to_bf16_bits(arr).tobytes()
    if wire == 'i8':
        import struct
        block = _quant_block()
        n = arr.size
        nb = -(-n // block)
        padded = np.zeros(nb * block, np.float32)
        padded[:n] = arr
        blocks = padded.reshape(nb, block)
        # float32 throughout: the scale each q multiplies against on
        # decode (here, in C++, and in wire_roundtrip) must be the
        # same float32 value, or the error-feedback residual the
        # session carries would not be exact
        scales = (np.abs(blocks).max(axis=1) / np.float32(127.0) +
                  np.float32(1e-30)).astype(np.float32)
        q = np.clip(np.rint(blocks / scales[:, None]),
                    -127, 127).astype(np.int8)
        return (struct.pack('<II', block, n) + scales.tobytes() +
                q.reshape(-1)[:n].tobytes())
    return memoryview(arr).cast('B')


def _decode(raw, wire):
    """Raw wire bytes -> float32 host array."""
    if wire == 'bf16':
        return _from_bf16_bits(raw)
    if wire == 'i8':
        import struct
        block, n = struct.unpack('<II', bytes(raw[:8]))
        nb = -(-n // block) if block else 0
        if not block or len(raw) != 8 + nb * 4 + n:
            raise ValueError('malformed i8 blockscale frame '
                             '(%d bytes, block=%d n=%d)'
                             % (len(raw), block, n))
        scales = np.frombuffer(raw, dtype='<f4', count=nb, offset=8)
        q = np.frombuffer(raw, dtype=np.int8, count=n,
                          offset=8 + nb * 4)
        padded = np.zeros(nb * block, np.float32)
        padded[:n] = q
        return (padded.reshape(nb, block) *
                scales[:, None]).reshape(-1)[:n].copy()
    return np.frombuffer(raw, dtype=np.float32)


def _wire_itemsize(wire):
    """Approximate wire bytes per element (i8 carries a ~4/block scale
    overhead on top; :func:`wire_nbytes` accounts it exactly)."""
    return {'bf16': 2, 'i8': 1}.get(wire, 4)


def _chunk_elems(wire):
    """Elements per frame chunk (AUTODIST_PS_CHUNK_BYTES of wire
    bytes); 0 disables chunking."""
    limit = ENV.AUTODIST_PS_CHUNK_BYTES.val
    if not limit:
        return 0
    return max(1, limit // _wire_itemsize(wire))


def _chunk_ranges(n_elems, wire):
    """Chunk ranges [(off, count)] covering ``n_elems``; a single
    (0, n) range means 'send unranged' (whole-tensor frame). Module
    level so :func:`wire_roundtrip` replicates the EXACT per-frame
    quantization layout a push produced."""
    chunk = _chunk_elems(wire)
    if not chunk or n_elems <= chunk:
        return [(0, n_elems)]
    return [(off, min(chunk, n_elems - off))
            for off in range(0, n_elems, chunk)]


def _row_chunk_ranges(nrows, bytes_per_row):
    """Row-chunk ranges [(off, count)] so no frame exceeds
    ``AUTODIST_PS_CHUNK_BYTES`` of wire bytes."""
    limit = ENV.AUTODIST_PS_CHUNK_BYTES.val
    if not limit or nrows * bytes_per_row <= limit:
        return [(0, nrows)]
    per = max(1, limit // bytes_per_row)
    return [(off, min(per, nrows - off))
            for off in range(0, nrows, per)]


def wire_roundtrip(arr, wire=None):
    """What the service will STORE for a dense pushed array: the exact
    ``decode(encode(chunk))`` of every frame a ``vadd``/``vstep`` of
    ``arr`` emits, reassembled to ``arr``'s shape. f32 is the identity;
    bf16 is round-to-nearest-even; i8 is the per-chunk blockscale
    round-trip. The session's error-feedback residual is
    ``compensated - wire_roundtrip(compensated)`` — exactly the mass
    the wire dropped, bit-for-bit (the same float32 ops run here and on
    the service)."""
    wire = _wire_dtype(wire)
    arr32 = np.asarray(arr, dtype=np.float32)
    if wire == 'f32':
        return arr32
    flat = _as_f32_flat(arr32)
    out = np.empty(flat.size, np.float32)
    for off, count in _chunk_ranges(flat.size, wire):
        out[off:off + count] = _decode(
            bytes(_encode(flat[off:off + count], wire)), wire)
    return out.reshape(arr32.shape)


def rows_roundtrip(rows, wire=None):
    """:func:`wire_roundtrip` for the row-sparse push (``vsadd``):
    the exact decode of every row-chunk frame's encoded blob, shaped
    ``[nrows, ncols]`` like the input."""
    wire = _wire_dtype(wire)
    rows = np.asarray(rows, dtype=np.float32)
    if wire == 'f32':
        return rows
    out = np.empty_like(rows)
    row_wire = rows.shape[1] * _wire_itemsize(wire)
    for off, count in _row_chunk_ranges(rows.shape[0], 4 + row_wire):
        out[off:off + count] = _decode(
            bytes(_encode(rows[off:off + count], wire)),
            wire).reshape(count, -1)
    return out


def wire_nbytes(n_elems, wire=None):
    """Payload bytes ``n_elems`` floats occupy on the given wire,
    including the i8 blockscale overhead (8-byte header + one f32
    scale per ``AUTODIST_QUANT_BLOCK`` elements, per chunk frame)."""
    wire = _wire_dtype(wire)
    if wire != 'i8':
        return n_elems * _wire_itemsize(wire)
    block = _quant_block()
    total = 0
    for _, count in _chunk_ranges(n_elems, wire):
        total += 8 + 4 * (-(-count // block)) + count
    return total


def ensure_service(port=DEFAULT_COORD_PORT, wait_s=10.0, bind='127.0.0.1'):
    """Start the native service on this host if nothing is listening.

    Binds loopback by default; multi-host launchers pass ``bind='0.0.0.0'``
    (or the coordinator interface) explicitly.
    """
    try:
        CoordClient(('127.0.0.1', port), timeout=0.5).ping()
        return None  # already running
    except OSError:
        pass
    from autodist_tpu_torch.native_build import build
    binary = build('coord_service.cc')
    env = dict(os.environ)
    token = coord_token()
    if token:
        # the service reads the secret from its environment only (argv
        # would be visible in ps); resolve token-file transport here
        env['AUTODIST_COORD_TOKEN'] = token
    proc = subprocess.Popen([binary, str(port), bind],
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL, env=env)
    deadline = time.time() + wait_s
    while time.time() < deadline:
        try:
            CoordClient(('127.0.0.1', port), timeout=0.5).ping()
            logging.info('coord_service started on :%d (pid %d)',
                         port, proc.pid)
            return proc
        except OSError:
            time.sleep(0.05)
    # the spawned process may be alive but unresponsive (or still
    # binding): kill it before raising, or it leaks as an orphan
    # holding the port and every subsequent start attempt on this
    # port fails against the half-dead listener
    proc.terminate()
    try:
        proc.wait(timeout=5.0)
    except subprocess.TimeoutExpired:  # pragma: no cover - stuck child
        proc.kill()
        proc.wait(timeout=5.0)
    raise RuntimeError('coord_service failed to start on :%d '
                       '(spawned pid %d killed)' % (port, proc.pid))


# A step counter at/above this value means the worker has LEFT the run
# (clean close, or an exclude-policy release of a dead peer's counter),
# not that it trained 2^30 steps — see publish_step's release note.
CLEAN_CLOSE_STEP = 1 << 30


def ps_endpoints():
    """Configured PS data-plane endpoints as (host, port) tuples.

    Empty when ``AUTODIST_PS_ENDPOINTS`` is unset — the single-endpoint
    layout where variables live on the coord service itself.
    """
    raw = ENV.AUTODIST_PS_ENDPOINTS.val
    if not raw:
        return []
    eps = []
    for item in raw.split(','):
        item = item.strip()
        if not item:   # tolerate trailing commas / blank entries
            continue
        if ':' not in item:
            raise ValueError(
                'AUTODIST_PS_ENDPOINTS entries must be host:port; got %r'
                % item)
        host, port = item.rsplit(':', 1)
        eps.append((host, int(port)))
    return eps


def connect_with_retry(address=None, deadline_s=30.0, op_timeout=300.0,
                       read_only=False):
    """Connect to the coord service, retrying until it comes up (workers
    may start before the chief's ensure_service).

    Connection attempts stay snappy (5 s), but the ESTABLISHED client
    gets ``op_timeout`` per socket operation: data-plane transfers move
    multi-MB frames through per-tensor locks under contention, and a
    single 64 KB recv stalling past a short probe timeout would kill a
    healthy pull (observed as a flaky 4-worker x 105 MB test on a
    loaded one-core host). Callers that need FAST failure detection on
    an established connection (e.g. heartbeat loops) pass a small
    ``op_timeout`` instead.

    Retries back off exponentially (0.05 s doubling to a 2 s cap) with
    ±25% deterministic-free jitter so a herd of workers restarted
    together does not hammer the service in lockstep; the final
    RuntimeError chains ``from`` the last OSError so the root cause
    (ECONNREFUSED vs EHOSTUNREACH vs auth failure) survives into the
    traceback.

    ``read_only=True`` returns a reader connection (serving tier): no
    fence binding ever, and every mutating verb raises
    :class:`ReadOnlyViolation` locally."""
    import random
    deadline = time.time() + deadline_s
    last = None
    delay = 0.05
    while time.time() < deadline:
        try:
            c = CoordClient(address, timeout=5.0, op_timeout=op_timeout,
                            read_only=read_only)
            c.ping()
            return c
        except OSError as e:
            last = e
            RETRY_STATS['connect_retries'] += 1
            _telemetry.get().count('coord/connect_retries')
            time.sleep(min(delay * (1.0 + random.uniform(-0.25, 0.25)),
                           max(0.0, deadline - time.time())))
            delay = min(delay * 2.0, 2.0)
    raise RuntimeError('coord_service unreachable at %s: %s'
                       % (address, last)) from last


class CoordClient:
    """Blocking line-protocol client."""

    # Fault-injection hook (utils/faultline.py): when set (class-wide,
    # chaos tests / bench recovery only), called as
    # ``hook(client, line, payload)`` before every request frame hits
    # the wire. The hook may raise (drop/close faults), sleep (delay
    # faults) or return a replacement ``(line, payload)`` (torn-frame
    # faults). None in production — one attribute test per frame.
    fault_hook = None

    # How long a torn pull waits for an in-flight chunked write whose
    # version has stopped advancing before declaring the writer dead.
    # Must cover one full chunk frame's encode+wire time (the version
    # only moves per landed frame); tests shrink it, deployments tune
    # it via AUTODIST_PS_STALL_TIMEOUT_S (see stall_timeout_s).
    STALL_TIMEOUT_S = 10.0

    @property
    def stall_timeout_s(self):
        """The torn-read stall window: ``AUTODIST_PS_STALL_TIMEOUT_S``
        when set (validated > 0 in const.py like the sibling
        TORN_RETRIES/BACKOFF knobs), else the class default — which
        tests shrink by patching :attr:`STALL_TIMEOUT_S`."""
        if os.environ.get(ENV.AUTODIST_PS_STALL_TIMEOUT_S.name):
            return ENV.AUTODIST_PS_STALL_TIMEOUT_S.val
        return self.STALL_TIMEOUT_S

    def __init__(self, address=None, timeout=None, op_timeout=None,
                 read_only=False):
        if address is None:
            raw = ENV.AUTODIST_COORD_SERVICE_ADDR.val
            if raw:
                host, port = raw.rsplit(':', 1)
                address = (host, int(port))
            else:
                address = ('127.0.0.1', DEFAULT_COORD_PORT)
        # the RESOLVED address, so sibling connections (e.g. a session's
        # background heartbeat thread) dial exactly what worked here —
        # the env address may differ (all-local runs rewrite to loopback)
        self.address = address
        # read-only connections (serving tier) never fence-bind and
        # refuse every mutating verb locally in _send_frame — the one
        # choke point both the scalar RPCs and the pipelined batches
        # pass through, so no command path can bypass the guard
        self.read_only = bool(read_only)
        # per-RPC telemetry spans (command + payload bytes) when the
        # plane is enabled; one attribute check per RPC when it is not
        self._tel = _telemetry.get()
        self._sock = socket.create_connection(address, timeout=timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._buf = b''
        self._rx_bytes = 0   # reply payload bytes read (rpc_batch spans)
        self._handshake()
        # per-operation timeout for the ESTABLISHED connection (the
        # connect `timeout` stays snappy for probes/handshake); the
        # timed waits below temporarily override and RESTORE it
        self._op_timeout = op_timeout if op_timeout is not None \
            else timeout
        self._sock.settimeout(self._op_timeout)

    def _read_reply_line(self):
        while b'\n' not in self._buf:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise OSError('coord_service closed connection')
            self._buf += chunk
        resp, self._buf = self._buf.split(b'\n', 1)
        return resp.decode()

    def _handshake(self):
        """Consume the service greeting; answer the nonce challenge when
        the service is token-protected (HELLO <nonce> -> AUTH
        hmac-sha256(token, nonce))."""
        greeting = self._read_reply_line()
        parts = greeting.split()
        if len(parts) != 2 or parts[0] != 'HELLO':
            # whatever is on this port, it is not a coord service
            raise OSError('unexpected greeting %r' % greeting[:64])
        if parts[1] == 'open':
            if coord_token():
                # no silent auth downgrade: a configured token means the
                # operator expects every endpoint authenticated — an
                # open listener here is a stale/spoofed service
                raise OSError(
                    'coord service at %s is UNAUTHENTICATED but an '
                    'AUTODIST_COORD_TOKEN is configured — refusing the '
                    'auth downgrade (stale or spoofed service?)'
                    % (self.address,))
            return
        token = coord_token()
        if not token:
            raise OSError(
                'coord service at %s requires authentication but no '
                'AUTODIST_COORD_TOKEN(_FILE) is configured'
                % (self.address,))
        mac = hmac_mod.new(token.encode(), parts[1].encode(),
                           hashlib.sha256).hexdigest()
        self._sock.sendall(('AUTH %s\n' % mac).encode())
        resp = self._read_reply_line()
        if resp != 'OK':
            raise OSError('coord service rejected auth: %s' % resp)

    def _send_frame(self, line, payload=None):
        """Write one request frame (header line + optional raw payload)
        WITHOUT reading its reply — the building block the pipelined
        multi-tensor calls (vmget/vmset/vmadd/vmsadd) write batches of.

        ``payload`` may be a LIST of buffers (scatter-gather framing:
        the sparse plane's ``int32 indices || row data`` payloads ship
        without a concat copy of the row bytes)."""
        if self.read_only:
            parts = line.split(None, 3)
            verb = parts[0] if parts else ''
            # INCR <key> 0 is the plane's counter READ (the server
            # fence-exempts delta 0 for the same reason); any other
            # blocked verb dies here, before it can reach the wire
            if verb in READ_ONLY_BLOCKED and not (
                    verb == 'INCR' and len(parts) > 2
                    and parts[2] == '0'):
                raise ReadOnlyViolation(
                    '%s refused: this connection is read-only (the '
                    'serving tier must never mutate the training '
                    'namespace or bind a writer generation)'
                    % line.split(None, 1)[0])
        hook = CoordClient.fault_hook
        if hook is not None:
            if isinstance(payload, (list, tuple)):
                # the hook contract is one flat buffer; hooks are
                # test-only (faultline), so the join copy is fine there
                payload = b''.join(bytes(b) for b in payload)
            replaced = hook(self, line, payload)
            if replaced is not None:
                line, payload = replaced
        header = line.encode() + b'\n'
        if isinstance(payload, (list, tuple)):
            bufs = [b for b in payload if len(b)]
            total = sum(len(b) for b in bufs)
            if total <= 65536:
                # small frame: one syscall/segment, like the scalar
                # path below — the common O(batch)-rows sparse push
                self._sock.sendall(
                    header + b''.join(bytes(b) for b in bufs))
            else:
                self._sock.sendall(header)
                for buf in bufs:
                    self._sock.sendall(buf)
            return
        if payload is not None and len(payload) > 65536:
            # large tensor frames: send header + payload separately to
            # avoid a whole-payload concat copy (TCP_NODELAY is set, and
            # the payload write follows immediately, so no Nagle stall)
            self._sock.sendall(header)
            self._sock.sendall(payload)
        elif payload is not None and len(payload):
            # payload may be a zero-copy memoryview (_encode f32 path)
            self._sock.sendall(header + bytes(payload))
        else:
            self._sock.sendall(header)

    @staticmethod
    def _payload_nbytes(payload):
        if payload is None:
            return 0
        if isinstance(payload, (list, tuple)):
            return sum(len(b) for b in payload)
        return len(payload)

    def _rpc(self, line, payload=None):
        """Send one request (header line + optional raw payload), read the
        reply header line."""
        if not self._tel.enabled:
            self._send_frame(line, payload)
            return self._read_reply_line()
        cmd = line.split(' ', 1)[0]
        # a command that waits at the service for a condition measures
        # the wait, not the link: it is no sample of the link's cost
        with self._tel.span('rpc_wait' if cmd in _WAIT_CMDS else 'rpc',
                            cmd=cmd, bytes=self._payload_nbytes(payload)):
            self._send_frame(line, payload)
            return self._read_reply_line()

    def _pipelined(self, frames, on_reply, window=32):
        """Write request ``frames`` (``(token, line, payload)``) ahead of
        reading replies, keeping at most ``window`` replies outstanding;
        ``on_reply(token)`` must consume exactly one reply from the
        socket. The service handles one request per connection at a time
        and replies in request order, so pipelining is safe; the window
        bounds how far the writer runs ahead so the two directions'
        socket buffers can never both fill (the classic pipelining
        deadlock)."""
        if self._tel.enabled:
            frames = list(frames)
            span = self._tel.span(
                'rpc_batch',
                cmd=frames[0][1].split(' ', 1)[0] if frames else '',
                frames=len(frames),
                bytes=sum(self._payload_nbytes(p)
                          for _, _, p in frames))
        else:
            span = _telemetry._NULL_SPAN
        rx0 = self._rx_bytes
        with span:
            outstanding = []
            for token, line, payload in frames:
                self._send_frame(line, payload)
                outstanding.append(token)
                if len(outstanding) >= window:
                    on_reply(outstanding.pop(0))
            while outstanding:
                on_reply(outstanding.pop(0))
            if span is not _telemetry._NULL_SPAN:
                # the replies' payloads were read inside the span: a
                # batched pull is a transfer of those bytes
                span.tags['bytes'] += self._rx_bytes - rx0

    def _read_exact(self, nbytes):
        """Read exactly ``nbytes`` of reply payload (after a VAL header)."""
        parts = []
        have = len(self._buf)
        if have:
            take = min(have, nbytes)
            parts.append(self._buf[:take])
            self._buf = self._buf[take:]
            nbytes -= take
        while nbytes:
            chunk = self._sock.recv(min(nbytes, 1 << 20))
            if not chunk:
                raise OSError('coord_service closed connection')
            if len(chunk) > nbytes:  # pragma: no cover - server never
                self._buf += chunk[nbytes:]  # pipelines replies
                chunk = chunk[:nbytes]
            parts.append(chunk)
            nbytes -= len(chunk)
        out = b''.join(parts)
        self._rx_bytes += len(out)
        return out

    # -- primitives --------------------------------------------------------
    def ping(self):
        resp = self._rpc('PING')
        if resp != 'PONG':
            # whatever is on this port, it is not a coord service
            raise OSError('unexpected PING reply %r' % resp[:64])

    def fence(self, key, gen):
        """Bind this connection as a generation-``gen`` writer of fence
        counter ``key``: once that counter advances past ``gen`` (this
        process was declared dead), every write on the connection is
        rejected with :class:`FencedWriteError`. Raises immediately if
        the generation is already superseded."""
        resp = _check_fenced(self._rpc('FENCE %s %d' % (key, gen)),
                             'fence(%s, %d)' % (key, gen))
        if resp != 'OK':
            raise OSError('FENCE %s failed: %s' % (key, resp))

    def set(self, key, value):
        resp = _check_fenced(self._rpc('SET %s %s' % (key, value)),
                             'set(%s)' % key)
        assert resp == 'OK'

    def get(self, key):
        resp = self._rpc('GET %s' % key)
        return None if resp == 'NONE' else resp[4:]

    def delete(self, key):
        _check_fenced(self._rpc('DEL %s' % key), 'delete(%s)' % key)

    def incr(self, key, delta=1):
        resp = _check_fenced(self._rpc('INCR %s %d' % (key, delta)),
                             'incr(%s)' % key)
        return int(resp[4:])

    def _timed_rpc(self, line, timeout_s):
        """RPC under a wait-specific socket timeout, RESTORING the
        client's op timeout after — a gate's short slice must not
        clobber the generous data-plane timeout for the next multi-MB
        pull on the same socket."""
        self._sock.settimeout(timeout_s + 5.0)
        try:
            return self._rpc(line)
        finally:
            self._sock.settimeout(self._op_timeout)

    def wait_ge(self, key, n, timeout_s=60.0):
        resp = self._timed_rpc('WAITGE %s %d %d'
                               % (key, n, int(timeout_s * 1000)),
                               timeout_s)
        if resp == 'TIMEOUT':
            raise TimeoutError('wait_ge(%s, %d)' % (key, n))
        return int(resp[4:])

    def min_wait(self, prefix, n, k, timeout_s=60.0):
        resp = self._timed_rpc('MINWAIT %s %d %d %d'
                               % (prefix, n, k, int(timeout_s * 1000)),
                               timeout_s)
        if resp == 'TIMEOUT':
            raise TimeoutError('min_wait(%s, %d)' % (prefix, n))
        return int(resp[4:])

    def barrier(self, name, parties, timeout_s=60.0):
        resp = self._timed_rpc('BARRIER %s %d %d'
                               % (name, parties, int(timeout_s * 1000)),
                               timeout_s)
        if resp == 'TIMEOUT':
            raise TimeoutError('barrier(%s, %d)' % (name, parties))

    def shutdown(self):
        try:
            self._rpc('SHUTDOWN')
        except OSError:
            pass

    # -- tensor data plane (PS accumulator equivalent) ---------------------
    @staticmethod
    def _chunk_elems(wire):
        """Elements per frame chunk (AUTODIST_PS_CHUNK_BYTES of wire
        bytes); 0 disables chunking."""
        return _chunk_elems(wire)

    def _ranges(self, n_elems, wire):
        """Chunk ranges [(off, count)] covering ``n_elems``; a single
        (0, n) range means 'send unranged' (whole-tensor frame)."""
        return _chunk_ranges(n_elems, wire)

    def _set_frames(self, key, value, wire):
        """The BSET frame sequence for one tensor (chunked like vset)."""
        # _as_f32_flat skips the copy the old
        # ascontiguousarray(asarray(...)) pair paid even on
        # already-conforming input — the common session hot path
        flat = _as_f32_flat(value)
        ranges = self._ranges(flat.size, wire)
        for off, count in ranges:
            payload = _encode(flat[off:off + count], wire)
            suffix = '' if len(ranges) == 1 else \
                ' %d %d' % (off, flat.size)
            yield (key, 'BSET %s %d %s%s'
                   % (key, len(payload), wire, suffix), payload)

    def vset(self, key, value, wire=None):
        """Store a tensor (authoritative PS copy). Stored f32; wire dtype
        per ``AUTODIST_PS_WIRE_DTYPE``; frames above the chunk limit move
        as ranged chunks (elementwise, so chunked application is exact)."""
        self.vmset([(key, value)], wire=wire)

    def vmset(self, items, wire=None):
        """Pipelined multi-tensor :meth:`vset`: every (key, value) in
        ``items`` is stored with vset's exact chunking, but all request
        frames are written ahead of draining the replies — one wire
        round trip for the whole batch instead of one per chunk.

        Stores are AUTHORITATIVE state, so an ``i8`` wire setting
        rides f32 here (:func:`_pull_wire`): quantizing at-rest values
        would corrupt them permanently, with no error-feedback residual
        to absorb it."""
        wire = _pull_wire(wire)
        frames = [f for key, value in items
                  for f in self._set_frames(key, value, wire)]
        errs = []

        def reply(key):
            resp = self._read_reply_line()
            if resp != 'OK':
                errs.append('BSET %s failed: %s' % (key, resp))

        self._pipelined(frames, reply)
        if errs:
            _raise_batch(errs)

    def vget(self, key, shape=None, dtype=np.float32, wire=None):
        """Fetch a tensor as float32 host array, or None if absent.
        With a known ``shape``, oversized tensors are pulled as ranged
        chunks. Single-key form of :meth:`vmget` (one torn-read
        implementation serves both)."""
        return self.vmget([(key, shape)], dtype=dtype, wire=wire)[0]

    def vmget(self, specs, dtype=np.float32, wire=None):
        """Pipelined multi-tensor fetch: ``specs`` is ``[(key, shape)]``;
        returns one float32 array (or None if absent) per spec. ALL
        chunk requests for every pending key are written ahead of
        draining the replies, so a pull of K keys x C chunks pays one
        wire round trip instead of K*C.

        Torn-read safe (ADVICE r4): every BGET opts into the server's
        version field ("v" flag → ``version*2 + write_in_progress``).
        An odd value means a chunked write is mid-flight; a value that
        moves between one key's chunks means a push landed between
        them. Either way that key's pull retries (only torn keys
        re-request). Old servers without the field degrade to the
        previous (unchecked) behavior.

        Retry policy: while a key's version ADVANCES between attempts
        the writer is alive and making progress (a multi-GB chunked
        push legitimately holds the flag for seconds) — keep waiting,
        up to a configurable cap (AUTODIST_PS_TORN_RETRIES /
        AUTODIST_PS_TORN_BACKOFF_S).  The version only moves when a
        whole chunk frame lands, and one frame can take
        AUTODIST_PS_CHUNK_BYTES of wire time, so "stalled" is judged
        on a wall-clock window (``stall_timeout_s``), not an attempt
        count: a version that stays odd AND unchanged that long is
        the dead-mid-push signature.

        Exhausting the cap is only an ERROR when parity is odd (a
        write is genuinely mid-chunk: returning would hand back a
        half-applied tensor). An even version that merely keeps
        MOVING between one key's chunks means whole pushes keep
        landing — element-level staleness, the same benign mix any
        reader of a concurrently-updated accumulator sees — so the
        final assembly is returned with a warning instead of killing
        a healthy worker under frequent pushes. Caveat: each chunk of
        the assembly comes from a COMPLETE push, but different chunks
        may come from consecutive pushes — fine for commutative BADD
        accumulation and for fetch-side staleness, but a reader that
        needs one specific BSET snapshot must quiesce writers (the
        staleness gate) rather than rely on this path.

        Pulls are the READ direction: an ``i8`` wire setting rides f32
        here (:func:`_pull_wire`) — only pushes quantize, under the
        session's error-feedback residual."""
        wire = _pull_wire(wire)
        specs = list(specs)
        n_elems = [int(np.prod(shp)) if shp is not None else None
                   for _, shp in specs]
        ranges = [self._ranges(n, wire) if n else [(0, None)]
                  for n in n_elems]
        results = [None] * len(specs)
        max_attempts = max(1, ENV.AUTODIST_PS_TORN_RETRIES.val)
        backoff = ENV.AUTODIST_PS_TORN_BACKOFF_S.val
        stall_s = self.stall_timeout_s
        last_ver = {}         # idx -> last version seen while torn
        last_progress = {}    # idx -> local time the version last moved
        pending = list(range(len(specs)))
        for attempt in range(max_attempts):
            final = attempt == max_attempts - 1
            frames = []
            for idx in pending:
                key = specs[idx][0]
                for off, count in ranges[idx]:
                    suffix = '' if len(ranges[idx]) == 1 and off == 0 \
                        and (count is None or count == n_elems[idx]) \
                        else ' %d %d' % (off, count)
                    frames.append((idx, 'BGET %s %s%s v'
                                   % (key, wire, suffix), None))
            parts = {idx: [] for idx in pending}
            first_ver = {}
            cur_ver = {}
            odd = set()
            torn = set()
            absent = set()
            errors = []

            def reply(idx):
                resp = self._read_reply_line()
                if resp == 'NONE':
                    absent.add(idx)
                    return
                if not resp.startswith('VAL'):
                    # keep draining the remaining replies (the stream
                    # stays framed); raise once the batch is consumed
                    errors.append('BGET %s failed: %s'
                                  % (specs[idx][0], resp))
                    return
                fields = resp.split()
                parts[idx].append(
                    _decode(self._read_exact(int(fields[1])), wire))
                ver = int(fields[2]) if len(fields) > 2 else None
                if ver is None:
                    return
                cur_ver[idx] = ver
                if ver & 1:  # write in progress
                    odd.add(idx)
                    torn.add(idx)
                elif idx not in first_ver:
                    first_ver[idx] = ver
                elif ver != first_ver[idx]:
                    torn.add(idx)

            self._pipelined(frames, reply)
            if errors:
                raise OSError('; '.join(errors))
            now = time.monotonic()
            retry = []
            for idx in pending:
                key, shape = specs[idx]
                if idx in absent:
                    results[idx] = None
                    continue
                if idx not in torn or (final and idx not in odd):
                    if idx in torn:
                        logging.warning(
                            'BGET %s: version kept advancing for %d '
                            'attempts (concurrent single-frame pushes);'
                            ' returning the last assembly — '
                            'element-level staleness only, parity was '
                            'even throughout the final pass',
                            key, max_attempts)
                    arr = parts[idx][0] if len(parts[idx]) == 1 else \
                        np.concatenate(parts[idx])
                    if shape is not None:
                        arr = arr.reshape(shape)
                    results[idx] = arr.astype(dtype, copy=False)
                    continue
                ver = cur_ver.get(idx)
                if ver != last_ver.get(idx):
                    last_ver[idx] = ver
                    last_progress[idx] = now
                elif idx in odd and \
                        now - last_progress.get(idx, now) > stall_s:
                    raise OSError(
                        'BGET %s: a chunked write is stuck mid-flight '
                        '(version parity odd and not advancing for '
                        '%.0fs) — a peer likely died mid-push'
                        % (key, stall_s))
                retry.append(idx)
            pending = retry
            if not pending:
                return results
            # linear backoff from the configured base, capped at the
            # larger of 0.2s and one base interval (a base above 0.2
            # must not be silently clamped back to the old cap)
            time.sleep(min(max(0.2, backoff), backoff * (attempt + 1)))
        raise OSError(
            'BGET %s: a chunked write was still mid-flight (version '
            'parity odd) after %d attempts — raising rather than '
            'returning a half-applied tensor'
            % (specs[pending[0]][0], max_attempts))

    def vadd(self, key, delta, wire=None):
        """Atomically add a delta elementwise (apply-per-push, the
        reference's staleness-mode ConditionalAccumulator semantics,
        ps_synchronizer.py:556-633 with num_required=1). Returns the
        tensor's total push count. Addition commutes, so chunked pushes
        from concurrent workers interleave exactly."""
        return self.vmadd([(key, delta)], wire=wire)[key]

    def vmadd(self, items, wire=None):
        """Pipelined multi-tensor :meth:`vadd`: every (key, delta) in
        ``items`` is accumulated with vadd's exact chunking, all request
        frames written ahead of draining the replies. Returns
        ``{key: push count}``."""
        wire = _wire_dtype(wire)
        frames = []
        for key, delta in items:
            flat = _as_f32_flat(delta)
            ranges = self._ranges(flat.size, wire)
            for off, count in ranges:
                payload = _encode(flat[off:off + count], wire)
                suffix = '' if len(ranges) == 1 else \
                    ' %d %d' % (off, flat.size)
                frames.append((key, 'BADD %s %d %s%s'
                               % (key, len(payload), wire, suffix),
                               payload))
        pushes = {}
        errs = []

        def reply(key):
            resp = self._read_reply_line()
            if not resp.startswith('VAL'):
                errs.append('BADD %s failed: %s' % (key, resp))
                return
            pushes[key] = int(resp[4:])

        self._pipelined(frames, reply)
        if errs:
            _raise_batch(errs)
        return pushes

    # -- row-sparse tensor plane (embedding variables) ---------------------
    @staticmethod
    def _wire_itemsize(wire):
        return _wire_itemsize(wire)

    def _row_chunks(self, nrows, bytes_per_row):
        """Row-chunk ranges [(off, count)] so no frame exceeds
        ``AUTODIST_PS_CHUNK_BYTES`` of wire bytes (indices + row data
        for pushes, row data for row fetches)."""
        return _row_chunk_ranges(nrows, bytes_per_row)

    def _sadd_frames(self, key, indices, rows, wire):
        """The BSADD frame sequence for one row-sparse push (chunked
        over ROWS like vset chunks over elements).

        f32/bf16 declare the per-row wire bytes; i8 blockscale blobs
        are not per-row divisible (the scales header spans the chunk),
        so those frames declare the TOTAL blob length instead and the
        service derives cols from decoded elements / nrows — the
        protocol note in coord_service.cc's header."""
        idx = np.asarray(indices, dtype=np.int32).reshape(-1)
        if not idx.flags.c_contiguous:
            idx = np.ascontiguousarray(idx)
        rows = np.asarray(rows, dtype=np.float32)
        if rows.ndim != 2 or rows.shape[0] != idx.size:
            raise ValueError(
                'vsadd(%s): rows must be [len(indices), cols]; got '
                'indices %d, rows %r' % (key, idx.size, rows.shape))
        row_wire = rows.shape[1] * self._wire_itemsize(wire)
        ranges = self._row_chunks(idx.size, 4 + row_wire)
        for off, count in ranges:
            suffix = '' if len(ranges) == 1 else \
                ' %d %d' % (off, idx.size)
            # scatter-gather payload: int32 indices then the row data,
            # no concat copy of the rows (the f32 path is a memoryview)
            blob = _encode(rows[off:off + count], wire)
            declared = len(blob) if wire == 'i8' else row_wire
            payload = [memoryview(idx[off:off + count]).cast('B'), blob]
            yield (key, 'BSADD %s %d %d %s%s'
                   % (key, count, declared, wire, suffix), payload)

    def vsadd(self, key, indices, rows, wire=None):
        """Row-sparse scatter-add: ``rows[r]`` is added into row
        ``indices[r]`` of the stored ``[table_rows, cols]`` tensor.
        Addition commutes, so sparse and dense pushes from concurrent
        workers interleave exactly; a delta whose untouched rows are
        exactly zero is applied LOSSLESSLY by shipping only its touched
        rows. The tensor must already exist (a row set cannot size it).
        Returns the tensor's total push count."""
        return self.vmsadd([(key, indices, rows)], wire=wire)[key]

    def vmsadd(self, items, wire=None):
        """Pipelined multi-tensor :meth:`vsadd`: ``items`` is
        ``[(key, indices, rows)]``; all request frames are written
        ahead of draining replies, one wire round trip for the batch.
        Returns ``{key: push count}``."""
        wire = _wire_dtype(wire)
        frames = [f for key, idx, rows in items
                  for f in self._sadd_frames(key, idx, rows, wire)]
        pushes = {}
        errs = []

        def reply(key):
            resp = self._read_reply_line()
            if not resp.startswith('VAL'):
                errs.append('BSADD %s failed: %s' % (key, resp))
                return
            pushes[key] = int(resp[4:])

        self._pipelined(frames, reply)
        if errs:
            _raise_batch(errs)
        return pushes

    def vgetrows(self, key, indices, ncols, wire=None):
        """Fetch just the listed rows of a stored ``[rows, ncols]``
        tensor as a float32 ``[len(indices), ncols]`` array, or None if
        the tensor is absent. Single-key form of :meth:`vmgetrows`."""
        return self.vmgetrows([(key, indices, ncols)], wire=wire)[0]

    def vmgetrows(self, specs, dtype=np.float32, wire=None):
        """Pipelined multi-tensor row fetch: ``specs`` is ``[(key,
        indices, ncols)]``; returns one ``[len(indices), ncols]`` array
        (or None if absent) per spec.

        Torn-read contract (the BGET "v" semantics, scaled down to row
        reads): every request opts into the version field; a key whose
        parity comes back odd — or whose version moves between its own
        row chunks — retries under the same AUTODIST_PS_TORN_RETRIES /
        _BACKOFF_S budget as :meth:`vmget`, with the same stall window:
        odd parity that stops advancing for ``stall_timeout_s`` is the
        died-mid-push signature and raises. A version that keeps
        MOVING but stays even means whole pushes keep landing — the
        final assembly is returned (benign element-level staleness,
        same caveat as vmget's). Reads ride f32 under an ``i8``
        setting, like :meth:`vmget`."""
        wire = _pull_wire(wire)
        specs = [(key, np.ascontiguousarray(
                     np.asarray(idx, dtype=np.int32).reshape(-1)),
                  int(ncols)) for key, idx, ncols in specs]
        row_wire = [ncols * self._wire_itemsize(wire)
                    for _, _, ncols in specs]
        results = [None] * len(specs)
        max_attempts = max(1, ENV.AUTODIST_PS_TORN_RETRIES.val)
        backoff = ENV.AUTODIST_PS_TORN_BACKOFF_S.val
        stall_s = self.stall_timeout_s
        last_ver = {}
        last_progress = {}
        pending = list(range(len(specs)))
        for attempt in range(max_attempts):
            final = attempt == max_attempts - 1
            frames = []
            for i in pending:
                key, idx, ncols = specs[i]
                for off, count in self._row_chunks(
                        idx.size, max(1, row_wire[i])):
                    frames.append(
                        (i, 'BGETROWS %s %d %d %s v'
                         % (key, count, ncols, wire),
                         memoryview(idx[off:off + count]).cast('B')))
            parts = {i: [] for i in pending}
            first_ver = {}
            cur_ver = {}
            odd = set()
            torn = set()
            absent = set()
            errors = []

            def reply(i):
                resp = self._read_reply_line()
                if resp == 'NONE':
                    absent.add(i)
                    return
                if not resp.startswith('VAL'):
                    errors.append('BGETROWS %s failed: %s'
                                  % (specs[i][0], resp))
                    return
                fields = resp.split()
                parts[i].append(
                    _decode(self._read_exact(int(fields[1])), wire))
                ver = int(fields[2]) if len(fields) > 2 else None
                if ver is None:
                    return
                cur_ver[i] = ver
                if ver & 1:
                    odd.add(i)
                    torn.add(i)
                elif i not in first_ver:
                    first_ver[i] = ver
                elif ver != first_ver[i]:
                    torn.add(i)

            self._pipelined(frames, reply)
            if errors:
                raise OSError('; '.join(errors))
            now = time.monotonic()
            retry = []
            for i in pending:
                key, idx, ncols = specs[i]
                if i in absent:
                    results[i] = None
                    continue
                if i not in torn or (final and i not in odd):
                    if i in torn:
                        logging.warning(
                            'BGETROWS %s: version kept advancing for '
                            '%d attempts (concurrent pushes); '
                            'returning the last assembly', key,
                            max_attempts)
                    arr = np.concatenate(parts[i]) if len(parts[i]) > 1 \
                        else parts[i][0]
                    results[i] = arr.reshape(idx.size, ncols).astype(
                        dtype, copy=False)
                    continue
                ver = cur_ver.get(i)
                if ver != last_ver.get(i):
                    last_ver[i] = ver
                    last_progress[i] = now
                elif i in odd and \
                        now - last_progress.get(i, now) > stall_s:
                    raise OSError(
                        'BGETROWS %s: a chunked write is stuck '
                        'mid-flight (version parity odd and not '
                        'advancing for %.0fs) — a peer likely died '
                        'mid-push' % (key, stall_s))
                retry.append(i)
            pending = retry
            if not pending:
                return results
            time.sleep(min(max(0.2, backoff), backoff * (attempt + 1)))
        raise OSError(
            'BGETROWS %s: a chunked write was still mid-flight '
            '(version parity odd) after %d attempts'
            % (specs[pending[0]][0], max_attempts))

    def vstep(self, key, grad, rule, params, wire=None):
        """Push a raw GRADIENT; the service applies the named update
        rule with PS-resident slots shared by all workers (the
        reference re-creates the user's optimizer over PS-resident
        variables, partitioner.py:570-573 / ps_synchronizer.py:175-176).

        ``rule`` is one of ``sgd`` (params [lr, momentum]), ``adam``
        ([lr, b1, b2, eps]), ``adagrad`` ([lr, eps, init_acc]). Returns
        the shared step index used (the adam bias-correction t). Chunked
        pushes share one t: the offset-0 chunk draws it, later chunks
        pass it explicitly — every rule is elementwise in (w, slots), so
        ranged application is exact."""
        wire = _wire_dtype(wire)
        flat = _as_f32_flat(grad)
        p = (list(params) + [0.0] * 4)[:4]
        ranges = self._ranges(flat.size, wire)
        step = 0
        for off, count in ranges:
            payload = _encode(flat[off:off + count], wire)
            suffix = '' if len(ranges) == 1 else \
                ' %d %d' % (off, flat.size)
            resp = _check_fenced(self._rpc(
                'BSTEP %s %d %s %s %d %.17g %.17g %.17g %.17g%s'
                % (key, len(payload), wire, rule, step,
                   p[0], p[1], p[2], p[3], suffix), payload),
                'vstep(%s)' % key)
            if not resp.startswith('VAL'):
                raise OSError('BSTEP %s failed: %s' % (key, resp))
            step = int(resp[4:])
        return step

    def vstat(self, key):
        """Tensor introspection: ``{'pushes', 'steps', 'elems',
        'slot1', 'slot2'}`` or None if absent — verifies PS-resident
        optimizer state (e.g. shared adam: steps == total pushes)."""
        resp = self._rpc('BSTAT %s' % key)
        if resp == 'NONE':
            return None
        if not resp.startswith('VAL'):
            raise OSError('BSTAT %s failed: %s' % (key, resp))
        p, s, n, s1, s2 = resp[4:].split()
        return {'pushes': int(p), 'steps': int(s), 'elems': int(n),
                'slot1': bool(int(s1)), 'slot2': bool(int(s2))}

    def delete_namespace(self, prefix):
        """Purge every key/counter/tensor/barrier under ``prefix`` —
        run-end cleanup so a long-lived endpoint daemon does not
        accumulate dead runs' tensors. Returns the entry count purged."""
        resp = _check_fenced(self._rpc('DELNS %s' % prefix),
                             'delete_namespace(%s)' % prefix)
        if not resp.startswith('VAL'):
            raise OSError('DELNS %s failed: %s' % (prefix, resp))
        return int(resp[4:])

    def wait_key(self, key, timeout_s=60.0, poll_s=0.05):
        """Poll-wait for a KV key to appear; returns its value."""
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            v = self.get(key)
            if v is not None:
                return v
            time.sleep(poll_s)
        raise TimeoutError('wait_key(%s)' % key)

    def close(self):
        self._sock.close()

    # -- composite: bounded staleness -------------------------------------
    # A step publish landing at/above CLEAN_CLOSE_STEP is a RELEASE, not
    # training progress: Session.close and the exclude-policy claim
    # winner publish it to lift any reachable gate bound on a departed
    # worker's counter (faultline's kill_worker matcher must never treat
    # it as the worker reaching its death step).
    def publish_step(self, worker, step, prefix='step/'):
        """Publish this worker's completed-step counter."""
        key = prefix + worker
        cur = self.incr(key, 0)
        if step > cur:
            self.incr(key, step - cur)

    def staleness_gate(self, step, staleness, num_workers,
                       timeout_s=600.0, prefix='step/',
                       failure_check=None, slice_s=2.0):
        """Block until every worker is within ``staleness`` steps.

        With ``failure_check`` (a callable that raises when a peer is
        known dead), the server-side wait is chunked into ``slice_s``
        slices and the check runs between slices — a crashed peer
        surfaces as its error instead of a full-window TimeoutError.
        A TRUTHY return from ``failure_check`` means a recovery is in
        flight (peer-failure policy ``restart``): the deadline re-arms
        so supervision time is not counted against the gate window —
        the caller bounds that wait itself (failed markers raise;
        ``AUTODIST_RESTART_WAIT_S`` caps a silent supervisor).

        ``num_workers`` may be a callable, re-evaluated every slice:
        elastic membership (peer-failure policy ``exclude``) shrinks
        the party count while a survivor is already blocked here, and
        the gate must re-bound against the NEW membership instead of
        waiting forever for a step key the excluder deleted.
        """
        if step <= staleness:
            return
        k = num_workers() if callable(num_workers) else num_workers
        if failure_check is None:
            self.min_wait(prefix, step - staleness, k, timeout_s)
            return
        deadline = time.time() + timeout_s
        while True:
            if failure_check():
                deadline = time.time() + timeout_s
            k = num_workers() if callable(num_workers) else num_workers
            remaining = deadline - time.time()
            if remaining <= 0:
                raise TimeoutError('staleness_gate(%s, %d)'
                                   % (prefix, step))
            try:
                self.min_wait(prefix, step - staleness, k,
                              min(slice_s, remaining))
                return
            except TimeoutError:
                continue

    # -- composite: heartbeat / failure detection --------------------------
    # Liveness is a monotonic BEAT COUNTER, not a timestamp: each consumer
    # judges "no advance for > timeout" against its OWN clock, so
    # wall-clock skew between hosts can neither kill healthy peers nor
    # mask dead ones.
    def heartbeat(self, worker):
        self.incr('hb/%s' % worker, 1)

    def beat_count(self, worker):
        """Current beat counter for ``worker`` (0 = never beat)."""
        return self.incr('hb/%s' % worker, 0)

    def dead_workers(self, workers, timeout_s, observations,
                     now=None):
        """Workers whose beat counter has not advanced for ``timeout_s``
        on THIS process's clock. ``observations`` is caller-owned state
        {worker: (last_count, local_time_first_seen)} updated in place."""
        now = time.time() if now is None else now
        dead = []
        for w in workers:
            cnt = self.beat_count(w)
            last = observations.get(w)
            if last is None or cnt != last[0]:
                observations[w] = (cnt, now)
                continue
            if now - last[1] > timeout_s:
                dead.append(w)
        return dead


class TransferJob:
    """Future-like handle for one :class:`TransferPool` job."""

    def __init__(self, fn, endpoint):
        self.fn = fn
        self.endpoint = endpoint
        self._done = threading.Event()
        self._value = None
        self._exc = None

    def set_result(self, value):
        self._value = value
        self._done.set()

    def set_error(self, exc):
        self._exc = exc
        self._done.set()

    def done(self):
        return self._done.is_set()

    def result(self, timeout=None):
        """Join the job; re-raises the job's exception if it failed."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                'PS transfer on endpoint %d did not finish within %ss'
                % (self.endpoint, timeout))
        if self._exc is not None:
            raise self._exc
        return self._value


class TransferPool:
    """Persistent per-endpoint transfer workers for the loose-mode PS
    data plane.

    One daemon thread per endpoint, each owning its OWN connection
    (CoordClient sockets are not thread-safe, and a dedicated
    connection keeps the session's control-plane client free for
    gates/heartbeats while transfers run in the background). Jobs
    submitted to one endpoint run strictly in FIFO order — which is
    what makes a pull queued behind the same variable's push
    read-your-writes safe for free — while distinct endpoints run
    concurrently, like the reference's concurrent grpc channels.
    Replaces the per-call ``threading.Thread`` spawn the session used
    to pay on every pull/push.

    Workers connect lazily on their first job and reconnect on the
    next job after a connection-level failure (the failed job carries
    the error to its joiner).
    """

    def __init__(self, connects):
        """``connects``: one zero-arg client factory per endpoint."""
        self._connects = list(connects)
        self._queues = [queue.Queue() for _ in self._connects]
        self._threads = [None] * len(self._connects)
        self._closed = False

    def __len__(self):
        return len(self._connects)

    def _worker(self, ep):
        q = self._queues[ep]
        client = None
        while True:
            job = q.get()
            if job is None:
                break
            try:
                if client is None:
                    client = self._connects[ep]()
                job.set_result(job.fn(client))
            except BaseException as e:  # noqa: BLE001 - carried to joiner
                if isinstance(e, OSError) and client is not None:
                    # connection-level failure: drop the socket so the
                    # next job reconnects instead of reusing a dead or
                    # unframed stream
                    try:
                        client.close()
                    except OSError:
                        pass
                    client = None
                job.set_error(e)
        if client is not None:
            try:
                client.close()
            except OSError:
                pass

    def submit(self, ep, fn):
        """Queue ``fn(client)`` on endpoint ``ep``'s worker; returns a
        :class:`TransferJob` to join."""
        if self._closed:
            # the workers have drained their sentinels and exited; a
            # queued job would never run and its joiner would hang
            raise OSError('TransferPool is closed')
        if self._threads[ep] is None:
            t = threading.Thread(target=self._worker, args=(ep,),
                                 daemon=True,
                                 name='autodist-ps-xfer-%d' % ep)
            self._threads[ep] = t
            t.start()
        job = TransferJob(fn, ep)
        self._queues[ep].put(job)
        return job

    def run(self, jobs):
        """Submit ``[(endpoint, fn)]`` and join them all.

        Every failure is logged WITH its endpoint before anything is
        raised; a single failure re-raises as itself (type-preserving
        for callers matching OSError), several raise one aggregate
        RuntimeError naming every endpoint — no endpoint's error is
        silently dropped. Returns the per-job results in order."""
        handles = [self.submit(ep, fn) for ep, fn in jobs]
        results = []
        errs = []
        for h in handles:
            try:
                results.append(h.result())
            # BaseException too (workers capture it): SystemExit from a
            # job must not unwind this loop before every handle is
            # joined and logged — that would drop the others' errors
            except BaseException as e:  # noqa: BLE001 - aggregated below
                logging.error('PS transfer failed on endpoint %d: %s: %s',
                              h.endpoint, type(e).__name__, e)
                errs.append((h.endpoint, e))
        # a non-Exception (KeyboardInterrupt/SystemExit) outranks any
        # aggregate: re-raise it as itself once everything is joined
        for _, e in errs:
            if not isinstance(e, Exception):
                raise e
        if len(errs) == 1:
            raise errs[0][1]
        if errs:
            raise RuntimeError(
                'PS transfer failed on %d endpoints: %s'
                % (len(errs),
                   '; '.join('endpoint %d: %s: %s'
                             % (ep, type(e).__name__, e)
                             for ep, e in errs)))
        return results

    def close(self, timeout=15.0):
        """Stop every worker (drains each queue first) and close their
        connections. Subsequent :meth:`submit` raises OSError."""
        self._closed = True
        for q, t in zip(self._queues, self._threads):
            if t is not None:
                q.put(None)
        for t in self._threads:
            if t is not None:
                t.join(timeout=timeout)
