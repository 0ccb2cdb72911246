"""Python face of the native data loader (``native/dataloader.cc``).

The counterpart of ``autodist_tpu/data/loader.py``, with the same
record format, C ABI, shuffling, sharding and epoch count, so both
packages read the same files into the same batches. Fixed-size binary
records (the ADTR1 format: an 8-byte magic, then the record size and
the record count as little-endian int64, then the records) become numpy
batches, prefetched by a native reader thread so host IO overlaps
device steps. Per-host sharding (``shard_id`` / ``num_shards``): record
i belongs to shard ``i % num_shards``.

``native=None`` (the default) builds and uses the C++ reader and falls
back, with a logged warning, to a Python reader of the same order where
g++ is missing; ``native=True`` raises instead; ``native=False`` reads
in Python.
"""
import ctypes
import os
import struct
import subprocess

import numpy as np

from autodist_tpu_torch.utils import logging

MAGIC = b'ADTR1\x00\x00\x00'
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from autodist_tpu_torch.native_build import build
        lib = ctypes.CDLL(build('dataloader.cc', shared=True))
        lib.adl_create.restype = ctypes.c_void_p
        lib.adl_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64]
        lib.adl_next.restype = ctypes.c_int64
        lib.adl_next.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.adl_epoch.restype = ctypes.c_int64
        lib.adl_epoch.argtypes = [ctypes.c_void_p]
        lib.adl_destroy.restype = None
        lib.adl_destroy.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


def write_records(path, array):
    """Write a [num_records, ...] array as an ADTR1 record file."""
    array = np.ascontiguousarray(array)
    record_size = array.nbytes // array.shape[0]
    with open(path, 'wb') as f:
        f.write(MAGIC)
        f.write(struct.pack('<qq', record_size, array.shape[0]))
        f.write(array.tobytes())
    return path


def read_record_header(path):
    """(record size in bytes, record count) of an ADTR1 file."""
    with open(path, 'rb') as f:
        magic = f.read(8)
        if magic != MAGIC:
            raise ValueError('%s is not an ADTR1 record file' % path)
        record_size, num_records = struct.unpack('<qq', f.read(16))
    return record_size, num_records


class DataLoader:
    """Iterate batches of records as numpy arrays.

    Args:
        files: record files (all with the same record layout).
        batch_records: records per emitted batch.
        record_shape / record_dtype: logical layout of one record.
        shuffle / seed: deterministic shuffling per epoch.
        shard_id / num_shards: host-sharded loading.
        queue_cap: batches the native reader keeps ready.
        native: True: the C++ reader or raise; False: the Python
            reader; None (default): the C++ reader, else the Python one
            with a logged warning.
    """

    def __init__(self, files, batch_records, record_shape, record_dtype,
                 shuffle=True, seed=0, shard_id=0, num_shards=1,
                 queue_cap=4, native=None):
        self.files = [os.fspath(f) for f in files]
        self.batch_records = int(batch_records)
        self.record_shape = tuple(record_shape)
        self.record_dtype = np.dtype(record_dtype)
        self.record_size = int(np.prod(self.record_shape) *
                               self.record_dtype.itemsize)
        for f in self.files:
            rec, _ = read_record_header(f)
            if rec != self.record_size:
                raise ValueError('record size mismatch in %s: %d != %d'
                                 % (f, rec, self.record_size))
        self._handle = None
        self._py_state = None
        if native is not False:
            try:
                lib = _lib()
                arr = (ctypes.c_char_p * len(self.files))(
                    *[f.encode() for f in self.files])
                self._handle = lib.adl_create(
                    arr, len(self.files), self.record_size,
                    self.batch_records, 1, seed, int(bool(shuffle)),
                    shard_id, num_shards, queue_cap)
                if not self._handle:
                    raise RuntimeError('adl_create failed (bad files?)')
            except (OSError, RuntimeError,
                    subprocess.CalledProcessError) as e:
                if native:
                    raise
                logging.warning('Native loader unavailable (%s); '
                                'using the Python reader', e)
        if self._handle is None:
            self._init_python(shuffle, seed, shard_id, num_shards)

    # -- the Python reader --------------------------------------------------
    def _init_python(self, shuffle, seed, shard_id, num_shards):
        records = []
        for f in self.files:
            _, n = read_record_header(f)
            data = np.fromfile(f, dtype=np.uint8, offset=24)
            records.append(data.reshape(n, self.record_size))
        all_records = np.concatenate(records, axis=0)
        mask = np.arange(all_records.shape[0]) % num_shards == shard_id
        self._py_records = all_records[mask]
        self._py_state = {'rng': np.random.RandomState(seed),
                          'order': None, 'pos': 0, 'epoch': 0,
                          'shuffle': shuffle}

    def _py_next(self):
        st = self._py_state
        n = self._py_records.shape[0]
        out = np.empty((self.batch_records, self.record_size), np.uint8)
        for b in range(self.batch_records):
            if st['order'] is None or st['pos'] == n:
                st['order'] = (st['rng'].permutation(n) if st['shuffle']
                               else np.arange(n))
                if st['pos'] == n:
                    st['epoch'] += 1
                st['pos'] = 0
            out[b] = self._py_records[st['order'][st['pos']]]
            st['pos'] += 1
        return out

    # -- API ----------------------------------------------------------------
    def next_batch(self):
        """[batch_records, *record_shape] array of record_dtype."""
        if self._handle is not None:
            buf = ctypes.create_string_buffer(
                self.batch_records * self.record_size)
            if _lib().adl_next(self._handle, buf) < 0:
                raise RuntimeError('native loader read error')
            raw = np.frombuffer(buf, dtype=np.uint8)
        else:
            raw = self._py_next().reshape(-1)
        return raw.view(self.record_dtype).reshape(
            (self.batch_records,) + self.record_shape).copy()

    @property
    def epoch(self):
        if self._handle is not None:
            return int(_lib().adl_epoch(self._handle))
        return self._py_state['epoch']

    def __iter__(self):
        while True:
            yield self.next_batch()

    def close(self):
        """Stop the reader thread and free it; safe to call twice."""
        if self._handle is not None:
            _lib().adl_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
