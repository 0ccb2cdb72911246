"""The port's record loader (``data/loader.py`` over
``native/dataloader.cc``) against the JAX package's, on the CPU.

Mirrors ``tests/test_native.py``'s loader cases (native against Python,
sharding, seeded shuffle) and adds: the two packages' ``DataLoader``s
yield identical batches on the same files, seed and shard, with shuffle
on and off and native on and off; the epoch counts agree; and the C++
source is a byte-identical copy of the JAX package's. Record bytes are
compared exactly.
"""
import os

import numpy as np
import pytest

from autodist_tpu.data.loader import DataLoader as JDataLoader
from autodist_tpu.data.loader import write_records as jwrite_records
from autodist_tpu_torch import native_build
from autodist_tpu_torch.data.loader import (DataLoader, read_record_header,
                                            write_records)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dataloader_source_is_the_jax_copy():
    with open(os.path.join(REPO, 'autodist_tpu', 'native',
                           'dataloader.cc'), 'rb') as f:
        jax_src = f.read()
    with open(os.path.join(native_build.NATIVE_SRC_DIR, 'dataloader.cc'),
              'rb') as f:
        assert f.read() == jax_src


def test_write_records_matches_jax_bytes(tmp_path):
    data = np.random.RandomState(0).rand(6, 3, 2).astype(np.float32)
    a = write_records(str(tmp_path / 'a.rec'), data)
    b = jwrite_records(str(tmp_path / 'b.rec'), data)
    assert open(a, 'rb').read() == open(b, 'rb').read()
    assert read_record_header(a) == (24, 6)
    junk = tmp_path / 'junk.bin'
    junk.write_bytes(b'\x00' * 32)
    with pytest.raises(ValueError, match='ADTR1'):
        read_record_header(str(junk))


def test_dataloader_native_matches_python(tmp_path):
    rng = np.random.RandomState(0)
    data = rng.randint(0, 1000, (32, 16)).astype(np.int32)
    f = write_records(str(tmp_path / 'd.rec'), data)
    batches = {}
    for native in (True, False):
        dl = DataLoader([f], 8, (16,), np.int32, shuffle=False,
                        native=native)
        assert (dl._handle is not None) == native   # the C++ reader ran
        batches[native] = [dl.next_batch() for _ in range(4)]
        dl.close()
    for a, b in zip(batches[True], batches[False]):
        assert np.array_equal(a, b)
    assert np.array_equal(np.concatenate(batches[True]), data)


def test_dataloader_sharding_partitions_records(tmp_path):
    data = np.arange(64, dtype=np.int32).reshape(16, 4)
    f = write_records(str(tmp_path / 'd.rec'), data)
    seen = set()
    for shard in range(4):
        dl = DataLoader([f], 4, (4,), np.int32, shuffle=False,
                        shard_id=shard, num_shards=4, native=True)
        rows = {int(row[0]) for row in dl.next_batch()}
        assert all(r // 4 % 4 == shard for r in rows)
        seen |= rows
        dl.close()
    assert seen == {int(r[0]) for r in data}


def test_dataloader_shuffle_is_seeded(tmp_path):
    data = np.arange(160, dtype=np.int32).reshape(16, 10)
    f = write_records(str(tmp_path / 'd.rec'), data)

    def first_batch(seed):
        dl = DataLoader([f], 16, (10,), np.int32, shuffle=True,
                        seed=seed, native=True)
        out = dl.next_batch()
        dl.close()
        return out

    assert np.array_equal(first_batch(3), first_batch(3))
    assert not np.array_equal(first_batch(3), first_batch(4))
    assert sorted(first_batch(3)[:, 0]) == list(range(0, 160, 10))


@pytest.mark.parametrize('native', [True, False])
@pytest.mark.parametrize('shuffle', [False, True])
def test_dataloader_yields_the_jax_batches(tmp_path, shuffle, native):
    """Two files, shard 1 of 2, seed 3, five batches of 5 (three epochs
    of the shard's 8 records): the same bytes from both packages, and,
    on the Python reader, the same epoch count after."""
    rng = np.random.RandomState(1)
    files = [write_records(str(tmp_path / ('d%d.rec' % i)),
                           rng.rand(n, 2, 3).astype(np.float32))
             for i, n in enumerate((9, 7))]
    kw = dict(shuffle=shuffle, seed=3, shard_id=1, num_shards=2,
              native=native)
    port = DataLoader(files, 5, (2, 3), 'float32', **kw)
    ref = JDataLoader(files, 5, (2, 3), 'float32', **kw)
    for _ in range(5):
        a, b = port.next_batch(), ref.next_batch()
        assert a.dtype == b.dtype and a.shape == b.shape == (5, 2, 3)
        assert a.tobytes() == b.tobytes()
    if not native:   # the native reader's epoch runs ahead with its queue
        assert port.epoch == ref.epoch == 3
    port.close()
    ref.close()


def test_dataloader_rejects_a_record_size_mismatch(tmp_path):
    f = write_records(str(tmp_path / 'd.rec'), np.zeros((4, 3), np.int32))
    with pytest.raises(ValueError, match='record size mismatch'):
        DataLoader([f], 2, (4,), np.int32, native=False)


def test_native_build_caches_by_source_and_command():
    first = native_build.build('dataloader.cc', shared=True)
    assert first.startswith(native_build.NATIVE_CACHE_DIR)
    assert native_build.build('dataloader.cc', shared=True) == first
    other = native_build.build('dataloader.cc', shared=True,
                               extra_flags=('-DADTR_UNUSED=1',))
    assert other != first and os.path.exists(other)
