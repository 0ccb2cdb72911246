"""The kernel builder's cache key covers everything that is compiled.

``build.library_path`` names the cached library after a hash of what goes
into it. A source may include any header in ``csrc/``, so a changed
header, like a changed source or compile command, must name a new
library; otherwise a stale one would be loaded. These run on the CPU:
``nvcc_path`` is patched, since the builder itself runs only where the
CUDA compiler is.
"""
import os
import shutil

import pytest

from autodist_tpu_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A private ``csrc/`` with one source that includes one header."""
    (tmp_path / 'k.cu').write_text('#include "prims.cuh"\n__global__ void k() {}\n')
    (tmp_path / 'prims.cuh').write_text('#pragma once\n// v1\n')
    monkeypatch.setattr(build, 'CSRC_DIR', str(tmp_path))
    monkeypatch.setattr(build, 'nvcc_path', lambda: '/usr/local/cuda/bin/nvcc')
    return tmp_path


def test_library_path_is_stable(csrc):
    assert build.library_path('k.cu') == build.library_path('k.cu')
    assert os.path.basename(build.library_path('k.cu')) == 'libk.so'


@pytest.mark.parametrize('change', ['header', 'new_header', 'source',
                                    'flags'])
def test_library_path_changes_with_what_is_compiled(csrc, monkeypatch,
                                                    change):
    before = build.library_path('k.cu')
    if change == 'header':
        (csrc / 'prims.cuh').write_text('#pragma once\n// v2\n')
    elif change == 'new_header':
        (csrc / 'more.h').write_text('// another header\n')
    elif change == 'source':
        (csrc / 'k.cu').write_text('#include "prims.cuh"\n// edited\n')
    else:
        monkeypatch.setattr(build, 'ARCH_FLAGS',
                            build.ARCH_FLAGS + ('-lineinfo',))
    assert build.library_path('k.cu') != before


def test_library_path_ignores_other_sources(csrc):
    before = build.library_path('k.cu')
    (csrc / 'other.cu').write_text('__global__ void other() {}\n')
    assert build.library_path('k.cu') == before


def test_repo_sources_key_on_the_shared_header(tmp_path, monkeypatch):
    """A copy of the real csrc/: flash_attention.cu includes sm90.cuh,
    and editing the header names a new library."""
    for name in os.listdir(build.CSRC_DIR):
        shutil.copy(os.path.join(build.CSRC_DIR, name), tmp_path / name)
    monkeypatch.setattr(build, 'CSRC_DIR', str(tmp_path))
    monkeypatch.setattr(build, 'nvcc_path', lambda: '/usr/local/cuda/bin/nvcc')
    assert '#include "sm90.cuh"' in (tmp_path / 'flash_attention.cu').read_text()
    before = build.library_path('flash_attention.cu')
    with open(tmp_path / 'sm90.cuh', 'a') as f:
        f.write('// edited\n')
    assert build.library_path('flash_attention.cu') != before
