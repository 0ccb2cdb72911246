"""On-demand builder for the port's native (host C++) components.

The counterpart of ``autodist_tpu/native_build.py``. Sources live in
``autodist_tpu_torch/native/`` (inside the package, so installed wheels
ship them; ``dataloader.cc`` is a byte-identical copy of the JAX
package's); libraries are cached under
``const.DEFAULT_WORKING_DIR/native/<hash>/``, keyed by the source bytes
and the compile command, so a rebuild happens only when one of them
changes. Plain g++ builds them. The CUDA kernels have their own
builder, :mod:`autodist_tpu_torch.kernels.build`.
"""
import hashlib
import os
import subprocess

from autodist_tpu_torch.const import DEFAULT_WORKING_DIR
from autodist_tpu_torch.utils import logging

NATIVE_SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              'native')
NATIVE_CACHE_DIR = os.path.join(DEFAULT_WORKING_DIR, 'native')


def build(source_name, output_name=None, shared=False, extra_flags=()):
    """Compile ``native/<source_name>`` and return the artifact path."""
    src = os.path.join(NATIVE_SRC_DIR, source_name)
    # -O3, as the JAX package builds its copy: the element loops need
    # gcc's auto-vectorizer
    cmd = ['g++', '-O3', '-std=c++17', '-pthread']
    if shared:
        cmd += ['-shared', '-fPIC']
    cmd += list(extra_flags)
    # the key covers the compile command too: a flag change rebuilds a
    # byte-identical source
    h = hashlib.sha256()
    with open(src, 'rb') as f:
        h.update(f.read())
    h.update('\x00'.join(cmd).encode())
    out_name = output_name or os.path.splitext(source_name)[0]
    if shared:
        out_name += '.so'
    out_dir = os.path.join(NATIVE_CACHE_DIR, h.hexdigest()[:16])
    out = os.path.join(out_dir, out_name)
    if os.path.exists(out):
        return out
    os.makedirs(out_dir, exist_ok=True)
    tmp = '%s.%d.tmp' % (out, os.getpid())
    logging.info('Building native component: %s',
                 ' '.join(cmd + [src, '-o', out]))
    subprocess.run(cmd + [src, '-o', tmp], check=True)
    os.replace(tmp, out)   # atomic: a reader never sees half a library
    return out
