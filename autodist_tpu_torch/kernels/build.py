"""On-demand builder for the port's CUDA kernels.

The counterpart of ``autodist_tpu/native_build.py``: sources live in
``autodist_tpu_torch/kernels/csrc/`` (inside the package, so installed
wheels ship them), and each is compiled at first use with ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface,
loaded with ``ctypes``. Libraries are cached under ``kernels/_build/
<hash>/``, keyed by the source bytes, the bytes of every header in
``csrc/`` and the compile command, so a checkout builds once and
rebuilds only when one of them changes. The
compiler's ``-Xptxas -v`` report (registers, shared memory, spills per
kernel) is kept beside each library as ``build.log``.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import time

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         '_build')
ARCH_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a')

_loaded = {}   # source name -> ctypes.CDLL, one load per process


def nvcc_path():
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    PATH, else the toolkit's default install location."""
    cands = []
    if os.environ.get('CUDA_HOME'):
        cands.append(os.path.join(os.environ['CUDA_HOME'], 'bin', 'nvcc'))
    cands += [shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc']
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError('nvcc not found (set CUDA_HOME): the CUDA kernels '
                       'are built from source on the machine with the card')


def _command(source_name, out):
    return [nvcc_path(), *ARCH_FLAGS, '-std=c++17', '-O3', '-shared',
            '-Xcompiler', '-fPIC', '-Xptxas', '-v',
            os.path.join(CSRC_DIR, source_name), '-o', out]


def library_path(source_name):
    """Where ``csrc/<source_name>`` builds to (not necessarily built):
    keyed by the source, every header in ``csrc/`` (any source may
    include one), and the whole compile-and-link command."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR)
                     if f.endswith(('.cuh', '.h')))
    for name in [source_name] + headers:
        h.update(name.encode() + b'\x00')
        with open(os.path.join(CSRC_DIR, name), 'rb') as f:
            h.update(f.read())
    h.update('\x00'.join(_command(source_name, '')[1:]).encode())
    stem = os.path.splitext(source_name)[0]
    return os.path.join(BUILD_DIR, h.hexdigest()[:16], 'lib%s.so' % stem)


def build_all(source_names):
    """Compile every source not yet built, all ``nvcc`` processes at
    once. Returns ``{source: seconds spent building}`` (0.0 when the
    cached library was used); raises with the compiler's output when
    any build fails."""
    procs = {}
    seconds = {}
    for name in source_names:
        out = library_path(name)
        seconds[name] = 0.0
        if os.path.exists(out):
            continue
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = '%s.%d.tmp' % (out, os.getpid())
        procs[name] = (subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out, time.time())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.time() - t0
        with open(os.path.join(os.path.dirname(out), 'build.log'), 'w') as f:
            f.write(log)
        if proc.returncode != 0:
            failed.append('%s (exit %d):\n%s' % (name, proc.returncode, log))
            continue
        os.replace(tmp, out)   # atomic: a reader never sees half a library
    if failed:
        raise RuntimeError('nvcc failed for ' + '\n'.join(failed))
    return seconds


def build_log(source_name):
    """The compiler's report from building ``source_name``."""
    path = os.path.join(os.path.dirname(library_path(source_name)),
                        'build.log')
    with open(path) as f:
        return f.read()


def load(source_name):
    """Build (if needed) and load ``csrc/<source_name>``."""
    lib = _loaded.get(source_name)
    if lib is None:
        build_all([source_name])
        lib = _loaded[source_name] = ctypes.CDLL(library_path(source_name))
    return lib
