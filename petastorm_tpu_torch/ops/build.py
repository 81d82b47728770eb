"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. Nothing
includes PyTorch's headers, so a build takes seconds. Builds happen at
first use (or together, in parallel, through :func:`build`) into
``build/petastorm_tpu_torch/`` beside the package, a directory that
``.gitignore`` lists; a library's file name carries a hash of its source
and flags, so an edited source rebuilds and an unchanged one does not.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), 'build', 'petastorm_tpu_torch')

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_lock = threading.Lock()
_loaded = {}
#: name -> {'seconds': build wall time, 'log': nvcc/ptxas output} of the
#: builds this process ran
build_log = {}


def _nvcc():
    for candidate in (os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                                   'bin', 'nvcc'),
                      shutil.which('nvcc')):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError('nvcc not found (set CUDA_HOME or put nvcc on PATH); '
                       'the CUDA kernels build on a machine with the CUDA toolkit')


def library_path(name):
    """Where the library built from ``csrc/<name>.cu`` lives."""
    with open(os.path.join(CSRC_DIR, name + '.cu'), 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, 'lib%s-%s.so' % (name, digest.hexdigest()[:16]))


def build(names):
    """Compile every not-yet-built library of ``names``, one ``nvcc`` per
    source, all started together; raises if any fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    running = []
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = '%s.%d.tmp' % (out, os.getpid())
        cmd = [nvcc, *NVCC_FLAGS, '-o', tmp, os.path.join(CSRC_DIR, name + '.cu')]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        running.append((name, out, tmp, proc, time.monotonic()))
    failures = []
    for name, out, tmp, proc, t0 in running:
        log = proc.communicate()[0].decode('utf-8', 'replace')
        build_log[name] = {'seconds': time.monotonic() - t0, 'log': log}
        if proc.returncode != 0:
            failures.append('%s (rc %d):\n%s' % (name, proc.returncode, log))
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError('nvcc failed for ' + '\n'.join(failures))


def load(name):
    """The ctypes handle of ``csrc/<name>.cu``'s library, built if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not os.path.exists(path):
                build([name])
            lib = _loaded[name] = ctypes.CDLL(path)
        return lib
