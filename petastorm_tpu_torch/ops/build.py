"""Build and load the port's native libraries: the hand-written CUDA
kernels and the host image decoders.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a``, and each
``native/<name>.c`` with ``cc -O3 -pthread`` (linking the system library
it decodes with), into a shared library with a plain C interface, loaded
with ``ctypes``. Nothing includes PyTorch's or Python's headers, so a
build takes seconds. Builds happen at first use (or together, in
parallel, through :func:`build`) into ``build/petastorm_tpu_torch/``
beside the package, a directory that ``.gitignore`` lists, under a file
lock shared by every process of the checkout; a library's file name
carries a hash of its source and flags, so an edited source rebuilds and
an unchanged one does not.
"""

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, 'csrc')
NATIVE_DIR = os.path.join(_PKG_DIR, 'native')
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), 'build', 'petastorm_tpu_torch')

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
CC_FLAGS = ('-O3', '-pthread', '-shared', '-fPIC')
#: host library (``native/<name>.c``) -> the system libraries it links
HOST_LIBRARIES = {'npy_batch': (), 'jpeg_batch': ('-ljpeg',), 'png_batch': ('-lz',)}

_lock = threading.Lock()
_loaded = {}
#: name -> {'seconds': build wall time, 'log': compiler output} of the
#: builds this process ran
build_log = {}


def _find_compiler(candidates, what):
    for candidate in candidates:
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError('%s not found' % what)


def _recipe(name):
    """``(source, flags, libraries, compiler finder)`` of library ``name``."""
    if name in HOST_LIBRARIES:
        return (os.path.join(NATIVE_DIR, name + '.c'), CC_FLAGS, HOST_LIBRARIES[name],
                lambda: _find_compiler((os.environ.get('CC') and shutil.which(
                    os.environ['CC']), shutil.which('cc'), shutil.which('gcc')),
                    'cc (a C compiler) is needed to build the native decoders'))
    return (os.path.join(CSRC_DIR, name + '.cu'), NVCC_FLAGS, (),
            lambda: _find_compiler((os.path.join(os.environ.get(
                'CUDA_HOME', '/usr/local/cuda'), 'bin', 'nvcc'), shutil.which('nvcc')),
                'nvcc (set CUDA_HOME or put nvcc on PATH); the CUDA kernels build '
                'on a machine with the CUDA toolkit'))


def library_path(name):
    """Where the library built from ``name``'s source lives."""
    source, flags, libraries, _ = _recipe(name)
    with open(source, 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(flags + libraries).encode())
    return os.path.join(BUILD_DIR, 'lib%s-%s.so' % (name, digest.hexdigest()[:16]))


def build(names):
    """Compile every not-yet-built library of ``names``, one compiler per
    source, all started together, under the checkout's build lock;
    raises if any fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, '.build.lock'), 'w') as lock:
        fcntl.flock(lock.fileno(), fcntl.LOCK_EX)
        running = []
        for name in names:
            out = library_path(name)
            if os.path.exists(out):
                continue  # built here before, or by the lock's last holder
            source, flags, libraries, compiler = _recipe(name)
            tmp = '%s.%d.tmp' % (out, os.getpid())
            cmd = [compiler(), *flags, '-o', tmp, source, *libraries]
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
        raise RuntimeError('build failed for ' + '\n'.join(failures))


def load(name):
    """The ctypes handle of library ``name``, built if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not os.path.exists(path):
                build([name])
            lib = _loaded[name] = ctypes.CDLL(path)
        return lib
