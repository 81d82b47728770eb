"""Spawn (never fork) a Python function in a fresh interpreter
(counterpart of ``petastorm_tpu/workers/exec_in_new_process.py``).

A parent that holds a CUDA context must never be forked. The function and
its arguments are dill-serialized to a temporary file, and a clean
``python -m petastorm_tpu_torch.workers.exec_in_new_process`` bootstrap
loads and runs it. The child sees no GPU (``CUDA_VISIBLE_DEVICES=''``), so
a decode worker can never open a context on the trainer's card.
"""

import os
import subprocess
import sys
import tempfile

import dill


def exec_in_new_process(func, *args, **kwargs):
    """Run ``func(*args, **kwargs)`` in a new Python process; returns its
    :class:`subprocess.Popen` handle."""
    fd, payload_path = tempfile.mkstemp(prefix='petastorm_tpu_torch_spawn_', suffix='.dill')
    with os.fdopen(fd, 'wb') as f:
        dill.dump((func, args, kwargs), f)
    env = dict(os.environ)
    env['CUDA_VISIBLE_DEVICES'] = ''
    # the child imports this package (and the caller's modules, such as a
    # user's worker class) even where the parent found them on a sys.path
    # it extended itself
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    paths = [p for p in [pkg_root] + sys.path if p]
    if env.get('PYTHONPATH'):
        paths.append(env['PYTHONPATH'])
    seen = set()
    env['PYTHONPATH'] = os.pathsep.join(p for p in paths if not (p in seen or seen.add(p)))
    return subprocess.Popen(
        [sys.executable, '-m', 'petastorm_tpu_torch.workers.exec_in_new_process', payload_path],
        env=env)


def _main():
    payload_path = sys.argv[1]
    with open(payload_path, 'rb') as f:
        func, args, kwargs = dill.load(f)
    os.unlink(payload_path)
    func(*args, **kwargs)


if __name__ == '__main__':
    _main()
