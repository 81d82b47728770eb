"""Spawned gloo ranks for the port's multi-rank tests on the CPU.

A module, not a test file: the ranks run ``python -m tests.torch_ranks``
and import their body by name, so no rank ever imports a test module (or
pytest's conftest, or JAX). Each rank caps torch at one thread before
anything else (ranks at torch's default thread count starve the
timing-bound tests of the other xdist workers, see
``tests/torch_cpu_threads.py``), joins its group through a file under the
test's ``tmp_path`` (no TCP port to race for), runs ``body(rank, world,
payload)`` and saves what it returns with ``torch.save``. The test process
never initializes a process group itself; a rank that fails or outlives
the timeout fails the test, and every rank is killed before
:meth:`Ranks.results` returns. Ranks run at a lower scheduling priority
(``os.nice``) than the test processes.
"""

import importlib
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 150
RANK_NICENESS = 10


class Ranks:
    """``world`` rank processes running ``body`` (``'module:function'``) on
    ``payload``; :meth:`results` waits for them."""

    def __init__(self, tmp_dir, world, body, payload, timeout=TIMEOUT_S):
        import torch
        os.makedirs(tmp_dir, exist_ok=True)
        self.dir, self.world, self.timeout = str(tmp_dir), world, timeout
        payload_path = os.path.join(self.dir, 'payload.pt')
        torch.save(payload, payload_path)
        init = 'file://' + os.path.join(self.dir, 'rendezvous')
        env = {k: v for k, v in os.environ.items()
               if k not in ('WORLD_SIZE', 'RANK', 'LOCAL_RANK', 'MASTER_ADDR', 'MASTER_PORT')}
        env.update(OMP_NUM_THREADS='1', PYTHONPATH=os.pathsep.join(
            p for p in (ROOT, env.get('PYTHONPATH')) if p))
        self.logs = [os.path.join(self.dir, 'rank%d.log' % r) for r in range(world)]
        self.procs = []
        for rank in range(world):
            with open(self.logs[rank], 'wb') as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, '-m', 'tests.torch_ranks', str(world), str(rank), init,
                     body, payload_path, self.dir],
                    cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
        self.start = time.monotonic()

    def _logs(self):
        out = []
        for path in self.logs:
            with open(path, errors='replace') as f:
                out.append(f.read()[-4000:])
        return '\n'.join('--- rank %d ---\n%s' % (r, text) for r, text in enumerate(out))

    def results(self):
        """Each rank's returned object, in rank order; raises
        ``AssertionError`` with the ranks' logs when one failed or ran past
        the timeout (all ranks are killed first)."""
        import torch
        try:
            for p in self.procs:
                left = self.timeout - (time.monotonic() - self.start)
                try:
                    p.wait(timeout=max(left, 0.1))
                except subprocess.TimeoutExpired:
                    break
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        codes = [p.returncode for p in self.procs]
        assert codes == [0] * self.world, 'ranks failed or timed out (%s):\n%s' % (
            codes, self._logs())
        return [torch.load(os.path.join(self.dir, 'result%d.pt' % r), weights_only=False)
                for r in range(self.world)]


def main(argv):
    # below the test processes: a rank must not starve the timing-bound
    # tests (heartbeats, stall windows) of the other xdist workers
    os.nice(RANK_NICENESS)
    import torch
    torch.set_num_threads(1)
    from datetime import timedelta

    import torch.distributed as dist
    world, rank, init, body, payload_path, out_dir = argv
    world, rank = int(world), int(rank)
    dist.init_process_group('gloo', init_method=init, rank=rank, world_size=world,
                            timeout=timedelta(seconds=TIMEOUT_S))
    try:
        module, name = body.split(':')
        fn = getattr(importlib.import_module(module), name)
        result = fn(rank, world, torch.load(payload_path, weights_only=False))
        torch.save(result, os.path.join(out_dir, 'result%d.pt' % rank))
    finally:
        dist.destroy_process_group()


if __name__ == '__main__':
    main(sys.argv[1:])
