"""Stub workers for the port's pool tests (the counterparts of
``tests/stub_workers.py``). They import only the port, so a spawned
process-pool worker that loads them by name imports nothing of the JAX
package."""

import os
import sys
import time

from petastorm_tpu_torch.workers.worker_base import WorkerBase


class IdentityWorker(WorkerBase):
    def process(self, *args, **kwargs):
        for a in args:
            self.publish_func(a)
        for v in kwargs.values():
            self.publish_func(v)


class SleepyIdentityWorker(WorkerBase):
    def process(self, value, sleep_s=0.01):
        time.sleep(sleep_s)
        self.publish_func(value)


class ExceptionOnFiveWorker(WorkerBase):
    """Publishes its input unless it equals 5, then raises."""

    def process(self, value):
        if value == 5:
            raise ValueError('value was 5')
        self.publish_func(value)


class ExitOnFiveWorker(WorkerBase):
    """Publishes its input unless it equals 5, then kills its own process
    (``os._exit``: no exception frame, no goodbye): the worker-killing
    row-group of the quarantine drills. A small sleep keeps other items in
    flight when the kill lands."""

    def process(self, value, sleep_s=0.02):
        if value == 5:
            os._exit(13)
        time.sleep(sleep_s)
        self.publish_func(value)


def slow_batch_identity(df):
    """A TransformSpec function that brakes each row-group, so a worker
    killed mid-epoch reliably owns items in flight."""
    time.sleep(0.05)
    return df


class MultiplyingWorker(WorkerBase):
    """Publishes value * args['factor']."""

    def process(self, value):
        self.publish_func(value * self.args['factor'])


class FailingStartWorker(WorkerBase):
    """Raises in ``initialize``: the worker dies before it checks in."""

    def initialize(self):
        raise RuntimeError('cannot start')

    def process(self, value):
        self.publish_func(value)


class SpanningSleepyWorker(WorkerBase):
    """Sleeps under a 'decode' span, then publishes its input: the probe
    for worker-side metrics reaching the consumer."""

    def process(self, value, sleep_s=0.02):
        from petastorm_tpu_torch.telemetry import span
        with span('decode'):
            time.sleep(sleep_s)
        self.publish_func(value)


class TracingProbeWorker(WorkerBase):
    """Publishes ``(item_index, the trace id active in the worker)`` after
    a small 'decode' span."""

    def process(self, item_index=None, sleep_s=0.002):
        from petastorm_tpu_torch.telemetry import span
        from petastorm_tpu_torch.telemetry.tracing import current_trace_id
        with span('decode'):
            time.sleep(sleep_s)
        self.publish_func((item_index, current_trace_id()))


class EnvironmentProbeWorker(WorkerBase):
    """Publishes its process's pid, ``CUDA_VISIBLE_DEVICES`` and whether
    JAX, the JAX package or torch is loaded there."""

    def process(self, value):
        self.publish_func({'value': value, 'pid': os.getpid(),
                           'cuda_visible_devices': os.environ.get('CUDA_VISIBLE_DEVICES'),
                           'jax': 'jax' in sys.modules,
                           'petastorm_tpu': 'petastorm_tpu' in sys.modules,
                           'torch': 'torch' in sys.modules})


def write_marker(path, value):
    """A child's proof of life: ``value`` and its pid, written to ``path``."""
    with open(path, 'w') as f:
        f.write('%s:%d' % (value, os.getpid()))


def exit_with(code):
    raise SystemExit(code)


def report_environment(path):
    """Write ``CUDA_VISIBLE_DEVICES`` (repr) and whether ``jax`` and
    ``petastorm_tpu`` are loaded, ``|``-separated, to ``path``."""
    with open(path, 'w') as f:
        f.write('%r|%s|%s' % (os.environ.get('CUDA_VISIBLE_DEVICES'), 'jax' in sys.modules,
                              'petastorm_tpu' in sys.modules))


def group_probe(rank, task):
    """A rank-pool task (``chip_smoke._RankPool``): a device mesh over the
    task's gloo group, and a sum of ``rank + 1`` over it."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    mesh = init_device_mesh('cpu', (world,), mesh_dim_names=('dp',))
    total = torch.tensor([rank + 1])
    dist.all_reduce(total, group=mesh.get_group('dp'))
    return {'rank': rank, 'task': task, 'world': world, 'sum': int(total), 'pid': os.getpid()}


def rank_exit(rank, code):
    """A rank-pool task whose rank 1 dies with exit ``code``."""
    if rank == 1:
        os._exit(code)
    return {'rank': rank}


class FleetDecodeWorker(WorkerBase):
    """Publishes ``(item, was_decoded, value, pid)`` for one item served
    through the job's materialized cache: ``was_decoded`` is the fleet-wide
    decode-count probe of the fleet cache tier's drills."""

    def process(self, item, sleep_s=0.0):
        import numpy as np
        from petastorm_tpu_torch.arrow_worker import ColumnBatch
        if sleep_s:
            time.sleep(sleep_s)
        decoded = []

        def fill():
            decoded.append(True)
            return ColumnBatch({'v': np.full(16, item, dtype=np.int64)}, 16)

        batch = self.args['cache'].get(('peer-e2e', item), fill)
        self.publish_func((int(item), bool(decoded), int(batch.columns['v'][0]), os.getpid()))
