"""Shared pieces of the port's decode-service tests: both packages' service
surfaces side by side, the reference tests' timing, fleets of worker-server
CLIs, and id multisets read through either package.

Every case spawns real worker-server processes over ``tcp://`` loopback.
Hangs are bounded inside the tests (every ``get_results`` has a timeout,
registration waits have ``connect_timeout_s``) and fleets are reaped in
``finally``.
"""

import collections
import contextlib
import os
import signal
import subprocess
import sys
import types

import numpy as np

from petastorm_tpu import errors as jax_errors
from petastorm_tpu import faults as jax_faults
from petastorm_tpu import reader as jax_reader
from petastorm_tpu import telemetry as jax_telemetry
from petastorm_tpu import transform as jax_transform
from petastorm_tpu import workers as jax_workers
from petastorm_tpu.telemetry import tracing as jax_tracing
from petastorm_tpu.service import dispatcher as jax_dispatcher
from petastorm_tpu.service import protocol as jax_protocol
from petastorm_tpu.service import service_pool as jax_service_pool
from petastorm_tpu.service import worker_server as jax_worker_server
from petastorm_tpu.workers import ventilator as jax_ventilator
from petastorm_tpu_torch import errors as torch_errors
from petastorm_tpu_torch import faults as torch_faults
from petastorm_tpu_torch import reader as torch_reader
from petastorm_tpu_torch import telemetry as torch_telemetry
from petastorm_tpu_torch import transform as torch_transform
from petastorm_tpu_torch import workers as torch_workers
from petastorm_tpu_torch.telemetry import tracing as torch_tracing
from petastorm_tpu_torch.service import dispatcher as torch_dispatcher
from petastorm_tpu_torch.service import protocol as torch_protocol
from petastorm_tpu_torch.service import service_pool as torch_service_pool
from petastorm_tpu_torch.service import worker_server as torch_worker_server
from petastorm_tpu_torch.workers import ventilator as torch_ventilator
from tests import stub_workers as jax_stubs
from tests import torch_stub_workers as torch_stubs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the reference tests' timing: lapses detected well under a second,
#: generous outer deadlines
FAST = dict(heartbeat_interval_s=0.15, liveness_timeout_s=0.75, connect_timeout_s=60,
            no_workers_timeout_s=20)


def _package(name, errors, faults, reader, telemetry, tracing, transform, workers, ventilator,
             dispatcher, protocol, service_pool, worker_server, stubs):
    return types.SimpleNamespace(
        name=name, errors=errors, faults=faults, reader=reader, telemetry=telemetry,
        tracing=tracing, TransformSpec=transform.TransformSpec,
        EmptyResultError=workers.EmptyResultError,
        ConcurrentVentilator=ventilator.ConcurrentVentilator, dispatcher=dispatcher,
        protocol=protocol, service_pool=service_pool, ServicePool=service_pool.ServicePool,
        worker_server=worker_server, stubs=stubs, cli=worker_server.__name__)


PACKAGES = {
    'jax': _package('jax', jax_errors, jax_faults, jax_reader, jax_telemetry, jax_tracing,
                    jax_transform, jax_workers, jax_ventilator, jax_dispatcher, jax_protocol,
                    jax_service_pool, jax_worker_server, jax_stubs),
    'torch': _package('torch', torch_errors, torch_faults, torch_reader, torch_telemetry,
                      torch_tracing, torch_transform, torch_workers, torch_ventilator,
                      torch_dispatcher, torch_protocol, torch_service_pool,
                      torch_worker_server, torch_stubs),
}


def both(fn):
    """``{'jax': fn(jax side), 'torch': fn(port side)}``, run one after the
    other."""
    return {name: fn(pkg) for name, pkg in PACKAGES.items()}


def drain(pkg, pool, per_result_timeout_s=60):
    out = []
    while True:
        try:
            out.append(pool.get_results(timeout=per_result_timeout_s))
        except pkg.EmptyResultError:
            return out


def arm(monkeypatch, spec):
    """Arm ``PETASTORM_TPU_FAULTS`` in both packages (spawned fleets inherit
    it); ``spec=None`` disarms."""
    if spec is None:
        monkeypatch.delenv('PETASTORM_TPU_FAULTS', raising=False)
    else:
        monkeypatch.setenv('PETASTORM_TPU_FAULTS', spec)
    for pkg in PACKAGES.values():
        pkg.faults.refresh_faults()


def reap(procs):
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def spawn_cli_worker(pkg, endpoint, worker_id=0, heartbeat_interval_s=0.2, faults=True):
    """One worker server started the way an operator would, through the
    package's CLI, orphan-checked against this process."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, 'tests')]),
               JAX_PLATFORMS='cpu')
    if not faults:
        env.pop('PETASTORM_TPU_FAULTS', None)
    return subprocess.Popen(
        [sys.executable, '-m', pkg.cli, '--endpoint', endpoint,
         '--heartbeat-interval', str(heartbeat_interval_s), '--worker-id', str(worker_id),
         '--parent-pid', str(os.getpid())], env=env)


@contextlib.contextmanager
def cli_worker_servers(pkg, endpoint, count, heartbeat_interval_s=0.2):
    procs = [spawn_cli_worker(pkg, endpoint, i, heartbeat_interval_s) for i in range(count)]
    try:
        yield procs
    finally:
        reap(procs)


def read_id_multiset(pkg, url, reader_pool_type, kill_proc_after_first=None,
                     transform=None, **kwargs):
    """Every ``id`` of one epoch of ``make_batch_reader`` as a multiset,
    SIGKILLing ``kill_proc_after_first`` after the first batch."""
    ids = collections.Counter()
    spec = pkg.TransformSpec(transform) if transform is not None else None
    with pkg.reader.make_batch_reader(url, reader_pool_type=reader_pool_type, num_epochs=1,
                                      shuffle_row_groups=False, transform_spec=spec,
                                      **kwargs) as reader:
        for i, batch in enumerate(reader):
            ids.update(int(x) for x in np.asarray(batch.id))
            if i == 0 and kill_proc_after_first is not None:
                os.kill(kill_proc_after_first.pid, signal.SIGKILL)
    return ids
