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
import time
import types

import numpy as np

from petastorm_tpu import errors as jax_errors
from petastorm_tpu import faults as jax_faults
from petastorm_tpu import materialized_cache as jax_materialized_cache
from petastorm_tpu import arrow_worker as jax_arrow_worker
from petastorm_tpu import reader as jax_reader
from petastorm_tpu import telemetry as jax_telemetry
from petastorm_tpu import transform as jax_transform
from petastorm_tpu import workers as jax_workers
from petastorm_tpu.telemetry import tracing as jax_tracing
from petastorm_tpu.service import daemon as jax_daemon
from petastorm_tpu.service import dispatcher as jax_dispatcher
from petastorm_tpu.service import peer_cache as jax_peer_cache
from petastorm_tpu.service import protocol as jax_protocol
from petastorm_tpu.service import service_pool as jax_service_pool
from petastorm_tpu.service import standby as jax_standby
from petastorm_tpu.service import supervisor as jax_supervisor
from petastorm_tpu.service import worker_server as jax_worker_server
from petastorm_tpu.workers import ventilator as jax_ventilator
from petastorm_tpu_torch import errors as torch_errors
from petastorm_tpu_torch import faults as torch_faults
from petastorm_tpu_torch import materialized_cache as torch_materialized_cache
from petastorm_tpu_torch import arrow_worker as torch_arrow_worker
from petastorm_tpu_torch import reader as torch_reader
from petastorm_tpu_torch import telemetry as torch_telemetry
from petastorm_tpu_torch import transform as torch_transform
from petastorm_tpu_torch import workers as torch_workers
from petastorm_tpu_torch.telemetry import tracing as torch_tracing
from petastorm_tpu_torch.service import daemon as torch_daemon
from petastorm_tpu_torch.service import dispatcher as torch_dispatcher
from petastorm_tpu_torch.service import peer_cache as torch_peer_cache
from petastorm_tpu_torch.service import protocol as torch_protocol
from petastorm_tpu_torch.service import service_pool as torch_service_pool
from petastorm_tpu_torch.service import standby as torch_standby
from petastorm_tpu_torch.service import supervisor as torch_supervisor
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
             dispatcher, protocol, service_pool, worker_server, stubs, daemon, standby,
             supervisor, peer_cache, materialized_cache, arrow_worker):
    return types.SimpleNamespace(
        name=name, errors=errors, faults=faults, reader=reader, telemetry=telemetry,
        tracing=tracing, TransformSpec=transform.TransformSpec,
        EmptyResultError=workers.EmptyResultError,
        ConcurrentVentilator=ventilator.ConcurrentVentilator, dispatcher=dispatcher,
        protocol=protocol, service_pool=service_pool, ServicePool=service_pool.ServicePool,
        worker_server=worker_server, stubs=stubs, cli=worker_server.__name__,
        daemon=daemon, ServiceDaemon=daemon.ServiceDaemon,
        DaemonClientPool=daemon.DaemonClientPool, standby=standby,
        StandbyDaemon=standby.StandbyDaemon, supervisor=supervisor,
        WorkerSupervisor=supervisor.WorkerSupervisor, daemon_cli=daemon.__package__,
        peer_cache=peer_cache, materialized_cache=materialized_cache,
        ColumnBatch=arrow_worker.ColumnBatch)


PACKAGES = {
    'jax': _package('jax', jax_errors, jax_faults, jax_reader, jax_telemetry, jax_tracing,
                    jax_transform, jax_workers, jax_ventilator, jax_dispatcher, jax_protocol,
                    jax_service_pool, jax_worker_server, jax_stubs, jax_daemon, jax_standby,
                    jax_supervisor, jax_peer_cache, jax_materialized_cache, jax_arrow_worker),
    'torch': _package('torch', torch_errors, torch_faults, torch_reader, torch_telemetry,
                      torch_tracing, torch_transform, torch_workers, torch_ventilator,
                      torch_dispatcher, torch_protocol, torch_service_pool,
                      torch_worker_server, torch_stubs, torch_daemon, torch_standby,
                      torch_supervisor, torch_peer_cache, torch_materialized_cache,
                      torch_arrow_worker),
}

#: the reference daemon and failover tests' timing: lapses detected well
#: under a second, generous outer deadlines
HB = 0.15
TICK = 0.15


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


def subprocess_env(extra=None, faults=True):
    """The environment of a spawned CLI: the repo and ``tests/`` on the
    path (stub workers load by name), JAX on the CPU."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, 'tests')]),
               JAX_PLATFORMS='cpu')
    if not faults:
        env.pop('PETASTORM_TPU_FAULTS', None)
    env.update(extra or {})
    return env


def spawn_cli_worker(pkg, endpoint, worker_id=0, heartbeat_interval_s=0.2, faults=True,
                     extra_args=(), env_extra=None):
    """One worker server started the way an operator would, through the
    package's CLI, orphan-checked against this process."""
    return subprocess.Popen(
        [sys.executable, '-m', pkg.cli, '--endpoint', endpoint,
         '--heartbeat-interval', str(heartbeat_interval_s), '--worker-id', str(worker_id),
         '--parent-pid', str(os.getpid())] + list(extra_args),
        env=subprocess_env(env_extra, faults))


def spawn_daemon_cli(pkg, endpoint, extra=(), supervise=False):
    """The package's standing daemon through its CLI (``python -m
    <package>.service``), unsupervised unless asked, at :data:`HB`."""
    args = [sys.executable, '-m', pkg.daemon_cli, '--endpoint', endpoint,
            '--heartbeat-interval', str(HB)]
    if not supervise:
        args.append('--no-supervisor')
    return subprocess.Popen(args + list(extra), env=subprocess_env())


def await_condition(predicate, deadline_s=30, interval_s=0.05, message='condition'):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(interval_s)
    raise AssertionError('timed out waiting for %s' % message)


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
