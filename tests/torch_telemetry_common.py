"""Shared fixtures of the port's telemetry tests, which run the JAX
package's telemetry and the port's in one process.

``telemetry_guard`` is autouse in every file that imports it. It resets
both packages' telemetry before and after each test; since it requests
no other fixture, its teardown runs after ``monkeypatch`` has restored
the environment, so the closing reset reads the restored knobs. It then
fails the test, inside the file that caused it, if the JAX package's
tracing or span caches, the SIGUSR1 handler, the ``PETASTORM_TPU_*``
environment or the JAX recorder differ from what they were before, or if
a port thread (``petastorm-tpu-torch-*``) is still running. For the live
plane it also fails the test when, after that reset, either package
still has an observability thread (``petastorm-tpu-obs*`` or
``petastorm-tpu-torch-obs*``), an HTTP server, a sampler, an SLO policy
or a flight-log writer, or when a ``PETASTORM_TPU_OBS_*`` or
``PETASTORM_TPU_SLO`` variable is still set: a reference server that
outlived a parity test would break a later reference test in the same
worker.

``armed_dump`` is for a test that sets ``PETASTORM_TPU_TRACE_DUMP``: it
restores the SIGUSR1 handler it found and unregisters the ``atexit``
dump hooks the test armed, in both packages. ``traced`` turns tracing on
in both. ``write_small_dataset`` writes the rows every file reads.
"""

import atexit
import os
import signal
import threading
import time

import numpy as np
import pytest

from petastorm_tpu import telemetry as jax_telemetry
from petastorm_tpu.telemetry import obs_server as jax_obs_server
from petastorm_tpu.telemetry import obslog as jax_obslog
from petastorm_tpu.telemetry import recorder as jax_recorder
from petastorm_tpu.telemetry import slo as jax_slo
from petastorm_tpu.telemetry import spans as jax_spans
from petastorm_tpu.telemetry import timeseries as jax_timeseries
from petastorm_tpu.telemetry import tracing as jax_tracing
from petastorm_tpu_torch import telemetry as torch_telemetry
from petastorm_tpu_torch.telemetry import obs_server as torch_obs_server
from petastorm_tpu_torch.telemetry import obslog as torch_obslog
from petastorm_tpu_torch.telemetry import slo as torch_slo
from petastorm_tpu_torch.telemetry import spans as torch_spans
from petastorm_tpu_torch.telemetry import timeseries as torch_timeseries
from petastorm_tpu_torch.telemetry import tracing as torch_tracing

PORT_THREAD_PREFIX = 'petastorm-tpu-torch-'
#: thread-name prefixes of both packages' observability planes
OBS_THREAD_PREFIXES = ('petastorm-tpu-obs', 'petastorm-tpu-torch-obs')
#: environment knobs that arm or shape the live plane
OBS_ENV_PREFIXES = ('PETASTORM_TPU_OBS_', 'PETASTORM_TPU_SLO')
#: JAX-only knobs that keep the reference's pipeline the port's shape
#: (the port has no readahead plane yet)
JAX_ONLY_OFF = ('PETASTORM_TPU_READAHEAD',)
_DUMP_FLAGS = ('_atexit_installed', '_signal_installed')


def reset_both():
    jax_telemetry.reset_for_tests()
    torch_telemetry.reset_for_tests()


def _port_threads():
    return [t for t in threading.enumerate() if t.name.startswith(PORT_THREAD_PREFIX)]


def _obs_leftovers():
    """What of either package's live plane is still there."""
    found = {}
    threads = [t.name for t in threading.enumerate() if t.name.startswith(OBS_THREAD_PREFIXES)]
    if threads:
        found['threads'] = threads
    for pkg, server, timeseries, slo, obslog in (
            ('jax', jax_obs_server, jax_timeseries, jax_slo, jax_obslog),
            ('port', torch_obs_server, torch_timeseries, torch_slo, torch_obslog)):
        for name, value in (('obs_server._state.server', server._state.server),
                            ('timeseries._collector', timeseries._collector),
                            ('slo._policy', slo._policy),
                            ('obslog._writer', obslog._writer)):
            if value is not None:
                found['%s %s' % (pkg, name)] = value
    env = {k: v for k, v in os.environ.items() if k.startswith(OBS_ENV_PREFIXES)}
    if env:
        found['environment'] = env
    return found


def _global_state():
    return {
        'jax tracing._enabled': jax_tracing._enabled,
        'jax tracing._stride': jax_tracing._stride,
        'jax spans._disabled': jax_spans._disabled,
        'jax spans._trace_hook': jax_spans._trace_hook,
        'jax dump hooks': tuple(getattr(jax_tracing, f) for f in _DUMP_FLAGS),
        'jax recorder length': len(jax_recorder.get_recorder()),
        'port tracing._enabled': torch_tracing._enabled,
        'port spans._trace_hook': torch_spans._trace_hook,
        'port dump hooks': tuple(getattr(torch_tracing, f) for f in _DUMP_FLAGS),
        'SIGUSR1 handler': signal.getsignal(signal.SIGUSR1),
        'PETASTORM_TPU_* environment': {k: v for k, v in os.environ.items()
                                        if k.startswith('PETASTORM_TPU_')},
    }


@pytest.fixture(autouse=True)
def telemetry_guard():
    reset_both()
    before = _global_state()
    yield
    reset_both()
    deadline = time.monotonic() + 5.0
    while _port_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not _port_threads(), 'port threads left running: %s' % _port_threads()
    while _obs_leftovers().get('threads') and time.monotonic() < deadline:
        time.sleep(0.01)
    leftovers = _obs_leftovers()
    assert not leftovers, 'observability plane left behind: %s' % leftovers
    after = _global_state()
    leaked = {k: (before[k], after[k]) for k in before if before[k] != after[k]}
    assert not leaked, 'process-global telemetry state leaked: %s' % leaked


@pytest.fixture
def armed_dump():
    """Restore the SIGUSR1 handler and both packages' dump-hook flags, and
    unregister the ``atexit`` dumps the test armed."""
    handler = signal.getsignal(signal.SIGUSR1)
    flags = {mod: {f: getattr(mod, f) for f in _DUMP_FLAGS}
             for mod in (jax_tracing, torch_tracing)}
    yield
    for mod, saved in flags.items():
        if not saved['_atexit_installed']:
            atexit.unregister(mod._dump_if_any)
        for flag, value in saved.items():
            setattr(mod, flag, value)
    # only the main thread installs handlers, so only a changed one is put back
    if signal.getsignal(signal.SIGUSR1) is not handler:
        signal.signal(signal.SIGUSR1, handler)


@pytest.fixture
def traced(monkeypatch):
    """``PETASTORM_TPU_TRACE=1`` in both packages (the guard's closing
    reset re-reads the restored environment)."""
    monkeypatch.setenv('PETASTORM_TPU_TRACE', '1')
    for knob in JAX_ONLY_OFF:
        monkeypatch.setenv(knob, '0')
    jax_telemetry.refresh()
    torch_telemetry.refresh()


def write_small_dataset(url, rows=120, rowgroup_size_rows=10, seed=0):
    """``rows`` rows of an int64 ``id`` and a float32 (4,) ``x`` made from
    ``seed``, in ``rowgroup_size_rows``-row groups, written by the port."""
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_dataset
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema('SmallSchema', [
        UnischemaField('id', np.int64, (), ScalarCodec(np.int64), False),
        UnischemaField('x', np.float32, (4,), NdarrayCodec(), False)])
    rng = np.random.RandomState(seed)
    write_dataset(url, schema, [{'id': i, 'x': rng.rand(4).astype(np.float32)}
                                for i in range(rows)],
                  rowgroup_size_rows=rowgroup_size_rows)
    return url
