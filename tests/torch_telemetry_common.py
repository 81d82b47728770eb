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
worker. ``PETASTORM_TPU_SANITIZE`` arms both packages' sanitizers too, and
each caches the knob: the guard resets both (after ``monkeypatch``'s
restore) and fails a test that leaves either's cache or violation ring
changed, or the knob set, so a parity test that armed a reference engine
cannot make a later reference test run armed. ``PETASTORM_TPU_FAULTS``
arms both packages' fault injectors: the guard re-reads it in both
(``refresh_faults``, after ``monkeypatch``'s restore, so both disarm) and
clears both decoded caches' publish listeners; it fails a test that left
a listener registered, or whose injector stays armed or whose registry
still shows a degraded decoded cache after that reset. The readahead
plane and the staging autotuner start threads and set process-wide
overrides inside every reader and loader of both packages: before its
reset the guard fails a test that left a live readahead manager (the
port's live set, or a reference manager not closed), a
``petastorm-tpu-torch-readahead-*`` thread, a readahead-depth or
decoder-thread override, or an autotuner holding either override; the
reset then closes both packages' managers and drops both packages'
overrides and owners. Test files that import nothing else of this module
take ``plane_guard``, the same check alone. Each guard charges a test only
for what that test left: what it finds at setup, left by an earlier test
in the same process (a JAX-package test's loader whose staging thread
released its tuner late, say), is reset and recorded on the test's report
as inherited, and at teardown it polls for up to
``PLANE_RELEASE_WAIT_S`` seconds before it fails the test, since a
loader's staging thread releases its tuner and decoder-thread override
after ``stop()``. Both guards also fail a test
that leaves a ``torch.distributed`` default process group initialized in
the test process (every later reader in that worker would shard by its
rank), and destroy it: multi-rank tests run their ranks in spawned
processes (``tests/torch_ranks.py``).

``armed_dump`` is for a test that sets ``PETASTORM_TPU_TRACE_DUMP``: it
restores the SIGUSR1 handler it found and unregisters the ``atexit``
dump hooks the test armed, in both packages. ``traced`` turns tracing on
in both. ``write_small_dataset`` writes the rows every file reads.
"""

import atexit
import os
import signal
import sys
import threading
import time

import numpy as np
import pytest

from petastorm_tpu import codecs as jax_codecs
from petastorm_tpu import faults as jax_faults
from petastorm_tpu import materialized_cache as jax_materialized_cache
from petastorm_tpu import readahead as jax_readahead
from petastorm_tpu import sanitizer as jax_sanitizer
from petastorm_tpu import telemetry as jax_telemetry
from petastorm_tpu.telemetry import obs_server as jax_obs_server
from petastorm_tpu.telemetry import obslog as jax_obslog
from petastorm_tpu.telemetry import recorder as jax_recorder
from petastorm_tpu.telemetry import slo as jax_slo
from petastorm_tpu.telemetry import spans as jax_spans
from petastorm_tpu.telemetry import timeseries as jax_timeseries
from petastorm_tpu.telemetry import tracing as jax_tracing
from petastorm_tpu_torch import codecs as torch_codecs
from petastorm_tpu_torch import faults as torch_faults
from petastorm_tpu_torch import materialized_cache as torch_materialized_cache
from petastorm_tpu_torch import readahead as torch_readahead
from petastorm_tpu_torch import sanitizer as torch_sanitizer
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
_DUMP_FLAGS = ('_atexit_installed', '_signal_installed')


#: the decoded caches' degraded gauge, in both packages' registries
DEGRADED_GAUGE = 'petastorm_tpu_decoded_cache_degraded'


def _autotune_modules():
    """Both packages' autotune modules, where imported (a reset never
    imports them)."""
    return [(pkg, sys.modules.get(name)) for pkg, name in (
        ('jax', 'petastorm_tpu.jax.autotune'), ('port', 'petastorm_tpu_torch.device.autotune'))
        if sys.modules.get(name) is not None]


def _live_default_group():
    """Whether a ``torch.distributed`` default group is initialized here (a
    process that never imported ``torch.distributed`` has none)."""
    dist = sys.modules.get('torch.distributed')
    return dist is not None and dist.is_available() and dist.is_initialized()


def reset_planes():
    """Both packages' readahead managers closed, their autotuners' rings
    and owners cleared and both overrides dropped (the JAX tuner's reset
    leaves the decoder-thread override set), and a default process group
    left initialized destroyed."""
    if _live_default_group():
        sys.modules['torch.distributed'].destroy_process_group()
    for readahead in (jax_readahead, torch_readahead):
        readahead._reset_for_tests()
    for _, autotune in _autotune_modules():
        autotune._reset_for_tests()
    jax_codecs.set_image_decoder_threads_override(None)
    torch_codecs.set_image_decoder_threads_override(None)


def reset_both():
    jax_telemetry.reset_for_tests()
    torch_telemetry.reset_for_tests()
    reset_planes()
    jax_sanitizer.reset_for_tests()
    torch_sanitizer.reset_for_tests()
    jax_faults.refresh_faults()
    torch_faults.refresh_faults()
    del jax_materialized_cache._PUBLISH_LISTENERS[:]
    del torch_materialized_cache._PUBLISH_LISTENERS[:]


def _cache_leftovers():
    """What of either package's fault arming or decoded-cache state is
    still set."""
    found = {}
    for pkg, faults, telemetry in (('jax', jax_faults, jax_telemetry),
                                   ('port', torch_faults, torch_telemetry)):
        if faults.ARMED is not None:
            found['%s faults.ARMED' % pkg] = faults.ARMED.spec
        degraded = {k: v for k, v in
                    telemetry.get_registry().gauges_with_prefix(DEGRADED_GAUGE).items() if v}
        if degraded:
            found['%s degraded gauge' % pkg] = degraded
    return found


def plane_leftovers():
    """What of either package's readahead plane or staging autotuner a test
    left behind: live managers, the port's fetch threads, the depth and
    decoder-thread overrides, and autotuners holding an override."""
    found = {}
    if _live_default_group():
        found['torch.distributed default process group'] = 'initialized'
    port_managers = torch_readahead.live_manager_count()
    if port_managers:
        found['port readahead managers'] = port_managers
    jax_open = [m for m in list(jax_readahead._live_managers) if not m._closed]
    if jax_open:
        found['jax readahead managers not closed'] = len(jax_open)
    threads = [t.name for t in threading.enumerate()
               if t.name.startswith(torch_readahead.THREAD_PREFIX)]
    if threads:
        found['port readahead threads'] = threads
    for pkg, readahead, codecs in (('jax', jax_readahead, jax_codecs),
                                   ('port', torch_readahead, torch_codecs)):
        if readahead._depth_override is not None:
            found['%s readahead depth override' % pkg] = readahead._depth_override
        if codecs._DECODER_THREADS_OVERRIDE is not None:
            found['%s decoder-thread override' % pkg] = codecs._DECODER_THREADS_OVERRIDE
    for pkg, autotune in _autotune_modules():
        owners = [o for o in (autotune._override_owner, autotune._readahead_owner)
                  if o is not None]
        if owners:
            found['%s autotune owners' % pkg] = owners
    return found


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
        'jax sanitizer._enabled': jax_sanitizer._enabled,
        'jax sanitizer violations': jax_sanitizer.violations(),
        'port sanitizer._enabled': torch_sanitizer._enabled,
        'port sanitizer violations': torch_sanitizer.violations(),
        'SIGUSR1 handler': signal.getsignal(signal.SIGUSR1),
        'PETASTORM_TPU_* environment': {k: v for k, v in os.environ.items()
                                        if k.startswith('PETASTORM_TPU_')},
    }


#: seconds a guard's teardown polls ``plane_leftovers()`` before it charges
#: the test: a loader's staging thread releases its tuner and its
#: decoder-thread override after ``stop()``
PLANE_RELEASE_WAIT_S = 5.0


def _note_inherited(request, found):
    """Record, on the test's report, what of the planes an earlier test in
    this process left behind: the guard resets it and does not charge the
    test for it."""
    if found:
        request.node.user_properties.append(('inherited plane state', repr(found)))


def settled_plane_leftovers(wait_s=PLANE_RELEASE_WAIT_S):
    """:func:`plane_leftovers`, polled until it is empty or ``wait_s``
    seconds have passed."""
    deadline = time.monotonic() + wait_s
    found = plane_leftovers()
    while found and time.monotonic() < deadline:
        time.sleep(0.02)
        found = plane_leftovers()
    return found


def guarded_planes(wait_s=PLANE_RELEASE_WAIT_S):
    """``plane_guard``'s body as a generator: at setup it takes what an
    earlier test left (yielded to the caller as inherited) and resets both
    planes; at teardown it polls for up to ``wait_s`` seconds, resets, and
    fails when what the test itself left is still there."""
    inherited = plane_leftovers()
    reset_planes()
    yield inherited
    planes = settled_plane_leftovers(wait_s)
    reset_planes()
    assert not planes, 'readahead or autotune state left behind: %s' % planes


@pytest.fixture(autouse=True)
def telemetry_guard(request):
    _note_inherited(request, plane_leftovers())
    reset_both()
    before = _global_state()
    yield
    listeners = {pkg: list(module._PUBLISH_LISTENERS)
                 for pkg, module in (('jax', jax_materialized_cache),
                                     ('port', torch_materialized_cache))
                 if module._PUBLISH_LISTENERS}
    planes = settled_plane_leftovers()
    reset_both()
    assert not planes, 'readahead or autotune state left behind: %s' % planes
    assert not listeners, 'decoded-cache publish listeners left registered: %s' % listeners
    leftovers = _cache_leftovers()
    assert not leftovers, 'fault arming or decoded-cache state left behind: %s' % leftovers
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


@pytest.fixture(autouse=True)
def plane_guard(request):
    """The guard's readahead and autotune check alone, for the port's test
    files that need nothing else of this module: it fails a test that
    leaves a manager, a fetch thread, an override or an owner behind, and
    resets both planes either way. What an earlier test left is reset at
    setup and recorded, not charged (:func:`guarded_planes`)."""
    guard = guarded_planes()
    _note_inherited(request, next(guard))
    yield
    next(guard, None)


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
