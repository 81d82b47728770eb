"""Per-item tracing: trace contexts, activation, dump hooks (counterpart
of ``petastorm_tpu/telemetry/tracing.py``).

With ``PETASTORM_TPU_TRACE=1`` the ventilator mints a
:class:`TraceContext` (trace id, item sequence, epoch, shard) for every
sampled work item and hands it to the pool as the reserved ``_trace_ctx``
kwarg (:data:`TRACE_CTX_KEY`); the pool strips it and runs the worker
inside :func:`attempt`, so the worker's stage spans land on the item's
timeline. The consumer re-derives the context of each result it pulls
(:func:`ctx_for`: sampling is deterministic on the item sequence and the
trace id is arithmetic over the process run id), so ``queue_wait`` and
the loader's staging spans join the same trace with nothing added to the
result path. Every event goes to the process's flight recorder
(:mod:`~petastorm_tpu_torch.telemetry.recorder`); :func:`dump_trace`
exports it as Chrome trace-event JSON.

Off (the default), :func:`mint` is one cached-boolean check returning
None, :func:`activate`/:func:`attempt` on a None context return a shared
do-nothing singleton, and the spans never see a trace hook. Sampling:
``PETASTORM_TPU_TRACE_SAMPLE=1/N`` (or ``N``) traces every item whose
sequence number is a multiple of N.
"""

import atexit
import collections
import logging
import os
import threading
import time
import uuid

from petastorm_tpu_torch.telemetry import knobs, spans
from petastorm_tpu_torch.telemetry.recorder import export_chrome_trace, get_recorder

logger = logging.getLogger(__name__)

#: reserved kwarg the ventilator injects into sampled work items and every
#: pool strips (and activates) before calling ``worker.process``
TRACE_CTX_KEY = '_trace_ctx'

TraceContext = collections.namedtuple(
    'TraceContext', ('trace_id', 'item_seq', 'epoch', 'shard'))

# knob caches (refresh_trace() re-reads); None = not yet resolved
_enabled = None
_stride = None
# per-process run id, part of every trace id: two readers (or a rerun) in
# one process never collide
_run_id = uuid.uuid4().hex[:8]

_state = threading.local()     # .ctx / .track of the active item, if any


def trace_enabled():
    """True when ``PETASTORM_TPU_TRACE`` turns per-item tracing on."""
    global _enabled
    if _enabled is None:
        _enabled = knobs.is_enabled('PETASTORM_TPU_TRACE')
        if _enabled:
            _install_dump_hooks()
    return _enabled


def sample_stride():
    """N of ``PETASTORM_TPU_TRACE_SAMPLE=1/N`` (a plain ``N`` too): every
    N-th item is traced. Default 1 (every item)."""
    global _stride
    if _stride is None:
        raw = knobs.get_str('PETASTORM_TPU_TRACE_SAMPLE')
        stride = 1
        if raw:
            try:
                stride = int(raw.split('/', 1)[1] if '/' in raw else raw)
            except ValueError:
                logger.warning('Unparseable PETASTORM_TPU_TRACE_SAMPLE=%r; '
                               'tracing every item', raw)
            stride = max(stride, 1)
        _stride = stride
    return _stride


def refresh_trace():
    """Re-read every trace knob; part of
    :func:`petastorm_tpu_torch.telemetry.refresh`."""
    global _enabled, _stride, _autodump_fired, _autodump_last_check
    _enabled = None
    _stride = None
    _autodump_fired = False
    _autodump_last_check = 0.0
    spans.set_trace_hook(None)
    # refresh() is a main-thread call in real entry points: the chance to
    # arm the SIGUSR1/atexit dump hooks for a just-set dump path
    _install_dump_hooks()


def _reset_for_tests():
    """Fresh run id, knob caches and thread state; the span hook off."""
    global _run_id
    refresh_trace()
    _run_id = uuid.uuid4().hex[:8]
    _state.ctx = None
    _state.track = None


# -- context mint / rederivation ---------------------------------------------


def _trace_id(item_seq, epoch):
    return '%s-e%s-i%s' % (_run_id, 0 if epoch is None else epoch, item_seq)


def mint(item_seq, epoch=None, shard=None):
    """Trace context for one ventilated item, or None when tracing is off
    or the item is not sampled."""
    if not trace_enabled():
        return None
    if item_seq % sample_stride():
        return None
    return TraceContext(_trace_id(item_seq, epoch), item_seq, epoch, shard)


def ctx_for(item_seq, epoch=None, shard=None):
    """The context :func:`mint` gave ``item_seq`` in this process, or
    None: how the consumer tags its events with the ventilator's trace."""
    if item_seq is None:
        return None
    return mint(item_seq, epoch, shard)


def current_context():
    return getattr(_state, 'ctx', None)


# -- activation ---------------------------------------------------------------


class _NoopActivation:
    """Shared do-nothing context manager for untraced items."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        return False


_NOOP_ACTIVATION = _NoopActivation()


class _Activation:
    __slots__ = ('_ctx', '_track', '_prev')

    def __init__(self, ctx, track):
        self._ctx = ctx
        self._track = track

    def __enter__(self):
        self._prev = (getattr(_state, 'ctx', None), getattr(_state, 'track', None))
        _state.ctx = self._ctx
        _state.track = self._track if self._track is not None else self._prev[1]
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        _state.ctx, _state.track = self._prev
        return False


class _Attempt(_Activation):
    """Activation that also records one ``attempt`` complete event, the
    worker's span over the whole ``worker.process`` call."""

    __slots__ = ('_t0',)

    def __enter__(self):
        super().__enter__()
        self._t0 = time.time()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        dur = time.time() - self._t0
        ctx, track = self._ctx, _state.track
        super().__exit__(exc_type, exc_val, exc_tb)
        record_complete('attempt', self._t0, dur, ctx, track, worker=track,
                        error=exc_type.__name__ if exc_type else None)
        return False


def activate(ctx, track=None):
    """Make ``ctx`` the thread's active trace context for the block: stage
    spans inside it record events on its trace, on ``track``. A None
    ``ctx`` returns a shared no-op."""
    if ctx is None:
        return _NOOP_ACTIVATION
    _ensure_span_hook()
    return _Activation(ctx, track)


def attempt(ctx, worker_label):
    """:func:`activate` plus an ``attempt`` event over the block, what
    every pool wraps ``worker.process`` in; ``worker_label`` is the
    track."""
    if ctx is None:
        return _NOOP_ACTIVATION
    _ensure_span_hook()
    return _Attempt(ctx, worker_label)


# -- event recording ----------------------------------------------------------


def _ctx_args(ctx, extra):
    args = {'trace_id': ctx.trace_id, 'item': ctx.item_seq}
    if ctx.epoch is not None:
        args['epoch'] = ctx.epoch
    if ctx.shard is not None:
        args['shard'] = ctx.shard
    for key, value in extra.items():
        if value is not None:
            args[key] = value
    return args


def record_complete(name, wall_start, dur_s, ctx=None, track=None, **extra):
    """One Chrome 'X' (complete) event on ``ctx``'s trace (default: the
    active one); ``wall_start`` is ``time.time()`` at its start. No-op
    without a context."""
    ctx = ctx if ctx is not None else current_context()
    if ctx is None:
        return
    if track is None:
        track = getattr(_state, 'track', None) or 'main'
    get_recorder().add({
        'name': name, 'ph': 'X', 'cat': 'petastorm_tpu',
        'ts': wall_start * 1e6, 'dur': dur_s * 1e6,
        'pid': os.getpid(), 'tid': track,
        'args': _ctx_args(ctx, extra),
    })


def record_instant(name, ctx, track, **extra):
    """One Chrome 'i' (instant) event on ``ctx``'s trace."""
    if ctx is None:
        return
    get_recorder().add({
        'name': name, 'ph': 'i', 's': 'p', 'cat': 'petastorm_tpu',
        'ts': time.time() * 1e6,
        'pid': os.getpid(), 'tid': track,
        'args': _ctx_args(ctx, extra),
    })


def _span_trace_hook(stage, elapsed_s):
    """The spans' hook while a context is active in this process: every
    stage span inside an activation also lands a trace event."""
    ctx = getattr(_state, 'ctx', None)
    if ctx is None:
        return
    record_complete(stage, time.time() - elapsed_s, elapsed_s, ctx)


def _ensure_span_hook():
    if spans._trace_hook is None:
        spans.set_trace_hook(_span_trace_hook)


# -- dumps --------------------------------------------------------------------


def dump_trace(path):
    """Export the process-wide flight recorder as Chrome trace-event JSON
    at ``path``. Returns the event count."""
    count = export_chrome_trace(path)
    logger.info('Wrote %d trace event(s) to %s', count, path)
    return count


def _dump_path():
    return knobs.get_str('PETASTORM_TPU_TRACE_DUMP') or None


_atexit_installed = False
_signal_installed = False
_autodump_fired = False
_autodump_last_check = 0.0


def _dump_if_any(signum=None, frame=None):
    path = _dump_path()
    if path and len(get_recorder()):
        try:
            dump_trace(path)
        except Exception:  # noqa: BLE001 - a dump must never crash the run
            logger.warning('Trace dump to %s failed', path, exc_info=True)


def _install_dump_hooks():
    """Armed when ``PETASTORM_TPU_TRACE_DUMP`` names a path: an ``atexit``
    dump and a SIGUSR1 handler (``kill -USR1 <pid>`` dumps a live run).
    A signal handler installs only from the main thread, so this runs at
    import and again from :func:`refresh_trace`; the knob is meant to be
    set before the process starts."""
    global _atexit_installed, _signal_installed
    if _dump_path() is None:
        return
    if not _atexit_installed:
        _atexit_installed = True
        atexit.register(_dump_if_any)
    if not _signal_installed:
        try:
            import signal
            signal.signal(signal.SIGUSR1, _dump_if_any)
            _signal_installed = True
        except (ValueError, OSError, AttributeError):
            # not the main thread, or no SIGUSR1 here: the atexit dump
            # still fires; a later main-thread refresh retries
            logger.debug('SIGUSR1 trace-dump handler not installed yet')


_install_dump_hooks()


def autodump_windows():
    return knobs.get_int('PETASTORM_TPU_TRACE_AUTODUMP_WINDOWS', 6, floor=1)


def maybe_autodump():
    """Dump the flight recorder once when the stall attributor has flagged
    ``PETASTORM_TPU_TRACE_AUTODUMP_WINDOWS`` (default 6) consecutive
    producer-bound windows: the "my GPU is idle" trace, captured from
    inside the run. Armed only while tracing is on and
    ``PETASTORM_TPU_TRACE_DUMP`` names a path; at most one windows scan a
    second. Called from the reader's pull path."""
    global _autodump_fired, _autodump_last_check
    if _autodump_fired or not trace_enabled():
        return False
    path = _dump_path()
    if path is None:
        return False
    now = time.monotonic()
    if now - _autodump_last_check < 1.0:
        return False
    _autodump_last_check = now
    from petastorm_tpu_torch.telemetry.stall import PRODUCER_BOUND, get_attributor
    need = autodump_windows()
    windows = get_attributor().windows(include_current=False)[-need:]
    if len(windows) < need or any(w['verdict'] != PRODUCER_BOUND for w in windows):
        return False
    _autodump_fired = True
    logger.warning('%d consecutive producer-bound windows: auto-dumping the '
                   'trace to %s (the input pipeline starves the consumer)', need, path)
    try:
        dump_trace(path)
    except Exception:  # noqa: BLE001 - telemetry is advisory
        logger.warning('Trace auto-dump to %s failed', path, exc_info=True)
    return True
