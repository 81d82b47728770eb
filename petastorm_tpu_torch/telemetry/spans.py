"""Per-stage timing spans (counterpart of
``petastorm_tpu/telemetry/spans.py``).

``with span('decode'): ...`` accumulates into the process-wide registry:
``petastorm_tpu_stage_seconds_total{stage=...}``,
``petastorm_tpu_stage_calls_total{stage=...}`` and
``petastorm_tpu_stage_duration_seconds{stage=...}``.
``PETASTORM_TPU_METRICS=0`` makes every span a shared no-op. While a
trace context is active in the process, each span's exit is also offered
to the trace hook (:mod:`~petastorm_tpu_torch.telemetry.tracing`).
"""

import time

from petastorm_tpu_torch.telemetry import knobs
from petastorm_tpu_torch.telemetry.registry import get_registry, on_registry_reset

STAGE_SECONDS = 'petastorm_tpu_stage_seconds_total'
STAGE_CALLS = 'petastorm_tpu_stage_calls_total'
STAGE_DURATION = 'petastorm_tpu_stage_duration_seconds'

# resolved once; refresh_enabled() re-reads
_disabled = None


def metrics_disabled():
    """True when ``PETASTORM_TPU_METRICS`` disables telemetry."""
    global _disabled
    if _disabled is None:
        _disabled = knobs.is_disabled('PETASTORM_TPU_METRICS')
    return _disabled


def refresh_enabled():
    """Re-read ``PETASTORM_TPU_METRICS``."""
    global _disabled
    _disabled = None
    _stage_cache.clear()


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        return False


_NOOP_SPAN = _NoopSpan()

# None until tracing activates a context in this process; then every span
# exit also hands ``(stage, elapsed)`` to it. Off, the span pays one
# module-global None check.
_trace_hook = None


def set_trace_hook(hook):
    global _trace_hook
    _trace_hook = hook


# stage -> (seconds counter, calls counter, duration histogram)
_stage_cache = {}
on_registry_reset(_stage_cache.clear)


def _stage_metrics(stage):
    metrics = _stage_cache.get(stage)
    if metrics is None:
        registry = get_registry()
        metrics = (registry.counter(STAGE_SECONDS, stage=stage),
                   registry.counter(STAGE_CALLS, stage=stage),
                   registry.histogram(STAGE_DURATION, stage=stage))
        _stage_cache[stage] = metrics
    return metrics


class _Span:
    __slots__ = ('_stage', '_metrics', '_t0')

    def __init__(self, stage, metrics):
        self._stage = stage
        self._metrics = metrics

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        elapsed = time.perf_counter() - self._t0
        seconds, calls, duration = self._metrics
        seconds.inc(elapsed)
        calls.inc()
        duration.observe(elapsed)
        if _trace_hook is not None:
            _trace_hook(self._stage, elapsed)
        return False


def span(stage):
    """Context manager timing one ``stage`` occurrence."""
    if metrics_disabled():
        return _NOOP_SPAN
    return _Span(stage, _stage_metrics(stage))
