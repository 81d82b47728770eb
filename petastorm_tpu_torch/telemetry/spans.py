"""Per-stage timing spans (counterpart of
``petastorm_tpu/telemetry/spans.py`` without the trace hook).

``with span('decode'): ...`` accumulates into the process-wide registry:
``petastorm_tpu_stage_seconds_total{stage=...}``,
``petastorm_tpu_stage_calls_total{stage=...}`` and
``petastorm_tpu_stage_duration_seconds{stage=...}``.
``PETASTORM_TPU_METRICS=0`` makes every span a shared no-op.
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
    __slots__ = ('_metrics', '_t0')

    def __init__(self, metrics):
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
        return False


def span(stage):
    """Context manager timing one ``stage`` occurrence."""
    if metrics_disabled():
        return _NOOP_SPAN
    return _Span(_stage_metrics(stage))
