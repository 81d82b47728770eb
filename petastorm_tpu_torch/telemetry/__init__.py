"""Telemetry (counterpart of ``petastorm_tpu/telemetry``, the in-process
half): the metrics registry, per-stage spans, the two stall wait clocks
and their windowed attribution, per-item tracing into a flight recorder,
the critical-path engine and the pipeline report.

* :func:`span` times one canonical stage (:data:`STAGES`) into the
  process-wide registry (:func:`get_registry`);
  ``PETASTORM_TPU_METRICS=0`` makes every span a shared no-op.
* :func:`note_producer_wait` / :func:`note_consumer_wait` feed the wait
  counters and the :class:`StallAttributor`, which classifies each window
  as producer-bound, consumer-bound or balanced.
* ``PETASTORM_TPU_TRACE=1`` traces every ventilated item
  (:mod:`~petastorm_tpu_torch.telemetry.tracing`); :func:`dump_trace`
  exports the recorder as Chrome trace-event JSON for Perfetto.
* :func:`pipeline_report` / :func:`format_pipeline_report`: per-stage
  seconds, the stall verdict, the H2D overlap share and, when traced, the
  critical path with its what-if lines; :func:`write_jsonl_snapshot` /
  :func:`read_jsonl_snapshots` (JSONL) and :func:`prometheus_text`.
* The live plane, armed by ``PETASTORM_TPU_OBS_PORT``: rollup windows
  and the anomaly detector (:mod:`~petastorm_tpu_torch.telemetry
  .timeseries`), SLO burn rates (:mod:`~petastorm_tpu_torch.telemetry
  .slo`), the HTTP endpoint (:mod:`~petastorm_tpu_torch.telemetry
  .obs_server`) and the on-disk flight log
  (:mod:`~petastorm_tpu_torch.telemetry.obslog`). Unset, none of it
  starts a thread or opens a socket.
"""

from petastorm_tpu_torch.telemetry import knobs  # noqa: F401
from petastorm_tpu_torch.telemetry.names import STAGES  # noqa: F401
from petastorm_tpu_torch.telemetry.registry import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, get_registry, reset_registry,
)
from petastorm_tpu_torch.telemetry.spans import (  # noqa: F401
    metrics_disabled, refresh_enabled, span,
)
from petastorm_tpu_torch.telemetry.stall import (  # noqa: F401
    BALANCED, CONSUMER_BOUND, PRODUCER_BOUND, StallAttributor, get_attributor,
    reset_attributor,
)
from petastorm_tpu_torch.telemetry.recorder import (  # noqa: F401
    FlightRecorder, export_chrome_trace, get_recorder, reset_recorder, slowest_items,
)
from petastorm_tpu_torch.telemetry import tracing  # noqa: F401
from petastorm_tpu_torch.telemetry.tracing import (  # noqa: F401
    TRACE_CTX_KEY, TraceContext, dump_trace, refresh_trace, trace_enabled,
)
from petastorm_tpu_torch.telemetry import critpath  # noqa: F401
from petastorm_tpu_torch.telemetry.export import (  # noqa: F401
    format_pipeline_report, pipeline_report, prometheus_text, read_jsonl_snapshots,
    write_jsonl_snapshot,
)
from petastorm_tpu_torch.telemetry import timeseries  # noqa: F401
from petastorm_tpu_torch.telemetry.timeseries import (  # noqa: F401
    AnomalyDetector, HeartbeatSummarizer, ObsCollector, WindowedRollup, recent_anomalies,
    record_anomaly,
)
from petastorm_tpu_torch.telemetry import obs_server  # noqa: F401
from petastorm_tpu_torch.telemetry import obslog  # noqa: F401
from petastorm_tpu_torch.telemetry import slo  # noqa: F401

#: registry counters the wait clocks accumulate into (seconds)
STALL_PRODUCER_WAIT = 'petastorm_tpu_stall_producer_wait_seconds_total'
STALL_CONSUMER_WAIT = 'petastorm_tpu_stall_consumer_wait_seconds_total'

#: registry counters of fused decode: rows and decoded bytes written
#: straight into staging buffers, and declines by ``reason``
FUSED_ROWS = 'petastorm_tpu_fused_decode_rows_total'
FUSED_BYTES = 'petastorm_tpu_fused_decode_bytes_total'
FUSED_FALLBACKS = 'petastorm_tpu_fused_decode_fallbacks_total'

#: every broad exception handler that deliberately carries on counts
#: itself here by ``site``, so a silent degradation still shows
SWALLOWED_ERRORS = 'petastorm_tpu_swallowed_errors_total'

#: waits shorter than this are scheduling noise, not stalls
STALL_NOTE_FLOOR_S = 0.001


def count_swallowed(site):
    """Count one deliberately swallowed failure at ``site`` (a short
    kebab-case label)."""
    if not metrics_disabled():
        get_registry().counter(SWALLOWED_ERRORS, site=site).inc()


def note_producer_wait(seconds):
    """Producer blocked pushing toward the consumer (the consumer is the
    slow side): the registry counter and the attributor."""
    if seconds <= 0.0 or metrics_disabled():
        return
    get_registry().counter(STALL_PRODUCER_WAIT).inc(seconds)
    get_attributor().note_producer_wait(seconds)


def note_consumer_wait(seconds):
    """Consumer blocked waiting for data (the producer is the slow side):
    the registry counter and the attributor."""
    if seconds <= 0.0 or metrics_disabled():
        return
    get_registry().counter(STALL_CONSUMER_WAIT).inc(seconds)
    get_attributor().note_consumer_wait(seconds)


# knob re-readers of other subsystems, so refresh() stays the one entry
# point that re-reads every cached PETASTORM_TPU_* knob
_extra_refreshers = []


def register_refresh(fn):
    """Hook a subsystem's knob-refresh function into :func:`refresh`."""
    if fn not in _extra_refreshers:
        _extra_refreshers.append(fn)


def refresh():
    """Re-read every cached knob: metrics, tracing, the sampling stride,
    the auto-dump state, and whatever :func:`register_refresh` added."""
    refresh_enabled()
    refresh_trace()
    for fn in list(_extra_refreshers):
        fn()


# the live plane's knobs (window, thresholds, SLO spec, log directory)
# are re-read through the same one entry point
register_refresh(timeseries.refresh_obs)


def reset_for_tests():
    """The live plane torn down (server, sampler, SLO policy, log
    writer), then a fresh registry, attributor and flight recorder,
    tracing's state and the planner summary cleared, knobs re-read (test
    isolation)."""
    obs_server._reset_for_tests()
    timeseries._reset_for_tests()
    slo._reset_for_tests()
    obslog._reset_for_tests()
    reset_registry()
    reset_attributor()
    reset_recorder()
    tracing._reset_for_tests()
    # lazy: pushdown imports telemetry at its module top
    from petastorm_tpu_torch import pushdown
    pushdown.reset_for_tests()
    refresh_enabled()
