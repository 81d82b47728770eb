"""Telemetry: metrics registry, per-stage spans and the two stall wait
clocks (counterpart of ``petastorm_tpu/telemetry``, slimmed to what the
port's read path records). Tracing, exporters, stall attribution windows,
the observability server, critical path, SLOs and the flight recorder
wait for their roadmap item."""

from petastorm_tpu_torch.telemetry import knobs  # noqa: F401
from petastorm_tpu_torch.telemetry.names import STAGES  # noqa: F401
from petastorm_tpu_torch.telemetry.registry import (  # noqa: F401
    Counter, Histogram, MetricsRegistry, get_registry, reset_registry,
)
from petastorm_tpu_torch.telemetry.spans import (  # noqa: F401
    metrics_disabled, refresh_enabled, span,
)

#: registry counters the wait clocks accumulate into (seconds)
STALL_PRODUCER_WAIT = 'petastorm_tpu_stall_producer_wait_seconds_total'
STALL_CONSUMER_WAIT = 'petastorm_tpu_stall_consumer_wait_seconds_total'

#: registry counters of fused decode: rows and decoded bytes written
#: straight into staging buffers, and declines by ``reason``
FUSED_ROWS = 'petastorm_tpu_fused_decode_rows_total'
FUSED_BYTES = 'petastorm_tpu_fused_decode_bytes_total'
FUSED_FALLBACKS = 'petastorm_tpu_fused_decode_fallbacks_total'

#: waits shorter than this are scheduling noise, not stalls
STALL_NOTE_FLOOR_S = 0.001


def note_producer_wait(seconds):
    """Producer blocked pushing toward the consumer (the consumer is slow)."""
    if seconds > 0.0 and not metrics_disabled():
        get_registry().counter(STALL_PRODUCER_WAIT).inc(seconds)


def note_consumer_wait(seconds):
    """Consumer blocked waiting for data (the producer is slow)."""
    if seconds > 0.0 and not metrics_disabled():
        get_registry().counter(STALL_CONSUMER_WAIT).inc(seconds)
