"""The naming contracts the port records under: canonical stage names,
trace-event names, anomaly kinds and environment knobs.

The port keeps its own copy of the names it uses from
``petastorm_tpu/analysis/contracts.py`` (it imports nothing of the JAX
package), so its spans read the same as the reference's.
"""

#: pipeline stages the port records, ventilator → device:
#: ``ventilate`` hand item to pool · ``io`` parquet row-group read ·
#: ``decode`` codec decode · ``filter`` predicate mask over a row-group ·
#: ``late_materialize`` decode of the predicate's survivors only ·
#: ``rowgroup_prune`` footer-statistics planner at Reader construction ·
#: ``transform`` TransformSpec · ``queue_wait``
#: consumer blocked pulling · ``collate`` re-batch/shuffle buffer ·
#: ``h2d_ready`` staging ring blocked until a slot's previous transfer
#: completed · ``stage_fill`` cast/pad/mask copy into the slot ·
#: ``decode_fused`` encoded image cells decoded straight into the slot's
#: rows · ``h2d_dispatch`` async transfer dispatch · ``pack`` mixture
#: documents packed into fixed rows · ``encode`` write-path codec encode ·
#: ``write_flush`` one row-group flushed into a part file
STAGES = ('ventilate', 'io', 'decode', 'filter', 'late_materialize', 'rowgroup_prune',
          'transform', 'queue_wait', 'collate', 'h2d_ready', 'stage_fill', 'decode_fused',
          'h2d_dispatch', 'pack', 'encode', 'write_flush')

#: trace-event names the port records outside the stage spans (the
#: reference's set, limited to what the port records): ``attempt`` one
#: worker-side processing of one item · ``ventilate`` the ventilator's
#: stage span · ``mixture_pull`` one source-reader pull of the mixture
#: engine, on that source's ``mixture-src-<i>`` track
EVENT_NAMES = frozenset(['attempt', 'ventilate', 'mixture_pull'])

#: environment knobs the port reads (the native decoders read the two
#: ``JPEG`` ones in C)
KNOWN_KNOBS = frozenset([
    'PETASTORM_TPU_IMAGE_DECODER_THREADS',
    'PETASTORM_TPU_JPEG_DCT',
    'PETASTORM_TPU_JPEG_FANCY',
    'PETASTORM_TPU_METRICS',
    'PETASTORM_TPU_METRICS_WINDOW_S',
    'PETASTORM_TPU_MIXTURE_OPEN_BINS',
    'PETASTORM_TPU_MIXTURE_RESEQ_MAX',
    'PETASTORM_TPU_NATIVE',
    'PETASTORM_TPU_OBS_COLLAPSE_FRAC',
    'PETASTORM_TPU_OBS_FLAP_FLIPS',
    'PETASTORM_TPU_OBS_HOST',
    'PETASTORM_TPU_OBS_LOG_DIR',
    'PETASTORM_TPU_OBS_LOG_MB',
    'PETASTORM_TPU_OBS_PORT',
    'PETASTORM_TPU_OBS_SATURATED_SHARE',
    'PETASTORM_TPU_OBS_WINDOWS',
    'PETASTORM_TPU_OBS_WINDOW_SEC',
    'PETASTORM_TPU_PUSHDOWN',
    'PETASTORM_TPU_PUSHDOWN_PRUNE',
    'PETASTORM_TPU_PUSHDOWN_WORKERS',
    'PETASTORM_TPU_SLO',
    'PETASTORM_TPU_STAGING',
    'PETASTORM_TPU_STAGING_SLOTS',
    'PETASTORM_TPU_TRACE',
    'PETASTORM_TPU_TRACE_AUTODUMP_WINDOWS',
    'PETASTORM_TPU_TRACE_DUMP',
    'PETASTORM_TPU_TRACE_SAMPLE',
])

#: anomaly event kinds, mapped to the docs/troubleshoot.md runbook
#: heading that explains each one (the reference's table, verbatim): the
#: heading rides on every event as its ``runbook`` field, and
#: :func:`~petastorm_tpu_torch.telemetry.timeseries.record_anomaly`
#: refuses a kind missing here
ANOMALY_KINDS = {
    'throughput_collapse': 'Throughput collapsed mid-epoch',
    'stall_flap': 'Stall verdict flaps between producer- and '
                  'consumer-bound',
    'queue_saturated': 'My pipeline is consumer-bound — is it the '
                       'training step or the H2D link?',
    'heartbeat_gap': 'Stale decode workers after a crash',
    'h2d_starvation': 'My pipeline is consumer-bound — is it the '
                      'training step or the H2D link?',
    'row_group_poisoned': 'A row-group was quarantined '
                          '(row_group_poisoned)',
    'cache_degraded': 'The decoded cache degraded to decode-through',
    'worker_flapping': 'A worker slot is crash-looping (worker_flapping)',
    'job_lease_expired': 'A job lease expired and was reclaimed '
                         '(job_lease_expired)',
    'dispatcher_failover': 'The dispatcher failed over to its standby '
                           '(dispatcher_failover)',
    'slo_breach': 'An SLO error budget is burning too fast (slo_breach)',
}

#: knob-truthiness spellings: every on-by-default kill switch (metrics,
#: staging, native) reads the first, every off-by-default opt-in
#: (tracing) the second
DISABLED_VALUES = ('0', 'false', 'off', 'no')
ENABLED_VALUES = ('1', 'true', 'on', 'yes')
