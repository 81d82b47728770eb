"""The naming contracts the port records under: canonical stage names,
trace-event names, metric series, fault-injection sites, anomaly kinds,
environment knobs and the pipesan borrow registry.

The port keeps its own copy of ``petastorm_tpu/analysis/contracts.py``
(it imports nothing of the JAX package), so its spans and series read the
same as the reference's. This module is the port's one registry: the
runtime (telemetry, the knob reader, :mod:`petastorm_tpu_torch.sanitizer`)
imports it, and the analyzer (:mod:`petastorm_tpu_torch.analysis`) reads
the same objects through ``analysis/contracts.py`` — one source of truth,
enforced from both sides. It imports nothing.
"""

#: pipeline stages the port records, ventilator → device:
#: ``ventilate`` hand item to pool · ``io`` parquet row-group read ·
#: ``decode`` codec decode · ``filter`` predicate mask over a row-group ·
#: ``late_materialize`` decode of the predicate's survivors only ·
#: ``rowgroup_prune`` footer-statistics planner at Reader construction ·
#: ``transform`` TransformSpec · ``cache_hit_read`` a decoded-cache entry
#: mapped back · ``cache_fill`` a decoded-cache entry published ·
#: ``queue_wait``
#: consumer blocked pulling · ``collate`` re-batch/shuffle buffer ·
#: ``h2d_ready`` staging ring blocked until a slot's previous transfer
#: completed · ``stage_fill`` cast/pad/mask copy into the slot ·
#: ``decode_fused`` encoded image cells decoded straight into the slot's
#: rows · ``h2d_dispatch`` async transfer dispatch · ``pack`` mixture
#: documents packed into fixed rows · ``encode`` write-path codec encode ·
#: ``write_flush`` one row-group flushed into a part file · ``compact`` one
#: compaction fold of small part files into one · ``autotune`` one
#: staging-autotuner tick (registry snapshot, window close, policy) ·
#: ``readahead_fetch`` one coalesced prefetch of an upcoming row-group's
#: column chunks on a readahead fetch thread
STAGES = ('ventilate', 'io', 'decode', 'filter', 'late_materialize', 'rowgroup_prune',
          'transform', 'cache_hit_read', 'cache_fill', 'queue_wait', 'collate', 'h2d_ready',
          'stage_fill', 'decode_fused', 'h2d_dispatch', 'pack', 'encode', 'write_flush',
          'compact', 'autotune', 'readahead_fetch')

#: trace-event names the port records outside the stage spans (the
#: reference's set, limited to what the port records): ``attempt`` one
#: worker-side processing of one item · ``ventilate`` the ventilator's
#: stage span · ``mixture_pull`` one source-reader pull of the mixture
#: engine, on that source's ``mixture-src-<i>`` track ·
#: ``autotune_decision`` one staging-autotuner adjustment, an instant on
#: the ``autotuner`` track
EVENT_NAMES = frozenset(['attempt', 'ventilate', 'mixture_pull', 'autotune_decision'])

#: prefix of every operator-facing environment knob
KNOB_PREFIX = 'PETASTORM_TPU_'

#: environment knobs the port reads (the native decoders read the two
#: ``JPEG`` ones in C)
KNOWN_KNOBS = frozenset([
    'PETASTORM_TPU_DECODED_CACHE',
    'PETASTORM_TPU_DECODED_CACHE_DIR',
    'PETASTORM_TPU_DECODED_CACHE_DISK_MB',
    'PETASTORM_TPU_DECODED_CACHE_MEM_MB',
    'PETASTORM_TPU_FAULTS',
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
    'PETASTORM_TPU_READAHEAD',
    'PETASTORM_TPU_READAHEAD_DEPTH',
    'PETASTORM_TPU_READAHEAD_GAP_KB',
    'PETASTORM_TPU_READAHEAD_MAX_DEPTH',
    'PETASTORM_TPU_READAHEAD_MAX_RANGE_MB',
    'PETASTORM_TPU_READAHEAD_POOL_MB',
    'PETASTORM_TPU_READAHEAD_THREADS',
    'PETASTORM_TPU_SANITIZE',
    'PETASTORM_TPU_SLO',
    'PETASTORM_TPU_STAGING',
    'PETASTORM_TPU_STAGING_AUTOTUNE',
    'PETASTORM_TPU_STAGING_AUTOTUNE_MAX_PREFETCH',
    'PETASTORM_TPU_STAGING_AUTOTUNE_MAX_SLOTS',
    'PETASTORM_TPU_STAGING_AUTOTUNE_WINDOW_SEC',
    'PETASTORM_TPU_STAGING_SLOTS',
    'PETASTORM_TPU_TRACE',
    'PETASTORM_TPU_TRACE_AUTODUMP_WINDOWS',
    'PETASTORM_TPU_TRACE_DUMP',
    'PETASTORM_TPU_TRACE_SAMPLE',
    'PETASTORM_TPU_WRITE_ROWGROUP_MB',
    'PETASTORM_TPU_WRITE_SELF_CHECK',
    'PETASTORM_TPU_WRITE_SHARD_ROWS',
    'PETASTORM_TPU_WRITE_WORKERS',
    'PETASTORM_TPU_COMPACT_MIN_FILES',
    'PETASTORM_TPU_COMPACT_TARGET_MB',
])

#: every metric series name — the registry namespace (``petastorm_tpu_*``):
#: the reference's set verbatim (series the port does not record yet
#: included, so a dashboard reads both packages alike) plus the port's
#: two native-decoder counters. The canonical-name analysis pass holds
#: every ``registry.counter/gauge/histogram`` call in the port to this set.
METRIC_NAMES = frozenset([
    # stage spans (telemetry/spans.py)
    'petastorm_tpu_stage_seconds_total',
    'petastorm_tpu_stage_calls_total',
    'petastorm_tpu_stage_duration_seconds',
    # stall wait clocks (telemetry/__init__.py)
    'petastorm_tpu_stall_producer_wait_seconds_total',
    'petastorm_tpu_stall_consumer_wait_seconds_total',
    # staging arena (jax/staging.py)
    'petastorm_tpu_h2d_bytes_total',
    # staging autotuner (jax/autotune.py)
    'petastorm_tpu_staging_autotune_decisions_total',
    # row-group cache (cache.py)
    'petastorm_tpu_cache_hits_total',
    'petastorm_tpu_cache_misses_total',
    'petastorm_tpu_cache_evictions_total',
    'petastorm_tpu_cache_bytes_written_total',
    'petastorm_tpu_cache_bytes_evicted_total',
    'petastorm_tpu_cache_size_bytes',
    # materialized decoded-row-group cache (materialized_cache.py)
    'petastorm_tpu_decoded_cache_hits_total',
    'petastorm_tpu_decoded_cache_misses_total',
    'petastorm_tpu_decoded_cache_mem_hits_total',
    'petastorm_tpu_decoded_cache_evictions_total',
    'petastorm_tpu_decoded_cache_bytes_written_total',
    'petastorm_tpu_decoded_cache_bytes_read_total',
    'petastorm_tpu_decoded_cache_mmap_reads_total',
    'petastorm_tpu_decoded_cache_copy_reads_total',
    'petastorm_tpu_decoded_cache_size_bytes',
    # disaggregated-service fleet health (service/dispatcher.py)
    'petastorm_tpu_service_reventilated_total',
    'petastorm_tpu_service_duplicate_done_total',
    'petastorm_tpu_service_workers_alive',
    'petastorm_tpu_service_workers_registered',
    'petastorm_tpu_service_items_pending',
    'petastorm_tpu_service_items_assigned',
    # failure-domain hardening (service/dispatcher.py, faults.py,
    # telemetry/__init__.py)
    'petastorm_tpu_service_retries_total',
    'petastorm_tpu_service_items_poisoned_total',
    # standing decode service (service/daemon.py + supervisor.py)
    'petastorm_tpu_service_jobs_active',
    'petastorm_tpu_service_workers_spawned_total',
    'petastorm_tpu_service_workers_released_total',
    'petastorm_tpu_service_breaker_open',
    # highly-available decode service: warm-standby failover, QoS
    # preemption, cache-aware placement (service/standby.py +
    # dispatcher.py)
    'petastorm_tpu_service_failovers_total',
    'petastorm_tpu_service_replication_lag_seconds',
    'petastorm_tpu_service_preemptions_total',
    'petastorm_tpu_service_placement_hits_total',
    'petastorm_tpu_service_placement_misses_total',
    'petastorm_tpu_swallowed_errors_total',
    'petastorm_tpu_faults_injected_total',
    # decoded-cache failure domain (materialized_cache.py)
    'petastorm_tpu_decoded_cache_disk_failures_total',
    'petastorm_tpu_decoded_cache_degraded',
    # pipesan runtime zero-copy sanitizer (sanitizer.py)
    'petastorm_tpu_sanitizer_violations_total',
    'petastorm_tpu_sanitizer_views_guarded_total',
    'petastorm_tpu_sanitizer_canary_checks_total',
    # fused batch-native decode (fused.py / jax/staging.py)
    'petastorm_tpu_fused_decode_rows_total',
    'petastorm_tpu_fused_decode_bytes_total',
    'petastorm_tpu_fused_decode_fallbacks_total',
    # live observability plane (telemetry/timeseries.py + obs_server.py)
    'petastorm_tpu_anomaly_events_total',
    'petastorm_tpu_obs_windows_total',
    'petastorm_tpu_obs_scrapes_total',
    # query-shaped reads: statistics pruning + late materialization
    # (pushdown.py, arrow_worker.py, materialized_cache.py)
    'petastorm_tpu_rowgroups_pruned_total',
    'petastorm_tpu_rows_pruned_total',
    'petastorm_tpu_late_materialized_rows_total',
    'petastorm_tpu_decoded_cache_skipped_total',
    # wire-speed I/O plane: coalesced column-chunk readahead
    # (readahead.py)
    'petastorm_tpu_readahead_hits_total',
    'petastorm_tpu_readahead_misses_total',
    'petastorm_tpu_readahead_bytes_total',
    'petastorm_tpu_readahead_coalesced_reads_total',
    'petastorm_tpu_readahead_degraded_total',
    'petastorm_tpu_readahead_pool_bytes',
    # streaming mixture engine: deterministic mixing + sequence packing
    # (mixture/engine.py, mixture/packing.py)
    'petastorm_tpu_mixture_docs_total',
    'petastorm_tpu_pack_rows_total',
    'petastorm_tpu_pack_tokens_total',
    'petastorm_tpu_pack_padding_tokens_total',
    'petastorm_tpu_pack_split_docs_total',
    # distributed write plane: fleet-ETL writer, compaction, append
    # (write/writer.py, write/compact.py, write/manifest.py)
    'petastorm_tpu_write_rows_total',
    'petastorm_tpu_write_bytes_total',
    'petastorm_tpu_write_files_total',
    'petastorm_tpu_write_commits_total',
    'petastorm_tpu_write_manifest_generation',
    'petastorm_tpu_compact_runs_total',
    'petastorm_tpu_compact_files_folded_total',
    # bounded-staleness append reads (write/append.py): observed lag
    # between the latest committed manifest and the follower's delivery
    'petastorm_tpu_append_staleness_s',
    # fleet-wide decoded-cache tier: peer-served entries
    # (service/peer_cache.py + dispatcher.py). Hits/bytes count
    # successful peer fetches on the FETCHING worker; misses carry the
    # degrade reason (no_holder, peer_miss, timeout, budget, corrupt,
    # injected, send) — every miss decodes locally, never errors;
    # evict_hints counts the dispatcher's advisory global-LRU hints
    'petastorm_tpu_peer_cache_hits_total',
    'petastorm_tpu_peer_cache_misses_total',
    'petastorm_tpu_peer_cache_bytes_total',
    'petastorm_tpu_peer_cache_evict_hints_total',
    # SLO plane (telemetry/slo.py): per-target breach windows + the
    # error budget left in the long burn window (1.0 = untouched)
    'petastorm_tpu_slo_breach_windows_total',
    'petastorm_tpu_slo_budget_remaining',
    # critical-path engine (telemetry/critpath.py): decision-quality
    # cross-check against the staging autotuner (verdict=agree|disagree)
    'petastorm_tpu_critpath_agreement_total',
    # the port's host decoders (native/__init__.py): libraries that failed
    # to build, and cells decoded natively, each by ``library``
    'petastorm_tpu_native_build_failures_total',
    'petastorm_tpu_native_decoded_cells_total',
])

#: every registered fault-injection site, mapped to a one-line
#: description of the seam it sits on (the reference's table verbatim;
#: :mod:`petastorm_tpu_torch.faults` arms them). The
#: ``faultpoint`` analysis pass holds every ``fault_hit()`` literal in
#: the port to this set. ``drop`` is only meaningful at the message-send
#: sites; the data-path sites take the error/oserror/delay modes.
FAULTPOINTS = {
    'io.read': 'parquet row-group read (arrow_worker._load_rowgroup), '
               'the pushdown planner\'s footer-statistics fetch '
               '(pushdown.StatsIndex, keys end in #footer — a footer '
               'fault degrades to unpruned reads, never a wrong answer) '
               'and the readahead plane\'s prefetch reads (readahead.py, '
               'keys end in #readahead — a fetch fault degrades to the '
               'worker\'s blocking read, counted in '
               'petastorm_tpu_readahead_degraded_total)',
    'decode.rowgroup': 'whole row-group decode, incl. the native batch '
                       'decoders (arrow_worker._load_rowgroup)',
    'decode.batch': 'one column batch decode (codecs.'
                    'decode_batch_with_nulls; fused + per-cell paths)',
    'cache.read': 'decoded-cache entry open/mmap (materialized_cache)',
    'cache.write': 'decoded-cache entry publish (materialized_cache)',
    'zmq.recv': 'dispatcher inbound message (drop = lose the frame)',
    'zmq.work': 'dispatcher WORK send (drop = assignment lost in '
                'flight; the consumer-read deadline is the backstop)',
    'zmq.done': 'worker DONE/ERROR send (drop = completion lost)',
    'zmq.heartbeat': 'worker heartbeat send (drop = dispatcher sees a '
                     'lapse and re-ventilates)',
    'zmq.stop': 'dispatcher STOP broadcast (drop = dispatcher dies '
                'without goodbye — the restart/reconnect drill)',
    'staging.h2d': 'staging-arena host->device dispatch (jax/staging)',
    'service.spawn': 'supervisor worker-server process spawn '
                     '(service/supervisor.py; error = the spawn fails, '
                     'feeding the crash-loop circuit breaker — the '
                     'breaker drill without burning real processes)',
    'zmq.replicate': 'the standby replication stream, checked at BOTH '
                     'ends (dispatcher SSTATE send, standby receive; '
                     'drop = the snapshot is lost in flight — sustained, '
                     'the standby\'s mirror goes stale and a later '
                     'promotion is COLD: clients re-register from '
                     'scratch, still exactly-once)',
    'service.promote': 'a standby\'s promotion attempt (service/'
                       'standby.py; error = the attempt fails and is '
                       'retried with backoff inside the promote window '
                       '— the failover drill\'s knob for prolonging the '
                       'blackout deterministically)',
    'zmq.peer_serve': 'a peer-cache serve reply (service/peer_cache.py '
                      'server side; drop = the holding worker never '
                      'answers and the fetcher times out into local '
                      'decode — the peer-loss drill without killing a '
                      'process; error = the serve fails mid-read)',
    'zmq.peer_fetch': 'a peer-cache fetch attempt (service/peer_cache.py '
                      'client side, hit before the request is sent; '
                      'error/drop = the fetch fails and the worker '
                      'degrades to local decode, counted in '
                      'petastorm_tpu_peer_cache_misses_total'
                      '{reason=injected} — never a wrong answer)',
    'io.write': 'the distributed write plane\'s publication seams '
                '(write/writer.py, write/compact.py, write/manifest.py):'
                ' part-file data write/close (keys end in #part), the '
                'tmp->final rename that publishes a part file (keys end '
                'in #rename) and the atomic manifest swap that commits '
                'a generation (keys end in #manifest). A fault before '
                'the rename leaves only an invisible .tmp file; a fault '
                'before the manifest swap leaves the previous generation'
                ' committed — either way readers never see a torn '
                'dataset, and a retried shard republishes byte-identical'
                ' output (the crash-safety chaos drill in '
                'tests/test_write.py)',
}

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

# -- pipesan buffer-ownership contracts ---------------------------------------
#
# The zero-copy fast paths hand out BORROWED views: arrays whose memory is
# owned by someone else with a shorter (or recycled) lifetime — the
# pinned staging slots, an arrow column's encoded cells. The
# ``buffer-escape``/``buffer-write`` analysis pass
# (:mod:`petastorm_tpu_torch.analysis.pass_buffers`) taints values born from
# the sources registered here and flags them escaping their owning scope or
# being written through; the runtime sanitizer (``PETASTORM_TPU_SANITIZE=1``,
# :mod:`petastorm_tpu_torch.sanitizer`) guards the slot ring dynamically.
# One registry, checked from both sides.

#: terminal call names whose RESULT is a borrowed buffer view.
#: ``frombuffer`` over a *call expression* (``np.frombuffer(bytes(...))``,
#: ``np.frombuffer(x.encode())``) is exempt: the argument is a fresh
#: anonymous temporary whose only reference becomes the array's ``.base``,
#: so the view owns its memory by construction.
BORROW_CALLS = frozenset([
    'frombuffer',           # numpy view over someone else's buffer
    'read_entry',           # decoded-cache columns alias the entry's mmap
    '_binary_cell_views',   # cells alias the arrow column's data buffer
])

#: call names whose result is borrowed only when the given keyword is
#: passed with the given value. ``astype`` over a *call expression*
#: receiver is exempt for the same fresh-temporary reason as frombuffer.
BORROW_CALL_KWARGS = {
    'recv_multipart': ('copy', False),   # frames view ZMQ receive buffers
    'astype': ('copy', False),           # may alias the source array
}

#: dotted expressions denoting borrowed buffer collections — staging-arena
#: slot memory (recycled after the slot's next transfer retires) and a
#: deferred image column's encoded cell views (zero-copy over the arrow
#: data buffer; valid only while the column object — which carries the
#: owning arrow column — is alive). Any view over them is borrowed.
BORROW_ATTRS = frozenset([
    'slot.buffers',
    'column.cells',
    # a readahead fetch entry's pooled range buffers (readahead.py):
    # recycled when the entry's reference census drains — views over
    # them are pinned only by a served table's finalizer
    'entry.ranges',
    # the port's pinned ring slot (device/staging.py): its host tensors
    # and their numpy views, refilled once the slot's CUDA event completes
    'slot.tensors',
    'slot.views',
])

#: the ownership-transfer annotation: ``# pipesan: owns`` on (any line of)
#: a flagged statement records that the transfer is intentional and the
#: receiver owns (or knowingly borrows) the memory — always pair it with a
#: justification comment. On a ``return`` it asserts the CALLER owns the
#: result, so taint does NOT propagate — a function whose callers
#: genuinely borrow its result belongs in :data:`BORROW_CALLS` instead.
OWNS_ANNOTATION_RE = r'pipesan:\s*owns'
