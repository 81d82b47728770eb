"""Exporters (counterpart of ``petastorm_tpu/telemetry/export.py``): JSONL
snapshots, the Prometheus text format and the pipeline report.

The report holds per-stage seconds and calls, the stall verdict and its
windows, the staging engine's H2D overlap share, the raw ``cache`` and the
``decoded_cache`` sections (the latter with its cache-bound/decode-bound
verdict, :func:`classify_cache_phase`), the selective-read (``pushdown``)
section, the ``readahead`` plane's hits, reads and degrades, the
``pipesan`` sanitizer's findings, the ``anomalies`` the live plane
recorded, the ``staging_autotune`` decisions, the ``critical_path``
section when tracing recorded stage events, and the ``slo`` section when
``PETASTORM_TPU_SLO`` arms a policy. All three read the registry (the
process-wide one by default) and never mutate it.

The reference's other report sections read subsystems the port does not
have yet, whose counters therefore never appear here: ``service``,
``peer_cache`` and ``write``.
"""

import json
import time

from petastorm_tpu_torch.telemetry.names import STAGES
from petastorm_tpu_torch.telemetry.registry import get_registry
from petastorm_tpu_torch.telemetry.spans import STAGE_CALLS, STAGE_SECONDS

#: stall-verdict horizon in sampling windows (~30 s at the 0.5 s default):
#: recent enough that start-up and idle phases age out of the verdict
_VERDICT_WINDOWS = 60


# -- JSONL -------------------------------------------------------------------


def write_jsonl_snapshot(path_or_file, registry=None, extra=None):
    """Append one JSON line holding the registry's full state: the parsed
    line's ``counters``, ``gauges`` and ``histograms`` equal
    ``registry.snapshot()``. ``extra`` rides along under its own keys
    without overwriting those; the recorded anomaly events ride under
    ``anomalies`` when there are any."""
    registry = registry or get_registry()
    record = dict(extra or {})
    record.update(registry.snapshot())
    record.setdefault('ts', time.time())
    from petastorm_tpu_torch.telemetry import timeseries
    events = timeseries.recent_anomalies()
    if events:
        record.setdefault('anomalies', events)
    line = json.dumps(record, sort_keys=True)
    if hasattr(path_or_file, 'write'):
        path_or_file.write(line + '\n')
    else:
        with open(path_or_file, 'a') as f:
            f.write(line + '\n')


def read_jsonl_snapshots(path):
    """Every snapshot line of a JSONL metrics file, oldest first."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# -- Prometheus text format --------------------------------------------------


def _metric_families(keys):
    """Snapshot keys (``name`` or ``name{labels}``) grouped by family name,
    sorted."""
    families = {}
    for key in sorted(keys):
        families.setdefault(key.split('{', 1)[0], []).append(key)
    return families


def prometheus_text(registry=None):
    """The registry in the Prometheus text exposition format: one ``#
    TYPE`` line a family, label values escaped (the registry escapes them
    in the key), histograms as cumulative ``_bucket`` series with ``le``
    ascending through ``+Inf``, then ``_sum`` and ``_count``."""
    registry = registry or get_registry()
    snap = registry.snapshot()
    lines = []
    for kind in ('counter', 'gauge'):
        values = snap[kind + 's']
        for name, keys in _metric_families(values).items():
            lines.append('# TYPE %s %s' % (name, kind))
            lines.extend('%s %s' % (key, _fmt(values[key])) for key in keys)
    for name, keys in _metric_families(snap['histograms']).items():
        lines.append('# TYPE %s histogram' % name)
        for key in keys:
            state = snap['histograms'][key]
            cumulative = 0
            for bound, count in zip(state['buckets'] + [float('inf')], state['counts']):
                cumulative += count
                lines.append('%s %d' % (_series(key, '_bucket', le=_le(bound)), cumulative))
            lines.append('%s %s' % (_series(key, '_sum'), _fmt(state['sum'])))
            lines.append('%s %d' % (_series(key, '_count'), state['count']))
    return '\n'.join(lines) + '\n'


def _le(bound):
    if bound == float('inf'):
        return '+Inf'
    text = repr(bound)
    return text[:-2] if text.endswith('.0') else text


def _fmt(value):
    if float(value).is_integer():
        return str(int(value))
    return repr(float(value))


def _series(key, suffix, **extra_labels):
    """``name{labels}`` → ``name<suffix>{labels + extra}``."""
    if '{' in key:
        name, labels = key.split('{', 1)
        labels = labels[:-1]
    else:
        name, labels = key, ''
    for k, v in sorted(extra_labels.items()):
        pair = '%s="%s"' % (k, v)
        labels = '%s,%s' % (labels, pair) if labels else pair
    return '%s%s{%s}' % (name, suffix, labels) if labels else '%s%s' % (name, suffix)


# -- pipeline report ---------------------------------------------------------


def _label_of(key, label):
    """Value of one label in a ``name{label="x",...}`` key, or None."""
    for marker in ('{%s="' % label, ',%s="' % label):
        i = key.find(marker)
        if i < 0:
            continue
        start = i + len(marker)
        j = key.find('"', start)
        return key[start:j] if j > 0 else None
    return None


def pipeline_report(registry=None, wall_time_s=None, baseline=None, attributor=None):
    """Per-stage time breakdown and stall attribution.

    :param wall_time_s: when given, each stage's ``share`` is its seconds
        over the wall time and ``attributed_fraction`` says how much of
        the wall the stages explain; without it, shares are of the summed
        stage time (worker stages run in parallel threads, so their sum
        can exceed any wall).
    :param baseline: an earlier ``registry.snapshot()``; stage seconds and
        calls are reported as the increase since it.
    :param attributor: stall attributor to read (default: the
        process-wide one).
    """
    from petastorm_tpu_torch.telemetry.stall import get_attributor
    registry = registry or get_registry()
    attributor = attributor or get_attributor()
    seconds = registry.counters_with_prefix(STAGE_SECONDS)
    calls = registry.counters_with_prefix(STAGE_CALLS)
    base = (baseline or {}).get('counters', {})

    stages = {}
    for key, value in seconds.items():
        stage = _label_of(key, 'stage')
        if stage is None:
            continue
        stages[stage] = {'seconds': max(value - base.get(key, 0.0), 0.0)}
    for key, value in calls.items():
        stage = _label_of(key, 'stage')
        if stage in stages:
            stages[stage]['calls'] = int(value - base.get(key, 0))
    total = sum(s['seconds'] for s in stages.values())
    denominator = wall_time_s if wall_time_s else total
    for stage in stages.values():
        stage.setdefault('calls', 0)
        stage['share'] = stage['seconds'] / denominator if denominator else 0.0

    producer_wait, consumer_wait = attributor.totals()
    report = {
        'stages': dict(sorted(stages.items(), key=lambda kv: -kv[1]['seconds'])),
        'stage_order': list(STAGES),
        'total_stage_seconds': round(total, 6),
        'wall_time_s': wall_time_s,
        'attributed_fraction': round(total / wall_time_s, 4) if wall_time_s else None,
        'stall': {
            # lifetime clocks, start-up included ...
            'producer_wait_s': round(producer_wait, 6),
            'consumer_wait_s': round(consumer_wait, 6),
            # ... but the verdict covers only the recent windows, so a
            # start-up's consumer waits do not read as producer-bound for
            # the whole run
            'verdict': attributor.verdict(last_n=_VERDICT_WINDOWS),
            'windows': attributor.windows()[-20:],
        },
    }
    overlap = _h2d_overlap_share(stages)
    if overlap is not None:
        report['h2d_overlap_share'] = overlap
    cache = _cache_section(registry)
    if cache is not None:
        report['cache'] = cache
    decoded = decoded_cache_section(registry, baseline=baseline, stages=stages)
    if decoded is not None:
        report['decoded_cache'] = decoded
    pushdown = _pushdown_section(registry)
    if pushdown is not None:
        report['pushdown'] = pushdown
    readahead = _readahead_section(registry)
    if readahead is not None:
        report['readahead'] = readahead
    write = _write_section(registry)
    if write is not None:
        report['write'] = write
    pipesan = _sanitizer_section(registry)
    if pipesan is not None:
        report['pipesan'] = pipesan
    anomalies = _anomalies_section(registry)
    if anomalies is not None:
        report['anomalies'] = anomalies
    autotune = _staging_autotune_section(registry)
    if autotune is not None:
        report['staging_autotune'] = autotune
    critical = _critical_path_section()
    if critical is not None:
        report['critical_path'] = critical
    from petastorm_tpu_torch.telemetry import slo
    slo_view = slo.slo_section()
    if slo_view is not None:
        report['slo'] = slo_view
    return report


def _readahead_section(registry):
    """The readahead plane's activity, present only once it served, missed
    or degraded. Occupancy and depth are this process's live managers'."""
    from petastorm_tpu_torch import readahead
    hits = registry.counter_value(readahead.READAHEAD_HITS)
    misses = registry.counter_value(readahead.READAHEAD_MISSES)
    degraded = {}
    for key, value in registry.counters_with_prefix(readahead.READAHEAD_DEGRADED).items():
        reason = _label_of(key, 'reason') or 'unknown'
        degraded[reason] = degraded.get(reason, 0) + int(value)
    if not hits and not misses and not degraded:
        return None
    bytes_fetched = registry.counter_value(readahead.READAHEAD_BYTES)
    reads = registry.counter_value(readahead.READAHEAD_COALESCED_READS)
    used, budget = readahead.pool_status()
    return {
        'hits': int(hits),
        'misses': int(misses),
        'hit_share': round(hits / (hits + misses), 4) if hits or misses else None,
        'bytes_fetched': int(bytes_fetched),
        'coalesced_reads': int(reads),
        'mean_coalesced_bytes': int(bytes_fetched / reads) if reads else None,
        'degraded': degraded,
        'depth': readahead.current_depth(),
        'pool_bytes': int(used),
        'pool_budget_bytes': int(budget),
    }


def _write_section(registry):
    """The write plane's activity (:mod:`petastorm_tpu_torch.write`), present
    only when this process wrote, committed or compacted; the generation
    is the latest manifest swap this process published."""
    from petastorm_tpu_torch.write import compact, writer
    from petastorm_tpu_torch.write import manifest as write_manifest
    rows = registry.counter_value(writer.WRITE_ROWS)
    commits = registry.counter_value(write_manifest.WRITE_COMMITS)
    compact_runs = registry.counter_value(compact.COMPACT_RUNS)
    if not rows and not commits and not compact_runs:
        return None
    return {
        'rows_written': int(rows),
        'bytes_written': int(registry.counter_value(writer.WRITE_BYTES)),
        'files_written': int(registry.counter_value(writer.WRITE_FILES)),
        'commits': int(commits),
        'generation': int(registry.gauge_value(write_manifest.MANIFEST_GENERATION) or 0),
        'compact_runs': int(compact_runs),
        'files_folded': int(registry.counter_value(compact.COMPACT_FILES_FOLDED)),
    }


def _staging_autotune_section(registry):
    """The staging autotuner's decisions, present only once it adjusted
    something: the counter's total by action and this process's recent
    entries. Read only when the autotune module is already imported (a
    process without a loader never imports it for a None section)."""
    import sys
    autotune = sys.modules.get('petastorm_tpu_torch.device.autotune')
    if autotune is None:
        return None
    by_action = {}
    for key, value in registry.counters_with_prefix(autotune.AUTOTUNE_DECISIONS).items():
        action = _label_of(key, 'action') or 'unknown'
        by_action[action] = by_action.get(action, 0) + int(value)
    recent = autotune.recent_decisions(10)
    if not by_action and not recent:
        return None
    return {
        'total': sum(by_action.values()),
        'by_action': by_action,
        'recent': recent,
    }


def _critical_path_section():
    """The critical-path analysis (telemetry/critpath.py), present only
    when the flight recorder holds events (tracing was on)."""
    from petastorm_tpu_torch.telemetry import critpath, recorder
    if not len(recorder.get_recorder()):
        return None
    return critpath.critpath_section()


def _h2d_overlap_share(stages):
    """Share of the staging engine's time not blocked on an in-flight
    transfer (``h2d_ready``): 1.0 means every copy landed while the
    consumer computed or the next slot filled; low values mean the link
    is the wall. Present only when the slot ring ran."""
    fill = stages.get('stage_fill', {}).get('seconds', 0.0)
    dispatch = stages.get('h2d_dispatch', {}).get('seconds', 0.0)
    ready = stages.get('h2d_ready', {}).get('seconds', 0.0)
    total = fill + dispatch + ready
    if not total:
        return None
    return round(1.0 - ready / total, 4)


def _cache_section(registry):
    """The raw row-group cache (``cache_type='local-disk'``), present once
    it served a hit or a miss."""
    from petastorm_tpu_torch.cache import (
        CACHE_BYTES_EVICTED, CACHE_BYTES_WRITTEN, CACHE_EVICTIONS, CACHE_HITS, CACHE_MISSES,
        CACHE_SIZE_BYTES,
    )
    hits = registry.counter_value(CACHE_HITS)
    misses = registry.counter_value(CACHE_MISSES)
    if not hits and not misses:
        return None
    return {
        'hits': int(hits),
        'misses': int(misses),
        'evictions': int(registry.counter_value(CACHE_EVICTIONS)),
        'bytes_written': int(registry.counter_value(CACHE_BYTES_WRITTEN)),
        'bytes_evicted': int(registry.counter_value(CACHE_BYTES_EVICTED)),
        # one gauge per process (pid label), each the running total of the
        # one shared directory: the freshest estimate is the max, never
        # the sum
        'size_bytes': int(max(registry.gauges_with_prefix(CACHE_SIZE_BYTES).values(),
                              default=0)),
        'hit_rate': round(hits / (hits + misses), 4),
    }


def classify_cache_phase(stages, hits, misses):
    """``'cache-bound'``, ``'decode-bound'`` or ``'mixed'`` for a pass over
    the decoded cache. Cache-bound: hits are at least 80% and the pass's
    decode side (io + decode + transform) no longer outweighs its
    hit-serving time (``cache_hit_read``), or is under 50 ms. ``stages``
    is a :func:`pipeline_report`-shaped per-stage dict."""
    total = hits + misses
    if total <= 0:
        return None
    hit_rate = hits / total

    def _sec(stage):
        return stages.get(stage, {}).get('seconds', 0.0)

    decode_side = _sec('io') + _sec('decode') + _sec('transform')
    hit_side = _sec('cache_hit_read')
    if hit_rate >= 0.8 and (decode_side <= hit_side or decode_side < 0.05):
        return 'cache-bound'
    if hit_rate <= 0.2:
        return 'decode-bound'
    return 'mixed'


def decoded_cache_section(registry=None, baseline=None, stages=None):
    """The decoded cache's activity (None when it never ran) with the
    :func:`classify_cache_phase` verdict. ``baseline`` (an earlier
    ``registry.snapshot()``) scopes the counters to one window: pass the
    snapshot taken between epochs to ask whether THIS pass was
    cache-bound."""
    from petastorm_tpu_torch.materialized_cache import (
        DECODED_CACHE_BYTES_READ, DECODED_CACHE_BYTES_WRITTEN, DECODED_CACHE_COPY_READS,
        DECODED_CACHE_EVICTIONS, DECODED_CACHE_HITS, DECODED_CACHE_MEM_HITS,
        DECODED_CACHE_MISSES, DECODED_CACHE_MMAP_READS, DECODED_CACHE_SIZE_BYTES,
    )
    registry = registry or get_registry()
    base = (baseline or {}).get('counters', {})

    def value(name):
        return registry.counter_value(name) - base.get(name, 0)

    hits = value(DECODED_CACHE_HITS)
    misses = value(DECODED_CACHE_MISSES)
    if not hits and not misses:
        return None
    return {
        'hits': int(hits),
        'misses': int(misses),
        'mem_hits': int(value(DECODED_CACHE_MEM_HITS)),
        'evictions': int(value(DECODED_CACHE_EVICTIONS)),
        'bytes_written': int(value(DECODED_CACHE_BYTES_WRITTEN)),
        'bytes_read': int(value(DECODED_CACHE_BYTES_READ)),
        'mmap_reads': int(value(DECODED_CACHE_MMAP_READS)),
        'copy_reads': int(value(DECODED_CACHE_COPY_READS)),
        # per-process gauges over one shared directory: the max, never the sum
        'size_bytes': int(max(registry.gauges_with_prefix(DECODED_CACHE_SIZE_BYTES).values(),
                              default=0)),
        'hit_rate': round(hits / (hits + misses), 4),
        'verdict': classify_cache_phase(stages or {}, hits, misses),
    }


def _pushdown_section(registry):
    """Selective-read activity: plan-time pruning from this process's
    planner summary, late-materialized rows from the workers' counters;
    present only when a planner ran or rows were late-materialized.
    ``declines`` holds why pruning proved nothing (``arbitrary-predicate``,
    ``no-statistics``, ``low-selectivity``)."""
    from petastorm_tpu_torch import pushdown
    summary = pushdown.planner_summary()
    pruned = registry.counter_value(pushdown.ROWGROUPS_PRUNED)
    late = registry.counter_value(pushdown.LATE_MATERIALIZED_ROWS)
    if not summary['planner_runs'] and not pruned and not late:
        return None
    considered = summary['rowgroups_considered']
    return {
        'planner_runs': summary['planner_runs'],
        'rowgroups_considered': considered,
        'rowgroups_pruned': int(pruned),
        'rows_pruned': int(registry.counter_value(pushdown.ROWS_PRUNED)),
        'late_materialized_rows': int(late),
        # the share from the local planner's tallies: the registry counter
        # may include other plans, and mixing denominators would lie
        'prune_share': (round(summary['rowgroups_pruned'] / considered, 4)
                        if considered else None),
        'declines': summary['declines'],
    }


def _sanitizer_section(registry):
    """pipesan findings: present when the sanitizer is armed
    (``PETASTORM_TPU_SANITIZE=1``) or violations were recorded, so unarmed
    reports keep their shape. ``recent`` carries the last few violations
    of the in-process ring (kind, detail, ts)."""
    from petastorm_tpu_torch import sanitizer
    by_kind = {}
    for key, value in registry.counters_with_prefix(sanitizer.SANITIZER_VIOLATIONS).items():
        kind = _label_of(key, 'kind') or 'unknown'
        by_kind[kind] = by_kind.get(kind, 0) + int(value)
    total = sum(by_kind.values())
    enabled = sanitizer.sanitize_enabled()
    if not enabled and not total:
        return None
    return {
        'enabled': enabled,
        'violations': total,
        'by_kind': by_kind,
        'views_guarded': int(registry.counter_value(sanitizer.SANITIZER_VIEWS_GUARDED)),
        'canary_checks': int(registry.counter_value(sanitizer.SANITIZER_CANARY_CHECKS)),
        'recent': sanitizer.violations()[-5:],
    }


def _anomalies_section(registry):
    """The live plane's anomaly events: totals by kind from the counter
    and the last few events of the ring, each naming its runbook. Present
    when an event was recorded or a sampler runs in this process."""
    from petastorm_tpu_torch.telemetry import timeseries
    by_kind = {}
    for key, value in registry.counters_with_prefix(timeseries.ANOMALY_EVENTS).items():
        kind = _label_of(key, 'kind') or 'unknown'
        by_kind[kind] = by_kind.get(kind, 0) + int(value)
    recent = timeseries.recent_anomalies(5)
    if not by_kind and not recent and not timeseries.collector_running():
        return None
    return {'total': sum(by_kind.values()), 'by_kind': by_kind, 'recent': recent}


def format_pipeline_report(report):
    """Human-readable rendering of :func:`pipeline_report`: one stage a
    line, canonical order first, then the stall verdict and whatever
    sections the report holds."""
    lines = ['pipeline stages (share of %s):'
             % ('wall time' if report['wall_time_s'] else 'stage time')]
    ordered = [s for s in report['stage_order'] if s in report['stages']]
    ordered += [s for s in report['stages'] if s not in ordered]
    for stage in ordered:
        info = report['stages'][stage]
        lines.append('  %-10s %8.3fs  %5.1f%%  (%d calls)'
                     % (stage, info['seconds'], 100 * info['share'], info['calls']))
    if report['wall_time_s']:
        lines.append('  attributed %5.1f%% of %.3fs wall'
                     % (100 * (report['attributed_fraction'] or 0.0), report['wall_time_s']))
    if report.get('h2d_overlap_share') is not None:
        lines.append('  h2d overlap %5.1f%% (share of staging-engine time '
                     'not blocked on an in-flight transfer)'
                     % (100 * report['h2d_overlap_share']))
    stall = report['stall']
    lines.append('stall attribution: %s (producer_wait %.3fs, consumer_wait %.3fs over %d '
                 'window(s))' % (stall['verdict'], stall['producer_wait_s'],
                                 stall['consumer_wait_s'], len(stall['windows'])))
    if 'cache' in report:
        c = report['cache']
        lines.append('cache: %d hit / %d miss (%.1f%%), %d eviction(s), %d B written, '
                     '%d B evicted, %d B resident'
                     % (c['hits'], c['misses'], 100 * c['hit_rate'], c['evictions'],
                        c['bytes_written'], c['bytes_evicted'], c['size_bytes']))
    if 'decoded_cache' in report:
        d = report['decoded_cache']
        lines.append('decoded cache: %s — %d hit / %d miss (%.1f%%, %d from memory tier), '
                     '%d mmap / %d copy column read(s), %d B written, %d B read, '
                     '%d eviction(s), %d B resident'
                     % (d['verdict'] or 'idle', d['hits'], d['misses'], 100 * d['hit_rate'],
                        d['mem_hits'], d['mmap_reads'], d['copy_reads'], d['bytes_written'],
                        d['bytes_read'], d['evictions'], d['size_bytes']))
    if 'pushdown' in report:
        p = report['pushdown']
        share = p['prune_share']
        declines = ', '.join('%s: %d' % (k, v) for k, v in sorted(p['declines'].items()))
        lines.append('pushdown: %d/%d row-group(s) pruned%s (%d rows skipped), %d row(s) '
                     'late-materialized%s'
                     % (p['rowgroups_pruned'], p['rowgroups_considered'],
                        (' = %.1f%%' % (100 * share)) if share is not None else '',
                        p['rows_pruned'], p['late_materialized_rows'],
                        (' — declines: %s' % declines) if declines else ''))
    if 'readahead' in report:
        r = report['readahead']
        reasons = ', '.join('%s: %d' % (k, v) for k, v in sorted(r['degraded'].items()))
        lines.append('readahead: %d hit / %d miss%s, %d B over %d coalesced read(s)%s, '
                     'depth %d, pool %d/%d B%s'
                     % (r['hits'], r['misses'],
                        (' (%.1f%%)' % (100 * r['hit_share'])
                         if r['hit_share'] is not None else ''),
                        r['bytes_fetched'], r['coalesced_reads'],
                        (' (mean %d B)' % r['mean_coalesced_bytes']
                         if r['mean_coalesced_bytes'] is not None else ''),
                        r['depth'], r['pool_bytes'], r['pool_budget_bytes'],
                        (' — degraded: %s' % reasons) if reasons else ''))
    if 'write' in report:
        w = report['write']
        compact_bit = ''
        if w['compact_runs']:
            compact_bit = (', %d compaction run(s) folding %d file(s)'
                           % (w['compact_runs'], w['files_folded']))
        lines.append('write plane: %d row(s) / %d B in %d part file(s), %d commit(s), '
                     'generation %d%s'
                     % (w['rows_written'], w['bytes_written'], w['files_written'],
                        w['commits'], w['generation'], compact_bit))
    if 'pipesan' in report:
        p = report['pipesan']
        kinds = ', '.join('%s: %d' % (k, v) for k, v in sorted(p['by_kind'].items()))
        lines.append('pipesan: %s — %d violation(s)%s, %d view(s) forced read-only, '
                     '%d canary check(s)'
                     % ('armed' if p['enabled'] else 'off', p['violations'],
                        (' (%s)' % kinds) if kinds else '', p['views_guarded'],
                        p['canary_checks']))
    if 'anomalies' in report:
        a = report['anomalies']
        kinds = ', '.join('%s: %d' % (k, v) for k, v in sorted(a['by_kind'].items()))
        lines.append('anomalies: %d event(s)%s' % (a['total'], (' (%s)' % kinds) if kinds else ''))
        for event in a['recent'][-3:]:
            lines.append('  %s at %.0f — %s' % (event['kind'], event.get('ts') or 0.0,
                                                event.get('runbook', '')))
    if 'staging_autotune' in report:
        t = report['staging_autotune']
        actions = ', '.join('%s: %d' % (k, v) for k, v in sorted(t['by_action'].items()))
        lines.append('staging autotune: %d decision(s)%s'
                     % (t['total'], (' (%s)' % actions) if actions else ''))
        for entry in t['recent'][-3:]:
            detail = {k: v for k, v in entry.items() if k not in ('action', 'ts')}
            lines.append('  %s — %s' % (entry['action'], detail))
    if 'critical_path' in report:
        c = report['critical_path']
        lines.append('critical path: bottleneck %s over %.3fs traced span (%d item(s), '
                     '%d stage event(s))'
                     % (c['bottleneck'], c['span_s'], c['items'], c['events']))
        for stage, info in list(c['stages'].items())[:4]:
            lines.append('  %-14s self %8.3fs  overlapped %8.3fs'
                         % (stage, info['self_s'], info['overlap_s']))
        for scenario in c['what_if'][:3]:
            lines.append('  what-if: %s => epoch %+.1f%%'
                         % (scenario['scenario'], scenario['epoch_delta_pct']))
        check = c.get('autotune_crosscheck')
        if check:
            lines.append('  autotuner cross-check: %d agree / %d disagree over %d '
                         'decision(s)' % (check['agree'], check['disagree'],
                                          check['decisions']))
    if 'slo' in report:
        for target in report['slo']['targets']:
            lines.append('slo %s %s %g: last %s, burn short %.2fx / long %.2fx, budget %.0f%%%s'
                         % (target['target'], target['op'], target['threshold'],
                            ('%.4g' % target['last_value'])
                            if target['last_value'] is not None else '-',
                            target['short_burn'], target['long_burn'],
                            100 * target['budget_remaining'],
                            ' — BREACHING' if target['breaching'] else ''))
    return '\n'.join(lines)
