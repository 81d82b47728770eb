"""The pipeline report (counterpart of the report half of
``petastorm_tpu/telemetry/export.py``): per-stage seconds and calls, the
stall verdict and its windows, the staging engine's H2D overlap share,
the selective-read (``pushdown``) section and, when tracing recorded
stage events, the ``critical_path`` section. Reads the registry, the
attributor and the flight recorder; never mutates them.

The reference's other sections read subsystems the port does not have
yet, whose counters therefore never appear here: ``cache``,
``decoded_cache``, ``service``, ``readahead``, ``peer_cache``, ``write``,
``pipesan``, ``anomalies``, ``staging_autotune`` and ``slo``. The JSONL
and Prometheus exporters come with the live plane.
"""

from petastorm_tpu_torch.telemetry.names import STAGES
from petastorm_tpu_torch.telemetry.registry import get_registry
from petastorm_tpu_torch.telemetry.spans import STAGE_CALLS, STAGE_SECONDS

#: stall-verdict horizon in sampling windows (~30 s at the 0.5 s default):
#: recent enough that start-up and idle phases age out of the verdict
_VERDICT_WINDOWS = 60


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
    pushdown = _pushdown_section(registry)
    if pushdown is not None:
        report['pushdown'] = pushdown
    critical = _critical_path_section()
    if critical is not None:
        report['critical_path'] = critical
    return report


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
    return '\n'.join(lines)
