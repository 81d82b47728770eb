"""Post-mortem of the on-disk flight log (counterpart of
``tools/obs_replay.py``).

While a job runs with ``PETASTORM_TPU_OBS_LOG_DIR`` set, the sampler
appends every closed window, anomaly, SLO verdict and periodic
critical-path digest to ``obslog.jsonl`` there
(:mod:`petastorm_tpu_torch.telemetry.obslog`). After the process is gone
(crashed, killed, drained), this reads the directory back::

    python -m petastorm_tpu_torch.tools.obs_replay /var/log/petastorm-obs
    python -m petastorm_tpu_torch.tools.obs_replay /var/log/petastorm-obs --last 50
    python -m petastorm_tpu_torch.tools.obs_replay /var/log/petastorm-obs --json

Three sections: the **timeline** (one line a window: throughput, stall
verdict, producer and consumer wait, with anomalies in place), the **SLO
burn report** (per target: windows evaluated and bad, the worst burns,
the budget left and every breach interval) and the last **critical
path** digest. ``--json`` prints the folded summary as one JSON document.
The log format is the reference's, so this reads either package's log.
"""

import argparse
import json
import sys
import time

from petastorm_tpu_torch.telemetry.obslog import read_log


def _fmt_ts(ts):
    if ts is None:
        return '--:--:--'
    try:
        return time.strftime('%H:%M:%S', time.localtime(float(ts)))
    except (ValueError, OverflowError):
        return str(ts)


def split_records(records):
    """Log lines grouped by record kind, order kept."""
    buckets = {'window': [], 'anomaly': [], 'slo': [], 'critpath': []}
    for rec in records:
        buckets.setdefault(rec.get('kind'), []).append(rec)
    return buckets


def fold_slo(slo_records):
    """Per-target burn summary over every SLO verdict line: totals, worst
    burns, the final budget and ``[start_ts, end_ts]`` breach spans (a
    breach still open at the end of the log has ``end_ts`` None)."""
    targets = {}
    for rec in slo_records:
        ts = rec.get('ts')
        for verdict in rec.get('targets') or []:
            name = verdict.get('target')
            if name is None:
                continue
            agg = targets.setdefault(name, {
                'target': name,
                'op': verdict.get('op'),
                'threshold': verdict.get('threshold'),
                'windows_evaluated': 0,
                'windows_bad': 0,
                'worst_short_burn': 0.0,
                'worst_long_burn': 0.0,
                'final_budget_remaining': None,
                'last_value': None,
                'breaches': [],
                '_breaching': False,
            })
            agg['windows_evaluated'] += 1
            if verdict.get('bad'):
                agg['windows_bad'] += 1
            agg['worst_short_burn'] = max(agg['worst_short_burn'],
                                          verdict.get('short_burn') or 0.0)
            agg['worst_long_burn'] = max(agg['worst_long_burn'], verdict.get('long_burn') or 0.0)
            agg['final_budget_remaining'] = verdict.get('budget_remaining')
            agg['last_value'] = verdict.get('value')
            breaching = bool(verdict.get('breaching'))
            if breaching and not agg['_breaching']:
                agg['breaches'].append([ts, None])
            elif not breaching and agg['_breaching']:
                agg['breaches'][-1][1] = ts
            agg['_breaching'] = breaching
    for agg in targets.values():
        agg['breaching_at_end'] = agg.pop('_breaching')
    return list(targets.values())


def fold_summary(records):
    """The whole post-mortem as one JSON-ready document."""
    buckets = split_records(records)
    windows = buckets['window']
    summary = {
        'records': len(records),
        'windows': len(windows),
        'anomalies': len(buckets['anomaly']),
        'anomaly_kinds': {},
        'slo': fold_slo(buckets['slo']),
        'critical_path': buckets['critpath'][-1] if buckets['critpath'] else None,
    }
    for rec in buckets['anomaly']:
        kind = rec.get('anomaly') or '?'
        summary['anomaly_kinds'][kind] = summary['anomaly_kinds'].get(kind, 0) + 1
    if windows:
        first, last = windows[0], windows[-1]
        summary['span'] = {
            'first_window_ts': first.get('start'),
            'last_window_ts': last.get('start'),
            'last_throughput': last.get('throughput'),
            'last_verdict': last.get('verdict'),
        }
    return summary


def _anomaly_line(rec):
    return '  %s  !! %s %s' % (_fmt_ts(rec.get('ts')), rec.get('anomaly') or '?',
                               json.dumps(rec.get('detail') or {}, sort_keys=True))


def render_timeline(buckets, last=None, out=print):
    windows = buckets['window']
    if last:
        windows = windows[-last:]
    if not windows:
        out('timeline: no window records')
        return
    # each anomaly goes after the latest window that precedes it
    anomalies = sorted(buckets['anomaly'], key=lambda r: r.get('ts') or 0.0)
    ai = 0
    out('timeline (%d window(s)%s):' % (len(windows), ', last %d shown' % last if last else ''))
    for win in windows:
        start = win.get('start')
        out('  %s  %8.1f rows/s  %-14s  p-wait %.2fs  c-wait %.2fs' % (
            _fmt_ts(start), win.get('throughput') or 0.0, win.get('verdict') or '-',
            win.get('producer_wait_s') or 0.0, win.get('consumer_wait_s') or 0.0))
        horizon = (start or 0.0) + (win.get('dur_s') or 0.0)
        while ai < len(anomalies) and (anomalies[ai].get('ts') or 0.0) <= horizon:
            out(_anomaly_line(anomalies[ai]))
            ai += 1
    for rec in anomalies[ai:]:
        out(_anomaly_line(rec))


def render_burn_report(slo_summary, out=print):
    if not slo_summary:
        out('slo: no verdict records (PETASTORM_TPU_SLO not set?)')
        return
    out('slo burn report:')
    for agg in slo_summary:
        out('  %s %s %g: %d/%d window(s) bad, worst burn short %.1fx long %.1fx, '
            'budget %.0f%% left%s' % (
                agg['target'], agg['op'], agg['threshold'], agg['windows_bad'],
                agg['windows_evaluated'], agg['worst_short_burn'], agg['worst_long_burn'],
                100.0 * (agg['final_budget_remaining'] or 0.0),
                ' — BREACHING at end of log' if agg['breaching_at_end'] else ''))
        for start, end in agg['breaches']:
            out('    breach %s -> %s' % (_fmt_ts(start),
                                         _fmt_ts(end) if end is not None else 'end of log'))


def render_critpath(digest, out=print):
    if digest is None:
        out('critical path: no digest recorded (trace off, or the run ended before the '
            'first periodic digest)')
        return
    out('critical path (last digest, %s):' % _fmt_ts(digest.get('ts')))
    out('  bottleneck %s over %d event(s), span %.2fs' % (
        digest.get('bottleneck'), digest.get('events') or 0, digest.get('span_s') or 0.0))
    for scenario in (digest.get('what_if') or [])[:3]:
        out('  what-if %s => epoch %+.1f%% (saves %.2fs)' % (
            scenario.get('scenario'), scenario.get('epoch_delta_pct') or 0.0,
            scenario.get('saving_s') or 0.0))
    if digest.get('recommendation'):
        out('  recommendation: %s' % digest['recommendation'])


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Render the observability flight log (PETASTORM_TPU_OBS_LOG_DIR) as a '
                    'post-mortem.')
    parser.add_argument('log_dir', help='directory holding obslog.jsonl[.1]')
    parser.add_argument('--last', type=int, default=None,
                        help='only the last N windows in the timeline')
    parser.add_argument('--json', action='store_true',
                        help='print the folded summary as one JSON document')
    args = parser.parse_args(argv)
    records = read_log(args.log_dir)
    if not records:
        print('no records under %s (is PETASTORM_TPU_OBS_LOG_DIR pointing here?)'
              % args.log_dir)
        return 1
    summary = fold_summary(records)
    if args.json:
        print(json.dumps(summary, sort_keys=True, default=str))
        return 0
    buckets = split_records(records)
    print('flight log: %d record(s) (%d windows, %d anomalies, %d slo verdicts, %d critpath '
          'digests)' % (len(records), summary['windows'], summary['anomalies'],
                        len(buckets['slo']), len(buckets['critpath'])))
    print()
    render_timeline(buckets, last=args.last)
    print()
    render_burn_report(summary['slo'])
    print()
    render_critpath(summary['critical_path'])
    return 0


if __name__ == '__main__':
    sys.exit(main())
