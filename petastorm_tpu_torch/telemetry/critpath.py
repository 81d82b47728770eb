"""Critical-path engine: per-item lifelines, self against overlapped
time, what-if projections (counterpart of
``petastorm_tpu/telemetry/critpath.py``).

The flight recorder's complete events say where each row-group's time
went; this module says what fixing a stage would be worth. Every instant
of the traced span is charged to exactly one active stage, by a priority
sweep (productive upstream work wins over waits, so ``decode`` keeps its
self-time while the ``queue_wait`` overlapping it reads as slack), and
the what-if scenarios follow the slack model::

    saving(stage, k x faster) = self_time(stage) * (1 - 1/k)

because only self-time is load-bearing. The port orders only the stages
it records (:data:`~petastorm_tpu_torch.telemetry.names.STAGES`), in the
reference's relative order. :func:`crosscheck_autotuner` compares the
bottleneck with the staging autotuner's recent decisions
(:mod:`petastorm_tpu_torch.device.autotune`, once imported) and counts
agreement into ``petastorm_tpu_critpath_agreement_total``.

Works only on what the recorder holds: ``PETASTORM_TPU_TRACE=1`` must
have been on, and sampling scales the analysis as it scales recording.
"""

import logging

from petastorm_tpu_torch.telemetry.names import STAGES
from petastorm_tpu_torch.telemetry.recorder import get_recorder
from petastorm_tpu_torch.telemetry.registry import get_registry
from petastorm_tpu_torch.telemetry.spans import metrics_disabled

logger = logging.getLogger(__name__)

#: decision-quality cross-check outcomes vs the staging autotuner
CRITPATH_AGREEMENT = 'petastorm_tpu_critpath_agreement_total'

#: the port's staging autotuner, looked up only when already imported
AUTOTUNE_MODULE = 'petastorm_tpu_torch.device.autotune'

#: sweep-line attribution priority, highest first: when several stages
#: are active over the same instant, the earliest-listed one takes it as
#: self-time and the rest read as overlapped slack. Productive compute
#: outranks I/O, I/O outranks staging bookkeeping, and the pure waits
#: (``queue_wait``, ``ventilate``) come last. The reference's order,
#: limited to the port's stages.
_PRIORITY = (
    'decode_fused', 'decode', 'late_materialize', 'transform', 'filter',
    'collate', 'pack', 'encode', 'write_flush', 'compact', 'cache_fill', 'cache_hit_read', 'io',
    'readahead_fetch', 'rowgroup_prune', 'stage_fill', 'h2d_dispatch', 'h2d_ready', 'autotune',
    'ventilate', 'queue_wait',
)
_RANK = {stage: i for i, stage in enumerate(_PRIORITY)}

#: compute stages deeper readahead can hide I/O behind (the bound of the
#: "readahead depth +4" scenario: prefetch turns blocking io into
#: overlapped time only while there is compute to hide it behind)
_COMPUTE_STAGES = ('decode', 'decode_fused', 'late_materialize',
                   'transform', 'filter', 'collate')

#: what-if speedup factor of the per-stage scenarios
_WHATIF_FACTOR = 2.0
_TOP_SCENARIOS = 4


def _stage_intervals(events):
    """``[(start_us, end_us, stage), ...]`` of every complete ('X') stage
    event. ``attempt`` and the lifecycle instants are skipped: an attempt
    envelopes the worker stages recorded inside it and would double-count
    every covered instant."""
    known = set(STAGES)
    intervals = []
    for event in events:
        if event.get('ph') != 'X':
            continue
        name = event.get('name')
        if name not in known:
            continue
        start = event.get('ts', 0.0)
        dur = event.get('dur', 0.0)
        if dur <= 0:
            continue
        intervals.append((start, start + dur, name))
    return intervals


def _sweep(intervals):
    """Priority sweep-line: per-stage ``{total_us, self_us}``. Between
    every pair of adjacent interval boundaries exactly one active stage —
    the highest-priority one — is charged the segment as self-time."""
    points = []
    totals = {}
    for start, end, stage in intervals:
        points.append((start, 1, stage))
        points.append((end, -1, stage))
        totals[stage] = totals.get(stage, 0.0) + (end - start)
    points.sort(key=lambda p: (p[0], p[1]))
    active = {}
    self_us = {}
    prev_t = None
    i = 0
    n = len(points)
    while i < n:
        t = points[i][0]
        if prev_t is not None and active and t > prev_t:
            winner = min(active, key=lambda s: _RANK.get(s, 10 ** 6))
            self_us[winner] = self_us.get(winner, 0.0) + (t - prev_t)
        while i < n and points[i][0] == t:
            _, delta, stage = points[i]
            count = active.get(stage, 0) + delta
            if count <= 0:
                active.pop(stage, None)
            else:
                active[stage] = count
            i += 1
        prev_t = t
    return totals, self_us


def _what_if(stages, span_s):
    """Slack-model projections, best first. Per-stage "k x faster"
    scenarios over the top self-time stages, plus the "readahead depth
    +4" overlap scenario (I/O self-time hidden behind the available
    compute self-time)."""
    scenarios = []
    by_self = sorted(stages.items(), key=lambda kv: -kv[1]['self_s'])
    for stage, info in by_self[:_TOP_SCENARIOS]:
        saving = info['self_s'] * (1.0 - 1.0 / _WHATIF_FACTOR)
        if saving <= 0:
            continue
        scenarios.append({
            'scenario': '%s %gx faster' % (stage, _WHATIF_FACTOR),
            'stage': stage,
            'factor': _WHATIF_FACTOR,
            'saving_s': round(saving, 6),
            'epoch_delta_pct': round(-100.0 * saving / span_s, 2),
        })
    io_self = stages.get('io', {}).get('self_s', 0.0)
    compute_self = sum(stages.get(s, {}).get('self_s', 0.0)
                       for s in _COMPUTE_STAGES)
    hideable = min(io_self, compute_self)
    if hideable > 0:
        scenarios.append({
            'scenario': 'readahead depth +4',
            'stage': 'io',
            'factor': None,
            'saving_s': round(hideable, 6),
            'epoch_delta_pct': round(-100.0 * hideable / span_s, 2),
        })
    scenarios.sort(key=lambda s: s['saving_s'], reverse=True)
    return scenarios


def analyze(events=None):
    """The critical-path report over ``events`` (default: the process
    flight recorder), or None when no stage events exist.

    ``stages`` maps each observed stage to its summed wall time
    (``total_s``), the share of the traced span where it was the
    highest-priority active work (``self_s``, the critical-path time),
    the remainder (``overlap_s``, slack hidden behind other stages), and
    ``self_share`` of the span. ``what_if`` ranks the slack-model
    scenarios; ``recommendation`` is the top one as a sentence.
    """
    if events is None:
        events = get_recorder().snapshot()
    intervals = _stage_intervals(events)
    if not intervals:
        return None
    totals, self_us = _sweep(intervals)
    span_us = (max(end for _, end, _ in intervals)
               - min(start for start, _, _ in intervals))
    span_s = max(span_us / 1e6, 1e-9)
    items = len({e['args'].get('trace_id') for e in events
                 if e.get('ph') == 'X' and isinstance(e.get('args'), dict)
                 and e['args'].get('trace_id')})
    stages = {}
    for stage, total in totals.items():
        self_s = self_us.get(stage, 0.0) / 1e6
        total_s = total / 1e6
        stages[stage] = {
            'total_s': round(total_s, 6),
            'self_s': round(self_s, 6),
            'overlap_s': round(max(total_s - self_s, 0.0), 6),
            'self_share': round(self_s / span_s, 4),
        }
    bottleneck = max(stages, key=lambda s: stages[s]['self_s'])
    what_if = _what_if(stages, span_s)
    recommendation = None
    if what_if:
        top = what_if[0]
        recommendation = '%s => epoch %+.1f%%' % (top['scenario'],
                                                  top['epoch_delta_pct'])
    return {
        'items': items,
        'events': len(intervals),
        'span_s': round(span_s, 6),
        'bottleneck': bottleneck,
        'stages': dict(sorted(stages.items(),
                              key=lambda kv: -kv[1]['self_s'])),
        'what_if': what_if,
        'recommendation': recommendation,
    }


def predict_speedup(stage, factor, events=None, report=None):
    """Projected epoch effect of ``stage`` becoming ``factor`` x faster
    (the ground-truth drill's entry point: inject a known slowdown, ask
    the model for the reverse projection, compare against the measured
    delta). Returns ``{'saving_s', 'predicted_span_s',
    'epoch_delta_pct'}`` or None when the stage never ran."""
    if report is None:
        report = analyze(events)
    if report is None or stage not in report['stages']:
        return None
    self_s = report['stages'][stage]['self_s']
    saving = self_s * (1.0 - 1.0 / float(factor))
    span = report['span_s']
    return {
        'saving_s': round(saving, 6),
        'predicted_span_s': round(span - saving, 6),
        'epoch_delta_pct': round(-100.0 * saving / span, 2),
    }


# -- decision-quality cross-check vs the staging autotuner --------------------

#: which stage territory each autotuner action treats as the bottleneck
#: (deepen/raise = the tuner believes that side is the wall) or as slack
#: (shed/lower/restore = the tuner believes that side has headroom)
_H2D_SIDE = frozenset(('h2d_ready', 'h2d_dispatch', 'stage_fill'))
_IO_SIDE = frozenset(('io', 'readahead_fetch'))
_ACTION_TERRITORY = {
    'deepen_slots': ('bottleneck', _H2D_SIDE),
    'deepen_prefetch': ('bottleneck', _H2D_SIDE),
    'raise_inflight': ('bottleneck', _H2D_SIDE),
    'deepen_readahead': ('bottleneck', _IO_SIDE),
    'shed_readahead': ('slack', _IO_SIDE),
    'lower_inflight': ('slack', _H2D_SIDE),
    'shed_decode_threads': ('slack',
                            frozenset(('decode', 'decode_fused', 'io'))),
    'restore_decode_threads': ('slack', frozenset()),
}


def crosscheck_autotuner(report=None, decisions=None):
    """Compare the engine's bottleneck verdict against the staging
    autotuner's recent threshold-heuristic decisions; count each
    (dis)agreement into ``petastorm_tpu_critpath_agreement_total``.

    A *bottleneck* action (deepen/raise) agrees when the critical-path
    bottleneck lies in the stage territory the action targets; a *slack*
    action (shed/lower/restore) agrees when it does NOT. The counts are
    evidence about the heuristics' decision quality — nothing is steered
    yet. Returns the per-decision verdict list (None when either side
    has nothing to say)."""
    import sys
    if report is None:
        report = analyze()
    if report is None:
        return None
    if decisions is None:
        autotune = sys.modules.get(AUTOTUNE_MODULE)
        if autotune is None:
            return None
        decisions = autotune.recent_decisions(10)
    if not decisions:
        return None
    bottleneck = report['bottleneck']
    verdicts = []
    for decision in decisions:
        territory = _ACTION_TERRITORY.get(decision.get('action'))
        if territory is None:
            continue
        mode, stage_set = territory
        in_territory = bottleneck in stage_set
        agree = in_territory if mode == 'bottleneck' else not in_territory
        verdict = 'agree' if agree else 'disagree'
        verdicts.append({'action': decision.get('action'),
                         'bottleneck': bottleneck, 'verdict': verdict})
        if not metrics_disabled():
            get_registry().counter(CRITPATH_AGREEMENT,
                                   verdict=verdict).inc()
    return verdicts or None


def critpath_section(events=None):
    """The ``pipeline_report()['critical_path']`` section: the analysis
    plus the autotuner cross-check summary — None when tracing never
    recorded a stage event, so untraced runs keep their report shape."""
    report = analyze(events)
    if report is None:
        return None
    verdicts = crosscheck_autotuner(report=report)
    if verdicts:
        agree = sum(1 for v in verdicts if v['verdict'] == 'agree')
        report['autotune_crosscheck'] = {
            'decisions': len(verdicts),
            'agree': agree,
            'disagree': len(verdicts) - agree,
        }
    return report
