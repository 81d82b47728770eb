"""Service-level objectives over the rollup windows (counterpart of
``petastorm_tpu/telemetry/slo.py``): burn rates and error budgets.

One knob holds the spec::

    PETASTORM_TPU_SLO='rows_per_sec>=40000;queue_wait_p99<=50ms;h2d_overlap>=0.3'

Each clause is ``target op threshold[unit]`` (``>=`` or ``<=``; ``ms``
and ``s`` normalize to seconds). The targets read the windows the
:class:`~petastorm_tpu_torch.telemetry.timeseries.ObsCollector` closes:

* ``rows_per_sec``: the window's throughput proxy;
* ``queue_wait_p99``: the ``queue_wait`` stage-duration p99;
* ``append_staleness``: the ``petastorm_tpu_append_staleness_s`` gauge,
  which the port sets once it has the append follower; until then its
  windows have no value and are skipped;
* ``h2d_overlap``: the slot ring's per-window overlap share.

A window where a target misses is a bad window; the error budget allows
``_BUDGET_FRAC`` of windows bad, and the burn rate is the bad share over
the budget, over a short and a long horizon. When both burn, the
``slo_breach`` anomaly fires once;
``petastorm_tpu_slo_breach_windows_total{target=…}`` counts bad windows
and ``petastorm_tpu_slo_budget_remaining{target=…}`` holds the budget.
"""

import collections
import logging
import threading

from petastorm_tpu_torch.telemetry import knobs
from petastorm_tpu_torch.telemetry.registry import get_registry, metric_key
from petastorm_tpu_torch.telemetry.spans import STAGE_DURATION, STAGE_SECONDS, metrics_disabled

logger = logging.getLogger(__name__)

SLO_BREACH_WINDOWS = 'petastorm_tpu_slo_breach_windows_total'
SLO_BUDGET_REMAINING = 'petastorm_tpu_slo_budget_remaining'

#: share of windows the error budget allows to be bad
_BUDGET_FRAC = 0.1
#: fast-burn horizon (windows)
_SHORT_WINDOWS = 12
#: budget horizon (windows)
_LONG_WINDOWS = 60
#: the short horizon must burn at this multiple of the budget rate
_FAST_BURN = 2.0
#: windows evaluated before a breach may fire (with one sample both
#: horizons read 100% bad)
_MIN_WINDOWS = 5

_QUEUE_WAIT_P99_KEY = metric_key(STAGE_DURATION, {'stage': 'queue_wait'})
_APPEND_STALENESS = 'petastorm_tpu_append_staleness_s'
_STAGE_FILL_KEY = metric_key(STAGE_SECONDS, {'stage': 'stage_fill'})
_H2D_DISPATCH_KEY = metric_key(STAGE_SECONDS, {'stage': 'h2d_dispatch'})
_H2D_READY_KEY = metric_key(STAGE_SECONDS, {'stage': 'h2d_ready'})


def _resolve_rows_per_sec(window):
    return window.get('throughput')


def _resolve_queue_wait_p99(window):
    q = window.get('quantiles', {}).get(_QUEUE_WAIT_P99_KEY)
    return q.get('p99') if q else None


def _resolve_append_staleness(window):
    return window.get('gauges', {}).get(_APPEND_STALENESS)


def _resolve_h2d_overlap(window):
    rates = window.get('rates', {})
    fill = rates.get(_STAGE_FILL_KEY, 0.0)
    dispatch = rates.get(_H2D_DISPATCH_KEY, 0.0)
    ready = rates.get(_H2D_READY_KEY, 0.0)
    total = fill + dispatch + ready
    if not total:
        return None
    return 1.0 - ready / total


_RESOLVERS = {
    'rows_per_sec': _resolve_rows_per_sec,
    'queue_wait_p99': _resolve_queue_wait_p99,
    'append_staleness': _resolve_append_staleness,
    'h2d_overlap': _resolve_h2d_overlap,
}


def parse_spec(text):
    """``[{'target', 'op', 'threshold'}, ...]`` from one spec string;
    unknown targets and unparseable clauses are warned about and dropped."""
    targets = []
    for clause in (text or '').split(';'):
        clause = clause.strip()
        if not clause:
            continue
        op = next((c for c in ('>=', '<=') if c in clause), None)
        if op is None:
            logger.warning('SLO clause %r has no >=/<= operator; dropped', clause)
            continue
        name, raw = (part.strip() for part in clause.split(op, 1))
        if name not in _RESOLVERS:
            logger.warning('SLO clause %r names unknown target %r (known: %s); dropped',
                           clause, name, ', '.join(sorted(_RESOLVERS)))
            continue
        scale = 1.0
        if raw.endswith('ms'):
            raw, scale = raw[:-2], 1e-3
        elif raw.endswith('s'):
            raw = raw[:-1]
        try:
            threshold = float(raw) * scale
        except ValueError:
            logger.warning('SLO clause %r has unparseable threshold; dropped', clause)
            continue
        targets.append({'target': name, 'op': op, 'threshold': threshold})
    return targets


class _TargetState:
    __slots__ = ('spec', 'short', 'long', 'last_value', 'breaching', 'bad_total', 'eval_total')

    def __init__(self, spec):
        self.spec = spec
        self.short = collections.deque(maxlen=_SHORT_WINDOWS)
        self.long = collections.deque(maxlen=_LONG_WINDOWS)
        self.last_value = None
        self.breaching = False
        self.bad_total = 0
        self.eval_total = 0

    def fractions(self):
        """Bad share over the short and the long horizon."""
        short = sum(self.short) / len(self.short) if self.short else 0.0
        long = sum(self.long) / len(self.long) if self.long else 0.0
        return short, long


class SloPolicy:
    """One parsed spec, evaluated window by window with per-target burn
    state. The sampler thread writes, scrape handlers read."""

    def __init__(self, targets):
        self.targets = [_TargetState(spec) for spec in targets]
        self._lock = threading.Lock()

    def observe(self, window):
        """Evaluate one closed window; the verdict record (also the flight
        log's line), or None when no target had a value. Fires
        ``slo_breach`` when a target's two horizons start burning."""
        from petastorm_tpu_torch.telemetry.timeseries import record_anomaly
        verdicts = []
        with self._lock:
            for state in self.targets:
                spec = state.spec
                value = _RESOLVERS[spec['target']](window)
                if value is None:
                    continue
                state.last_value = value
                bad = (value < spec['threshold'] if spec['op'] == '>='
                       else value > spec['threshold'])
                state.short.append(bad)
                state.long.append(bad)
                state.eval_total += 1
                if bad:
                    state.bad_total += 1
                    if not metrics_disabled():
                        get_registry().counter(SLO_BREACH_WINDOWS, target=spec['target']).inc()
                short_frac, long_frac = state.fractions()
                remaining = max(0.0, 1.0 - long_frac / _BUDGET_FRAC)
                if not metrics_disabled():
                    get_registry().gauge(SLO_BUDGET_REMAINING,
                                         target=spec['target']).set(round(remaining, 4))
                burning = (len(state.long) >= _MIN_WINDOWS
                           and short_frac >= _FAST_BURN * _BUDGET_FRAC
                           and long_frac >= _BUDGET_FRAC)
                detail = {
                    'target': spec['target'],
                    'op': spec['op'],
                    'threshold': spec['threshold'],
                    'value': round(float(value), 6),
                    'bad': bad,
                    'short_burn': round(short_frac / _BUDGET_FRAC, 3),
                    'long_burn': round(long_frac / _BUDGET_FRAC, 3),
                    'budget_remaining': round(remaining, 4),
                    'breaching': burning,
                }
                if burning and not state.breaching:
                    record_anomaly('slo_breach', detail=dict(detail),
                                   window_start=window.get('start'))
                state.breaching = burning
                verdicts.append(detail)
        if not verdicts:
            return None
        return {'ts': window.get('start'), 'targets': verdicts}

    def section(self):
        """Per target: the spec, last value, burn rates and budget left."""
        out = []
        with self._lock:
            for state in self.targets:
                spec = state.spec
                short_frac, long_frac = state.fractions()
                out.append({
                    'target': spec['target'],
                    'op': spec['op'],
                    'threshold': spec['threshold'],
                    'last_value': (round(float(state.last_value), 6)
                                   if state.last_value is not None else None),
                    'windows_evaluated': state.eval_total,
                    'windows_bad': state.bad_total,
                    'short_burn': round(short_frac / _BUDGET_FRAC, 3),
                    'long_burn': round(long_frac / _BUDGET_FRAC, 3),
                    'budget_remaining': round(max(0.0, 1.0 - long_frac / _BUDGET_FRAC), 4),
                    'breaching': state.breaching,
                })
        return {'budget_frac': _BUDGET_FRAC, 'short_windows': _SHORT_WINDOWS,
                'long_windows': _LONG_WINDOWS, 'targets': out}


_policy_lock = threading.Lock()
_policy = None
_policy_spec = None


def get_policy():
    """The process-wide policy parsed from ``PETASTORM_TPU_SLO``, or None
    when the knob is empty. Parsed anew only when the text changes, so
    burn state survives other refreshes."""
    global _policy, _policy_spec
    text = knobs.get_str('PETASTORM_TPU_SLO')
    with _policy_lock:
        if text != _policy_spec:
            _policy_spec = text
            targets = parse_spec(text) if text else []
            _policy = SloPolicy(targets) if targets else None
        return _policy


def observe_window(window):
    """Evaluate the active policy on one closed window (the sampler's
    hook); None when no policy is armed."""
    policy = get_policy()
    return policy.observe(window) if policy is not None else None


def slo_section():
    """The live SLO view for ``/health`` and ``pipeline_report()``; None
    when no spec is armed."""
    policy = get_policy()
    return policy.section() if policy is not None else None


def qos_weight_advice(qos_entries, slo=None):
    """Per-job QoS weight advice: while a budget burns, a job below its
    declared worker share should weigh more (``raise_weight``) and one
    above it less (``lower_weight``); otherwise ``ok``. ``qos_entries``
    are dicts with ``job_id``, ``name``, ``worker_share`` and
    ``target_share``."""
    if slo is None:
        slo = slo_section()
    burning = bool(slo) and any(t['breaching'] for t in slo['targets'])
    advice = []
    for entry in qos_entries or []:
        worker_share = entry.get('worker_share') or 0.0
        target_share = entry.get('target_share') or 0.0
        gap = target_share - worker_share
        if burning and gap > 0.05:
            verdict = 'raise_weight'
        elif burning and gap < -0.05:
            verdict = 'lower_weight'
        else:
            verdict = 'ok'
        advice.append({'job_id': entry.get('job_id'), 'name': entry.get('name'),
                       'worker_share': round(worker_share, 4),
                       'target_share': round(target_share, 4), 'advice': verdict})
    return advice


def refresh_slo():
    """Knob-refresh hook: re-read the spec; an unchanged one keeps its
    burn state."""
    get_policy()


def _reset_for_tests():
    global _policy, _policy_spec
    with _policy_lock:
        _policy = None
        _policy_spec = None
