"""petastorm_tpu_torch's rollup windows, anomaly detector and SLO plane
against the JAX package's, on the CPU.

The same synthetic registry snapshots, made from a seed, go into both
``WindowedRollup``s and the windows come out equal (floats to 1e-12). The
same windows go into both ``AnomalyDetector``s, on the reference's own
fixtures (saturation edge and re-arm, a collapse that needs a waiting
consumer, flap and its re-arm, steady verdicts, H2D starvation, the
heartbeat gap) and on a seeded random stream: both fire the same kinds
in the same order with the same details. ``parse_spec`` agrees on a
table of specs with bad clauses, both ``SloPolicy``s give the same
verdicts and sections over the same windows, and ``qos_weight_advice``
agrees. No sleeps: every time is given.
"""

import math
import types

import numpy as np
import pytest

from petastorm_tpu import telemetry as jax_telemetry
from petastorm_tpu.telemetry import slo as jax_slo
from petastorm_tpu.telemetry import timeseries as jax_timeseries
from petastorm_tpu_torch import telemetry as torch_telemetry
from petastorm_tpu_torch.telemetry import slo as torch_slo
from petastorm_tpu_torch.telemetry import timeseries as torch_timeseries
from petastorm_tpu_torch.telemetry.registry import metric_key
from petastorm_tpu_torch.telemetry.spans import STAGE_CALLS, STAGE_DURATION, STAGE_SECONDS
from petastorm_tpu_torch.telemetry.stall import BALANCED, CONSUMER_BOUND, PRODUCER_BOUND
from tests.torch_telemetry_common import telemetry_guard  # noqa: F401 - autouse

TIMESERIES = {'jax': jax_timeseries, 'torch': torch_timeseries}
SLO = {'jax': jax_slo, 'torch': torch_slo}
TELEMETRY = {'jax': jax_telemetry, 'torch': torch_telemetry}
#: float tolerance of every parity comparison here
TOL = 1e-12

QW_CALLS = metric_key(STAGE_CALLS, {'stage': 'queue_wait'})
DECODE_CALLS = metric_key(STAGE_CALLS, {'stage': 'decode'})
H2D_READY = metric_key(STAGE_SECONDS, {'stage': 'h2d_ready'})
STAGE_FILL = metric_key(STAGE_SECONDS, {'stage': 'stage_fill'})
H2D_DISPATCH = metric_key(STAGE_SECONDS, {'stage': 'h2d_dispatch'})
QW_DURATION = metric_key(STAGE_DURATION, {'stage': 'queue_wait'})
PRODUCER = 'petastorm_tpu_stall_producer_wait_seconds_total'
CONSUMER = 'petastorm_tpu_stall_consumer_wait_seconds_total'


def assert_close(got, want, path='$'):
    """Equal structure; floats equal to :data:`TOL`."""
    if isinstance(want, float) or isinstance(got, float):
        assert isinstance(got, (int, float)) and isinstance(want, (int, float)), path
        assert math.isclose(got, want, rel_tol=0, abs_tol=TOL), (path, got, want)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, sorted(got), sorted(want))
        for key in want:
            assert_close(got[key], want[key], '%s.%s' % (path, key))
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_close(a, b, '%s[%d]' % (path, i))
    else:
        assert got == want, (path, got, want)


# -- rollup -------------------------------------------------------------------


def _snapshots(seed, n=24):
    """``n`` cumulative registry snapshots (counters only go up), with
    times: a quiet start, a busy middle and a stretch with a new series
    and a histogram whose bucket layout changes."""
    rng = np.random.RandomState(seed)
    counters = {QW_CALLS: 0.0, DECODE_CALLS: 0.0, PRODUCER: 0.0, CONSUMER: 0.0,
                H2D_READY: 0.0, STAGE_FILL: 0.0}
    counts = [0] * 17
    buckets = list(torch_telemetry.registry.DEFAULT_DURATION_BUCKETS)
    out = []
    now, wall = 10.0, 1000.0
    for i in range(n):
        dur = float(rng.choice([0.2, 0.25, 0.5, 1.0]))
        if i >= 2:
            for key in counters:
                counters[key] += float(rng.rand()) * dur * (3.0 if key == QW_CALLS else 0.6)
            for _ in range(int(rng.randint(0, 30))):
                counts[int(rng.randint(0, 17))] += 1
        if i == 12:
            counters['petastorm_tpu_new_total{k="v"}'] = 0.0
        snap = {
            'counters': dict(counters),
            'gauges': {'petastorm_tpu_depth': float(rng.randint(0, 9))},
            'histograms': {QW_DURATION: {'buckets': list(buckets), 'counts': list(counts),
                                         'sum': float(sum(counts)) * 0.01,
                                         'count': sum(counts)}},
        }
        if i >= 18:  # a bucket layout that differs from the baseline's is skipped
            snap['histograms']['petastorm_tpu_h'] = {
                'buckets': [0.1, 1.0][:1 + (i % 2)], 'counts': [i] * (2 + (i % 2)),
                'sum': 1.0, 'count': 3 * i}
        out.append((snap, now, wall))
        now += dur
        wall += dur
    return out


def _roll(name, snapshots, max_windows=120):
    rollup = TIMESERIES[name].WindowedRollup(max_windows=max_windows)
    returned = [rollup.sample(snap, now=now, wall=wall) for snap, now, wall in snapshots]
    return rollup, returned


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_rollup_windows_are_the_references(seed):
    snaps = _snapshots(seed)
    got_rollup, got = _roll('torch', snaps)
    want_rollup, want = _roll('jax', snaps)
    assert got[0] is None and want[0] is None
    assert_close(got, want)
    assert_close(got_rollup.windows(), want_rollup.windows())
    assert got_rollup.closed_total == want_rollup.closed_total == len(snaps) - 1
    verdicts = {w['verdict'] for w in got[1:]}
    assert verdicts <= {BALANCED, PRODUCER_BOUND, CONSUMER_BOUND}
    assert any(w['quantiles'] for w in got[1:])


def test_rollup_ring_bound_and_zero_duration_are_the_references():
    snaps = _snapshots(5, n=12)
    snaps.insert(6, (snaps[5][0], snaps[5][1], snaps[5][2]))  # a repeated time closes nothing
    for max_windows in (2, 3, 7):
        got_rollup, got = _roll('torch', snaps, max_windows)
        want_rollup, want = _roll('jax', snaps, max_windows)
        assert_close(got, want)
        assert len(got_rollup.windows()) == len(want_rollup.windows()) == max_windows
        assert_close(got_rollup.windows(last_n=2), want_rollup.windows(last_n=2))
        assert got_rollup.closed_total == want_rollup.closed_total


def test_rollup_quantiles_from_bucket_deltas():
    """The reference's quantile case through both packages' registries."""
    windows = {}
    for name, telemetry in TELEMETRY.items():
        rollup = TIMESERIES[name].WindowedRollup(max_windows=4)
        reg = telemetry.get_registry()
        hist = reg.histogram('lat', buckets=(0.01, 0.1, 1.0))
        rollup.sample(reg.snapshot(), now=0.0, wall=5.0)
        for v in [0.005] * 90 + [0.5] * 10:
            hist.observe(v)
        first = rollup.sample(reg.snapshot(), now=1.0, wall=6.0)
        hist.observe(0.05)
        windows[name] = (first, rollup.sample(reg.snapshot(), now=2.0, wall=7.0))
    assert_close(windows['torch'], windows['jax'])
    first, second = windows['torch']
    assert first['quantiles']['lat'] == {'p50': 0.01, 'p95': 1.0, 'p99': 1.0}
    assert second['quantiles']['lat']['p50'] == 0.1


def test_shares_are_the_references():
    window = {'rates': {H2D_READY: 0.7, metric_key(STAGE_SECONDS, {'stage': 'io'}): 1.4}}
    for fn in ('h2d_ready_share', 'io_wait_share'):
        assert getattr(torch_timeseries, fn)(window) == getattr(jax_timeseries, fn)(window)
        assert getattr(torch_timeseries, fn)({'rates': {}}) == 0.0


# -- anomaly detector ---------------------------------------------------------


def _window(dur=1.0, producer=0.0, consumer=0.0, rates=None, gauges=None, verdict=BALANCED,
            throughput=None, start=0.0):
    return {'start': start, 'dur_s': dur, 'rates': dict(rates or {}), 'quantiles': {},
            'gauges': dict(gauges or {}), 'producer_wait_s': producer,
            'consumer_wait_s': consumer, 'verdict': verdict, 'throughput': throughput}


def _calm(n):
    return [_window(verdict=BALANCED) for _ in range(n)]


def _flap(n=3):
    return [_window(verdict=v) for v in [PRODUCER_BOUND, CONSUMER_BOUND] * n]


ALIVE = 'petastorm_tpu_service_workers_alive'
REGISTERED = 'petastorm_tpu_service_workers_registered'

#: the reference's detector fixtures (tests/test_obs.py), as window streams
DETECTOR_STREAMS = {
    'saturated-edge-and-rearm': ([_window(producer=0.8)] * 3 + [_window(producer=0.9)]
                                 + [_window(producer=0.0)] + [_window(producer=0.8)] * 3),
    'collapse-needs-waiting-consumer': (
        [_window(throughput=100.0, consumer=0.1)] * 6
        + [_window(throughput=0.0, consumer=0.0)] * 3
        + [_window(throughput=100.0, consumer=0.1)] * 6
        + [_window(throughput=5.0, consumer=0.4)] * 2),
    'collapse-baseline-excludes-collapsed': ([_window(throughput=100.0, consumer=0.1)] * 6
                                             + [_window(throughput=5.0, consumer=0.4)] * 10),
    'flap': _flap(),
    'steady-verdicts-do-not-flap': [_window(verdict=PRODUCER_BOUND)] * 10,
    'flap-rearms-after-calm': _flap() + _calm(4) + _flap(),
    'heartbeat-gap-gauges': [_window(gauges={ALIVE: 2, REGISTERED: 2}),
                             _window(gauges={ALIVE: 1, REGISTERED: 2}),
                             _window(gauges={ALIVE: 2, REGISTERED: 2}),
                             _window(gauges={ALIVE: 1, REGISTERED: 3})],
    'heartbeat-gap-reventilation': [
        _window(rates={'petastorm_tpu_service_reventilated_total': 2.0})],
    'h2d-starvation': [_window(rates={H2D_READY: 0.7})] * 3 + [_window(rates={H2D_READY: 0.1})]
                      + [_window(rates={H2D_READY: 0.9})] * 3,
}

EXPECTED_KINDS = {
    'saturated-edge-and-rearm': ['queue_saturated'] * 2,
    'collapse-needs-waiting-consumer': ['throughput_collapse'],
    'collapse-baseline-excludes-collapsed': ['throughput_collapse'],
    'flap': ['stall_flap'],
    'steady-verdicts-do-not-flap': [],
    'flap-rearms-after-calm': ['stall_flap'] * 2,
    'heartbeat-gap-gauges': ['heartbeat_gap'] * 2,
    'heartbeat-gap-reventilation': ['heartbeat_gap'],
    'h2d-starvation': ['h2d_starvation'] * 2,
}


def _detect(name, windows):
    events = []

    def emit(kind, detail=None, window_start=None):
        event = {'kind': kind, 'detail': detail, 'window_start': window_start}
        events.append(event)
        return event

    detector = TIMESERIES[name].AnomalyDetector(emit=emit)
    returned = [detector.observe(dict(w, start=float(i))) for i, w in enumerate(windows)]
    return events, returned


@pytest.mark.parametrize('stream', sorted(DETECTOR_STREAMS))
def test_detector_fires_as_the_reference(stream):
    got, got_returned = _detect('torch', DETECTOR_STREAMS[stream])
    want, want_returned = _detect('jax', DETECTOR_STREAMS[stream])
    assert [e['kind'] for e in got] == EXPECTED_KINDS[stream]
    assert_close(got, want)
    assert_close(got_returned, want_returned)


def _random_windows(seed, n=300):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        phase = (i // 25) % 4
        dur = float(rng.choice([0.2, 0.5, 1.0]))
        out.append(_window(
            dur=dur,
            producer=float(rng.rand()) * dur * (1.0 if phase == 1 else 0.3),
            consumer=float(rng.rand()) * dur * (1.0 if phase == 2 else 0.2),
            rates={H2D_READY: (0.3 + 0.7 * float(rng.rand())) if phase == 3
                   else 0.4 * float(rng.rand())},
            gauges={ALIVE: int(rng.randint(1, 4)), REGISTERED: 3} if rng.rand() < 0.05 else {},
            verdict=[BALANCED, PRODUCER_BOUND, CONSUMER_BOUND][int(rng.randint(0, 3))]
            if phase == 0 else BALANCED,
            throughput=float(rng.choice([100.0, 2.0])) if phase == 2 else 100.0))
    return out


@pytest.mark.parametrize('seed', [0, 1])
def test_detector_on_a_random_stream_is_the_references(seed, monkeypatch):
    windows = _random_windows(seed)
    got, _ = _detect('torch', windows)
    want, _ = _detect('jax', windows)
    assert_close(got, want)
    assert {e['kind'] for e in got} >= {'queue_saturated', 'h2d_starvation'}
    # thresholds from the knobs, read the same way
    monkeypatch.setenv('PETASTORM_TPU_OBS_SATURATED_SHARE', '0.2')
    monkeypatch.setenv('PETASTORM_TPU_OBS_FLAP_FLIPS', '2')
    monkeypatch.setenv('PETASTORM_TPU_OBS_COLLAPSE_FRAC', '0.5')
    got, _ = _detect('torch', windows)
    want, _ = _detect('jax', windows)
    assert_close(got, want)


def test_record_anomaly_is_the_references():
    events = {}
    for name, timeseries in TIMESERIES.items():
        with pytest.raises(ValueError, match='ANOMALY_KINDS'):
            timeseries.record_anomaly('made_up_kind')
        events[name] = timeseries.record_anomaly('queue_saturated', detail={'x': 1},
                                                 window_start=3.0)
        assert TELEMETRY[name].get_registry().counter_value(
            timeseries.ANOMALY_EVENTS, kind='queue_saturated') == 1
    for event in events.values():
        event.pop('ts')
    assert events['torch'] == events['jax']
    reports = {name: TELEMETRY[name].pipeline_report() for name in TELEMETRY}
    got, want = reports['torch']['anomalies'], reports['jax']['anomalies']
    assert got['by_kind'] == want['by_kind'] == {'queue_saturated': 1}
    assert [e['kind'] for e in got['recent']] == [e['kind'] for e in want['recent']]
    assert 'anomalies: 1 event(s) (queue_saturated: 1)' in \
        torch_telemetry.format_pipeline_report(reports['torch'])
    assert torch_timeseries.anomaly_counts() == jax_timeseries.anomaly_counts()


def test_no_anomaly_section_while_the_plane_is_idle():
    assert 'anomalies' not in torch_telemetry.pipeline_report()
    assert 'slo' not in torch_telemetry.pipeline_report()


def test_heartbeat_summarizer_is_the_references(monkeypatch):
    summaries = {}
    for name, telemetry in TELEMETRY.items():
        clock = iter([10.0, 10.0, 10.0, 12.0, 12.0])
        monkeypatch.setattr(TIMESERIES[name], 'time',
                            types.SimpleNamespace(monotonic=lambda: next(clock)))
        summarizer = TIMESERIES[name].HeartbeatSummarizer(worker_id=7)
        first = summarizer.summary(obs_port=1234)
        for i in range(30):
            telemetry.get_registry().counter('c_total', i=str(i)).inc(float(i + 1))
        second = summarizer.summary()
        monkeypatch.undo()
        summaries[name] = (first, second)
    for first, second in summaries.values():
        assert first['worker_id'] == 7 and first['obs_port'] == 1234 and 'rates' not in first
        assert len(second['rates']) == 24
    assert summaries['torch'] == summaries['jax']


# -- SLO ----------------------------------------------------------------------

SPECS = [
    'rows_per_sec>=40000;queue_wait_p99<=50ms;append_staleness<=30s;h2d_overlap>=0.3',
    'frames_per_sec>=10;rows_per_sec=10;queue_wait_p99<=fastms;;rows_per_sec>=100',
    '',
    None,
    ' queue_wait_p99 <= 0.05ms ',
    'h2d_overlap>=0.3;rows_per_sec>=1',
    'append_staleness<=2s;h2d_overlap<=1;rows_per_sec>=1e3',
    'rows_per_sec>=;queue_wait_p99<=ms',
]


@pytest.mark.parametrize('spec', SPECS, ids=range(len(SPECS)))
def test_parse_spec_is_the_references(spec):
    assert torch_slo.parse_spec(spec) == jax_slo.parse_spec(spec)


def _slo_windows(seed, n=90):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        bad = (i // 15) % 2 == 1
        window = {'start': 100.0 + i, 'throughput': float(rng.rand() * (50 if bad else 500)),
                  'quantiles': {}, 'gauges': {}, 'rates': {}}
        if rng.rand() < 0.8:
            window['quantiles'][QW_DURATION] = {'p99': float(rng.choice([0.001, 0.025, 0.1]))}
        if rng.rand() < 0.7:
            window['rates'] = {STAGE_FILL: float(rng.rand()), H2D_DISPATCH: 0.1,
                               H2D_READY: float(rng.rand()) * (2.0 if bad else 0.2)}
        if rng.rand() < 0.3:
            window['gauges']['petastorm_tpu_append_staleness_s'] = float(rng.rand() * 60)
        if i % 17 == 3:
            window = {'start': 100.0 + i, 'quantiles': {}, 'gauges': {}, 'rates': {}}
        out.append(window)
    return out


@pytest.mark.parametrize('seed', [0, 1])
def test_slo_policy_is_the_references(seed):
    spec = SPECS[0]
    windows = _slo_windows(seed)
    results = {}
    for name, slo in SLO.items():
        policy = slo.SloPolicy(slo.parse_spec(spec))
        verdicts = [policy.observe(w) for w in windows]
        sections = policy.section()
        breaches = [e for e in TIMESERIES[name].recent_anomalies(200)
                    if e['kind'] == 'slo_breach']
        registry = TELEMETRY[name].get_registry()
        metrics = ({k: v for k, v in registry.snapshot()['counters'].items() if 'slo' in k},
                   {k: v for k, v in registry.snapshot()['gauges'].items() if 'slo' in k})
        results[name] = (verdicts, sections, [(e['detail'], e['window_start']) for e in breaches],
                         metrics)
    assert_close(results['torch'], results['jax'])
    verdicts, _, breaches, _ = results['torch']
    assert any(v is None for v in verdicts) and breaches


def test_budget_and_section_of_the_reference_case():
    """The reference's budget case: 1 bad of 20 windows leaves half."""
    sections = {}
    for name, slo in SLO.items():
        policy = slo.SloPolicy(slo.parse_spec('rows_per_sec>=100'))
        policy.observe({'start': 0.0, 'throughput': 10.0})
        for i in range(19):
            policy.observe({'start': 1.0 + i, 'throughput': 500.0})
        sections[name] = policy.section()
        assert TELEMETRY[name].get_registry().gauge_value(
            slo.SLO_BUDGET_REMAINING, target='rows_per_sec') == pytest.approx(0.5)
    assert sections['torch'] == sections['jax']
    assert sections['torch']['targets'][0]['budget_remaining'] == pytest.approx(0.5)


def test_policy_follows_the_knob_as_the_reference(monkeypatch):
    for name, slo in SLO.items():
        assert slo.get_policy() is None
        monkeypatch.setenv('PETASTORM_TPU_SLO', 'rows_per_sec>=100')
        policy = slo.get_policy()
        policy.observe({'start': 0.0, 'throughput': 10.0})
        TELEMETRY[name].refresh()
        assert slo.get_policy() is policy
        monkeypatch.setenv('PETASTORM_TPU_SLO', 'rows_per_sec>=200')
        assert slo.get_policy() is not policy
        assert slo.observe_window({'start': 1.0, 'throughput': 10.0})['targets'][0]['bad']
        monkeypatch.delenv('PETASTORM_TPU_SLO')
        assert slo.get_policy() is None and slo.slo_section() is None
        assert slo.observe_window({'start': 1.0}) is None


QOS = [
    {'job_id': 1, 'name': 'starved', 'worker_share': 0.2, 'target_share': 0.5},
    {'job_id': 2, 'name': 'donor', 'worker_share': 0.6, 'target_share': 0.3},
    {'job_id': 3, 'name': 'even', 'worker_share': 0.5, 'target_share': 0.5},
    {'job_id': 4, 'name': None, 'worker_share': None, 'target_share': 0.04},
    {'job_id': 5},
]


@pytest.mark.parametrize('state', ['burning', 'calm', 'none'])
def test_qos_weight_advice_is_the_references(state):
    slo_view = {'burning': {'targets': [{'breaching': True}]},
                'calm': {'targets': [{'breaching': False}]}, 'none': None}[state]
    got = torch_slo.qos_weight_advice(QOS, slo=slo_view)
    assert got == jax_slo.qos_weight_advice(QOS, slo=slo_view)
    assert torch_slo.qos_weight_advice([], slo=slo_view) == []
    if state == 'burning':
        assert [a['advice'] for a in got[:3]] == ['raise_weight', 'lower_weight', 'ok']
