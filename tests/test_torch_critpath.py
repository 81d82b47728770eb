"""petastorm_tpu_torch.telemetry.critpath against the JAX package's, on
the CPU: the same event lists through both ``analyze`` give equal
per-stage total, self and overlapped seconds (abs 1e-9), the same
bottleneck, what-if lines and ``predict_speedup``; the autotuner
cross-check agrees on explicit decisions, finds nothing in a process
without the port's autotuner and reads its decisions where it runs.
The event lists hold only stages the port records."""

import random
import sys

import pytest

from petastorm_tpu import reader as jax_reader
from petastorm_tpu import telemetry as jax_telemetry
from petastorm_tpu.telemetry import critpath as jax_critpath
from petastorm_tpu_torch import reader as torch_reader
from petastorm_tpu_torch import telemetry as torch_telemetry
from petastorm_tpu_torch.telemetry import critpath as torch_critpath
from petastorm_tpu_torch.telemetry.names import STAGES
from tests.torch_telemetry_common import (  # noqa: F401 - fixtures
    telemetry_guard, traced, write_small_dataset,
)

ABS = 1e-9


def _x(name, ts, dur, item=0, tid='thread-0'):
    return {'name': name, 'ph': 'X', 'ts': float(ts), 'dur': float(dur), 'pid': 1, 'tid': tid,
            'args': {'trace_id': 'run-e0-i%d' % item, 'item': item, 'epoch': 0}}


def _lifeline(item, t0, io=300, decode=500, wait=200):
    """ventilate → io → decode inside an attempt, then the consumer's
    queue_wait overlapping the decode, then collate on the stager."""
    return [
        _x('ventilate', t0, 10, item, 'ventilator'),
        _x('attempt', t0 + 10, io + decode, item),
        _x('io', t0 + 10, io, item),
        _x('decode', t0 + 10 + io, decode, item),
        _x('queue_wait', t0 + 10 + io + decode - wait, wait, item, 'consumer'),
        _x('collate', t0 + 20 + io + decode, 40, item, 'stager'),
        _x('stage_fill', t0 + 60 + io + decode, 30, item, 'stager'),
    ]


def _random_events(seed, n=60):
    rng = random.Random(seed)
    events = []
    for i in range(n):
        start = rng.uniform(0, 5e4)
        events.append(_x(rng.choice(STAGES), start, rng.choice([0, rng.uniform(1, 3e3)]),
                         item=rng.randrange(8)))
    # instants, envelopes and names outside the stages are skipped
    events.append({'name': 'mixture_pull', 'ph': 'X', 'ts': 10.0, 'dur': 5.0, 'args': {}})
    events.append({'name': 'done', 'ph': 'i', 'ts': 3.0, 'args': {'trace_id': 'x'}})
    return events


EVENT_LISTS = {
    'one-lifeline': _lifeline(0, 0),
    'overlapped-workers': sum((_lifeline(i, 150 * i) for i in range(6)), []),
    'io-bound': sum((_lifeline(i, 1000 * i, io=900, decode=50) for i in range(4)), []),
    'wait-only': [_x('queue_wait', 0, 100), _x('ventilate', 50, 100)],
    'staging': [_x('h2d_ready', 0, 80), _x('stage_fill', 40, 80), _x('h2d_dispatch', 100, 5),
                _x('decode_fused', 110, 300), _x('pack', 150, 60), _x('transform', 500, 9)],
    'random-1': _random_events(1),
    'random-2': _random_events(2),
    'random-3': _random_events(3, n=200),
}


def _assert_reports_equal(got, want):
    assert (got is None) == (want is None)
    if want is None:
        return
    for key in ('items', 'events', 'bottleneck', 'what_if', 'recommendation'):
        assert got[key] == want[key], key
    assert got['span_s'] == pytest.approx(want['span_s'], abs=ABS)
    assert list(got['stages']) == list(want['stages'])
    for stage, info in want['stages'].items():
        for key, value in info.items():
            assert got['stages'][stage][key] == pytest.approx(value, abs=ABS), (stage, key)


@pytest.mark.parametrize('name', sorted(EVENT_LISTS))
def test_analyze_is_the_references(name):
    events = EVENT_LISTS[name]
    _assert_reports_equal(torch_critpath.analyze(events), jax_critpath.analyze(events))


@pytest.mark.parametrize('name', sorted(EVENT_LISTS))
@pytest.mark.parametrize('factor', [1.5, 2, 4])
def test_predict_speedup_is_the_references(name, factor):
    events = EVENT_LISTS[name]
    for stage in STAGES:
        assert torch_critpath.predict_speedup(stage, factor, events=events) == \
            jax_critpath.predict_speedup(stage, factor, events=events), stage


def test_self_time_goes_to_productive_work():
    report = torch_critpath.analyze(EVENT_LISTS['one-lifeline'])
    stages = report['stages']
    assert report['bottleneck'] == 'decode'
    # the queue_wait lies under the decode: all of it is slack
    assert stages['queue_wait']['self_s'] == 0.0
    assert stages['queue_wait']['overlap_s'] == pytest.approx(200e-6, abs=ABS)
    assert stages['decode']['self_s'] == pytest.approx(500e-6, abs=ABS)
    assert report['items'] == 1 and report['events'] == 6


def test_priority_is_the_references_over_the_port_stages():
    # a stage outside the reference's explicit order (the fleet cache tier's
    # peer_fetch) ranks after it in both packages
    assert set(torch_critpath._PRIORITY) == {s for s in STAGES if s in jax_critpath._PRIORITY}
    assert set(STAGES) - set(torch_critpath._PRIORITY) == {'peer_fetch'}
    assert list(torch_critpath._PRIORITY) == [s for s in jax_critpath._PRIORITY if s in STAGES]


def test_nothing_to_analyze():
    for critpath in (torch_critpath, jax_critpath):
        assert critpath.analyze([]) is None
        assert critpath.analyze([_x('attempt', 0, 10), _x('io', 5, 0)]) is None
        assert critpath.predict_speedup('io', 2, events=[]) is None
        assert critpath.critpath_section([]) is None
    assert torch_critpath.predict_speedup('io', 2, events=EVENT_LISTS['wait-only']) is None


DECISIONS = [{'action': a} for a in (
    'deepen_slots', 'deepen_prefetch', 'raise_inflight', 'deepen_readahead', 'shed_readahead',
    'lower_inflight', 'shed_decode_threads', 'restore_decode_threads', 'unknown_action')]


@pytest.mark.parametrize('name', ['one-lifeline', 'io-bound', 'staging', 'wait-only'])
def test_autotuner_crosscheck_is_the_references(name):
    events = EVENT_LISTS[name]
    want = jax_critpath.crosscheck_autotuner(jax_critpath.analyze(events), DECISIONS)
    got = torch_critpath.crosscheck_autotuner(torch_critpath.analyze(events), DECISIONS)
    assert got == want
    for telemetry, critpath in ((jax_telemetry, jax_critpath), (torch_telemetry, torch_critpath)):
        counted = {v: telemetry.get_registry().counter_value(critpath.CRITPATH_AGREEMENT,
                                                              verdict=v)
                   for v in ('agree', 'disagree')}
        assert counted == {v: sum(1 for d in got if d['verdict'] == v)
                           for v in ('agree', 'disagree')}


def test_crosscheck_finds_no_port_autotuner(monkeypatch):
    # a process that never imported the autotuner: nothing to cross-check
    monkeypatch.delitem(sys.modules, torch_critpath.AUTOTUNE_MODULE, raising=False)
    report = torch_critpath.analyze(EVENT_LISTS['one-lifeline'])
    assert torch_critpath.crosscheck_autotuner(report) is None
    assert torch_critpath.crosscheck_autotuner(report, decisions=[]) is None
    section = torch_critpath.critpath_section(EVENT_LISTS['one-lifeline'])
    assert 'autotune_crosscheck' not in section
    _assert_reports_equal(section, jax_critpath.analyze(EVENT_LISTS['one-lifeline']))


def test_crosscheck_reads_the_port_autotuners_decisions():
    """Decisions the port's autotuner recorded are what the cross-check
    reads when none are given, with the reference's verdicts."""
    from petastorm_tpu_torch.device import autotune
    for decision in DECISIONS[:-1]:
        autotune.record_decision(decision['action'])
    report = torch_critpath.analyze(EVENT_LISTS['io-bound'])
    got = torch_critpath.crosscheck_autotuner(report)
    assert [v['action'] for v in got] == [d['action'] for d in DECISIONS[:-1]][-10:]
    assert got == jax_critpath.crosscheck_autotuner(
        jax_critpath.analyze(EVENT_LISTS['io-bound']), DECISIONS[:-1])
    section = torch_critpath.critpath_section(EVENT_LISTS['io-bound'])
    assert section['autotune_crosscheck']['decisions'] == len(got)


@pytest.fixture(scope='module')
def small_url(tmp_path_factory):
    return write_small_dataset('file://' + str(tmp_path_factory.mktemp('critpath') / 'ds'),
                               rows=60)


def test_recorder_analysis_covers_the_same_stages_as_the_reference(traced, small_url):
    reports = {}
    for name, reader, telemetry, critpath in (
            ('jax', jax_reader, jax_telemetry, jax_critpath),
            ('torch', torch_reader, torch_telemetry, torch_critpath)):
        with reader.make_batch_reader(small_url, reader_pool_type='dummy', num_epochs=2) as r:
            list(r)
        reports[name] = critpath.analyze()
        # the same analysis as the recorder's explicit snapshot
        assert critpath.analyze(telemetry.get_recorder().snapshot()) == reports[name]
    assert set(reports['torch']['stages']) == set(reports['jax']['stages']) == {
        'ventilate', 'io', 'decode', 'queue_wait'}
    assert reports['torch']['items'] == reports['jax']['items'] == 12
    assert reports['torch']['events'] == reports['jax']['events'] == 48
