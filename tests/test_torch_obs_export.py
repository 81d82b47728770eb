"""petastorm_tpu_torch's metrics registry keys and exporters against the
JAX package's, on the CPU.

The registry: ``metric_key`` escapes label values (quote, backslash,
newline) as the reference does, ``histogram(buckets=)`` takes its buckets
and makes no ``buckets`` label, buckets that do not ascend raise, and a
histogram has ``sum`` and ``count``. The exporters: two registries filled
the same way (counters, gauges, labelled series with values that need
escaping, a histogram with custom buckets) give the same Prometheus text
byte for byte, and a JSONL snapshot written by one package reads in the
other with the same state.
"""

import io
import json

import numpy as np
import pytest

from petastorm_tpu import telemetry as jax_telemetry
from petastorm_tpu.telemetry import export as jax_export
from petastorm_tpu.telemetry import registry as jax_registry
from petastorm_tpu_torch import telemetry as torch_telemetry
from petastorm_tpu_torch.telemetry import export as torch_export
from petastorm_tpu_torch.telemetry import registry as torch_registry
from tests.torch_telemetry_common import telemetry_guard  # noqa: F401 - autouse

REGISTRIES = {'jax': jax_registry, 'torch': torch_registry}
EXPORTS = {'jax': jax_export, 'torch': torch_export}
TELEMETRY = {'jax': jax_telemetry, 'torch': torch_telemetry}

AWKWARD_LABELS = [
    {'site': 'a"b\\c\nd'},
    {'site': 'plain'},
    {'path': 'C:\\data\\part-0.parquet', 'stage': 'io'},
    {'msg': 'line one\nline "two"'},
    {'z': '\\"', 'a': '\n\n'},
]


@pytest.mark.parametrize('labels', AWKWARD_LABELS, ids=range(len(AWKWARD_LABELS)))
def test_metric_key_escapes_as_the_reference(labels):
    assert torch_registry.metric_key('x', labels) == jax_registry.metric_key('x', labels)
    assert '\n' not in torch_registry.metric_key('x', labels)


def test_metric_key_of_a_quote_backslash_newline_label():
    key = torch_registry.metric_key('x', {'site': 'a"b\\c\nd'})
    assert key == 'x{site="a\\"b\\\\c\\nd"}'


def test_label_values_the_port_records_are_unchanged_by_escaping():
    """Stage, kind, site and reason labels carry no character that
    escaping touches, so their series keys are what they were."""
    from petastorm_tpu_torch.telemetry.names import ANOMALY_KINDS, STAGES
    for value in list(STAGES) + list(ANOMALY_KINDS) + ['no-statistics']:
        assert torch_registry.metric_key('m', {'stage': value}) == 'm{stage="%s"}' % value


def test_histogram_takes_buckets_and_makes_no_buckets_label():
    for name, module in REGISTRIES.items():
        reg = module.MetricsRegistry()
        hist = reg.histogram('h', buckets=(0.1, 1.0), stage='io')
        assert hist.buckets == (0.1, 1.0), name
        snap = reg.snapshot()['histograms']
        assert list(snap) == ['h{stage="io"}'], name
        assert snap['h{stage="io"}']['buckets'] == [0.1, 1.0], name


@pytest.mark.parametrize('buckets', [(1.0, 0.5), (0.1, 0.1, 1.0), ()])
def test_buckets_that_do_not_ascend_raise(buckets):
    for module in REGISTRIES.values():
        with pytest.raises(ValueError, match='strictly ascending'):
            module.Histogram(buckets)
        with pytest.raises(ValueError, match='strictly ascending'):
            module.MetricsRegistry().histogram('h', buckets=buckets)


def test_histogram_sum_and_count():
    values = np.random.RandomState(3).exponential(0.05, size=50)
    got = {}
    for name, module in REGISTRIES.items():
        hist = module.Histogram()
        for v in values:
            hist.observe(float(v))
        got[name] = (hist.sum, hist.count, hist.state())
    assert got['torch'][1] == got['jax'][1] == 50
    assert got['torch'][0] == pytest.approx(got['jax'][0], rel=0, abs=1e-12)
    assert got['torch'][2] == got['jax'][2]


def _fill(module, seed=0):
    """One registry of ``module`` filled from ``seed``."""
    rng = np.random.RandomState(seed)
    reg = module.MetricsRegistry()
    for stage in ('io', 'decode', 'queue_wait'):
        reg.counter('petastorm_tpu_stage_seconds_total', stage=stage).inc(float(rng.rand()))
        reg.counter('petastorm_tpu_stage_calls_total', stage=stage).inc(int(rng.randint(1, 9)))
    reg.counter('petastorm_tpu_plain_total').inc(3)
    reg.counter('petastorm_tpu_swallowed_errors_total', site='a"b\\c\nd').inc()
    reg.gauge('petastorm_tpu_queue_depth').set(float(rng.rand()))
    reg.gauge('petastorm_tpu_budget', target='rows_per_sec').set(0.25)
    reg.gauge('petastorm_tpu_budget', target='h2d_overlap').set(1)
    custom = reg.histogram('petastorm_tpu_custom_seconds', buckets=(0.001, 0.01, 0.1, 1.0),
                           route='metrics')
    default = reg.histogram('petastorm_tpu_stage_duration_seconds', stage='io')
    for v in rng.exponential(0.05, size=40):
        custom.observe(float(v))
        default.observe(float(v))
    reg.histogram('petastorm_tpu_empty_seconds')
    return reg


def test_prometheus_text_is_the_references_byte_for_byte():
    texts = {name: EXPORTS[name].prometheus_text(_fill(REGISTRIES[name]))
             for name in REGISTRIES}
    assert texts['torch'] == texts['jax']
    text = texts['torch']
    assert '# TYPE petastorm_tpu_custom_seconds histogram' in text
    assert 'petastorm_tpu_custom_seconds_bucket{route="metrics",le="+Inf"} 40' in text
    assert 'site="a\\"b\\\\c\\nd"' in text


def test_prometheus_text_of_the_process_registry():
    for name in REGISTRIES:
        TELEMETRY[name].get_registry().counter('petastorm_tpu_x_total', k='v').inc(2)
    assert torch_export.prometheus_text() == jax_export.prometheus_text()


@pytest.mark.parametrize('writer,reader', [('jax', 'torch'), ('torch', 'jax'),
                                           ('torch', 'torch')])
def test_jsonl_snapshot_crosses_packages(tmp_path, writer, reader):
    path = str(tmp_path / 'metrics.jsonl')
    reg = _fill(REGISTRIES[writer], seed=4)
    EXPORTS[writer].write_jsonl_snapshot(path, registry=reg, extra={'run': 'a', 'ts': 1.0})
    EXPORTS[writer].write_jsonl_snapshot(path, registry=reg)
    lines = EXPORTS[reader].read_jsonl_snapshots(path)
    assert len(lines) == 2
    snap = reg.snapshot()
    for line in lines:
        for key in ('counters', 'gauges', 'histograms'):
            assert line[key] == json.loads(json.dumps(snap[key]))
    assert lines[0]['run'] == 'a' and lines[0]['ts'] == 1.0
    assert 'anomalies' not in lines[0]


def test_jsonl_snapshot_carries_anomalies():
    for name, telemetry in TELEMETRY.items():
        telemetry.record_anomaly('stall_flap', detail={'flips': 3})
    lines = {}
    for name in REGISTRIES:
        buf = io.StringIO()
        EXPORTS[name].write_jsonl_snapshot(buf, extra={'ts': 2.0})
        lines[name] = json.loads(buf.getvalue())
    for name, line in lines.items():
        (event,) = line['anomalies']
        assert event['kind'] == 'stall_flap' and event['detail'] == {'flips': 3}, name
    strip = ('ts',)
    assert ({k: v for k, v in lines['torch']['anomalies'][0].items() if k not in strip}
            == {k: v for k, v in lines['jax']['anomalies'][0].items() if k not in strip})
    assert lines['torch']['counters'] == lines['jax']['counters']
