"""petastorm_tpu_torch's pipeline report and the telemetry pieces under
it, against the JAX package's, on the CPU.

The same read (dummy pool) through both packages gives a report with the
same stage set, the same calls per stage and the same keys, apart from
the sections the port does not have yet (both packages' readahead planes
and autotuners are switched off, so the fetch threads' timing-dependent
calls stay out of the exact comparison). Both reports
over the same registry and attributor are equal outside ``stage_order``;
the ``h2d_overlap_share``, ``pushdown`` and ``critical_path`` sections
and the text rendering are the reference's. Also the registry's gauges
and reads, the knobs, ``count_swallowed``, ``register_refresh`` /
``refresh`` and ``reset_for_tests``.
"""

import types

import pytest

from petastorm_tpu import reader as jax_reader
from petastorm_tpu import telemetry as jax_telemetry
from petastorm_tpu.jax import make_jax_loader
from petastorm_tpu.telemetry import export as jax_export
from petastorm_tpu.telemetry import knobs as jax_knobs
from petastorm_tpu.telemetry import registry as jax_registry
from petastorm_tpu_torch import pushdown as torch_pushdown
from petastorm_tpu_torch import reader as torch_reader
from petastorm_tpu_torch import telemetry as torch_telemetry
from petastorm_tpu_torch.device.loader import InMemoryCachedLoader, TorchLoader, make_torch_loader
from petastorm_tpu_torch.telemetry import export as torch_export
from petastorm_tpu_torch.telemetry import knobs as torch_knobs
from petastorm_tpu_torch.telemetry import registry as torch_registry
from petastorm_tpu_torch.telemetry import stall as torch_stall
from petastorm_tpu_torch.telemetry.names import STAGES
from tests.torch_telemetry_common import (  # noqa: F401 - fixtures
    telemetry_guard, traced, write_small_dataset,
)

PACKAGES = {'jax': (jax_telemetry, jax_reader), 'torch': (torch_telemetry, torch_reader)}

#: report sections of subsystems the port does not have yet
PORT_LACKS = {'service', 'peer_cache', 'write'}


@pytest.fixture(scope='module')
def small_url(tmp_path_factory):
    return write_small_dataset('file://' + str(tmp_path_factory.mktemp('report') / 'ds'))


@pytest.fixture
def reference_shape(monkeypatch):
    # one knob each turns both packages' plane off
    for knob in ('PETASTORM_TPU_READAHEAD', 'PETASTORM_TPU_STAGING_AUTOTUNE'):
        monkeypatch.setenv(knob, '0')


def _read_report(package, url, **kwargs):
    telemetry, reader = PACKAGES[package]
    telemetry.reset_registry()
    with reader.make_batch_reader(url, reader_pool_type='dummy', **kwargs) as r:
        rows = sum(len(batch.id) for batch in r)
        return rows, r.pipeline_report()


def _calls(report):
    return {stage: info['calls'] for stage, info in report['stages'].items()}


@pytest.mark.parametrize('trace', ['untraced', 'traced'])
@pytest.mark.parametrize('kwargs', [{}, {'num_epochs': 2},
                                    {'filters': [('id', '<', 35)]},
                                    {'shuffle_row_drop_partitions': 3}],
                         ids=['plain', 'two-epochs', 'filters', 'drop-partitions'])
def test_report_of_a_read_is_the_references(reference_shape, monkeypatch, small_url,
                                            trace, kwargs):
    if trace == 'traced':
        monkeypatch.setenv('PETASTORM_TPU_TRACE', '1')
    jax_telemetry.refresh()
    torch_telemetry.refresh()
    want_rows, want = _read_report('jax', small_url, **kwargs)
    got_rows, got = _read_report('torch', small_url, **kwargs)
    assert got_rows == want_rows
    assert set(got) == set(want) - PORT_LACKS
    assert _calls(got) == _calls(want)
    assert set(got['stall']) == set(want['stall'])
    assert set(got['stage_order']) == set(STAGES)
    assert ('critical_path' in got) == (trace == 'traced')
    if trace == 'traced':
        got_cp, want_cp = got['critical_path'], want['critical_path']
        assert set(got_cp) == set(want_cp)
        assert set(got_cp['stages']) == set(want_cp['stages'])
        assert (got_cp['items'], got_cp['events']) == (want_cp['items'], want_cp['events'])
        assert got_cp['bottleneck'] in got_cp['stages'] and got_cp['what_if']
    if 'filters' in kwargs:
        assert got['pushdown'] == want['pushdown']


def _fill(registry, stall_module, attributor_notes, monkeypatch):
    """The same counters, and the same waits at the same (fake) times,
    into either package's objects."""
    for stage, seconds, calls in (('io', 1.5, 10), ('decode', 3.25, 10), ('queue_wait', 0.5, 11),
                                  ('stage_fill', 0.75, 6), ('h2d_dispatch', 0.05, 6),
                                  ('h2d_ready', 0.2, 6), ('ventilate', 0.01, 10)):
        registry.counter('petastorm_tpu_stage_seconds_total', stage=stage).inc(seconds)
        registry.counter('petastorm_tpu_stage_calls_total', stage=stage).inc(calls)
    registry.counter('petastorm_tpu_stall_consumer_wait_seconds_total').inc(0.5)
    clock = types.SimpleNamespace(now=100.0)
    monkeypatch.setattr(stall_module, 'time', types.SimpleNamespace(monotonic=lambda: clock.now))
    attributor = stall_module.StallAttributor(window_s=1.0)
    for side, seconds in attributor_notes:
        getattr(attributor, 'note_%s_wait' % side)(seconds)
        clock.now += 0.4
    return attributor


@pytest.mark.parametrize('wall_time_s', [None, 4.0])
@pytest.mark.parametrize('notes', [[], [('consumer', 0.4), ('producer', 0.01)] * 4,
                                   [('producer', 0.3)] * 5], ids=['idle', 'producer', 'consumer'])
def test_report_over_the_same_metrics_is_the_references(monkeypatch, wall_time_s, notes):
    from petastorm_tpu.telemetry import stall as jax_stall
    reports = {}
    for name, registry_module, stall_module, export in (
            ('jax', jax_registry, jax_stall, jax_export),
            ('torch', torch_registry, torch_stall, torch_export)):
        registry = registry_module.MetricsRegistry()
        attributor = _fill(registry, stall_module, notes, monkeypatch)
        baseline = registry.snapshot()
        registry.counter('petastorm_tpu_stage_seconds_total', stage='io').inc(0.25)
        registry.counter('petastorm_tpu_stage_calls_total', stage='io').inc(2)
        reports[name] = (export.pipeline_report(registry, wall_time_s=wall_time_s,
                                                attributor=attributor),
                         export.pipeline_report(registry, wall_time_s=wall_time_s,
                                                baseline=baseline, attributor=attributor))
    for got, want in zip(reports['torch'], reports['jax']):
        assert got['stage_order'] == list(STAGES)
        assert {k: v for k, v in got.items() if k != 'stage_order'} == \
            {k: v for k, v in want.items() if k != 'stage_order'}
        assert got.get('h2d_overlap_share') == want.get('h2d_overlap_share')
        assert torch_export.format_pipeline_report(got) == \
            jax_export.format_pipeline_report(dict(got, stage_order=want['stage_order']))


@pytest.mark.parametrize('fill, dispatch, ready', [
    (0, 0, 0), (1.0, 0.1, 0.0), (0.5, 0.1, 0.4), (0, 0, 2.0), (0.3, 0, 0)])
def test_h2d_overlap_share_is_the_references(fill, dispatch, ready):
    stages = {name: {'seconds': s} for name, s in
              (('stage_fill', fill), ('h2d_dispatch', dispatch), ('h2d_ready', ready)) if s}
    assert torch_export._h2d_overlap_share(stages) == jax_export._h2d_overlap_share(stages)


def test_report_text_names_the_traced_sections(traced, small_url):
    with make_torch_loader(small_url, batch_size=16, reader_pool_type='dummy',
                           num_epochs=1, device='cpu', filters=[('id', '>=', 40)]) as loader:
        n = sum(len(b['id']) for b in loader)
        report = loader.pipeline_report(wall_time_s=10.0)
    assert n == 80
    assert report['pushdown']['rowgroups_pruned'] == 4
    text = torch_telemetry.format_pipeline_report(report)
    for line in ('pipeline stages (share of wall time):', 'stall attribution:',
                 'pushdown: ', 'critical path: bottleneck ', 'what-if: '):
        assert line in text
    assert report['attributed_fraction'] == round(report['total_stage_seconds'] / 10.0, 4)


def test_loader_and_reader_reports_match_the_jax_loaders(reference_shape, small_url):
    calls = {}
    for name, make in (('jax', make_jax_loader), ('torch', make_torch_loader)):
        kwargs = {'device': 'cpu'} if name == 'torch' else {}
        PACKAGES[name][0].reset_registry()
        with make(small_url, batch_size=16, reader_pool_type='dummy', num_epochs=1,
                  **kwargs) as loader:
            list(loader)
            report = loader.pipeline_report()
        calls[name] = _calls(report)
        assert set(report['stall']) == {'producer_wait_s', 'consumer_wait_s', 'verdict',
                                        'windows'}
    # the reader's stages are the reference's; the staging stages are each
    # package's own (the port on the CPU has no copy to dispatch)
    reader_stages = ('ventilate', 'io', 'decode', 'queue_wait')
    assert {s: calls['torch'][s] for s in reader_stages} == \
        {s: calls['jax'][s] for s in reader_stages}
    assert {'collate', 'stage_fill'} <= set(calls['torch'])


def test_report_and_trace_are_on_every_entry_point():
    for cls in (torch_reader.Reader, TorchLoader, InMemoryCachedLoader):
        assert callable(getattr(cls, 'pipeline_report')) and callable(getattr(cls, 'dump_trace'))


# -- registry ------------------------------------------------------------------


def _registry_reads(module):
    registry = module.MetricsRegistry()
    registry.gauge('petastorm_tpu_g', pid='1').set(3)
    registry.gauge('petastorm_tpu_g', pid='2').inc(2.5)
    registry.gauge('petastorm_tpu_g', pid='2').dec(0.5)
    registry.counter('petastorm_tpu_c', stage='io').inc(4)
    registry.counter('petastorm_tpu_c_other').inc()
    registry.histogram('petastorm_tpu_h').observe(0.003)
    return (registry.gauge_value('petastorm_tpu_g', pid='1'),
            registry.gauge_value('petastorm_tpu_g', pid='2'),
            registry.gauge_value('petastorm_tpu_missing'),
            registry.counter_value('petastorm_tpu_c', stage='io'),
            registry.counter_value('petastorm_tpu_c'),
            registry.counters_with_prefix('petastorm_tpu_c'),
            registry.counters_with_prefix('petastorm_tpu_c{'),
            registry.gauges_with_prefix('petastorm_tpu_g'),
            registry.snapshot())


def test_registry_gauges_and_reads_are_the_references():
    assert _registry_reads(torch_registry) == _registry_reads(jax_registry)


def test_gauge_is_settable_and_thread_safe():
    import threading
    gauge = torch_registry.Gauge()
    threads = [threading.Thread(target=lambda: [gauge.inc() for _ in range(1000)])
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert gauge.value == 4000.0
    gauge.set('7')
    assert gauge.value == 7.0


# -- knobs ---------------------------------------------------------------------


@pytest.mark.parametrize('value', [None, '', ' 1 ', 'true', 'ON', 'yes', '0', 'off', 'maybe'])
def test_knob_truthiness_is_the_references(monkeypatch, value):
    if value is not None:
        monkeypatch.setenv('PETASTORM_TPU_TRACE', value)
    for read in ('raw', 'get_str', 'is_enabled', 'is_disabled'):
        assert getattr(torch_knobs, read)('PETASTORM_TPU_TRACE') == \
            getattr(jax_knobs, read)('PETASTORM_TPU_TRACE'), read
    assert torch_knobs.raw('PETASTORM_TPU_TRACE', 'dflt') == \
        jax_knobs.raw('PETASTORM_TPU_TRACE', 'dflt')


@pytest.mark.parametrize('value', [None, '0.25', '3', ' 2.5 ', '-4', 'junk'])
def test_knob_numbers_are_the_references(monkeypatch, value):
    if value is not None:
        monkeypatch.setenv('PETASTORM_TPU_METRICS_WINDOW_S', value)
    for floor in (None, 0.0, 1.0):
        assert torch_knobs.get_float('PETASTORM_TPU_METRICS_WINDOW_S', 0.5, floor=floor) == \
            jax_knobs.get_float('PETASTORM_TPU_METRICS_WINDOW_S', 0.5, floor=floor)
    if value is not None and '.' not in value:
        monkeypatch.setenv('PETASTORM_TPU_TRACE_AUTODUMP_WINDOWS', value.strip())
        assert torch_knobs.get_int('PETASTORM_TPU_TRACE_AUTODUMP_WINDOWS', 6, floor=1) == \
            jax_knobs.get_int('PETASTORM_TPU_TRACE_AUTODUMP_WINDOWS', 6, floor=1)


def test_trace_knobs_are_registered_as_the_references():
    from petastorm_tpu.analysis.contracts import KNOWN_KNOBS
    for knob in ('PETASTORM_TPU_TRACE', 'PETASTORM_TPU_TRACE_SAMPLE', 'PETASTORM_TPU_TRACE_DUMP',
                 'PETASTORM_TPU_TRACE_AUTODUMP_WINDOWS', 'PETASTORM_TPU_METRICS_WINDOW_S'):
        assert knob in torch_knobs.KNOWN_KNOBS and knob in KNOWN_KNOBS
    assert torch_knobs.KNOWN_KNOBS <= KNOWN_KNOBS


def test_set_env_writes_a_registered_knob(monkeypatch):
    # the module's environment, not the process's
    fake_os = types.SimpleNamespace(environ={})
    monkeypatch.setattr(torch_knobs, 'os', fake_os)
    torch_knobs.set_env('PETASTORM_TPU_TRACE', '1')
    assert fake_os.environ == {'PETASTORM_TPU_TRACE': '1'}
    assert torch_knobs.is_enabled('PETASTORM_TPU_TRACE')
    for call in (lambda: torch_knobs.set_env('PETASTORM_TPU_TRACEE', '1'),
                 lambda: torch_knobs.raw('PETASTORM_TPU_NOPE'),
                 lambda: torch_knobs.get_float('PETASTORM_TPU_NOPE', 1.0)):
        with pytest.raises(ValueError, match='Unregistered environment knob'):
            call()
    assert fake_os.environ == {'PETASTORM_TPU_TRACE': '1'}


# -- the package's entry points ----------------------------------------------


@pytest.mark.parametrize('metrics', ['on', 'off'])
def test_count_swallowed_is_the_references(monkeypatch, metrics):
    if metrics == 'off':
        monkeypatch.setenv('PETASTORM_TPU_METRICS', 'false')
    counts = {}
    for name, (telemetry, _) in PACKAGES.items():
        telemetry.refresh()
        telemetry.count_swallowed('site-a')
        telemetry.count_swallowed('site-a')
        telemetry.count_swallowed('site-b')
        counts[name] = telemetry.get_registry().snapshot()['counters']
    assert counts['torch'] == counts['jax']
    assert torch_telemetry.SWALLOWED_ERRORS == jax_telemetry.SWALLOWED_ERRORS


def test_register_refresh_runs_with_refresh():
    seen = []

    def hook():
        seen.append(1)

    try:
        torch_telemetry.register_refresh(hook)
        torch_telemetry.register_refresh(hook)      # once only
        torch_telemetry.refresh()
        assert seen == [1]
    finally:
        torch_telemetry._extra_refreshers.remove(hook)
    torch_telemetry.refresh()
    assert seen == [1]


def test_reset_for_tests_clears_every_port_subsystem(traced, small_url):
    with torch_reader.make_batch_reader(small_url, reader_pool_type='dummy',
                                        filters=[('id', '<', 35)], predicate=None) as r:
        list(r)
    torch_telemetry.note_consumer_wait(0.5)
    torch_pushdown._note_run(4, pruned=1)
    assert len(torch_telemetry.get_recorder()) and torch_telemetry.get_attributor().totals()[1]
    registry, attributor = torch_telemetry.get_registry(), torch_telemetry.get_attributor()
    torch_telemetry.reset_for_tests()
    assert torch_telemetry.get_registry() is not registry
    assert torch_telemetry.get_attributor() is not attributor
    assert len(torch_telemetry.get_recorder()) == 0
    assert torch_pushdown.planner_summary()['planner_runs'] == 0
    assert torch_telemetry.tracing._enabled is None
    assert torch_telemetry.pipeline_report()['stages'] == {}
