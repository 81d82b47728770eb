"""petastorm_tpu_torch's HTTP observability endpoint, end to end on the
CPU, against the JAX package's.

* Unarmed (``PETASTORM_TPU_OBS_PORT`` unset, or metrics off), a port
  reader or loader pass starts no thread, server or sampler, and its
  mount is the shared no-op.
* Armed on port 0, the port's reader (dummy and thread pools) and
  ``make_torch_loader(device='cpu')`` answer on all five routes;
  ``/metrics`` is valid Prometheus text and ``/health`` has the reader's
  and the loader's entries with the reference's keys.
* The reference's slow-consumer drill (a results queue of one, two
  workers, a consumer that sleeps 0.12 s a batch, an SLO below the first
  bucket) runs through both packages' readers and loaders: the same
  anomaly kinds fire, ``/health`` turns to ``slo-breach``, and the final
  report shows the budget spent.
* ``refresh()`` reconfigures a live collector in place, report entries
  never overwrite each other, and the sampler ticks and counts.

Every port binds is 0; knobs go through ``monkeypatch``.
"""

import json
import threading
import time
import urllib.request

import pytest

from petastorm_tpu import reader as jax_reader
from petastorm_tpu import telemetry as jax_telemetry
from petastorm_tpu.jax import make_jax_loader
from petastorm_tpu.telemetry import obs_server as jax_obs_server
from petastorm_tpu_torch import reader as torch_reader
from petastorm_tpu_torch import telemetry as torch_telemetry
from petastorm_tpu_torch.device.loader import make_torch_loader
from petastorm_tpu_torch.telemetry import obs_server, slo, timeseries
from tests.torch_telemetry_common import (  # noqa: F401 - fixtures
    OBS_THREAD_PREFIXES, reset_both, telemetry_guard, write_small_dataset,
)

#: the reference's /health keys of a reader and of a loader
READER_HEALTH_KEYS = {'started', 'stopped', 'last_row_consumed', 'num_epochs', 'row_groups',
                      'cur_shard', 'shard_count', 'pruned_items', 'ventilate_extra'}
LOADER_HEALTH_KEYS = {'epoch', 'exhausted', 'batches_delivered', 'stage_queue_depth', 'prefetch',
                      'consumer_wait_s', 'stage_backpressure_s', 'staging_enabled',
                      'fused_decode_mode', 'h2d_overlap_share', 'staging_prefetch',
                      'staging_slot_depth', 'staging_autotune_decisions'}
#: batches the slow consumer takes, and its sleep per batch
DRILL_BATCHES = 20
DRILL_SLEEP_S = 0.12


@pytest.fixture(scope='module')
def small_url(tmp_path_factory):
    return write_small_dataset('file://' + str(tmp_path_factory.mktemp('obs') / 'ds'),
                               rows=160, rowgroup_size_rows=8)


def _obs_threads():
    return [t.name for t in threading.enumerate() if t.name.startswith(OBS_THREAD_PREFIXES)]


def _arm(monkeypatch, window_sec='0.2', **extra):
    monkeypatch.setenv('PETASTORM_TPU_OBS_PORT', '0')
    monkeypatch.setenv('PETASTORM_TPU_OBS_WINDOW_SEC', window_sec)
    for name, value in extra.items():
        monkeypatch.setenv(name, value)
    jax_telemetry.refresh()
    torch_telemetry.refresh()


def _get(route, server=obs_server):
    port = server.server_port()
    assert port, 'no endpoint bound'
    return urllib.request.urlopen('http://127.0.0.1:%d%s' % (port, route), timeout=10).read()


def _get_json(route, server=obs_server):
    return json.loads(_get(route, server))


def parse_prometheus(text):
    """``{series_key: value}`` of one exposition; fails unless every
    family has a ``# TYPE`` line before its series, every other line is
    ``key value`` and every histogram's ``_bucket`` counts are cumulative
    up to a ``+Inf`` bucket that equals ``_count``."""
    types, series = {}, {}
    for line in text.splitlines():
        if line.startswith('# TYPE '):
            _, _, name, kind = line.split(' ')
            types[name] = kind
            continue
        key, value = line.rsplit(' ', 1)
        name = key.split('{', 1)[0]
        family = name
        for suffix in ('_bucket', '_sum', '_count'):
            if name.endswith(suffix) and types.get(name[:-len(suffix)]) == 'histogram':
                family = name[:-len(suffix)]
        assert family in types, line
        series[key] = float(value)
    buckets = {}
    for key, value in series.items():
        if '_bucket{' in key:
            base = key.split('_bucket{', 1)[0] + '|' + ','.join(
                p for p in key.split('{', 1)[1][:-1].split(',') if not p.startswith('le='))
            buckets.setdefault(base, []).append((key, value))
    for base, rows in buckets.items():
        values = [v for _, v in rows]
        assert values == sorted(values), base
        assert rows[-1][0].endswith('le="+Inf"}'), base
    return series


# -- unarmed: nothing starts ---------------------------------------------------


@pytest.mark.parametrize('pool', ['dummy', 'thread'])
def test_no_thread_or_server_without_the_port(small_url, pool):
    assert not timeseries.obs_enabled()
    with torch_reader.make_batch_reader(small_url, reader_pool_type=pool, workers_count=1,
                                        shuffle_row_groups=False) as reader:
        assert reader._obs_mount is obs_server._NOOP_MOUNT
        assert sum(len(b.id) for b in reader) == 160
    with make_torch_loader(small_url, batch_size=16, device='cpu', workers_count=1) as loader:
        assert loader._obs_mount is obs_server._NOOP_MOUNT
        assert sum(len(b['id']) for b in loader) == 160
    assert obs_server._state.server is None and obs_server._state.thread is None
    assert timeseries._collector is None and not timeseries.collector_running()
    assert not _obs_threads()


def test_no_thread_or_server_with_metrics_off(small_url, monkeypatch):
    monkeypatch.setenv('PETASTORM_TPU_METRICS', '0')
    _arm(monkeypatch)
    assert not timeseries.obs_enabled()
    assert obs_server.mount('x') is obs_server._NOOP_MOUNT
    assert timeseries.ensure_collector() is None
    with torch_reader.make_batch_reader(small_url, reader_pool_type='dummy') as reader:
        assert reader._obs_mount is obs_server._NOOP_MOUNT
        for _ in reader:
            pass
    assert obs_server._state.server is None and obs_server.server_port() is None
    assert obs_server.server_address() is None and not _obs_threads()


@pytest.mark.parametrize('value,want', [('', None), ('0', 0), ('8123', 8123), ('-4', 0)])
def test_requested_port_is_the_references(monkeypatch, value, want):
    monkeypatch.setenv('PETASTORM_TPU_OBS_PORT', value)
    assert obs_server.requested_port() == jax_obs_server.requested_port() == want


# -- armed: the five routes ----------------------------------------------------


def _assert_routes_live(expect_components):
    series = parse_prometheus(_get('/metrics').decode())
    assert any(k.startswith('petastorm_tpu_stage_seconds_total{') for k in series)
    report = _get_json('/report')
    assert {'stages', 'stall', 'rollup', 'anomalies'} <= set(report)
    health = _get_json('/health')
    assert health['status'] == 'ok' and health['uptime_s'] >= 0
    for prefix in expect_components:
        assert any(name.startswith(prefix) for name in health['components']), health
    assert 'traceEvents' in _get_json('/trace')
    assert isinstance(_get_json('/critpath'), dict)
    with pytest.raises(urllib.error.HTTPError):
        _get('/nope')
    return report, health


@pytest.mark.parametrize('pool', ['dummy', 'thread'])
def test_routes_answer_on_the_reader(small_url, monkeypatch, pool):
    _arm(monkeypatch)
    with torch_reader.make_batch_reader(small_url, reader_pool_type=pool, workers_count=1,
                                        shuffle_row_groups=False) as reader:
        assert reader._obs_mount.live
        for _ in reader:
            pass
        _, health = _assert_routes_live(['reader'])
        assert set(health['components']['reader']) >= READER_HEALTH_KEYS | {'items_processed'}
        assert health['components']['reader']['started']
        assert obs_server.server_address()[0] == '127.0.0.1'
    assert obs_server._state.mounts == {}
    assert _get_json('/health')['components'] == {}
    assert sorted(_obs_threads()) == ['petastorm-tpu-torch-obs-http',
                                      'petastorm-tpu-torch-obs-sampler']


def test_routes_answer_on_the_torch_loader(small_url, monkeypatch):
    _arm(monkeypatch, PETASTORM_TPU_TRACE='1')
    torch_telemetry.refresh()
    with make_torch_loader(small_url, batch_size=16, device='cpu', workers_count=1,
                           shuffle_row_groups=False) as loader:
        assert sum(len(b['id']) for b in loader) == 160
        report, health = _assert_routes_live(['reader', 'torch-loader'])
        loader_health = health['components']['torch-loader']
        assert set(loader_health) == LOADER_HEALTH_KEYS
        assert loader_health['batches_delivered'] == 10
        assert report['torch_loader']['batches_delivered'] == 10
        trace = _get_json('/trace')
        tracks = {e['args']['name'] for e in trace['traceEvents'] if e.get('ph') == 'M'}
        assert {'ventilator', 'consumer'} <= tracks
        assert _get_json('/critpath')['bottleneck']
        scrapes = torch_telemetry.get_registry().counters_with_prefix(obs_server.OBS_SCRAPES)
        assert set(scrapes) >= {'%s{route="%s"}' % (obs_server.OBS_SCRAPES, r)
                                for r in ('metrics', 'report', 'health', 'trace', 'critpath')}


def test_health_has_the_references_shape(small_url, monkeypatch):
    """The same loader job through both packages: the same top-level
    keys, and the loader entries differ only in the reference's
    ``autotune`` report and the component name."""
    _arm(monkeypatch)
    docs = {}
    for name, make, server in (('jax', make_jax_loader, jax_obs_server),
                               ('torch', make_torch_loader, obs_server)):
        kwargs = {'device': 'cpu'} if name == 'torch' else {}
        with make(small_url, batch_size=16, workers_count=1, num_epochs=1,
                  shuffle_row_groups=False, **kwargs) as loader:
            for _ in loader:
                pass
            docs[name] = (_get_json('/health', server), _get_json('/report', server))
        reset_both()
    (jh, jr), (th, tr) = docs['jax'], docs['torch']
    assert set(th) == set(jh)
    assert set(th['components']) == {'reader', 'torch-loader'}
    assert set(jh['components']) == {'reader', 'jax-loader'}
    assert set(th['components']['torch-loader']) == set(jh['components']['jax-loader'])
    assert READER_HEALTH_KEYS <= set(th['components']['reader'])
    assert READER_HEALTH_KEYS <= set(jh['components']['reader'])
    assert set(tr) - {'torch_loader'} <= set(jr)
    assert set(tr['rollup']) == set(jr['rollup'])


# -- the slow-consumer drill, both packages -----------------------------------


def _drill(package, kind, url):
    """Slow consumer over a one-slot results queue; returns the live
    ``/health`` doc once it reads ``slo-breach`` (or the last one), the
    live ``/report`` anomalies and the final report."""
    server = {'jax': jax_obs_server, 'torch': obs_server}[package]
    telemetry = {'jax': jax_telemetry, 'torch': torch_telemetry}[package]
    reader_module = {'jax': jax_reader, 'torch': torch_reader}[package]
    kwargs = dict(workers_count=2, results_queue_size=1, num_epochs=None,
                  shuffle_row_groups=False)
    if kind == 'reader':
        source = reader_module.make_batch_reader(url, reader_pool_type='thread', **kwargs)
    elif package == 'torch':
        source = make_torch_loader(url, batch_size=8, device='cpu', **kwargs)
    else:
        source = make_jax_loader(url, batch_size=8, **kwargs)
    health = None
    with source:
        for i, _ in enumerate(source):
            time.sleep(DRILL_SLEEP_S)
            if i + 1 == DRILL_BATCHES:
                break
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            health = _get_json('/health', server)
            if health['status'] == 'slo-breach':
                break
            time.sleep(0.05)
        live = _get_json('/report', server).get('anomalies') or {}
    return health, live, telemetry.pipeline_report()


@pytest.mark.parametrize('kind', ['reader', 'loader'])
def test_slow_consumer_drill_matches_the_reference(small_url, monkeypatch, kind):
    _arm(monkeypatch, PETASTORM_TPU_SLO='queue_wait_p99<=0.05ms')
    results = {}
    for package in ('jax', 'torch'):
        results[package] = _drill(package, kind, small_url)
        reset_both()
    kinds = {}
    for package, (health, live, final) in results.items():
        assert health['status'] == 'slo-breach', (package, health)
        target = health['slo']['targets'][0]
        assert target['target'] == 'queue_wait_p99' and target['breaching']
        assert target['windows_bad'] >= slo._MIN_WINDOWS
        (final_target,) = final['slo']['targets']
        assert final_target['breaching'] and final_target['budget_remaining'] == 0
        assert set(live['by_kind']) == set(final['anomalies']['by_kind'])
        kinds[package] = set(final['anomalies']['by_kind'])
    assert kinds['torch'] == kinds['jax']
    assert {'queue_saturated', 'slo_breach'} <= kinds['torch']


# -- refresh, report entries, the sampler --------------------------------------


def test_refresh_reconfigures_a_live_collector(monkeypatch):
    _arm(monkeypatch, window_sec='0.2')
    collector = timeseries.ensure_collector()
    assert collector is timeseries.ensure_collector()
    assert collector.window_s == pytest.approx(0.2)
    detector = collector.detector
    assert detector._saturated_share == pytest.approx(0.5)
    detector._active.add('queue_saturated')
    detector._sat_streak = 3
    monkeypatch.setenv('PETASTORM_TPU_OBS_WINDOW_SEC', '0.7')
    monkeypatch.setenv('PETASTORM_TPU_OBS_SATURATED_SHARE', '0.25')
    torch_telemetry.refresh()
    assert collector.window_s == pytest.approx(0.7)
    assert collector.detector is detector
    assert detector._saturated_share == pytest.approx(0.25)
    assert 'queue_saturated' in detector._active and detector._sat_streak == 3


def test_report_entries_never_overwrite(monkeypatch):
    _arm(monkeypatch)
    obs_server.mount('a', report=lambda: {'autotune': {'who': 'a'}, 'stall': 'clobber'})
    obs_server.mount('b', report=lambda: {'autotune': {'who': 'b'}})
    obs_server.mount('c', report=lambda: ['not', 'a', 'dict'])
    obs_server.mount('a', health=lambda: 1 / 0)
    obs_server.mount('a', health=lambda: {'n': 2})
    report = obs_server.build_report()
    assert report['autotune'] == {'who': 'a'} and report['autotune-2'] == {'who': 'b'}
    assert isinstance(report['stall'], dict) and report['stall-2'] == 'clobber'
    components = obs_server.build_health()['components']
    assert 'ZeroDivisionError' in components['a']['error'] and components['a-2'] == {'n': 2}


def test_sampler_ticks_and_counts(monkeypatch, tmp_path):
    _arm(monkeypatch, window_sec='0.05', PETASTORM_TPU_OBS_LOG_DIR=str(tmp_path))
    torch_telemetry.refresh()
    collector = timeseries.ensure_collector()
    deadline = time.monotonic() + 20
    while collector.rollup.closed_total < 3 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert collector.rollup.closed_total >= 3
    registry = torch_telemetry.get_registry()
    assert registry.counter_value(timeseries.OBS_WINDOWS) >= 2
    section = timeseries.rollup_section()
    assert section['headline']['windows_sampled'] >= 3 and len(section['windows']) <= 12
    # the collector and ticks by hand write the same log records
    assert collector.tick()['dur_s'] > 0
    from petastorm_tpu_torch.telemetry import obslog
    assert {r['kind'] for r in obslog.read_log(str(tmp_path))} == {'window'}
