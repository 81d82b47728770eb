"""Telemetry and tracing through the decode service, the port against the
JAX package (the service cases of ``tests/test_telemetry_pools.py`` and
``tests/test_tracing_pools.py``): the shared pool gauges, worker-server
spans merged at the dispatcher from the DONE deltas, the stall verdict
through remote workers, and a traced item's worker-side events and the
dispatcher's instants in the consumer's recorder."""

import collections

import pytest

from petastorm_tpu_torch.workers import SHARED_POOL_GAUGES
from tests.torch_service_common import PACKAGES, both, drain
from tests.torch_stub_workers import slow_batch_identity
from tests.torch_telemetry_common import telemetry_guard, traced  # noqa: F401

pytestmark = pytest.mark.service

_POOL = dict(heartbeat_interval_s=0.2, connect_timeout_s=60)


@pytest.fixture(scope='module')
def url(tmp_path_factory):
    """8 single-row-group files (the reference tests' dataset)."""
    from tests.test_common import create_test_scalar_dataset
    url = 'file://' + str(tmp_path_factory.mktemp('telemetry') / 'dataset')
    create_test_scalar_dataset(url, num_rows=80, num_files=8)
    return url


def test_pool_gauge_name_parity_service(url):
    def run(pkg):
        with pkg.reader.make_batch_reader(url, reader_pool_type='service', workers_count=2,
                                          num_epochs=1) as reader:
            for _ in reader:
                pass
            return set(reader.diagnostics)

    out = both(run)
    assert not SHARED_POOL_GAUGES - out['torch']
    assert out['torch'] == out['jax']


def test_service_worker_deltas_aggregate_at_dispatcher():
    """Worker servers' 'decode' spans reach this process's registry in the
    DONE frames' deltas, merged by the dispatcher."""
    def run(pkg):
        pkg.telemetry.reset_for_tests()
        pool = pkg.ServicePool(spawn_local_workers=1, **_POOL)
        pool.start(pkg.stubs.SpanningSleepyWorker)
        try:
            for i in range(5):
                pool.ventilate(i, sleep_s=0.02)
            results = sorted(drain(pkg, pool))
            decode_s = pkg.telemetry.get_registry().counter_value(
                'petastorm_tpu_stage_seconds_total', stage='decode')
            return results, decode_s >= 0.08, pool.diagnostics['metrics_deltas_merged'] >= 5
        finally:
            pool.stop()
            pool.join()

    out = both(run)
    assert out['torch'] == out['jax'] == (list(range(5)), True, True)


def test_service_slow_workers_flag_producer_bound(url):
    """Remote workers slowed by a transform starve the consumer: the
    verdict is producer-bound and the transform seconds arrive from the
    worker servers."""
    def run(pkg):
        pkg.telemetry.reset_for_tests()
        pool = pkg.ServicePool(spawn_local_workers=1, **_POOL)
        with pkg.reader.make_batch_reader(url, reader_pool_type=pool,
                                          transform_spec=pkg.TransformSpec(slow_batch_identity),
                                          num_epochs=1, shuffle_row_groups=False) as reader:
            for _ in reader:
                pass
        _, consumer = pkg.telemetry.get_attributor().totals()
        transform_s = pkg.telemetry.get_registry().counter_value(
            'petastorm_tpu_stage_seconds_total', stage='transform')
        return (consumer > 0.1, pkg.telemetry.get_attributor().verdict(),
                transform_s >= 0.2)

    out = both(run)
    assert out['torch'] == (True, PACKAGES['torch'].telemetry.PRODUCER_BOUND, True)
    assert out['jax'] == (True, PACKAGES['jax'].telemetry.PRODUCER_BOUND, True)


def test_service_pool_trace_roundtrip(traced):
    """A traced item's context rides the WORK frame and is active in the
    worker server; its events ride back in the DONE's delta; the
    dispatcher stamps ``dispatch`` and ``done`` under the same trace id."""
    def run(pkg):
        pool = pkg.ServicePool(spawn_local_workers=1, **_POOL)
        ventilator = pkg.ConcurrentVentilator(
            pool.ventilate, [{'item_index': i} for i in range(6)], iterations=1)
        pool.start(pkg.stubs.TracingProbeWorker, ventilator=ventilator)
        try:
            results = dict(drain(pkg, pool))
        finally:
            pool.stop()
            pool.join()
        assert sorted(results) == list(range(6))
        for item_index, worker_side_id in results.items():
            assert worker_side_id == pkg.tracing.ctx_for(item_index, epoch=0).trace_id
        events = pkg.telemetry.get_recorder().snapshot()
        names = collections.Counter(e['name'] for e in events)
        done_ids = {e['args']['trace_id'] for e in events if e['name'] == 'done'}
        attempt_ids = {e['args']['trace_id'] for e in events if e['name'] == 'attempt'}
        assert done_ids == attempt_ids
        return {name: names[name] for name in ('attempt', 'decode', 'dispatch', 'done')}

    out = both(run)
    assert out['torch'] == out['jax'] == {'attempt': 6, 'decode': 6, 'dispatch': 6, 'done': 6}
