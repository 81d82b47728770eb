"""The port's decode service against the JAX package's, case for case with
``tests/test_service.py``: each case runs the same input through both
packages' ``ServicePool`` (or reader, or loader) and compares the results
and the diagnostics keys. Worker servers are real processes over
``tcp://`` loopback (``tests/torch_service_common.py``)."""

import os
import signal
import time

import numpy as np
import pytest

from petastorm_tpu.jax import make_jax_loader
from petastorm_tpu_torch.device.loader import make_torch_loader
from tests.torch_service_common import (
    FAST, PACKAGES, both, cli_worker_servers, drain, read_id_multiset,
)
from tests.torch_stub_workers import slow_batch_identity
from tests.torch_telemetry_common import plane_guard  # noqa: F401 - autouse

pytestmark = pytest.mark.service


@pytest.fixture(scope='module')
def many_rowgroup_url(tmp_path_factory):
    """10 single-row-group files: a mid-epoch kill always leaves undelivered
    work to re-ventilate (the reference tests' dataset)."""
    from tests.test_common import create_test_scalar_dataset
    url = 'file://' + str(tmp_path_factory.mktemp('service') / 'dataset')
    create_test_scalar_dataset(url, num_rows=100, num_files=10)
    return url


def test_sigkill_worker_mid_read_reventilates_exactly_once():
    def run(pkg):
        pool = pkg.ServicePool(spawn_local_workers=2, **FAST)
        pool.start(pkg.stubs.SleepyIdentityWorker)
        try:
            for i in range(40):
                pool.ventilate(i, sleep_s=0.05)
            results = [pool.get_results(timeout=60) for _ in range(5)]
            os.kill(pool._local_procs[0].pid, signal.SIGKILL)
            results.extend(drain(pkg, pool))
            return sorted(results), pool.diagnostics
        finally:
            pool.stop()
            pool.join()

    out = both(run)
    for results, diag in out.values():
        assert results == list(range(40))
        assert diag['items_reventilated'] >= 1
        assert diag['workers_alive'] == 1
        assert diag['items_inflight'] == 0
    assert set(out['torch'][1]) == set(out['jax'][1])


def test_stalled_consumer_quiesces_fleet_without_killing_it():
    """A consumer pause past the workers' ack timeout, with the results
    queue full, keeps the fleet: the dispatcher thread acks heartbeats while
    delivery backlogs."""
    def run(pkg):
        pool = pkg.ServicePool(spawn_local_workers=2, results_queue_size=4,
                               worker_ack_timeout_s=1.5, **FAST)
        pool.start(pkg.stubs.SleepyIdentityWorker)
        try:
            for i in range(30):
                pool.ventilate(i, sleep_s=0.01)
            results = [pool.get_results(timeout=60) for _ in range(2)]
            time.sleep(4.0)
            alive = pool.diagnostics['workers_alive']
            results.extend(drain(pkg, pool))
            return alive, sorted(results)
        finally:
            pool.stop()
            pool.join()

    assert both(run) == {'jax': (2, list(range(30))), 'torch': (2, list(range(30)))}


def test_worker_error_propagates_and_pool_cleans_up():
    def run(pkg):
        pool = pkg.ServicePool(spawn_local_workers=2, **FAST)
        pool.start(pkg.stubs.ExceptionOnFiveWorker)
        try:
            for i in range(10):
                pool.ventilate(i)
            with pytest.raises(ValueError, match='value was 5') as info:
                deadline = time.monotonic() + 60
                while time.monotonic() < deadline:
                    pool.get_results(timeout=60)
            # the error path stops and joins: the fleet is reaped
            reaped = all(p.poll() is not None for p in pool._local_procs)
            return type(info.value), str(info.value), reaped or not pool._local_procs
        finally:
            pool.stop()
            pool.join()

    out = both(run)
    assert out['torch'] == out['jax'] == (ValueError, 'value was 5', True)


def test_registration_timeout_fails_fast_with_clear_error():
    def run(pkg):
        pool = pkg.ServicePool(expected_workers=1, connect_timeout_s=1.5)
        with pytest.raises(RuntimeError, match='registered with the dispatcher') as info:
            pool.start(pkg.stubs.SleepyIdentityWorker)
        # the message names the pool's own random endpoint
        return str(info.value).split(' at ')[0]

    out = both(run)
    assert out['torch'] == out['jax'] == 'Only 0 of 1 worker servers registered with the dispatcher'


def test_dispatcher_endpoint_resolves_random_port():
    def run(pkg):
        pool = pkg.ServicePool(spawn_local_workers=1, **FAST)
        pool.start(pkg.stubs.SleepyIdentityWorker)
        try:
            return pool.dispatcher_endpoint
        finally:
            pool.stop()
            pool.join()

    for endpoint in both(run).values():
        assert endpoint.startswith('tcp://127.0.0.1:')
        assert not endpoint.endswith(':0')


def test_reader_service_pool_is_drop_in_for_thread_pool(many_rowgroup_url, monkeypatch):
    """``make_batch_reader(reader_pool_type='service')`` against two worker
    servers started through each package's CLI returns the thread pool's
    multiset, twice on the same long-lived fleet (servers re-register after
    a job ends)."""
    url = many_rowgroup_url
    expected = read_id_multiset(PACKAGES['jax'], url, 'thread')
    assert sum(expected.values()) == 100

    def run(pkg):
        endpoint = 'tcp://127.0.0.1:%d' % pkg.protocol.free_tcp_port()
        with cli_worker_servers(pkg, endpoint, 2):
            monkeypatch.setenv('PETASTORM_TPU_SERVICE_DISPATCHER', endpoint)
            monkeypatch.setenv('PETASTORM_TPU_SERVICE_WORKERS', '2')
            try:
                return [read_id_multiset(pkg, url, 'service') for _ in range(2)]
            finally:
                monkeypatch.delenv('PETASTORM_TPU_SERVICE_DISPATCHER')
                monkeypatch.delenv('PETASTORM_TPU_SERVICE_WORKERS')

    assert both(run) == {'jax': [expected, expected], 'torch': [expected, expected]}


def test_reader_survives_worker_server_sigkill_mid_epoch(many_rowgroup_url):
    """One of two CLI worker servers killed mid-epoch: re-ventilation
    delivers every row once, the thread pool's multiset in both packages."""
    url = many_rowgroup_url
    expected = read_id_multiset(PACKAGES['jax'], url, 'thread', transform=slow_batch_identity)

    def run(pkg):
        endpoint = 'tcp://127.0.0.1:%d' % pkg.protocol.free_tcp_port()
        with cli_worker_servers(pkg, endpoint, 2) as procs:
            # a pool instance, for the tight heartbeat and liveness
            pool = pkg.ServicePool(endpoint=endpoint, expected_workers=2, **FAST)
            return read_id_multiset(pkg, url, pool, kill_proc_after_first=procs[0],
                                    transform=slow_batch_identity)

    assert both(run) == {'jax': expected, 'torch': expected}


def test_service_pool_diagnostics_gauges(many_rowgroup_url):
    """The liveness and ownership gauges reach the reader's diagnostics
    under the local pools' names, and both pools report the same keys."""
    def run(pkg):
        pool = pkg.ServicePool(spawn_local_workers=2, **FAST)
        with pkg.reader.make_batch_reader(many_rowgroup_url, reader_pool_type=pool,
                                          num_epochs=1, shuffle_row_groups=False) as reader:
            next(iter(reader))
            return reader.diagnostics, pool.diagnostics

    out = both(run)
    for diag, _ in out.values():
        assert diag['workers_alive'] == 2
        assert diag['workers_registered'] == 2
        for gauge in ('items_inflight', 'items_pending', 'items_assigned', 'items_reventilated',
                      'items_ventilated', 'items_processed'):
            assert gauge in diag, gauge
    assert set(out['torch'][1]) == set(out['jax'][1])


# -- the torch loader on the service ---------------------------------------------


@pytest.mark.parametrize('kill', ['whole', 'sigkill'])
def test_torch_loader_epoch_is_the_jax_loaders(many_rowgroup_url, kill):
    """``make_torch_loader(reader_pool_type=ServicePool(...))`` gives the
    ids of ``make_jax_loader`` on the JAX package's pool, also when one of
    the two spawned worker servers is killed after the first batch."""
    def ids(pkg, make):
        pool = pkg.ServicePool(spawn_local_workers=2, **FAST)
        kw = dict(batch_size=10, fields=['^id$'], num_epochs=1, last_batch='short',
                  reader_pool_type=pool, shuffle_row_groups=False,
                  transform_spec=pkg.TransformSpec(slow_batch_identity))
        if pkg.name == 'torch':
            kw['device'] = 'cpu'
        got = []
        with make(many_rowgroup_url, **kw) as loader:
            for batch in loader:
                got.extend(int(i) for i in np.asarray(batch['id']))
                if kill == 'sigkill' and len(got) == 10:
                    os.kill(pool._local_procs[0].pid, signal.SIGKILL)
            return sorted(got), pool.diagnostics['items_reventilated']

    want, _ = ids(PACKAGES['jax'], make_jax_loader)
    got, reventilated = ids(PACKAGES['torch'], make_torch_loader)
    assert got == want == list(range(100))
    if kill == 'sigkill':
        assert reventilated >= 1


def test_torch_loader_takes_the_service_by_name(many_rowgroup_url):
    """``reader_pool_type='service'`` through the loader's reader kwargs:
    ``workers_count`` spawned servers, the thread pool's rows."""
    kw = dict(batch_size=10, fields=['^id$'], num_epochs=1, last_batch='short',
              shuffle_row_groups=False, device='cpu')
    got = {}
    for pool_type in ('thread', 'service'):
        with make_torch_loader(many_rowgroup_url, reader_pool_type=pool_type, workers_count=2,
                               **kw) as loader:
            got[pool_type] = sorted(int(i) for b in loader for i in b['id'])
    assert got['service'] == got['thread'] == list(range(100))


def test_concurrent_ventilation_delivers_every_item_once():
    """Eight threads ventilate into one port pool at once, with the
    interpreter switching threads as often as it can, while the dispatcher
    thread assigns: every item is counted and delivered exactly once."""
    import sys
    import threading
    pkg = PACKAGES['torch']
    interval = sys.getswitchinterval()
    pool = pkg.ServicePool(spawn_local_workers=2, **FAST)
    pool.start(pkg.stubs.IdentityWorker)
    try:
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=lambda t=t: [pool.ventilate(100 * t + i)
                                                        for i in range(100)])
                   for t in range(8)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(60)
        assert not any(thread.is_alive() for thread in threads)
        sys.setswitchinterval(interval)
        results = drain(pkg, pool)
        assert pool.diagnostics['items_ventilated'] == 800
    finally:
        sys.setswitchinterval(interval)
        pool.stop()
        pool.join()
    assert sorted(results) == list(range(800))
