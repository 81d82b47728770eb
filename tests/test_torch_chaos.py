"""Chaos drills on the port: faults armed through ``PETASTORM_TPU_FAULTS``
against the port's reader, decoded cache and staging engine, held against
the JAX package's reads of the same rows.

The reference's four cache drills (``tests/test_chaos.py``): a full cache
disk degrades to decode-through once, an EIO read degrades, one EACCES
read does not, and ``reroot`` re-arms a degraded tier. The port decides
"count it, degrade, announce" under the tier's lock, so its disk-full
drill holds the reference's own assertions (one anomaly, one failure
counted, no entry published) on a four-worker thread pool every run,
where the reference's count depends on how many stores were in flight.
Then the port's own drills: a poisoned row-group raises ``FaultInjected``
naming it, a failed host-to-device dispatch reaches the consumer after
the batches before it, and a faulted footer read prunes nothing. The
service pool's drills (quarantine, the soak) wait for ROADMAP item 9.
Faults are armed through ``monkeypatch``; the guard disarms both
packages after each test."""

import collections
import os
import threading
import time

import numpy as np
import pytest

from petastorm_tpu import faults as jax_faults
from petastorm_tpu import telemetry as jax_telemetry
from petastorm_tpu_torch import faults
from petastorm_tpu_torch import telemetry
from petastorm_tpu_torch.materialized_cache import (
    DECODED_CACHE_DEGRADED, DECODED_CACHE_DISK_FAILURES, MaterializedRowGroupCache,
)

from tests.torch_telemetry_common import (  # noqa: F401 - autouse
    telemetry_guard, write_small_dataset,
)

#: the reference's disk-full drill ran on its default pool; the port's
#: runs on four thread workers, where in-flight stores race the degrade
DRILL_WORKERS = 4


@pytest.fixture
def scalar_dataset(tmp_path):
    from tests.test_common import create_test_scalar_dataset
    url = 'file://' + str(tmp_path / 'dataset')
    create_test_scalar_dataset(url, num_rows=50, num_files=5)
    return url


@pytest.fixture
def arm(monkeypatch):
    """Arm a spec in both packages; the guard disarms them after."""
    def arm(spec):
        monkeypatch.setenv('PETASTORM_TPU_FAULTS', spec)
        monkeypatch.setenv('PETASTORM_TPU_READAHEAD', '0')
        jax_telemetry.refresh()
        telemetry.refresh()
    return arm


def _read_ids(package, url, **kwargs):
    if package == 'jax':
        from petastorm_tpu.reader import make_batch_reader
    else:
        from petastorm_tpu_torch.reader import make_batch_reader
    ids = collections.Counter()
    with make_batch_reader(url, num_epochs=1, shuffle_row_groups=False, **kwargs) as reader:
        for batch in reader:
            ids.update(int(x) for x in batch.id)
    return ids


def _cached(tmp_path):
    return dict(cache_type='decoded', cache_location=str(tmp_path / 'cache'),
                cache_size_limit=64 * 2 ** 20)


def _failures():
    return telemetry.get_registry().counters_with_prefix(DECODED_CACHE_DISK_FAILURES)


def _degraded_events():
    return [e for e in telemetry.recent_anomalies() if e['kind'] == 'cache_degraded']


@pytest.mark.parametrize('run', range(3))
def test_cache_disk_full_degrades_to_decode_through(scalar_dataset, tmp_path, arm, run):
    """Every store hits an injected ENOSPC on the four-worker pool: the
    epoch reads the JAX package's uncached rows, the tier degrades once
    (one anomaly naming ENOSPC, the gauge set), exactly one failure is
    counted, and nothing is published on the full disk."""
    expected = _read_ids('jax', scalar_dataset)
    arm('cache.write:oserror:1:errno=28')
    got = _read_ids('torch', scalar_dataset, reader_pool_type='thread',
                    workers_count=DRILL_WORKERS, **_cached(tmp_path))
    assert got == expected and sum(got.values()) == 50
    events = _degraded_events()
    assert len(events) == 1, 'degrade must announce exactly once'
    assert 'ENOSPC' in events[0]['detail']['reason']
    assert sum(_failures().values()) == 1, \
        'a degraded tier must stop paying the failing syscall per item'
    report = telemetry.pipeline_report()
    assert report['anomalies']['by_kind'].get('cache_degraded') == 1
    gauges = telemetry.get_registry().gauges_with_prefix(DECODED_CACHE_DEGRADED)
    assert list(gauges.values()) == [1]
    assert not [f for _, _, files in os.walk(str(tmp_path / 'cache')) for f in files
                if f.endswith('.arrow')]
    fired = faults.injection_stats()['cache.write']['fired']
    assert telemetry.get_registry().counter_value(faults.FAULTS_INJECTED,
                                                  site='cache.write') == fired >= 1


def test_stores_in_flight_at_the_degrade_count_once(tmp_path, arm):
    """Four stores leave one barrier together and each waits 200 ms at
    the faultpoint before its ENOSPC, so all four are in flight before
    any degrade: the tier counts one failure and announces once."""
    from petastorm_tpu_torch.arrow_worker import ColumnBatch
    cache = MaterializedRowGroupCache(str(tmp_path / 'c'), 10 ** 8)
    arm('cache.write:delay:ms=200,cache.write:oserror:1:errno=28')
    barrier = threading.Barrier(4)
    results = []

    def fill(i):
        barrier.wait(timeout=10)
        return ColumnBatch({'x': np.full(3, i)}, 3)

    threads = [threading.Thread(target=lambda i=i: results.append(
        cache.get('k%d' % i, lambda: fill(i)).columns['x'][0])) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(results) == [0, 1, 2, 3]
    assert cache.degraded
    assert sum(_failures().values()) == 1 and len(_degraded_events()) == 1
    assert [clause.fired for clause in faults.ARMED.by_site['cache.write']] == [4, 4]


@pytest.mark.parametrize('package', ['jax', 'torch'])
def test_cache_read_eio_counts_and_serves_decode(scalar_dataset, tmp_path, arm, package):
    expected = _read_ids(package, scalar_dataset, **_cached(tmp_path))
    arm('cache.read:oserror:1:errno=5:times=1')
    got = _read_ids(package, scalar_dataset, **_cached(tmp_path))
    assert got == expected == _read_ids('jax', scalar_dataset)
    tel = jax_telemetry if package == 'jax' else telemetry
    failures = tel.get_registry().counters_with_prefix(DECODED_CACHE_DISK_FAILURES)
    assert any('read' in key for key in failures)
    assert [e for e in tel.recent_anomalies() if e['kind'] == 'cache_degraded']


@pytest.mark.parametrize('package', ['jax', 'torch'])
def test_read_eacces_is_entry_shaped_not_medium_shaped(scalar_dataset, tmp_path, arm,
                                                       package):
    expected = _read_ids(package, scalar_dataset, **_cached(tmp_path))
    arm('cache.read:oserror:1:errno=13:times=1')
    got = _read_ids(package, scalar_dataset, **_cached(tmp_path))
    assert got == expected
    tel = jax_telemetry if package == 'jax' else telemetry
    assert not [e for e in tel.recent_anomalies() if e['kind'] == 'cache_degraded']
    failures = tel.get_registry().counters_with_prefix(DECODED_CACHE_DISK_FAILURES)
    assert sum(failures.values()) == 1


def test_reroot_rearms_degraded_tier_and_clears_gauge(tmp_path, arm, monkeypatch):
    from petastorm_tpu_torch.arrow_worker import ColumnBatch
    cache = MaterializedRowGroupCache(str(tmp_path / 'a'), 64 * 2 ** 20)
    arm('cache.write:oserror:1:errno=28')

    def fill():
        return ColumnBatch({'x': np.arange(3)}, 3)

    cache.get('k1', fill)
    assert cache.degraded
    gauges = telemetry.get_registry().gauges_with_prefix(DECODED_CACHE_DEGRADED)
    assert gauges and all(v == 1 for v in gauges.values())
    monkeypatch.delenv('PETASTORM_TPU_FAULTS')
    faults.refresh_faults()
    cache.reroot(str(tmp_path / 'b'))
    assert not cache.degraded
    assert all(v == 0 for v in
               telemetry.get_registry().gauges_with_prefix(DECODED_CACHE_DEGRADED).values())
    cache.get('k1', fill)
    assert not cache.degraded and os.listdir(str(tmp_path / 'b'))


def test_consecutive_entry_shaped_failures_degrade(tmp_path, arm):
    """Five entry-shaped store failures in a row degrade the tier, as in
    the reference."""
    from petastorm_tpu.arrow_worker import ColumnBatch as JaxColumnBatch
    from petastorm_tpu.materialized_cache import MaterializedRowGroupCache as JaxCache
    from petastorm_tpu_torch.arrow_worker import ColumnBatch
    arm('cache.write:oserror:1:errno=22')
    degraded_after = {}
    for name, cache_type, batch_type in (('jax', JaxCache, JaxColumnBatch),
                                         ('torch', MaterializedRowGroupCache, ColumnBatch)):
        cache = cache_type(str(tmp_path / name), 10 ** 8)
        for i in range(8):
            cache.get('k%d' % i, lambda: batch_type({'x': np.arange(2)}, 2))
            if cache.degraded:
                degraded_after[name] = i + 1
                break
    assert degraded_after == {'jax': 5, 'torch': 5}


# -- the port's read-path and staging drills ---------------------------------


def test_poisoned_rowgroup_raises_naming_it(tmp_path, arm):
    url = write_small_dataset('file://%s/ds' % tmp_path, rows=120, rowgroup_size_rows=10)
    arm('decode.rowgroup:error:1:match=#rg3')
    from petastorm_tpu_torch.reader import make_batch_reader
    start = time.monotonic()
    with pytest.raises(faults.FaultInjected, match='#rg3'):
        with make_batch_reader(url, reader_pool_type='thread', workers_count=2,
                               shuffle_row_groups=False) as reader:
            for _ in reader:
                pass
    assert time.monotonic() - start < 30
    assert faults.injection_stats()['decode.rowgroup'] == {'hits': 1, 'fired': 1}
    assert not [t for t in threading.enumerate() if t.name.startswith('petastorm-tpu-torch-')]


@pytest.mark.parametrize('staging_on', [True, False], ids=['ring', 'fresh'])
def test_failed_dispatch_reaches_the_consumer_after_the_batches_before_it(
        tmp_path, arm, monkeypatch, staging_on):
    """``staging.h2d:error:1:after=3:times=1``: the consumer receives the
    first three batches, then ``FaultInjected``, without a hang; the
    staging thread ends and a fresh loader reads the whole epoch."""
    from petastorm_tpu_torch.device.loader import make_torch_loader
    url = write_small_dataset('file://%s/ds' % tmp_path, rows=120, rowgroup_size_rows=10)
    if not staging_on:
        monkeypatch.setenv('PETASTORM_TPU_STAGING', '0')
    arm('staging.h2d:error:1:after=3:times=1')
    got = []
    start = time.monotonic()
    loader = make_torch_loader(url, 10, device='cpu', reader_pool_type='thread',
                               workers_count=2, shuffle_row_groups=False)
    with pytest.raises(faults.FaultInjected, match='staging.h2d'):
        with loader:
            for batch in loader:
                got.append(batch['id'].tolist())
    assert time.monotonic() - start < 30
    assert len(got) == 3
    assert not loader._stage_thread.is_alive()
    assert faults.injection_stats()['staging.h2d'] == {'hits': 4, 'fired': 1}
    with make_torch_loader(url, 10, device='cpu', reader_pool_type='thread', workers_count=2,
                           shuffle_row_groups=False) as fresh:
        ids = sorted(i for b in fresh for i in b['id'].tolist())
    assert ids == list(range(120))


def test_faulted_footer_prunes_nothing(tmp_path, arm):
    """A failed footer read degrades to unpruned reads: nothing pruned,
    the same rows as the JAX reader's."""
    from petastorm_tpu_torch import pushdown
    from petastorm_tpu_torch.predicates import in_set
    url = write_small_dataset('file://%s/ds' % tmp_path, rows=120, rowgroup_size_rows=10)
    want = _read_ids('jax', url, predicate=__import__(
        'petastorm_tpu.predicates', fromlist=['in_set']).in_set({3, 4, 95}, 'id'),
        reader_pool_type='dummy')
    pruned = {}
    for spec in (None, 'io.read:error:1:match=#footer'):
        telemetry.reset_for_tests()
        if spec:
            arm(spec)
        got = _read_ids('torch', url, predicate=in_set({3, 4, 95}, 'id'),
                        reader_pool_type='dummy')
        assert got == want
        pruned[spec] = pushdown.planner_summary()['rowgroups_pruned']
    assert pruned == {None: 10, 'io.read:error:1:match=#footer': 0}
    assert faults.injection_stats()['io.read'] == {'hits': 1, 'fired': 1}


def test_injection_stats_agree_with_the_counter(tmp_path, arm):
    url = write_small_dataset('file://%s/ds' % tmp_path, rows=60, rowgroup_size_rows=10)
    arm('io.read:delay:0.5:seed=3:ms=0,decode.batch:delay:0.5:seed=4:ms=0')
    counts = {}
    for package in ('jax', 'torch'):
        _read_ids(package, url, reader_pool_type='dummy')
        tel, module = ((jax_telemetry, jax_faults) if package == 'jax' else (telemetry, faults))
        counts[package] = module.injection_stats()
        for site, stats in counts[package].items():
            assert tel.get_registry().counter_value(module.FAULTS_INJECTED, site=site) == \
                stats['fired']
    assert counts['torch'] == counts['jax']
    assert counts['torch']['io.read']['fired'] > 0 and counts['torch']['decode.batch']['fired'] > 0
