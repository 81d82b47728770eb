"""The port's row-group caches (``petastorm_tpu_torch/cache.py``) held
against the JAX package's ``cache.py``: each of the reference's
``NullCache``/``LocalDiskCache`` cases runs on both packages' classes, the
two read each other's entries (same path, same pickle), and
``cache_type='local-disk'`` reads the JAX reader's row multisets and
column bytes, cold and warm."""

import collections
import os
import pickle
import threading

import numpy as np
import pytest

from petastorm_tpu import cache as jax_cache
from petastorm_tpu import telemetry as jax_telemetry
from petastorm_tpu_torch import cache
from petastorm_tpu_torch import telemetry

from tests.torch_telemetry_common import (  # noqa: F401 - autouse
    telemetry_guard, write_small_dataset,
)

MODULES = {'jax': jax_cache, 'torch': cache}
both = pytest.mark.parametrize('package', sorted(MODULES))


def _disk(package, path, limit=10 ** 6, **kwargs):
    return MODULES[package].LocalDiskCache(str(path), limit, **kwargs)


def _tree_bytes(path):
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(str(path)) for f in files)


@both
def test_null_cache_always_computes(package):
    calls = []
    null = MODULES[package].NullCache()
    assert null.get('k', lambda: calls.append(1) or 42) == 42
    assert null.get('k', lambda: calls.append(1) or 42) == 42
    assert len(calls) == 2


@both
def test_get_or_compute(tmp_path, package):
    disk = _disk(package, tmp_path / 'c')
    calls = []

    def fill():
        calls.append(1)
        return {'a': np.arange(5)}

    first = disk.get('key1', fill)
    second = disk.get('key1', fill)
    np.testing.assert_array_equal(first['a'], second['a'])
    assert len(calls) == 1


@both
def test_distinct_keys(tmp_path, package):
    disk = _disk(package, tmp_path / 'c')
    assert disk.get('a', lambda: 1) == 1
    assert disk.get('b', lambda: 2) == 2
    assert disk.get('a', lambda: 99) == 1


@both
def test_persistence_across_instances(tmp_path, package):
    _disk(package, tmp_path / 'c').get('k', lambda: 'value')
    assert _disk(package, tmp_path / 'c').get('k', lambda: 'MISS') == 'value'


@pytest.mark.parametrize('writer,reader', [('jax', 'torch'), ('torch', 'jax')])
def test_entries_cross_packages(tmp_path, writer, reader):
    """One directory serves both packages: the same key names the same
    entry, and a value either package stored reads back in the other."""
    rng = np.random.RandomState(3)
    values = {'k%d' % i: rng.rand(7, 3).astype(np.float32) for i in range(5)}
    stored = _disk(writer, tmp_path / 'c')
    for key, value in values.items():
        stored.get(key, lambda v=value: v)
    fresh = _disk(reader, tmp_path / 'c')
    for key, value in values.items():
        assert fresh._entry_path(key) == stored._entry_path(key)
        np.testing.assert_array_equal(fresh.get(key, lambda: 'MISS'), value)


@both
def test_size_limit_evicts_lru(tmp_path, package):
    disk = _disk(package, tmp_path / 'c', limit=50_000)
    payload = np.zeros(10_000, dtype=np.uint8)
    for i in range(10):
        disk.get('k%d' % i, lambda: payload)
    assert _tree_bytes(tmp_path / 'c') <= 50_000


def test_eviction_leaves_the_references_survivors(tmp_path):
    """With the same access times, both packages keep the same entries."""
    survivors = {}
    for package in MODULES:
        disk = _disk(package, tmp_path / package, limit=45_000)
        for i in range(10):
            disk.get('k%d' % i, lambda i=i: np.full(10_000, i, np.uint8))
            entry = disk._entry_path('k%d' % i)
            if os.path.exists(entry):
                os.utime(entry, (1000.0 + i, 1000.0 + i))
        survivors[package] = sorted(
            os.path.relpath(os.path.join(root, f), str(tmp_path / package))
            for root, _, files in os.walk(str(tmp_path / package)) for f in files)
    assert survivors['torch'] == survivors['jax'] and survivors['torch']


@both
def test_corrupt_entry_recomputed(tmp_path, package):
    disk = _disk(package, tmp_path / 'c')
    disk.get('k', lambda: 'good')
    with open(disk._entry_path('k'), 'wb') as f:
        f.write(b'not a pickle')
    assert disk.get('k', lambda: 'recomputed') == 'recomputed'


@both
def test_weird_keys_are_safe(tmp_path, package):
    disk = _disk(package, tmp_path / 'c')
    for key in ('a/b/../c', 'x' * 500, 'sp ace\n', "k'\"", ''):
        assert disk.get(key, lambda k=key: 'v:' + str(k)) == 'v:' + key
    root = os.path.realpath(str(tmp_path / 'c'))
    for dirpath, _, _ in os.walk(root):
        assert os.path.realpath(dirpath).startswith(root)


@both
def test_pickles_across_process_boundary(tmp_path, package):
    disk = _disk(package, tmp_path / 'c')
    disk.get('k', lambda: 1)
    clone = pickle.loads(pickle.dumps(disk))
    assert clone.get('k', lambda: 'MISS') == 1


@both
def test_concurrent_get_same_key(tmp_path, package):
    disk = _disk(package, tmp_path / 'c')
    results = []

    def read():
        results.append(disk.get('k', lambda: np.arange(100).tolist()))

    threads = [threading.Thread(target=read) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(results) == 8 and all(r == list(range(100)) for r in results)


@both
def test_cleanup_flag(tmp_path, package):
    disk = _disk(package, tmp_path / 'c', cleanup=True)
    disk.get('k', lambda: 1)
    disk.cleanup()
    assert not os.path.exists(str(tmp_path / 'c'))


@both
def test_cleanup_default_keeps(tmp_path, package):
    disk = _disk(package, tmp_path / 'c')
    disk.get('k', lambda: 1)
    disk.cleanup()
    assert os.path.exists(str(tmp_path / 'c'))


@both
def test_corrupt_entry_is_deleted_before_refill(tmp_path, package):
    disk = _disk(package, tmp_path / 'c')
    disk.get('k', lambda: 'good')
    entry = disk._entry_path('k')
    with open(entry, 'wb') as f:
        f.write(b'not a pickle')
    removed_during_fill = []

    def fill():
        removed_during_fill.append(not os.path.exists(entry))
        return 'recomputed'

    assert disk.get('k', fill) == 'recomputed'
    assert removed_during_fill == [True]


@both
def test_truncated_pickle_valueerror_recomputed(tmp_path, package):
    disk = _disk(package, tmp_path / 'c')
    disk.get('k', lambda: np.arange(1000))
    entry = disk._entry_path('k')
    with open(entry, 'rb') as f:
        blob = f.read()
    with open(entry, 'wb') as f:
        f.write(blob[:len(blob) - 500])
    assert disk.get('k', lambda: 'refilled') == 'refilled'


@both
def test_stale_tmp_files_purged_at_init(tmp_path, package):
    path = tmp_path / 'c'
    disk = _disk(package, path)
    disk.get('k', lambda: 'v')
    shard = os.path.dirname(disk._entry_path('k'))
    dead = os.path.join(shard, 'orphan.pkl.tmp.%d' % (2 ** 22 + 9999))
    live = os.path.join(shard, 'inflight.pkl.tmp.%d' % os.getpid())
    for p in (dead, live):
        with open(p, 'wb') as f:
            f.write(b'x' * 4096)
    fresh = _disk(package, path)
    assert not os.path.exists(dead)
    assert os.path.exists(live)
    assert fresh._total == os.path.getsize(disk._entry_path('k'))


@both
def test_foreign_host_tmp_files_need_age_not_pid(tmp_path, package):
    path = tmp_path / 'c'
    os.makedirs(str(path / '00'))
    fresh = str(path / '00' / 'e.pkl.tmp.otherhost-12345')
    stale = str(path / '00' / 'f.pkl.tmp.otherhost-12346')
    for p in (fresh, stale):
        with open(p, 'wb') as f:
            f.write(b'x')
    os.utime(stale, (1.0, 1.0))
    _disk(package, path)
    assert os.path.exists(fresh)
    assert not os.path.exists(stale)


@both
def test_eviction_walk_skips_inflight_tmp_files(tmp_path, package):
    disk = _disk(package, tmp_path / 'c', limit=20_000)
    tmp_file = str(tmp_path / 'c' / '00' / ('big.pkl.tmp.%d' % os.getpid()))
    os.makedirs(os.path.dirname(tmp_file), exist_ok=True)
    with open(tmp_file, 'wb') as f:
        f.write(b'x' * 100_000)
    disk.get('k', lambda: b'y' * 30_000)
    assert os.path.exists(tmp_file)


def test_tmp_entry_names_are_the_references():
    entry = os.path.join('/x', 'ab', 'cd.pkl')
    assert cache.tmp_entry_path(entry) == jax_cache.tmp_entry_path(entry)
    for name in ('cd.pkl', cache.tmp_entry_path('cd.pkl'), 'a.tmp.h-1'):
        assert cache.is_tmp_entry(name) == jax_cache.is_tmp_entry(name)


def test_counters_are_the_references(tmp_path):
    """Hits, misses, bytes written and evictions count alike."""
    counted = {}
    for package, tel in (('jax', jax_telemetry), ('torch', telemetry)):
        disk = _disk(package, tmp_path / package, limit=30_000)
        for i in range(6):
            disk.get('k%d' % (i % 4), lambda i=i: np.full(9_000, i % 4, np.uint8))
        counted[package] = {k: v for k, v in tel.get_registry().snapshot()['counters'].items()
                            if k.startswith('petastorm_tpu_cache_')}
    assert counted['torch'] == counted['jax']
    assert counted['torch']['petastorm_tpu_cache_misses_total'] == 6
    assert counted['torch']['petastorm_tpu_cache_evictions_total'] > 0


# -- cache_type='local-disk' through the readers -------------------------------


def _batches(package, url, **kwargs):
    if package == 'jax':
        from petastorm_tpu.reader import make_batch_reader
    else:
        from petastorm_tpu_torch.reader import make_batch_reader
    out = []
    with make_batch_reader(url, reader_pool_type='dummy', shuffle_row_groups=False,
                           **kwargs) as reader:
        for batch in reader:
            out.append({name: np.asarray(col) for name, col in batch._asdict().items()})
    return out


def test_local_disk_reads_the_references_batches(tmp_path, monkeypatch):
    monkeypatch.setenv('PETASTORM_TPU_READAHEAD', '0')
    url = write_small_dataset('file://%s/ds' % tmp_path, rows=60, rowgroup_size_rows=10)
    want = _batches('jax', url)
    for package in ('torch', 'jax'):
        for epoch in ('cold', 'warm'):
            got = _batches(package, url, cache_type='local-disk',
                           cache_location=str(tmp_path / ('c-' + package)),
                           cache_size_limit=10 ** 8)
            assert len(got) == len(want) == 6, (package, epoch)
            for a, b in zip(got, want):
                assert sorted(a) == sorted(b)
                for name in a:
                    assert a[name].dtype == b[name].dtype and a[name].tobytes() == \
                        b[name].tobytes(), (package, epoch, name)
    section = telemetry.pipeline_report()['cache']
    assert (section['hits'], section['misses']) == (6, 6)
    assert section['hit_rate'] == 0.5 and section['bytes_written'] > 0


@pytest.mark.parametrize('kwargs,message', [
    (dict(cache_type='local-disk'), 'cache_location'),
    (dict(cache_type='bogus'), 'Unknown cache_type'),
])
def test_bad_cache_arguments_raise_as_the_reference(tmp_path, kwargs, message):
    from petastorm_tpu.reader import make_batch_reader as jax_reader
    from petastorm_tpu_torch.reader import make_batch_reader as torch_reader
    url = write_small_dataset('file://%s/ds' % tmp_path, rows=20)
    for make in (jax_reader, torch_reader):
        with pytest.raises(ValueError, match=message):
            make(url, reader_pool_type='dummy', **kwargs)


def test_local_disk_with_a_predicate_raises(tmp_path):
    from petastorm_tpu_torch.predicates import in_set
    from petastorm_tpu_torch.reader import make_batch_reader
    url = write_small_dataset('file://%s/ds' % tmp_path, rows=20)
    with pytest.raises(RuntimeError, match='not supported together with predicates'):
        make_batch_reader(url, reader_pool_type='dummy', predicate=in_set({3}, 'id'),
                          cache_type='local-disk', cache_location=str(tmp_path / 'c'),
                          cache_size_limit=10 ** 6)


def test_local_disk_row_multiset_on_the_thread_pool(tmp_path):
    url = write_small_dataset('file://%s/ds' % tmp_path, rows=80, rowgroup_size_rows=10)
    from petastorm_tpu_torch.reader import make_reader
    counts = []
    for _ in range(2):
        with make_reader(url, reader_pool_type='thread', workers_count=3,
                         cache_type='local-disk', cache_location=str(tmp_path / 'c'),
                         cache_size_limit=10 ** 8) as reader:
            counts.append(collections.Counter(int(row.id) for row in reader))
    assert counts[0] == counts[1] == collections.Counter(range(80))
