"""petastorm_tpu_torch.readahead and petastorm_tpu_torch.device.autotune
against petastorm_tpu.readahead and petastorm_tpu.jax.autotune, on the CPU.

Case for case with ``tests/test_readahead.py``. Exact on both sides: the
coalesced ranges, the buffer pool's accounting, the mirrored sequences and
sweeps, the plans of readers over shards, shuffles, pruned items and
mixture shares, the footer's column-chunk byte ranges, the decline reasons,
the report and ``/health`` keys and the autotuner's decisions on the same
windows (its policies are a pure function of the window). Epoch multisets
with the plane on equal those with ``PETASTORM_TPU_READAHEAD=0`` and the
JAX reader's, through every degrade reason, the sanitizer armed included.
"""

import gc
import time

import numpy as np
import pytest
import torch

from petastorm_tpu import codecs as jax_codecs
from petastorm_tpu import readahead as jax_readahead
from petastorm_tpu import telemetry as jax_telemetry
from petastorm_tpu.etl.dataset_metadata import ParquetDatasetInfo as JaxDatasetInfo
from petastorm_tpu.filters import FiltersPredicate as JaxFiltersPredicate
from petastorm_tpu.reader import make_batch_reader as jax_batch_reader
from petastorm_tpu.reader import make_reader as jax_reader
from petastorm_tpu.telemetry import timeseries as jax_timeseries
from petastorm_tpu.workers.ventilator import ConcurrentVentilator as JaxVentilator
from petastorm_tpu_torch import arrow_worker, codecs, readahead
from petastorm_tpu_torch import sanitizer as torch_sanitizer
from petastorm_tpu_torch import telemetry as T
from petastorm_tpu_torch.device import autotune
from petastorm_tpu_torch.etl.dataset_metadata import ParquetDatasetInfo
from petastorm_tpu_torch.filters import FiltersPredicate
from petastorm_tpu_torch.pushdown import StatsIndex
from petastorm_tpu_torch.reader import make_batch_reader, make_reader
from petastorm_tpu_torch.telemetry import timeseries
from petastorm_tpu_torch.telemetry.stall import BALANCED, CONSUMER_BOUND, PRODUCER_BOUND
from petastorm_tpu_torch.workers.ventilator import epoch_order

try:
    from petastorm_tpu.jax import autotune as jax_autotune
    from tests.torch_telemetry_common import telemetry_guard  # noqa: F401 - autouse
except ImportError:  # the machine with the card: only the cuda test runs there
    jax_autotune = None


def _set_knobs(monkeypatch, **env):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    jax_telemetry.refresh()
    T.refresh()


def _ids(reader):
    return sorted(int(i) for batch in reader for i in batch.id)


def _read_ids(make, url, pool='thread', shuffle=True, **kwargs):
    with make(url, reader_pool_type=pool, shuffle_row_groups=shuffle, seed=0,
              **kwargs) as reader:
        return _ids(reader)


def _oracle_ids(monkeypatch, make, url, **kwargs):
    """The same read with the plane off in both packages, the knob then
    restored."""
    monkeypatch.setenv('PETASTORM_TPU_READAHEAD', '0')
    jax_telemetry.refresh()
    T.refresh()
    try:
        return _read_ids(make, url, **kwargs)
    finally:
        monkeypatch.delenv('PETASTORM_TPU_READAHEAD')
        jax_telemetry.refresh()
        T.refresh()


def _worker(reader):
    pool = reader._pool
    return pool._workers[0] if getattr(pool, '_workers', None) else pool._worker


def _plan_of(reader):
    return _worker(reader).args['readahead_plan']


@pytest.fixture(scope='module')
def scalar_url(tmp_path_factory):
    """400 scalar rows over 4 files of 5 row-groups of 20, written by the
    port: enough row-groups for the depth-ahead window."""
    from petastorm_tpu_torch.codecs import ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_dataset
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema('ReadaheadSchema', [
        UnischemaField('id', np.int64, (), ScalarCodec(np.int64), False),
        UnischemaField('value', np.float64, (), ScalarCodec(np.float64), False)])
    url = 'file://' + str(tmp_path_factory.mktemp('readahead')) + '/ds'
    write_dataset(url, schema, [{'id': i, 'value': i * 0.5} for i in range(400)],
                  rowgroup_size_rows=20, num_files=4)
    return url


# -- units: coalescing, the buffer pool, the sequence mirror -------------------

COALESCE_CASES = {
    'merge-through-the-gap': (([(0, 100), (150, 100), (1000, 50)], 64, 10000),
                              [(0, 250), (1000, 50)]),
    'max-range-caps-a-merge': (([(0, 100), (110, 100), (220, 100)], 64, 250),
                               [(0, 210), (220, 100)]),
    'oversized-chunk-never-split': (([(0, 5000)], 0, 100), [(0, 5000)]),
    'unsorted-sorted-first': (([(500, 10), (0, 10)], 1000, 10000), [(0, 510)]),
}


@pytest.mark.parametrize('case', sorted(COALESCE_CASES))
def test_coalesce_ranges_is_the_references(case):
    (ranges, gap, max_range), want = COALESCE_CASES[case]
    got = readahead.coalesce_ranges(ranges, gap=gap, max_range=max_range)
    assert got == jax_readahead.coalesce_ranges(ranges, gap=gap, max_range=max_range) == want


def test_coalesce_ranges_on_seeded_ranges():
    rng = np.random.RandomState(11)
    for _ in range(50):
        starts = np.cumsum(rng.randint(0, 200, size=12))
        ranges = [(int(s), int(n)) for s, n in zip(starts, rng.randint(1, 150, size=12))]
        gap, max_range = int(rng.randint(0, 100)), int(rng.randint(50, 1000))
        assert readahead.coalesce_ranges(ranges, gap, max_range) == \
            jax_readahead.coalesce_ranges(ranges, gap, max_range)


def test_buffer_pool_accounting_is_the_references():
    steps = [('acquire', 60), ('acquire', 50), ('acquire', 40), ('free', 60), ('free', 40),
             ('free', 10), ('acquire', 100), ('acquire', 1)]
    pools = readahead._BufferPool(100), jax_readahead._BufferPool(100)
    for op, n in steps:
        got = [getattr(pool, op)(n) for pool in pools]
        assert got[0] == got[1]
        assert pools[0].used == pools[1].used
    assert pools[0].used == 100


def _managers(n=10, randomize=True, seed=7, exclude=(), iterations=None):
    plan = {'version': 1, 'items': [('f%d' % (i % 2), i) for i in range(n)],
            'randomize': randomize, 'seed': seed, 'iterations': iterations,
            'exclude': sorted(exclude)}
    out = []
    for module in (readahead, jax_readahead):
        manager = module.ReadaheadManager(object(), plan)
        manager.close()  # arithmetic only
        out.append(manager)
    return out


def _ventilator_order(n, seed, epoch, exclude=(), sweeps=0):
    from petastorm_tpu.workers.ventilator import _RESET_SEED_STRIDE
    vent = JaxVentilator(lambda **kw: None, [{'i': i} for i in range(n)],
                         randomize_item_order=True, random_seed=seed,
                         always_exclude=frozenset(exclude))
    vent._seed = (seed + sweeps * _RESET_SEED_STRIDE) % (2 ** 32)
    order = [i for i in vent._epoch_order(epoch) if i not in frozenset(exclude)]
    port = [i for i in epoch_order(n, vent._seed, epoch, True) if i not in frozenset(exclude)]
    assert port == order
    return order


@pytest.mark.parametrize('epoch', [0, 1, 5])
def test_epoch_orders_match(epoch):
    port, ref = _managers(n=17, seed=123)
    assert port._epoch_order(0, epoch) == ref._epoch_order(0, epoch) == \
        _ventilator_order(17, 123, epoch)


def test_excluded_items_never_appear():
    port, ref = _managers(n=12, seed=3, exclude={2, 7})
    order = port._epoch_order(0, 0)
    assert 2 not in order and 7 not in order
    assert order == ref._epoch_order(0, 0) == _ventilator_order(12, 3, 0, exclude={2, 7})


def test_sweep_advances_by_the_reset_stride():
    port, ref = _managers(n=9, seed=55)
    assert port._epoch_order(1, 0) == ref._epoch_order(1, 0) == \
        _ventilator_order(9, 55, 0, sweeps=1)


SWEEP_STREAMS = {
    # a reset replays the epoch: two consecutive repeats flip the sweep
    'repeated-epoch-items': (4, False, [(0, 0), (1, 0), (0, 0), (1, 0)], [0, 0, 0, 1]),
    # a lone redelivery repeats one item and must not desync
    'lone-retry': (6, False, [(0, 0), (1, 0), (2, 0), (1, 0), (3, 0), (4, 0), (5, 0)],
                   [0] * 7),
    # a reset after more epochs than the seen-sets keep: the epoch regression
    'epoch-regression': (4, True, [(i, e) for e in range(8) for i in range(4)]
                         + [(0, 0), (1, 0), (0, 1), (3, 0)], [0] * 32 + [1, 1, 1, 1]),
}


@pytest.mark.parametrize('case', sorted(SWEEP_STREAMS))
def test_sweep_detection_is_the_references(case):
    n, randomize, stream, want = SWEEP_STREAMS[case]
    port, ref = _managers(n=n, randomize=randomize)
    got = [port._advance_sweep_locked(item, epoch) for item, epoch in stream]
    assert got == [ref._advance_sweep_locked(item, epoch) for item, epoch in stream] == want


def test_sweep_detection_on_a_seeded_stream():
    rng = np.random.RandomState(5)
    port, ref = _managers(n=6, randomize=True)
    for _ in range(300):
        item, epoch = int(rng.randint(6)), int(rng.randint(8))
        assert port._advance_sweep_locked(item, epoch) == ref._advance_sweep_locked(item, epoch)
    assert port._sweep == ref._sweep > 0


# -- plans of real readers: shards, shuffles, pruned items, mixture shares -----

PLAN_CASES = {
    'unsharded-shuffled': dict(shuffle_row_groups=True, seed=3),
    'unsharded-ordered': dict(shuffle_row_groups=False),
    'shard-1-of-3': dict(cur_shard=1, shard_count=3, shuffle_row_groups=True, seed=9),
    'drop-partitions': dict(shuffle_row_drop_partitions=2, seed=1),
    'statistics-pruned': dict(predicate='id<60', seed=4),
    'mixture-share': dict(mixture_interleave={'share': 0.25}, seed=2),
    'two-epochs': dict(num_epochs=2, seed=6),
}


def _plan_kwargs(case, package):
    kw = dict(PLAN_CASES[case])
    if kw.get('predicate') == 'id<60':
        kw['predicate'] = (FiltersPredicate if package == 'port' else JaxFiltersPredicate)(
            [('id', '<', 60)])
    return kw


@pytest.mark.parametrize('case', sorted(PLAN_CASES))
def test_plan_is_the_references(scalar_url, case):
    with make_batch_reader(scalar_url, reader_pool_type='dummy',
                           **_plan_kwargs(case, 'port')) as reader:
        plan = _plan_of(reader)
        orders = [reader.ventilation_order(e) for e in range(2)]
    with jax_batch_reader(scalar_url, reader_pool_type='dummy',
                          **_plan_kwargs(case, 'jax')) as reader:
        assert plan == _plan_of(reader)
    if case == 'statistics-pruned':
        assert plan['exclude'] and len(plan['exclude']) < len(plan['items'])
    if case == 'mixture-share':
        assert plan['interleave'] == {'share': 0.25}
    # the manager's mirror is the reader's own ventilation order
    manager = readahead.ReadaheadManager(object(), plan)
    manager.close()
    assert [manager._epoch_order(0, e) for e in range(2)] == orders


def test_mixture_share_scales_the_window(scalar_url, monkeypatch):
    """A 0.25 source fetches a quarter of the depth ahead (at least one).
    The port's first observe also fetches its own item, which nothing
    before it could schedule; after that the windows are the reference's."""
    plan = jax_readahead.build_plan(
        [{'piece_index': i} for i in range(20)],
        [type('P', (), {'path': 'p', 'row_group': i})() for i in range(20)],
        randomize=False, seed=0, iterations=1, exclude=(), workers=1,
        interleave={'share': 0.25})
    scheduled = {}
    for module in (readahead, jax_readahead):
        got = scheduled[module.__name__] = []
        monkeypatch.setattr(module.ReadaheadManager, '_submit',
                            lambda self, entry, got=got: got.append(entry.rgkey))
        manager = module.ReadaheadManager(object(), plan)
        for item in range(3):
            manager.observe(item, 0, ['id'])
        manager.close()
    assert scheduled[jax_readahead.__name__] == [('p', 1), ('p', 2), ('p', 3)]
    assert scheduled[readahead.__name__] == [('p', 0), ('p', 1), ('p', 2), ('p', 3)]
    with pytest.raises(ValueError, match='interleave share'):
        readahead.build_plan([], [], False, 0, 1, (), interleave={'share': 0})


# -- the footer's column-chunk byte ranges -------------------------------------


@pytest.mark.parametrize('which', ['scalar', 'synthetic'])
def test_get_ranges_is_the_references(scalar_url, synthetic_dataset, which):
    from petastorm_tpu.pushdown import StatsIndex as JaxStatsIndex
    url = scalar_url if which == 'scalar' else synthetic_dataset.url
    info, jax_info = ParquetDatasetInfo(url), JaxDatasetInfo(url)
    port, ref = StatsIndex(info), JaxStatsIndex(jax_info)
    port.prefetch(info.file_paths)
    ref.prefetch(jax_info.file_paths)
    seen = 0
    for path in info.file_paths:
        for rg in range(8):
            assert port.get_ranges(path, rg) == ref.get_ranges(path, rg)
            if port.get_ranges(path, rg) is not None:
                assert port.get(path, rg) == ref.get(path, rg)
                seen += 1
    assert seen >= 4
    assert port.get_ranges('/nonexistent.parquet', 0) is None


# -- exact parity with the blocking-read oracle and the JAX reader -------------


@pytest.mark.parametrize('pool', ['thread', 'dummy'])
def test_row_multiset_parity_across_pools(scalar_url, monkeypatch, pool):
    got = _read_ids(make_batch_reader, scalar_url, pool=pool, workers_count=2)
    oracle = _oracle_ids(monkeypatch, make_batch_reader, scalar_url, pool=pool,
                         workers_count=2)
    assert got == oracle == _read_ids(jax_batch_reader, scalar_url, pool=pool,
                                      workers_count=2) == list(range(400))


def test_hits_recorded_and_pool_drains(scalar_url):
    with make_batch_reader(scalar_url, reader_pool_type='thread', shuffle_row_groups=True,
                           seed=0, num_epochs=2) as reader:
        manager = _worker(reader)._readahead
        got = _ids(reader)
    assert got == sorted(list(range(400)) * 2)
    registry = T.get_registry()
    assert registry.counter_value(readahead.READAHEAD_HITS) > 20
    assert registry.counter_value(readahead.READAHEAD_BYTES) > 0
    assert registry.counter_value(readahead.READAHEAD_COALESCED_READS) > 0
    assert registry.counter_value('petastorm_tpu_stage_calls_total',
                                  stage='readahead_fetch') > 0
    gc.collect()
    assert manager._closed and manager._pool.used == 0
    assert readahead.pool_status() == (0, 0)


@pytest.mark.parametrize('pool_rowgroups', [None, 6], ids=['default-pool', 'six-rowgroup-pool'])
def test_cold_epoch_in_order_hits_every_rowgroup(scalar_url, monkeypatch, pool_rowgroups):
    """A cold epoch on one worker hits every row-group: the first observe
    fetches its own item too (the reference misses the first). A pool of
    six row-groups holds the worker's window (its item and four ahead):
    served entries let go of their bytes before the clock retires them,
    so nothing degrades where the reference's entries, held for the
    retire slack of four, would need nine."""
    if pool_rowgroups is not None:
        info = ParquetDatasetInfo(scalar_url)
        stats = StatsIndex(info)
        stats.prefetch(info.file_paths)
        largest = max(sum(n for _, n in readahead.coalesce_ranges(
            [r for chunks in stats.get_ranges(path, rg).values() for r in chunks],
            readahead.gap_bytes(), readahead.max_range_bytes()))
            for path in info.file_paths for rg in range(5))
        monkeypatch.setattr(readahead, 'pool_budget_bytes', lambda: pool_rowgroups * largest)
    with make_batch_reader(scalar_url, reader_pool_type='thread', workers_count=1,
                           shuffle_row_groups=False, seed=0) as reader:
        assert _ids(reader) == list(range(400))
    registry = T.get_registry()
    assert registry.counter_value(readahead.READAHEAD_HITS) == 20
    assert registry.counter_value(readahead.READAHEAD_MISSES) == 0
    assert not registry.counters_with_prefix(readahead.READAHEAD_DEGRADED)


def test_parity_with_pushdown_and_late_materialization(synthetic_dataset, monkeypatch):
    """Shuffle, statistics pruning and the two-phase read served by the
    plane: ids and heavy-column bytes equal the oracle's and the JAX
    reader's."""

    def rows(make, predicate):
        with make(synthetic_dataset.url, shuffle_row_groups=True, seed=0,
                  predicate=predicate([('id', 'in', (3, 31, 47, 99))])) as reader:
            return sorted((r.id, r.image_png.tobytes(), r.matrix.tobytes()) for r in reader)

    got = rows(make_reader, FiltersPredicate)
    assert [g[0] for g in got] == [3, 31, 47, 99]
    assert got == rows(jax_reader, JaxFiltersPredicate)
    monkeypatch.setenv('PETASTORM_TPU_READAHEAD', '0')
    T.refresh()
    assert got == rows(make_reader, FiltersPredicate)


def test_reset_sweep_keeps_hitting(scalar_url):
    with make_batch_reader(scalar_url, reader_pool_type='thread', shuffle_row_groups=True,
                           seed=0, num_epochs=1) as reader:
        first = _ids(reader)
        reader.reset()
        second = _ids(reader)
    assert first == second == list(range(400))
    registry = T.get_registry()
    hits = registry.counter_value(readahead.READAHEAD_HITS)
    misses = registry.counter_value(readahead.READAHEAD_MISSES)
    assert hits + misses == 40
    assert hits >= 30


# -- degrade: counted, never a wrong answer -------------------------------------


def _slow_fetch(monkeypatch):
    original = readahead.ReadaheadManager._fetch

    def slow(self, entry):
        time.sleep(0.05)
        return original(self, entry)

    monkeypatch.setattr(readahead.ReadaheadManager, '_fetch', slow)
    monkeypatch.setattr(readahead, '_SERVE_WAIT_S', 0.0)


def _outside_ranges(monkeypatch):
    def read(self, nbytes=-1):
        raise readahead._OutsideRanges('forced')

    monkeypatch.setattr(readahead._RangeSource, 'read', read)


DEGRADES = {
    'fetch-error': lambda mp: _set_knobs(
        mp, PETASTORM_TPU_FAULTS='io.read:error:1:match=#readahead'),
    'pool-exhausted': lambda mp: mp.setattr(readahead, 'pool_budget_bytes', lambda: 16),
    'no-footer': lambda mp: mp.setattr(StatsIndex, 'get_ranges', lambda *a: None),
    'deserialize': _outside_ranges,
    'fetch-timeout': _slow_fetch,
}


@pytest.mark.parametrize('reason', sorted(DEGRADES))
def test_each_degrade_reason_loses_no_row(scalar_url, monkeypatch, reason):
    """Every prefetch degraded one way (a fetch fault matches the
    ``#readahead`` key suffix, never the blocking read): the epoch is still
    the exact multiset, through the blocking path, with the reason
    counted and no hit."""
    want = _read_ids(jax_batch_reader, scalar_url, workers_count=2)
    logger_level = readahead.logger.level
    readahead.logger.setLevel('ERROR')  # a warning per failed fetch
    try:
        DEGRADES[reason](monkeypatch)
        got = _read_ids(make_batch_reader, scalar_url, workers_count=2)
    finally:
        readahead.logger.setLevel(logger_level)
    assert got == want == list(range(400))
    registry = T.get_registry()
    assert registry.counter_value(readahead.READAHEAD_DEGRADED, reason=reason) > 0
    assert registry.counter_value(readahead.READAHEAD_HITS) == 0
    assert set(readahead.DEGRADE_REASONS) == {
        'fetch-error', 'pool-exhausted', 'no-footer', 'no-columns', 'deserialize',
        'fetch-timeout', 'cache'}


def test_caching_reader_ships_no_plan(scalar_url, tmp_path):
    """A caching reader never prefetches (a warm epoch reads no storage);
    the decline is counted once, by the reader."""
    with make_batch_reader(scalar_url, reader_pool_type='thread', shuffle_row_groups=False,
                           cache_type='decoded', cache_location=str(tmp_path / 'cache'),
                           cache_size_limit=10 ** 8) as reader:
        assert _plan_of(reader) is None
        delivered = _ids(reader)
    assert delivered == list(range(400))
    registry = T.get_registry()
    assert registry.counter_value(readahead.READAHEAD_HITS) == 0
    assert registry.counter_value(readahead.READAHEAD_MISSES) == 0
    assert registry.counter_value(readahead.READAHEAD_DEGRADED, reason='cache') == 1


def test_plan_decline_reasons_are_distinct(scalar_url):
    """A readable footer with no prefetchable file column is 'no-columns',
    an unreadable one 'no-footer', in both packages."""
    got = []
    for module, info_cls in ((readahead, ParquetDatasetInfo), (jax_readahead, JaxDatasetInfo)):
        info = info_cls(scalar_url)
        plan = {'version': 1, 'items': [(info.file_paths[0], 0)], 'randomize': False,
                'seed': 0, 'iterations': 1, 'exclude': [], 'workers': 1}
        manager = module.ReadaheadManager(info, plan)
        try:
            manager._columns = frozenset(['not_a_stored_column'])
            results = [manager._plan_ranges(info.file_paths[0], 0),
                       manager._plan_ranges('/nonexistent.parquet', 0)]
            manager._columns = frozenset(['id'])
            results.append(manager._plan_ranges(info.file_paths[0], 0))
            manager._columns = frozenset(['id', 'value'])
            results.append(manager._plan_ranges(info.file_paths[0], 3))
        finally:
            manager.close()
        got.append(results)
    assert got[0] == got[1]
    assert got[0][:2] == [(None, 'no-columns'), (None, 'no-footer')]
    assert got[0][2][1] is None and got[0][2][0][1] == ['id']
    assert got[0][3][0][1] == ['id', 'value'] and len(got[0][3][0][0]) == 1


def test_oracle_knob_runs_zero_plane_state(scalar_url, monkeypatch):
    _set_knobs(monkeypatch, PETASTORM_TPU_READAHEAD='0')
    with make_batch_reader(scalar_url, reader_pool_type='thread', seed=0) as reader:
        assert _worker(reader)._readahead is None
        assert reader._obs_health()['readahead']['enabled'] is False
        got = _ids(reader)
    assert got == list(range(400))
    registry = T.get_registry()
    assert registry.counter_value(readahead.READAHEAD_HITS) == 0
    assert registry.counter_value(readahead.READAHEAD_BYTES) == 0
    assert readahead.live_manager_count() == 0


@pytest.mark.parametrize('how', ['stop-join', 'context', 'exit'])
def test_reader_teardown_leaves_no_manager_or_thread(scalar_url, how):
    import threading
    reader = make_batch_reader(scalar_url, reader_pool_type='thread', workers_count=3, seed=0)
    manager = _worker(reader)._readahead
    next(iter(reader))
    assert readahead.live_manager_count() == 1 and manager._threads
    if how == 'stop-join':
        reader.stop()
        reader.join()
    elif how == 'context':
        with reader:
            pass
    else:
        reader.exit()
    assert manager._closed and readahead.live_manager_count() == 0
    assert not [t for t in threading.enumerate() if t.name.startswith(readahead.THREAD_PREFIX)]


# -- the ParquetFile LRU, report, health, the ventilate seam -------------------


def test_memo_is_bounded_and_reads_stay_exact(scalar_url, monkeypatch):
    monkeypatch.setattr(arrow_worker, '_PARQUET_FILE_CACHE_MAX', 2)
    with make_batch_reader(scalar_url, reader_pool_type='thread', workers_count=1, seed=0,
                           shuffle_row_groups=True) as reader:
        delivered = _ids(reader)
        workers = reader._pool._workers
        assert workers
        for worker in workers:
            assert len(worker._parquet_files) <= 2
    assert delivered == list(range(400))


def test_report_section_and_rendering(scalar_url):
    _read_ids(jax_batch_reader, scalar_url)
    want = jax_telemetry.pipeline_report()['readahead']
    _read_ids(make_batch_reader, scalar_url)
    report = T.pipeline_report()
    section = report['readahead']
    assert set(section) == set(want)
    assert section['hits'] + section['misses'] > 0
    assert section['hit_share'] is not None
    assert section['coalesced_reads'] > 0
    assert section['mean_coalesced_bytes'] > 0
    assert section['pool_bytes'] == 0  # every manager closed, every byte back
    assert 'readahead:' in T.format_pipeline_report(report)


def test_section_absent_without_activity():
    assert 'readahead' not in T.pipeline_report()
    assert 'staging_autotune' not in T.pipeline_report()


def test_health_snapshot_shape(scalar_url):
    with jax_batch_reader(scalar_url, reader_pool_type='thread', shuffle_row_groups=False,
                          seed=0) as reader:
        next(iter(reader))
        want = reader._obs_health()
    with make_batch_reader(scalar_url, reader_pool_type='thread', shuffle_row_groups=False,
                           seed=0) as reader:
        next(iter(reader))
        health = reader._obs_health()
    assert health['ventilate_extra'] == want['ventilate_extra'] == 2
    snap = health['readahead']
    assert set(snap) == set(want['readahead'])
    assert snap['enabled'] is True
    assert snap['managers'] == 1
    assert snap['depth'] >= 1


def test_live_bound_adjustment(scalar_url):
    with make_batch_reader(scalar_url, reader_pool_type='thread', workers_count=2,
                           shuffle_row_groups=False) as reader:
        vent = reader._ventilator
        assert vent._current_max_queue_size() == 4
        assert reader.set_ventilate_extra(7) == 7
        assert reader.ventilate_extra == 7
        assert vent._current_max_queue_size() == 9
        # floor 1: the tuner can never strangle ventilation
        assert reader.set_ventilate_extra(0) == 1


# -- the autotuner's policies, window for window against the reference ---------


class _FakeReader:
    def __init__(self, extra=2):
        self._extra = extra

    @property
    def ventilate_extra(self):
        return self._extra

    def set_ventilate_extra(self, extra):
        self._extra = max(1, int(extra))
        return self._extra


class _FakeStager:
    def __init__(self, num_slots=2):
        self.num_slots = num_slots

    def set_num_slots(self, num_slots):
        self.num_slots = max(self.num_slots, int(num_slots))
        return self.num_slots


class _FakeLoader:
    def __init__(self, reader=None, stager=None):
        self._stager = stager
        self._prefetch = 2
        self._reader = reader or _FakeReader()

    @property
    def reader(self):
        return self._reader

    def _set_prefetch(self, depth):
        self._prefetch = depth
        return depth


def _window(module, verdict=None, io_rate=0.0, h2d_ready=0.0):
    return {'rates': {module._IO_SECONDS_KEY: io_rate, module._H2D_READY_KEY: h2d_ready},
            'quantiles': {}, 'gauges': {}, 'producer_wait_s': 0.0, 'consumer_wait_s': 0.0,
            'verdict': verdict, 'dur_s': 1.0, 'throughput': None, 'start': 0.0}


def _w(verdict=None, io=0.0, h2d=0.0, pool=(0, 100)):
    return dict(verdict=verdict, io=io, h2d=h2d, pool=pool)


IO = _w(PRODUCER_BOUND, io=1.5)
POOL = _w(pool=(95, 100))
#: the reference's autotune cases, then two more policies and a mixed run
SCENARIOS = {
    'sustained-io-wait-deepens-readahead': (True, [IO] * 3),
    'io-wait-without-starving-consumer': (True, [_w(io=1.5)] * 6),
    'pool-pressure-sheds-to-the-knob-floor': (True, [IO] * 3 + [POOL] * 9),
    'no-live-manager-no-depth-decisions': (False, [IO] * 3),
    'inflight-raises-and-lowers': (False, [_w(PRODUCER_BOUND)] * 3
                                   + [_w(CONSUMER_BOUND)] * 9),
    'h2d-starvation-deepens-slots-and-prefetch': (False, [_w(h2d=0.7)] * 21),
    'decode-threads-shed-and-restore': (False, [_w(CONSUMER_BOUND)] * 12
                                        + [_w(PRODUCER_BOUND)] * 12),
}


def _seeded_windows(seed=2024, n=120):
    rng = np.random.RandomState(seed)
    out = []
    while len(out) < n:
        window = _w(verdict=[None, PRODUCER_BOUND, CONSUMER_BOUND, BALANCED][rng.randint(4)],
                    io=[0.0, 0.2, 1.5, 3.0][rng.randint(4)],
                    h2d=[0.0, 0.3, 0.7][rng.randint(3)],
                    pool=[(0, 100), (95, 100)][rng.randint(2)])
        out.extend([window] * int(rng.randint(1, 6)))
    return out[:n]


SCENARIOS['seeded-mixed-run'] = (True, _seeded_windows())


def _strip(actions):
    return None if actions is None else [{k: v for k, v in a.items() if k != 'ts'}
                                         for a in actions]


@pytest.mark.parametrize('name', sorted(SCENARIOS))
def test_autotune_decisions_are_the_references(scalar_url, monkeypatch, name):
    live, windows = SCENARIOS[name]
    _set_knobs(monkeypatch, PETASTORM_TPU_IMAGE_DECODER_THREADS='4')
    pool = [(0, 100)]
    for module in (readahead, jax_readahead):
        monkeypatch.setattr(module, 'pool_status', lambda: pool[0])
    managers = []
    if live:
        plan = {'version': 1, 'items': [('f', 0)], 'randomize': False, 'seed': 0,
                'iterations': 1, 'exclude': []}
        managers = [readahead.ReadaheadManager(ParquetDatasetInfo(scalar_url), plan),
                    jax_readahead.ReadaheadManager(JaxDatasetInfo(scalar_url), plan)]
    loaders = [_FakeLoader(stager=_FakeStager()), _FakeLoader(stager=_FakeStager())]
    tuners = [autotune.StagingAutotuner(loaders[0], window_s=10.0),
              jax_autotune.StagingAutotuner(loaders[1], window_s=10.0)]
    base = readahead.current_depth()
    trail = []
    try:
        for w in windows:
            pool[0] = w['pool']
            got = [_strip(tuner.observe(_window(module, w['verdict'], w['io'], w['h2d'])))
                   for tuner, module in ((tuners[0], timeseries), (tuners[1], jax_timeseries))]
            assert got[0] == got[1]
            trail.extend(a['action'] for a in got[0])
            assert readahead.current_depth() == jax_readahead.current_depth()
            assert codecs.image_decoder_threads() == jax_codecs.image_decoder_threads()
            assert [(loader._prefetch, loader._stager.num_slots, loader.reader.ventilate_extra)
                    for loader in loaders] == [(loaders[1]._prefetch, loaders[1]._stager.num_slots,
                                                loaders[1].reader.ventilate_extra)] * 2
        assert tuners[0].decisions == tuners[1].decisions == len(trail)
        summary = tuners[0].summary()
        assert set(summary) == set(tuners[1].summary())
    finally:
        for tuner in tuners:
            tuner.close()
        for manager in managers:
            manager.close()
    # what each case of the reference asserts, on the port
    if name == 'sustained-io-wait-deepens-readahead':
        assert trail == ['deepen_readahead', 'raise_inflight']
    elif name in ('io-wait-without-starving-consumer', 'no-live-manager-no-depth-decisions'):
        assert 'deepen_readahead' not in trail
    elif name == 'pool-pressure-sheds-to-the-knob-floor':
        assert trail.count('shed_readahead') == 1
    elif name == 'inflight-raises-and-lowers':
        assert [a for a in trail if a.endswith('_inflight')] == ['raise_inflight',
                                                                 'lower_inflight']
        assert loaders[0].reader.ventilate_extra == 2  # never below the baseline
    elif name == 'h2d-starvation-deepens-slots-and-prefetch':
        assert loaders[0]._stager.num_slots == 8 and loaders[0]._prefetch == 8
    elif name == 'decode-threads-shed-and-restore':
        assert trail.count('shed_decode_threads') == 3
        assert trail.count('restore_decode_threads') == 3
    # every override died with its tuner
    assert readahead.current_depth() == base and readahead.depth_override() is None
    assert codecs._DECODER_THREADS_OVERRIDE is None
    assert autotune.override_owners() == (None, None)


def test_decisions_land_in_report_ring(scalar_url):
    plan = {'version': 1, 'items': [('f', 0)], 'randomize': False, 'seed': 0,
            'iterations': 1, 'exclude': []}
    manager = readahead.ReadaheadManager(ParquetDatasetInfo(scalar_url), plan)
    tuner = autotune.StagingAutotuner(_FakeLoader(), window_s=10.0)
    try:
        for _ in range(3):
            tuner.observe(_window(timeseries, PRODUCER_BOUND, io_rate=1.5))
        actions = {d['action'] for d in autotune.recent_decisions()}
        assert {'deepen_readahead', 'raise_inflight'} <= actions
        assert autotune.decision_counts() == {'deepen_readahead': 1, 'raise_inflight': 1}
        report = T.pipeline_report()
        assert report['staging_autotune']['total'] >= 2
        assert 'staging autotune: 2 decision(s)' in T.format_pipeline_report(report)
    finally:
        tuner.close()
        manager.close()


def test_two_tuners_never_fight_over_an_override(scalar_url, monkeypatch):
    """The first tuner to move an override owns it; a second leaves it
    alone, and closing the second drops nothing of the first's."""
    _set_knobs(monkeypatch, PETASTORM_TPU_IMAGE_DECODER_THREADS='4')
    first, second = (autotune.StagingAutotuner(_FakeLoader(), window_s=10.0)
                     for _ in range(2))
    try:
        for _ in range(3):
            first.observe(_window(timeseries, CONSUMER_BOUND))
        assert codecs.image_decoder_threads() == 3
        for _ in range(3):
            assert not [a for a in second.observe(_window(timeseries, CONSUMER_BOUND))
                        if a['action'] == 'shed_decode_threads']
        second.close()
        assert codecs.image_decoder_threads() == 3
        assert autotune.override_owners()[0] is first
    finally:
        first.close()
        second.close()
    assert codecs.image_decoder_threads() == 4 and autotune.override_owners() == (None, None)


def test_one_tuner_claims_an_override_slot_under_contention():
    """Tuners on many threads racing for the empty slots: one owner each,
    and closing them all leaves both slots empty."""
    import sys
    import threading
    tuners = [autotune.StagingAutotuner(_FakeLoader(), window_s=10.0) for _ in range(8)]
    barrier = threading.Barrier(len(tuners))
    claims = {'threads': [], 'readahead': []}

    def claim(tuner):
        barrier.wait()
        if tuner._owns_override():
            claims['threads'].append(tuner)
        if tuner._owns_readahead():
            claims['readahead'].append(tuner)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=claim, args=(t,)) for t in tuners]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join()
    finally:
        sys.setswitchinterval(interval)
        for tuner in tuners:
            tuner.close()
    assert len(claims['threads']) == len(claims['readahead']) == 1
    assert autotune.override_owners() == (None, None)


def test_a_closed_tuner_applies_no_window(monkeypatch):
    """A tick that reaches the policy after the loader's stop closed the
    tuner (a staging thread the stop gave up joining) moves nothing."""
    _set_knobs(monkeypatch, PETASTORM_TPU_IMAGE_DECODER_THREADS='4')
    loader = _FakeLoader()
    tuner = autotune.StagingAutotuner(loader, window_s=10.0)
    tuner.close()
    for verdict in [CONSUMER_BOUND] * 3 + [PRODUCER_BOUND] * 3:
        assert tuner.observe(_window(timeseries, verdict)) == []
    assert tuner.decisions == 0 and loader.reader.ventilate_extra == 2
    assert codecs.image_decoder_threads() == 4
    assert autotune.override_owners() == (None, None)


def _autotuned_loader(url, **kw):
    from petastorm_tpu_torch.device.loader import make_torch_loader
    return make_torch_loader(url, batch_size=20, device='cpu', fields=['^id$'],
                             reader_pool_type='dummy', shuffle_row_groups=False, **kw)


def test_loader_tunes_its_own_stager_reader_and_prefetch(scalar_url):
    """Synthetic windows through a real loader's tuner move that loader's
    slot ring, prefetch queue and reader, and show in its reports; stop
    drops everything it held."""
    loader = _autotuned_loader(scalar_url)
    try:
        ids = sorted(int(i) for b in loader for i in b['id'])
        assert ids == list(range(400))
        tuner = loader._autotuner
        assert tuner is not None
        slots = loader._stager.num_slots
        for _ in range(3):
            tuner.observe(_window(timeseries, h2d_ready=0.9))
        assert loader._stager.num_slots == slots + 1 and loader._prefetch == 3
        for _ in range(3):
            tuner.observe(_window(timeseries, PRODUCER_BOUND))
        assert loader.reader.ventilate_extra == 3
        report = loader.autotune_report()
        assert report['staging_autotune']['decisions'] == 3
        assert report['staging_autotune']['ventilate_extra'] == 3
        assert loader._obs_report()['autotune']['staging_autotune']['slots'] == slots + 1
        diag = loader.diagnostics
        assert diag['staging_autotune'] is True and diag['staging_autotune_decisions'] == 3
        # the learned ring depth carries into the next pass's engine
        assert sorted(int(i) for b in loader for i in b['id']) == list(range(400))
        assert loader._stager.num_slots == slots + 1
    finally:
        loader.stop()
    assert autotune.override_owners() == (None, None)
    assert readahead.live_manager_count() == 0


def test_loader_tick_closes_windows_on_the_staging_thread(scalar_url, monkeypatch):
    """With a 0.05 s window the staging thread's ``maybe_tick`` closes
    windows while the pass runs (a decision needs sustained windows and
    may or may not come)."""
    _set_knobs(monkeypatch, PETASTORM_TPU_STAGING_AUTOTUNE_WINDOW_SEC='0.05')
    ticks = []
    original = autotune.StagingAutotuner.tick
    monkeypatch.setattr(autotune.StagingAutotuner, 'tick',
                        lambda self, now=None: ticks.append(now) or original(self, now))
    with _autotuned_loader(scalar_url, num_epochs=None) as loader:
        deadline = time.monotonic() + 10
        for batch in loader:
            time.sleep(0.01)
            if len(ticks) >= 3 or time.monotonic() > deadline:
                break
        assert loader._autotuner.window_s == 0.05
    assert len(ticks) >= 3
    registry = T.get_registry()
    assert registry.counter_value('petastorm_tpu_stage_calls_total', stage='autotune') >= 3


@pytest.mark.parametrize('knob', ['PETASTORM_TPU_STAGING_AUTOTUNE', 'PETASTORM_TPU_STAGING'])
def test_knobs_off_mean_no_tuner(scalar_url, monkeypatch, knob):
    _set_knobs(monkeypatch, **{knob: '0'})
    with _autotuned_loader(scalar_url) as loader:
        assert sorted(int(i) for b in loader for i in b['id']) == list(range(400))
        assert loader._autotuner is None
        assert 'staging_autotune' not in loader.autotune_report()
        assert loader.diagnostics['staging_autotune_decisions'] == 0


# -- the sanitizer --------------------------------------------------------------


def test_parity_and_canaries_under_sanitize(scalar_url, monkeypatch):
    _set_knobs(monkeypatch, PETASTORM_TPU_SANITIZE='1')
    torch_sanitizer.refresh_sanitizer()
    with make_batch_reader(scalar_url, reader_pool_type='thread', seed=0) as reader:
        manager = _worker(reader)._readahead
        got = _ids(reader)
    assert got == list(range(400))
    assert T.get_registry().counter_value(readahead.READAHEAD_HITS) > 0
    assert not [v for v in torch_sanitizer.violations() if v['kind'] == 'readahead-canary']
    gc.collect()
    assert manager._pool.used == 0
    assert T.get_registry().counter_value('petastorm_tpu_sanitizer_canary_checks_total') > 0


def test_trampled_fetch_buffer_is_caught(scalar_url, monkeypatch):
    """A byte written into a guarded fetch buffer's red zone is a
    ``readahead-canary`` violation when the pool reclaims it."""
    _set_knobs(monkeypatch, PETASTORM_TPU_SANITIZE='1')
    torch_sanitizer.refresh_sanitizer()
    original = readahead._Fetch.complete

    def trample(self, ranges, guards, nbytes, columns, file_size):
        guards[0].numpy()[0] ^= 0xFF
        return original(self, ranges, guards, nbytes, columns, file_size)

    monkeypatch.setattr(readahead._Fetch, 'complete', trample)
    with make_batch_reader(scalar_url, reader_pool_type='dummy', seed=0) as reader:
        got = _ids(reader)
    gc.collect()
    assert got == list(range(400))
    kinds = [v['kind'] for v in torch_sanitizer.violations()]
    assert 'readahead-canary' in kinds
    torch_sanitizer.reset_for_tests()


# -- on the card ----------------------------------------------------------------


@pytest.mark.cuda
def test_card_loader_with_readahead_and_autotune_equals_the_cpu_loader(scalar_url):
    """Batches staged onto the card by a loader with both planes on equal
    the CPU loader's, and the plane served hits."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the staging ring copies to the card')
    from petastorm_tpu_torch.device.loader import make_torch_loader

    def batches(device):
        with make_torch_loader(scalar_url, batch_size=20, device=device, fields=['^id$'],
                               reader_pool_type='dummy', shuffle_row_groups=False) as loader:
            out = [b['id'].cpu() for b in loader]
            assert loader._autotuner is not None  # made at the pass's start
            return out

    card, cpu = batches('cuda'), batches('cpu')
    assert len(card) == len(cpu) == 20
    assert all(torch.equal(a, b) for a, b in zip(card, cpu))
    assert T.get_registry().counter_value(readahead.READAHEAD_HITS) > 0
