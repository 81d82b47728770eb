"""petastorm_tpu_torch.pushdown against petastorm_tpu.pushdown: the
footer-statistics planner, null safety, exact parity with the full-scan
oracle, and checkpoint accounting of pruned row-groups.

Each case builds the same predicate in both packages and reads the same
dataset with the dummy pool, so delivery order is deterministic: the ids
(exact, in order), the planner's summary, the pruned item sets, the
counters and the ``state_dict``s must be the JAX package's, and the
port's rows must equal its own decode-everything-then-filter oracle
(``PETASTORM_TPU_PUSHDOWN=0``). The cases are the JAX package's
``tests/test_pushdown.py`` matrix.
"""

import os
import types

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from petastorm_tpu import filters as jax_filters
from petastorm_tpu import predicates as jax_predicates
from petastorm_tpu import pushdown as jax_pushdown
from petastorm_tpu import reader as jax_reader
from petastorm_tpu import telemetry as jax_telemetry
from petastorm_tpu_torch import filters as torch_filters
from petastorm_tpu_torch import predicates as torch_predicates
from petastorm_tpu_torch import pushdown as torch_pushdown
from petastorm_tpu_torch import reader as torch_reader
from petastorm_tpu_torch.telemetry import get_registry, reset_registry
from tests.torch_telemetry_common import plane_guard  # noqa: F401 - autouse


def _namespace(filters, predicates, pushdown, reader):
    return types.SimpleNamespace(
        F=filters.FiltersPredicate, in_set=predicates.in_set,
        in_lambda=predicates.in_lambda, in_negate=predicates.in_negate,
        in_reduce=predicates.in_reduce, pushdown=pushdown,
        make_batch_reader=reader.make_batch_reader, make_reader=reader.make_reader)


PACKAGES = {
    'jax': _namespace(jax_filters, jax_predicates, jax_pushdown, jax_reader),
    'torch': _namespace(torch_filters, torch_predicates, torch_pushdown, torch_reader),
}


def reset_both():
    jax_telemetry.reset_for_tests()
    reset_registry()
    torch_pushdown.reset_for_tests()


@pytest.fixture(autouse=True)
def _fresh_state():
    reset_both()
    yield
    reset_both()


def counter(package, name, **labels):
    if package == 'jax':
        return jax_telemetry.get_registry().counter_value(name, **labels)
    key = name
    if labels:
        key += '{%s}' % ','.join('%s="%s"' % kv for kv in sorted(labels.items()))
    return get_registry().snapshot()['counters'].get(key, 0)


def read(package, url, build=None, oracle=False, pool='dummy', monkeypatch=None, rows=False,
         **kwargs):
    """One package's read: ids in delivery order (``rows``: ``(id, image
    bytes, matrix bytes)`` from ``make_reader``), the reader's pruned items
    and its final ``state_dict``. ``build(ns)`` makes the predicate."""
    ns = PACKAGES[package]
    if oracle:
        monkeypatch.setenv('PETASTORM_TPU_PUSHDOWN', '0')
    try:
        if build is not None:
            kwargs['predicate'] = build(ns)
        make = ns.make_reader if rows else ns.make_batch_reader
        kwargs.setdefault('shuffle_row_groups', False)
        with make(url, reader_pool_type=pool, **kwargs) as reader:
            if rows:
                out = [(int(r.id), r.image_png.tobytes(), r.matrix.tobytes()) for r in reader]
            else:
                out = [int(i) for batch in reader for i in batch.id]
            return out, sorted(reader._pruned_items), reader.state_dict()
    finally:
        if oracle:
            monkeypatch.delenv('PETASTORM_TPU_PUSHDOWN')


def read_both(url, build=None, **kwargs):
    """``(jax, torch)`` reads; resets the planner state before each."""
    out = []
    for package in ('jax', 'torch'):
        reset_both() if package == 'jax' else None
        out.append(read(package, url, build, **kwargs))
    return out


def summaries_equal_after(url, build, **kwargs):
    """Read with each package from a fresh state and return both planner
    summaries and both results."""
    results, summaries = {}, {}
    for package in ('jax', 'torch'):
        reset_both()
        results[package] = read(package, url, build, **kwargs)
        summaries[package] = PACKAGES[package].pushdown.planner_summary()
    return results, summaries


# -- datasets ------------------------------------------------------------------


def _write_groups(path, tables, name='part0.parquet', **kwargs):
    os.makedirs(path, exist_ok=True)
    writer = pq.ParquetWriter(os.path.join(path, name), tables[0].schema, **kwargs)
    for t in tables:
        writer.write_table(t)
    writer.close()
    return 'file://' + path


@pytest.fixture(scope='module')
def two_rowgroup_url(tmp_path_factory):
    """One file, two row-groups: x in [0, 9] and x in [20, 29], no nulls."""
    t = [pa.table({'x': pa.array(r, type=pa.int64()), 'id': pa.array(r, type=pa.int64())})
         for r in (range(10), range(20, 30))]
    return _write_groups(str(tmp_path_factory.mktemp('prover')) + '/ds', t)


@pytest.fixture(scope='module')
def null_bearing_url(tmp_path_factory):
    """A string x: ['a', None, 'c'] then ['m', 'n', 'p']."""
    t = [pa.table({'x': pa.array(['a', None, 'c']), 'id': pa.array([0, 1, 2], pa.int64())}),
         pa.table({'x': pa.array(['m', 'n', 'p']), 'id': pa.array([3, 4, 5], pa.int64())})]
    return _write_groups(str(tmp_path_factory.mktemp('nulls')) + '/ds', t)


# -- the prover ----------------------------------------------------------------

PROVER_CASES = [
    ([('x', '=', 5)], 1),
    ([('x', '=', 15)], 2),
    ([('x', '<', 0)], 2),
    ([('x', '<', 1)], 1),
    ([('x', '<=', 0)], 1),
    ([('x', '>', 29)], 2),
    ([('x', '>=', 25)], 1),
    ([('x', '!=', 40)], 0),
    ([('x', 'in', (11, 15))], 2),
    ([('x', 'in', (5, 15))], 1),
    ([('x', 'not in', (5,))], 0),
    ([[('x', '<', 0)], [('x', '>', 29)]], 2),
    ([[('x', '<', 0)], [('x', '=', 25)]], 1),
]


@pytest.mark.parametrize('filters,expected_pruned', PROVER_CASES,
                         ids=['case%d' % i for i in range(len(PROVER_CASES))])
def test_clause_interval_logic(two_rowgroup_url, monkeypatch, filters, expected_pruned):
    def build(ns):
        return ns.F(filters)
    results, summaries = summaries_equal_after(two_rowgroup_url, build)
    assert results['torch'] == results['jax']
    assert summaries['torch'] == summaries['jax']
    assert summaries['torch']['rowgroups_pruned'] == expected_pruned
    oracle = read('torch', two_rowgroup_url, build, oracle=True, monkeypatch=monkeypatch)
    assert results['torch'][0] == oracle[0]


COMPOSITIONS = {
    'in_set': (lambda ns: ns.in_set([15, 16], 'x'), 2),
    'reduce_all_with_arbitrary': (
        lambda ns: ns.in_reduce([ns.in_lambda(['x'], lambda v: True),
                                 ns.F([('x', '>', 15)])], all), 1),
    'reduce_any': (lambda ns: ns.in_reduce([ns.F([('x', '=', 15)]), ns.in_set([16], 'x')],
                                           any), 2),
    'reduce_any_with_arbitrary': (
        lambda ns: ns.in_reduce([ns.F([('x', '=', 15)]),
                                 ns.in_lambda(['x'], lambda v: v['x'] == 3)], any), 0),
}


@pytest.mark.parametrize('case', sorted(COMPOSITIONS))
def test_in_set_and_reduce_compositions(two_rowgroup_url, case):
    build, pruned = COMPOSITIONS[case]
    results, summaries = summaries_equal_after(two_rowgroup_url, build)
    assert results['torch'] == results['jax']
    assert summaries['torch'] == summaries['jax']
    assert summaries['torch']['rowgroups_pruned'] == pruned


@pytest.mark.parametrize('case', ['lambda', 'negate'])
def test_arbitrary_predicates_decline(two_rowgroup_url, case):
    def build(ns):
        if case == 'lambda':
            return ns.in_lambda(['x'], lambda v: v['x'] == 25)
        return ns.in_negate(ns.F([('x', '<', 15)]))
    results, summaries = summaries_equal_after(two_rowgroup_url, build)
    assert results['torch'] == results['jax']
    assert summaries['torch'] == summaries['jax']
    assert summaries['torch']['declines'] == {'arbitrary-predicate': 1}


def test_incomparable_types_keep(two_rowgroup_url):
    results, summaries = summaries_equal_after(two_rowgroup_url,
                                               lambda ns: ns.F([('x', 'in', ('zz',))]))
    assert results['torch'] == results['jax'] and results['torch'][0] == []
    assert summaries['torch'] == summaries['jax']
    assert summaries['torch']['rowgroups_pruned'] == 0


def test_counters_are_the_references(two_rowgroup_url):
    for package in ('jax', 'torch'):
        reset_both()
        ids, _, _ = read(package, two_rowgroup_url, lambda ns: ns.F([('x', '<', 5)]))
        assert ids == list(range(5))
        assert counter(package, torch_pushdown.ROWGROUPS_PRUNED) == 1
        assert counter(package, torch_pushdown.ROWS_PRUNED) == 10
    assert torch_pushdown.ROWGROUPS_PRUNED == jax_pushdown.ROWGROUPS_PRUNED
    assert torch_pushdown.ROWS_PRUNED == jax_pushdown.ROWS_PRUNED
    assert torch_pushdown.LATE_MATERIALIZED_ROWS == jax_pushdown.LATE_MATERIALIZED_ROWS


def test_no_planner_run_without_predicate(two_rowgroup_url):
    ids, pruned, _ = read('torch', two_rowgroup_url)
    assert ids == list(range(10)) + list(range(20, 30)) and pruned == []
    assert torch_pushdown.planner_summary()['planner_runs'] == 0


def test_footer_memoization(two_rowgroup_url, monkeypatch):
    calls = []
    real = torch_pushdown.StatsIndex._read_footer

    def counting(self, path):
        calls.append(path)
        return real(self, path)

    monkeypatch.setattr(torch_pushdown.StatsIndex, '_read_footer', counting)
    for _ in range(2):
        read('torch', two_rowgroup_url, lambda ns: ns.F([('x', '<', 5)]))
    # the second reader's plan hits the process-wide memo
    assert len(calls) == 1
    torch_pushdown.reset_for_tests()
    read('torch', two_rowgroup_url, lambda ns: ns.F([('x', '<', 5)]))
    assert len(calls) == 2


def test_footer_memo_is_bounded(monkeypatch):
    monkeypatch.setattr(torch_pushdown, '_FOOTER_CACHE_MAX_FILES', 2)

    class Info:
        url = 'mem://x'

        class fs:
            @staticmethod
            def info(path):
                return {'size': 1, 'mtime': 2}

    monkeypatch.setattr(torch_pushdown.StatsIndex, '_read_footer', lambda self, path: [])
    index = torch_pushdown.StatsIndex(Info())
    index.prefetch(['a', 'b', 'c'])
    assert [k[1] for k in torch_pushdown._footer_cache] == ['b', 'c']


# -- null safety ---------------------------------------------------------------


def test_in_set_none_not_wrongly_pruned(null_bearing_url, monkeypatch):
    results, summaries = summaries_equal_after(null_bearing_url,
                                               lambda ns: ns.in_set([None, 'zz'], 'x'))
    assert results['torch'] == results['jax'] and results['torch'][0] == [1]
    assert summaries['torch']['rowgroups_pruned'] == 1 == summaries['jax']['rowgroups_pruned']
    assert read('torch', null_bearing_url, lambda ns: ns.in_set([None, 'zz'], 'x'),
                oracle=True, monkeypatch=monkeypatch)[0] == [1]


@pytest.mark.parametrize('filters', [[('x', '!=', 5)], [('x', 'not in', (5,))]],
                         ids=['ne', 'not-in'])
def test_negative_ops_keep_null_bearing_numeric_groups(tmp_path, monkeypatch, filters):
    t1 = pa.table({'x': pa.array([7, 8, 9], pa.int64()), 'id': pa.array([3, 4, 5], pa.int64())})
    url = _write_groups(str(tmp_path / 'numnulls'), [
        pa.table({'x': pa.array([5, None, 5], pa.int64()),
                  'id': pa.array([0, 1, 2], pa.int64())}), t1])
    results, summaries = summaries_equal_after(url, lambda ns: ns.F(filters))
    assert results['torch'] == results['jax'] and results['torch'][0] == [1, 3, 4, 5]
    assert summaries['torch']['rowgroups_pruned'] == 0
    assert read('torch', url, lambda ns: ns.F(filters), oracle=True,
                monkeypatch=monkeypatch)[0] == [1, 3, 4, 5]
    # without nulls a lo == hi == value group is pruned
    url2 = _write_groups(str(tmp_path / 'nonulls'), [
        pa.table({'x': pa.array([5, 5, 5], pa.int64()),
                  'id': pa.array([0, 1, 2], pa.int64())}), t1])
    results, summaries = summaries_equal_after(url2, lambda ns: ns.F(filters))
    assert results['torch'] == results['jax'] and results['torch'][0] == [3, 4, 5]
    assert summaries['torch']['rowgroups_pruned'] == 1 == summaries['jax']['rowgroups_pruned']


@pytest.mark.parametrize('filters', [[('x', '!=', 5.0)], [('x', 'not in', (5.0,))]],
                         ids=['ne', 'not-in'])
def test_negative_ops_keep_stored_nan_float_groups(tmp_path, monkeypatch, filters):
    path = str(tmp_path / 'storednan')
    os.makedirs(path)
    pq.write_table(pa.table({'x': pa.array([5.0, float('nan'), 5.0]),
                             'id': pa.array([0, 1, 2], pa.int64())}),
                   os.path.join(path, 'p0.parquet'))
    url = 'file://' + path
    results, summaries = summaries_equal_after(url, lambda ns: ns.F(filters))
    assert results['torch'] == results['jax'] and results['torch'][0] == [1]
    assert summaries['torch']['rowgroups_pruned'] == 0 == summaries['jax']['rowgroups_pruned']
    assert read('torch', url, lambda ns: ns.F(filters), oracle=True,
                monkeypatch=monkeypatch)[0] == [1]


def test_dnf_terms_prune_through_nulls(null_bearing_url):
    results, summaries = summaries_equal_after(null_bearing_url,
                                               lambda ns: ns.F([('x', '>', 'f')]))
    assert results['torch'] == results['jax'] and results['torch'][0] == [3, 4, 5]
    assert summaries['torch']['rowgroups_pruned'] == 1 == summaries['jax']['rowgroups_pruned']


# -- exact parity with the oracle and the JAX package ------------------------------


@pytest.mark.parametrize('pool', ['dummy', 'thread'])
def test_row_multiset_parity_across_pools(synthetic_dataset, monkeypatch, pool):
    def build(ns):
        return ns.F([[('id', '<', 12)], [('id', '>=', 95)]])
    want = list(range(12)) + list(range(95, 100))
    jax_ids = read('jax', synthetic_dataset.url, build, pool=pool, workers_count=2)[0]
    ids = read('torch', synthetic_dataset.url, build, pool=pool, workers_count=2)[0]
    oracle = read('torch', synthetic_dataset.url, build, pool=pool, workers_count=2,
                  oracle=True, monkeypatch=monkeypatch)[0]
    assert sorted(ids) == sorted(oracle) == sorted(jax_ids) == want
    if pool == 'dummy':
        assert ids == jax_ids
    assert counter('torch', torch_pushdown.ROWGROUPS_PRUNED) > 0


def test_heavy_column_value_parity(synthetic_dataset, monkeypatch):
    def build(ns):
        return ns.F([('id', 'in', (3, 31, 47, 99))])
    got = read('torch', synthetic_dataset.url, build, rows=True)[0]
    late = counter('torch', torch_pushdown.LATE_MATERIALIZED_ROWS)
    stage = counter('torch', 'petastorm_tpu_stage_calls_total', stage='late_materialize')
    want = read('jax', synthetic_dataset.url, build, rows=True)[0]
    oracle = read('torch', synthetic_dataset.url, build, rows=True, oracle=True,
                  monkeypatch=monkeypatch)[0]
    assert sorted(g[0] for g in got) == [3, 31, 47, 99]
    assert got == want and sorted(got) == sorted(oracle)
    assert late == counter('jax', jax_pushdown.LATE_MATERIALIZED_ROWS) == 4
    assert stage > 0


def test_sharding_parity(synthetic_dataset, monkeypatch):
    def build(ns):
        return ns.F([('id', '<', 30)])
    per_shard = []
    for cur in (0, 1):
        jax_out, torch_out = read_both(synthetic_dataset.url, build, cur_shard=cur,
                                       shard_count=2)
        oracle = read('torch', synthetic_dataset.url, build, cur_shard=cur, shard_count=2,
                      oracle=True, monkeypatch=monkeypatch)
        # pruning runs after sharding: each shard equals its unpruned self
        assert torch_out == jax_out
        assert torch_out[0] == oracle[0]
        assert torch_out[2]['items_global'] == oracle[2]['items_global']
        per_shard.append(torch_out[0])
    assert sorted(per_shard[0] + per_shard[1]) == list(range(30))


def test_prune_only_knob_keeps_late_materialization(synthetic_dataset, monkeypatch):
    monkeypatch.setenv('PETASTORM_TPU_PUSHDOWN_PRUNE', '0')
    for package in ('jax', 'torch'):
        reset_both()
        ids, pruned, _ = read(package, synthetic_dataset.url,
                              lambda ns: ns.F([('id', 'in', (3, 47))]))
        assert ids == [3, 47] and pruned == []
        assert counter(package, torch_pushdown.ROWGROUPS_PRUNED) == 0
        assert counter(package, torch_pushdown.LATE_MATERIALIZED_ROWS) == 2


def test_row_drop_partition_parity(synthetic_dataset, monkeypatch):
    def build(ns):
        return ns.F([('id', 'in', (3, 31, 47))])
    jax_out, torch_out = read_both(synthetic_dataset.url, build, shuffle_row_drop_partitions=3)
    oracle = read('torch', synthetic_dataset.url, build, shuffle_row_drop_partitions=3,
                  oracle=True, monkeypatch=monkeypatch)
    assert torch_out == jax_out
    assert sorted(torch_out[0]) == sorted(oracle[0]) == [3, 31, 47]


@pytest.mark.parametrize('epochs', [1, None])
def test_fully_pruned_reader_delivers_empty(synthetic_dataset, epochs):
    for package in ('jax', 'torch'):
        ns = PACKAGES[package]
        with ns.make_batch_reader(synthetic_dataset.url, num_epochs=epochs,
                                  shuffle_row_groups=False, reader_pool_type='dummy',
                                  predicate=ns.F([('id', '>', 10 ** 6)])) as reader:
            assert list(reader) == []


def test_multi_epoch_parity(synthetic_dataset):
    jax_out, torch_out = read_both(synthetic_dataset.url, lambda ns: ns.F([('id', '<', 7)]),
                                   num_epochs=3, shuffle_row_groups=True, seed=3)
    assert torch_out == jax_out
    assert sorted(torch_out[0]) == sorted(list(range(7)) * 3)


# -- checkpoint accounting -----------------------------------------------------


def test_completed_epoch_reads_complete(synthetic_dataset):
    jax_out, torch_out = read_both(synthetic_dataset.url, lambda ns: ns.F([('id', '<', 25)]),
                                   num_epochs=1)
    assert torch_out == jax_out
    ids, pruned, state = torch_out
    assert pruned and ids == list(range(25))
    assert state['epoch'] == 1 and state['consumed_items'] == []


@pytest.mark.parametrize('saver,loader', [('torch', 'jax'), ('jax', 'torch'),
                                          ('torch', 'torch')])
def test_mid_epoch_resume_loses_no_rows(synthetic_dataset, saver, loader):
    """A state saved mid-epoch under pruning resumes in either package
    with the same rows."""
    def build(ns):
        return ns.F([('id', '<', 25)])
    states = {}
    for package in ('jax', 'torch'):
        ns = PACKAGES[package]
        with ns.make_batch_reader(synthetic_dataset.url, num_epochs=1,
                                  shuffle_row_groups=False, reader_pool_type='dummy',
                                  predicate=build(ns)) as reader:
            first = next(iter(reader))
            states[package] = reader.state_dict()
    assert states['torch'] == states['jax']
    seen = set(int(i) for i in first.id)
    ns = PACKAGES[loader]
    with ns.make_batch_reader(synthetic_dataset.url, num_epochs=1, shuffle_row_groups=False,
                              reader_pool_type='dummy', predicate=build(ns)) as reader:
        reader.load_state_dict(states[saver])
        rest = set(int(i) for b in reader for i in b.id)
    assert seen | rest == set(range(25)) and not seen & rest


@pytest.mark.parametrize('save_oracle,restore_oracle', [(False, True), (True, False)])
def test_resume_across_pushdown_knob_flip(synthetic_dataset, monkeypatch, save_oracle,
                                          restore_oracle):
    """Flipping ``PETASTORM_TPU_PUSHDOWN`` across a resume changes the
    filters' pre-shard prune, so the item indices differ: the state
    translates through its global identities and no row is lost."""
    filters = [[('id', '<', 10)], [('id', '>=', 30)]]
    expected = set(range(10)) | set(range(30, 100))

    def build(oracle):
        if oracle:
            monkeypatch.setenv('PETASTORM_TPU_PUSHDOWN', '0')
        else:
            monkeypatch.delenv('PETASTORM_TPU_PUSHDOWN', raising=False)
        return torch_reader.make_batch_reader(synthetic_dataset.url, num_epochs=1,
                                              shuffle_row_groups=False,
                                              reader_pool_type='dummy', filters=filters)

    with build(save_oracle) as reader:
        it = iter(reader)
        seen = set(int(i) for i in next(it).id) | set(int(i) for i in next(it).id)
        state = reader.state_dict()
    with build(restore_oracle) as reader:
        reader.load_state_dict(state)
        rest = set(int(i) for b in reader for i in b.id)
    assert seen | rest == expected, sorted(expected - (seen | rest))


def test_ventilation_order_skips_pruned_items(synthetic_dataset):
    orders = {}
    for package in ('jax', 'torch'):
        ns = PACKAGES[package]
        with ns.make_batch_reader(synthetic_dataset.url, reader_pool_type='dummy', seed=5,
                                  predicate=ns.F([('id', 'in', (3, 55, 91))])) as reader:
            orders[package] = [reader.ventilation_order(e) for e in (0, 1)]
            pruned = reader._pruned_items
    assert orders['torch'] == orders['jax']
    assert len(orders['torch'][0]) == 3 and not set(orders['torch'][0]) & pruned


# -- degrading: no statistics prunes nothing and loses no row --------------------


def test_statless_dataset_declines(tmp_path):
    path = str(tmp_path / 'nostats')
    os.makedirs(path)
    pq.write_table(pa.table({'id': pa.array(range(20), type=pa.int64())}),
                   os.path.join(path, 'p0.parquet'), write_statistics=False)
    results, summaries = summaries_equal_after('file://' + path,
                                               lambda ns: ns.F([('id', '<', 5)]))
    assert results['torch'] == results['jax'] and results['torch'][0] == list(range(5))
    assert summaries['torch'] == summaries['jax']
    assert summaries['torch']['rowgroups_pruned'] == 0
    assert summaries['torch']['declines'].get('no-statistics', 0) > 0


def test_unreadable_footer_keeps_every_row_group(synthetic_dataset):
    from petastorm_tpu_torch.etl.dataset_metadata import ParquetDatasetInfo, load_row_groups
    info = ParquetDatasetInfo(synthetic_dataset.url)
    pieces = load_row_groups(info)

    class Failing:
        url = info.url
        fs = types.SimpleNamespace(info=info.fs.info, open=lambda *a: 1 / 0)

    plan = torch_pushdown.plan_rowgroup_pruning(
        Failing(), pieces, range(len(pieces)), clauses=[[('id', '<', 10)]])
    assert plan.kept == list(range(len(pieces))) and plan.pruned == []
    assert plan.no_stats_rowgroups == len(pieces)
    assert torch_pushdown.planner_summary()['declines'] == {'no-statistics': len(pieces)}


def test_dataset_file_fingerprint_without_stat():
    class NoStat:
        class fs:
            @staticmethod
            def info(path):
                raise OSError(path)
    assert torch_pushdown.dataset_file_fingerprint(NoStat(), 'p') == 'nostat'


@pytest.mark.parametrize('knob,enabled,oracle', [
    (None, True, False), ('PETASTORM_TPU_PUSHDOWN', False, True),
    ('PETASTORM_TPU_PUSHDOWN_PRUNE', False, False)])
def test_knobs_are_the_references(monkeypatch, knob, enabled, oracle):
    if knob is not None:
        monkeypatch.setenv(knob, '0')
    for pushdown in (jax_pushdown, torch_pushdown):
        assert pushdown.pushdown_enabled() is enabled
        assert pushdown.fullscan_oracle() is oracle


# -- the ventilator's always_exclude -----------------------------------------------


def _ventilate(module, items, exclude_once=None, **kwargs):
    out = []
    vent = module.ConcurrentVentilator(lambda **item: out.append(item['i']), items, **kwargs)
    if exclude_once is not None:
        vent.exclude_from_next_epoch(exclude_once)
    vent.start()
    while not vent.completed():
        vent.processed_item()
    vent.stop()
    return out, vent.completed()


VENTILATOR_CASES = {
    'every-epoch': (dict(iterations=2, always_exclude={1, 3}), None),
    'all-excluded': (dict(iterations=1, always_exclude={0, 1, 2, 3}), None),
    'all-excluded-infinite': (dict(iterations=None, always_exclude={0, 1, 2, 3}), None),
    'with-exclude-once': (dict(iterations=2, always_exclude={3}), {0}),
    'shuffled': (dict(iterations=3, always_exclude={2}, randomize_item_order=True,
                      random_seed=11), None),
}


@pytest.mark.parametrize('case', sorted(VENTILATOR_CASES))
def test_ventilator_always_exclude_is_the_references(case):
    from petastorm_tpu.workers import ventilator as jax_ventilator
    from petastorm_tpu_torch.workers import ventilator as torch_ventilator
    kwargs, once = VENTILATOR_CASES[case]
    items = [{'i': n} for n in range(4)]
    want = _ventilate(jax_ventilator, items, once, **kwargs)
    got = _ventilate(torch_ventilator, items, once, **kwargs)
    assert got == want
    assert got[1] is True
    if case == 'every-epoch':
        assert got[0] == [0, 2, 0, 2]
