"""petastorm_tpu_torch.filters against petastorm_tpu.filters.

The JAX package's ``tests/test_filters.py`` cases, each run through both
packages: DNF normalization (the same clauses, or ``ValueError`` with the
same text), ``FiltersPredicate``'s row and columnar masks (exact), and
end to end on the dummy pool: the same rows in the same order, the same
row-groups left after the partition and statistics prune, the same
``NoDataAvailableError`` text.
"""

import numpy as np
import pytest

from petastorm_tpu import filters as jax_filters
from petastorm_tpu import predicates as jax_predicates
from petastorm_tpu.errors import NoDataAvailableError as JaxNoData
from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader
from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu_torch import filters as torch_filters
from petastorm_tpu_torch import predicates as torch_predicates
from petastorm_tpu_torch import pushdown as torch_pushdown
from petastorm_tpu_torch.errors import NoDataAvailableError as TorchNoData
from petastorm_tpu_torch.etl.dataset_metadata import ParquetDatasetInfo
from petastorm_tpu_torch.reader import make_batch_reader as torch_make_batch_reader
from petastorm_tpu_torch.reader import make_reader as torch_make_reader

READERS = {'jax': (jax_make_reader, jax_make_batch_reader),
           'torch': (torch_make_reader, torch_make_batch_reader)}
PREDICATES = {'jax': jax_predicates, 'torch': torch_predicates}


@pytest.fixture(autouse=True)
def _fresh_planner():
    torch_pushdown.reset_for_tests()
    yield
    torch_pushdown.reset_for_tests()


VALID = {
    'single-and-group': [('a', '=', 1), ('b', '<', 2)],
    'or-of-ands': [[('a', '=', 1)], [('b', 'in', (1, 2))]],
    'lists-as-terms': [['a', '!=', 3]],
    'empty': [],
    'none': None,
}


@pytest.mark.parametrize('case', sorted(VALID))
def test_normalize_is_the_references(case):
    assert torch_filters.normalize_filters(VALID[case]) == \
        jax_filters.normalize_filters(VALID[case])


INVALID = {
    'unsupported-op': [('a', 'like', 1)],
    'not-a-triple': [('a', '=')],
    'empty-and-clause': [[('a', '=', 1)], []],
    'non-string-column': [(1, '=', 1)],
    'mixed-flat-nested': [('a', '=', 1), [('b', '=', 2)]],
    'string-for-in': [('a', 'in', 'p_2')],
    'scalar-for-not-in': [('a', 'not in', 5)],
    'bad-term-in-clause': [[('a', '=', 1), ('b', 2)]],
}


@pytest.mark.parametrize('case', sorted(INVALID))
def test_invalid_filters_raise_the_references_error(case):
    with pytest.raises(ValueError) as want:
        jax_filters.normalize_filters(INVALID[case])
    with pytest.raises(ValueError) as got:
        torch_filters.normalize_filters(INVALID[case])
    assert str(got.value) == str(want.value)


MASK_CASES = {
    'lt': [('x', '<', 3)],
    'ge-and-ne': [('x', '>=', 2), ('y', '!=', 'b')],
    'in': [('x', 'in', (0, 4))],
    'not-in': [('y', 'not in', ('a',))],
    'or': [[('x', '=', 0)], [('y', '=', 'c')]],
    'numeric-in': [('x', 'in', (2, 4))],
    'le-gt': [('x', '<=', 3), ('x', '>', 0)],
    'eq-double': [('x', '==', 1)],
}


@pytest.mark.parametrize('case', sorted(MASK_CASES))
def test_row_and_columnar_masks_are_the_references(case):
    columns = {'x': np.arange(5), 'y': ['a', 'b', 'c', 'b', 'c']}
    want = jax_filters.FiltersPredicate(MASK_CASES[case])
    got = torch_filters.FiltersPredicate(MASK_CASES[case])
    assert got.get_fields() == want.get_fields()
    assert got.clauses == want.clauses
    mask = got.do_include_batch(columns)
    np.testing.assert_array_equal(mask, want.do_include_batch(columns))
    rows = [{'x': columns['x'][i], 'y': columns['y'][i]} for i in range(5)]
    assert [got.do_include(r) for r in rows] == [want.do_include(r) for r in rows] \
        == mask.tolist()


@pytest.mark.parametrize('filters', [[('x', '<', 2)], [('x', '>=', 1)], [('x', '!=', 1)],
                                     [('x', 'in', (0, 1))], [('x', 'not in', (0,))]],
                         ids=['lt', 'ge', 'ne', 'in', 'not-in'])
def test_nulls_never_match(filters):
    columns = {'x': np.array([0, 1, None], dtype=object)}
    want = jax_filters.FiltersPredicate(filters)
    got = torch_filters.FiltersPredicate(filters)
    assert got.do_include_batch(columns).tolist() == want.do_include_batch(columns).tolist()
    assert [got.do_include({'x': v}) for v in columns['x']] == \
        [want.do_include({'x': v}) for v in columns['x']]
    assert got.do_include({'x': None}) is False


def test_describe_clauses_is_the_references():
    clauses = [[('a', '=', 1), ('b', 'in', ('x', 'y'))], [('c', '<', 2.5)]]
    assert torch_filters.describe_clauses(clauses) == jax_filters.describe_clauses(clauses)


def test_empty_filters_predicate_raises():
    with pytest.raises(ValueError, match='filters must be non-empty'):
        torch_filters.FiltersPredicate([])


# -- end to end ----------------------------------------------------------------


@pytest.fixture(scope='module')
def partitioned_url(tmp_path_factory):
    from tests.test_common import create_test_dataset
    url = 'file://' + str(tmp_path_factory.mktemp('filters')) + '/ds'
    create_test_dataset(url, range(100), num_files=1, rowgroup_size=10,
                        partition_by=('partition_key',))
    return url


def _read(package, url, row=True, **kw):
    """Ids in delivery order, the partition keys seen and the reader's
    row-groups, on the dummy pool."""
    make = READERS[package][0 if row else 1]
    kw.setdefault('shuffle_row_groups', False)
    with make(url, reader_pool_type='dummy', **kw) as reader:
        if row:
            rows = list(reader)
            ids = [int(r.id) for r in rows]
            keys = {getattr(r, 'partition_key', None) for r in rows}
        else:
            ids = [int(i) for b in reader for i in b.id]
            keys = None
        return ids, keys, list(reader._piece_indices)


def _both(url, row=True, **kw):
    return _read('jax', url, row, **kw), _read('torch', url, row, **kw)


def test_make_reader_partition_filter(partitioned_url):
    want, got = _both(partitioned_url, filters=[('partition_key', '=', 'p_2')])
    assert got == want
    assert got[1] == {'p_2'} and sorted(got[0]) == [i for i in range(100) if i % 5 == 2]


def test_partition_filter_prunes_row_groups(partitioned_url):
    total = len(_read('torch', partitioned_url, schema_fields=['^id$'])[2])
    want, got = _both(partitioned_url, schema_fields=['^id$'],
                      filters=[('partition_key', '=', 'p_2')])
    assert got[2] == want[2] and 0 < len(got[2]) < total


def test_stats_pruning_on_value_column(synthetic_dataset):
    total = len(_read('torch', synthetic_dataset.url, schema_fields=['^id$'])[2])
    want, got = _both(synthetic_dataset.url, filters=[('id', '<', 10)])
    assert got == want
    assert sorted(got[0]) == list(range(10)) and len(got[2]) < total


def test_stats_pruning_off_keeps_every_value_row_group(synthetic_dataset, monkeypatch):
    monkeypatch.setenv('PETASTORM_TPU_PUSHDOWN', '0')
    want, got = _both(synthetic_dataset.url, schema_fields=['^id$'],
                      filters=[('id', '<', 10)])
    assert got == want and sorted(got[0]) == list(range(10))
    assert len(got[2]) == len(_read('torch', synthetic_dataset.url,
                                    schema_fields=['^id$'])[2])


def test_batch_reader_filters(scalar_dataset):
    want, got = _both(scalar_dataset.url, row=False, filters=[('id', '>=', 90)])
    assert got == want and sorted(got[0]) == list(range(90, 100))


@pytest.mark.parametrize('filters', [[[('id', '<', 3)], [('id', '>=', 97)]],
                                     [('string2', '=', 'world_1')],
                                     [('float64', '>', 60.0)]],
                         ids=['or-clauses', 'string-column', 'float-column'])
def test_batch_reader_filter_columns(scalar_dataset, filters):
    want, got = _both(scalar_dataset.url, row=False, filters=filters)
    assert got == want and got[0]


def test_or_clauses(synthetic_dataset):
    want, got = _both(synthetic_dataset.url, filters=[[('id', '<', 3)], [('id', '>=', 97)]],
                      schema_fields=['^id$'])
    assert got == want and sorted(got[0]) == [0, 1, 2, 97, 98, 99]


def test_filters_combine_with_predicate(synthetic_dataset):
    out = {}
    for package in ('jax', 'torch'):
        pred = PREDICATES[package].in_lambda(['id'], lambda v: v['id'] % 2 == 0)
        out[package] = _read(package, synthetic_dataset.url, filters=[('id', '<', 50)],
                             predicate=pred, schema_fields=['^id$'])
    assert out['torch'] == out['jax']
    assert sorted(out['torch'][0]) == [i for i in range(50) if i % 2 == 0]


@pytest.mark.parametrize('kwargs', [dict(filters=[('id', '>', 10 ** 6)]),
                                    dict(filters=[[('id', '<', -1)], [('id', '>', 10 ** 6)]]),
                                    dict(cur_shard=0, shard_count=100)],
                         ids=['filters', 'or-filters', 'shards'])
def test_no_data_error_is_the_references(synthetic_dataset, kwargs):
    with pytest.raises(JaxNoData) as want:
        jax_make_reader(synthetic_dataset.url, **kwargs)
    with pytest.raises(TorchNoData) as got:
        torch_make_reader(synthetic_dataset.url, **kwargs)
    assert str(got.value) == str(want.value)


def test_partition_predicate_empty_blames_configuration(partitioned_url):
    """A partition-key predicate that keeps nothing is not blamed on
    filters."""
    errors = {}
    for package, error in (('jax', JaxNoData), ('torch', TorchNoData)):
        pred = PREDICATES[package].in_set({'p_9'}, 'partition_key')
        with pytest.raises(error) as caught:
            READERS[package][0](partitioned_url, predicate=pred)
        errors[package] = str(caught.value)
    assert errors['torch'] == errors['jax']
    assert 'check shard/predicate/selector configuration' in errors['torch']


def test_partition_key_predicate_prunes_before_the_workers(partitioned_url):
    out = {}
    for package in ('jax', 'torch'):
        pred = PREDICATES[package].in_set({'p_1', 'p_3'}, 'partition_key')
        out[package] = _read(package, partitioned_url, predicate=pred,
                             schema_fields=['^id$', '^partition_key$'])
    assert out['torch'] == out['jax'] and out['torch'][1] == {'p_1', 'p_3'}


def test_incomparable_partition_filter_is_conservative(partitioned_url):
    """A string partition against an int bound keeps every row-group at
    construction; the workers' row-level comparison then raises."""
    for make in (jax_make_reader, torch_make_reader):
        with pytest.raises(TypeError):
            with make(partitioned_url, filters=[('partition_key', '<', 5)],
                      reader_pool_type='dummy') as reader:
                list(reader)


def test_in_filter(partitioned_url):
    want, got = _both(partitioned_url, filters=[('partition_key', 'in', ('p_0', 'p_4'))],
                      schema_fields=['^id$', '^partition_key$'])
    assert got == want and got[1] == {'p_0', 'p_4'}


def test_unknown_predicate_field_raises(synthetic_dataset):
    for make in (jax_make_batch_reader, torch_make_batch_reader):
        with pytest.raises(ValueError, match='Predicate references unknown fields'):
            with make(synthetic_dataset.url, reader_pool_type='dummy',
                      filters=[('no_such_field', '=', 1)]) as reader:
                list(reader)


def test_prune_row_group_indices_is_the_references(partitioned_url):
    from petastorm_tpu.etl.dataset_metadata import ParquetDatasetInfo as JaxInfo
    from petastorm_tpu.etl.dataset_metadata import load_row_groups as jax_load
    from petastorm_tpu_torch.etl.dataset_metadata import load_row_groups as torch_load
    clauses = [[('partition_key', 'in', ('p_1', 'p_2')), ('id', '<', 40)]]
    jax_info, torch_info = JaxInfo(partitioned_url), ParquetDatasetInfo(partitioned_url)
    jax_pieces, torch_pieces = jax_load(jax_info), torch_load(torch_info)
    assert [(p.path, p.row_group) for p in torch_pieces] == \
        [(p.path, p.row_group) for p in jax_pieces]
    want = jax_filters.prune_row_group_indices(jax_info, jax_pieces, range(len(jax_pieces)),
                                               clauses)
    got = torch_filters.prune_row_group_indices(torch_info, torch_pieces,
                                                range(len(torch_pieces)), clauses)
    assert got == want and 0 < len(got) < len(torch_pieces)


def test_partition_keys_are_the_references(partitioned_url, synthetic_dataset):
    from petastorm_tpu.etl.dataset_metadata import ParquetDatasetInfo as JaxInfo
    for url in (partitioned_url, synthetic_dataset.url):
        assert ParquetDatasetInfo(url).partition_keys == JaxInfo(url).partition_keys
    assert ParquetDatasetInfo(partitioned_url).partition_keys == ['partition_key']
