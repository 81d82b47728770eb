"""Row-group indexes and selectors of the port against the JAX package's,
on the CPU.

The datasets are ``tests/test_selectors.py``'s: ``BlockySchema``, 30 rows
in 5-row groups over 2 files, a category constant within each group and
one whole group whose vector is null. Each package writes its own copy
and indexes it; the index JSON is byte-equal between the two, each
package reads the other's index, and every selector kind keeps the same
row-groups. ``make_reader``, ``make_batch_reader`` and
``make_torch_loader(device='cpu')`` read what the JAX reader and loader
read on the dummy pool, in order; with ``filters=``, with
``cur_shard``/``shard_count`` and across a mid-epoch resume too. The
errors (nothing selected, an unknown index, a dataset without an index)
are the reference's.
"""

import json

import numpy as np
import pyarrow as pa
import pytest

from petastorm_tpu import reader as jax_reader
from petastorm_tpu import selectors as jax_selectors
from petastorm_tpu.codecs import NdarrayCodec, ScalarCodec
from petastorm_tpu.errors import MetadataError as JaxMetadataError
from petastorm_tpu.errors import NoDataAvailableError as JaxNoDataAvailableError
from petastorm_tpu.etl import dataset_metadata as jax_meta
from petastorm_tpu.etl import rowgroup_indexers as jax_indexers
from petastorm_tpu.etl import rowgroup_indexing as jax_indexing
from petastorm_tpu.jax import make_jax_loader
from petastorm_tpu.jax import staging as jax_staging
from petastorm_tpu.unischema import Unischema, UnischemaField
from petastorm_tpu_torch import reader as torch_reader
from petastorm_tpu_torch import selectors as torch_selectors
from petastorm_tpu_torch.device.loader import make_torch_loader
from petastorm_tpu_torch.errors import MetadataError, NoDataAvailableError
from petastorm_tpu_torch.etl import dataset_metadata as torch_meta
from petastorm_tpu_torch.etl import rowgroup_indexers as torch_indexers
from petastorm_tpu_torch.etl import rowgroup_indexing as torch_indexing
from petastorm_tpu_torch.unischema import Unischema as TorchUnischema
from tests.torch_telemetry_common import plane_guard  # noqa: F401 - autouse

BlockySchema = Unischema('BlockySchema', [
    UnischemaField('id', np.int64, (), ScalarCodec(pa.int64()), False),
    UnischemaField('category', np.str_, (), ScalarCodec(pa.string()), False),
    UnischemaField('maybe_vec', np.float32, (2,), NdarrayCodec(), True),
])
N_ROWS, ROWGROUP = 30, 5

PACKAGES = {
    'jax': dict(meta=jax_meta, indexers=jax_indexers, indexing=jax_indexing,
                selectors=jax_selectors, reader=jax_reader, schema=BlockySchema),
    'torch': dict(meta=torch_meta, indexers=torch_indexers, indexing=torch_indexing,
                  selectors=torch_selectors, reader=torch_reader,
                  schema=TorchUnischema.from_json_dict(BlockySchema.to_json_dict())),
}


def _blocky_row(i):
    return {'id': i, 'category': 'cat_%d' % (i // ROWGROUP),
            'maybe_vec': None if 5 <= i < 10 else np.float32([i, i + 0.5])}


def _indexers(p):
    ix = p['indexers']
    return [ix.SingleFieldIndexer('category_index', 'category'),
            ix.SingleFieldIndexer('id_index', 'id'),
            ix.FieldNotNullIndexer('vec_not_null', 'maybe_vec')]


@pytest.fixture(scope='module')
def datasets(tmp_path_factory):
    """``{package: url}``: each package's written and indexed copy."""
    urls = {}
    for name, p in PACKAGES.items():
        url = 'file://' + str(tmp_path_factory.mktemp('blocky-' + name)) + '/ds'
        p['meta'].write_dataset(url, p['schema'], [_blocky_row(i) for i in range(N_ROWS)],
                                rowgroup_size_rows=ROWGROUP, num_files=2)
        p['indexing'].build_rowgroup_index(url, _indexers(p))
        urls[name] = url
    return urls


@pytest.fixture
def jax_staging_off(monkeypatch):
    monkeypatch.setenv('PETASTORM_TPU_STAGING', '0')
    jax_staging.refresh_staging()
    yield
    monkeypatch.undo()
    jax_staging.refresh_staging()


def _footer_index(package, url):
    info = PACKAGES[package]['meta'].ParquetDatasetInfo(url)
    return info.common_metadata.metadata[torch_indexing.ROWGROUPS_INDEX_KEY]


def _selector(package, kind):
    s = PACKAGES[package]['selectors']
    return {
        'single': lambda: s.SingleIndexSelector('category_index', ['cat_2']),
        'multi-value': lambda: s.SingleIndexSelector('category_index', ['cat_0', 'cat_5']),
        'union': lambda: s.UnionIndexSelector([
            s.SingleIndexSelector('category_index', ['cat_3']),
            s.SingleIndexSelector('id_index', ['7'])]),
        'intersect': lambda: s.IntersectIndexSelector([
            s.SingleIndexSelector('category_index', ['cat_1', 'cat_4']),
            s.SingleIndexSelector('id_index', ['21'])]),
        'not-null': lambda: s.SingleIndexSelector('vec_not_null', [None]),
        'id-values': lambda: s.SingleIndexSelector('id_index', [2, '18', 29]),
    }[kind]()


SELECTOR_IDS = {
    'single': list(range(10, 15)),
    'multi-value': list(range(0, 5)) + list(range(25, 30)),
    'union': list(range(5, 10)) + list(range(15, 20)),
    'intersect': list(range(20, 25)),
    'not-null': list(range(0, 5)) + list(range(10, 30)),
    'id-values': list(range(0, 5)) + list(range(15, 20)) + list(range(25, 30)),
}


def _read(package, url, selector, batched=True, **kw):
    """Every id read, in delivery order."""
    r = PACKAGES[package]['reader']
    make = r.make_batch_reader if batched else r.make_reader
    kw.setdefault('reader_pool_type', 'dummy')
    kw.setdefault('shuffle_row_groups', False)
    with make(url, rowgroup_selector=selector, **kw) as reader:
        if batched:
            return [int(v) for b in reader for v in b.id]
        return [int(row.id) for row in reader]


# -- the indexes -------------------------------------------------------------------


def test_index_json_is_byte_equal(datasets):
    assert _footer_index('torch', datasets['torch']) == _footer_index('jax', datasets['jax'])
    # each indexer's JSON form, built from the same rows by each package
    rows = [_blocky_row(i) for i in range(N_ROWS)]
    forms = {}
    for name, p in PACKAGES.items():
        built = _indexers(p)
        for g in range(N_ROWS // ROWGROUP):
            for ix in built:
                ix.build_index(rows[g * ROWGROUP:(g + 1) * ROWGROUP], g)
        forms[name] = [json.dumps(ix.to_json_dict()).encode() for ix in built]
    assert forms['torch'] == forms['jax'] and len(forms['torch']) == 3


@pytest.mark.parametrize('writer', ['jax', 'torch'])
def test_get_row_group_indexes_round_trip(datasets, writer):
    """Each package reads the index either wrote, to the same indexers."""
    url = datasets[writer]
    got = torch_indexing.get_row_group_indexes(torch_meta.ParquetDatasetInfo(url))
    want = jax_indexing.get_row_group_indexes(jax_meta.ParquetDatasetInfo(url))
    assert set(got) == set(want) == {'category_index', 'id_index', 'vec_not_null'}
    for name in got:
        assert type(got[name]).__name__ == type(want[name]).__name__
        assert got[name].to_json_dict() == want[name].to_json_dict()
        assert sorted(got[name].indexed_values) == sorted(want[name].indexed_values)
        assert sorted(got[name].column_names) == sorted(want[name].column_names)
        again = torch_indexers.indexer_from_json(got[name].to_json_dict())
        assert again.to_json_dict() == got[name].to_json_dict()
    assert got['vec_not_null'].get_row_group_indexes() == {0, 2, 3, 4, 5}
    assert got['category_index'].get_row_group_indexes('cat_5') == {5}
    assert got['id_index'].get_row_group_indexes(12) == {2}
    assert got['id_index'].get_row_group_indexes('nope') == set()


def test_indexer_merge_and_unknown_type():
    for ix in (torch_indexers, jax_indexers):
        a, b = ix.SingleFieldIndexer('m', 'f'), ix.SingleFieldIndexer('m', 'f')
        a.build_index([{'f': 'x'}], 0)
        b.build_index([{'f': 'x'}, {'f': 'y'}, {'f': None}], 1)
        merged = a + b
        assert merged.get_row_group_indexes('x') == {0, 1}
        assert merged.get_row_group_indexes('y') == {1}
        assert merged.to_json_dict()['index'] == {'x': [0, 1], 'y': [1]}
        with pytest.raises(ValueError, match='different fields'):
            a + ix.SingleFieldIndexer('m', 'other')
        with pytest.raises(ValueError, match='Unknown indexer type'):
            ix.indexer_from_json({'type': 'BloomIndexer'})


def test_base_classes_are_the_references():
    from petastorm_tpu.etl import RowGroupIndexerBase as JaxBase
    from petastorm_tpu_torch.etl import RowGroupIndexerBase
    assert RowGroupIndexerBase.__abstractmethods__ == JaxBase.__abstractmethods__
    assert issubclass(torch_indexers.SingleFieldIndexer, RowGroupIndexerBase)
    assert issubclass(torch_indexers.FieldNotNullIndexer, RowGroupIndexerBase)
    assert torch_selectors.RowGroupSelectorBase.__abstractmethods__ == \
        jax_selectors.RowGroupSelectorBase.__abstractmethods__
    for name in ('SingleIndexSelector', 'IntersectIndexSelector', 'UnionIndexSelector'):
        assert issubclass(getattr(torch_selectors, name), torch_selectors.RowGroupSelectorBase)
    with pytest.raises(TypeError):
        RowGroupIndexerBase()


def test_unindexed_field_rejected(datasets):
    for name, p in PACKAGES.items():
        with pytest.raises(ValueError, match='not in schema'):
            p['indexing'].build_rowgroup_index(
                datasets[name], [p['indexers'].SingleFieldIndexer('x', 'no_such_field')])


# -- the selectors on the readers ------------------------------------------------------


@pytest.mark.parametrize('writer', ['jax', 'torch'])
@pytest.mark.parametrize('kind', sorted(SELECTOR_IDS))
def test_every_selector_kind_reads_the_references_rows(datasets, writer, kind):
    url = datasets[writer]
    index = torch_indexing.get_row_group_indexes(torch_meta.ParquetDatasetInfo(url))
    want_groups = _selector('jax', kind).select_row_groups(
        jax_indexing.get_row_group_indexes(jax_meta.ParquetDatasetInfo(url)))
    assert _selector('torch', kind).select_row_groups(index) == want_groups
    for batched in (True, False):
        got = _read('torch', url, _selector('torch', kind), batched=batched)
        assert got == _read('jax', url, _selector('jax', kind), batched=batched)
        assert sorted(got) == SELECTOR_IDS[kind]


@pytest.mark.parametrize('pool', ['dummy', 'thread'])
def test_reader_and_batch_reader_over_pools(datasets, pool):
    url = datasets['torch']
    for batched in (True, False):
        got = _read('torch', url, _selector('torch', 'union'), batched=batched,
                    reader_pool_type=pool, shuffle_row_groups=True, seed=3)
        want = _read('jax', url, _selector('jax', 'union'), batched=batched,
                     reader_pool_type=pool, shuffle_row_groups=True, seed=3)
        if pool == 'dummy':
            assert got == want
        assert sorted(got) == sorted(want) == SELECTOR_IDS['union']


def test_reader_class_takes_the_selector(datasets):
    url = datasets['torch']
    info = torch_meta.ParquetDatasetInfo(url)
    # the ninth positional argument, as in the reference
    with torch_reader.Reader(info, None, 'dummy', None, 50, False, 1, None,
                             _selector('torch', 'single')) as reader:
        got = [int(v) for b in reader for v in b.id]
    assert got == SELECTOR_IDS['single']
    assert reader._piece_indices == [2]


@pytest.mark.parametrize('kind', ['not-null', 'union'])
@pytest.mark.parametrize('last_batch', ['drop', 'short'])
def test_torch_loader_matches_jax_loader(datasets, jax_staging_off, kind, last_batch):
    url = datasets['torch']
    kw = dict(batch_size=4, fields=['^id$'], last_batch=last_batch,
              shuffle_row_groups=True, seed=5, reader_pool_type='dummy')
    with make_jax_loader(url, rowgroup_selector=_selector('jax', kind), **kw) as loader:
        want = [{k: np.asarray(v) for k, v in b.items()} for b in loader]
    with make_torch_loader(url, rowgroup_selector=_selector('torch', kind), device='cpu',
                           **kw) as loader:
        got = [{k: np.asarray(v) for k, v in b.items()} for b in loader]
    assert len(got) == len(want) > 0
    for a, b in zip(want, got):
        assert sorted(a) == sorted(b) == ['id']
        np.testing.assert_array_equal(b['id'], a['id'].astype(b['id'].dtype))
    ids = sorted(int(i) for b in got for i in b['id'])
    if last_batch == 'short':
        assert ids == SELECTOR_IDS[kind]


def test_selector_with_filters(datasets):
    url = datasets['torch']
    kw = dict(filters=[('id', '>=', 12)])
    got = _read('torch', url, _selector('torch', 'not-null'), **kw)
    want = _read('jax', url, _selector('jax', 'not-null'), **kw)
    assert got == want == list(range(12, 30))
    # filters prune first: a selection the filters already emptied
    for package, error in (('torch', NoDataAvailableError), ('jax', JaxNoDataAvailableError)):
        with pytest.raises(error, match='matched no row-groups'):
            _read(package, url, _selector(package, 'single'), filters=[('id', '>', 100)])


@pytest.mark.parametrize('shard_count', [2, 3])
def test_selector_then_shards(datasets, shard_count):
    """The selection comes before sharding: shards split the selected
    row-groups, as in the reference."""
    url = datasets['torch']
    seen = []
    for shard in range(shard_count):
        kw = dict(cur_shard=shard, shard_count=shard_count)
        got = _read('torch', url, _selector('torch', 'not-null'), **kw)
        assert got == _read('jax', url, _selector('jax', 'not-null'), **kw)
        seen.extend(got)
    assert sorted(seen) == SELECTOR_IDS['not-null']
    with pytest.raises(NoDataAvailableError, match='requested shards'):
        _read('torch', url, _selector('torch', 'single'), cur_shard=0, shard_count=2)


@pytest.mark.parametrize('package', ['jax', 'torch'])
def test_mid_epoch_resume_under_a_selector(datasets, package):
    """Two row-groups read, a state saved, a fresh reader restored: the
    rest is read, and the port's states and rows are the JAX reader's
    (a state saved by either restores in the port)."""
    url = datasets['torch']
    kw = dict(reader_pool_type='dummy', shuffle_row_groups=True, seed=2, num_epochs=2)
    states, first = {}, {}
    for name in ('jax', 'torch'):
        r = PACKAGES[name]['reader']
        with r.make_batch_reader(url, rowgroup_selector=_selector(name, 'not-null'),
                                 **kw) as reader:
            first[name] = [int(v) for _ in range(2) for v in next(reader).id]
            states[name] = reader.state_dict()
    assert first['torch'] == first['jax']
    assert states['torch'] == states['jax']
    with torch_reader.make_batch_reader(url, rowgroup_selector=_selector('torch', 'not-null'),
                                        **kw) as reader:
        reader.load_state_dict(states[package])
        rest = [int(v) for b in reader for v in b.id]
    with jax_reader.make_batch_reader(url, rowgroup_selector=_selector('jax', 'not-null'),
                                      **kw) as reader:
        reader.load_state_dict(states['jax'])
        want_rest = [int(v) for b in reader for v in b.id]
    assert rest == want_rest
    assert sorted(first['torch'] + rest) == sorted(SELECTOR_IDS['not-null'] * 2)


# -- the errors ------------------------------------------------------------------------


def test_empty_selection_raises_the_references_error(datasets):
    url = datasets['torch']
    messages = []
    for package, error in (('torch', NoDataAvailableError), ('jax', JaxNoDataAvailableError)):
        s = PACKAGES[package]['selectors']
        sel = s.IntersectIndexSelector([s.SingleIndexSelector('category_index', ['cat_0']),
                                        s.SingleIndexSelector('category_index', ['cat_1'])])
        with pytest.raises(error) as caught:
            _read(package, url, sel)
        messages.append(str(caught.value))
    assert messages[0] == messages[1]
    assert messages[0].endswith('check shard/predicate/selector configuration')


def test_missing_index_name_raises_value_error(datasets):
    for package in ('torch', 'jax'):
        sel = PACKAGES[package]['selectors'].SingleIndexSelector('nope', ['x'])
        with pytest.raises(ValueError, match="no row-group index named \\['nope'\\]"):
            _read(package, datasets['torch'], sel)


def test_dataset_without_index_raises_metadata_error(tmp_path):
    for package, error in (('torch', MetadataError), ('jax', JaxMetadataError)):
        p = PACKAGES[package]
        url = 'file://' + str(tmp_path / package)
        p['meta'].write_dataset(url, p['schema'], [_blocky_row(i) for i in range(10)],
                                rowgroup_size_rows=5)
        with pytest.raises(error, match='carries no row-group index'):
            _read(package, url, _selector(package, 'single'))
        with pytest.raises(error, match='carries no row-group index'):
            p['indexing'].get_row_group_indexes(p['meta'].ParquetDatasetInfo(url))


# -- the synthetic dataset, indexed by the JAX package ---------------------------------


def test_synthetic_dataset_selectors(synthetic_dataset):
    url = synthetic_dataset.url
    for values in (['2', '18'], ['p_3']):
        index = 'partition_index' if values[0].startswith('p_') else 'id_index'
        got = sorted(_read('torch', url, torch_selectors.SingleIndexSelector(index, values),
                           batched=False, schema_fields=['^id$']))
        want = sorted(_read('jax', url, jax_selectors.SingleIndexSelector(index, values),
                            batched=False, schema_fields=['^id$']))
        assert got == want
        assert {2, 18} <= set(got) if index == 'id_index' else got == list(range(100))
