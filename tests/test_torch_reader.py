"""petastorm_tpu_torch reader and writer against the JAX package's.

Each package reads the dataset the other wrote (the shared synthetic
``TestSchema`` store, a plain Parquet store and MNIST), with the same row
multiset, column values and dtypes; the same seed gives the same order on
the dummy pool and the same per-shard split on the thread pool; a
``Reader.state_dict`` saved by one package resumes in the other.
"""

import json
import os

import fsspec
import numpy as np
import pyarrow.parquet as pq
import pytest

from petastorm_tpu.etl.dataset_metadata import UNISCHEMA_KEY
from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader
from petastorm_tpu.transform import TransformSpec as JaxTransformSpec
from petastorm_tpu_torch.errors import NoDataAvailableError
from petastorm_tpu_torch.etl.dataset_metadata import write_dataset as torch_write_dataset
from petastorm_tpu_torch.reader import make_batch_reader as torch_make_batch_reader
from petastorm_tpu_torch.transform import TransformSpec as TorchTransformSpec
from petastorm_tpu_torch.unischema import Unischema as TorchUnischema

from tests.test_common import TestSchema, _row
from tests.torch_telemetry_common import plane_guard  # noqa: F401 - autouse

READERS = {'jax': jax_make_batch_reader, 'torch': torch_make_batch_reader}


def _eq(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype == object or b.dtype == object:
            return (a.shape == b.shape
                    and all(_eq(x, y) for x, y in zip(a.ravel(), b.ravel())))
        return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    return type(a) is type(b) and a == b


def _read(package, url, **kw):
    """All batches as lists of column dicts, in delivery order."""
    with READERS[package](url, **kw) as reader:
        return [dict(b._asdict()) for b in reader]


def _rows_by_key(batches, key):
    rows = {}
    for b in batches:
        for i, k in enumerate(b[key]):
            rows.setdefault(k.item() if hasattr(k, 'item') else k, []).append(
                {name: col[i] for name, col in b.items()})
    return rows


def _assert_same_rows(a_batches, b_batches, key='id'):
    a, b = _rows_by_key(a_batches, key), _rows_by_key(b_batches, key)
    assert sorted(a) == sorted(b)
    for k in a:
        assert len(a[k]) == len(b[k])
        for ra, rb in zip(a[k], b[k]):
            assert sorted(ra) == sorted(rb)
            for name in ra:
                assert _eq(ra[name], rb[name]), (k, name, ra[name], rb[name])
    dtypes = [{name: {str(col.dtype) for col in (bt[name] for bt in batches)}
               for name in batches[0]} for batches in (a_batches, b_batches)]
    assert dtypes[0] == dtypes[1]


@pytest.fixture(scope='module')
def torch_written_dataset(tmp_path_factory):
    """TestSchema rows 0..99 written by the port, as the JAX fixture writes
    them (4 files, 10-row row-groups)."""
    url = 'file://%s/dataset' % tmp_path_factory.mktemp('torch_written')
    schema = TorchUnischema.from_json_dict(TestSchema.to_json_dict())
    torch_write_dataset(url, schema, [_row(i) for i in range(100)],
                        rowgroup_size_rows=10, num_files=4)
    return url


@pytest.mark.parametrize('pool', ['dummy', 'thread'])
def test_port_reads_jax_written_dataset(synthetic_dataset, pool):
    want = _read('jax', synthetic_dataset.url, reader_pool_type=pool)
    got = _read('torch', synthetic_dataset.url, reader_pool_type=pool)
    _assert_same_rows(want, got)
    assert len(_rows_by_key(got, 'id')) == 100


@pytest.mark.parametrize('pool', ['dummy', 'thread'])
def test_jax_reads_port_written_dataset(synthetic_dataset, torch_written_dataset, pool):
    want = _read('jax', synthetic_dataset.url, reader_pool_type=pool)
    got = _read('jax', torch_written_dataset, reader_pool_type=pool)
    _assert_same_rows(want, got)


def test_written_columns_and_footer_schema_match(synthetic_dataset, torch_written_dataset):
    """The port writes the same parquet columns, row-group layout and
    schema JSON as the JAX writer for the same rows."""
    jax_root = synthetic_dataset.path
    torch_root = torch_written_dataset[len('file://'):]
    for i in range(4):
        name = 'part-%05d.parquet' % i
        a, b = pq.ParquetFile('%s/%s' % (jax_root, name)), pq.ParquetFile('%s/%s' % (torch_root, name))
        assert a.metadata.num_row_groups == b.metadata.num_row_groups
        assert a.read().equals(b.read())
    footers = [pq.read_metadata('%s/_common_metadata' % root).metadata[UNISCHEMA_KEY]
               for root in (jax_root, torch_root)]
    assert json.loads(footers[0]) == json.loads(footers[1])


@pytest.mark.parametrize('pool', ['dummy', 'thread'])
def test_plain_parquet_store_parity(scalar_dataset, pool):
    want = _read('jax', scalar_dataset.url, reader_pool_type=pool)
    got = _read('torch', scalar_dataset.url, reader_pool_type=pool)
    _assert_same_rows(want, got)


@pytest.mark.parametrize('seed', [0, 5])
@pytest.mark.parametrize('drop_partitions', [1, 2])
def test_dummy_pool_exact_order(synthetic_dataset, seed, drop_partitions):
    kw = dict(reader_pool_type='dummy', shuffle_row_groups=True, seed=seed,
              shuffle_row_drop_partitions=drop_partitions, num_epochs=2,
              schema_fields=['^id$', '^matrix$', '^image_png$'])
    want = _read('jax', synthetic_dataset.url, **kw)
    got = _read('torch', synthetic_dataset.url, **kw)
    # 4 files of 25 rows in 10-row row-groups: 12 row-groups an epoch
    assert len(want) == len(got) == 2 * 12 * drop_partitions
    for a, b in zip(want, got):
        assert sorted(a) == sorted(b)
        for name in a:
            assert _eq(a[name], b[name]), name


@pytest.mark.parametrize('shard', [0, 1, 2])
def test_thread_pool_per_shard_split(synthetic_dataset, shard):
    kw = dict(reader_pool_type='thread', workers_count=3, cur_shard=shard,
              shard_count=3, schema_fields=['^id$', '^id_float$'])
    want = _read('jax', synthetic_dataset.url, **kw)
    got = _read('torch', synthetic_dataset.url, **kw)
    _assert_same_rows(want, got)


def test_too_many_shards_raises(synthetic_dataset):
    with pytest.raises(NoDataAvailableError):
        torch_make_batch_reader(synthetic_dataset.url, cur_shard=0, shard_count=41)


def test_transform_spec_parity(synthetic_dataset):
    def func(frame):
        frame['id_float'] = frame['id_float'] * 2
        return frame

    fields = ['^id$', '^id_float$', '^id2$']
    want = _read('jax', synthetic_dataset.url, reader_pool_type='dummy', schema_fields=fields,
                 transform_spec=JaxTransformSpec(func, removed_fields=['id2']))
    got = _read('torch', synthetic_dataset.url, reader_pool_type='dummy', schema_fields=fields,
                transform_spec=TorchTransformSpec(func, removed_fields=['id2']))
    _assert_same_rows(want, got)
    assert sorted(got[0]) == ['id', 'id_float']


@pytest.mark.parametrize('saver,loader', [('jax', 'torch'), ('torch', 'jax')])
def test_state_dict_resumes_across_packages(synthetic_dataset, saver, loader):
    kw = dict(reader_pool_type='dummy', shuffle_row_groups=True, seed=3,
              schema_fields=['^id$'])
    with READERS[saver](synthetic_dataset.url, **kw) as reader:
        seen = [next(reader).id for _ in range(4)]
        state = reader.state_dict()
    remaining = {}
    for package in ('jax', 'torch'):
        with READERS[package](synthetic_dataset.url, **kw) as reader:
            reader.load_state_dict(json.loads(json.dumps(state)))
            remaining[package] = [b.id for b in reader]
    assert len(remaining[loader]) == len(remaining[saver])
    for a, b in zip(remaining['jax'], remaining['torch']):
        np.testing.assert_array_equal(a, b)
    seen_ids = np.concatenate(seen).tolist()
    rest_ids = np.concatenate(remaining[loader]).tolist()
    assert sorted(seen_ids + rest_ids) == list(range(100))


@pytest.mark.parametrize('kwargs', [
    dict(reader_pool_type='process'),
    dict(reader_pool_type='service'),
    dict(cache_type='decoded'),
    dict(filters=[('id', '<', 5)]),
    dict(rowgroup_selector=object()),
    dict(predicate='in_set'),
], ids=['process', 'service', 'decoded-cache', 'filters', 'rowgroup-selector', 'predicate'])
def test_unported_kwargs_raise(synthetic_dataset, kwargs, tmp_path):
    """Each kwarg still unported raises its ROADMAP item; ``filters``,
    ``predicate``, ``rowgroup_selector``, the decoded cache and the process
    pool are ported and read the JAX reader's batches (the process pool on
    one worker, where its order is the ventilation order)."""
    if kwargs.get('reader_pool_type') == 'process':
        out = {package: _read(package, synthetic_dataset.url, reader_pool_type='process',
                              workers_count=1, shuffle_row_groups=False,
                              schema_fields=['^id$'])
               for package in ('jax', 'torch')}
        assert [b['id'].tolist() for b in out['torch']] == \
            [b['id'].tolist() for b in out['jax']]
        assert sorted(i for b in out['torch'] for i in b['id'].tolist()) == list(range(100))
        return
    if set(kwargs) & {'filters', 'predicate', 'cache_type', 'rowgroup_selector'}:
        from petastorm_tpu import predicates as jax_predicates
        from petastorm_tpu import selectors as jax_selectors
        from petastorm_tpu_torch import predicates as torch_predicates
        from petastorm_tpu_torch import selectors as torch_selectors
        out = {}
        for package, predicates, selectors in (
                ('jax', jax_predicates, jax_selectors),
                ('torch', torch_predicates, torch_selectors)):
            kw = dict(kwargs)
            if 'predicate' in kw:
                kw['predicate'] = predicates.in_set({3, 31, 47}, 'id')
            if 'rowgroup_selector' in kw:
                # the synthetic dataset's id index, built by the JAX package
                kw['rowgroup_selector'] = selectors.SingleIndexSelector('id_index',
                                                                        ['3', '47'])
            if 'cache_type' in kw:
                kw['cache_location'] = str(tmp_path / package)
            out[package] = _read(package, synthetic_dataset.url, reader_pool_type='dummy',
                                 shuffle_row_groups=False, schema_fields=['^id$'], **kw)
        assert [b['id'].tolist() for b in out['torch']] == \
            [b['id'].tolist() for b in out['jax']]
        assert out['torch']
        return
    with pytest.raises(NotImplementedError, match='ROADMAP.md'):
        torch_make_batch_reader(synthetic_dataset.url, **kwargs)


# the reference's kwargs the port takes at the reference's positions, each
# raising its own ROADMAP item; None: ported, taken and kept on the reader;
# 'read': ported, and the reader reads the JAX reader's batches; 'memory':
# ported, and both readers read a memory:// copy of the dataset with it
# (options for the memory store; an explicit MemoryFileSystem instance)
REFERENCE_KWARGS = {
    'cache_location': ('cache', 'read'),
    'cache_size_limit': (1 << 20, 'read'),
    'cache_row_size_estimate': (1024, 'read'),
    'mixture_interleave': ({'share': 0.5}, None),
    'storage_options': ({'anon': True}, 'memory'),
    'filesystem': ('instance', 'memory'),
    'max_staleness_s': (1.0, 'no-manifest'),
}


@pytest.fixture
def memory_copy(synthetic_dataset, request):
    """The synthetic dataset's files copied byte for byte into fsspec's
    memory store, under a path of this test's own; removed after."""
    from fsspec.implementations.memory import MemoryFileSystem
    memory = MemoryFileSystem()
    root = '/reader_kwargs_%s' % request.node.name.replace('[', '_').strip(']')
    memory.put(synthetic_dataset.url[len('file://'):], root, recursive=True)
    yield 'memory://' + root.lstrip('/')
    memory.rm(root, recursive=True)


@pytest.mark.parametrize('name', sorted(REFERENCE_KWARGS))
def test_reference_kwargs_raise_their_item(synthetic_dataset, name, tmp_path, request):
    import inspect
    value, item = REFERENCE_KWARGS[name]
    if item == 'memory':
        from fsspec.implementations.memory import MemoryFileSystem
        url = request.getfixturevalue('memory_copy')
        out = {}
        for package in ('jax', 'torch'):
            kw = {name: MemoryFileSystem(skip_instance_cache=True) if value == 'instance'
                  else value}
            with READERS[package](url, reader_pool_type='dummy', shuffle_row_groups=False,
                                  schema_fields=['^id$'], **kw) as reader:
                if name == 'filesystem':
                    assert reader.dataset_info.fs is kw[name]
                out[package] = [b.id.tolist() for b in reader]
        assert out['torch'] == out['jax']
        assert sorted(i for b in out['torch'] for i in b) == list(range(100))
    elif item == 'read':
        # a cache kwarg without cache_type: the default null cache ignores it
        if name == 'cache_location':
            value = str(tmp_path / value)
        out = {package: _read(package, synthetic_dataset.url, reader_pool_type='dummy',
                              shuffle_row_groups=False, schema_fields=['^id$'], **{name: value})
               for package in ('jax', 'torch')}
        assert [b['id'].tolist() for b in out['torch']] == \
            [b['id'].tolist() for b in out['jax']]
        assert not os.path.exists(str(tmp_path / 'cache'))
    elif item is None:
        with torch_make_batch_reader(synthetic_dataset.url, reader_pool_type='dummy',
                                     **{name: value}) as reader:
            assert getattr(reader, name) == value
    elif item == 'no-manifest':
        # ported: a dataset without a committed manifest has nothing to
        # bound the staleness against, in both packages
        for make in (jax_make_batch_reader, torch_make_batch_reader):
            with pytest.raises(ValueError, match='committed manifest'):
                make(synthetic_dataset.url, **{name: value})
    else:
        with pytest.raises(NotImplementedError,
                           match=r'ROADMAP.md: Queue 1 item %d,' % item):
            torch_make_batch_reader(synthetic_dataset.url, **{name: value})
    want = list(inspect.signature(jax_make_batch_reader).parameters)
    got = list(inspect.signature(torch_make_batch_reader).parameters)
    assert got.index(name) == want.index(name)


def test_materialize_dataset_takes_row_group_size_mb(tmp_path):
    """``materialize_dataset(url, schema, 256)``: the third parameter is the
    reference's ``row_group_size_mb`` (a Spark conf there), accepted without
    Spark; the footer the port writes reads back in both packages."""
    import inspect

    from petastorm_tpu.etl.dataset_metadata import materialize_dataset as jax_materialize
    from petastorm_tpu_torch.etl.dataset_metadata import DatasetWriter, materialize_dataset
    schema = TorchUnischema.from_json_dict(TestSchema.to_json_dict())
    url = 'file://%s/ds' % tmp_path
    with materialize_dataset(url, schema, 256):
        with DatasetWriter(url, schema, rowgroup_size_rows=10) as writer:
            writer.write_row_dicts([_row(i) for i in range(30)])
    for package in ('jax', 'torch'):
        ids = sorted(i for b in _read(package, url, reader_pool_type='dummy',
                                      schema_fields=['^id$']) for i in b['id'].tolist())
        assert ids == list(range(30))
    assert (list(inspect.signature(materialize_dataset).parameters)
            == list(inspect.signature(jax_materialize).parameters))


@pytest.mark.parametrize('call,item', [
    ('materialize-spark', 11),
    ('writer-workers-count', None),
    ('writer-sort-by', None),
    ('writer-filesystem', None),
    ('transform-cacheable', None),
])
def test_write_and_transform_kwargs_raise_their_item(tmp_path, call, item):
    from petastorm_tpu_torch.etl.dataset_metadata import DatasetWriter, materialize_dataset
    schema = TorchUnischema.from_json_dict(TestSchema.to_json_dict())
    url = 'file://%s/ds' % tmp_path
    calls = {
        'materialize-spark': lambda: materialize_dataset(url, schema, 256,
                                                         spark=object()).__enter__(),
        'writer-workers-count': lambda: DatasetWriter(url, schema, workers_count=4),
        'writer-sort-by': lambda: DatasetWriter(url, schema, sort_by='id'),
        'writer-filesystem': lambda: DatasetWriter(url, schema,
                                                   filesystem=fsspec.filesystem('file')),
        'transform-cacheable': lambda: TorchTransformSpec(lambda f: f, cacheable=True),
    }
    if call == 'transform-cacheable':
        # ported: the decoded cache's opt-in, kept as the reference keeps it
        assert calls[call]().cacheable is True
        return
    if item is None:
        # ported: the writer takes the kwarg, writes and reads back
        with calls[call]() as writer:
            writer.write_row_dicts([_row(i) for i in range(12)])
        assert writer.sort_by == ('id' if call == 'writer-sort-by' else None)
        assert len(writer.paths_written) == 1
        return
    with pytest.raises(NotImplementedError, match=r'ROADMAP.md: Queue 1 item %d,' % item):
        calls[call]()
