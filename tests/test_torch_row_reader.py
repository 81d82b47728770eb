"""petastorm_tpu_torch ``make_reader`` against the JAX package's.

Both packages read the shared synthetic ``TestSchema`` store row by row:
on the dummy pool the rows come in the same order with equal values and
types, field by field; on the thread pool they are the same multiset.
Schema views, ``transform_spec``, row-drop partitions, epochs and shards
are covered, every reference kwarg that reaches unported code raises its
``ROADMAP.md`` item, and a row reader's ``state_dict`` saved by either
package resumes in the other with the same remaining rows.
"""

import json
import warnings
from decimal import Decimal

import numpy as np
import pytest

from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu.transform import TransformSpec as JaxTransformSpec
from petastorm_tpu_torch.reader import make_reader as torch_make_reader
from petastorm_tpu_torch.transform import TransformSpec as TorchTransformSpec
from tests.torch_telemetry_common import plane_guard  # noqa: F401 - autouse

READERS = {'jax': jax_make_reader, 'torch': torch_make_reader}


def _eq(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype == object or b.dtype == object:
            return (a.shape == b.shape
                    and all(_eq(x, y) for x, y in zip(a.ravel(), b.ravel())))
        return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    if a is None or b is None:
        return a is None and b is None
    return type(a) is type(b) and a == b


def _rows(package, url, **kw):
    """Every row as a dict, in delivery order."""
    with READERS[package](url, **kw) as reader:
        return [row._asdict() for row in reader]


def _assert_rows_equal(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert list(a) == list(b)
        for name in a:
            assert _eq(a[name], b[name]), (name, a[name], b[name])


def _by_id(rows):
    return sorted(rows, key=lambda r: int(r['id']))


@pytest.mark.parametrize('seed', [0, 3])
@pytest.mark.parametrize('drop_partitions', [1, 2])
def test_dummy_pool_rows_equal_in_order(synthetic_dataset, seed, drop_partitions):
    kw = dict(reader_pool_type='dummy', seed=seed, num_epochs=2,
              shuffle_row_drop_partitions=drop_partitions)
    want = _rows('jax', synthetic_dataset.url, **kw)
    got = _rows('torch', synthetic_dataset.url, **kw)
    assert len(got) == 200
    _assert_rows_equal(want, got)
    assert sorted(int(r['id']) for r in got) == sorted(list(range(100)) * 2)
    # every codec decoded: a PNG image, a Decimal, a string array
    assert got[0]['image_png'].shape == (16, 32, 3)
    assert isinstance(got[0]['decimal'], Decimal)


@pytest.mark.parametrize('fields', [
    ['^id$', 'matrix.*'],
    ['^id$', '^sensor_name$', '^decimal$', '^id_odd$'],
    ['id.*'],
], ids=['matrices', 'mixed', 'prefix'])
def test_thread_pool_row_multisets(synthetic_dataset, fields):
    kw = dict(reader_pool_type='thread', workers_count=3, schema_fields=fields)
    want = _by_id(_rows('jax', synthetic_dataset.url, **kw))
    got = _by_id(_rows('torch', synthetic_dataset.url, **kw))
    _assert_rows_equal(want, got)
    assert [int(r['id']) for r in got] == list(range(100))


@pytest.mark.parametrize('shard', [0, 1, 2])
def test_shards_split_the_rows_alike(synthetic_dataset, shard):
    kw = dict(reader_pool_type='thread', workers_count=2, cur_shard=shard,
              shard_count=3, schema_fields=['^id$', '^id2$'])
    want = _by_id(_rows('jax', synthetic_dataset.url, **kw))
    got = _by_id(_rows('torch', synthetic_dataset.url, **kw))
    _assert_rows_equal(want, got)
    assert got


def test_shards_cover_the_dataset_once(synthetic_dataset):
    ids = [int(r['id']) for shard in range(3)
           for r in _rows('torch', synthetic_dataset.url, reader_pool_type='dummy',
                          cur_shard=shard, shard_count=3, schema_fields=['^id$'])]
    assert sorted(ids) == list(range(100))


def test_transform_spec_rows(synthetic_dataset):
    def func(frame):
        frame['id_float'] = frame['id_float'] * 2
        return frame

    fields = ['^id$', '^id_float$', '^id2$']
    want = _rows('jax', synthetic_dataset.url, reader_pool_type='dummy', schema_fields=fields,
                 transform_spec=JaxTransformSpec(func, removed_fields=['id2']))
    got = _rows('torch', synthetic_dataset.url, reader_pool_type='dummy', schema_fields=fields,
                transform_spec=TorchTransformSpec(func, removed_fields=['id2']))
    _assert_rows_equal(want, got)
    assert list(got[0]) == ['id', 'id_float']


@pytest.mark.parametrize('saver,loader', [('jax', 'torch'), ('torch', 'jax'),
                                          ('torch', 'torch')])
@pytest.mark.parametrize('stop_after', [7, 31])
def test_state_dict_resumes_across_packages(synthetic_dataset, saver, loader, stop_after):
    kw = dict(reader_pool_type='dummy', seed=3, schema_fields=['^id$'])
    with READERS[saver](synthetic_dataset.url, **kw) as reader:
        seen = [int(next(reader).id) for _ in range(stop_after)]
        state = reader.state_dict()
    remaining = {}
    for package in ('jax', 'torch'):
        with READERS[package](synthetic_dataset.url, **kw) as reader:
            reader.load_state_dict(json.loads(json.dumps(state)))
            remaining[package] = [int(r.id) for r in reader]
    assert remaining['jax'] == remaining['torch']
    # at least once: a row-group in flight is read again, nothing is lost
    assert set(seen) | set(remaining[loader]) == set(range(100))
    assert len(seen) + len(remaining[loader]) - 100 < 10


def test_state_dict_equals_jax_key_for_key(synthetic_dataset):
    kw = dict(reader_pool_type='dummy', seed=5, shuffle_row_drop_partitions=2,
              schema_fields=['^id$'], num_epochs=2)
    states = {}
    for package in ('jax', 'torch'):
        with READERS[package](synthetic_dataset.url, **kw) as reader:
            states[package] = []
            for i, _ in enumerate(reader):
                if i in (0, 4, 5, 6, 60, 140):
                    states[package].append(reader.state_dict())
            states[package].append(reader.state_dict())
    assert states['torch'] == states['jax']
    # progress is recorded mid-epoch, and the first state has none
    assert states['torch'][0]['consumed_items'] == []
    assert any(s['consumed_items'] for s in states['torch'])


def test_reset_after_full_consumption(synthetic_dataset):
    passes = {}
    for package in ('jax', 'torch'):
        with READERS[package](synthetic_dataset.url, reader_pool_type='dummy',
                              schema_fields=['^id$']) as reader:
            passes[package] = [[int(r.id) for r in reader]]
            reader.reset()
            passes[package].append([int(r.id) for r in reader])
    assert passes['torch'] == passes['jax']
    assert all(sorted(ids) == list(range(100)) for ids in passes['torch'])


def test_row_reader_mode(synthetic_dataset):
    with torch_make_reader(synthetic_dataset.url, reader_pool_type='dummy') as reader:
        assert reader.batched_output is False and reader.ngram is None
        with pytest.raises(TypeError, match='batched reader'):
            reader.next_batch_info()
        assert reader.next().id is not None


@pytest.mark.parametrize('package', ['jax', 'torch'])
def test_plain_parquet_store_warns(scalar_dataset, package):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        rows = _rows(package, scalar_dataset.url, reader_pool_type='dummy',
                     schema_fields=['^id$'])
    assert any('missing petastorm metadata' in str(w.message) for w in caught)
    assert sorted(int(r['id']) for r in rows) == list(range(100))


# the reference's kwargs that reach unported code, and the ROADMAP item each
# raises; None: ported (the rows are the JAX reader's); 'memory': ported,
# and both readers read a memory:// copy of the dataset with it (options
# for the memory store; an explicit MemoryFileSystem instance);
# 'value-error': ported, and both readers refuse it on the default pool
UNPORTED_KWARGS = {
    'predicate': ('in_set', None),
    'filters': ([('id', '<', 5)], None),
    'cache_type': ('decoded', None),
    'cache_location': ('cache', None),
    'cache_size_limit': (1 << 20, None),
    'cache_row_size_estimate': (1024, None),
    'rowgroup_selector': ('id_index', None),
    'reader_pool_type': ('process', None),
    'poison_policy': ('skip', 'value-error'),
    'storage_options': ({'anon': True}, 'memory'),
    'filesystem': ('instance', 'memory'),
}


@pytest.mark.parametrize('name', sorted(UNPORTED_KWARGS) + ['service-pool'])
def test_unported_kwargs_raise_their_item(synthetic_dataset, name, tmp_path):
    import inspect
    if name == 'service-pool':
        name, (value, item) = 'reader_pool_type', ('service', None)
    else:
        value, item = UNPORTED_KWARGS[name]
    if item == 'value-error':
        # poison_policy is the service pools': both readers refuse it on the
        # default thread pool
        messages = []
        for make in (jax_make_reader, torch_make_reader):
            with pytest.raises(ValueError, match='poison_policy') as info:
                make(synthetic_dataset.url, **{name: value})
            messages.append(str(info.value))
        assert messages[0] == messages[1]
    elif item == 'memory':
        from fsspec.implementations.memory import MemoryFileSystem
        memory = MemoryFileSystem()
        root = '/row_reader_kwargs_%s' % name
        memory.put(synthetic_dataset.url[len('file://'):], root, recursive=True)
        try:
            ids = {}
            for package in ('jax', 'torch'):
                kw = {name: MemoryFileSystem(skip_instance_cache=True) if value == 'instance'
                      else value}
                with READERS[package]('memory://' + root.lstrip('/'),
                                      reader_pool_type='dummy', shuffle_row_groups=False,
                                      schema_fields=['^id$'], **kw) as reader:
                    if name == 'filesystem':
                        assert reader.dataset_info.fs is kw[name]
                    ids[package] = [int(r.id) for r in reader]
        finally:
            memory.rm(root, recursive=True)
        assert ids['torch'] == ids['jax']
        assert sorted(ids['torch']) == list(range(100))
    elif item is None:
        from petastorm_tpu import predicates as jax_predicates
        from petastorm_tpu import selectors as jax_selectors
        from petastorm_tpu_torch import predicates as torch_predicates
        from petastorm_tpu_torch import selectors as torch_selectors
        ids = {}
        for package, predicates, selectors in (
                ('jax', jax_predicates, jax_selectors),
                ('torch', torch_predicates, torch_selectors)):
            kw = {name: predicates.in_set({3, 31, 47}, 'id') if value == 'in_set' else value}
            if name == 'rowgroup_selector':
                # the synthetic dataset's id index, built by the JAX package
                kw[name] = selectors.SingleIndexSelector(value, ['3', '47'])
            if name == 'cache_location':
                kw[name] = str(tmp_path / value)   # ignored by the default null cache
            elif name == 'cache_type':
                kw['cache_location'] = str(tmp_path / package)
            # the process pool reads on one worker, in ventilation order
            kw = dict(dict(reader_pool_type='dummy', shuffle_row_groups=False, workers_count=1),
                      **kw)
            ids[package] = [int(r['id']) for r in _rows(package, synthetic_dataset.url, **kw)]
        assert ids['torch'] == ids['jax'] and ids['torch']
    else:
        with pytest.raises(NotImplementedError,
                           match=r'ROADMAP.md: Queue 1 item %d,' % item):
            torch_make_reader(synthetic_dataset.url, **{name: value})
    want = list(inspect.signature(jax_make_reader).parameters)
    got = list(inspect.signature(torch_make_reader).parameters)
    assert got.index(name) == want.index(name)


def test_signature_is_the_references():
    import inspect
    want = inspect.signature(jax_make_reader).parameters
    got = inspect.signature(torch_make_reader).parameters
    assert [(p.name, p.default) for p in got.values()] == \
        [(p.name, p.default) for p in want.values()]


def test_package_exports_make_reader(synthetic_dataset):
    import petastorm_tpu_torch
    with petastorm_tpu_torch.make_reader(synthetic_dataset.url, reader_pool_type='dummy',
                                         schema_fields=['^id$']) as reader:
        assert sorted(int(r.id) for r in reader) == list(range(100))
    with petastorm_tpu_torch.make_batch_reader(synthetic_dataset.url, reader_pool_type='dummy',
                                               schema_fields=['^id$']) as reader:
        assert reader.batched_output


@pytest.mark.parametrize('loader', ['jax', 'torch'])
def test_device_loaders_refuse_a_row_reader(synthetic_dataset, loader):
    """``make_jax_loader`` and ``make_torch_loader`` take batched readers
    only; a row reader from ``make_reader`` is refused, and stopped."""
    made = []

    def factory(url, **kw):
        made.append(READERS[loader](url, reader_pool_type='dummy', **kw))
        return made[-1]

    if loader == 'jax':
        from petastorm_tpu.jax import make_jax_loader
        build = lambda: make_jax_loader(synthetic_dataset.url, batch_size=4,  # noqa: E731
                                        fields=['^id$'], reader_factory=factory)
    else:
        from petastorm_tpu_torch.device.loader import make_torch_loader
        build = lambda: make_torch_loader(synthetic_dataset.url, batch_size=4,  # noqa: E731
                                          fields=['^id$'], reader_factory=factory,
                                          device='cpu')
    with pytest.raises(ValueError, match='batched reader'):
        build()
    assert len(made) == 1
    with pytest.raises(RuntimeError, match='stopped reader'):
        next(made[0])
