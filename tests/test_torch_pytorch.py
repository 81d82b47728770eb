"""petastorm_tpu_torch.pytorch against the JAX package's PyTorch bridge.

The cases of the JAX package's bridge tests run through both bridges with
``device='cpu'``: sanitizing, collation, the row ``DataLoader`` over
``make_reader`` and the ``BatchedDataLoader`` over ``make_batch_reader``
give batches equal value for value and dtype for dtype, in the same
order on the dummy pool (the shuffling buffers draw from the same
``RandomState`` seeds). ``device=None`` means the card and raises without
CUDA. The ``cuda`` test holds the card's batches against the host's; run
it on the machine with the card (which has no JAX) with
``python -m pytest --noconftest -m cuda tests/test_torch_pytorch.py``.
"""

from decimal import Decimal

import numpy as np
import pytest
import torch

try:
    from petastorm_tpu import pytorch as jax_bridge
    from petastorm_tpu.ngram import NGram as JaxNGram
    from petastorm_tpu.reader import make_batch_reader as jax_batch_reader
    from petastorm_tpu.reader import make_reader as jax_reader
except ImportError:  # the machine with the card: only the cuda test runs there
    jax_bridge = None
from petastorm_tpu_torch import pytorch as torch_bridge
from petastorm_tpu_torch.ngram import NGram as TorchNGram
from petastorm_tpu_torch.reader import make_batch_reader as torch_batch_reader
from petastorm_tpu_torch.reader import make_reader as torch_reader

if jax_bridge is not None:
    BRIDGES = {'jax': (jax_bridge, jax_reader, jax_batch_reader, {}),
               'torch': (torch_bridge, torch_reader, torch_batch_reader, {'device': 'cpu'})}


def _same(a, b):
    if torch.is_tensor(a) or torch.is_tensor(b):
        return (torch.is_tensor(a) and torch.is_tensor(b) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.asarray(a).dtype == np.asarray(b).dtype and np.array_equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) or (hasattr(a, '_fields') and hasattr(b, '_fields'))) \
            and len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


def _assert_batches_equal(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert _same(a, b), (a, b)


def _both(case):
    """``case(bridge, make_reader, make_batch_reader, loader_kw)`` through
    each package; returns ``{package: result}``."""
    return {package: case(*BRIDGES[package]) for package in ('jax', 'torch')}


# -- sanitizing and collation --------------------------------------------------

SANITIZE_ROWS = {
    'promotions': lambda: {'a': np.arange(3, dtype=np.uint16), 'b': np.arange(3, dtype=np.uint32),
                           'c': np.uint16(7), 'd': np.arange(3, dtype=np.float32),
                           'e': np.uint64(2 ** 40), 'f': np.arange(2, dtype=np.uint64)},
    'string': lambda: {'s': 'hello'},
    'string-array': lambda: {'s': np.array(['a', 'b'])},
    'string-scalar': lambda: {'s': np.str_('x')},
    'none': lambda: {'x': None},
}


@pytest.mark.parametrize('case', sorted(SANITIZE_ROWS))
def test_sanitize_equal(case):
    results = {}
    for package in ('jax', 'torch'):
        row = SANITIZE_ROWS[case]()
        try:
            BRIDGES[package][0]._sanitize_pytorch_types(row)
            results[package] = ('ok', row)
        except TypeError as e:
            results[package] = ('TypeError', str(e).split(' ')[:2])
    assert results['torch'][0] == results['jax'][0]
    if results['torch'][0] == 'ok':
        assert _same(results['jax'][1], results['torch'][1])
        assert results['torch'][1]['a'].dtype == np.int32
        assert results['torch'][1]['b'].dtype == np.int64
    else:
        assert results['torch'][1] == results['jax'][1]
        assert case != 'promotions'


COLLATE_BATCHES = {
    'decimals': lambda: [Decimal('1.5'), Decimal('2.5')],
    'empty-dict': lambda: [dict()],
    'decimal-in-tuple': lambda: [(Decimal('1'), np.float32(1.0)), (Decimal('2'), np.float32(2.0))],
    'dict-with-decimal': lambda: [{'d': Decimal('1'), 'x': np.float32(1.0)},
                                  {'d': Decimal('2'), 'x': np.float32(2.0)}],
    'nested-list': lambda: [[np.int64(1), np.arange(3)], [np.int64(2), np.arange(3)]],
    'ragged': lambda: [{'r': np.arange(3)}, {'r': np.arange(4)}],
    **{'dtype-%s' % np.dtype(t).name: (lambda t=t: [{'x': np.arange(4, dtype=t)}] * 2)
       for t in (np.float32, np.float64, np.int16, np.int32, np.int64, np.uint8)},
}


@pytest.mark.parametrize('case', sorted(COLLATE_BATCHES))
def test_collate_equal(case):
    results = {}
    for package in ('jax', 'torch'):
        try:
            results[package] = ('ok', BRIDGES[package][0].decimal_friendly_collate(
                COLLATE_BATCHES[case]()))
        except TypeError as e:
            results[package] = ('TypeError', str(e))
    assert results['torch'][0] == results['jax'][0]
    if case == 'ragged':
        assert results['torch'][0] == 'TypeError' and "'r'" in results['torch'][1]
        assert 'variable shape' in results['torch'][1]
    else:
        assert _same(results['jax'][1], results['torch'][1]), results


# -- the row DataLoader --------------------------------------------------------

_FIELDS = ['^id$', '^id2$', '^matrix_uint16$', '^decimal$']


@pytest.mark.parametrize('batch_size,capacity,seed', [
    (8, 0, None), (10, 50, 1), (32, 256, 0), (7, 16, 3),
])
def test_data_loader_batches_equal(synthetic_dataset, batch_size, capacity, seed):
    def case(bridge, make_reader, _, kw):
        reader = make_reader(synthetic_dataset.url, schema_fields=_FIELDS, reader_pool_type='dummy',
                             shuffle_row_groups=False, num_epochs=1)
        with bridge.DataLoader(reader, batch_size=batch_size, shuffling_queue_capacity=capacity,
                               seed=seed, **kw) as loader:
            return list(loader)

    got = _both(case)
    _assert_batches_equal(got['jax'], got['torch'])
    batches = got['torch']
    assert [len(b['id']) for b in batches[:-1]] == [batch_size] * (len(batches) - 1)
    assert sorted(torch.cat([b['id'] for b in batches]).tolist()) == list(range(100))
    assert batches[0]['matrix_uint16'].dtype == torch.int32
    assert isinstance(batches[0]['decimal'][0], Decimal)
    if capacity:
        assert torch.cat([b['id'] for b in batches]).tolist() != sorted(
            torch.cat([b['id'] for b in batches]).tolist())


def test_data_loader_epochs_reshuffle_alike(synthetic_dataset):
    """Re-iteration resets the reader; the buffer's seed is offset by the
    epoch, so the two epochs differ, and alike in both packages."""
    def case(bridge, make_reader, _, kw):
        reader = make_reader(synthetic_dataset.url, schema_fields=['^id$'],
                             reader_pool_type='dummy', num_epochs=1)
        with bridge.DataLoader(reader, batch_size=25, shuffling_queue_capacity=40, seed=7,
                               **kw) as loader:
            return [torch.cat([b['id'] for b in loader]).tolist() for _ in range(2)]

    got = _both(case)
    assert got['torch'] == got['jax']
    assert got['torch'][0] != got['torch'][1]
    assert sorted(got['torch'][1]) == list(range(100))


def test_data_loader_rejects_nested_iteration_and_len(synthetic_dataset):
    reader = torch_reader(synthetic_dataset.url, schema_fields=['^id$'], num_epochs=1)
    with torch_bridge.DataLoader(reader, batch_size=10, device='cpu') as loader:
        it = iter(loader)
        next(it)
        with pytest.raises(RuntimeError, match='already being iterated'):
            next(iter(loader))
        with pytest.raises(TypeError, match='unknown'):
            len(loader)


def test_data_loader_rejects_strings(synthetic_dataset):
    def case(bridge, make_reader, _, kw):
        reader = make_reader(synthetic_dataset.url, schema_fields=['^id$', '^sensor_name$'],
                             num_epochs=1)
        with bridge.DataLoader(reader, batch_size=4, **kw) as loader:
            with pytest.raises(TypeError, match='no dense tensor representation') as e:
                list(loader)
            return str(e.value).split(' ')[:2]

    # the port words the remedy for its own loaders; the diagnosis is the same
    got = _both(case)
    assert got['torch'] == got['jax'] == ['Field', "'sensor_name'"]


def test_ngram_reader_fails_in_the_data_loader_alike(synthetic_dataset):
    """Neither bridge takes NGram windows: ``DataLoader`` calls
    ``row._asdict()``, which a window dict lacks."""
    errors = {}
    for package, ngram_cls in (('jax', JaxNGram), ('torch', TorchNGram)):
        bridge, make_reader, _, kw = BRIDGES[package]
        ngram = ngram_cls(fields={0: ['^id$'], 1: ['^id$']}, delta_threshold=1,
                          timestamp_field='^id$')
        reader = make_reader(synthetic_dataset.url, ngram=ngram, reader_pool_type='dummy')
        with bridge.DataLoader(reader, batch_size=4, **kw) as loader:
            with pytest.raises(AttributeError) as e:
                next(iter(loader))
            errors[package] = str(e.value)
    assert errors['torch'] == errors['jax']
    assert '_asdict' in errors['torch']


# -- the BatchedDataLoader -----------------------------------------------------

@pytest.mark.parametrize('batch_size,capacity,seed', [
    (16, 0, None), (10, 64, 5), (64, 128, 0),
])
def test_batched_loader_batches_equal(scalar_dataset, batch_size, capacity, seed):
    def case(bridge, _, make_batch_reader, kw):
        reader = make_batch_reader(scalar_dataset.url, schema_fields=['^id$', '^float64$'],
                                   reader_pool_type='dummy', shuffle_row_groups=False,
                                   num_epochs=1)
        with bridge.BatchedDataLoader(reader, batch_size=batch_size,
                                      shuffling_queue_capacity=capacity, seed=seed,
                                      **kw) as loader:
            return list(loader)

    got = _both(case)
    _assert_batches_equal(got['jax'], got['torch'])
    ids = torch.cat([b['id'] for b in got['torch']]).tolist()
    assert sorted(ids) == list(range(100))
    assert got['torch'][0]['float64'].dtype == torch.float64


def test_batched_loader_rejects_strings_and_object_columns(scalar_dataset, synthetic_dataset):
    def case(bridge, _, make_batch_reader, kw):
        messages = []
        for url, fields in ((scalar_dataset.url, ['^id$', '^string$']),
                            (synthetic_dataset.url, ['^id$', '^matrix_string$'])):
            reader = make_batch_reader(url, schema_fields=fields, num_epochs=1)
            with bridge.BatchedDataLoader(reader, batch_size=10, **kw) as loader:
                with pytest.raises(TypeError) as e:
                    list(loader)
                messages.append(str(e.value).split(' ')[:2])
        return messages

    got = _both(case)
    assert got['torch'] == got['jax']


def test_batched_loader_keep_fields_and_promotion(synthetic_dataset):
    def case(bridge, _, make_batch_reader, kw):
        reader = make_batch_reader(synthetic_dataset.url, reader_pool_type='dummy',
                                   shuffle_row_groups=False, num_epochs=1)
        with bridge.BatchedDataLoader(reader, batch_size=10,
                                      keep_fields=['id', 'matrix_uint16'], **kw) as loader:
            return list(loader)

    got = _both(case)
    _assert_batches_equal(got['jax'], got['torch'])
    assert set(got['torch'][0]) == {'id', 'matrix_uint16'}
    assert got['torch'][0]['matrix_uint16'].dtype == torch.int32


@pytest.mark.parametrize('capacity', [0, 128])
def test_inmemory_cache_replays_alike(scalar_dataset, capacity):
    def case(bridge, _, make_batch_reader, kw):
        reader = make_batch_reader(scalar_dataset.url, schema_fields=['^id$'],
                                   reader_pool_type='dummy', shuffle_row_groups=False,
                                   num_epochs=1)
        with bridge.BatchedDataLoader(reader, batch_size=20, shuffling_queue_capacity=capacity,
                                      seed=0, inmemory_cache_all=True, **kw) as loader:
            epochs = []
            for _ in range(3):
                batches = list(loader)
                # an in-place op on a yielded batch must not reach the cache
                batches[0]['id'] += 1000
                epochs.append([b['id'].clone() for b in batches])
            return epochs

    got = _both(case)
    for a, b in zip(got['jax'], got['torch']):
        _assert_batches_equal(a, b)
    flat = [torch.cat(e).tolist() for e in got['torch']]
    assert all(sorted(i % 1000 for i in ids) == list(range(100)) for ids in flat)
    assert max(max(ids) for ids in flat) < 1100
    if capacity:
        assert flat[0] != flat[1]


def test_inmemory_cache_needs_a_one_epoch_reader(scalar_dataset):
    for package in ('jax', 'torch'):
        bridge, _, make_batch_reader, kw = BRIDGES[package]
        for bad_epochs in (2, None):
            reader = make_batch_reader(scalar_dataset.url, schema_fields=['^id$'],
                                       num_epochs=bad_epochs)
            try:
                with pytest.raises(ValueError, match='num_epochs=1'):
                    bridge.BatchedDataLoader(reader, batch_size=10, inmemory_cache_all=True, **kw)
            finally:
                reader.stop()
                reader.join()


def test_abandoned_first_epoch_cannot_replay(scalar_dataset):
    reader = torch_batch_reader(scalar_dataset.url, schema_fields=['^id$'],
                                shuffle_row_groups=False, num_epochs=1)
    with torch_bridge.BatchedDataLoader(reader, batch_size=10, inmemory_cache_all=True,
                                        device='cpu') as loader:
        it = iter(loader)
        next(it)
        it.close()
        with pytest.raises(NotImplementedError, match='middle'):
            list(loader)


def test_transform_fn_equal(scalar_dataset):
    def to_half(columns):
        return {k: torch.as_tensor(v).to(torch.float16) for k, v in columns.items()}

    def case(bridge, _, make_batch_reader, kw):
        reader = make_batch_reader(scalar_dataset.url, schema_fields=['^float64$'],
                                   reader_pool_type='dummy', num_epochs=1)
        with bridge.BatchedDataLoader(reader, batch_size=10, transform_fn=to_half,
                                      **kw) as loader:
            return list(loader)

    got = _both(case)
    _assert_batches_equal(got['jax'], got['torch'])
    assert got['torch'][0]['float64'].dtype == torch.float16


# -- where the batches land ----------------------------------------------------

@pytest.mark.parametrize('loader', ['DataLoader', 'BatchedDataLoader'])
def test_default_device_is_the_card(synthetic_dataset, monkeypatch, loader):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    reader = torch_batch_reader(synthetic_dataset.url, num_epochs=1)
    try:
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            getattr(torch_bridge, loader)(reader, batch_size=4)
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            getattr(torch_bridge, loader)(reader, batch_size=4, device='cuda')
    finally:
        reader.stop()
        reader.join()


def test_to_device_keeps_the_structure():
    from collections import namedtuple
    pair = namedtuple('pair', 'a b')
    batch = {'x': torch.arange(3), 'd': [Decimal('1')], 'n': pair(torch.ones(2), 'tag'),
             'l': [torch.zeros(1), (torch.ones(1, dtype=torch.float64),)]}
    moved, nbytes = torch_bridge._to_device(batch, torch.device('cpu'))
    assert _same(moved, batch)
    assert moved['x'] is batch['x']  # already on the target: left alone
    assert nbytes == 0 and type(moved['n']) is pair and moved['d'] == [Decimal('1')]


@pytest.mark.cuda
def test_batches_land_on_the_card(tmp_path):
    """Both loaders put every tensor of a batch on the card, equal to the
    host batch; Decimal lists stay on the host."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the loaders copy batches to the card')
    import pyarrow as pa

    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_dataset
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema('Card', [
        UnischemaField('id', np.int64, (), ScalarCodec(pa.int64()), False),
        UnischemaField('m', np.uint16, (2, 3), NdarrayCodec(), False),
        UnischemaField('dec', Decimal, (), ScalarCodec(pa.string()), False),
    ])
    url = 'file://%s/card' % tmp_path
    write_dataset(url, schema, [{'id': i, 'm': np.full((2, 3), i, np.uint16),
                                 'dec': Decimal(i)} for i in range(40)],
                  rowgroup_size_rows=10)
    out = {}
    for device in ('cpu', 'cuda'):
        with torch_bridge.DataLoader(torch_reader(url, reader_pool_type='dummy'),
                                     batch_size=8, shuffling_queue_capacity=16, seed=0,
                                     device=device) as loader:
            rows = list(loader)
        with torch_bridge.BatchedDataLoader(
                torch_batch_reader(url, reader_pool_type='dummy', schema_fields=['^id$', '^m$']),
                batch_size=8, device=device) as loader:
            out[device] = (rows, list(loader))
    torch.cuda.synchronize()
    for host, card in zip(*(out[d][0] + out[d][1] for d in ('cpu', 'cuda'))):
        for name, value in host.items():
            if torch.is_tensor(value):
                assert card[name].is_cuda and torch.equal(card[name].cpu(), value), name
            else:
                assert card[name] == value, name
