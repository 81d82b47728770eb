"""Late materialization in the port's worker and loader, against the JAX
package's.

Under a predicate the worker reads and evaluates the predicate's columns
first and decodes only the survivors' rows of the others; with deferred
decode an image column ships only the survivors' cells, and the loader's
staging fill decodes exactly those into its buffers. Held here on the
dummy pool: the batches equal the JAX loader's (exact, byte for byte, every
tail policy), the rows equal the port's full-scan oracle
(``PETASTORM_TPU_PUSHDOWN=0``), decoded images equal survivors, the
``late_materialize`` counters equal the JAX package's, and loader states
with pruning equal the JAX loader's.
"""

import json

import numpy as np
import pytest
import torch

from petastorm_tpu import telemetry as jax_telemetry
from petastorm_tpu.filters import FiltersPredicate as JaxFilters
from petastorm_tpu.jax import make_jax_loader
from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader
from petastorm_tpu_torch import pushdown
from petastorm_tpu_torch.codecs import CompressedImageCodec
from petastorm_tpu_torch.device.loader import make_torch_loader
from petastorm_tpu_torch.filters import FiltersPredicate as TorchFilters
from petastorm_tpu_torch.fused import EncodedImageColumn
from petastorm_tpu_torch.native import PackedCells
from petastorm_tpu_torch.reader import make_batch_reader as torch_make_batch_reader
from petastorm_tpu_torch.telemetry import FUSED_ROWS, get_registry, reset_registry
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

SHAPE = (24, 16, 3)
LABELS = 8
ROWS = 96


def _reset():
    jax_telemetry.reset_for_tests()
    reset_registry()
    pushdown.reset_for_tests()


@pytest.fixture(autouse=True)
def _fresh_state():
    _reset()
    yield
    _reset()


def _counters():
    return get_registry().snapshot()['counters']


@pytest.fixture(scope='module')
def label_ordered_url(tmp_path_factory):
    """PNG images with ``id`` and ``label``, rows in label order in
    16-row groups, so each row-group covers one or two labels."""
    from petastorm_tpu_torch.etl.dataset_metadata import write_dataset
    schema = Unischema('Selective', [
        UnischemaField('id', np.int64, (), None, False),
        UnischemaField('label', np.int32, (), None, False),
        UnischemaField('image', np.uint8, SHAPE, CompressedImageCodec('png'), False),
    ])
    rng = np.random.RandomState(2)
    labels = np.sort(rng.randint(0, LABELS, ROWS)).astype(np.int32)
    rows = [{'id': np.int64(i), 'label': labels[i],
             'image': rng.randint(0, 255, SHAPE, dtype=np.uint8)} for i in range(ROWS)]
    url = 'file://' + str(tmp_path_factory.mktemp('selective')) + '/ds'
    write_dataset(url, schema, rows, rowgroup_size_rows=16, num_files=2)
    return url, rows


def test_packed_cells_take():
    cells = PackedCells.from_cells([b'ab', b'', b'cde', b'f'])
    taken = cells.take([2, 0, 3])
    assert [bytes(c) for c in taken] == [b'cde', b'ab', b'f']
    assert taken.nbytes == 6 and len(cells.take([])) == 0
    assert [bytes(c) for c in cells[1:3].take([1])] == [b'cde']


def test_predicate_columns_not_decoded_twice(synthetic_dataset):
    """With ``id`` both the predicate and the only output column, nothing
    is left to read late: no late stage, no late rows, in either package."""
    out = {}
    for package, make, filters in (('jax', jax_make_batch_reader, JaxFilters),
                                   ('torch', torch_make_batch_reader, TorchFilters)):
        _reset()
        with make(synthetic_dataset.url, shuffle_row_groups=False, reader_pool_type='dummy',
                  predicate=filters([('id', '<', 12)]), schema_fields=['^id$']) as reader:
            out[package] = [int(i) for b in reader for i in b.id]
    assert out['torch'] == out['jax'] == list(range(12))
    counters = _counters()
    assert counters.get(pushdown.LATE_MATERIALIZED_ROWS, 0) == 0
    assert counters.get('petastorm_tpu_stage_calls_total{stage="late_materialize"}', 0) == 0
    assert counters['petastorm_tpu_stage_calls_total{stage="filter"}'] > 0


def _encoded_batches(make, url, predicate):
    with make(url, defer_image_decode=True, shuffle_row_groups=False,
              reader_pool_type='dummy', predicate=predicate) as reader:
        batches = []
        while True:
            try:
                columns, _, _ = reader.next_batch_info()
            except StopIteration:
                return batches
            batches.append(columns)


def test_deferred_encoded_column_ships_survivors_only(synthetic_dataset):
    ids = (3, 7, 47)
    want = _encoded_batches(jax_make_batch_reader, synthetic_dataset.url,
                            JaxFilters([('id', 'in', ids)]))
    got = _encoded_batches(torch_make_batch_reader, synthetic_dataset.url,
                           TorchFilters([('id', 'in', ids)]))
    assert all(isinstance(c['image_png'], EncodedImageColumn) for c in got)
    assert [len(c['image_png']) for c in got] == [len(c['image_png']) for c in want] == [2, 1]
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a['id'], b['id'])
        np.testing.assert_array_equal(a['image_png'].materialize(),
                                      b['image_png'].materialize())
    rows = {int(r['id']): r['image_png'] for r in synthetic_dataset.data}
    for columns in got:
        pixels = columns['image_png'].materialize()
        for k, rid in enumerate(int(i) for i in columns['id']):
            np.testing.assert_array_equal(pixels[k], rows[rid])
    assert _counters()[pushdown.LATE_MATERIALIZED_ROWS] == 3


def _jax(url, **kw):
    with make_jax_loader(url, reader_pool_type='dummy', shuffle_row_groups=False,
                         **kw) as loader:
        return [{k: np.asarray(v).copy() for k, v in b.items()} for b in loader]


def _torch(url, **kw):
    with make_torch_loader(url, reader_pool_type='dummy', shuffle_row_groups=False,
                           device='cpu', **kw) as loader:
        batches = [{k: v.numpy().copy() for k, v in b.items()} for b in loader]
        return batches, loader.diagnostics


def _assert_same(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert sorted(a) == sorted(b)
        for name in a:
            np.testing.assert_array_equal(a[name], b[name].astype(a[name].dtype), err_msg=name)


LOADER_CASES = {
    'filters-drop': (dict(filters=[('label', 'in', (1, 2))]), 'drop'),
    'filters-pad': (dict(filters=[('label', 'in', (1, 2))]), 'pad'),
    'filters-short': (dict(filters=[('label', 'in', (1, 2))]), 'short'),
    'range-short': (dict(filters=[('label', '>=', 6)]), 'short'),
    'or-pad': (dict(filters=[[('label', '=', 0)], [('id', '>', 90)]]), 'pad'),
}


@pytest.mark.parametrize('case', sorted(LOADER_CASES))
def test_selective_loader_batches_are_the_jax_loaders(label_ordered_url, case):
    url, rows = label_ordered_url
    kw, last_batch = LOADER_CASES[case]
    got, diag = _torch(url, batch_size=12, last_batch=last_batch, **kw)
    late = _counters().get(pushdown.LATE_MATERIALIZED_ROWS, 0)
    fused_rows = _counters().get(FUSED_ROWS, 0)
    want = _jax(url, batch_size=12, last_batch=last_batch, **kw)
    _assert_same(want, got)
    assert diag['fused_decode_mode'] == 'fused-into-slab'
    survivors = [r for r in rows
                 if JaxFilters(kw['filters']).do_include({'id': r['id'], 'label': r['label']})]
    valid = [b['id'][b['valid_mask']] if 'valid_mask' in b else b['id'] for b in got]
    delivered = sorted(int(i) for ids in valid for i in ids)
    # the workers decoded the survivors' images late, and the staging fill
    # decoded every delivered one straight into its buffer
    assert late == len(survivors)
    assert fused_rows == sum(len(b['id']) if 'valid_mask' not in b else
                             int(b['valid_mask'].sum()) for b in got)
    if last_batch != 'drop':
        assert delivered == sorted(int(r['id']) for r in survivors)
    images = {int(r['id']): r['image'] for r in rows}
    for b in got:
        for i, rid in enumerate(b['id']):
            if 'valid_mask' not in b or b['valid_mask'][i]:
                np.testing.assert_array_equal(b['image'][i], images[int(rid)])


def test_selective_loader_matches_its_oracle(label_ordered_url, monkeypatch):
    url, _ = label_ordered_url
    kw = dict(batch_size=12, last_batch='short', filters=[('label', 'in', (3, 4, 5))])
    got, _ = _torch(url, **kw)
    pruned = _counters().get(pushdown.ROWGROUPS_PRUNED, 0)
    monkeypatch.setenv('PETASTORM_TPU_PUSHDOWN', '0')
    oracle, _ = _torch(url, **kw)
    _assert_same(oracle, got)
    assert pruned > 0


def test_selective_loader_with_predicate_prunes_and_matches(label_ordered_url):
    from petastorm_tpu.predicates import in_set as jax_in_set
    from petastorm_tpu_torch.predicates import in_set as torch_in_set
    url, _ = label_ordered_url
    got, _ = _torch(url, batch_size=12, last_batch='short',
                    predicate=torch_in_set({1, 2}, 'label'))
    summary = pushdown.planner_summary()
    want = _jax(url, batch_size=12, last_batch='short', predicate=jax_in_set({1, 2}, 'label'))
    _assert_same(want, got)
    filtered, _ = _torch(url, batch_size=12, last_batch='short',
                         filters=[('label', 'in', (1, 2))])
    _assert_same(filtered, got)
    assert summary['planner_runs'] == 1 and summary['rowgroups_pruned'] > 0


@pytest.mark.parametrize('steps', [1, 3])
def test_selective_loader_state_is_the_jax_loaders(label_ordered_url, steps):
    url, rows = label_ordered_url
    kw = dict(batch_size=8, reader_pool_type='dummy', shuffle_row_groups=False,
              fields=['^id$', '^label$'], filters=[('label', 'in', (2, 3, 6))])
    with make_jax_loader(url, **kw) as loader:
        it = iter(loader)
        for _ in range(steps):
            next(it)
        want = loader.state_dict()
    seen = []
    with make_torch_loader(url, device='cpu', **kw) as loader:
        it = iter(loader)
        for _ in range(steps):
            seen.extend(int(i) for i in next(it)['id'])
        got = loader.state_dict()
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    # it resumes to the rest of the selective epoch: every survivor is
    # delivered (row-groups in flight at the save are read again)
    with make_torch_loader(url, device='cpu', last_batch='short',
                           **dict(kw, batch_size=100)) as loader:
        loader.load_state_dict(got)
        rest = [int(i) for b in loader for i in b['id']]
    survivors = {int(r['id']) for r in rows if r['label'] in (2, 3, 6)}
    assert rest and set(seen) | set(rest) == survivors
    assert len(rest) == len(set(rest))


def test_pruned_predicate_state_is_the_jax_readers(label_ordered_url):
    """Statistics pruning after sharding keeps the item list: states equal
    the JAX reader's, and an unpruned reader's item identities."""
    from petastorm_tpu.predicates import in_set as jax_in_set
    from petastorm_tpu_torch.predicates import in_set as torch_in_set
    url, _ = label_ordered_url
    states = {}
    for package, make, pred in (('jax', jax_make_batch_reader, jax_in_set({5}, 'label')),
                                ('torch', torch_make_batch_reader, torch_in_set({5}, 'label'))):
        with make(url, reader_pool_type='dummy', shuffle_row_groups=False, predicate=pred,
                  cur_shard=1, shard_count=2) as reader:
            assert reader._pruned_items
            next(reader)
            states[package] = reader.state_dict()
    with torch_make_batch_reader(url, reader_pool_type='dummy', cur_shard=1,
                                 shard_count=2) as reader:
        unpruned = reader.state_dict()
    assert states['torch'] == states['jax']
    assert states['torch']['items_global'] == unpruned['items_global']


def test_selective_loader_yields_host_tensors_on_the_cpu(label_ordered_url):
    url, _ = label_ordered_url
    with make_torch_loader(url, 12, filters=[('label', '=', 1)], reader_pool_type='dummy',
                           last_batch='short', device='cpu') as loader:
        batch = next(iter(loader))
    assert all(isinstance(t, torch.Tensor) and t.device.type == 'cpu' for t in batch.values())
