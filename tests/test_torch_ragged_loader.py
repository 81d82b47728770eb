"""``pad_ragged=`` and ``bucket_boundaries=`` in make_torch_loader, held
batch for batch against make_jax_loader on the CPU.

Both loaders read the same seeded datasets on the dummy pool (a
deterministic order); the JAX loader runs its pre-arena copy path
(``PETASTORM_TPU_STAGING=0``), as in ``tests/test_torch_loader.py``. Values
must be equal, ``<field>_len`` columns included; dtypes are compared after
JAX's 32-bit canonicalization. The semantic checks (static shapes, true
lengths, zero padding, routing) mirror ``tests/test_jax_loader.py``.
"""

import json

import numpy as np
import pytest
import pyarrow as pa
import torch

import jax

from petastorm_tpu.jax import make_jax_loader
from petastorm_tpu.jax import staging as jax_staging
from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.device.loader import MASK_FIELD, TorchLoader, make_torch_loader
from petastorm_tpu_torch.etl.dataset_metadata import write_dataset
from petastorm_tpu_torch.unischema import Unischema, UnischemaField


@pytest.fixture
def jax_staging_off(monkeypatch):
    monkeypatch.setenv('PETASTORM_TPU_STAGING', '0')
    jax_staging.refresh_staging()
    yield
    monkeypatch.undo()
    jax_staging.refresh_staging()


def _write(url, fields, rows, rowgroup_size_rows=8):
    schema = Unischema('Ragged', [
        UnischemaField(name, dtype, shape, codec, False)
        for name, dtype, shape, codec in fields])
    write_dataset(url, schema, rows, rowgroup_size_rows=rowgroup_size_rows)
    return rows


_ID = ('id', np.int32, (), ScalarCodec(pa.int32()))
_TOKENS = ('tokens', np.int32, (None,), NdarrayCodec())


@pytest.fixture(scope='module')
def ragged(tmp_path_factory):
    """32 rows: ``tokens`` of 3..11 int32 and ``frames`` of (1..5, 4) uint8
    (the JAX loader tests' ``ragged_dataset``), 8-row row-groups."""
    url = 'file://' + str(tmp_path_factory.mktemp('ragged')) + '/ds'
    rng = np.random.RandomState(0)
    rows = [{'id': i,
             'tokens': rng.randint(0, 100, (3 + i % 9,), dtype=np.int32),
             'frames': rng.randint(0, 255, (1 + i % 5, 4), dtype=np.uint8)}
            for i in range(32)]
    _write(url, [_ID, _TOKENS, ('frames', np.uint8, (None, 4), NdarrayCodec())], rows)
    return url, {r['id']: r for r in rows}


def _jax_batches(url, **kw):
    with make_jax_loader(url, reader_pool_type='dummy', **kw) as loader:
        return [{k: np.asarray(v) for k, v in b.items()} for b in loader]


def _torch_batches(url, **kw):
    with make_torch_loader(url, reader_pool_type='dummy', device='cpu', **kw) as loader:
        return [{k: v.numpy() for k, v in b.items()} for b in loader]


def _assert_same_batches(jax_batches, torch_batches):
    assert len(jax_batches) == len(torch_batches)
    for a, b in zip(jax_batches, torch_batches):
        assert sorted(a) == sorted(b)
        for name in a:
            assert a[name].shape == b[name].shape, name
            assert a[name].dtype == jax.dtypes.canonicalize_dtype(b[name].dtype), name
            np.testing.assert_array_equal(a[name], b[name].astype(a[name].dtype),
                                          err_msg=name)


def _assert_rows_match(batches, by_id, name, bound_of=None):
    """Every row holds its source cell up to the padded extent, zeros
    after, and its true length in ``<name>_len``."""
    for batch in batches:
        width = batch[name].shape[1]
        if bound_of is not None:
            assert width in bound_of.values() or width == max(bound_of.values())
        for i, row_id in enumerate(batch['id'].tolist()):
            if MASK_FIELD in batch and not batch[MASK_FIELD][i]:
                continue
            want = by_id[row_id][name]
            assert int(batch[name + '_len'][i]) == len(want)
            keep = min(len(want), width)
            np.testing.assert_array_equal(batch[name][i][:keep], want[:keep])
            assert (batch[name][i][keep:] == 0).all()


RAGGED_CASES = {
    'pad-ragged': dict(batch_size=8, pad_ragged={'tokens': 16, 'frames': 6}),
    'pad-ragged-truncates': dict(batch_size=8, pad_ragged={'tokens': 5},
                                 fields=['^id$', '^tokens$']),
    'pad-ragged-last-batch-pad': dict(batch_size=10, pad_ragged={'tokens': 16},
                                      fields=['^id$', '^tokens$'], last_batch='pad'),
    'pad-ragged-short': dict(batch_size=10, pad_ragged={'tokens': 16, 'frames': 2},
                             last_batch='short'),
    'pad-ragged-shuffle-rows': dict(batch_size=6, pad_ragged={'tokens': 12},
                                    fields=['^id$', '^tokens$'], shuffle_rows=True,
                                    seed=3, last_batch='pad'),
    'buckets': dict(batch_size=4, fields=['^id$', '^tokens$'],
                    bucket_boundaries={'tokens': [6, 12]}, last_batch='short'),
    'buckets-shuffle-rows': dict(batch_size=4, fields=['^id$', '^tokens$'],
                                 bucket_boundaries={'tokens': [6, 12]}, shuffle_rows=True,
                                 seed=5, last_batch='short'),
    'buckets-truncate-into-last': dict(batch_size=4, fields=['^id$', '^tokens$'],
                                       bucket_boundaries={'tokens': [4, 8]},
                                       last_batch='short'),
    'buckets-with-pad-ragged': dict(batch_size=4, bucket_boundaries={'tokens': [6, 12]},
                                    pad_ragged={'frames': 6}, last_batch='short'),
    'buckets-pad': dict(batch_size=5, fields=['^id$', '^tokens$'],
                        bucket_boundaries={'tokens': [5, 8, 12]}, last_batch='pad'),
    'buckets-drop': dict(batch_size=5, fields=['^id$', '^tokens$'],
                         bucket_boundaries={'tokens': [5, 8, 12]}),
    'buckets-2-epochs-shuffled': dict(batch_size=4, fields=['^id$', '^tokens$'],
                                      bucket_boundaries={'tokens': [6, 12]},
                                      shuffle_rows=True, seed=1, num_epochs=2,
                                      shuffling_queue_capacity=8, min_after_retrieve=2,
                                      extra_capacity=8),
    'buckets-frames': dict(batch_size=3, fields=['^id$', '^frames$'],
                           bucket_boundaries={'frames': [2, 5]}, last_batch='short'),
}


@pytest.mark.parametrize('case', sorted(RAGGED_CASES))
def test_ragged_batches_match_jax_loader(ragged, jax_staging_off, case):
    url, by_id = ragged
    kw = dict(RAGGED_CASES[case], shuffle_row_groups=True)
    want = _jax_batches(url, **kw)
    got = _torch_batches(url, **kw)
    _assert_same_batches(want, got)
    assert got
    for name in ('tokens', 'frames'):
        if name in got[0]:
            _assert_rows_match(got, by_id, name)
    if 'bucket_boundaries' in kw:
        ((name, bounds),) = kw['bucket_boundaries'].items()
        seen = []
        for batch in got:
            width = batch[name].shape[1]
            assert width in bounds
            for i, row_id in enumerate(batch['id'].tolist()):
                if MASK_FIELD in batch and not batch[MASK_FIELD][i]:
                    continue
                n = len(by_id[row_id][name])
                # the smallest bound that fits, or the last one
                assert width == next((b for b in bounds if b >= n), bounds[-1])
                seen.append(row_id)
        if kw.get('last_batch') in ('short', 'pad'):
            assert sorted(seen) == sorted(by_id) * kw.get('num_epochs', 1)


def test_pad_ragged_static_shapes(ragged):
    url, _ = ragged
    batches = _torch_batches(url, batch_size=8, pad_ragged={'tokens': 16, 'frames': 6},
                             shuffle_row_groups=False)
    assert len(batches) == 4
    for b in batches:
        assert b['tokens'].shape == (8, 16) and b['frames'].shape == (8, 6, 4)
        assert b['tokens_len'].shape == (8,) and b['tokens_len'].dtype == np.int32


def test_pad_ragged_uniform_row_groups_pad_to_the_policy(tmp_path, jax_staging_off):
    # rows of one length arrive pre-stacked dense; they still pad to 12
    url = 'file://' + str(tmp_path / 'uniform')
    _write(url, [_ID, _TOKENS], [{'id': i, 'tokens': np.full((7,), i, np.int32)}
                                 for i in range(16)])
    kw = dict(batch_size=8, pad_ragged={'tokens': 12}, shuffle_row_groups=False)
    got = _torch_batches(url, **kw)
    _assert_same_batches(_jax_batches(url, **kw), got)
    assert got[0]['tokens'].shape == (8, 12)
    assert (got[0]['tokens_len'] == 7).all() and (got[0]['tokens'][:, 7:] == 0).all()


def test_pad_ragged_nullable_cells_are_zero_length(synthetic_dataset, jax_staging_off):
    kw = dict(batch_size=9, fields=['^id$', '^matrix_nullable$'],
              pad_ragged={'matrix_nullable': 4}, shuffle_row_groups=False)
    got = _torch_batches(synthetic_dataset.url, **kw)
    _assert_same_batches(_jax_batches(synthetic_dataset.url, **kw), got)
    null_ids = {d['id'] for d in synthetic_dataset.data if d['matrix_nullable'] is None}
    batch = got[0]
    assert batch['matrix_nullable'].shape == (9, 4, 14)
    for i, row_id in enumerate(batch['id'].tolist()):
        size = int(batch['matrix_nullable_len'][i])
        if row_id in null_ids:
            assert size == 0 and (batch['matrix_nullable'][i] == 0).all()
        else:
            assert size == 3


@pytest.mark.parametrize('bucketed', [False, True], ids=['pad-ragged', 'buckets'])
@pytest.mark.parametrize('shuffle_rows', [False, True], ids=['in-order', 'shuffled'])
def test_mixed_chunk_forms_across_row_groups(tmp_path, jax_staging_off, shuffle_rows,
                                             bucketed):
    # a uniform row-group gives a dense chunk, a ragged one an object chunk,
    # another uniform one a dense chunk of another width
    url = 'file://' + str(tmp_path / 'mixed')
    rows = ([{'id': i, 'tokens': np.full((5,), i, np.int32)} for i in range(8)]
            + [{'id': i, 'tokens': np.full((3 + i % 7,), i, np.int32)} for i in range(8, 16)]
            + [{'id': i, 'tokens': np.full((9,), i, np.int32)} for i in range(16, 24)])
    _write(url, [_ID, _TOKENS], rows)
    policy = ({'bucket_boundaries': {'tokens': [6, 12]}} if bucketed
              else {'pad_ragged': {'tokens': 12}})
    kw = dict(batch_size=6, shuffle_rows=shuffle_rows, seed=2, last_batch='short',
              shuffle_row_groups=False, **policy)
    got = _torch_batches(url, **kw)
    _assert_same_batches(_jax_batches(url, **kw), got)
    _assert_rows_match(got, {r['id']: r for r in rows}, 'tokens')
    assert sorted(i for b in got for i in b['id'].tolist()) == list(range(24))


def test_bucket_field_of_scalars_is_diagnosed(scalar_dataset):
    with make_torch_loader(scalar_dataset.url, batch_size=8, device='cpu',
                           reader_pool_type='dummy', fields=['^id$'],
                           bucket_boundaries={'id': [4, 8]},
                           shuffle_row_groups=False) as loader:
        with pytest.raises(ValueError, match='leading sequence dim'):
            list(loader)


@pytest.mark.parametrize('kwargs', [
    dict(pad_ragged={'no_such_field': 16}),
    dict(bucket_boundaries={'no_such_field': [4]}),
], ids=['pad-ragged', 'buckets'])
def test_unknown_field_is_named(ragged, kwargs):
    url, _ = ragged
    with make_torch_loader(url, batch_size=8, device='cpu', reader_pool_type='dummy',
                           **kwargs) as loader:
        with pytest.raises(ValueError, match='no_such_field'):
            list(loader)


class _BatchedReader:
    batched_output = True


@pytest.mark.parametrize('kwargs,match', [
    (dict(bucket_boundaries={'tokens': [8, 4]}), 'ascending'),
    (dict(bucket_boundaries={'tokens': [4, 4]}), 'ascending'),
    (dict(bucket_boundaries={'tokens': [0, 4]}), 'ascending'),
    (dict(bucket_boundaries={'a': [4], 'b': [8]}), 'exactly one'),
    (dict(bucket_boundaries={'a': [4]}, pad_ragged={'a': 4}), 'both pad_ragged'),
    (dict(pad_ragged={'tokens': 0}), 'positive int'),
    (dict(pad_ragged={'tokens': (4, -1)}), 'positive int'),
], ids=['descending', 'repeated', 'zero', 'two-fields', 'both', 'zero-size', 'negative'])
def test_validation_messages_match_jax(kwargs, match):
    from petastorm_tpu.jax.loader import JaxLoader
    with pytest.raises(ValueError, match=match) as want:
        JaxLoader(_BatchedReader(), 4, **kwargs)
    with pytest.raises(ValueError, match=match) as got:
        TorchLoader(_BatchedReader(), 4, device='cpu', **kwargs)
    assert str(got.value) == str(want.value)


def test_object_column_names_pad_ragged(ragged):
    url, _ = ragged
    with make_torch_loader(url, batch_size=8, device='cpu', reader_pool_type='dummy',
                           fields=['^id$', '^tokens$'], shuffle_row_groups=False) as loader:
        with pytest.raises(TypeError, match='pad_ragged'):
            list(loader)


def test_existing_len_column_is_refused(tmp_path):
    url = 'file://' + str(tmp_path / 'len')
    _write(url, [_ID, _TOKENS, ('tokens_len', np.int32, (), ScalarCodec(pa.int32()))],
           [{'id': i, 'tokens': np.arange(i + 1, dtype=np.int32), 'tokens_len': i}
            for i in range(8)])
    with make_torch_loader(url, batch_size=4, device='cpu', reader_pool_type='dummy',
                           pad_ragged={'tokens': 8}) as loader:
        with pytest.raises(ValueError, match='already has one'):
            list(loader)


def test_bucketed_checkpoint_resumes_as_the_jax_loader(ragged):
    # rows parked in unfilled buckets at the checkpoint are re-read on
    # resume (at-least-once); both packages save and restore the same state
    url, by_id = ragged
    kw = dict(batch_size=4, fields=['^id$', '^tokens$'], reader_pool_type='dummy',
              bucket_boundaries={'tokens': [6, 12]}, last_batch='short',
              shuffle_row_groups=True, seed=4)
    states, consumed = {}, {}
    for package, make in (('jax', make_jax_loader), ('torch', make_torch_loader)):
        extra = {'device': 'cpu'} if package == 'torch' else {}
        with make(url, **kw, **extra) as loader:
            it = iter(loader)
            consumed[package] = [np.asarray(next(it)['id']).tolist() for _ in range(3)]
            states[package] = json.loads(json.dumps(loader.state_dict()))
    assert consumed['jax'] == consumed['torch']
    assert states['jax'] == states['torch']
    with make_jax_loader(url, **kw) as loader:
        loader.load_state_dict(states['torch'])
        want = [np.asarray(b['id']).tolist() for b in loader]
    with make_torch_loader(url, device='cpu', **kw) as loader:
        loader.load_state_dict(states['jax'])
        got = [b['id'].tolist() for b in loader]
    assert got == want
    assert set(sum(consumed['torch'] + got, [])) == set(by_id)


def test_bucketed_iter_steps_crosses_epochs_as_the_jax_loader(ragged):
    url, _ = ragged
    kw = dict(batch_size=8, fields=['^id$', '^tokens$'], reader_pool_type='dummy',
              bucket_boundaries={'tokens': [6, 12]}, num_epochs=None,
              shuffle_row_groups=True, seed=6)
    with make_jax_loader(url, **kw) as loader:
        want = [{k: np.asarray(v) for k, v in b.items()} for b in loader.iter_steps(12)]
    with make_torch_loader(url, device='cpu', **kw) as loader:
        got = [{k: v.numpy() for k, v in b.items()} for b in loader.iter_steps(12)]
    _assert_same_batches(want, got)
    assert {b['tokens'].shape[1] for b in got} == {6, 12}


def test_bucketed_loader_declines_fused_decode(synthetic_dataset, monkeypatch):
    # bucketing gathers rows, so a deferred image column is decoded by the
    # loader ('bucketed'), and the loader asks the reader for none itself
    from petastorm_tpu_torch.telemetry import FUSED_FALLBACKS, get_registry, reset_registry
    kw = dict(batch_size=5, fields=['^id$', '^image_png$', '^matrix_nullable$'],
              bucket_boundaries={'matrix_nullable': [1, 3]}, last_batch='short',
              shuffle_row_groups=False)
    reset_registry()
    with make_torch_loader(synthetic_dataset.url, device='cpu', reader_pool_type='dummy',
                           **kw) as loader:
        plain = [{k: v.numpy() for k, v in b.items()} for b in loader]
        assert 'fused_decode_fallback' not in loader.diagnostics
    with make_torch_loader(synthetic_dataset.url, device='cpu', reader_pool_type='dummy',
                           defer_image_decode=True, **kw) as loader:
        deferred = [{k: v.numpy() for k, v in b.items()} for b in loader]
        assert loader.diagnostics['fused_decode_fallback'] == 'bucketed'
    counters = get_registry().snapshot()['counters']
    assert counters.get('%s{reason="bucketed"}' % FUSED_FALLBACKS, 0) > 0
    reset_registry()
    assert len(plain) == len(deferred)
    for a, b in zip(plain, deferred):
        assert sorted(a) == sorted(b)
        for name in a:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    # the port's slot ring stays on above; the JAX side runs its pre-arena path
    monkeypatch.setenv('PETASTORM_TPU_STAGING', '0')
    jax_staging.refresh_staging()
    try:
        want = _jax_batches(synthetic_dataset.url, **kw)
    finally:
        monkeypatch.undo()
        jax_staging.refresh_staging()
    _assert_same_batches(want, deferred)
    assert all(b['image_png'].shape[1:] == (16, 32, 3) for b in deferred)


def test_pad_ragged_batches_are_tensors_of_the_staged_dtypes(ragged):
    url, _ = ragged
    with make_torch_loader(url, batch_size=8, device='cpu', reader_pool_type='dummy',
                           pad_ragged={'tokens': 16, 'frames': 6},
                           dtypes={'frames': torch.bfloat16}) as loader:
        batch = next(iter(loader))
    assert batch['tokens'].dtype == torch.int32 and batch['tokens_len'].dtype == torch.int32
    assert batch['frames'].dtype == torch.bfloat16


def test_pad_ragged_two_variable_dims(tmp_path, jax_staging_off):
    # a (None, None) field padded to (3, 5): the len column is (B, 2)
    url = 'file://' + str(tmp_path / 'grid')
    rng = np.random.RandomState(1)
    rows = [{'id': i, 'grid': rng.randint(1, 255, (1 + i % 4, 2 + i % 6), dtype=np.uint8)}
            for i in range(20)]
    _write(url, [_ID, ('grid', np.uint8, (None, None), NdarrayCodec())], rows)
    kw = dict(batch_size=6, pad_ragged={'grid': (3, 5)}, last_batch='pad',
              shuffle_row_groups=False)
    got = _torch_batches(url, **kw)
    _assert_same_batches(_jax_batches(url, **kw), got)
    by_id = {r['id']: r['grid'] for r in rows}
    for batch in got:
        assert batch['grid'].shape == (6, 3, 5) and batch['grid_len'].shape == (6, 2)
        for i, row_id in enumerate(batch['id'].tolist()):
            if not batch[MASK_FIELD][i]:
                continue
            want = by_id[row_id]
            assert batch['grid_len'][i].tolist() == list(want.shape)
            h, w = min(want.shape[0], 3), min(want.shape[1], 5)
            np.testing.assert_array_equal(batch['grid'][i][:h, :w], want[:h, :w])
            assert batch['grid'][i].sum() == want[:h, :w].sum()


def test_each_bucket_width_stages_through_its_own_ring():
    """Bucketed batches alternate widths; each width is its own staging
    signature, so it gets its own slot ring and no slot of one width is
    refilled with another's rows."""
    from petastorm_tpu_torch.device import staging

    class Target:
        pin_memory = False

        def transfer(self, host, device_casts):
            return {k: v.clone() for k, v in host.items()}, None

        def deliver(self, tensors, event):
            return tensors

    engine = staging.StagingEngine(2, None, 'drop', Target(), num_slots=2)
    held = []
    for i in range(6):
        width = (6, 12)[i % 2]
        part = {'tokens': np.full((2, width), i, np.int32),
                'tokens_len': np.full(2, width - 1, np.int32)}
        held.append(engine.stage([part], 2).deliver())
    assert engine.slabs_allocated == 4
    for i, batch in enumerate(held):
        assert batch['tokens'].shape == (2, (6, 12)[i % 2])
        assert (batch['tokens'] == i).all()
