"""petastorm_tpu_torch.ngram and NGram reads against the JAX package's.

The unit cases of the JAX package's NGram tests run through both
packages' ``form_ngram`` on the same column batches, made from a seed with
numpy, and must give the same windows with the same values and types; the
validation cases must raise the same errors. End to end, ``make_reader``
with an NGram yields the same windows in the same order on the dummy pool
(with and without row-drop partitions, whose overlap rows keep the
windows at a partition boundary), the same multiset on the thread pool,
and a state that records window progress and resumes in either package.
"""

import json
import pickle

import numpy as np
import pyarrow as pa
import pytest

from petastorm_tpu.arrow_worker import ColumnBatch as JaxColumnBatch
from petastorm_tpu.codecs import ScalarCodec
from petastorm_tpu.ngram import NGram as JaxNGram
from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu.unischema import Unischema, UnischemaField
from petastorm_tpu_torch.arrow_worker import ColumnBatch as TorchColumnBatch
from petastorm_tpu_torch.ngram import NGram as TorchNGram
from petastorm_tpu_torch.reader import make_reader as torch_make_reader
from petastorm_tpu_torch.unischema import Unischema as TorchUnischema

from tests.test_common import TestSchema
from tests.torch_telemetry_common import plane_guard  # noqa: F401 - autouse

TsSchema = Unischema('TsSchema', [
    UnischemaField('ts', np.int64, (), ScalarCodec(pa.int64()), False),
    UnischemaField('value', np.int32, (), ScalarCodec(pa.int32()), False),
    UnischemaField('other', np.float64, (), ScalarCodec(pa.float64()), False),
])
TorchTsSchema = TorchUnischema.from_json_dict(TsSchema.to_json_dict())
PACKAGES = {
    'jax': (JaxNGram, JaxColumnBatch, TsSchema, jax_make_reader),
    'torch': (TorchNGram, TorchColumnBatch, TorchTsSchema, torch_make_reader),
}


def _batch(package, ts_values, seed=0):
    rng = np.random.RandomState(seed)
    n = len(ts_values)
    columns = {'ts': np.asarray(ts_values, dtype=np.int64),
               'value': rng.randint(0, 1000, n).astype(np.int32),
               'other': rng.rand(n)}
    return PACKAGES[package][1](columns, n)


def _resolved(package, fields, delta, overlap=True, timestamp='ts'):
    ngram_cls, _, schema, _ = PACKAGES[package]
    ngram = ngram_cls(fields=fields, delta_threshold=delta, timestamp_field=timestamp,
                      timestamp_overlap=overlap)
    ngram.resolve_regex_field_names(schema)
    return ngram


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (np.asarray(a).dtype == np.asarray(b).dtype
                and np.array_equal(np.asarray(a), np.asarray(b)))
    return type(a) is type(b) and a == b


def _assert_windows_equal(want, got):
    """Windows as ``{timestep: dict or namedtuple}``, compared in order."""
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert list(a) == list(b)
        for k in a:
            ra, rb = (r._asdict() if hasattr(r, '_asdict') else r for r in (a[k], b[k]))
            assert list(ra) == list(rb)
            for name in ra:
                assert _same(ra[name], rb[name]), (k, name, ra[name], rb[name])


# (fields, delta_threshold, timestamp_overlap, timestamps): the form_ngram
# cases of the JAX package's TestFormNGram, plus random gaps
FORM_CASES = {
    'dense': ({0: ['value'], 1: ['value', 'other']}, 1, True, [0, 1, 2, 3]),
    'delta-gap': ({-1: ['value'], 0: ['value']}, 4, True, [0, 3, 8, 10, 11, 20, 30]),
    'all-dropped': ({0: ['value'], 1: ['value']}, 5, True, [0, 10, 20, 30]),
    'sparse-keys': ({-1: ['value'], 1: ['value']}, 1, True, [0, 1, 2, 3]),
    'non-overlapping': ({0: ['value'], 1: ['value'], 2: ['value']}, 1, False,
                        [0, 1, 2, 3, 4, 5]),
    'short-batch': ({0: ['value'], 1: ['value'], 2: ['value']}, 1, True, [0, 1]),
    'length-one': ({0: ['value', 'ts']}, 1, True, [0, 5, 6]),
    'regex-fields': ({0: ['va.*', 'ts'], 2: ['o.*']}, 2, True, [0, 1, 3, 4, 7, 8, 9]),
    'random-gaps': ({-2: ['ts'], 0: ['value', 'other']}, 2, True,
                    np.cumsum(np.random.RandomState(1).randint(1, 4, 60)).tolist()),
    'random-gaps-non-overlapping': ({0: ['ts'], 1: ['value']}, 2, False,
                                    np.cumsum(np.random.RandomState(2).randint(1, 4, 60)).tolist()),
    'float-threshold': ({0: ['ts'], 1: ['ts', 'other']}, 1.5, True, [0, 1, 3, 4, 6, 8]),
}


@pytest.mark.parametrize('case', sorted(FORM_CASES))
def test_form_ngram_windows_equal(case):
    fields, delta, overlap, ts = FORM_CASES[case]
    windows = {package: _resolved(package, fields, delta, overlap).form_ngram(
        _batch(package, ts), PACKAGES[package][2]) for package in PACKAGES}
    _assert_windows_equal(windows['jax'], windows['torch'])
    if case in ('all-dropped', 'short-batch'):
        assert windows['torch'] == []
    else:
        assert windows['torch']
    named = {package: [_resolved(package, fields, delta, overlap).make_namedtuple(
        PACKAGES[package][2], w) for w in windows[package]] for package in PACKAGES}
    _assert_windows_equal(named['jax'], named['torch'])


def test_form_ngram_refuses_unsorted_rows():
    for package in PACKAGES:
        ngram = _resolved(package, {0: ['value'], 1: ['value']}, 1)
        with pytest.raises(NotImplementedError, match='sorted'):
            ngram.form_ngram(_batch(package, [3, 1, 2]), PACKAGES[package][2])


# the construction errors of the JAX package's TestNGramUnit.test_validation
INVALID = {
    'fields-none': dict(fields=None, delta_threshold=1, timestamp_field='ts'),
    'value-not-list': dict(fields={0: 'not-a-list'}, delta_threshold=1, timestamp_field='ts'),
    'entry-not-field': dict(fields={0: [5]}, delta_threshold=1, timestamp_field='ts'),
    'delta-not-number': dict(fields={0: ['value']}, delta_threshold='x', timestamp_field='ts'),
    'delta-bool': dict(fields={0: ['value']}, delta_threshold=True, timestamp_field='ts'),
    'timestamp-not-field': dict(fields={0: ['value']}, delta_threshold=1, timestamp_field=7),
    'overlap-not-bool': dict(fields={0: ['value']}, delta_threshold=1, timestamp_field='ts',
                             timestamp_overlap='yes'),
    'key-not-int': dict(fields={0.5: ['value']}, delta_threshold=1, timestamp_field='ts'),
}


@pytest.mark.parametrize('case', sorted(INVALID))
def test_validation_errors_equal(case):
    with pytest.raises(ValueError) as want:
        JaxNGram(**INVALID[case])
    with pytest.raises(ValueError) as got:
        TorchNGram(**INVALID[case])
    assert str(got.value) == str(want.value)


def test_timestamp_regex_must_match_one_field():
    for package in PACKAGES:
        ngram = PACKAGES[package][0](fields={0: ['value']}, delta_threshold=1,
                                     timestamp_field='.*')
        with pytest.raises(ValueError, match='exactly one'):
            ngram.resolve_regex_field_names(PACKAGES[package][2])


def test_schema_queries_equal():
    out = {}
    for package in PACKAGES:
        schema = PACKAGES[package][2]
        a = _resolved(package, {0: ['va.*'], 1: [schema.fields['other']]}, 1)
        b = _resolved(package, {-1: ['value'], 1: ['value', 'other']}, 1)
        out[package] = {
            'lengths': (a.length, b.length),
            'names': [a.get_field_names_at_timestep(k) for k in (0, 1, 9)],
            'view': sorted(b.get_schema_at_timestep(schema, 1).fields),
            'all': sorted(f.name for f in b.get_field_names_at_all_timesteps()),
        }
    assert out['torch'] == out['jax']
    assert out['torch']['lengths'] == (2, 3)


def test_equality_and_pickling():
    a = _resolved('torch', {0: ['value'], 1: ['other']}, 1)
    b = _resolved('torch', {0: ['value'], 1: ['other']}, 5)
    c = _resolved('torch', {0: ['value'], 1: ['value']}, 1)
    assert a == b and not a != b  # the threshold is not part of the identity
    assert a != c and not a == c
    a.get_schema_at_timestep(TorchTsSchema, 1)  # fills the view cache
    copy = pickle.loads(pickle.dumps(a))
    assert copy == a and '_view_cache' not in copy.__dict__
    assert copy.make_namedtuple(TorchTsSchema, {0: {'value': 1}, 1: {'other': 0.5}})[1].other == 0.5


# -- end to end on the synthetic dataset: ids 0..99, row-groups of (10, 10, 5) per file


def _windows(package, url, fields, **kw):
    ngram_cls, _, _, make_reader = PACKAGES[package]
    ngram = ngram_cls(fields=fields, delta_threshold=kw.pop('delta', 1),
                      timestamp_field=kw.pop('timestamp', '^id$'),
                      timestamp_overlap=kw.pop('overlap', True))
    with make_reader(url, ngram=ngram, **kw) as reader:
        assert reader.batched_output is False and reader.ngram is ngram
        return list(reader)


def _expected_window_count(length):
    return 4 * sum(max(0, n - length + 1) for n in (10, 10, 5))


@pytest.mark.parametrize('fields,length', [
    ({0: ['^id$', '^id2$'], 1: ['^id$', '^sensor_name$']}, 2),
    ({0: ['^id$'], 1: ['^id$', '^image_png$', '^matrix$'], 2: ['^id$', '^decimal$']}, 3),
    ({0: ['^id$']}, 1),
], ids=['pairs', 'decoded-triples', 'length-one'])
@pytest.mark.parametrize('drop_partitions', [1, 2])
def test_dummy_pool_windows_equal(synthetic_dataset, fields, length, drop_partitions):
    kw = dict(reader_pool_type='dummy', seed=2, num_epochs=1,
              shuffle_row_drop_partitions=drop_partitions)
    want = _windows('jax', synthetic_dataset.url, fields, **kw)
    got = _windows('torch', synthetic_dataset.url, fields, **kw)
    _assert_windows_equal(want, got)
    # the overlap rows keep every window at a partition boundary
    assert len(got) == _expected_window_count(length)
    for w in got:
        assert [int(w[k].id) for k in sorted(w)] == list(range(int(w[0].id),
                                                               int(w[0].id) + length))


def test_thread_pool_window_multisets(synthetic_dataset):
    fields = {0: ['^id$', '^id_float$'], 1: ['^id$', '^matrix_uint16$']}
    kw = dict(reader_pool_type='thread', workers_count=3, shuffle_row_drop_partitions=2)
    want = sorted(_windows('jax', synthetic_dataset.url, fields, **kw), key=lambda w: int(w[0].id))
    got = sorted(_windows('torch', synthetic_dataset.url, fields, **kw), key=lambda w: int(w[0].id))
    _assert_windows_equal(want, got)
    assert len(got) == _expected_window_count(2)


def test_non_overlapping_windows_equal(synthetic_dataset):
    fields = {0: ['^id$'], 1: ['^id$']}
    kw = dict(reader_pool_type='dummy', overlap=False)
    want = _windows('jax', synthetic_dataset.url, fields, **kw)
    got = _windows('torch', synthetic_dataset.url, fields, **kw)
    _assert_windows_equal(want, got)
    seen = [int(w[k].id) for w in got for k in (0, 1)]
    assert len(seen) == len(set(seen))


def test_non_overlap_with_row_drop_refused(synthetic_dataset):
    for package in PACKAGES:
        ngram = PACKAGES[package][0](fields={0: ['^id$'], 1: ['^id$']}, delta_threshold=1,
                                     timestamp_field='^id$', timestamp_overlap=False)
        with pytest.raises(NotImplementedError, match='shuffle_row_drop_partitions'):
            PACKAGES[package][3](synthetic_dataset.url, ngram=ngram,
                                 shuffle_row_drop_partitions=2)


def test_explicit_unischema_fields(synthetic_dataset):
    schema = TorchUnischema.from_json_dict(TestSchema.to_json_dict())
    fields = {0: [schema.fields['id']], 1: [schema.fields['id'], schema.fields['id2']]}
    ngram = TorchNGram(fields=fields, delta_threshold=1, timestamp_field=schema.fields['id'])
    with torch_make_reader(synthetic_dataset.url, ngram=ngram, reader_pool_type='dummy') as reader:
        w = next(reader)
    assert int(w[1].id) == int(w[0].id) + 1 and set(w[1]._fields) == {'id', 'id2'}


@pytest.mark.parametrize('delta,starts', [(100, [0, 3, 8, 10, 11, 20]), (4, [0, 8, 10, 20])])
def test_delta_threshold_end_to_end(tmp_path, delta, starts):
    from petastorm_tpu_torch.etl.dataset_metadata import write_dataset
    url = 'file://%s/ts' % tmp_path
    gappy = [0, 3, 8, 10, 11, 20, 23]
    write_dataset(url, TorchTsSchema, [{'ts': t, 'value': i, 'other': i * 0.5}
                                       for i, t in enumerate(gappy)],
                  rowgroup_size_rows=len(gappy))
    fields = {0: ['^ts$'], 1: ['^ts$', '^value$']}
    got = {package: _windows(package, url, fields, reader_pool_type='dummy', delta=delta,
                             timestamp='^ts$') for package in PACKAGES}
    _assert_windows_equal(got['jax'], got['torch'])
    assert sorted(int(w[0].ts) for w in got['torch']) == starts


@pytest.mark.parametrize('saver,loader', [('jax', 'torch'), ('torch', 'jax')])
def test_checkpoint_records_window_progress(synthetic_dataset, saver, loader):
    """Window consumption marks row-groups consumed (on the last window of
    each), so a state resumes instead of replaying the epoch, in either
    package, with the same remaining windows."""
    fields = {0: ['^id$'], 1: ['^id$']}
    kw = dict(reader_pool_type='dummy', shuffle_row_groups=False)
    states = {}
    for package in PACKAGES:
        ngram_cls, _, _, make_reader = PACKAGES[package]
        ngram = ngram_cls(fields=fields, delta_threshold=1, timestamp_field='^id$')
        with make_reader(synthetic_dataset.url, ngram=ngram, **kw) as reader:
            consumed = [next(reader) for _ in range(25)]
            states[package] = reader.state_dict()
    assert states['torch'] == states['jax']
    assert states[saver]['consumed_items'], 'window consumption must record progress'
    ngram_cls, _, _, make_reader = PACKAGES[loader]
    ngram = ngram_cls(fields=fields, delta_threshold=1, timestamp_field='^id$')
    with make_reader(synthetic_dataset.url, ngram=ngram, **kw) as resumed:
        resumed.load_state_dict(json.loads(json.dumps(states[saver])))
        rest = {int(w[0].id) for w in resumed}
    seen = {int(w[0].id) for w in consumed}
    # every window start is read at least once
    assert seen | rest >= {i for i in range(100) if (i % 25) not in (9, 19, 24)}
