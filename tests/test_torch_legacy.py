"""The port's legacy pickled schemas (``petastorm_tpu_torch/etl/legacy.py``)
and footers against the JAX package's, on the CPU.

* The pinned dataset ``tests/data/reference_written``, whose footer holds
  only the original petastorm's ``dataset-toolkit.*`` keys, opens in the
  port: the depickled schema is the JAX package's, and its 24 rows are
  the values ``RandomState(42)`` regenerates (``tests/test_interop_pinned.py``).
* ``pickle_unischema_for_reference`` gives the JAX package's bytes for a
  schema covering every codec, every arrow type of
  ``ARROW_TO_SPARK_TYPE_NAME``, a decimal and a timestamp; each package
  depickles the other's blob to the same schema.
* The restricted unpickler refuses what the JAX package's refuses, with
  its message; every export leaves ``sys.modules`` as it found it.
* The footers of ``materialize_dataset`` and of the write plane carry
  every key and value the JAX package's carry, the two legacy keys
  included, and a footer cut down to the legacy keys reads the same rows.
"""

import os
import pickle
import sys
import types
from decimal import Decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from petastorm_tpu import codecs as jax_codecs
from petastorm_tpu import unischema as jax_unischema
from petastorm_tpu.etl import dataset_metadata as jax_meta
from petastorm_tpu.etl import legacy as jax_legacy
from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu_torch import codecs as torch_codecs
from petastorm_tpu_torch import unischema as torch_unischema
from petastorm_tpu_torch.errors import MetadataError
from petastorm_tpu_torch.etl import dataset_metadata as torch_meta
from petastorm_tpu_torch.etl import legacy as torch_legacy
from petastorm_tpu_torch.reader import make_batch_reader, make_reader
from tests.torch_telemetry_common import plane_guard  # noqa: F401 - autouse

PINNED_URL = 'file://' + os.path.join(os.path.dirname(os.path.abspath(__file__)), 'data',
                                      'reference_written')
N_PINNED = 24
LEGACY_KEYS = {b'dataset-toolkit.unischema.v1', b'dataset-toolkit.num_row_groups_per_file.v1'}
STUB_ROOTS = ('petastorm', 'pyspark')


def _expected_pinned_rows():
    """The values the pinned fixture was written from, as
    ``tests/test_interop_pinned.py`` regenerates them."""
    rng = np.random.RandomState(42)
    rows = {}
    for i in range(N_PINNED):
        rows[i] = {
            'id': np.int32(i), 'name': 'row_%d' % i, 'weight': np.float64(i) / 3.0,
            'vec': rng.rand(8).astype(np.float32), 'cvec': rng.rand(4).astype(np.float64),
            'img': rng.randint(0, 255, (16, 32, 3), np.uint8),
            'price': Decimal('%d.%02d' % (i, i)),
            'maybe': None if i % 3 == 0 else np.int32(i * 10),
        }
    return rows


def _stub_modules():
    return sorted(m for m in sys.modules if m.split('.')[0] in STUB_ROOTS)


# -- the pinned dataset the original petastorm wrote ------------------------------------


def test_pinned_footer_holds_only_the_legacy_keys():
    meta = torch_meta.ParquetDatasetInfo(PINNED_URL).common_metadata.metadata
    assert LEGACY_KEYS <= set(meta)
    assert torch_meta.UNISCHEMA_KEY not in meta
    assert torch_meta.ROW_GROUPS_PER_FILE_KEY not in meta


def test_pinned_schema_is_the_references():
    got = torch_meta.get_schema_from_dataset_url(PINNED_URL)
    want = jax_meta.get_schema_from_dataset_url(PINNED_URL)
    assert got.to_json_dict() == want.to_json_dict()
    assert list(got.fields) == ['id', 'name', 'weight', 'vec', 'cvec', 'img', 'price', 'maybe']
    assert got.img.shape == (16, 32, 3) and got.maybe.nullable
    assert got.price.numpy_dtype is Decimal
    assert got.price.codec.arrow_type(got.price) == pa.decimal128(10, 2)
    assert isinstance(got.img.codec, torch_codecs.CompressedImageCodec)
    assert isinstance(got.cvec.codec, torch_codecs.CompressedNdarrayCodec)
    assert len(torch_meta.load_row_groups(torch_meta.ParquetDatasetInfo(PINNED_URL))) == \
        len(jax_meta.load_row_groups(jax_meta.ParquetDatasetInfo(PINNED_URL)))


@pytest.mark.parametrize('pool', ['dummy', 'thread'])
def test_pinned_rows_decode_exactly(pool):
    expected = _expected_pinned_rows()
    with make_reader(PINNED_URL, shuffle_row_groups=False, reader_pool_type=pool) as reader:
        rows = list(reader)
    assert sorted(int(r.id) for r in rows) == list(range(N_PINNED))
    for row in rows:
        want = expected[int(row.id)]
        assert row.name == want['name'] and row.weight == want['weight']
        for name in ('vec', 'cvec', 'img'):
            np.testing.assert_array_equal(getattr(row, name), want[name])
        assert row.price == want['price']
        assert row.maybe == want['maybe'] if want['maybe'] is not None else row.maybe is None
    if pool == 'dummy':
        with jax_make_reader(PINNED_URL, shuffle_row_groups=False,
                             reader_pool_type='dummy') as reader:
            assert [int(r.id) for r in reader] == [int(r.id) for r in rows]


def test_pinned_batch_reader():
    expected = _expected_pinned_rows()
    seen = []
    with make_batch_reader(PINNED_URL, shuffle_row_groups=False, reader_pool_type='dummy',
                           schema_fields=['^id$', '^img$', '^vec$']) as reader:
        for batch in reader:
            for i, row_id in enumerate(batch.id):
                np.testing.assert_array_equal(batch.img[i], expected[int(row_id)]['img'])
                np.testing.assert_array_equal(batch.vec[i], expected[int(row_id)]['vec'])
                seen.append(int(row_id))
    assert sorted(seen) == list(range(N_PINNED))


# -- pickled bytes ------------------------------------------------------------------------


def test_spark_type_table_is_the_references():
    assert torch_codecs.ARROW_TO_SPARK_TYPE_NAME == jax_codecs.ARROW_TO_SPARK_TYPE_NAME


def _every_codec_schema_json():
    """Every codec, a ScalarCodec of every arrow type the spark table
    names, a decimal, a timestamp, shared shapes and a wildcard dim."""
    fields = []
    for i, type_str in enumerate(sorted(jax_codecs.ARROW_TO_SPARK_TYPE_NAME)):
        arrow_type = jax_codecs._parse_arrow_type(type_str)
        fields.append(jax_unischema.UnischemaField(
            'f_' + type_str.replace('[', '_').replace(']', ''),
            jax_unischema.arrow_to_numpy_dtype(arrow_type), (),
            jax_codecs.ScalarCodec(arrow_type), i % 2 == 0))
    jf = jax_unischema.UnischemaField
    fields += [
        jf('price', Decimal, (), jax_codecs.ScalarCodec(pa.decimal128(10, 2)), False),
        jf('at', np.datetime64, (), jax_codecs.ScalarCodec(pa.timestamp('us')), True),
        jf('png', np.uint8, (16, 32, 3), jax_codecs.CompressedImageCodec('png'), False),
        jf('jpeg', np.uint8, (None, None, 3), jax_codecs.CompressedImageCodec('jpeg', 91),
           False),
        jf('arr', np.float32, (None, 4), jax_codecs.NdarrayCodec(), True),
        jf('zipped', np.float64, (3,), jax_codecs.CompressedNdarrayCodec(), False),
        jf('plain', np.int64, (), None, False),
    ]
    return jax_unischema.Unischema('EveryCodec', fields).to_json_dict()


def test_pickle_bytes_are_the_references():
    d = _every_codec_schema_json()
    port_schema = torch_unischema.Unischema.from_json_dict(d)
    jax_schema = jax_unischema.Unischema.from_json_dict(d)
    assert torch_legacy._real_modules_if_importable() is None
    assert jax_legacy._real_modules_if_importable() is None
    blob = torch_legacy.pickle_unischema_for_reference(port_schema)
    assert blob == jax_legacy.pickle_unischema_for_reference(jax_schema)
    # the reference's export of the port's own schema object, too
    assert blob == jax_legacy.pickle_unischema_for_reference(port_schema)
    assert blob[:2] == b'\x80\x02'
    assert b'petastorm.unischema' in blob and b'pyspark.sql.types' in blob
    assert b'petastorm_tpu' not in blob


def test_each_package_depickles_the_others_blob():
    d = _every_codec_schema_json()
    # numpy 2 pickles np.bool_ as numpy.bool, which the allowlist (the
    # reference's) lacks: both packages refuse it alike
    d['fields'] = [f for f in d['fields'] if f['numpy_dtype'] != 'bool']
    port_schema = torch_unischema.Unischema.from_json_dict(d)
    blob = torch_legacy.pickle_unischema_for_reference(port_schema)
    got = torch_legacy.depickle_legacy_unischema(blob)
    want = jax_legacy.depickle_legacy_unischema(blob)
    assert got.to_json_dict() == want.to_json_dict()
    assert list(got.fields) == list(port_schema.fields)
    assert got.jpeg.codec.image_codec == 'jpeg' and got.jpeg.codec._quality == 91
    assert got.arr.shape == (None, 4) and got.arr.nullable
    assert got.price.codec.arrow_type(got.price) == pa.decimal128(10, 2)
    assert got.plain.codec is None


def test_bool_is_refused_as_the_reference_refuses_it():
    schema = torch_unischema.Unischema('B', [torch_unischema.UnischemaField(
        'flag', np.bool_, (), torch_codecs.ScalarCodec(pa.bool_()), False)])
    blob = torch_legacy.pickle_unischema_for_reference(schema)
    errors = []
    for legacy in (torch_legacy, jax_legacy):
        with pytest.raises(pickle.UnpicklingError) as caught:
            legacy.depickle_legacy_unischema(blob)
        errors.append(str(caught.value))
    assert errors[0] == errors[1]


def test_reference_style_pickle_depickles():
    from tests.legacy_pickle_helper import make_reference_style_pickle
    blob = make_reference_style_pickle()
    schema = torch_legacy.depickle_legacy_unischema(blob)
    assert list(schema.fields) == ['id', 'image'] and schema.id.numpy_dtype is np.int32
    assert schema.id.codec.arrow_type(None) == pa.int32()
    assert schema.image.codec.image_codec == 'png' and schema.image.shape == (None, None, 3)
    assert schema.to_json_dict() == jax_legacy.depickle_legacy_unischema(blob).to_json_dict()


class _Evil:
    def __reduce__(self):
        return (os.system, ('echo pwned',))


class _LoadsNumpy:
    def __reduce__(self):
        return (np.load, ('/nonexistent.npy',))


@pytest.mark.parametrize('payload', [_Evil(), _LoadsNumpy(), print, eval],
                         ids=['os-system', 'numpy-load', 'print', 'eval'])
def test_restricted_unpickler_refuses_what_the_reference_refuses(payload):
    blob = pickle.dumps(payload, protocol=2)
    messages = []
    for legacy in (torch_legacy, jax_legacy):
        with pytest.raises(pickle.UnpicklingError) as caught:
            legacy.depickle_legacy_unischema(blob)
        messages.append(str(caught.value))
    assert messages[0] == messages[1] and messages[0].startswith('Refusing to depickle')


def test_malformed_schemas_raise_metadata_error():
    for blob in (pickle.dumps(3), pickle.dumps(types.SimpleNamespace(_name='x')),
                 pickle.dumps(frozenset())):
        with pytest.raises((MetadataError, pickle.UnpicklingError)):
            torch_legacy.depickle_legacy_unischema(blob)


def test_export_leaves_sys_modules_as_it_found_them(monkeypatch):
    schema = torch_unischema.Unischema.from_json_dict(_every_codec_schema_json())
    before = _stub_modules()
    torch_legacy.pickle_unischema_for_reference(schema)
    jax_legacy.pickle_unischema_for_reference(schema)
    assert _stub_modules() == before
    # an entry present before the export is put back, not dropped
    sentinel = types.ModuleType('pyspark')
    monkeypatch.setitem(sys.modules, 'pyspark', sentinel)
    torch_legacy.pickle_unischema_for_reference(schema)
    assert sys.modules['pyspark'] is sentinel
    assert 'petastorm' not in sys.modules and 'pyspark.sql.types' not in sys.modules
    monkeypatch.undo()
    assert _stub_modules() == before


def test_export_restores_sys_modules_after_a_failure():
    class Unknown:
        pass
    schema = torch_unischema.Unischema('S', [torch_unischema.UnischemaField(
        'x', np.int32, (), Unknown(), False)])
    before = _stub_modules()
    with pytest.raises(MetadataError, match='no reference equivalent'):
        torch_legacy.pickle_unischema_for_reference(schema)
    assert _stub_modules() == before


# -- footers ------------------------------------------------------------------------------

ROWS_SCHEMA_JSON = jax_unischema.Unischema('FooterSchema', [
    jax_unischema.UnischemaField('id', np.int64, (), jax_codecs.ScalarCodec(pa.int64()), False),
    jax_unischema.UnischemaField('vec', np.float32, (4,), jax_codecs.NdarrayCodec(), False),
    jax_unischema.UnischemaField('img', np.uint8, (8, 8, 3),
                                 jax_codecs.CompressedImageCodec('png'), False),
    jax_unischema.UnischemaField('price', Decimal, (),
                                 jax_codecs.ScalarCodec(pa.decimal128(10, 2)), True),
]).to_json_dict()


def _footer_rows(n=40):
    rng = np.random.RandomState(5)
    return [{'id': np.int64(i), 'vec': rng.rand(4).astype(np.float32),
             'img': rng.randint(0, 255, (8, 8, 3), np.uint8),
             'price': None if i % 4 == 0 else Decimal('%d.%02d' % (i, i % 100))}
            for i in range(n)]


def _write(package, url, how):
    meta = jax_meta if package == 'jax' else torch_meta
    unischema = jax_unischema if package == 'jax' else torch_unischema
    schema = unischema.Unischema.from_json_dict(ROWS_SCHEMA_JSON)
    if how == 'materialize':
        meta.write_dataset(url, schema, _footer_rows(), rowgroup_size_rows=10, num_files=2)
    else:
        if package == 'jax':
            from petastorm_tpu.write import write_dataset_distributed
        else:
            from petastorm_tpu_torch.write import write_dataset_distributed
        write_dataset_distributed(url, schema, _footer_rows(), shard_rows=16,
                                  rowgroup_size_rows=8, sort_by='id')
    return dict(meta.ParquetDatasetInfo(url).common_metadata.metadata)


@pytest.mark.parametrize('how', ['materialize', 'write-plane'])
def test_footer_keys_and_values_are_the_references(tmp_path, how):
    got = _write('torch', 'file://' + str(tmp_path / 'torch'), how)
    want = _write('jax', 'file://' + str(tmp_path / 'jax'), how)
    assert LEGACY_KEYS <= set(got)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key] == want[key], key
    assert got[b'dataset-toolkit.num_row_groups_per_file.v1'] == \
        got[torch_meta.ROW_GROUPS_PER_FILE_KEY]


def _legacy_only(url, tmp_path):
    """A copy of ``url``'s footer holding only the two legacy keys: the
    footer the original petastorm writes."""
    info = torch_meta.ParquetDatasetInfo(url)
    meta = {k: v for k, v in info.common_metadata.metadata.items() if k in LEGACY_KEYS}
    base = info.common_metadata.schema.to_arrow_schema().with_metadata(meta)
    path = os.path.join(info.root_path, '_common_metadata')
    pq.write_metadata(base, path)
    return torch_meta.ParquetDatasetInfo(url)


def test_legacy_only_footer_reads_the_same_rows(tmp_path):
    url = 'file://' + str(tmp_path / 'ds')
    torch_meta.write_dataset(url, torch_unischema.Unischema.from_json_dict(ROWS_SCHEMA_JSON),
                             _footer_rows(), rowgroup_size_rows=10, num_files=2)
    with make_batch_reader(url, reader_pool_type='dummy', shuffle_row_groups=False) as reader:
        want = [b._asdict() for b in reader]
    info = _legacy_only(url, tmp_path)
    assert set(info.common_metadata.metadata) - {b'ARROW:schema'} == LEGACY_KEYS
    schema = torch_meta.get_schema(info)
    assert schema.to_json_dict() == dict(ROWS_SCHEMA_JSON, name='FooterSchema')
    assert jax_meta.get_schema(jax_meta.ParquetDatasetInfo(url)).to_json_dict() == \
        schema.to_json_dict()
    with make_batch_reader(url, reader_pool_type='dummy', shuffle_row_groups=False) as reader:
        got = [b._asdict() for b in reader]
    assert len(got) == len(want) == 4
    for a, b in zip(want, got):
        assert list(a) == list(b)
        for name in a:
            if isinstance(a[name], np.ndarray) and a[name].dtype != object:
                np.testing.assert_array_equal(a[name], b[name])
            else:
                assert list(a[name]) == list(b[name]), name
