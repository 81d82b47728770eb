"""The port's URL → filesystem layer against the JAX package's, case for
case with ``tests/test_fs.py``: URL helpers, reads over fsspec's
``memory://`` store (each package reading what the other wrote), an
explicit ``filesystem=``, URL lists and a dataset moved after it was
written. Both packages resolve every URL to the same filesystem class and
path."""

import contextlib
import uuid

import fsspec
import numpy as np
import pyarrow as pa
import pytest
from fsspec.implementations.memory import MemoryFileSystem

from petastorm_tpu import fs as jax_fs
from petastorm_tpu.codecs import NdarrayCodec as JaxNdarrayCodec
from petastorm_tpu.codecs import ScalarCodec as JaxScalarCodec
from petastorm_tpu.etl import dataset_metadata as jax_metadata
from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader
from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu.unischema import Unischema as JaxUnischema
from petastorm_tpu.unischema import UnischemaField as JaxUnischemaField
from petastorm_tpu_torch import fs as torch_fs
from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.etl import dataset_metadata as torch_metadata
from petastorm_tpu_torch.reader import make_batch_reader as torch_make_batch_reader
from petastorm_tpu_torch.reader import make_reader as torch_make_reader
from petastorm_tpu_torch.unischema import Unischema, UnischemaField
from tests.torch_stub_fs import fake_object_store_class, registered
from tests.torch_telemetry_common import plane_guard  # noqa: F401 - autouse

FS = {'jax': jax_fs, 'torch': torch_fs}
METADATA = {'jax': jax_metadata, 'torch': torch_metadata}
READERS = {'jax': jax_make_reader, 'torch': torch_make_reader}
BATCH_READERS = {'jax': jax_make_batch_reader, 'torch': torch_make_batch_reader}
PACKAGES = ('jax', 'torch')

SCHEMAS = {
    'jax': JaxUnischema('SmallSchema', [
        JaxUnischemaField('id', np.int64, (), JaxScalarCodec(pa.int64()), False),
        JaxUnischemaField('vec', np.float32, (4,), JaxNdarrayCodec(), False)]),
    'torch': Unischema('SmallSchema', [
        UnischemaField('id', np.int64, (), ScalarCodec(pa.int64()), False),
        UnischemaField('vec', np.float32, (4,), NdarrayCodec(), False)]),
}


def _rows(n):
    rng = np.random.RandomState(0)
    return [{'id': i, 'vec': rng.rand(4).astype(np.float32)} for i in range(n)]


def _write(package, url, n, **kwargs):
    METADATA[package].write_dataset(url, SCHEMAS[package], _rows(n), **kwargs)


def _ids(batches):
    return sorted(int(i) for b in batches for i in b.id)


@pytest.fixture
def memory_url():
    """A ``memory://`` dataset URL of this test's own; its objects are
    removed after."""
    root = '/torch_fs_%s' % uuid.uuid4().hex
    yield 'memory://' + root.lstrip('/')
    memory = MemoryFileSystem()
    if memory.exists(root):
        memory.rm(root, recursive=True)


class TestUrlHelpers:
    def test_normalize_dir_url(self):
        for package in PACKAGES:
            assert FS[package].normalize_dir_url('file:///a/b/') == 'file:///a/b'
            with pytest.raises(ValueError):
                FS[package].normalize_dir_url(123)

    @pytest.mark.parametrize('url,path', [
        ('gs://bucket/dir/ds', 'bucket/dir/ds'), ('gcs://bucket/ds', 'bucket/ds'),
        ('s3://b/key', 'b/key'), ('s3a://b/key', 'b/key'), ('s3n://b/key', 'b/key'),
        ('file:///x/y', '/x/y'), ('hdfs://ns/x/y', '/x/y'), ('hdfs:///x', '/x'),
        ('memory://m/ds', '/ds'), ('/bare/path', '/bare/path'),
    ])
    def test_get_dataset_path_object_store_keeps_bucket(self, url, path):
        assert torch_fs.get_dataset_path(url) == jax_fs.get_dataset_path(url) == path

    def test_url_list_must_be_homogeneous(self):
        for package in PACKAGES:
            with pytest.raises(ValueError, match='share scheme'):
                FS[package].get_filesystem_and_path_or_paths(
                    ['file:///a/1.parquet', 'memory://a/2.parquet'])
            with pytest.raises(ValueError, match='share scheme'):
                FS[package].get_filesystem_and_path_or_paths(
                    ['gs://b1/1.parquet', 'gs://b2/2.parquet'])

    def test_url_list_resolution(self):
        urls = ['file:///a/1.parquet', 'file:///a/2.parquet']
        got = {package: FS[package].get_filesystem_and_path_or_paths(urls)
               for package in PACKAGES}
        assert got['torch'][1] == got['jax'][1] == ['/a/1.parquet', '/a/2.parquet']
        assert type(got['torch'][0]) is type(got['jax'][0])


@pytest.mark.parametrize('url', [
    'file:///data/ds', '/data/ds', 'memory://bucket/ds', 'gs://bucket/ds',
    's3://bucket/ds', ['gs://bucket/ds/a.parquet', 'gs://bucket/ds/b.parquet'],
    ['memory://m/a.parquet', 'memory://m/b.parquet'],
])
def test_same_url_resolves_to_the_same_filesystem_and_path(url):
    """Scheme dispatch: the same filesystem class and paths in both
    packages (``gs``/``s3`` bound to fake stores)."""
    first = url[0] if isinstance(url, list) else url
    proto = first.split('://')[0] if '://' in first else None
    with registered(proto, fake_object_store_class(proto)) if proto in ('gs', 's3') \
            else contextlib.nullcontext():
        got = {package: FS[package].get_filesystem_and_path_or_paths(url)
               for package in PACKAGES}
    assert type(got['torch'][0]) is type(got['jax'][0])
    assert got['torch'][1] == got['jax'][1]
    if proto in ('gs', 's3'):
        paths = got['torch'][1] if isinstance(url, list) else [got['torch'][1]]
        assert all(p.startswith('/bucket/ds') for p in paths), paths


class TestMemoryFilesystem:
    """An fsspec store with no local paths: scheme and path handling the
    ``file://`` tests cannot catch. Each package reads what the other
    wrote."""

    @pytest.mark.parametrize('writer', PACKAGES)
    def test_write_and_read_round_trip(self, memory_url, writer):
        rows = _rows(20)
        _write(writer, memory_url, 20, rowgroup_size_rows=5)
        got = {}
        for package in PACKAGES:
            schema = METADATA[package].get_schema_from_dataset_url(memory_url)
            assert list(schema.fields) == ['id', 'vec']
            with READERS[package](memory_url, shuffle_row_groups=False,
                                  reader_pool_type='dummy') as reader:
                got[package] = [(int(r.id), r.vec.tobytes()) for r in reader]
        assert got['torch'] == got['jax']
        assert [i for i, _ in got['torch']] == list(range(20))
        assert got['torch'][3][1] == rows[3]['vec'].tobytes()

    @pytest.mark.parametrize('writer', PACKAGES)
    def test_batch_reader_over_memory(self, memory_url, writer):
        _write(writer, memory_url, 30, rowgroup_size_rows=10)
        ids = {}
        for package in PACKAGES:
            with BATCH_READERS[package](memory_url) as reader:
                ids[package] = _ids(reader)
            assert METADATA[package].count_rows(memory_url) == 30
        assert ids['torch'] == ids['jax'] == list(range(30))


class TestExplicitFilesystem:
    """``filesystem=``: an fsspec instance used as given, in place of
    resolving one from the URL (e.g. a pre-authenticated gcsfs)."""

    def test_reader_uses_explicit_instance(self, memory_url):
        _write('torch', memory_url, 20, rowgroup_size_rows=5)
        got = {}
        for package in PACKAGES:
            # a distinct instance: URL resolution would return fsspec's
            # cached one, so a dropped passthrough shows as another object
            fs = fsspec.filesystem('memory', skip_instance_cache=True)
            with READERS[package](memory_url, shuffle_row_groups=False, filesystem=fs,
                                  reader_pool_type='dummy') as reader:
                assert reader.dataset_info.fs is fs
                rows = sorted(int(r.id) for r in reader)
            with BATCH_READERS[package](memory_url, filesystem=fs) as reader:
                assert reader.dataset_info.fs is fs
                got[package] = (rows, _ids(reader))
        assert got['torch'] == got['jax'] == (list(range(20)), list(range(20)))

    def test_scheme_mismatch_rejected(self):
        fs = fsspec.filesystem('memory', skip_instance_cache=True)
        messages = []
        for package in PACKAGES:
            with pytest.raises(ValueError, match='does not match') as caught:
                FS[package].get_filesystem_and_path_or_paths('gs://bucket/ds', filesystem=fs)
            messages.append(str(caught.value))
        assert messages[0] == messages[1]

    def test_resolver_returns_instance_and_stripped_paths(self):
        fs = fsspec.filesystem('memory')
        for package in PACKAGES:
            resolve = FS[package].get_filesystem_and_path_or_paths
            got_fs, path = resolve('memory://some/ds', filesystem=fs)
            assert got_fs is fs
            assert path == fs._strip_protocol('memory://some/ds')
            got_fs, paths = resolve(['memory://a/1.parquet', 'memory://a/2.parquet'],
                                    filesystem=fs)
            assert got_fs is fs and paths == ['/a/1.parquet', '/a/2.parquet']
            # a bare path has no scheme to check
            assert resolve('/bare/ds', filesystem=fs) == (fs, '/bare/ds')

    def test_mutually_exclusive_with_storage_options(self):
        for package in PACKAGES:
            with pytest.raises(ValueError, match='mutually exclusive'):
                FS[package].get_filesystem_and_path_or_paths(
                    'memory://ds', storage_options={'foo': 1},
                    filesystem=fsspec.filesystem('memory'))


class TestUrlListReads:
    @pytest.fixture(scope='class')
    def dataset(self, tmp_path_factory):
        root = str(tmp_path_factory.mktemp('torch_urllist')) + '/ds'
        url = 'file://' + root
        _write('torch', url, 40, rowgroup_size_rows=10, num_files=4)
        info = torch_metadata.ParquetDatasetInfo(url)
        return url, ['file://' + p for p in info.file_paths]

    def test_batch_reader_accepts_file_url_list(self, dataset):
        _, file_urls = dataset
        assert len(file_urls) == 4
        ids = {}
        for package in PACKAGES:
            with BATCH_READERS[package](file_urls) as reader:
                ids[package] = _ids(reader)
        assert ids['torch'] == ids['jax'] == list(range(40))

    def test_subset_of_files(self, dataset):
        _, file_urls = dataset
        ids = {}
        for package in PACKAGES:
            with BATCH_READERS[package](file_urls[:2]) as reader:
                ids[package] = _ids(reader)
        assert ids['torch'] == ids['jax'] and len(ids['torch']) == 20


class TestMovedDataset:
    @pytest.mark.parametrize('writer', PACKAGES)
    def test_read_after_move(self, tmp_path, writer):
        src = tmp_path / 'original'
        dst = tmp_path / 'relocated'
        _write(writer, 'file://' + str(src), 15, rowgroup_size_rows=5)
        src.rename(dst)
        # metadata is relative: a moved dataset reads unchanged
        ids = {}
        for package in PACKAGES:
            with READERS[package]('file://' + str(dst), shuffle_row_groups=False,
                                  reader_pool_type='dummy') as reader:
                ids[package] = [int(r.id) for r in reader]
        assert ids['torch'] == ids['jax'] == list(range(15))
