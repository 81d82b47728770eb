"""``gs://`` and ``s3://`` on the port, held against the JAX package, with
no network: each protocol is bound to an in-memory fsspec store for the
test (``tests/torch_stub_fs.py``), so everything above the bytes
transport runs as it would on a real bucket.

Case for case with ``tests/test_object_store.py``: each package reads
what the other wrote, URL-list subsets, ``storage_options`` reaching the
store, the loaders, the strict store's refusals, and a ``torch.optim``
loop trained from a ``gs://`` URL list whose bytes moved through ranged
reads. Beyond it, over ``gs://``: every entry point that takes
``storage_options`` forwards them as the JAX package's does; the write
plane's commit, append and fold write a local write's bytes; the commit
lease, the tmp sweep, garbage collection and the decoded cache's key see
no modified time on an object store, in both packages alike;
``copy_dataset`` to and from a bucket; the decoded cache and the
readahead plane; a process-pool read from a store kept on disk.
"""

import hashlib
import os
import posixpath
import time

import fsspec
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from petastorm_tpu.codecs import NdarrayCodec as JaxNdarrayCodec
from petastorm_tpu.codecs import ScalarCodec as JaxScalarCodec
from petastorm_tpu.unischema import Unischema as JaxUnischema
from petastorm_tpu.unischema import UnischemaField as JaxUnischemaField
from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.unischema import Unischema, UnischemaField
from tests.torch_stub_fs import (
    DiskGsStore, fake_object_store_class, registered, strict_store_class,
)
from tests.torch_telemetry_common import telemetry_guard  # noqa: F401 - autouse

PACKAGES = ('jax', 'torch')


class _Package:
    """One package's storage-facing entry points."""

    def __init__(self, name):
        if name == 'jax':
            from petastorm_tpu import materialized_cache, pytorch, reader, write
            from petastorm_tpu.etl import (
                dataset_metadata, metadata_util, petastorm_generate_metadata,
                rowgroup_indexing,
            )
            from petastorm_tpu.etl.rowgroup_indexers import SingleFieldIndexer
            from petastorm_tpu.jax import make_jax_loader as make_loader
            from petastorm_tpu.mixture import engine as mixture_engine
            from petastorm_tpu.mixture import spec as mixture_spec
            from petastorm_tpu.ngram import NGram
            from petastorm_tpu.tools import copy_dataset
            from petastorm_tpu.write import append, compact, manifest
            self.schema = JaxUnischema('SmallSchema', [
                JaxUnischemaField('id', np.int64, (), JaxScalarCodec(pa.int64()), False),
                JaxUnischemaField('vec', np.float32, (4,), JaxNdarrayCodec(), False)])
        else:
            from petastorm_tpu_torch import materialized_cache, pytorch, reader, write
            from petastorm_tpu_torch.device.loader import make_torch_loader as make_loader
            from petastorm_tpu_torch.etl import (
                dataset_metadata, metadata_util, petastorm_generate_metadata,
                rowgroup_indexing,
            )
            from petastorm_tpu_torch.etl.rowgroup_indexers import SingleFieldIndexer
            from petastorm_tpu_torch.mixture import engine as mixture_engine
            from petastorm_tpu_torch.mixture import spec as mixture_spec
            from petastorm_tpu_torch.ngram import NGram
            from petastorm_tpu_torch.tools import copy_dataset
            from petastorm_tpu_torch.write import append, compact, manifest
            self.schema = Unischema('SmallSchema', [
                UnischemaField('id', np.int64, (), ScalarCodec(pa.int64()), False),
                UnischemaField('vec', np.float32, (4,), NdarrayCodec(), False)])
        self.name = name
        self.meta, self.reader, self.write = dataset_metadata, reader, write
        self.make_loader, self.pytorch = make_loader, pytorch
        self.manifest, self.append, self.compact = manifest, append, compact
        self.materialized_cache = materialized_cache
        self.rowgroup_indexing, self.SingleFieldIndexer = rowgroup_indexing, SingleFieldIndexer
        self.metadata_util, self.generate = metadata_util, petastorm_generate_metadata
        self.copy_dataset = copy_dataset.copy_dataset
        self.mixture_engine, self.mixture_spec, self.NGram = mixture_engine, mixture_spec, NGram

    def write_ds(self, url, n, **kwargs):
        self.meta.write_dataset(url, self.schema, _rows(n), **kwargs)

    def batches(self, url, **kwargs):
        kwargs.setdefault('reader_pool_type', 'dummy')
        kwargs.setdefault('shuffle_row_groups', False)
        with self.reader.make_batch_reader(url, num_epochs=1, **kwargs) as reader:
            return [(b.id.tolist(), b.vec.tobytes()) for b in reader]

    def ids(self, url, **kwargs):
        return sorted(i for ids, _ in self.batches(url, **kwargs) for i in ids)


PKG = {name: _Package(name) for name in PACKAGES}


def _rows(n):
    rng = np.random.RandomState(0)
    return [{'id': i, 'vec': rng.rand(4).astype(np.float32)} for i in range(n)]


@pytest.fixture(params=['gs', 's3'])
def object_store(request):
    """The param protocol bound to a fresh fake store; the binding put
    back (or dropped) and the store cleared after."""
    with registered(request.param, fake_object_store_class(request.param)) as cls:
        yield request.param, cls


@pytest.fixture
def gs_store():
    """``gs`` bound to the strict store: a path that lost its bucket or a
    localizing call fails the plane that made it."""
    with registered('gs', strict_store_class('gs')) as cls:
        yield cls


@pytest.fixture
def strict_gs_store():
    with registered('gs', strict_store_class('gs')) as cls:
        cls.reads.clear()
        cls.seeks.clear()
        yield cls


def _store_files(fs, root):
    """``{relative path: sha1 of the bytes}`` of every file under ``root``."""
    out = {}
    for path in fs.find(root):
        with fs.open(path, 'rb') as f:
            out[posixpath.relpath(path, root)] = hashlib.sha1(f.read()).hexdigest()
    return out


# -- the reference's cases, on both packages ---------------------------------------


@pytest.mark.parametrize('writer', PACKAGES)
def test_write_read_round_trip(object_store, writer):
    proto, _ = object_store
    url = proto + '://bucket/datasets/small_' + writer
    PKG[writer].write_ds(url, 30, rowgroup_size_rows=10, num_files=2)
    got = {}
    for name, package in PKG.items():
        # footer metadata resolves over the scheme
        assert set(package.meta.get_schema_from_dataset_url(url).fields) == {'id', 'vec'}
        assert package.meta.count_rows(url) == 30
        got[name] = package.batches(url)
    assert got['torch'] == got['jax']
    assert sorted(i for ids, _ in got['torch'] for i in ids) == list(range(30))


@pytest.mark.parametrize('writer', PACKAGES)
def test_row_reader_and_codec_decode(object_store, writer):
    proto, _ = object_store
    url = proto + '://bucket/rowds_' + writer
    rows = _rows(12)
    PKG[writer].write_ds(url, 12, rowgroup_size_rows=4)
    got = {}
    for name, package in PKG.items():
        with package.reader.make_reader(url, num_epochs=1) as reader:
            got[name] = {int(row.id): row.vec.tobytes() for row in reader}
    assert got['torch'] == got['jax']
    assert len(got['torch']) == 12 and got['torch'][3] == rows[3]['vec'].tobytes()


def test_url_list_reads_file_subset(object_store):
    proto, _ = object_store
    url = proto + '://bucket/listed'
    PKG['torch'].write_ds(url, 40, rowgroup_size_rows=10, num_files=4)
    fs = fsspec.filesystem(proto)
    parts = sorted(p.lstrip('/') for p in fs.ls('/bucket/listed', detail=False)
                   if p.endswith('.parquet'))
    assert len(parts) == 4
    urls = ['%s://%s' % (proto, p) for p in parts[:2]]
    got = {name: package.ids(urls) for name, package in PKG.items()}
    assert got['torch'] == got['jax'] and len(got['torch']) == 20   # the two files' rows


def test_storage_options_reach_the_filesystem(object_store):
    proto, cls = object_store
    url = proto + '://bucket/opts'
    token = {'token': 'fake-%s-credential' % proto}
    PKG['torch'].write_ds(url, 8, rowgroup_size_rows=4, storage_options=token)
    assert any(opts.get('token') == token['token'] for opts in cls.captured_options)
    for name, package in PKG.items():
        cls.captured_options.clear()
        assert len(package.ids(url, storage_options=token)) == 8
        assert cls.captured_options and all(opts == token for opts in cls.captured_options), \
            (name, cls.captured_options)


def test_torch_loader_over_object_store(object_store):
    """``make_torch_loader`` over the store: the batches ``make_jax_loader``
    gives, on the dummy pool in ventilation order."""
    proto, _ = object_store
    url = proto + '://bucket/loaderds'
    PKG['torch'].write_ds(url, 32, rowgroup_size_rows=8)
    got = {}
    for name, package in PKG.items():
        kwargs = {} if name == 'jax' else {'device': 'cpu'}
        with package.make_loader(url, batch_size=8, num_epochs=1, last_batch='short',
                                 reader_pool_type='dummy', shuffle_row_groups=False,
                                 **kwargs) as loader:
            got[name] = [(np.asarray(b['id']).tolist(), np.asarray(b['vec'])) for b in loader]
    assert [ids for ids, _ in got['torch']] == [ids for ids, _ in got['jax']]
    assert sum(len(ids) for ids, _ in got['torch']) == 32
    for (_, a), (_, b) in zip(got['torch'], got['jax']):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


def test_torch_loader_on_a_mesh_over_object_store(gs_store):
    """``make_torch_loader(mesh=)`` on a one-rank gloo group reads the
    store's rows with ``storage_options`` as the unsharded loader does."""
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    url = 'gs://bucket/meshds'
    token = {'token': 'mesh-credential'}
    PKG['torch'].write_ds(url, 32, rowgroup_size_rows=8)
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    dist.init_process_group('gloo', init_method='tcp://127.0.0.1:%d' % port, rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh('cpu', (1,), mesh_dim_names=('dp',))
        gs_store.captured_options.clear()
        with PKG['torch'].make_loader(url, 8, mesh, ('dp',), num_epochs=1,
                                      reader_pool_type='dummy', shuffle_row_groups=False,
                                      storage_options=token, device='cpu') as loader:
            meshed = [b['id'].tolist() for b in loader]
    finally:
        dist.destroy_process_group()
    assert gs_store.captured_options and all(o == token for o in gs_store.captured_options)
    with PKG['torch'].make_loader(url, 8, num_epochs=1, reader_pool_type='dummy',
                                  shuffle_row_groups=False, storage_options=token,
                                  device='cpu') as loader:
        assert meshed == [b['id'].tolist() for b in loader]
    assert sorted(i for b in meshed for i in b) == list(range(32))


def test_strict_store_rejects_local_paths_and_localizing_apis(strict_gs_store):
    fs = fsspec.filesystem('gs')
    with pytest.raises(AssertionError, match='non-bucket'):
        fs.ls('gs://tmp/not-a-bucket-path')
    with pytest.raises(AssertionError, match='localizing'):
        fs.get('gs://bucket/x', '/tmp/x')
    # a URL whose scheme the explicit filesystem does not serve is refused
    # before LocalFileSystem could mangle it into '<cwd>/gs:/bucket/x'
    from petastorm_tpu_torch.fs import get_filesystem_and_path_or_paths
    with pytest.raises(ValueError, match='does not match'):
        get_filesystem_and_path_or_paths('gs://bucket/x', filesystem=fsspec.filesystem('file'))


def test_e2e_train_loop_from_gs_url(strict_gs_store):
    """The port's product path against a remote-semantics store: write to
    ``gs://``, read back through a URL list with ``storage_options`` by
    ``make_torch_loader``, and train with ``torch.optim``; the same batches
    as ``make_jax_loader``'s, bytes through seekable ranged reads."""
    cls = strict_gs_store
    token = {'token': 'fake-gcs-credential'}
    url = 'gs://bucket/train/e2e'
    PKG['torch'].write_ds(url, 64, rowgroup_size_rows=8, num_files=2, storage_options=token)
    fs = fsspec.filesystem('gs')
    parts = sorted(p for p in fs.ls('/bucket/train/e2e', detail=False)
                   if p.endswith('.parquet'))
    assert len(parts) == 2
    urls = ['gs://%s' % p.lstrip('/') for p in parts]

    cls.reads.clear()
    cls.seeks.clear()
    cls.captured_options.clear()
    torch.manual_seed(0)
    w = torch.zeros(4, requires_grad=True)
    opt = torch.optim.Adam([w], lr=0.2)
    target_w = torch.tensor([1.0, -2.0, 0.5, 3.0])
    losses, ids = [], []
    for _ in range(4):  # four epochs, a loader each over the same urls
        with PKG['torch'].make_loader(urls, batch_size=8, num_epochs=1,
                                      storage_options=token, reader_pool_type='dummy',
                                      shuffle_row_groups=False, device='cpu') as loader:
            for batch in loader:
                vec = batch['vec']
                ids.append(batch['id'].tolist())
                loss = torch.mean((vec @ w - vec @ target_w) ** 2)
                opt.zero_grad()
                loss.backward()
                opt.step()
                losses.append(loss.item())
    assert len(losses) == 32  # 64 rows / batch 8, four epochs
    assert all(np.isfinite(v) for v in losses)
    assert losses[-1] < losses[0] / 10, losses  # it descended
    with PKG['jax'].make_loader(urls, batch_size=8, num_epochs=1, storage_options=token,
                                reader_pool_type='dummy', shuffle_row_groups=False) as loader:
        assert ids[:8] == [np.asarray(b['id']).tolist() for b in loader]
    # the bytes went through seekable reads of this store, the credential seen
    assert any(p.endswith('.parquet') for p in cls.reads), cls.reads
    assert any(p.endswith('.parquet') and pos > 0 for p, pos, _ in cls.seeks), cls.seeks
    assert any(o.get('token') == token['token'] for o in cls.captured_options)


# -- entry points that take storage_options= --------------------------------------


def _entry_point_calls(package, url, tmp):
    """``{name: call(storage_options)}`` for each of ``package``'s entry
    points that takes ``storage_options`` (directly or as a reader
    kwarg), over the dataset at ``url``."""
    p = PKG[package]
    dst = 'gs://bucket/entry_%s' % package

    def reader(make, **kw):
        def call(so):
            with make(url, num_epochs=1, reader_pool_type='dummy', storage_options=so,
                      **kw) as r:
                return sum(1 for _ in r)
        return call

    def loader(so):
        kw = {} if package == 'jax' else {'device': 'cpu'}
        with p.make_loader(url, 4, num_epochs=1, reader_pool_type='dummy',
                           storage_options=so, **kw) as lo:
            return sum(1 for _ in lo)

    def bridge(so):
        with p.pytorch.DataLoader(p.reader.make_reader(url, num_epochs=1,
                                                       reader_pool_type='dummy',
                                                       storage_options=so),
                                  batch_size=4, **({} if package == 'jax' else
                                                   {'device': 'cpu'})) as lo:
            return sum(1 for _ in lo)

    def mixture(so):
        spec = p.mixture_spec.MixtureSpec([p.mixture_spec.MixtureSource(
            'a', 1, url=url, reader_kwargs={'storage_options': so})])
        readers = p.mixture_engine.build_source_readers(spec, reader_pool_type='dummy')
        for r in readers:
            r.stop()
            r.join()
        return len(readers)

    def writer(so):
        with p.meta.DatasetWriter(dst + '_writer', p.schema, rowgroup_size_rows=4,
                                  storage_options=so) as w:
            w.write_row_dicts(_rows(4))

    def materialize(so):
        with p.meta.materialize_dataset(dst + '_mat', p.schema, storage_options=so):
            with p.meta.DatasetWriter(dst + '_mat', p.schema, storage_options=so) as w:
                w.write_row_dicts(_rows(4))

    def distributed(so):
        p.write.write_dataset_distributed(dst + '_dist', p.schema, _rows(8), shard_rows=4,
                                          storage_options=so)
        p.write.write_dataset_distributed(dst + '_dist', p.schema, _rows(4), append=True,
                                          shard_rows=4, storage_options=so)
        return p.compact.compact_dataset(dst + '_dist', storage_options=so)

    def follower(so):
        follow = p.append.AppendFollower(dst + '_dist0', storage_options=so)
        follow.stop()

    def ngram(so):
        ngram = p.NGram(fields={0: ['^id$'], 1: ['^id$']}, delta_threshold=1,
                        timestamp_field='^id$')
        with p.reader.make_reader(url, ngram=ngram, num_epochs=1,
                                  reader_pool_type='dummy', shuffle_row_groups=False,
                                  storage_options=so) as r:
            return sum(1 for _ in r)

    def indexed(so):
        p.meta.write_dataset(dst + '_idx', p.schema, _rows(8), rowgroup_size_rows=4,
                             storage_options=so)
        return p.rowgroup_indexing.build_rowgroup_index(
            dst + '_idx', [p.SingleFieldIndexer('id_index', 'id')], storage_options=so)

    def regenerated(so):
        p.meta.write_dataset(dst + '_gen', p.schema, _rows(8), rowgroup_size_rows=4,
                             storage_options=so)
        return list(p.generate.generate_petastorm_metadata(dst + '_gen',
                                                           storage_options=so).fields)

    return {
        'ParquetDatasetInfo': lambda so: len(p.meta.ParquetDatasetInfo(url, so).file_paths),
        'count_rows': lambda so: p.meta.count_rows(url, storage_options=so),
        'get_schema_from_dataset_url': lambda so: list(
            p.meta.get_schema_from_dataset_url(url, storage_options=so).fields),
        'make_reader': reader(p.reader.make_reader),
        'make_batch_reader': reader(p.reader.make_batch_reader),
        'ngram_reader': ngram,
        'loader': loader,
        'pytorch_DataLoader': bridge,
        'mixture_source': mixture,
        'write_dataset': lambda so: p.meta.write_dataset(dst + '_wd', p.schema, _rows(4),
                                                          storage_options=so),
        'DatasetWriter': writer,
        'materialize_dataset': materialize,
        'write_dataset_distributed_append_compact': distributed,
        'AppendFollower': follower,
        'build_rowgroup_index': indexed,
        'print_metadata': lambda so: p.metadata_util.print_metadata(
            url, storage_options=so, out=open(os.devnull, 'w')),
        'generate_petastorm_metadata': regenerated,
        'copy_dataset': lambda so: p.copy_dataset(url, dst + '_copy', storage_options=so),
    }


@pytest.mark.parametrize('entry', sorted(_entry_point_calls('torch', 'gs://bucket/x', None)))
def test_entry_points_forward_storage_options(gs_store, entry, tmp_path):
    """Each entry point builds every filesystem it touches with the
    caller's ``storage_options``, as the JAX package's does, and gives the
    same answer."""
    url = 'gs://bucket/entry_source'
    PKG['torch'].write_ds(url, 16, rowgroup_size_rows=4)
    if entry == 'AppendFollower':
        for package in PACKAGES:
            PKG[package].write.write_dataset_distributed(
                'gs://bucket/entry_%s_dist0' % package, PKG[package].schema, _rows(4),
                shard_rows=4)
    got = {}
    for package in PACKAGES:
        token = {'token': 'credential-of-%s' % package}
        gs_store.captured_options.clear()
        result = _entry_point_calls(package, url, tmp_path)[entry](token)
        seen = list(gs_store.captured_options)
        assert seen and all(opts == token for opts in seen), (package, entry, seen)
        if isinstance(result, dict):
            result = sorted(result)
        got[package] = (result, len(seen) > 0)
    assert got['torch'] == got['jax'], got


# -- the write plane on gs:// -----------------------------------------------------


def test_write_plane_commit_append_fold_on_gs(gs_store, tmp_path):
    """``write_dataset_distributed``, an append and a fold on ``gs://``: the
    store holds the bytes a local write holds, in both packages, and each
    package reads the other's folded dataset."""
    kw = dict(shard_rows=16, rowgroup_size_rows=8, sort_by='id')
    rows = _rows(96)
    roots = {}
    for package in PACKAGES:
        p = PKG[package]
        for where in ('gs', 'file'):
            url = ('gs://bucket/wp_%s' % package if where == 'gs'
                   else 'file://%s/wp_%s' % (tmp_path, package))
            p.write.write_dataset_distributed(url, p.schema, rows[:64], **kw)
            p.write.write_dataset_distributed(url, p.schema, rows[64:], append=True, **kw)
            p.compact.compact_dataset(url, minimum=2)
            roots[package, where] = url
    files = {}
    for (package, where), url in roots.items():
        fs, root = PKG['torch'].meta.ParquetDatasetInfo(url, validate=False).fs, None
        root = url.split('://', 1)[1] if where == 'gs' else url[len('file://'):]
        files[package, where] = _store_files(fs, root if where == 'file' else '/' + root)
    meta = {k: v.pop('_common_metadata') for k, v in files.items()}
    assert files['torch', 'gs'] == files['torch', 'file'] == files['jax', 'gs'], files
    assert any(k.endswith('.parquet') for k in files['torch', 'gs'])
    assert '_manifest.json' in files['torch', 'gs']
    assert meta['torch', 'gs'] == meta['torch', 'file']
    for package in PACKAGES:
        for other in PACKAGES:
            assert PKG[package].ids(roots[other, 'gs']) == list(range(96))


class _NoExclusiveCreate(fake_object_store_class('gs')):
    """An object store without exclusive create: ``'xb'`` is refused."""

    def _open(self, path, mode='rb', **kwargs):
        if 'x' in mode:
            raise ValueError('unsupported file mode: %r' % mode)
        return super()._open(path, mode=mode, **kwargs)


@pytest.mark.parametrize('store', ['exclusive-create', 'check-then-create'])
def test_commit_lease_by_exclusive_create(store):
    """fsspec's memory store honours ``'xb'`` (a second create raises
    ``FileExistsError``); a store without it takes the check-then-create
    branch. Either way the second taker waits, in both packages."""
    cls = fake_object_store_class('gs') if store == 'exclusive-create' else _NoExclusiveCreate
    with registered('gs', cls):
        fs = fsspec.filesystem('gs')
        if store == 'exclusive-create':
            with fs.open('/bucket/xb/probe', 'xb') as f:
                f.write(b'1')
            with pytest.raises(FileExistsError):
                fs.open('/bucket/xb/probe', 'xb')
        got = []
        for package in PACKAGES:
            m = PKG[package].manifest
            root = '/bucket/lease_%s' % package
            first = m.CommitLock(fs, root, timeout_s=5)
            second = m.CommitLock(fs, root, timeout_s=0.2)
            first.acquire()
            outcome = [first._held, fs.exists(posixpath.join(root, m.LOCK_NAME))]
            with pytest.raises(m.ManifestError, match='held past'):
                second.acquire()
            first.release()
            second.acquire()
            outcome += [second._held, fs.exists(posixpath.join(root, m.LOCK_NAME))]
            second.release()
            outcome.append(fs.exists(posixpath.join(root, m.LOCK_NAME)))
            got.append(outcome)
        assert got[0] == got[1] == [True, True, True, True, False]


# -- modified times: the reference's behavior on an object store, pinned ----------
#
# Both packages read only ``info()['mtime']``; fsspec's memory store gives
# ``created``, gcsfs ``updated``, s3fs ``LastModified``. So on an object
# store the manifest's staleness is unknown, a stale lease is never
# broken, a young tmp file counts as old, nothing is collected after a
# grace window, and the decoded cache's file key is '<size>-None'. These
# tests hold the port to the JAX package's behavior there; on a local disk
# (an mtime) both packages do the other thing.


def _age(fs, path, where, seconds):
    if where == 'file':
        then = time.time() - seconds
        os.utime(path, (then, then))


@pytest.mark.parametrize('where', ['gs', 'file'])
def test_staleness_and_stale_lease_without_mtime(gs_store, tmp_path, where):
    got = []
    for package in PACKAGES:
        p = PKG[package]
        url = ('gs://bucket/stale_%s' % package if where == 'gs'
               else 'file://%s/stale_%s' % (tmp_path, package))
        p.write.write_dataset_distributed(url, p.schema, _rows(8), shard_rows=8)
        info = p.meta.ParquetDatasetInfo(url)
        fs, root = info.fs, info.root_path
        staleness = p.manifest.staleness_s(fs, root)
        lease = posixpath.join(root, p.manifest.LOCK_NAME)
        with fs.open(lease, 'wb') as f:
            f.write(b'left by a dead committer')
        _age(fs, lease, where, 3600)
        lock = p.manifest.CommitLock(fs, root, timeout_s=0.3, stale_s=60)
        try:
            lock.acquire()
            broken = True
        except p.manifest.ManifestError:
            broken = False
        lock.release()
        got.append((staleness is None, broken))
    assert got[0] == got[1]
    # an object store: no age known, so no staleness and the lease stands
    assert got[1] == ((True, False) if where == 'gs' else (False, True))


@pytest.mark.parametrize('where', ['gs', 'file'])
def test_tmp_sweep_and_gc_without_mtime(gs_store, tmp_path, where):
    got = []
    for package in PACKAGES:
        p = PKG[package]
        url = ('gs://bucket/gc_%s' % package if where == 'gs'
               else 'file://%s/gc_%s' % (tmp_path, package))
        p.write.write_dataset_distributed(url, p.schema, _rows(32), shard_rows=8)
        p.compact.compact_dataset(url, minimum=2)
        info = p.meta.ParquetDatasetInfo(url)
        fs, root = info.fs, info.root_path
        # a young tmp file of a live writer
        with fs.open(posixpath.join(root, p.manifest.TMP_PREFIX + 'young.parquet'), 'wb') as f:
            f.write(b'in flight')
        purged = p.manifest.purge_stale_tmp(fs, root, max_age_s=3600)
        # superseded parts, long past a 60 s grace window on a disk
        for path in fs.find(root):
            _age(fs, path, where, 3600)
        graced = p.manifest.gc_superseded(fs, root, grace_s=60)
        collected = p.manifest.gc_superseded(fs, root, grace_s=0)
        got.append((purged, sorted(graced), sorted(collected), p.ids(url)))
    assert got[0] == got[1]
    purged, graced, collected, ids = got[1]
    assert ids == list(range(32)) and (graced or collected)
    if where == 'gs':
        # no mtime: the young tmp file counts as old, the grace window never ends
        assert (purged, graced) == (1, [])
    else:
        assert (purged, collected) == (0, [])


def test_decoded_cache_key_without_mtime(gs_store, tmp_path):
    """The decoded cache's file key on the store is '<size>-None' in both
    packages (a rewrite of the same size would keep it); the cold and warm
    epochs read the JAX reader's rows, and both packages key alike."""
    url = 'gs://bucket/cached'
    PKG['torch'].write_ds(url, 40, rowgroup_size_rows=10)
    got = {}
    for package in PACKAGES:
        p = PKG[package]
        info = p.meta.ParquetDatasetInfo(url)
        prints = [p.materialized_cache.dataset_file_fingerprint(info, path)
                  for path in info.file_paths]
        keys = []
        get = p.materialized_cache.MaterializedRowGroupCache.get

        def recording_get(self, key, fill, _get=get, _keys=keys):
            _keys.append(key)
            return _get(self, key, fill)

        p.materialized_cache.MaterializedRowGroupCache.get = recording_get
        try:
            epochs = [p.batches(url, cache_type='decoded',
                                cache_location=str(tmp_path / package)) for _ in range(2)]
        finally:
            p.materialized_cache.MaterializedRowGroupCache.get = get
        got[package] = (prints, epochs, [k.rsplit(':', 1)[-1] for k in keys],
                        [k.split(':')[1:4] for k in keys])
    assert got['torch'] == got['jax']
    prints, epochs, suffixes, parts = got['torch']
    size = fsspec.filesystem('gs').info(PKG['torch'].meta.ParquetDatasetInfo(url)
                                        .file_paths[0])['size']
    assert prints == ['%d-None' % size]
    assert epochs[0] == epochs[1] and sorted(i for ids, _ in epochs[0] for i in ids) == \
        list(range(40))
    assert set(suffixes) == {'%d-None' % size} and len(suffixes) == 8   # 4 cold, 4 warm


def test_readahead_over_gs(strict_gs_store, monkeypatch):
    """The readahead plane's ranged reads go through the store (open, seek
    and read of column-chunk ranges), and an epoch with the plane on equals
    the epoch with it off and the JAX reader's."""
    from petastorm_tpu_torch import telemetry
    url = 'gs://bucket/readahead'
    PKG['torch'].write_ds(url, 64, rowgroup_size_rows=8)
    telemetry.reset_for_tests()
    strict_gs_store.seeks.clear()
    on = PKG['torch'].batches(url, reader_pool_type='thread', workers_count=1)
    section = telemetry.pipeline_report().get('readahead') or {}
    monkeypatch.setenv('PETASTORM_TPU_READAHEAD', '0')
    telemetry.refresh()
    off = PKG['torch'].batches(url, reader_pool_type='thread', workers_count=1)
    jax_batches = PKG['jax'].batches(url)
    assert sorted(on) == sorted(off) == sorted(jax_batches)
    assert section.get('hits', 0) > 0 and not section.get('degraded'), section
    assert section.get('coalesced_reads', 0) > 0
    assert any(p.endswith('.parquet') and pos > 0 for p, pos, _ in strict_gs_store.seeks)


def test_pushdown_selectors_and_indexes_over_gs(strict_gs_store):
    """Footer statistics (``filters=``) and a row-group index built and
    selected over the store prune the row-groups the JAX reader prunes."""
    url = 'gs://bucket/selective'
    PKG['torch'].write_ds(url, 64, rowgroup_size_rows=8)
    got = {}
    for package in PACKAGES:
        p = PKG[package]
        if package == 'jax':
            from petastorm_tpu.selectors import SingleIndexSelector
        else:
            from petastorm_tpu_torch.selectors import SingleIndexSelector
        p.rowgroup_indexing.build_rowgroup_index(url, [p.SingleFieldIndexer('id_index', 'id')])
        filtered = p.batches(url, filters=[('id', '<', 20)])
        selected = p.batches(url, rowgroup_selector=SingleIndexSelector('id_index', ['3', '60']))
        got[package] = (filtered, selected)
    assert got['torch'] == got['jax']
    filtered, selected = got['torch']
    assert sorted(i for ids, _ in filtered for i in ids) == list(range(20))
    assert sorted(i for ids, _ in selected for i in ids) == list(range(8)) + list(range(56, 64))


# -- copy_dataset to and from a bucket ----------------------------------------------


def _cells(fs, root):
    """``{id: {column: raw cell}}`` of every part file under ``root``, read
    as plain Parquet (the encoded cells, not decoded values)."""
    out = {}
    for path in fs.find(root):
        if not path.endswith('.parquet'):
            continue
        with fs.open(path, 'rb') as f:
            table = pq.read_table(f)
        for row in table.to_pylist():
            out[row['id']] = row
    return out


def test_copy_dataset_to_gs_and_back(gs_store, tmp_path):
    """``copy_dataset`` from ``file://`` to ``gs://`` and back: every cell's
    bytes as the source's, and as the JAX package's copy's."""
    src = 'file://%s/src' % tmp_path
    PKG['torch'].write_ds(src, 40, rowgroup_size_rows=10, num_files=2)
    local = fsspec.filesystem('file')
    source = _cells(local, src[len('file://'):])
    got = {}
    for package in PACKAGES:
        p = PKG[package]
        there = 'gs://bucket/copy_%s' % package
        back = 'file://%s/back_%s' % (tmp_path, package)
        assert p.copy_dataset(src, there, rowgroup_size_rows=10) == 40
        assert p.copy_dataset(there, back, rowgroup_size_rows=10) == 40
        got[package] = (_cells(fsspec.filesystem('gs'), '/bucket/copy_%s' % package),
                        _cells(local, back[len('file://'):]))
    assert got['torch'][0] == got['torch'][1] == source
    assert got['jax'] == got['torch']


# -- a process-pool read from a store on disk -------------------------------------


def test_process_pool_read_from_a_disk_backed_store(tmp_path):
    """Spawned workers unpickle the reader's filesystem (a ``gs`` store kept
    on disk, built from its ``storage_options``) and read the rows the JAX
    package's thread read reads; no worker imports gcsfs."""
    options = {'root': str(tmp_path / 'objects'), 'token': 'anon'}
    url = 'gs://bucket/pooled'
    with registered('gs', DiskGsStore):
        PKG['torch'].write_ds(url, 60, rowgroup_size_rows=10, num_files=3,
                              storage_options=options)
        assert os.path.isdir(os.path.join(options['root'], 'bucket', 'pooled'))
        with PKG['torch'].reader.make_batch_reader(url, reader_pool_type='process',
                                                   workers_count=2,
                                                   storage_options=options) as reader:
            reports = list(reader._pool.worker_reports)
            assert isinstance(reader.dataset_info.fs, DiskGsStore)
            pooled = sorted((int(i), v.tobytes()) for b in reader
                            for i, v in zip(b.id, b.vec))
        with PKG['jax'].reader.make_batch_reader(url, reader_pool_type='thread',
                                                 workers_count=2, storage_options=options,
                                                 num_epochs=1) as reader:
            threaded = sorted((int(i), v.tobytes()) for b in reader
                              for i, v in zip(b.id, b.vec))
    assert pooled == threaded and [i for i, _ in pooled] == list(range(60))
    assert len(reports) == 2
    for report in reports:
        assert 'gcsfs' not in report['modules'] and 'jax' not in report['modules']
