"""The port's write plane (``petastorm_tpu_torch/write``) against the JAX
package's ``petastorm_tpu/write``, on the CPU.

The reference's ``tests/test_write.py`` classes run on both packages in
one process (``package`` is ``jax`` or ``torch``): the manifest, the local
write, the ``DatasetWriter`` lifecycle, the local and thread-pool rows of
the backend parity and write→read contracts, the crash-safety rows that
need no service pool, compaction, append, concurrent commits, layout and
observability. Then the two packages against each other:

* the same seeded rows (an int64 scalar, a float32 ndarray and an 8×8 PNG
  image) written through either package's ``write_dataset_distributed``
  with the same ``shard_rows``, ``rowgroup_size_rows``, ``sort_by`` and
  pool kind give byte-identical part files and ``_manifest.json``, inline
  and on a three-thread pool, and the same ``_common_metadata``: every
  key and value, the original petastorm's pickled schema and counts
  included;
* each package's reader reads the other's committed, appended and
  compacted dataset multiset-exact, and never the parts a compaction
  superseded that are still on disk;
* the port's process pool writes the inline write's bytes, and a service
  pool raises the port's ``unported`` item 9.

Faults and knobs are set through ``monkeypatch``; the guard of
``tests/torch_telemetry_common.py`` disarms both packages after each
test. Readers run on the dummy pool, followers and daemons are stopped
and joined, and staleness and grace windows are driven by file mtimes or
wide bounds, never by a sleep race.
"""

import glob
import hashlib
import json
import os
import threading
import time

import numpy as np
import pyarrow as pa
import pytest

import petastorm_tpu
import petastorm_tpu_torch
from petastorm_tpu import faults as jax_faults
from petastorm_tpu import telemetry as jax_telemetry
from petastorm_tpu.codecs import CompressedImageCodec, NdarrayCodec, ScalarCodec
from petastorm_tpu.unischema import Unischema, UnischemaField
from petastorm_tpu_torch import faults as torch_faults
from petastorm_tpu_torch import telemetry as torch_telemetry
from petastorm_tpu_torch.unischema import Unischema as TorchUnischema

from tests.torch_telemetry_common import telemetry_guard, traced  # noqa: F401 - autouse, fixture


class _Package:
    """One package's write plane and what the tests read it with."""

    def __init__(self, name):
        self.name = name
        if name == 'jax':
            from petastorm_tpu import pushdown, readahead, write
            from petastorm_tpu.errors import NoDataAvailableError
            from petastorm_tpu.etl import dataset_metadata
            from petastorm_tpu.filters import FiltersPredicate
            from petastorm_tpu.fs import get_filesystem_and_path_or_paths
            from petastorm_tpu.reader import make_batch_reader
            from petastorm_tpu.workers.thread_pool import ThreadPool
            from petastorm_tpu.write import append, layout, manifest
            self.telemetry, self.faults = jax_telemetry, jax_faults
            self.schema = SCHEMA
        else:
            from petastorm_tpu_torch import pushdown, readahead, write
            from petastorm_tpu_torch.errors import NoDataAvailableError
            from petastorm_tpu_torch.etl import dataset_metadata
            from petastorm_tpu_torch.filters import FiltersPredicate
            from petastorm_tpu_torch.fs import get_filesystem_and_path_or_paths
            from petastorm_tpu_torch.reader import make_batch_reader
            from petastorm_tpu_torch.workers.thread_pool import ThreadPool
            from petastorm_tpu_torch.write import append, layout, manifest
            self.telemetry, self.faults = torch_telemetry, torch_faults
            self.schema = TorchUnischema.from_json_dict(SCHEMA.to_json_dict())
        self.write, self.manifest, self.layout, self.append = write, manifest, layout, append
        self.pushdown, self.readahead = pushdown, readahead
        self.meta = dataset_metadata
        self.NoDataAvailableError = NoDataAvailableError
        self.FiltersPredicate = FiltersPredicate
        self.fs_of = get_filesystem_and_path_or_paths
        self.make_batch_reader = make_batch_reader
        self.ThreadPool = ThreadPool

    def write_ds(self, url, rows, **kwargs):
        return self.write.write_dataset_distributed(url, self.schema, rows, **kwargs)

    def read_ids(self, url, **kwargs):
        kwargs.setdefault('reader_pool_type', 'dummy')
        with self.make_batch_reader(url, shuffle_row_groups=False, **kwargs) as reader:
            return sorted(int(i) for b in reader for i in b.id)

    def registry(self):
        return self.telemetry.get_registry()


SCHEMA = Unischema('WriteTest', [
    UnischemaField('id', np.int64, (), ScalarCodec(pa.int64()), False),
    UnischemaField('val', np.float64, (), ScalarCodec(pa.float64()), False),
])

#: the byte-parity rows: a scalar, an ndarray and an 8×8 PNG image
IMAGE_SCHEMA = Unischema('WriteImageTest', [
    UnischemaField('id', np.int64, (), ScalarCodec(pa.int64()), False),
    UnischemaField('vec', np.float32, (4,), NdarrayCodec(), False),
    UnischemaField('image', np.uint8, (8, 8, 3), CompressedImageCodec('png'), False),
])

PACKAGES = {name: _Package(name) for name in ('jax', 'torch')}


@pytest.fixture(params=['jax', 'torch'])
def pkg(request):
    return PACKAGES[request.param]


def _rows(n, start=0):
    return [{'id': i, 'val': i * 0.5} for i in range(start, start + n)]


def _image_rows(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{'id': i, 'vec': rng.rand(4).astype(np.float32),
             'image': rng.randint(0, 256, (8, 8, 3)).astype(np.uint8)} for i in range(n)]


def _part_hashes(root):
    return [(os.path.basename(p), hashlib.sha1(open(p, 'rb').read()).hexdigest())
            for p in sorted(glob.glob(os.path.join(str(root), 'part-*')))]


def _url(path):
    return 'file://' + str(path)


@pytest.fixture
def arm(monkeypatch):
    """Arm a fault spec in both packages; the guard disarms them after."""
    def arm(spec):
        monkeypatch.setenv('PETASTORM_TPU_FAULTS', spec)
        jax_telemetry.refresh()
        torch_telemetry.refresh()
    return arm


def _small_file_dataset(pkg, tmp_path, files=6, rows_per=30):
    url = _url(tmp_path)
    for i in range(files):
        pkg.write_ds(url, _rows(rows_per, start=i * rows_per), sort_by='id',
                     shard_rows=rows_per, append=(i > 0))
    return url, files * rows_per


# -- the commit manifest -------------------------------------------------------


class TestManifest:
    def test_bytes_deterministic(self, pkg):
        m = pkg.manifest
        entries = [m.file_entry('b.parquet', 10, 1, 100), m.file_entry('a.parquet', 10, 1, 100)]
        m1 = m.build_manifest(entries, generation=3, sort_key='id')
        m2 = m.build_manifest(list(reversed(entries)), generation=3, sort_key='id')
        assert m.dumps(m1) == m.dumps(m2)
        assert b'time' not in m.dumps(m1)
        assert m.dumps(m1) == PACKAGES['jax'].manifest.dumps(m2)

    def test_swap_must_be_monotonic(self, pkg, tmp_path):
        fs, root = pkg.fs_of(_url(tmp_path))
        pkg.manifest.publish(fs, root, pkg.manifest.build_manifest([], generation=2))
        with pytest.raises(pkg.write.ManifestError, match='not monotonic'):
            pkg.manifest.publish(fs, root, pkg.manifest.build_manifest([], generation=2))
        assert pkg.write.load_manifest(fs, root)['generation'] == 2

    def test_missing_is_none_unparseable_raises(self, pkg, tmp_path):
        fs, root = pkg.fs_of(_url(tmp_path))
        assert pkg.write.load_manifest(fs, root) is None
        (tmp_path / '_manifest.json').write_text('{nope')
        with pytest.raises(pkg.write.ManifestError, match='Unparseable'):
            pkg.write.load_manifest(fs, root)

    def test_staleness_from_file_mtime(self, pkg, tmp_path):
        fs, root = pkg.fs_of(_url(tmp_path))
        assert pkg.write.staleness_s(fs, root) is None
        pkg.manifest.publish(fs, root, pkg.manifest.build_manifest([], generation=1))
        old = time.time() - 100
        os.utime(str(tmp_path / '_manifest.json'), (old, old))
        assert 100 <= pkg.write.staleness_s(fs, root) < 130

    def test_publish_serializes_via_commit_lease(self, pkg, tmp_path):
        fs, root = pkg.fs_of(_url(tmp_path))
        lock_file = tmp_path / '_manifest.lock'
        lock_file.write_bytes(b'held by a live committer')
        with pytest.raises(pkg.write.ManifestError, match='lease'):
            pkg.manifest.publish(fs, root, pkg.manifest.build_manifest([], generation=1),
                                 lock_timeout_s=0.3)
        old = time.time() - 3600
        os.utime(str(lock_file), (old, old))
        with pkg.manifest.CommitLock(fs, root, timeout_s=5.0, stale_s=60.0):
            pass
        assert not lock_file.exists()
        pkg.manifest.publish(fs, root, pkg.manifest.build_manifest([], generation=1))
        assert pkg.write.load_manifest(fs, root)['generation'] == 1
        assert not lock_file.exists()

    def test_load_propagates_transient_io_errors(self, pkg, tmp_path):
        fs, root = pkg.fs_of(_url(tmp_path))
        pkg.manifest.publish(fs, root, pkg.manifest.build_manifest([], generation=1))

        class FlakyFS:
            def exists(self, path):
                return fs.exists(path)

            def open(self, *args, **kwargs):
                raise OSError('transient storage hiccup')

        with pytest.raises(OSError, match='transient'):
            pkg.manifest.load(FlakyFS(), root)
        assert pkg.manifest.load(fs, root)['generation'] == 1

    def test_purge_respects_age_gate(self, pkg, tmp_path):
        fs, root = pkg.fs_of(_url(tmp_path))
        fresh = tmp_path / '.tmp.part-live.parquet'
        fresh.write_bytes(b'x')
        assert pkg.manifest.purge_stale_tmp(fs, root) == 0
        assert fresh.exists()
        assert pkg.manifest.purge_stale_tmp(fs, root, max_age_s=0.0) == 1
        assert not fresh.exists()

    def test_unreadable_manifest_warns_and_walks(self, pkg, tmp_path, caplog):
        url = _url(tmp_path)
        pkg.write_ds(url, _rows(30), shard_rows=30)
        (tmp_path / '_manifest.json').write_text('{nope')
        with caplog.at_level('WARNING'):
            assert pkg.read_ids(url) == list(range(30))
        assert 'unreadable dataset manifest' in caplog.text


# -- local backend and round trip ---------------------------------------------


class TestLocalWrite:
    def test_write_commit_read_round_trip(self, pkg, tmp_path):
        url = _url(tmp_path)
        w = pkg.write_ds(url, _rows(300), sort_by='id', shard_rows=100)
        assert w.manifest['generation'] == 1
        assert all(e['path'].startswith('part-g0001-s') for e in w.manifest['files'])
        assert pkg.read_ids(url) == list(range(300))
        assert {f.name for f in pkg.meta.get_schema(pkg.meta.ParquetDatasetInfo(url))} == \
            {'id', 'val'}

    def test_no_tmp_litter_after_commit(self, pkg, tmp_path):
        pkg.write_ds(_url(tmp_path), _rows(100), shard_rows=40)
        assert glob.glob(str(tmp_path / '.tmp.*')) == []

    def test_zero_row_dataset_commits_cleanly(self, pkg, tmp_path):
        url = _url(tmp_path)
        w = pkg.write_ds(url, [])
        assert w.manifest['generation'] == 1
        assert w.manifest['files'][0]['rows'] == 0
        assert {f.name for f in pkg.meta.get_schema(pkg.meta.ParquetDatasetInfo(url))} == \
            {'id', 'val'}
        with pytest.raises(pkg.NoDataAvailableError):
            pkg.read_ids(url)

    def test_fresh_target_refuses_second_nonappend_write(self, pkg, tmp_path):
        url = _url(tmp_path)
        pkg.write_ds(url, _rows(10))
        with pytest.raises(ValueError, match='append=True'):
            pkg.write.DistributedDatasetWriter(url, pkg.schema)

    def test_abort_on_exception_leaves_no_generation_litter(self, pkg, tmp_path):
        url = _url(tmp_path)
        with pytest.raises(RuntimeError, match='boom'):
            with pkg.write.DistributedDatasetWriter(url, pkg.schema, shard_rows=20) as w:
                w.write_row_dicts(_rows(50))
                raise RuntimeError('boom')
        assert glob.glob(str(tmp_path / 'part-*')) == []
        assert glob.glob(str(tmp_path / '.tmp.*')) == []
        assert pkg.write.load_manifest(*pkg.fs_of(url)) is None

    def test_write_metrics_and_report_section(self, pkg, tmp_path):
        pkg.write_ds(_url(tmp_path), _rows(120), shard_rows=60)
        registry = pkg.registry()
        assert registry.counter_value('petastorm_tpu_write_rows_total') == 120
        assert registry.counter_value('petastorm_tpu_write_files_total') == 2
        assert registry.counter_value('petastorm_tpu_write_commits_total') == 1
        report = pkg.telemetry.pipeline_report()
        assert report['write']['rows_written'] == 120
        assert report['write']['generation'] == 1
        assert any('write plane:' in line
                   for line in pkg.telemetry.format_pipeline_report(report).splitlines())

    def test_report_sections_are_the_references(self, tmp_path):
        """The same write and compaction leave equal ``write`` sections
        and the same formatted line in both packages."""
        got = {}
        for name, p in PACKAGES.items():
            p.telemetry.reset_for_tests()
            url, _ = _small_file_dataset(p, tmp_path / name, files=4, rows_per=20)
            p.write.compact_dataset(url, minimum=2)
            report = p.telemetry.pipeline_report()
            line = [x for x in p.telemetry.format_pipeline_report(report).splitlines()
                    if x.startswith('write plane:')]
            got[name] = (report['write'], line)
        assert got['torch'] == got['jax']
        assert got['torch'][0]['compact_runs'] == 1


# -- DatasetWriter lifecycle and statistics -------------------------------------


class TestDatasetWriterLifecycle:
    def test_exception_path_aborts_not_publishes(self, pkg, tmp_path):
        url = _url(tmp_path / 'ds')
        with pytest.raises(RuntimeError, match='boom'):
            with pkg.meta.DatasetWriter(url, pkg.schema, rowgroup_size_rows=10,
                                        workers_count=2) as w:
                w.write_row_dicts(_rows(25))
                raise RuntimeError('boom')
        assert glob.glob(str(tmp_path / 'ds' / '*.parquet')) == []
        assert w._encode_pool is None

    def test_success_path_still_publishes(self, pkg, tmp_path):
        with pkg.meta.DatasetWriter(_url(tmp_path / 'ds'), pkg.schema,
                                    rowgroup_size_rows=10) as w:
            w.write_row_dicts(_rows(25))
        assert len(w.paths_written) == 1
        assert w._rows_written == 25

    def test_footer_statistics_always_written(self, pkg, tmp_path):
        import pyarrow.parquet as pq
        with pkg.meta.DatasetWriter(_url(tmp_path / 'ds'), pkg.schema, rowgroup_size_rows=10,
                                    sort_by='id') as w:
            w.write_row_dicts(_rows(30))
        meta = pq.read_metadata(w.paths_written[0])
        for rg in range(meta.num_row_groups):
            st = meta.row_group(rg).column(0).statistics
            assert st is not None and st.has_min_max
        assert meta.row_group(0).sorting_columns

    def test_sort_by_unknown_column_rejected(self, pkg, tmp_path):
        with pytest.raises(ValueError, match='not in the schema'):
            pkg.meta.DatasetWriter(_url(tmp_path), pkg.schema, sort_by='nope')

    def test_pushdown_never_declines_no_statistics_on_own_output(self, pkg, tmp_path):
        url = _url(tmp_path)
        pkg.write_ds(url, _rows(200), sort_by='id', shard_rows=50)
        pkg.telemetry.reset_for_tests()
        got = pkg.read_ids(url, predicate=pkg.FiltersPredicate([('id', '<', 20)]))
        assert got == list(range(20))
        summary = pkg.pushdown.planner_summary()
        assert summary['declines'].get('no-statistics', 0) == 0
        assert summary['rowgroups_pruned'] > 0

    @pytest.mark.parametrize('workers', [0, 3])
    def test_writer_bytes_are_the_references(self, tmp_path, workers):
        """``DatasetWriter(workers_count=, sort_by=)`` and ``write_dataset(
        workers_count=)`` write the reference's bytes, and the port counts
        the rows the reference's ``count_rows`` counts."""
        rows = _image_rows(150)
        for name, p in PACKAGES.items():
            schema = (IMAGE_SCHEMA if name == 'jax'
                      else TorchUnischema.from_json_dict(IMAGE_SCHEMA.to_json_dict()))
            with p.meta.DatasetWriter(_url(tmp_path / name / 'w'), schema,
                                      rowgroup_size_rows=32, sort_by='id',
                                      workers_count=workers) as w:
                w.write_row_dicts(iter(rows))
            p.meta.write_dataset(_url(tmp_path / name / 'd'), schema, rows,
                                 rowgroup_size_rows=40, workers_count=workers)
        for sub in ('w', 'd'):
            assert _part_hashes(tmp_path / 'torch' / sub) == _part_hashes(tmp_path / 'jax' / sub)
        from petastorm_tpu.etl.dataset_metadata import count_rows as jax_count_rows
        from petastorm_tpu_torch.etl.dataset_metadata import count_rows
        assert count_rows(_url(tmp_path / 'torch' / 'd')) == \
            jax_count_rows(_url(tmp_path / 'torch' / 'd')) == 150

    def test_add_to_dataset_metadata_merges_one_key(self, tmp_path):
        from petastorm_tpu_torch.etl.dataset_metadata import (
            DEFAULT_ROW_GROUP_SIZE_MB, ParquetDatasetInfo, add_to_dataset_metadata, get_schema,
        )
        from petastorm_tpu.etl import dataset_metadata as jax_meta
        assert DEFAULT_ROW_GROUP_SIZE_MB == jax_meta.DEFAULT_ROW_GROUP_SIZE_MB
        url = _url(tmp_path)
        PACKAGES['torch'].write_ds(url, _rows(20), shard_rows=20)
        add_to_dataset_metadata(ParquetDatasetInfo(url), b'custom.key', b'custom value')
        meta = ParquetDatasetInfo(url).common_metadata.metadata
        assert meta[b'custom.key'] == b'custom value'
        assert jax_meta.ParquetDatasetInfo(url).common_metadata.metadata[b'custom.key'] == \
            b'custom value'
        assert {f.name for f in get_schema(ParquetDatasetInfo(url))} == {'id', 'val'}

    def test_writer_takes_a_local_filesystem(self, tmp_path):
        import fsspec
        url = _url(tmp_path / 'ds')
        with PACKAGES['torch'].meta.DatasetWriter(url, PACKAGES['torch'].schema,
                                                  filesystem=fsspec.filesystem('file')) as w:
            w.write_row_dicts(_rows(5))
        assert len(w.paths_written) == 1
        # any fsspec instance since remote storage was ported: a scheme it
        # does not serve is refused, a bare path writes through it, as in
        # the JAX package
        memory = fsspec.filesystem('memory', skip_instance_cache=True)
        root = '/writer_takes_%s' % tmp_path.name
        try:
            for package in PACKAGES.values():
                with pytest.raises(ValueError, match='does not match'):
                    package.meta.DatasetWriter(url, package.schema, filesystem=memory)
                with package.meta.DatasetWriter('%s/%s' % (root, package.name), package.schema,
                                                filesystem=memory) as w:
                    w.write_row_dicts(_rows(5))
                assert [p.startswith(root) for p in w.paths_written] == [True]
            assert ({p.rsplit('/', 1)[1] for p in memory.find('%s/torch' % root)}
                    == {p.rsplit('/', 1)[1] for p in memory.find('%s/jax' % root)})
        finally:
            if memory.exists(root):
                memory.rm(root, recursive=True)


# -- backend byte parity ---------------------------------------------------------


class TestBackendParity:
    def test_thread_pool_matches_local_bytes(self, pkg, tmp_path):
        rows = _rows(300)
        w_local = pkg.write_ds(_url(tmp_path / 'local'), rows, sort_by='id', shard_rows=75)
        w_thread = pkg.write_ds(_url(tmp_path / 'thread'), rows, sort_by='id', shard_rows=75,
                                pool=pkg.ThreadPool(3))
        assert pkg.manifest.dumps(w_local.manifest) == pkg.manifest.dumps(w_thread.manifest)
        assert _part_hashes(tmp_path / 'local') == _part_hashes(tmp_path / 'thread')

    def test_dummy_pool_matches_local_bytes(self, tmp_path):
        from petastorm_tpu_torch.workers.dummy_pool import DummyPool
        p = PACKAGES['torch']
        rows = _rows(120)
        w_local = p.write_ds(_url(tmp_path / 'local'), rows, shard_rows=50)
        w_dummy = p.write_ds(_url(tmp_path / 'dummy'), rows, shard_rows=50, pool=DummyPool())
        assert p.manifest.dumps(w_local.manifest) == p.manifest.dumps(w_dummy.manifest)
        assert _part_hashes(tmp_path / 'local') == _part_hashes(tmp_path / 'dummy')


@pytest.mark.parametrize('pool', ['local', 'thread'])
def test_parts_and_manifest_are_the_references(tmp_path, pool):
    """The same rows through either package: byte-identical part files and
    manifests, and ``_common_metadata`` equal in every key and value."""
    from petastorm_tpu.etl.dataset_metadata import ParquetDatasetInfo as JaxInfo
    from petastorm_tpu_torch.etl.dataset_metadata import (
        LEGACY_ROW_GROUPS_PER_FILE_KEY, LEGACY_UNISCHEMA_KEY, ROW_GROUPS_PER_FILE_KEY,
        UNISCHEMA_KEY, ParquetDatasetInfo,
    )
    rows = _image_rows(320)
    written = {}
    for name, p in PACKAGES.items():
        schema = (IMAGE_SCHEMA if name == 'jax'
                  else TorchUnischema.from_json_dict(IMAGE_SCHEMA.to_json_dict()))
        written[name] = p.write.write_dataset_distributed(
            _url(tmp_path / name), schema, rows, sort_by='id', shard_rows=96,
            rowgroup_size_rows=32, pool=p.ThreadPool(3) if pool == 'thread' else None)
    parts = _part_hashes(tmp_path / 'torch')
    assert len(parts) == 4 and parts == _part_hashes(tmp_path / 'jax')
    assert (tmp_path / 'torch' / '_manifest.json').read_bytes() == \
        (tmp_path / 'jax' / '_manifest.json').read_bytes()
    assert written['torch'].manifest == written['jax'].manifest
    got = ParquetDatasetInfo(_url(tmp_path / 'torch')).common_metadata.metadata
    want = JaxInfo(_url(tmp_path / 'jax')).common_metadata.metadata
    for key in (UNISCHEMA_KEY, ROW_GROUPS_PER_FILE_KEY):
        assert json.loads(got[key]) == json.loads(want[key])
    assert {LEGACY_UNISCHEMA_KEY, LEGACY_ROW_GROUPS_PER_FILE_KEY} <= set(got)
    assert dict(got) == dict(want)
    assert written['torch'].last_self_check == written['jax'].last_self_check


# -- each package reads the other's committed dataset ---------------------------


@pytest.mark.parametrize('writer,reader', [('jax', 'torch'), ('torch', 'jax')])
def test_each_reader_reads_the_others_commits(tmp_path, writer, reader):
    """A dataset written, appended and compacted by one package reads
    multiset-exact in the other; superseded parts still on disk are never
    read; after the sweep both read it the same."""
    w, r = PACKAGES[writer], PACKAGES[reader]
    url = _url(tmp_path)
    w.write_ds(url, _rows(120), sort_by='id', shard_rows=30)
    w.write_ds(url, _rows(60, start=120), shard_rows=20, append=True)
    assert r.read_ids(url) == list(range(180))
    superseded = {os.path.basename(p) for p in glob.glob(str(tmp_path / 'part-*'))}
    compacted = w.write.compact_dataset(url, minimum=2)
    assert compacted is not None and compacted['generation'] == 3
    on_disk = {os.path.basename(p) for p in glob.glob(str(tmp_path / 'part-*'))}
    assert superseded <= on_disk
    files = {os.path.basename(p) for p in r.meta.ParquetDatasetInfo(url).file_paths}
    assert files == {e['path'] for e in compacted['files']} and not files & superseded
    assert r.read_ids(url) == list(range(180))
    assert r.read_ids(url, max_staleness_s=60) == list(range(180))
    fs, root = r.fs_of(url)
    assert sorted(r.write.gc_superseded(fs, root, grace_s=0)) == sorted(superseded)
    assert w.read_ids(url) == r.read_ids(url) == list(range(180))


def test_packages_commit_onto_each_others_generations(tmp_path):
    """Generations stack across packages: the reference writes, the port
    appends, the reference compacts, the port appends again and a
    compaction by the port folds it; each read is exact in both."""
    jax_pkg, torch_pkg = PACKAGES['jax'], PACKAGES['torch']
    url = _url(tmp_path)
    jax_pkg.write_ds(url, _rows(60), sort_by='id', shard_rows=20)
    w = torch_pkg.write_ds(url, _rows(40, start=60), shard_rows=20, append=True)
    assert w.manifest['generation'] == 2 and w.sort_by == 'id'
    assert jax_pkg.write.compact_dataset(url, minimum=2)['generation'] == 3
    torch_pkg.write_ds(url, _rows(20, start=100), shard_rows=10, append=True)
    torch_pkg.write_ds(url, _rows(20, start=120), shard_rows=10, append=True)
    m = torch_pkg.write.compact_dataset(url, minimum=2)
    assert m['generation'] == 6
    for p in PACKAGES.values():
        assert p.read_ids(url) == list(range(140))


@pytest.mark.parametrize('pool', ['process', 'service', 'jax-process-pool'])
def test_pools_the_port_lacks_raise_item_9(tmp_path, pool):
    """A service pool raises the port's item 9. The process pool is
    ported: named ``'process'``, or as a port ``ProcessPool(2)`` (the case
    that once handed the port the JAX package's pool), it writes the
    inline write's part bytes and manifest."""
    torch_pkg = PACKAGES['torch']
    if pool == 'service':
        with pytest.raises(NotImplementedError, match=r'ROADMAP.md: Queue 1 item 9,'):
            torch_pkg.write_ds(_url(tmp_path), _rows(10), pool=pool)
        assert not os.path.exists(str(tmp_path / '_manifest.json'))
        return
    if pool == 'jax-process-pool':
        from petastorm_tpu_torch.workers.process_pool import ProcessPool
        pool = ProcessPool(2)
    rows = _rows(60)
    inline = torch_pkg.write_ds(_url(tmp_path / 'inline'), rows, shard_rows=20)
    pooled = torch_pkg.write_ds(_url(tmp_path / 'pool'), rows, shard_rows=20, pool=pool)
    assert torch_pkg.manifest.dumps(pooled.manifest) == \
        torch_pkg.manifest.dumps(inline.manifest)
    parts = _part_hashes(tmp_path / 'pool')
    assert len(parts) == 3 and parts == _part_hashes(tmp_path / 'inline')
    assert torch_pkg.read_ids(_url(tmp_path / 'pool')) == list(range(60))


# -- crash safety (the rows without a service pool) ------------------------------


class TestCrashSafety:
    def test_fault_before_part_write_publishes_nothing(self, pkg, tmp_path, arm):
        url = _url(tmp_path)
        arm('io.write:error:1:match=#part')
        with pytest.raises(Exception):
            pkg.write_ds(url, _rows(60), shard_rows=30)
        assert glob.glob(str(tmp_path / 'part-*')) == []
        assert pkg.write.load_manifest(*pkg.fs_of(url)) is None

    def test_faulted_manifest_swap_keeps_previous_generation(self, pkg, tmp_path, arm):
        url = _url(tmp_path)
        pkg.write_ds(url, _rows(100), shard_rows=50)
        arm('io.write:error:1:match=#manifest')
        with pytest.raises(Exception):
            pkg.write_ds(url, _rows(100, start=100), shard_rows=50, append=True)
        fs, root = pkg.fs_of(url)
        assert pkg.write.load_manifest(fs, root)['generation'] == 1
        assert pkg.read_ids(url) == list(range(100))

    @pytest.mark.parametrize('seam', ['#part', '#rename', '#manifest'])
    @pytest.mark.parametrize('pool', ['local', 'thread'])
    def test_append_fault_keeps_previous_generation_readable(self, pkg, tmp_path, arm,
                                                             seam, pool):
        url = _url(tmp_path)
        pkg.write_ds(url, _rows(90), shard_rows=30)
        arm('io.write:error:1:match=%s' % seam)
        with pytest.raises(Exception, match='io.write'):
            pkg.write_ds(url, _rows(60, start=90), shard_rows=30, append=True,
                         pool=pkg.ThreadPool(2) if pool == 'thread' else None)
        fs, root = pkg.fs_of(url)
        assert pkg.write.load_manifest(fs, root)['generation'] == 1
        if pool == 'thread':
            # a shard failed on a pool thread surfaces at close(), after the
            # ``with`` body: its tmp litter stays, invisible, for the next
            # commit's age-gated purge (as in the reference)
            pkg.manifest.purge_stale_tmp(fs, root, max_age_s=0.0)
        assert glob.glob(str(tmp_path / '.tmp.*')) == []
        assert pkg.read_ids(url) == list(range(90))

    def test_faulted_compaction_keeps_previous_generation(self, pkg, tmp_path, arm):
        url, total = _small_file_dataset(pkg, tmp_path, files=4, rows_per=20)
        arm('io.write:error:1:match=#rename')
        with pytest.raises(Exception, match='io.write'):
            pkg.write.compact_dataset(url, minimum=2)
        assert pkg.write.load_manifest(*pkg.fs_of(url))['generation'] == 4
        assert pkg.read_ids(url) == list(range(total))


# -- compaction -------------------------------------------------------------------


class TestCompaction:
    def test_fold_preserves_rows_schema_and_statistics(self, pkg, tmp_path):
        import pyarrow.parquet as pq
        url, total = _small_file_dataset(pkg, tmp_path)
        m = pkg.write.compact_dataset(url, minimum=2)
        assert m is not None
        folded = [e for e in m['files'] if e['source'] == 'compact']
        assert folded and all(e['replaces'] for e in folded)
        assert pkg.read_ids(url) == list(range(total))
        assert {f.name for f in pkg.meta.get_schema(pkg.meta.ParquetDatasetInfo(url))} == \
            {'id', 'val'}
        for e in folded:
            st = pq.read_metadata(str(tmp_path / e['path'])).row_group(0).column(0).statistics
            assert st is not None and st.has_min_max

    def test_concurrent_reader_is_multiset_exact_across_swap(self, pkg, tmp_path):
        url, total = _small_file_dataset(pkg, tmp_path)
        got = []
        with pkg.make_batch_reader(url, shuffle_row_groups=False,
                                   reader_pool_type='dummy') as reader:
            it = iter(reader)
            got.extend(int(i) for i in next(it).id)
            assert pkg.write.compact_dataset(url, minimum=2) is not None
            for batch in it:
                got.extend(int(i) for i in batch.id)
        assert sorted(got) == list(range(total))
        assert pkg.read_ids(url) == list(range(total))

    def test_gc_waits_out_the_grace_window(self, pkg, tmp_path):
        url, total = _small_file_dataset(pkg, tmp_path)
        pkg.write.compact_dataset(url, minimum=2)
        fs, root = pkg.fs_of(url)
        assert pkg.write.gc_superseded(fs, root, grace_s=3600) == []
        assert pkg.write.gc_superseded(fs, root, grace_s=0)
        assert pkg.read_ids(url) == list(range(total))

    def test_gc_grace_measured_from_swap_not_file_age(self, pkg, tmp_path):
        url, total = _small_file_dataset(pkg, tmp_path)
        old = time.time() - 7200
        for p in glob.glob(str(tmp_path / 'part-*')):
            os.utime(p, (old, old))
        assert pkg.write.compact_dataset(url, minimum=2) is not None
        fs, root = pkg.fs_of(url)
        assert pkg.write.gc_superseded(fs, root, grace_s=5.0) == []
        # once the swap itself is older than the window, the sweep runs
        os.utime(str(tmp_path / '_manifest.json'), (old, old))
        assert pkg.write.gc_superseded(fs, root, grace_s=5.0)
        assert pkg.read_ids(url) == list(range(total))

    def test_reader_holding_old_file_list_survives_restamp(self, pkg, tmp_path):
        url, _ = _small_file_dataset(pkg, tmp_path)
        old_paths = list(pkg.meta.ParquetDatasetInfo(url).file_paths)
        assert pkg.write.compact_dataset(url, minimum=2) is not None
        stale = pkg.meta.ParquetDatasetInfo(url, validate=False)
        stale.file_paths = old_paths
        assert len(pkg.meta.load_row_groups(stale)) >= len(old_paths)

    def test_plan_respects_min_files_floor(self, pkg):
        m = pkg.manifest
        committed = m.build_manifest([m.file_entry('a.parquet', 10, 1, 100),
                                      m.file_entry('b.parquet', 10, 1, 100)], generation=1)
        assert pkg.write.plan_compaction(committed, minimum=3) == []
        assert pkg.write.plan_compaction(committed, minimum=2)

    def test_plan_is_the_references(self):
        """Equal plans for the same manifest, at the knobs' defaults and
        at a target that splits the files into several folds."""
        m = PACKAGES['jax'].manifest
        committed = m.build_manifest([m.file_entry('p%02d.parquet' % i, 10, 1, 1000 + 700 * i)
                                      for i in range(12)], generation=4)
        for kwargs in ({}, {'target_bytes': 5000, 'minimum': 2}, {'minimum': 20}):
            assert PACKAGES['torch'].write.plan_compaction(committed, **kwargs) == \
                PACKAGES['jax'].write.plan_compaction(committed, **kwargs)

    def test_nothing_to_fold_returns_none(self, pkg, tmp_path):
        url = _url(tmp_path)
        pkg.write_ds(url, _rows(50), shard_rows=50)
        assert pkg.write.compact_dataset(url, minimum=4) is None

    def test_restores_sort_after_interleaved_appends(self, pkg, tmp_path):
        url = _url(tmp_path)
        pkg.write_ds(url, _rows(50) + _rows(50, start=100), sort_by='id', shard_rows=25)
        pkg.write_ds(url, _rows(50, start=50) + _rows(50, start=150), sort_by='id',
                     shard_rows=25, append=True)
        pkg.write.compact_dataset(url, minimum=2, target_bytes=16 * 1024)
        assert pkg.write.self_check(url, sort_key='id')['stats_coverage'] == 1.0
        assert pkg.read_ids(url) == list(range(200))

    def test_folded_bytes_are_the_references(self, tmp_path):
        """The same appended files folded by either package: the same
        folded part bytes and the same committed manifest."""
        for name, p in PACKAGES.items():
            url, _ = _small_file_dataset(p, tmp_path / name, files=5, rows_per=24)
            p.write.compact_dataset(url, minimum=2)
        assert _part_hashes(tmp_path / 'torch') == _part_hashes(tmp_path / 'jax')
        assert (tmp_path / 'torch' / '_manifest.json').read_bytes() == \
            (tmp_path / 'jax' / '_manifest.json').read_bytes()


# -- bounded-staleness append -----------------------------------------------------


class TestAppend:
    def test_generations_are_monotonic_and_union(self, pkg, tmp_path):
        url = _url(tmp_path)
        w1 = pkg.write_ds(url, _rows(50), shard_rows=50, sort_by='id')
        w2 = pkg.write_ds(url, _rows(50, start=50), shard_rows=50, append=True)
        assert (w1.manifest['generation'], w2.manifest['generation']) == (1, 2)
        assert w2.sort_by == 'id'
        assert len(w2.manifest['files']) == 2
        assert pkg.read_ids(url) == list(range(100))

    def test_reader_staleness_opt_in(self, pkg, tmp_path):
        url = _url(tmp_path)
        bare_url = _url(tmp_path / 'bare')
        pkg.write_ds(url, _rows(30), shard_rows=30)
        assert pkg.read_ids(url, max_staleness_s=5) == list(range(30))
        with pkg.meta.DatasetWriter(bare_url, pkg.schema) as w:
            w.write_row_dicts(_rows(10))
        with pytest.raises(ValueError, match='committed manifest'):
            pkg.make_batch_reader(bare_url, max_staleness_s=5)
        part = glob.glob(str(tmp_path / 'part-*'))[0]
        with pytest.raises(ValueError, match='committed manifest'):
            pkg.make_batch_reader(['file://' + part], max_staleness_s=5)

    def test_follower_picks_up_rows_within_bound(self, pkg, tmp_path):
        url = _url(tmp_path)
        pkg.write_ds(url, _rows(60), shard_rows=30)
        seen = []
        arrived = threading.Event()
        follower = pkg.write.AppendFollower(url, max_staleness_s=0.4)

        def consume():
            for batch in follower:
                seen.extend(int(i) for i in batch.id)
                if len(seen) >= 100:
                    arrived.set()

        thread = threading.Thread(target=consume, name='test-follower')
        thread.start()
        try:
            deadline = time.monotonic() + 30
            while len(seen) < 60 and time.monotonic() < deadline:
                time.sleep(0.02)
            committed_at = time.monotonic()
            pkg.write_ds(url, _rows(40, start=60), shard_rows=40, append=True)
            assert arrived.wait(30)
            # the bound (0.4 s) plus the read, widely
            assert time.monotonic() - committed_at < 10.0
        finally:
            follower.stop()
            thread.join(30)
        assert not thread.is_alive()
        assert sorted(seen) == list(range(100))

    def test_follower_thread_is_stopped_and_joined(self, tmp_path):
        """The port's follower iterates on its own thread when started;
        ``stop()`` ends and joins it between polls."""
        p = PACKAGES['torch']
        url = _url(tmp_path)
        p.write_ds(url, _rows(40), shard_rows=20)
        seen = []
        follower = p.write.AppendFollower(url, max_staleness_s=0.2)
        follower.start(lambda batch: seen.extend(int(i) for i in batch.id))
        try:
            deadline = time.monotonic() + 30
            while len(seen) < 40 and time.monotonic() < deadline:
                time.sleep(0.02)
            p.write_ds(url, _rows(20, start=40), shard_rows=20, append=True)
            while len(seen) < 60 and time.monotonic() < deadline:
                time.sleep(0.02)
        finally:
            follower.stop()
        assert not [t for t in threading.enumerate()
                    if t.name == 'petastorm-tpu-torch-follower']
        assert follower.error is None
        assert sorted(seen) == list(range(60))
        assert follower.generation == 2

    def test_follower_skips_delivered_compaction_folds(self, pkg, tmp_path):
        url, total = _small_file_dataset(pkg, tmp_path, files=4, rows_per=20)
        follower = pkg.write.AppendFollower(url)
        first = follower._fresh_entries()
        assert sorted(e['path'] for e in first) == sorted(
            os.path.basename(p) for p in glob.glob(str(tmp_path / 'part-*')))
        follower._mark_delivered(first)
        assert pkg.write.compact_dataset(url, minimum=2) is not None
        # the fold's rows already flowed through its sources: nothing new
        assert follower._fresh_entries() == []
        assert pkg.read_ids(url) == list(range(total))

    def test_partial_fold_delivers_only_undelivered_sources(self, pkg, tmp_path):
        url = _url(tmp_path)
        pkg.write_ds(url, _rows(40), shard_rows=20, sort_by='id')
        follower = pkg.write.AppendFollower(url)
        first = follower._fresh_entries()
        assert len(first) == 2
        follower._mark_delivered(first)
        pkg.write_ds(url, _rows(40, start=40), shard_rows=40, append=True)
        assert pkg.write.compact_dataset(url, minimum=2) is not None
        fresh = follower._fresh_entries()
        assert fresh and all(e.get('settles') for e in fresh)
        urls = [url.rstrip('/') + '/' + e['path'] for e in fresh]
        assert pkg.read_ids(urls) == list(range(40, 80))
        follower._mark_delivered(fresh)
        pkg.write_ds(url, _rows(10, start=80), shard_rows=10, append=True)
        nxt = follower._fresh_entries()
        assert len(nxt) == 1 and not nxt[0].get('replaces')


# -- concurrent committers ----------------------------------------------------------


class TestCommitConcurrency:
    def test_append_commit_rebases_over_concurrent_compaction(self, pkg, tmp_path):
        url, total = _small_file_dataset(pkg, tmp_path, files=4, rows_per=20)
        w = pkg.write.DistributedDatasetWriter(url, pkg.schema, shard_rows=40, append=True)
        w.write_row_dicts(_rows(40, start=total))
        compacted = pkg.write.compact_dataset(url, minimum=2)
        assert compacted is not None
        w.close()
        assert w.manifest['generation'] == compacted['generation'] + 1
        assert any(e['source'] == 'compact' for e in w.manifest['files'])
        assert pkg.read_ids(url) == list(range(total + 40))

    def test_same_generation_part_collision_fails_loudly(self, pkg, tmp_path):
        url = _url(tmp_path)
        pkg.write_ds(url, _rows(50), shard_rows=50)
        wa = pkg.write.DistributedDatasetWriter(url, pkg.schema, shard_rows=50, append=True)
        wb = pkg.write.DistributedDatasetWriter(url, pkg.schema, shard_rows=50, append=True)
        wa.write_row_dicts(_rows(50, start=50))
        with pytest.raises(RuntimeError, match='collision'):
            wb.write_row_dicts(_rows(50, start=100))
        wa.close()
        assert pkg.read_ids(url) == list(range(100))

    def test_cross_package_collision_fails_loudly(self, tmp_path):
        """The reference and the port racing one generation collide on the
        same deterministic names, and the second fails loudly."""
        url = _url(tmp_path)
        PACKAGES['jax'].write_ds(url, _rows(50), shard_rows=50)
        wa = PACKAGES['jax'].write.DistributedDatasetWriter(
            url, PACKAGES['jax'].schema, shard_rows=50, append=True)
        wb = PACKAGES['torch'].write.DistributedDatasetWriter(
            url, PACKAGES['torch'].schema, shard_rows=50, append=True)
        wa.write_row_dicts(_rows(50, start=50))
        with pytest.raises(RuntimeError, match='collision'):
            wb.write_row_dicts(_rows(50, start=100))
        wa.close()
        assert PACKAGES['torch'].read_ids(url) == list(range(100))


# -- layout -------------------------------------------------------------------------


class TestLayout:
    def test_target_tracks_readahead_window(self, pkg, monkeypatch):
        monkeypatch.setenv('PETASTORM_TPU_READAHEAD_MAX_RANGE_MB', '8')
        assert pkg.layout.target_rowgroup_bytes() == 8 * 1024 * 1024
        monkeypatch.setenv('PETASTORM_TPU_WRITE_ROWGROUP_MB', '4')
        assert pkg.layout.target_rowgroup_bytes() == 4 * 1024 * 1024
        monkeypatch.delenv('PETASTORM_TPU_WRITE_ROWGROUP_MB')
        monkeypatch.delenv('PETASTORM_TPU_READAHEAD_MAX_RANGE_MB')
        assert pkg.layout.target_rowgroup_bytes() == 16 * 1024 * 1024

    def test_sorted_dataset_reports_clean(self, pkg, tmp_path):
        w = pkg.write_ds(_url(tmp_path), _rows(400), sort_by='id', shard_rows=100)
        report = w.last_self_check
        assert report['stats_coverage'] == 1.0
        assert report['predicted_prune_share'] > 0.5
        assert report['coalesce']['fits_window_share'] == 1.0
        assert report['warnings'] == []

    def test_scattered_sort_key_warns(self, pkg, tmp_path):
        url = _url(tmp_path)
        ids = np.random.RandomState(7).permutation(400)
        pkg.write_ds(url, [{'id': int(i), 'val': float(i)} for i in ids], sort_by='id',
                     shard_rows=100)
        report = pkg.write.self_check(url, sort_key='id')
        assert report['predicted_prune_share'] < 0.5
        assert any('prunes only' in warning for warning in report['warnings'])

    def test_self_check_is_the_references(self, tmp_path):
        """Either package's self-check of one dataset gives one report."""
        url = _url(tmp_path)
        PACKAGES['jax'].write_ds(url, _rows(300), sort_by='id', shard_rows=60,
                                 rowgroup_size_rows=20)
        assert PACKAGES['torch'].write.self_check(url, sort_key='id') == \
            PACKAGES['jax'].write.self_check(url, sort_key='id')

    def test_self_check_knob_skips(self, pkg, tmp_path, monkeypatch):
        monkeypatch.setenv('PETASTORM_TPU_WRITE_SELF_CHECK', '0')
        w = pkg.write_ds(_url(tmp_path), _rows(50), shard_rows=50)
        assert w.last_self_check is None

    def test_shard_rows_knob(self, pkg, tmp_path, monkeypatch):
        monkeypatch.setenv('PETASTORM_TPU_WRITE_SHARD_ROWS', '25')
        monkeypatch.setenv('PETASTORM_TPU_WRITE_WORKERS', '2')
        w = pkg.write_ds(_url(tmp_path), _rows(100))
        assert len(w.manifest['files']) == 4
        assert pkg.read_ids(_url(tmp_path)) == list(range(100))


# -- the write->read contract --------------------------------------------------------


class TestWriteReadContract:
    @pytest.mark.parametrize('backend', ['local', 'thread'])
    def test_selective_read_is_index_priced_and_exact(self, pkg, tmp_path, backend):
        url = _url(tmp_path)
        pkg.write_ds(url, _rows(400), sort_by='id', shard_rows=50,
                     pool=pkg.ThreadPool(3) if backend == 'thread' else None)
        pkg.telemetry.reset_for_tests()
        pred = pkg.FiltersPredicate([('id', '>=', 300)])
        got = pkg.read_ids(url, predicate=pred, num_epochs=4, reader_pool_type='thread',
                           workers_count=2)
        assert got == sorted(list(range(300, 400)) * 4)
        summary = pkg.pushdown.planner_summary()
        assert summary['rowgroups_pruned'] > 0
        assert summary['declines'].get('no-statistics', 0) == 0
        registry = pkg.registry()
        hits = registry.counter_value(pkg.readahead.READAHEAD_HITS)
        misses = registry.counter_value(pkg.readahead.READAHEAD_MISSES)
        assert hits + misses > 0
        assert hits / (hits + misses) > 0.8

    def test_full_multiset_parity_against_oracle(self, pkg, tmp_path, monkeypatch):
        url = _url(tmp_path)
        pkg.write_ds(url, _rows(200), sort_by='id', shard_rows=40)
        pred = pkg.FiltersPredicate([('id', 'in', (3, 77, 150, 199))])
        with monkeypatch.context() as m:
            m.setenv('PETASTORM_TPU_PUSHDOWN', '0')
            m.setenv('PETASTORM_TPU_READAHEAD', '0')
            oracle = pkg.read_ids(url, predicate=pred)
        assert pkg.read_ids(url, predicate=pred) == oracle == [3, 77, 150, 199]


# -- observability ---------------------------------------------------------------------


class TestWriteObservability:
    def test_writer_threads_trace_and_dumps_chrome_json(self, pkg, tmp_path, traced,
                                                        monkeypatch):
        monkeypatch.setenv('PETASTORM_TPU_TRACE_SAMPLE', '1')
        pkg.telemetry.refresh()
        w = pkg.write_ds(_url(tmp_path / 'traced'), _rows(40), shard_rows=20)
        out = str(tmp_path / 'write-trace.json')
        assert w.dump_trace(out) > 0
        with open(out) as f:
            doc = json.load(f)
        names = {e.get('name') for e in doc['traceEvents']}
        assert {'encode', 'write_flush'} <= names, names
        assert any((e.get('args') or {}).get('trace_id') for e in doc['traceEvents'])

    def test_append_follower_publishes_staleness_gauge(self, pkg, tmp_path):
        url = _url(tmp_path)
        pkg.write_ds(url, _rows(20), shard_rows=20)
        old = time.time() - 50
        os.utime(str(tmp_path / '_manifest.json'), (old, old))
        follower = pkg.write.AppendFollower(url, max_staleness_s=0.2)
        registry = pkg.registry()
        follower._note_staleness(True)
        assert 50 <= registry.gauge_value(pkg.append.APPEND_STALENESS) < 80
        follower._note_staleness(False)
        assert registry.gauge_value(pkg.append.APPEND_STALENESS) == 0.0

    def test_compaction_daemon_mounts_health_section(self, pkg, tmp_path, monkeypatch):
        monkeypatch.setenv('PETASTORM_TPU_OBS_PORT', '0')
        pkg.telemetry.refresh()
        obs_server = pkg.telemetry.obs_server
        url, total = _small_file_dataset(pkg, tmp_path, files=6, rows_per=30)
        daemon = pkg.write.CompactionDaemon(url, interval_s=0.1, gc_grace_s=600.0)
        daemon.start()
        try:
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and daemon.runs == 0:
                time.sleep(0.05)
            assert daemon.runs >= 1
            section = next(v for k, v in obs_server.build_health()['components'].items()
                           if k.startswith('compaction-daemon'))
            assert section['dataset_url'] == url
            assert section['runs'] >= 1 and section['generation'] >= 7
        finally:
            daemon.stop()
        assert not any(k.startswith('compaction-daemon')
                       for k in obs_server.build_health()['components'])
        assert pkg.read_ids(url) == list(range(total))


def test_write_exports_are_the_references():
    import petastorm_tpu.write as jax_write
    import petastorm_tpu_torch.write as torch_write
    assert torch_write.__all__ == jax_write.__all__
    assert all(hasattr(torch_write, name) for name in torch_write.__all__)
    assert hasattr(petastorm_tpu, 'make_batch_reader') and \
        hasattr(petastorm_tpu_torch, 'make_batch_reader')
