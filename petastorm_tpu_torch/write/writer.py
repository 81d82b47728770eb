"""Distributed dataset writer: sharded encode and write over a worker pool,
committed by a manifest swap.

Counterpart of ``petastorm_tpu/write/writer.py`` on the port's pools.
:class:`DistributedDatasetWriter` cuts the rows into shards of
``shard_rows`` and hands each to a :class:`WriteShardWorker`, inline
(``pool=None``) or on a :class:`~petastorm_tpu_torch.workers.dummy_pool.DummyPool`,
:class:`~petastorm_tpu_torch.workers.thread_pool.ThreadPool` or
:class:`~petastorm_tpu_torch.workers.process_pool.ProcessPool`. Every
backend runs the same worker code, so its part files and manifest are the
same bytes (and the reference's, for the same rows and settings).

Exactly-once publication:

1. a shard worker writes its part files under invisible ``.tmp.`` names,
   then renames each onto a deterministic final name
   ``part-g<gen>-s<shard>-<seq>.parquet``;
2. a faulted attempt leaves only tmp litter, and a retry republishes the
   same bytes onto the same names;
3. the writer commits by swapping ``_manifest.json``
   (:mod:`petastorm_tpu_torch.write.manifest`) after the metadata
   footer, so readers see the previous generation or the whole new one.

The footer (``_common_metadata``) carries the unischema JSON and the
row-group counts, and the original petastorm's pickled schema and counts
beside them (:func:`~petastorm_tpu_torch.etl.dataset_metadata.footer_entries`),
as the reference stamps them.
"""

import json
import logging
import os
import posixpath

import pyarrow.parquet as pq

from petastorm_tpu_torch import faults
from petastorm_tpu_torch.errors import unported
from petastorm_tpu_torch.etl.dataset_metadata import (
    DatasetWriter, ParquetDatasetInfo, _row_group_counts_from_common_metadata,
    footer_entries, update_dataset_metadata,
)
from petastorm_tpu_torch.fs import get_filesystem_and_path_or_paths, normalize_dir_url
from petastorm_tpu_torch.telemetry import get_registry, knobs, metrics_disabled, tracing
from petastorm_tpu_torch.unischema import Unischema
from petastorm_tpu_torch.workers import EmptyResultError
from petastorm_tpu_torch.workers.worker_base import WorkerBase
from petastorm_tpu_torch.write import layout, manifest
from petastorm_tpu_torch.write.manifest import TMP_PREFIX

logger = logging.getLogger(__name__)

WRITE_ROWS = 'petastorm_tpu_write_rows_total'
WRITE_BYTES = 'petastorm_tpu_write_bytes_total'
WRITE_FILES = 'petastorm_tpu_write_files_total'

_MB = 1024 * 1024

#: pool classes (and ``reader_pool_type`` names) of pools the port lacks
_UNPORTED_POOLS = ('service', 'ServicePool')


def _default_shard_rows():
    return knobs.get_int('PETASTORM_TPU_WRITE_SHARD_ROWS', 4096, floor=1)


def _default_encode_workers():
    return knobs.get_int('PETASTORM_TPU_WRITE_WORKERS', 0, floor=0)


def _check_pool(pool):
    """The pool the writer runs on: None (inline), a new process pool for
    the name ``'process'`` (as many workers as the reader's default), or an
    instance with the pool contract. A service pool raises the roadmap item
    that ports it."""
    if pool is None:
        return None
    kind = pool if isinstance(pool, str) else type(pool).__name__
    if kind in _UNPORTED_POOLS:
        raise unported('a service pool (%s) for the write plane' % kind, 9)
    if pool == 'process':
        from petastorm_tpu_torch.workers.process_pool import ProcessPool
        return ProcessPool(max(1, min(4, os.cpu_count() or 1)))
    missing = [m for m in ('start', 'ventilate', 'get_results', 'stop', 'join')
               if not hasattr(pool, m)]
    if missing:
        raise ValueError('pool %r lacks pool contract member(s) %s' % (pool, missing))
    return pool


class WriteShardWorker(WorkerBase):
    """Writes one shard of rows as tmp part files and renames them onto
    their deterministic final names.

    ``args``: ``{'dataset_url', 'schema_json', 'generation',
    'rowgroup_size_rows', 'rowgroup_size_mb', 'compression', 'sort_by',
    'encode_workers', 'storage_options'}``. Publishes ``{'shard': id,
    'entries': [manifest file entries]}``."""

    def initialize(self):
        self._schema = Unischema.from_json_dict(self.args['schema_json'])
        self.fs, self.root_path = get_filesystem_and_path_or_paths(
            self.args['dataset_url'], self.args.get('storage_options'))

    def process(self, shard_id, rows):
        a = self.args
        final_prefix = 'part-g%04d-s%05d' % (a['generation'], shard_id)
        if faults.ARMED:
            faults.fault_hit('io.write', key='%s/%s#part' % (self.root_path, final_prefix))
        writer = DatasetWriter(
            a['dataset_url'], self._schema, rowgroup_size_rows=a['rowgroup_size_rows'],
            rowgroup_size_mb=a['rowgroup_size_mb'], compression=a['compression'],
            file_prefix=TMP_PREFIX + final_prefix, sort_by=a['sort_by'],
            workers_count=a['encode_workers'], storage_options=a.get('storage_options'))
        try:
            writer.write_row_dicts(rows)
            writer.close()
        except BaseException:
            writer.abort()
            raise
        entries = []
        total_rows = total_bytes = 0
        for tmp_path in writer.paths_written:
            directory, tmp_name = posixpath.split(tmp_path)
            final_path = posixpath.join(directory, tmp_name[len(TMP_PREFIX):])
            if faults.ARMED:
                faults.fault_hit('io.write', key='%s#rename' % final_path)
            self._publish_part(tmp_path, final_path)
            with self.fs.open(final_path, 'rb') as f:
                meta = pq.read_metadata(f)
            nbytes = int(self.fs.info(final_path)['size'])
            rel = posixpath.relpath(final_path, self.root_path.rstrip('/'))
            entries.append(manifest.file_entry(rel, meta.num_rows, meta.num_row_groups,
                                               nbytes, source='write'))
            total_rows += int(meta.num_rows)
            total_bytes += nbytes
        if not metrics_disabled():
            registry = get_registry()
            registry.counter(WRITE_ROWS).inc(total_rows)
            registry.counter(WRITE_BYTES).inc(total_bytes)
            registry.counter(WRITE_FILES).inc(len(entries))
        self.publish_func({'shard': shard_id, 'entries': entries})

    def _publish_part(self, tmp_path, final_path):
        """Rename one tmp part onto its final name. An occupied name is
        compared byte for byte: the same bytes are a retry's (the
        committed copy stands), other bytes mean a concurrent writer took
        the same generation, which fails loudly."""
        try:
            occupied = self.fs.exists(final_path)
        except (OSError, ValueError):
            occupied = False
        if not occupied:
            self.fs.mv(tmp_path, final_path)
            return
        with self.fs.open(final_path, 'rb') as f:
            committed_bytes = f.read()
        with self.fs.open(tmp_path, 'rb') as f:
            our_bytes = f.read()
        if committed_bytes != our_bytes:
            raise RuntimeError(
                'write: part name collision at %r — a concurrent writer committed '
                'different bytes under this generation\'s deterministic name; re-open '
                'the writer (append=True) to take a fresh generation' % final_path)
        self.fs.rm(tmp_path)


class DistributedDatasetWriter:
    """Dataset writer with a manifest commit, inline or over a pool::

        with DistributedDatasetWriter(url, schema, pool=ThreadPool(4), sort_by='id') as w:
            w.write_row_dicts(rows)
        # exit publishes: part files, metadata footer, manifest commit

    ``pool=None`` runs every shard inline through the same
    :class:`WriteShardWorker`; a port pool (constructed, not started: the
    writer starts and stops it, or the name ``'process'``) distributes
    them, and a service pool raises ``NotImplementedError`` naming its
    roadmap item.
    ``append=True`` stacks a new generation on the committed one;
    ``append=False`` refuses a target that has a manifest.
    """

    def __init__(self, dataset_url, schema, pool=None, shard_rows=None,
                 rowgroup_size_rows=100000, rowgroup_size_mb=None, compression='auto',
                 sort_by=None, append=False, storage_options=None):
        self.schema = schema
        self.sort_by = sort_by
        self._url = normalize_dir_url(dataset_url)
        self._storage_options = storage_options
        self._pool = _check_pool(pool)
        self.fs, self.root_path = get_filesystem_and_path_or_paths(self._url,
                                                                   storage_options)
        self.fs.makedirs(self.root_path, exist_ok=True)
        committed = manifest.load(self.fs, self.root_path)
        if committed is not None and not append:
            raise ValueError(
                'Dataset %r already carries a committed manifest (generation %d); pass '
                'append=True to stack a new generation' % (dataset_url, committed['generation']))
        self._append = bool(append)
        self._base_entries = list(committed['files']) if committed else []
        self.generation = (committed['generation'] if committed else 0) + 1
        if committed and sort_by is None:
            self.sort_by = committed.get('sort_key')
        self._pool_started = False
        self._shard_rows = shard_rows or _default_shard_rows()
        if rowgroup_size_mb is None:
            rowgroup_size_mb = max(1, layout.target_rowgroup_bytes() // _MB)
        self._worker_args = {
            'dataset_url': self._url,
            'schema_json': schema.to_json_dict(),
            'generation': self.generation,
            'rowgroup_size_rows': rowgroup_size_rows,
            'rowgroup_size_mb': rowgroup_size_mb,
            'compression': compression,
            'sort_by': self.sort_by,
            'encode_workers': _default_encode_workers(),
            'storage_options': storage_options,
        }
        self._buffer = []
        self._shards_dispatched = 0
        self._inline_results = []
        self._inline_worker = None
        self.manifest = None  #: the committed manifest, set by close()
        self.last_self_check = None

    # -- dispatch ---------------------------------------------------------

    def write_row_dict(self, row_dict):
        self._buffer.append(row_dict)
        if len(self._buffer) >= self._shard_rows:
            self._dispatch_shard()

    def write_row_dicts(self, row_dicts):
        for row in row_dicts:
            self.write_row_dict(row)

    def _dispatch_shard(self):
        rows, self._buffer = self._buffer, []
        if not rows:
            return
        shard_id = self._shards_dispatched
        self._shards_dispatched += 1
        # one traced item a shard: its encode/write_flush spans join the
        # timeline as a read-path row-group's do
        ctx = tracing.mint(shard_id, epoch=self.generation, shard=shard_id)
        if self._pool is None:
            if self._inline_worker is None:
                self._inline_worker = WriteShardWorker(0, self._inline_results.append,
                                                       self._worker_args)
                self._inline_worker.initialize()
            with tracing.attempt(ctx, 'write-inline-0'):
                self._inline_worker.process(shard_id, rows)
            return
        if not self._pool_started:
            self._pool.start(WriteShardWorker, self._worker_args)
            self._pool_started = True
        if ctx is not None:
            self._pool.ventilate(shard_id=shard_id, rows=rows, **{tracing.TRACE_CTX_KEY: ctx})
        else:
            self._pool.ventilate(shard_id=shard_id, rows=rows)

    def _drain_pool(self):
        """One result a shard. The pool is read until it reports empty, so
        every completion marker, with the metrics delta a process worker
        hangs on it, is read before the pool stops."""
        if self._pool is None:
            return list(self._inline_results)
        results = []
        while self._pool_started:
            try:
                results.append(self._pool.get_results())
            except EmptyResultError:
                break
        if len(results) != self._shards_dispatched:
            raise RuntimeError('write: %d shard results for %d shards dispatched'
                               % (len(results), self._shards_dispatched))
        return results

    # -- commit -----------------------------------------------------------

    def close(self):
        """Flush, drain every shard, write the metadata footer, commit the
        manifest, then (unless ``PETASTORM_TPU_WRITE_SELF_CHECK`` turns it
        off) run the layout self-check on the committed dataset.

        The commit section (rebase onto the latest manifest, footer, swap)
        holds the commit lease: a commit that raced this writer (another
        appender, a compaction fold) keeps its files and this one stacks
        on top."""
        self._dispatch_shard()
        try:
            results = self._drain_pool()
        finally:
            self._stop_pool()
        new_entries = [e for r in results for e in r['entries']]
        if not (self._base_entries or new_entries):
            new_entries = [self._empty_part()]
        with manifest.commit_lock(self.fs, self.root_path):
            latest = manifest.load(self.fs, self.root_path)
            if latest is not None:
                if not self._append:
                    raise manifest.ManifestError(
                        'Dataset %r gained a committed manifest (generation %d) while this '
                        'non-append write ran — refusing to clobber it'
                        % (self._url, latest['generation']))
                self._base_entries = list(latest['files'])
                self.generation = latest['generation'] + 1
                if self.sort_by is None:
                    self.sort_by = latest.get('sort_key')
            built = manifest.build_manifest(self._base_entries + new_entries,
                                            generation=self.generation, sort_key=self.sort_by)
            self._write_footer(built)
            self.manifest = manifest.publish(self.fs, self.root_path, built, locked=True)
        manifest.purge_stale_tmp(self.fs, self.root_path)
        if not knobs.is_disabled('PETASTORM_TPU_WRITE_SELF_CHECK'):
            info = ParquetDatasetInfo(self._url, self._storage_options)
            self.last_self_check = layout.self_check(info, sort_key=self.sort_by)

    def _empty_part(self):
        """A zero-row dataset still commits one (empty) part, a readable
        store."""
        with DatasetWriter(self._url, self.schema,
                           file_prefix='part-g%04d-s00000' % self.generation,
                           sort_by=self.sort_by,
                           storage_options=self._storage_options) as w:
            pass
        path = w.paths_written[0]
        with self.fs.open(path, 'rb') as f:
            meta = pq.read_metadata(f)
        return manifest.file_entry(posixpath.relpath(path, self.root_path.rstrip('/')),
                                   meta.num_rows, meta.num_row_groups,
                                   int(self.fs.info(path)['size']), source='write')

    def _write_footer(self, built):
        """Stamp ``_common_metadata`` (the schema, JSON and pickled, and the
        row-group counts) from the counts the manifest already holds,
        before the manifest swap.
        The counts merge over the previously stamped map, so a reader
        holding an older generation keeps resolving its files."""
        info = ParquetDatasetInfo(self._url, self._storage_options, validate=False)
        # the footer describes the new generation, not the committed one
        info.file_paths = sorted(manifest.committed_paths(built, self.root_path))
        try:
            previous = _row_group_counts_from_common_metadata(info)
        except (OSError, ValueError):
            previous = None
        counts = manifest.merge_footer_counts(self.fs, self.root_path,
                                              manifest.row_group_counts(built), previous)
        counts_json = json.dumps(counts, sort_keys=True).encode('utf-8')
        update_dataset_metadata(info, footer_entries(self.schema, counts_json))

    def dump_trace(self, path):
        """Export this process's flight recorder as Chrome trace-event JSON
        (the write plane's ``Reader.dump_trace``). Returns the event
        count."""
        return tracing.dump_trace(path)

    def _stop_pool(self):
        if self._pool is not None and self._pool_started:
            self._pool_started = False
            self._pool.stop()
            self._pool.join()

    def abort(self):
        """Exception-path teardown: stop the pool and remove this
        generation's litter (tmp files and parts already renamed). The
        committed manifest is untouched: readers never saw this write."""
        self._buffer = []
        try:
            self._stop_pool()
        except Exception:  # noqa: BLE001 - teardown must reach the sweep
            logger.exception('write abort: pool stop failed')
        marker = 'part-g%04d-' % self.generation
        try:
            listing = self.fs.ls(self.root_path, detail=False)
        except (OSError, ValueError):
            return
        for path in listing:
            name = posixpath.basename(path)
            if name.startswith(marker) or name.startswith(TMP_PREFIX + marker):
                try:
                    self.fs.rm(path)
                except (OSError, ValueError):
                    pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is None:
            self.close()
        else:
            self.abort()


def write_dataset_distributed(dataset_url, schema, rows, pool=None, sort_by=None,
                              append=False, shard_rows=None, rowgroup_size_rows=100000,
                              rowgroup_size_mb=None, storage_options=None):
    """One-call distributed materialization; returns the committed
    :class:`DistributedDatasetWriter` (its manifest and self-check)."""
    writer = DistributedDatasetWriter(
        dataset_url, schema, pool=pool, shard_rows=shard_rows,
        rowgroup_size_rows=rowgroup_size_rows, rowgroup_size_mb=rowgroup_size_mb,
        sort_by=sort_by, append=append, storage_options=storage_options)
    with writer:
        writer.write_row_dicts(rows)
    return writer
