"""Dataset materialization and footer metadata, read and write.

Counterpart of ``petastorm_tpu/etl/dataset_metadata.py``. The footer keeps
the same versioned JSON schema key and row-group-count key, so either
package reads what the other wrote, and beside them the original
petastorm's keys: its pickled schema (:mod:`petastorm_tpu_torch.etl.legacy`)
and its row-group counts. So a dataset the original petastorm wrote opens
here, and one written here opens there. A dataset committed by a write
plane (:mod:`petastorm_tpu_torch.write`, or the reference's) is read
through its manifest: the committed file list, never a directory walk.
Not ported yet: Spark.
"""

import collections
import itertools
import json
import logging
import posixpath
import threading
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from urllib.parse import quote, unquote

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from petastorm_tpu_torch.errors import MetadataError, unported
from petastorm_tpu_torch.fs import get_filesystem_and_path_or_paths, normalize_dir_url
from petastorm_tpu_torch.telemetry import span
from petastorm_tpu_torch.unischema import Unischema, dict_to_encoded_row

logger = logging.getLogger(__name__)

UNISCHEMA_KEY = b'petastorm_tpu.unischema.v1'
ROW_GROUPS_PER_FILE_KEY = b'petastorm_tpu.num_row_groups_per_file.v1'
# keys of the original petastorm footer: its pickled schema and its
# row-group counts
LEGACY_UNISCHEMA_KEY = b'dataset-toolkit.unischema.v1'
LEGACY_ROW_GROUPS_PER_FILE_KEY = b'dataset-toolkit.num_row_groups_per_file.v1'
# row-group size bound of the Spark converter (reference default); pass
# it to DatasetWriter(rowgroup_size_mb=...)
DEFAULT_ROW_GROUP_SIZE_MB = 32


class RowGroupPiece:
    """One unit of ventilated work: a single row-group of a single file."""

    __slots__ = ('path', 'row_group', 'partition_values')

    def __init__(self, path, row_group, partition_values=None):
        self.path = path
        self.row_group = row_group
        self.partition_values = partition_values or {}

    def __repr__(self):
        return 'RowGroupPiece(%r, rg=%d)' % (self.path, self.row_group)

    def __eq__(self, other):
        return (isinstance(other, RowGroupPiece)
                and (self.path, self.row_group) == (other.path, other.row_group))

    def __hash__(self):
        return hash((self.path, self.row_group))


def _parse_hive_partitions(relpath):
    """``{key: value}`` from hive-style ``key=value`` directories."""
    parts = {}
    for segment in relpath.split('/')[:-1]:
        if '=' in segment:
            key, _, value = segment.partition('=')
            parts[key] = unquote(value)
    return parts


class ParquetDatasetInfo:
    """Resolved view of a parquet dataset directory: the file inventory,
    hive partitions and lazily read summary footers."""

    def __init__(self, dataset_url_or_urls, storage_options=None, validate=True,
                 filesystem=None):
        self.url = dataset_url_or_urls
        fs, path_or_paths = get_filesystem_and_path_or_paths(
            dataset_url_or_urls, storage_options, filesystem=filesystem)
        self.fs = fs
        if isinstance(path_or_paths, list):
            self.root_path = posixpath.dirname(path_or_paths[0])
            self.file_paths = sorted(path_or_paths)
        else:
            self.root_path = path_or_paths
            self.file_paths = self._discover_files(fs, path_or_paths)
        if validate and not self.file_paths:
            raise MetadataError('No parquet files found under %r' % (dataset_url_or_urls,))
        self._footers = {}
        self._schema = None
        self._lock = threading.Lock()

    def __getstate__(self):
        # crosses the process pool's spawn boundary: the lock stays behind,
        # and the footers and schema are read again where they are needed
        state = self.__dict__.copy()
        del state['_lock']
        state['_footers'] = {}
        state['_schema'] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    @staticmethod
    def _discover_files(fs, root):
        if fs.isfile(root):
            return [root]
        root_norm = root.rstrip('/')
        # a committed manifest is the dataset: one atomic snapshot of its
        # files, so a reader racing a writer or a compaction never sees a
        # torn mix of old and new parts
        from petastorm_tpu_torch.write import manifest as write_manifest
        try:
            committed = write_manifest.load(fs, root_norm)
        except write_manifest.ManifestError as e:
            logger.warning('Ignoring unreadable dataset manifest: %s', e)
            committed = None
        if committed is not None:
            return sorted(write_manifest.committed_paths(committed, root_norm))
        files = []
        for path in fs.find(root):
            rel = posixpath.relpath(path, root_norm)
            # hidden/metadata entries anywhere in the path are not data
            segments = rel.split('/')
            if any(seg.startswith(('.', '_')) for seg in segments):
                continue
            if segments[-1].endswith('.crc'):
                continue
            files.append(path)
        return sorted(files)

    def _summary(self, name):
        """The summary footer file ``name`` (None when absent), read once."""
        with self._lock:
            if name not in self._footers:
                path = posixpath.join(self.root_path, name)
                meta = None
                if self.fs.exists(path):
                    with self.fs.open(path, 'rb') as f:
                        meta = pq.read_metadata(f)
                self._footers[name] = meta
            return self._footers[name]

    @property
    def common_metadata(self):
        return self._summary('_common_metadata')

    @property
    def summary_metadata(self):
        return self._summary('_metadata')

    def invalidate_footers(self):
        with self._lock:
            self._footers.clear()

    @property
    def arrow_schema(self):
        """Physical arrow schema, from the first data file's footer."""
        if self._schema is None:
            with self.fs.open(self.file_paths[0], 'rb') as f:
                self._schema = pq.read_schema(f)
        return self._schema

    def relpath(self, path):
        return posixpath.relpath(path, self.root_path)

    def partition_values_for(self, path):
        return _parse_hive_partitions(self.relpath(path))

    @property
    def partition_keys(self):
        """Hive partition keys over every file, in first-seen order."""
        keys = []
        for path in self.file_paths:
            for k in self.partition_values_for(path):
                if k not in keys:
                    keys.append(k)
        return keys

    def open(self, path):
        return self.fs.open(path, 'rb')


def count_rows(dataset_info_or_url, storage_options=None, footer_scan_workers=8):
    """Total row count of a dataset from its footers alone: the
    ``_metadata`` summary when it has rows, else one footer read a file."""
    info = (dataset_info_or_url if isinstance(dataset_info_or_url, ParquetDatasetInfo)
            else ParquetDatasetInfo(dataset_info_or_url, storage_options))
    summary = info.summary_metadata
    if summary is not None and summary.num_rows:
        return summary.num_rows
    if not info.file_paths:
        return 0

    def rows_in(path):
        with info.open(path) as f:
            return pq.read_metadata(f).num_rows

    with ThreadPoolExecutor(max_workers=min(footer_scan_workers,
                                            len(info.file_paths))) as pool:
        return sum(pool.map(rows_in, info.file_paths))


def load_row_groups(dataset_info, footer_scan_workers=8):
    """All row-groups of a dataset as :class:`RowGroupPiece`s, sorted by
    path then row-group index. Counts come from the footer key, else the
    ``_metadata`` summary, else a scan of every data file's footer."""
    counts = _row_group_counts_from_common_metadata(dataset_info)
    if counts is None:
        counts = _row_group_counts_from_summary(dataset_info)
    if counts is None:
        counts = _row_group_counts_from_footers(dataset_info, footer_scan_workers)
    pieces = []
    for path in dataset_info.file_paths:
        rel = dataset_info.relpath(path)
        if rel not in counts:
            raise MetadataError('No row-group count recorded for file %r' % rel)
        partitions = dataset_info.partition_values_for(path)
        for rg in range(counts[rel]):
            pieces.append(RowGroupPiece(path, rg, partitions))
    return pieces


def _row_group_counts_from_common_metadata(dataset_info):
    cm = dataset_info.common_metadata
    if cm is None or cm.metadata is None:
        return None
    meta = cm.metadata
    raw = meta.get(ROW_GROUPS_PER_FILE_KEY) or meta.get(LEGACY_ROW_GROUPS_PER_FILE_KEY)
    if raw is None:
        return None
    return {k: int(v) for k, v in json.loads(raw.decode('utf-8')).items()}


def _row_group_counts_from_summary(dataset_info):
    summary = dataset_info.summary_metadata
    if summary is None or summary.num_row_groups == 0:
        return None
    counts = {}
    for i in range(summary.num_row_groups):
        file_path = summary.row_group(i).column(0).file_path
        if not file_path:
            return None
        counts[file_path] = counts.get(file_path, 0) + 1
    return counts


def _row_group_counts_from_footers(dataset_info, workers):
    def count(path):
        with dataset_info.open(path) as f:
            return dataset_info.relpath(path), pq.read_metadata(f).num_row_groups

    with ThreadPoolExecutor(max_workers=workers) as pool:
        return dict(pool.map(count, dataset_info.file_paths))


def get_schema(dataset_info):
    """The Unischema stored in the dataset footer."""
    cm = dataset_info.common_metadata
    if cm is None or cm.metadata is None:
        raise MetadataError(
            'Could not find _common_metadata file for %r. Use '
            'materialize_dataset to add petastorm metadata to an existing '
            'dataset.' % dataset_info.url)
    meta = cm.metadata
    if UNISCHEMA_KEY in meta:
        return Unischema.from_json_dict(json.loads(meta[UNISCHEMA_KEY].decode('utf-8')))
    if LEGACY_UNISCHEMA_KEY in meta:
        from petastorm_tpu_torch.etl.legacy import depickle_legacy_unischema
        return depickle_legacy_unischema(meta[LEGACY_UNISCHEMA_KEY])
    raise MetadataError('_common_metadata of %r carries no unischema entry'
                        % dataset_info.url)


def get_schema_from_dataset_url(dataset_url_or_urls, storage_options=None):
    """Unischema of the dataset at a URL."""
    return get_schema(ParquetDatasetInfo(dataset_url_or_urls, storage_options))


def infer_or_load_unischema(dataset_info):
    """The stored Unischema if present, else one inferred from the parquet
    schema (hive partition keys typed from their observed values)."""
    try:
        return get_schema(dataset_info)
    except MetadataError:
        logger.info('Dataset %s has no petastorm metadata; inferring schema from '
                    'the parquet footer', dataset_info.url)
        partition_types = _infer_partition_types(dataset_info)
        return Unischema.from_arrow_schema(
            dataset_info.arrow_schema,
            partition_columns=list(partition_types),
            partition_types=partition_types)


def _infer_partition_types(dataset_info):
    """Numpy dtype per hive partition key: all-integer values become int64,
    all-float values float64, anything else str."""
    observed = {}
    for path in dataset_info.file_paths:
        for key, value in dataset_info.partition_values_for(path).items():
            observed.setdefault(key, set()).add(value)

    def dtype_of(values):
        for dtype in (np.int64, np.float64):
            try:
                for v in values:
                    dtype(v)
                return dtype
            except (TypeError, ValueError, OverflowError):
                continue
        return np.str_

    return {key: dtype_of(values) for key, values in observed.items()}


def add_to_dataset_metadata(dataset_info, key, value):
    """Merge one ``key: value`` entry into the dataset's ``_common_metadata``."""
    update_dataset_metadata(dataset_info, {key: value})


def update_dataset_metadata(dataset_info, entries):
    """Merge ``entries`` into ``_common_metadata`` in one write, keeping the
    existing entries; a stale ``._common_metadata.crc`` left by another
    writer is removed."""
    cm = dataset_info.common_metadata
    if cm is not None:
        base_schema = cm.schema.to_arrow_schema()
        existing = dict(cm.metadata or {})
    else:
        base_schema = dataset_info.arrow_schema
        existing = dict(base_schema.metadata or {})
    for key, value in entries.items():
        existing[key if isinstance(key, bytes) else key.encode()] = (
            value if isinstance(value, bytes) else value.encode())
    path = posixpath.join(dataset_info.root_path, '_common_metadata')
    with dataset_info.fs.open(path, 'wb') as f:
        pq.write_metadata(base_schema.with_metadata(existing), f)
    crc = posixpath.join(dataset_info.root_path, '._common_metadata.crc')
    try:
        if dataset_info.fs.exists(crc):
            dataset_info.fs.rm(crc)
    except (OSError, ValueError):
        pass
    dataset_info.invalidate_footers()


def footer_entries(schema, counts_json):
    """The footer's entries for ``schema`` and its row-group counts: the
    JSON keys, and the original petastorm's pickled schema and counts
    unless the schema has no pickled form (a codec or type the original
    lacks; the dataset is then JSON-only)."""
    entries = {
        ROW_GROUPS_PER_FILE_KEY: counts_json,
        UNISCHEMA_KEY: json.dumps(schema.to_json_dict()).encode('utf-8'),
    }
    from petastorm_tpu_torch.etl.legacy import pickle_unischema_for_reference
    try:
        entries[LEGACY_UNISCHEMA_KEY] = pickle_unischema_for_reference(schema)
        entries[LEGACY_ROW_GROUPS_PER_FILE_KEY] = counts_json
    except MetadataError as e:
        logger.debug('Not writing reference-compatible schema pickle: %s', e)
    return entries


def _write_dataset_footer(dataset_url, schema, storage_options=None):
    info = ParquetDatasetInfo(dataset_url, storage_options)
    counts_json = json.dumps(
        _row_group_counts_from_footers(info, workers=8)).encode('utf-8')
    update_dataset_metadata(info, footer_entries(schema, counts_json))


@contextmanager
def materialize_dataset(dataset_url, schema, row_group_size_mb=None,
                        storage_options=None, spark=None):
    """Run any parquet-producing job in the body; on exit the footer
    (``_common_metadata`` with the schema JSON, the original petastorm's
    pickled schema and the row-group counts) is written. ``row_group_size_mb`` is accepted as the reference accepts it:
    there it only sets a Spark session's parquet block size, and ``spark=``
    (the Spark bridge) is not ported yet."""
    if spark is not None:
        raise unported('materialize_dataset(spark=)', 11)
    yield
    _write_dataset_footer(normalize_dir_url(dataset_url), schema, storage_options)


class DatasetWriter:
    """Writes codec-encoded rows into parquet files with hive partitioning,
    flushing a row-group every ``rowgroup_size_rows`` rows (or
    ``rowgroup_size_mb``). Footer statistics are always written.

    ``workers_count > 1`` encodes :meth:`write_row_dicts` in a thread pool
    of that width (codec encode releases the GIL), rows in input order;
    ``None``/0/1 encode serially. ``sort_by`` names a column the caller
    promises to feed in non-decreasing order: it is stamped into each
    file's footer as parquet sorted-column metadata (the writer does not
    sort). ``filesystem`` is an fsspec filesystem used in place of the
    one the URL names."""

    def __init__(self, dataset_url, schema, rowgroup_size_rows=1000,
                 partition_by=(), file_prefix='part', storage_options=None,
                 rowgroup_size_mb=None, compression='auto',
                 workers_count=None, sort_by=None, filesystem=None):
        self.schema = schema
        self._compression = compression
        self._workers_count = int(workers_count or 0)
        self._encode_pool = None
        self.rowgroup_size_rows = rowgroup_size_rows
        self.rowgroup_size_bytes = (rowgroup_size_mb * 1024 * 1024
                                    if rowgroup_size_mb else None)
        self.partition_by = tuple(partition_by)
        self.sort_by = sort_by
        if sort_by is not None and sort_by not in {f.name for f in schema}:
            raise ValueError('sort_by column %r is not in the schema' % sort_by)
        self._url = normalize_dir_url(dataset_url)
        self._file_prefix = file_prefix
        self.fs, self.root_path = get_filesystem_and_path_or_paths(
            self._url, storage_options, filesystem=filesystem)
        self.fs.makedirs(self.root_path, exist_ok=True)
        self._arrow_schema = pa.schema(
            [pa.field(f.name, f.arrow_storage_type(), nullable=True)
             for f in self.schema if f.name not in self.partition_by])
        self._writers = {}
        self._buffers = {}
        self._buffer_bytes = {}
        self._file_seq = 0
        self._files_written = 0
        self._rows_written = 0
        #: paths of every parquet file this writer has closed
        self.paths_written = []

    def _resolve_compression(self):
        """``'auto'``: NONE for codec-compressed cells (png, jpeg and npz do
        not compress further), SNAPPY elsewhere, keyed by parquet column
        path."""
        if self._compression != 'auto':
            return self._compression
        from petastorm_tpu_torch.codecs import (
            CompressedImageCodec, CompressedNdarrayCodec,
        )
        per_column = {}
        for f in self.schema:
            if f.name in self.partition_by:
                continue
            storage = f.arrow_storage_type()
            if pa.types.is_list(storage) or pa.types.is_large_list(storage):
                key = f.name + '.list.element'
            else:
                key = f.name
            incompressible = isinstance(
                f.codec, (CompressedImageCodec, CompressedNdarrayCodec))
            per_column[key] = 'NONE' if incompressible else 'SNAPPY'
        return per_column

    def _partition_dir(self, row):
        segments = []
        for key in self.partition_by:
            if key not in row:
                raise ValueError('Row is missing partition column %r' % key)
            segments.append('%s=%s' % (key, quote(str(row[key]), safe='')))
        return '/'.join(segments)

    def _sorting_columns(self):
        """Parquet sorted-column metadata for the declared sort key
        (ascending, nulls last), or None; a partition column is not in
        the files."""
        if self.sort_by is None:
            return None
        index = self._arrow_schema.get_field_index(self.sort_by)
        if index < 0:
            return None
        return [pq.SortingColumn(index)]

    def _writer_for(self, part_dir):
        if part_dir not in self._writers:
            directory = posixpath.join(self.root_path, part_dir) if part_dir else self.root_path
            self.fs.makedirs(directory, exist_ok=True)
            path = posixpath.join(directory, '%s-%05d.parquet' % (self._file_prefix, self._file_seq))
            self._file_seq += 1
            sink = self.fs.open(path, 'wb')
            self._writers[part_dir] = (
                pq.ParquetWriter(sink, self._arrow_schema,
                                 compression=self._resolve_compression(),
                                 write_statistics=True,
                                 sorting_columns=self._sorting_columns()),
                sink, path)
            self._buffers[part_dir] = []
        return self._writers[part_dir][0]

    @staticmethod
    def _row_nbytes(encoded):
        total = 0
        for v in encoded.values():
            if isinstance(v, (bytes, bytearray)):
                total += len(v)
            elif isinstance(v, list):
                total += 8 * len(v)
            else:
                total += 8
        return total

    def write_row_dict(self, row_dict):
        with span('encode'):
            encoded = dict_to_encoded_row(self.schema, row_dict)
        self._append_encoded(encoded)

    def _append_encoded(self, encoded):
        part_dir = self._partition_dir(encoded)
        self._writer_for(part_dir)
        buf = self._buffers[part_dir]
        buf.append(encoded)
        if len(buf) >= self.rowgroup_size_rows:
            self._flush(part_dir)
        elif self.rowgroup_size_bytes is not None:
            self._buffer_bytes[part_dir] = (self._buffer_bytes.get(part_dir, 0)
                                            + self._row_nbytes(encoded))
            if self._buffer_bytes[part_dir] >= self.rowgroup_size_bytes:
                self._flush(part_dir)

    def write_row_dicts(self, row_dicts):
        if self._workers_count > 1:
            for encoded in self._encode_parallel(row_dicts):
                self._append_encoded(encoded)
        else:
            for row in row_dicts:
                self.write_row_dict(row)

    def _encode_parallel(self, row_dicts):
        """Encoded rows in input order, ``workers_count`` chunks of 64 rows
        encoding at once; ``row_dicts`` may be a generator (at most
        ``workers_count + 2`` chunks are held). An encode error surfaces
        here as it would serially."""
        if self._encode_pool is None:
            self._encode_pool = ThreadPoolExecutor(
                max_workers=self._workers_count,
                thread_name_prefix='petastorm-tpu-torch-encode')

        def encode_chunk(part):
            with span('encode'):
                return [dict_to_encoded_row(self.schema, r) for r in part]

        rows_iter = iter(row_dicts)
        pending = collections.deque()
        while True:
            while len(pending) < self._workers_count + 2:
                part = list(itertools.islice(rows_iter, 64))
                if not part:
                    break
                pending.append(self._encode_pool.submit(encode_chunk, part))
            if not pending:
                break
            for encoded in pending.popleft().result():
                yield encoded

    def new_file(self):
        """Close current files; later rows open fresh parquet files."""
        self._close_writers()

    def _flush(self, part_dir):
        rows = self._buffers[part_dir]
        self._buffer_bytes[part_dir] = 0
        if not rows:
            return
        with span('write_flush'):
            columns = {field.name: pa.array([r[field.name] for r in rows],
                                            type=field.type)
                       for field in self._arrow_schema}
            table = pa.table(columns, schema=self._arrow_schema)
            self._writers[part_dir][0].write_table(table)
        self._rows_written += len(rows)
        self._buffers[part_dir] = []

    def _close_writers(self):
        for part_dir in list(self._writers):
            self._flush(part_dir)
            writer, sink, path = self._writers.pop(part_dir)
            writer.close()
            sink.close()
            self._buffers.pop(part_dir, None)
            self._files_written += 1
            self.paths_written.append(path)

    def _shutdown_encode_pool(self, cancel=False):
        if self._encode_pool is not None:
            self._encode_pool.shutdown(wait=True, cancel_futures=cancel)
            self._encode_pool = None

    def close(self):
        self._shutdown_encode_pool()
        if self._files_written == 0 and not self._writers and not self.partition_by:
            # zero rows: still one (empty) parquet file, a readable store
            self._writer_for('')
        self._close_writers()

    def abort(self):
        """Tear down without publishing: stop the encode pool, close the
        sinks and delete every file this writer opened."""
        self._shutdown_encode_pool(cancel=True)
        opened = []
        for part_dir in list(self._writers):
            writer, sink, path = self._writers.pop(part_dir)
            try:
                writer.close()
            except Exception:  # noqa: BLE001 - teardown must reach the deletes
                logger.debug('abort: parquet writer close failed for %s', path)
            try:
                sink.close()
            except OSError:
                pass
            opened.append(path)
        for path in opened + self.paths_written:
            try:
                if self.fs.exists(path):
                    self.fs.rm(path)
            except (OSError, ValueError):
                pass
        self.paths_written = []
        self._buffers = {}
        self._buffer_bytes = {}

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is None:
            self.close()
        else:
            self.abort()


def write_dataset(dataset_url, schema, rows, rowgroup_size_rows=1000,
                  num_files=1, partition_by=(), storage_options=None,
                  rowgroup_size_mb=None, workers_count=None):
    """One call: write ``rows`` and the metadata footer; ``workers_count``
    is :class:`DatasetWriter`'s encode width."""
    rows = list(rows)
    with materialize_dataset(dataset_url, schema, storage_options=storage_options):
        with DatasetWriter(dataset_url, schema, rowgroup_size_rows,
                           partition_by, storage_options=storage_options,
                           rowgroup_size_mb=rowgroup_size_mb,
                           workers_count=workers_count) as writer:
            if num_files <= 1:
                writer.write_row_dicts(rows)
            else:
                per_file = max(1, (len(rows) + num_files - 1) // num_files)
                for start in range(0, len(rows), per_file):
                    writer.write_row_dicts(rows[start:start + per_file])
                    writer.new_file()
