"""The row-group decode worker: parquet → decoded numpy column batches.

Counterpart of ``petastorm_tpu/arrow_worker.py``. Per ventilated item:
row-group read → shuffle-row-drop partition → codec decode of the kept
rows → hive partition columns → TransformSpec → publish a
:class:`ColumnBatch`. Under a predicate the read has two phases (late
materialization): the predicate's columns are read, decoded and
evaluated first; the survivors and the row-drop partition are decided;
then only the survivors' rows of the other columns decode (an image
column ships only the survivors' cells when decode is deferred), and a
row-group with no survivor reads nothing more. Binary codec columns reach
the codecs as zero-copy views of the Arrow buffers, so fixed-shape
``NdarrayCodec`` and image
columns decode in one native call per row-group; when the consumer
deferred decode, eligible image columns travel still encoded
(:mod:`petastorm_tpu_torch.fused`). With an NGram the worker publishes
one ``{'window', 'item_index', 'epoch', 'last'}`` dict per admitted
window instead of the batch. With a cache (:mod:`petastorm_tpu_torch.cache`,
:mod:`petastorm_tpu_torch.materialized_cache`) the whole item goes through
``cache.get``: a hit skips the read and the decode; the decoded cache
stores the post-transform batch. The row-group read and decode are the
``io.read`` and ``decode.rowgroup`` faultpoints (:mod:`petastorm_tpu_torch.faults`).
With the readahead plane (:mod:`petastorm_tpu_torch.readahead`) each item
first advances the reader's manager, and a column read is served from the
prefetched bytes when they are there; a miss is the blocking read.
"""

import hashlib
import logging
from collections import OrderedDict

import numpy as np
import pyarrow.parquet as pq

from petastorm_tpu_torch import faults, readahead
from petastorm_tpu_torch.cache import NullCache
from petastorm_tpu_torch.codecs import (
    CompressedImageCodec, NdarrayCodec, decode_batch_with_nulls,
)
from petastorm_tpu_torch.filters import FiltersPredicate
from petastorm_tpu_torch.fused import EncodedImageColumn, alloc_column_slab, count_fallback
from petastorm_tpu_torch.materialized_cache import (
    MaterializedRowGroupCache, dataset_file_fingerprint, decode_fingerprint,
)
from petastorm_tpu_torch.native import PackedCells, binary_cells
from petastorm_tpu_torch.pushdown import LATE_MATERIALIZED_ROWS, fullscan_oracle
from petastorm_tpu_torch.telemetry import get_registry, metrics_disabled, span
from petastorm_tpu_torch.workers.worker_base import WorkerBase

logger = logging.getLogger(__name__)

#: bound on the per-worker memo of open parquet files
_PARQUET_FILE_CACHE_MAX = 64


def defer_config_ok(transform_spec, ngram, cache):
    """Whether workers may defer image decode: not when a TransformSpec or
    an NGram needs the pixels on the worker, nor when a cache must store
    finished batches (the Reader counts the decline once)."""
    return (transform_spec is None and ngram is None
            and (cache is None or isinstance(cache, NullCache)))


def typed_partition_value(field, value):
    """Cast a hive-partition path string to the field's numpy dtype."""
    if field is None or value is None:
        return value
    try:
        dtype = np.dtype(field.numpy_dtype)
    except TypeError:  # e.g. Decimal
        return value
    if dtype.kind in 'iuf':
        try:
            return dtype.type(value)
        except (TypeError, ValueError):
            return value
        except OverflowError as e:
            raise ValueError(
                'Hive partition value %r of field %r does not fit its '
                'declared dtype %s' % (value, field.name, dtype)) from e
    if dtype.kind == 'b':
        return value in (True, 'true', 'True', '1', 1)
    return value


class ColumnBatch:
    """Decoded columns of (a row-drop partition of) one row-group;
    ``item_index``/``epoch`` identify the ventilated item for checkpoints."""

    __slots__ = ('columns', 'length', 'item_index', 'epoch')

    def __init__(self, columns, length, item_index=None, epoch=None):
        self.columns = columns
        self.length = length
        self.item_index = item_index
        self.epoch = epoch

    def row(self, i):
        return {name: col[i] for name, col in self.columns.items()}


class ZeroRowItem:
    """What a worker publishes for a ventilated item that yields no rows
    (its predicate kept none): its provenance only. The reader takes it off
    the results queue and never hands it to a consumer; an in-order
    consumer learns from it that the item is done."""

    __slots__ = ('item_index', 'epoch')

    def __init__(self, item_index, epoch):
        self.item_index = item_index
        self.epoch = epoch


class RowGroupWorker(WorkerBase):
    """Args (dict): dataset_info, loaded_schema (stored fields to read and
    decode), schema (output schema after the TransformSpec),
    stored_schema, transform_spec, cache, ngram, row_groups,
    defer_image_decode, readahead_plan."""

    def __init__(self, worker_id, publish_func, args):
        super().__init__(worker_id, publish_func, args)
        self._dataset_info = args['dataset_info']
        self._schema = args['schema']
        self._loaded_schema = args['loaded_schema']
        self._stored_schema = args['stored_schema']
        self._transform_spec = args.get('transform_spec')
        self._cache = args.get('cache')
        self._ngram = args.get('ngram')
        self._row_groups = args['row_groups']
        self._defer_decode = (bool(args.get('defer_image_decode'))
                              and defer_config_ok(self._transform_spec, self._ngram,
                                                  self._cache))
        self._parquet_files = OrderedDict()
        # the reader's readahead manager, shared by the pool's workers; None
        # when the plane is off or the reader shipped no plan (a cache)
        self._readahead = readahead.attach(args)
        # PETASTORM_TPU_PUSHDOWN=0: decode everything, then filter
        self._fullscan_oracle = fullscan_oracle()
        # the decoded cache's key identity, resolved lazily: the decode
        # fingerprint once per worker, the file's once per file
        self._decode_fp = None
        self._file_fps = {}

    def process(self, piece_index, worker_predicate=None, shuffle_row_drop_partition=(0, 1),
                item_index=None, epoch=None):
        piece = self._row_groups[piece_index]

        def load():
            if self._fullscan_oracle and worker_predicate is not None:
                return self._load_rowgroup_fullscan(piece, worker_predicate,
                                                    shuffle_row_drop_partition, item_index,
                                                    epoch)
            return self._load_rowgroup(piece, worker_predicate, shuffle_row_drop_partition,
                                       item_index, epoch)

        key = self._item_cache_key(piece, worker_predicate, shuffle_row_drop_partition)
        batch = load() if key is None else self._cache.get(key, load)
        if batch is None or batch.length == 0:
            if item_index is not None:
                self.publish_func(ZeroRowItem(item_index, epoch))
            return
        if self._ngram is None:
            batch.item_index = item_index
            batch.epoch = epoch
            self.publish_func(batch)
            return
        windows = self._ngram.form_ngram(batch, self._schema)
        for i, window in enumerate(windows):
            # 'last' lets the consumer mark the whole item consumed
            self.publish_func({'window': window, 'item_index': item_index,
                               'epoch': epoch, 'last': i == len(windows) - 1})

    def shutdown(self):
        if self._readahead is not None:
            self._readahead = None
            readahead.release(self.args)
        for f in self._parquet_files.values():
            f.close()
        self._parquet_files = OrderedDict()

    def _item_cache_key(self, piece, worker_predicate, drop_partition):
        """The item's cache key, or None when it reads uncached: no cache,
        an arbitrary predicate (no stable identity; DNF filters have one),
        or a TransformSpec the cache may not store. The raw cache never
        stores a transform's output; the decoded cache keys the transform
        by its code and stores the post-transform batch."""
        cache = self._cache
        if cache is None or isinstance(cache, NullCache):
            return None
        if worker_predicate is not None and not isinstance(worker_predicate, FiltersPredicate):
            return None
        decoded = isinstance(cache, MaterializedRowGroupCache)
        if self._transform_spec is not None and not (decoded and self._spec_cacheable()):
            return None
        key = self._cache_key(piece, worker_predicate, drop_partition)
        if decoded:
            key += ':d%s' % self._decoded_fingerprint(piece)
        return key

    def _cache_key(self, piece, worker_predicate, drop_partition):
        """Dataset URL, file, row-group, drop partition, loaded column set
        (readers with different ``schema_fields`` must not serve each
        other truncated batches) and the filters' clause digest."""
        filter_part = ''
        if worker_predicate is not None:
            filter_part = ':f%s' % hashlib.md5(
                repr(worker_predicate.clauses).encode('utf-8')).hexdigest()
        needed = [f.name for f in self._loaded_schema if f.name in self._stored_schema.fields]
        columns_hash = hashlib.md5(','.join(sorted(needed)).encode('utf-8')).hexdigest()[:12]
        url_hash = hashlib.md5(str(self._dataset_info.url).encode('utf-8')).hexdigest()
        return '%s:%s:rg%d:%s:c%s%s' % (url_hash, self._dataset_info.relpath(piece.path),
                                        piece.row_group, drop_partition, columns_hash,
                                        filter_part)

    def _spec_cacheable(self):
        """May the decoded cache store this TransformSpec's output?
        ``cacheable``: False → never; True → always; None (undeclared) →
        only when the reader asked for the decoded cache, not when the
        fleet knob upgraded it."""
        cacheable = getattr(self._transform_spec, 'cacheable', None)
        if cacheable is not None:
            return cacheable
        return not getattr(self._cache, 'implicit_upgrade', False)

    def _decoded_fingerprint(self, piece):
        """Decode-identity suffix of a decoded-cache key: the schema view
        with its codecs, the TransformSpec and NGram, and the parquet
        file's bytes identity. Any change must miss: a stale decoded batch
        would be silent corruption."""
        if self._decode_fp is None:
            self._decode_fp = decode_fingerprint(self._loaded_schema, self._transform_spec,
                                                 self._ngram)
        file_fp = self._file_fps.get(piece.path)
        if file_fp is None:
            file_fp = self._file_fps[piece.path] = dataset_file_fingerprint(
                self._dataset_info, piece.path)
        return '%s:%s' % (self._decode_fp, file_fp)

    def _parquet_file(self, path):
        pf = self._parquet_files.get(path)
        if pf is None:
            pf = pq.ParquetFile(self._dataset_info.open(path))
            self._parquet_files[path] = pf
            while len(self._parquet_files) > _PARQUET_FILE_CACHE_MAX:
                _, evicted = self._parquet_files.popitem(last=False)
                evicted.close()
        else:
            self._parquet_files.move_to_end(path)
        return pf

    def _columns_of(self, piece):
        """``(partition_keys, file_columns)``: the stored fields to load,
        split by where their values live."""
        needed = [f.name for f in self._loaded_schema if f.name in self._stored_schema.fields]
        return ([k for k in piece.partition_values if k in needed],
                [n for n in needed if n not in piece.partition_values])

    def _read_columns(self, pf, piece, columns):
        """One row-group read under the ``io`` span, behind the ``io.read``
        faultpoint keyed ``<path>#rg<n>`` ('#', not ':', the spec
        grammar's separator, so ``match=`` can select one row-group). A
        readahead hit serves the columns zero-copy from the prefetched
        ranges; a miss, or ``PETASTORM_TPU_READAHEAD=0``, reads blocking."""
        if faults.ARMED:
            faults.fault_hit('io.read', key=self._rowgroup_key(piece))
        with span('io'):
            if self._readahead is not None:
                table = self._readahead.serve(pf, piece.path, piece.row_group, columns)
                if table is not None:
                    return table
            return pf.read_row_group(piece.row_group, columns=columns)

    @staticmethod
    def _rowgroup_key(piece):
        return '%s#rg%d' % (piece.path, piece.row_group)

    def _load_rowgroup(self, piece, worker_predicate, drop_partition, item_index=None,
                       epoch=None):
        partition_keys, file_columns = self._columns_of(piece)
        if self._readahead is not None:
            # the clock advances before any read of this item; under a
            # predicate only its columns prefetch (the survivors' other
            # columns stay on demand)
            prefetch = (sorted(worker_predicate.get_fields())
                        if worker_predicate is not None else file_columns)
            self._readahead.observe(item_index, epoch, prefetch)
        pf = self._parquet_file(piece.path)
        keep, pred_columns = None, {}
        if worker_predicate is not None:
            keep, pred_columns = self._predicate_mask(pf, piece, worker_predicate)
            if not keep.any():
                return None
        # the predicate's columns were decoded whole for the mask: the
        # survivors' rows of them are a select, not a second decode
        reuse = {n: pred_columns[n] for n in file_columns if n in pred_columns}
        read_columns = [n for n in file_columns if n not in reuse]
        overlap = self._ngram.length - 1 if self._ngram is not None else 0
        late = keep is not None
        if late:
            # survivors and the row-drop partition are decided before the
            # other columns are read: a partition without survivors reads
            # nothing more
            table, num_rows, candidates = None, len(keep), np.flatnonzero(keep)
        else:
            table = self._read_columns(pf, piece, read_columns)
            num_rows = table.num_rows
            candidates = np.arange(num_rows)
        row_indices = self._apply_row_drop(candidates, drop_partition, overlap)
        if row_indices.size == 0:
            return None
        if late and read_columns:
            table = self._read_columns(pf, piece, read_columns)
        select_all = row_indices.size == num_rows
        if faults.ARMED:
            # inside a decode span, so an injected delay reads as decode time
            with span('decode'):
                faults.fault_hit('decode.rowgroup', key=self._rowgroup_key(piece))
        columns = {}
        if read_columns and late:
            with span('late_materialize'):
                for name in read_columns:
                    columns[name] = self._decode_survivors(name, table.column(name),
                                                           row_indices, select_all)
            if not metrics_disabled():
                get_registry().counter(LATE_MATERIALIZED_ROWS).inc(int(row_indices.size))
        elif read_columns:
            with span('decode'):
                for name in read_columns:
                    arrow_col = table.column(name)
                    selected = arrow_col if select_all else arrow_col.take(row_indices)
                    columns[name] = self._decode_column(name, selected)
        for name, decoded in reuse.items():
            columns[name] = decoded if select_all else decoded[row_indices]
        return self._finish_batch(columns, piece, partition_keys, int(row_indices.size))

    def _finish_batch(self, columns, piece, partition_keys, count):
        """Partition-key columns from the hive path values, then the
        TransformSpec."""
        for name in partition_keys:
            field = self._stored_schema.fields.get(name)
            value = typed_partition_value(field, piece.partition_values[name])
            dtype = np.dtype(field.numpy_dtype) if field is not None else np.dtype(object)
            columns[name] = np.full(count, value,
                                    dtype=dtype if dtype.kind in 'iufb' else object)
        batch = ColumnBatch(columns, count)
        if self._transform_spec is not None:
            with span('transform'):
                batch = self._apply_transform(batch)
        return batch

    def _predicate_columns(self, piece, predicate):
        """The predicate's field names and those of them that live in the
        file (the others are hive partition keys)."""
        pred_fields = sorted(predicate.get_fields())
        missing = [f for f in pred_fields
                   if f not in self._stored_schema.fields and f not in piece.partition_values]
        if missing:
            raise ValueError('Predicate references unknown fields: %s' % missing)
        return pred_fields, [f for f in pred_fields if f not in piece.partition_values]

    def _partition_column(self, piece, name, n):
        field = self._stored_schema.fields.get(name)
        return np.full(n, typed_partition_value(field, piece.partition_values[name]),
                       dtype=object)

    def _evaluate(self, predicate, values, pred_fields, n):
        """The predicate's row mask over ``values``: its columnar form, or
        ``do_include`` row by row when it has none."""
        with span('filter'):
            mask = predicate.do_include_batch({f: values[f] for f in pred_fields})
            if mask is None:
                mask = np.fromiter((predicate.do_include({f: values[f][i] for f in pred_fields})
                                    for i in range(n)), dtype=bool, count=n)
            mask = np.asarray(mask, dtype=bool)
            if mask.shape != (n,):
                raise ValueError('Predicate %s.do_include_batch returned mask of shape %s '
                                 'for %d rows' % (type(predicate).__name__, mask.shape, n))
        return mask

    def _predicate_mask(self, pf, piece, predicate):
        """Phase one of the two-phase read: ``(mask, decoded)``, where
        ``decoded`` holds each predicate file column decoded over the whole
        row-group."""
        pred_fields, file_fields = self._predicate_columns(piece, predicate)
        pred_table = self._read_columns(pf, piece, file_fields)
        with span('decode'):
            decoded = {name: self._decode_column(name, pred_table.column(name),
                                                 allow_defer=False)
                       for name in file_fields}
        n = pred_table.num_rows
        values = dict(decoded)
        for name in pred_fields:
            if name in piece.partition_values:
                values[name] = self._partition_column(piece, name, n)
        return self._evaluate(predicate, values, pred_fields, n), decoded

    def _load_rowgroup_fullscan(self, piece, worker_predicate, drop_partition, item_index=None,
                                epoch=None):
        """The decode-everything-then-filter oracle
        (``PETASTORM_TPU_PUSHDOWN=0``): one read of every needed and
        predicate column, every row decoded, the predicate evaluated on
        the decoded columns and the survivors selected afterwards."""
        partition_keys, file_columns = self._columns_of(piece)
        pred_fields, pred_file_fields = self._predicate_columns(piece, worker_predicate)
        read_columns = list(dict.fromkeys(file_columns + pred_file_fields))
        if self._readahead is not None:
            # the oracle's one read wants the whole union at once
            self._readahead.observe(item_index, epoch, read_columns)
        table = self._read_columns(self._parquet_file(piece.path), piece, read_columns)
        num_rows = table.num_rows
        if faults.ARMED:
            with span('decode'):
                faults.fault_hit('decode.rowgroup', key=self._rowgroup_key(piece))
        with span('decode'):
            decoded = {name: self._decode_column(name, table.column(name), allow_defer=False)
                       for name in read_columns}
        values = dict(decoded)
        for name in pred_fields:
            if name in piece.partition_values:
                values[name] = self._partition_column(piece, name, num_rows)
        mask = self._evaluate(worker_predicate, values, pred_fields, num_rows)
        overlap = self._ngram.length - 1 if self._ngram is not None else 0
        row_indices = self._apply_row_drop(np.flatnonzero(mask), drop_partition, overlap)
        if row_indices.size == 0:
            return None
        select_all = row_indices.size == num_rows
        columns = {name: decoded[name] if select_all else decoded[name][row_indices]
                   for name in file_columns}
        return self._finish_batch(columns, piece, partition_keys, int(row_indices.size))

    @staticmethod
    def _apply_row_drop(row_indices, drop_partition, overlap=0):
        """Keep contiguous split ``j`` of ``k`` of the rows (shuffle
        decorrelation). With an NGram, each split borrows the first
        ``overlap`` (= ngram length - 1) rows of the next, so windows that
        span a split boundary are not lost."""
        j, k = drop_partition
        if k <= 1:
            return row_indices
        parts = np.array_split(row_indices, k)
        selected = parts[j]
        if overlap and j + 1 < k:
            borrow = np.concatenate(parts[j + 1:])[:overlap]
            selected = np.concatenate([selected, borrow])
        return selected

    def _decode_survivors(self, name, arrow_col, row_indices, select_all):
        """Only the surviving rows of one column: an image column packs its
        survivors' encoded cells into one buffer, read straight from the
        Arrow column's, and decodes them in one batched call (or ships them
        still encoded when decode is deferred); other columns ``take``
        their survivors and decode as usual."""
        if select_all:
            return self._decode_column(name, arrow_col)
        field = self._loaded_schema.fields.get(name) or self._stored_schema.fields.get(name)
        if field is not None and isinstance(field.codec, CompressedImageCodec):
            cells = binary_cells(arrow_col)
            if cells is not None:
                survivors = (cells.take(row_indices) if isinstance(cells, PackedCells)
                             else [cells[i] for i in row_indices])
                return self._image_column(field, survivors, arrow_col)
        return self._decode_column(name, arrow_col.take(row_indices))

    def _decode_column(self, name, arrow_col, allow_defer=True):
        """Arrow column → decoded numpy values: scalars to typed arrays,
        strings to unicode arrays, codec cells through the codec; uniform
        shapes stack to ``(n,) + shape``, ragged values stay object arrays.
        ``NdarrayCodec`` and image cells go to the codec as zero-copy views
        of the Arrow buffers (one batched native call for a fixed shape).
        A predicate's columns pass ``allow_defer=False``: predicates
        compare decoded values."""
        field = self._loaded_schema.fields.get(name) or self._stored_schema.fields.get(name)
        if field is not None and isinstance(field.codec, (CompressedImageCodec, NdarrayCodec)):
            cells = binary_cells(arrow_col)
            if cells is not None:
                if isinstance(field.codec, CompressedImageCodec):
                    return self._image_column(field, cells, arrow_col, allow_defer)
                return self._stack(decode_batch_with_nulls(field, cells))
        values = arrow_col.to_pylist()
        if field is not None and field.codec is not None:
            return self._stack(decode_batch_with_nulls(field, values))
        if field is not None and field.shape:
            # list<primitive> column → per-row ndarrays
            return self._stack([None if v is None else np.asarray(v, dtype=field.numpy_dtype)
                                for v in values])
        try:
            out = arrow_col.combine_chunks().to_numpy(zero_copy_only=False)
        except Exception:  # noqa: BLE001 - exotic arrow types stay objects
            out = np.asarray(values, dtype=object)
        if (out.dtype == object and field is not None
                and field.numpy_dtype in (np.str_, np.bytes_)
                and not any(v is None for v in values)):
            out = out.astype(field.numpy_dtype)
        return out

    def _image_column(self, field, cells, arrow_col, allow_defer=True):
        """One image column of one row-group: deferred (an
        :class:`EncodedImageColumn` for the staging fill), decoded into a
        page-aligned slab in one batched call, or per cell."""
        dense_ok = field.shape and not any(d is None for d in field.shape) \
            and isinstance(cells, PackedCells)
        dtype = np.dtype(field.numpy_dtype)
        if self._defer_decode and allow_defer:
            if dense_ok and dtype.kind in 'iuf':
                return EncodedImageColumn(field, cells, owner=arrow_col)
            count_fallback('column-shape')
        if dense_ok:
            try:
                return decode_batch_with_nulls(
                    field, cells, out=alloc_column_slab((len(cells),) + tuple(field.shape),
                                                        dtype))
            except Exception:  # noqa: BLE001 - the slab path is an accelerator
                logger.debug('Dense slab image decode failed; falling back to the per-cell '
                             'path', exc_info=True)
        return self._stack(decode_batch_with_nulls(field, cells))

    @staticmethod
    def _stack(items):
        """Uniform ndarray shapes → one ``(n,) + shape`` array; anything
        ragged or None-bearing → a 1-d object array."""
        if isinstance(items, np.ndarray) and items.dtype.kind not in 'OU':
            return items
        if not len(items):
            return np.empty(0, dtype=object)
        first = items[0]
        if isinstance(first, np.ndarray) and first.dtype.kind not in 'OU':
            shape = first.shape
            if all(isinstance(x, np.ndarray) and x.shape == shape for x in items):
                return np.stack(items)
        if isinstance(first, (int, float, bool, np.generic)) and \
                all(x is not None and not isinstance(x, np.ndarray) for x in items):
            return np.asarray(items)
        out = np.empty(len(items), dtype=object)
        for i, x in enumerate(items):
            out[i] = x
        return out

    def _apply_transform(self, batch):
        """Run the TransformSpec on a pandas view of the whole row-group."""
        import pandas as pd
        spec = self._transform_spec
        frame = pd.DataFrame({name: list(col) for name, col in batch.columns.items()})
        if spec.func is not None:
            frame = spec.func(frame)
        for name in spec.removed_fields:
            if name in frame.columns:
                frame = frame.drop(columns=[name])
        if spec.selected_fields is not None:
            frame = frame[list(spec.selected_fields)]
        columns = {name: self._stack(list(frame[name])) for name in frame.columns}
        return ColumnBatch(columns, len(frame))
