"""The row-group decode worker: parquet → decoded numpy column batches.

Counterpart of ``petastorm_tpu/arrow_worker.py``. Per ventilated item:
row-group read → shuffle-row-drop partition → codec decode of the kept
rows → hive partition columns → TransformSpec → publish a
:class:`ColumnBatch`. Binary codec columns reach the codecs as zero-copy
views of the Arrow buffers, so fixed-shape ``NdarrayCodec`` and image
columns decode in one native call per row-group; when the consumer
deferred decode, eligible image columns travel still encoded
(:mod:`petastorm_tpu_torch.fused`). With an NGram the worker publishes
one ``{'window', 'item_index', 'epoch', 'last'}`` dict per admitted
window instead of the batch. Predicates, caches, readahead and fault
injection wait for their roadmap items (the Reader refuses them before a
worker starts).
"""

import logging
from collections import OrderedDict

import numpy as np
import pyarrow.parquet as pq

from petastorm_tpu_torch.codecs import (
    CompressedImageCodec, NdarrayCodec, decode_batch_with_nulls,
)
from petastorm_tpu_torch.fused import EncodedImageColumn, alloc_column_slab, count_fallback
from petastorm_tpu_torch.native import PackedCells, binary_cells
from petastorm_tpu_torch.telemetry import span
from petastorm_tpu_torch.workers.worker_base import WorkerBase

logger = logging.getLogger(__name__)

#: bound on the per-worker memo of open parquet files
_PARQUET_FILE_CACHE_MAX = 64


def defer_config_ok(transform_spec, ngram=None):
    """Whether workers may defer image decode: not when a TransformSpec or
    an NGram needs the pixels on the worker (the Reader counts the decline
    once)."""
    return transform_spec is None and ngram is None


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


class RowGroupWorker(WorkerBase):
    """Args (dict): dataset_info, loaded_schema (stored fields to read and
    decode), schema (output schema after the TransformSpec),
    stored_schema, transform_spec, ngram, row_groups, defer_image_decode."""

    def __init__(self, worker_id, publish_func, args):
        super().__init__(worker_id, publish_func, args)
        self._dataset_info = args['dataset_info']
        self._schema = args['schema']
        self._loaded_schema = args['loaded_schema']
        self._stored_schema = args['stored_schema']
        self._transform_spec = args.get('transform_spec')
        self._ngram = args.get('ngram')
        self._row_groups = args['row_groups']
        self._defer_decode = (bool(args.get('defer_image_decode'))
                              and defer_config_ok(self._transform_spec, self._ngram))
        self._parquet_files = OrderedDict()

    def process(self, piece_index, shuffle_row_drop_partition=(0, 1),
                item_index=None, epoch=None):
        batch = self._load_rowgroup(self._row_groups[piece_index],
                                    shuffle_row_drop_partition)
        if batch is None or batch.length == 0:
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
        for f in self._parquet_files.values():
            f.close()
        self._parquet_files = OrderedDict()

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

    def _load_rowgroup(self, piece, drop_partition):
        needed = [f.name for f in self._loaded_schema
                  if f.name in self._stored_schema.fields]
        partition_keys = [k for k in piece.partition_values if k in needed]
        read_columns = [n for n in needed if n not in piece.partition_values]
        pf = self._parquet_file(piece.path)
        with span('io'):
            table = pf.read_row_group(piece.row_group, columns=read_columns)
        num_rows = table.num_rows
        overlap = self._ngram.length - 1 if self._ngram is not None else 0
        row_indices = self._apply_row_drop(np.arange(num_rows), drop_partition, overlap)
        if row_indices.size == 0:
            return None
        select_all = row_indices.size == num_rows
        columns = {}
        with span('decode'):
            for name in read_columns:
                arrow_col = table.column(name)
                selected = arrow_col if select_all else arrow_col.take(row_indices)
                columns[name] = self._decode_column(name, selected)
        count = int(row_indices.size)
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

    def _decode_column(self, name, arrow_col):
        """Arrow column → decoded numpy values: scalars to typed arrays,
        strings to unicode arrays, codec cells through the codec; uniform
        shapes stack to ``(n,) + shape``, ragged values stay object arrays.
        ``NdarrayCodec`` and image cells go to the codec as zero-copy views
        of the Arrow buffers (one batched native call for a fixed shape)."""
        field = self._loaded_schema.fields.get(name) or self._stored_schema.fields.get(name)
        if field is not None and isinstance(field.codec, (CompressedImageCodec, NdarrayCodec)):
            cells = binary_cells(arrow_col)
            if cells is not None:
                if isinstance(field.codec, CompressedImageCodec):
                    return self._image_column(field, cells, arrow_col)
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

    def _image_column(self, field, cells, arrow_col):
        """One image column of one row-group: deferred (an
        :class:`EncodedImageColumn` for the staging fill), decoded into a
        page-aligned slab in one batched call, or per cell."""
        dense_ok = field.shape and not any(d is None for d in field.shape) \
            and isinstance(cells, PackedCells)
        dtype = np.dtype(field.numpy_dtype)
        if self._defer_decode:
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
