"""PyTorch bridge: readers → torch tensor batches on the card.

Counterpart of ``petastorm_tpu/pytorch.py``: dtype sanitization,
Decimal-tolerant collation, a row :class:`DataLoader` over ``make_reader``
and a :class:`BatchedDataLoader` over ``make_batch_reader`` with optional
in-memory epoch replay, both on the shared shuffling buffers
(:mod:`petastorm_tpu_torch.buffers`).

The port's one change is where batches land. Both loaders take
``device=None``, which means the card (and raises without CUDA), as
:func:`~petastorm_tpu_torch.device.loader.make_torch_loader` does. Batches
collate on the host exactly as in the reference; then every tensor leaf of
what ``collate_fn`` or ``transform_fn`` returns (a dict, namedtuple, list
or tuple, nested) is pinned and copied to the device with
``non_blocking=True``. Leaves that are not tensors (Decimal lists) stay on
the host. ``device='cpu'`` yields the reference's host tensors.
"""

import collections.abc
import decimal

import numpy as np
import torch

from petastorm_tpu_torch.buffers import (
    BatchedNoopShufflingBuffer, BatchedRandomShufflingBuffer,
    NoopShufflingBuffer, RandomShufflingBuffer,
)
from petastorm_tpu_torch.device.loader import resolve_device
from petastorm_tpu_torch.device.staging import H2D_BYTES
from petastorm_tpu_torch.ragged import (
    RAGGED_MESSAGE as _RAGGED_MESSAGE,
    STRING_MESSAGE as _STRING_MESSAGE,
    reject_object_column as _reject_object_column,
)
from petastorm_tpu_torch.telemetry import get_registry, metrics_disabled

# numpy dtypes torch cannot hold → the nearest wider dtype it can
_TORCH_PROMOTIONS = {
    np.dtype(np.uint16): np.int32,
    np.dtype(np.uint32): np.int64,
    np.dtype(np.uint64): np.int64,
}


def _writable(arr):
    """``arr``, or a copy of it when it is a read-only array: a
    decoded-cache hit maps its entry read-only, torch warns on such an
    array, and an in-place op on the batch would write into the mapping.
    Writable arrays stay zero-copy."""
    if isinstance(arr, np.ndarray) and not arr.flags.writeable:
        return arr.copy()
    return arr


def _sanitize_pytorch_types(row_as_dict):
    """In-place dtype promotion for values torch rejects, and a copy of
    a read-only array (:func:`_writable`); None and strings raise."""
    for name, value in row_as_dict.items():
        if value is None:
            raise TypeError('Field %r is None: nullable fields must be '
                            'filled or filtered before torch collation' % name)
        if isinstance(value, np.ndarray):
            if value.dtype in _TORCH_PROMOTIONS:
                row_as_dict[name] = value.astype(_TORCH_PROMOTIONS[value.dtype])
            elif value.dtype.kind in 'US':
                raise TypeError(_STRING_MESSAGE % name)
            else:
                row_as_dict[name] = _writable(value)
        elif isinstance(value, np.generic):
            dt = np.dtype(value.dtype)
            if dt in _TORCH_PROMOTIONS:
                row_as_dict[name] = np.asarray(value, dtype=_TORCH_PROMOTIONS[dt])
            elif dt.kind in 'US':
                raise TypeError(_STRING_MESSAGE % name)
        elif isinstance(value, str):
            raise TypeError(_STRING_MESSAGE % name)


def decimal_friendly_collate(batch):
    """``torch.utils.data.default_collate`` that passes Decimals through as
    lists and names the field of a ragged column."""
    if isinstance(batch[0], decimal.Decimal):
        return list(batch)
    if isinstance(batch[0], collections.abc.Mapping):
        out = {}
        for key in batch[0]:
            values = [d[key] for d in batch]
            if (isinstance(values[0], np.ndarray)
                    and len({v.shape for v in values
                             if isinstance(v, np.ndarray)}) > 1):
                # pre-empt default_collate's opaque 'stack expects each
                # tensor to be equal size' with the field name and remedies
                raise TypeError(_RAGGED_MESSAGE % key)
            out[key] = decimal_friendly_collate(values)
        return out
    if isinstance(batch[0], tuple) and hasattr(batch[0], '_fields'):
        return type(batch[0])(*(decimal_friendly_collate(samples)
                                for samples in zip(*batch)))
    if isinstance(batch[0], collections.abc.Sequence) and \
            not isinstance(batch[0], (str, bytes)):
        return [decimal_friendly_collate(samples) for samples in zip(*batch)]
    return torch.utils.data.default_collate(batch)


def _to_device(obj, device):
    """``obj`` with every tensor leaf copied to ``device`` from pinned
    memory, non-blocking; ``(tensor leaves, their bytes)`` beside it."""
    if torch.is_tensor(obj):
        if obj.device == device:  # a transform_fn that placed it already
            return obj, 0
        return obj.pin_memory().to(device, non_blocking=True), obj.numel() * obj.element_size()
    if isinstance(obj, collections.abc.Mapping):
        moved = {k: _to_device(v, device) for k, v in obj.items()}
        return {k: v for k, (v, _) in moved.items()}, sum(n for _, n in moved.values())
    if isinstance(obj, (list, tuple)):
        moved = [_to_device(v, device) for v in obj]
        values = [v for v, _ in moved]
        if isinstance(obj, tuple):
            values = type(obj)(*values) if hasattr(obj, '_fields') else tuple(values)
        return values, sum(n for _, n in moved)
    return obj, 0


class LoaderBase:
    """Iteration state machine shared by both loaders: a loader is an
    iterable that restarts its reader on re-iteration, and moves what it
    yields to ``device``."""

    def __init__(self, reader, device=None):
        self.reader = reader
        self.device = resolve_device(device)
        self._in_iter = None

    def __iter__(self):
        if self._in_iter is not None and self._in_iter:
            raise RuntimeError('Loader is already being iterated')
        if self._in_iter is not None:
            self._on_reiterate()
        self._in_iter = True
        batches = self._iter_impl()
        try:
            for batch in batches:
                yield self._place(batch)
        finally:
            batches.close()
            self._in_iter = False

    def _place(self, batch):
        if self.device.type == 'cpu':
            return batch
        batch, nbytes = _to_device(batch, self.device)
        if not metrics_disabled():
            get_registry().counter(H2D_BYTES).inc(nbytes)
        return batch

    def _on_reiterate(self):
        self.reader.reset()

    def __len__(self):
        raise TypeError('Loader length is data-dependent and unknown')

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.reader.stop()
        self.reader.join()

    def stop(self):
        self.reader.stop()

    def join(self):
        self.reader.join()


class DataLoader(LoaderBase):
    """Row-at-a-time loader: rows from ``make_reader`` → collated batches.

    :param reader: a row reader (``make_reader``).
    :param batch_size: rows per emitted batch.
    :param collate_fn: batch-of-dicts → tensors
        (default :func:`decimal_friendly_collate`).
    :param shuffling_queue_capacity: >0 enables a row-level
        :class:`RandomShufflingBuffer` of that capacity.
    :param seed: the buffer's seed, offset by the epoch.
    :param device: where batches land: ``None`` (the card; raises without
        CUDA), ``'cuda:N'`` or ``'cpu'``.
    """

    def __init__(self, reader, batch_size=1,
                 collate_fn=decimal_friendly_collate,
                 shuffling_queue_capacity=0, seed=None, device=None):
        super().__init__(reader, device)
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffling_queue_capacity = shuffling_queue_capacity
        self._seed = seed
        self._epoch = 0

    def _make_buffer(self):
        if self.shuffling_queue_capacity > 0:
            # seed offset by epoch: a constant seed would replay the same
            # "random" order every epoch
            seed = None if self._seed is None else self._seed + self._epoch
            return RandomShufflingBuffer(
                self.shuffling_queue_capacity,
                min_after_retrieve=self.shuffling_queue_capacity // 2,
                seed=seed)
        return NoopShufflingBuffer()

    def _iter_impl(self):
        buf = self._make_buffer()
        self._epoch += 1
        acc = []
        for row in self.reader:
            row_dict = row._asdict()
            _sanitize_pytorch_types(row_dict)
            buf.add_many([row_dict])
            while buf.can_retrieve:
                acc.append(buf.retrieve())
                if len(acc) == self.batch_size:
                    yield self.collate_fn(acc)
                    acc = []
        buf.finish()
        while buf.can_retrieve:
            acc.append(buf.retrieve())
            if len(acc) == self.batch_size:
                yield self.collate_fn(acc)
                acc = []
        if acc:
            yield self.collate_fn(acc)


class BatchedDataLoader(LoaderBase):
    """Column-batch loader: ``make_batch_reader`` row-groups → fixed-size
    torch batches with no per-row Python work.

    :param transform_fn: ``{name: np.ndarray} → {name: tensor}`` applied per
        emitted batch (default: zero-copy ``torch.as_tensor`` per column,
        a copy for a read-only column such as a decoded-cache hit's).
    :param inmemory_cache_all: keep the whole first epoch in host memory
        and replay it (reshuffled per epoch when shuffling is on) for later
        epochs: the reader is read exactly once, so it must have
        ``num_epochs=1``.
    :param keep_fields: the columns to keep (None: all).
    :param device: as :class:`DataLoader`'s.
    """

    def __init__(self, reader, batch_size=1, transform_fn=None,
                 shuffling_queue_capacity=0, seed=None,
                 inmemory_cache_all=False, keep_fields=None, device=None):
        super().__init__(reader, device)
        if inmemory_cache_all and getattr(reader, 'num_epochs', None) != 1:
            # a multi-epoch (or infinite) reader would fill the cache with
            # repeated rows; a reader that does not say is refused too
            raise ValueError('inmemory_cache_all requires a reader with '
                             'num_epochs=1; further epochs replay from RAM')
        self.batch_size = batch_size
        self.shuffling_queue_capacity = shuffling_queue_capacity
        self._seed = seed
        self._cache = [] if inmemory_cache_all else None
        self._cache_complete = False
        self._keep_fields = keep_fields
        self._epoch = 0
        self.transform_fn = transform_fn or self._default_transform

    def _on_reiterate(self):
        # replay epochs come from the cache; touch the reader only while it
        # is still the source
        if not self._cache_complete:
            self.reader.reset()

    @staticmethod
    def _default_transform(columns):
        return {name: torch.as_tensor(_writable(arr)) for name, arr in columns.items()}

    def _make_buffer(self, epoch):
        seed = None if self._seed is None else self._seed + epoch
        if self.shuffling_queue_capacity > 0:
            return BatchedRandomShufflingBuffer(
                self.shuffling_queue_capacity,
                min_after_retrieve=self.shuffling_queue_capacity // 2,
                batch_size=self.batch_size,
                extra_capacity=self.shuffling_queue_capacity, seed=seed)
        return BatchedNoopShufflingBuffer(self.batch_size)

    def _column_chunks(self):
        """Chunks from the reader (first epoch) or the cache (replay).

        Cached arrays are copied in both directions: the default transform
        is zero-copy ``torch.as_tensor``, so without the copies an in-place
        tensor op (``batch['x'] -= mean``) would rewrite the cache and every
        later epoch with it."""
        if self._cache_complete:
            for chunk in self._cache:
                yield {k: v.copy() for k, v in chunk.items()}
            return
        for batch in self.reader:
            columns = batch._asdict()
            if self._keep_fields is not None:
                keep = set(self._keep_fields)
                columns = {k: v for k, v in columns.items() if k in keep}
            for name, arr in columns.items():
                if isinstance(arr, np.ndarray) and arr.dtype in _TORCH_PROMOTIONS:
                    columns[name] = arr.astype(_TORCH_PROMOTIONS[arr.dtype])
                elif isinstance(arr, np.ndarray) and arr.dtype.kind == 'O':
                    _reject_object_column(name, arr)
                elif isinstance(arr, np.ndarray) and arr.dtype.kind in 'US':
                    raise TypeError(_STRING_MESSAGE % name)
            if self._cache is not None:
                self._cache.append({k: v.copy() for k, v in columns.items()})
            yield columns
        if self._cache is not None:
            self._cache_complete = True

    def _iter_impl(self):
        if self._cache is not None and not self._cache_complete:
            # a partial cache from an interrupted first epoch would replay
            # repeated rows; every reader-fed pass rebuilds it
            self._cache = []
        buf = self._make_buffer(self._epoch)
        for columns in self._column_chunks():
            buf.add_many(columns)
            while buf.can_retrieve:
                yield self.transform_fn(buf.retrieve())
        buf.finish()
        while buf.can_retrieve:
            yield self.transform_fn(buf.retrieve())
        self._epoch += 1
