"""Shuffling buffers between row-group reads and batches (counterpart
of ``petastorm_tpu/buffers.py``).

The row buffers hold single items (the row ``DataLoader``'s row dicts);
the batched buffers hold ``{name: ndarray}`` dicts of equal leading
dimension and return fixed-size batches. Randoms come from numpy's
``RandomState``, as in the reference, so a seed gives the same rows in
the same order. Contract: ``can_add`` → ``add_many``, ``can_retrieve`` →
``retrieve``, ``finish()`` when upstream is exhausted, then drain until
``size == 0``.
"""

from abc import ABCMeta, abstractmethod
from collections import deque

import numpy as np


class ShufflingBufferBase(metaclass=ABCMeta):
    """Row-level buffer contract."""

    @abstractmethod
    def add_many(self, items):
        """Store items; only legal while ``can_add``."""

    @abstractmethod
    def retrieve(self):
        """Return one item; only legal while ``can_retrieve``."""

    @abstractmethod
    def finish(self):
        """Upstream exhausted: everything buffered becomes retrievable."""

    @property
    @abstractmethod
    def can_add(self):
        """True when the buffer will accept more items."""

    @property
    @abstractmethod
    def can_retrieve(self):
        """True when retrieve() would return an item."""

    @property
    @abstractmethod
    def size(self):
        """Number of buffered items."""


class NoopShufflingBuffer(ShufflingBufferBase):
    """FIFO pass-through."""

    def __init__(self):
        self._items = deque()
        self._done = False

    def add_many(self, items):
        if not self.can_add:
            raise RuntimeError('add_many called on a finished buffer')
        self._items.extend(items)

    def retrieve(self):
        return self._items.popleft()

    def finish(self):
        self._done = True

    @property
    def can_add(self):
        return not self._done

    @property
    def can_retrieve(self):
        return len(self._items) > 0

    @property
    def size(self):
        return len(self._items)


class RandomShufflingBuffer(ShufflingBufferBase):
    """Uniform-random retrieval with swap-remove.

    :param shuffling_buffer_capacity: soft fill target; ``can_add`` turns
        False at this size, but one ``add_many`` may overshoot up to
        ``extra_capacity`` (callers add whole row-groups at once).
    :param min_after_retrieve: retrieval blocks until this many items are
        buffered (decorrelation floor), except after :meth:`finish`.
    """

    def __init__(self, shuffling_buffer_capacity, min_after_retrieve=0,
                 extra_capacity=0, seed=None):
        if min_after_retrieve > shuffling_buffer_capacity:
            raise ValueError('min_after_retrieve (%d) must not exceed the '
                             'buffer capacity (%d)'
                             % (min_after_retrieve, shuffling_buffer_capacity))
        self._capacity = shuffling_buffer_capacity
        self._min_after_retrieve = min_after_retrieve
        self._extra_capacity = extra_capacity
        self._items = []
        self._done = False
        self._rng = np.random.RandomState(seed)

    def add_many(self, items):
        if not self.can_add:
            raise RuntimeError('add_many called on a full or finished buffer')
        self._items.extend(items)

    def retrieve(self):
        if not self.can_retrieve:
            raise RuntimeError('retrieve called but can_retrieve is False')
        idx = self._rng.randint(len(self._items))
        # swap-remove: O(1), order irrelevant in a shuffling buffer
        self._items[idx], self._items[-1] = self._items[-1], self._items[idx]
        return self._items.pop()

    def finish(self):
        self._done = True

    @property
    def can_add(self):
        return not self._done and len(self._items) < self._capacity

    @property
    def can_retrieve(self):
        if self._done:
            return len(self._items) > 0
        # >= (not >): capacity == min_after_retrieve must not deadlock the
        # add-while-can_add / retrieve-while-can_retrieve loop
        return len(self._items) >= max(1, self._min_after_retrieve)

    @property
    def size(self):
        return len(self._items)


class BatchedNoopShufflingBuffer:
    """Order-preserving re-batcher: chunks in, fixed batches out."""

    def __init__(self, batch_size):
        self.batch_size = batch_size
        self._chunks = deque()
        self._size = 0
        self._done = False

    def add_many(self, columns):
        if not self.can_add:
            raise RuntimeError('add_many called on a finished buffer')
        n = _leading_dim(columns)
        if n == 0:
            return
        self._chunks.append(columns)
        self._size += n

    def retrieve_parts(self):
        """One batch as a LIST of column-dict parts (chunk views, no
        concatenation), for consumers that copy into their own buffer."""
        if not self.can_retrieve:
            raise RuntimeError('retrieve called but can_retrieve is False')
        want = min(self.batch_size, self._size)
        parts = []
        got = 0
        while got < want:
            chunk = self._chunks[0]
            n = _leading_dim(chunk)
            take = min(n, want - got)
            if take == n:
                parts.append(self._chunks.popleft())
            else:
                parts.append({k: v[:take] for k, v in chunk.items()})
                self._chunks[0] = {k: v[take:] for k, v in chunk.items()}
            got += take
        self._size -= want
        return parts

    def retrieve(self):
        parts = self.retrieve_parts()
        if len(parts) == 1:
            return parts[0]
        return {k: _concat([p[k] for p in parts]) for k in parts[0]}

    def finish(self):
        self._done = True

    @property
    def can_add(self):
        return not self._done

    @property
    def can_retrieve(self):
        return self._size >= self.batch_size or (self._done and self._size > 0)

    @property
    def size(self):
        return self._size


class BatchedRandomShufflingBuffer:
    """Uniform-random fixed-size batches out of contiguous column buffers
    preallocated to ``capacity + extra_capacity`` rows; retrieval gathers
    ``batch_size`` random rows and backfills the holes with tail rows."""

    def __init__(self, shuffling_buffer_capacity, min_after_retrieve,
                 batch_size, extra_capacity=0, seed=None):
        if min_after_retrieve > shuffling_buffer_capacity:
            raise ValueError('min_after_retrieve (%d) must not exceed the '
                             'buffer capacity (%d)'
                             % (min_after_retrieve, shuffling_buffer_capacity))
        if batch_size > shuffling_buffer_capacity:
            raise ValueError('batch_size (%d) must not exceed the buffer '
                             'capacity (%d)'
                             % (batch_size, shuffling_buffer_capacity))
        self.batch_size = batch_size
        self._capacity = shuffling_buffer_capacity
        self._min_after_retrieve = min_after_retrieve
        self._extra_capacity = extra_capacity
        self._buffers = None
        self._size = 0
        self._done = False
        self._rng = np.random.RandomState(seed)

    def add_many(self, columns):
        if not self.can_add:
            raise RuntimeError('add_many called on a full or finished buffer')
        columns = {k: np.asarray(v) for k, v in columns.items()}
        n = _leading_dim(columns)
        if n == 0:
            return
        if self._buffers is None:
            cap = self._capacity + self._extra_capacity
            self._buffers = {name: np.empty((cap,) + arr.shape[1:], dtype=arr.dtype)
                             for name, arr in columns.items()}
        if self._size + n > next(iter(self._buffers.values())).shape[0]:
            raise RuntimeError(
                'Chunk of %d rows overflows the shuffling buffer (capacity %d '
                '+ extra %d, size %d); raise extra_capacity to at least the '
                'row-group size' % (n, self._capacity, self._extra_capacity,
                                    self._size))
        for name, arr in columns.items():
            buf = self._buffers[name]
            # widen on a wider later chunk: assignment would truncate/wrap
            promoted = np.promote_types(buf.dtype, arr.dtype)
            if promoted != buf.dtype:
                buf = self._buffers[name] = buf.astype(promoted)
            buf[self._size:self._size + n] = arr
        self._size += n

    def retrieve(self):
        if not self.can_retrieve:
            raise RuntimeError('retrieve called but can_retrieve is False')
        k = min(self.batch_size, self._size)
        sel = self._rng.choice(self._size, size=k, replace=False)
        batch = {name: buf[sel] for name, buf in self._buffers.items()}
        # backfill the vacated slots below the new size with surviving
        # rows living at or above it
        new_size = self._size - k
        sel_mask = np.zeros(self._size, dtype=bool)
        sel_mask[sel] = True
        holes = np.flatnonzero(sel_mask[:new_size])
        movers = np.flatnonzero(~sel_mask[new_size:]) + new_size
        for buf in self._buffers.values():
            buf[holes] = buf[movers]
        self._size = new_size
        return batch

    def finish(self):
        self._done = True

    @property
    def can_add(self):
        return not self._done and self._size < self._capacity

    @property
    def can_retrieve(self):
        if self._done:
            return self._size > 0
        return self._size >= max(self.batch_size, self._min_after_retrieve)

    @property
    def size(self):
        return self._size


def _leading_dim(columns):
    return len(next(iter(columns.values())))


def _concat(arrays):
    if arrays[0].dtype == object:
        out = np.empty(sum(len(a) for a in arrays), dtype=object)
        pos = 0
        for a in arrays:
            out[pos:pos + len(a)] = a
            pos += len(a)
        return out
    return np.concatenate(arrays)
