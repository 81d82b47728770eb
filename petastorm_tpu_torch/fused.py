"""Fused decode: encoded image cells ride to the staging slot.

Counterpart of ``petastorm_tpu/fused.py``. When the reader is built with
``defer_image_decode=True`` (the torch loader asks whenever its batch path
can fuse), the row-group worker skips decoding fixed-shape, numeric,
null-free image columns and publishes an :class:`EncodedImageColumn`: the
still-encoded cells and the field that decodes them. The column travels
the route a decoded one would (the re-batcher's chunk views, part
slicing), and the staging engine's fill decodes it straight into the rows
of the pinned slot the copy to the card starts from, under the
``decode_fused`` span: decoded pixels are written once, at their final
host address, by the native decoders' threads.

Every decline falls back to the classic batched decode and is counted in
``petastorm_tpu_fused_decode_fallbacks_total{reason=...}``: the worker
declines a column of another shape (``column-shape``) and a reader with a
TransformSpec (``worker-config``); the loader materializes when staging
is off, rows are shuffled or a dtype cast retargets the column.
"""

import numpy as np

from petastorm_tpu_torch.codecs import decode_batch_with_nulls
from petastorm_tpu_torch.telemetry import FUSED_FALLBACKS, get_registry, metrics_disabled

#: column slabs start on a page boundary, so the native decoders' parallel
#: row writes stay cache-line clean
SLAB_ALIGN = 4096


def alloc_column_slab(shape, dtype):
    """A writable ``np.empty(shape, dtype)`` whose data starts on a
    :data:`SLAB_ALIGN` boundary; it owns its memory like any fresh array
    (the allocation rides its ``.base``)."""
    dtype = np.dtype(dtype)
    nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    if nbytes <= 0:
        return np.empty(shape, dtype)
    raw = np.empty(nbytes + SLAB_ALIGN, np.uint8)
    offset = (-raw.ctypes.data) % SLAB_ALIGN
    return raw[offset:offset + nbytes].view(dtype).reshape(shape)


def count_fallback(reason):
    """One fused-decode decline, by reason."""
    if not metrics_disabled():
        get_registry().counter(FUSED_FALLBACKS, reason=reason).inc()


class EncodedImageColumn:
    """A column whose cells are still encoded, between the row-group
    worker and the staging fill.

    It has just enough of a decoded column's ndarray surface (``shape``,
    ``dtype``, ``len``, slicing) for the batch path between the two to
    need no special case; the first consumer that needs pixels calls
    :meth:`decode_into` (the staging fill) or :meth:`materialize`.
    ``cells`` is a :class:`~petastorm_tpu_torch.native.PackedCells` (or a
    sequence of bytes-like cells) aliasing the Arrow column in ``owner``,
    which keeps that memory alive as long as the column lives."""

    __slots__ = ('field', 'cells', 'owner')

    def __init__(self, field, cells, owner=None):
        self.field = field
        self.cells = cells
        self.owner = owner

    @property
    def shape(self):
        return (len(self.cells),) + tuple(self.field.shape)

    @property
    def dtype(self):
        return np.dtype(self.field.numpy_dtype)

    @property
    def nbytes(self):
        """The decoded size (what the fill will write), not the encoded one."""
        return int(np.prod(self.shape, dtype=np.int64)) * self.dtype.itemsize

    def __len__(self):
        return len(self.cells)

    def __getitem__(self, index):
        """A slice is a view column over the same cells; per-row access is
        refused, since it means a consumer takes this for decoded data."""
        if not isinstance(index, slice):
            raise TypeError('EncodedImageColumn is encoded data; decode it '
                            '(decode_into/materialize) before per-row indexing')
        return EncodedImageColumn(self.field, self.cells[index], owner=self.owner)

    def decode_into(self, out):
        """Decode every cell into the ``(n,) + field.shape`` destination in
        one batched call; returns ``out``."""
        return decode_batch_with_nulls(self.field, self.cells, out=out)

    def materialize(self):
        """Decode into a fresh page-aligned array, for consumers that have
        no destination of their own."""
        return self.decode_into(alloc_column_slab(self.shape, self.dtype))

    def __repr__(self):
        return 'EncodedImageColumn(%r, n=%d, shape=%s)' % (self.field.name, len(self.cells),
                                                           self.shape)
