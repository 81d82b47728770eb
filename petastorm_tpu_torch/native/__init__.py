"""The port's native host decoders: batched ``.npy``, JPEG and PNG decode.

Counterpart of ``petastorm_tpu/native``. Each C source here
(``npy_batch.c``, ``jpeg_batch.c`` with libjpeg, ``png_batch.c`` with
zlib) has a plain C entry point, built with ``cc`` by
:mod:`petastorm_tpu_torch.ops.build` at first use and bound with
``ctypes``, which releases the GIL for the call. The cells travel as
:class:`PackedCells`: one byte buffer and int64 offsets, which is an Arrow
binary column's own layout, so a row-group's column reaches C with no
per-cell Python object.

A decoder whose library fails to build is logged, counted in
``petastorm_tpu_native_build_failures_total{library=...}`` and reported by
:func:`native_status`; its codec then decodes per cell. Cells decoded
natively count in ``petastorm_tpu_native_decoded_cells_total{library=...}``.
The ``PETASTORM_TPU_NATIVE`` kill switch (checked on every call) turns
every decoder off.
"""

import ctypes
import logging
import threading

import numpy as np

from petastorm_tpu_torch.telemetry import get_registry, knobs, metrics_disabled

logger = logging.getLogger(__name__)

#: library -> its C entry point and argument types after (data, offsets, n, out)
_ENTRY_POINTS = {
    'npy_batch': ('pt_decode_npy_batch',
                  (ctypes.c_int64, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int)),
    'jpeg_batch': ('pt_decode_jpeg_batch', (ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                            ctypes.c_int)),
    'png_batch': ('pt_decode_png_batch', (ctypes.c_int, ctypes.c_int, ctypes.c_int)),
}
DECODERS = tuple(_ENTRY_POINTS)

#: registry counters: native decoder libraries that failed to build or
#: load, and cells each decoder decoded
BUILD_FAILURES = 'petastorm_tpu_native_build_failures_total'
DECODED_CELLS = 'petastorm_tpu_native_decoded_cells_total'

_functions = {}   # library -> bound entry point
_failed = {}      # library -> why it is unavailable in this process
_lock = threading.Lock()


class PackedCells:
    """Encoded cells as one ``uint8`` buffer and ``n + 1`` int64 offsets:
    cell ``i`` is ``data[offsets[i]:offsets[i + 1]]``. Slicing with a step
    of 1 is a view over the same buffer; an integer index gives that
    cell's bytes as a ``uint8`` view. ``data`` may alias memory it does not
    own (an Arrow buffer): whoever builds it keeps the owner alive."""

    __slots__ = ('data', 'offsets')

    def __init__(self, data, offsets):
        self.data = data
        self.offsets = offsets

    @classmethod
    def from_cells(cls, cells):
        """Pack a sequence of bytes-like cells (a copy of their bytes)."""
        arrays = [np.frombuffer(c, np.uint8) if not isinstance(c, np.ndarray)
                  else c.reshape(-1).view(np.uint8) for c in cells]
        offsets = np.zeros(len(arrays) + 1, np.int64)
        np.cumsum([a.size for a in arrays], out=offsets[1:])
        data = np.concatenate(arrays) if arrays else np.empty(0, np.uint8)
        return cls(data, offsets)

    def __len__(self):
        return len(self.offsets) - 1

    def __getitem__(self, index):
        if isinstance(index, slice):
            start, stop, step = index.indices(len(self))
            if step != 1:
                raise ValueError('PackedCells slices take a step of 1')
            return PackedCells(self.data, self.offsets[start:max(start, stop) + 1])
        if index < 0:
            index += len(self)
        if not 0 <= index < len(self):
            raise IndexError(index)
        return self.data[self.offsets[index]:self.offsets[index + 1]]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def take(self, indices):
        """The cells at ``indices``, in that order, packed into a new
        buffer (a copy of their encoded bytes)."""
        indices = np.asarray(indices, np.int64)
        starts, ends = self.offsets[indices], self.offsets[indices + 1]
        offsets = np.zeros(len(indices) + 1, np.int64)
        np.cumsum(ends - starts, out=offsets[1:])
        data = (np.concatenate([self.data[a:b] for a, b in zip(starts, ends)])
                if len(indices) else np.empty(0, np.uint8))
        return PackedCells(data, offsets)

    @property
    def nbytes(self):
        """Encoded bytes of these cells."""
        return int(self.offsets[-1] - self.offsets[0])


def binary_cells(arrow_col):
    """An Arrow ``binary``/``large_binary`` column's cells, zero-copy: a
    :class:`PackedCells` over its data buffer, or, when it holds nulls, a
    list of ``uint8`` views with ``None`` at the nulls. None for a column
    of another type. The views alias the column's buffers: keep the column
    alive while they are used."""
    import pyarrow as pa
    chunks = (arrow_col.chunks if isinstance(arrow_col, pa.ChunkedArray) else [arrow_col])
    if len(chunks) > 1:
        chunks = [pa.concat_arrays(chunks)]
    if not chunks:
        return PackedCells(np.empty(0, np.uint8), np.zeros(1, np.int64))
    chunk = chunks[0]
    if pa.types.is_large_binary(chunk.type):
        offsets_dtype = np.int64
    elif pa.types.is_binary(chunk.type):
        offsets_dtype = np.int32
    else:
        return None
    if chunk.null_count:
        return [np.frombuffer(v.as_buffer(), np.uint8) if v.is_valid else None
                for v in chunk]
    buffers = chunk.buffers()
    offsets = np.frombuffer(buffers[1], dtype=offsets_dtype,
                            count=chunk.offset + len(chunk) + 1)[chunk.offset:]
    data = (np.frombuffer(buffers[2], np.uint8) if buffers[2] is not None
            else np.empty(0, np.uint8))
    return PackedCells(data, offsets.astype(np.int64))


def native_disabled():
    """True when the ``PETASTORM_TPU_NATIVE`` kill switch is off."""
    return knobs.is_disabled('PETASTORM_TPU_NATIVE')


def _function(library):
    """The bound entry point of ``library``, built on first use; None when
    the kill switch is off or the library is unavailable."""
    if native_disabled():
        return None
    fn = _functions.get(library)
    if fn is not None or library in _failed:
        return fn
    from petastorm_tpu_torch.ops import build
    with _lock:
        if library in _functions or library in _failed:
            return _functions.get(library)
        name, tail = _ENTRY_POINTS[library]
        try:
            fn = getattr(build.load(library), name)
        except (OSError, RuntimeError) as e:
            lines = str(e).strip().splitlines() or [repr(e)]
            # the compiler's first error line says why (a missing header)
            _failed[library] = next((line.strip() for line in lines if 'error' in line),
                                    lines[-1])
            logger.warning('native decoder %s unavailable, decoding per cell: %s',
                           library, _failed[library])
            if not metrics_disabled():
                get_registry().counter(BUILD_FAILURES, library=library).inc()
            return None
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, *tail]
        fn.restype = ctypes.c_int64
        _functions[library] = fn
        return fn


def available(library):
    """True when ``library``'s decoder is built and not switched off (it
    is built here on first ask)."""
    return _function(library) is not None


def native_status():
    """``{library: 'live' | 'disabled' | 'not loaded' | 'unavailable: ...'}``
    for each decoder in this process."""
    if native_disabled():
        return {library: 'disabled' for library in DECODERS}
    return {library: ('live' if library in _functions
                      else 'unavailable: ' + _failed[library] if library in _failed
                      else 'not loaded') for library in DECODERS}


def load_all():
    """Build and bind every decoder now (not at first use); returns
    :func:`native_status`."""
    for library in DECODERS:
        _function(library)
    return native_status()


def _call(library, cells, out, *args):
    """One native call over ``cells`` into ``out``; the decoded prefix
    count, or None when the decoder is unavailable."""
    fn = _function(library)
    if fn is None:
        return None
    if not isinstance(cells, PackedCells):
        cells = PackedCells.from_cells(cells)
    if not (out.flags.c_contiguous and out.flags.writeable):
        raise ValueError('the native decoders write a C-contiguous writable array')
    if len(cells) != len(out):
        raise ValueError('%d cells for %d output rows' % (len(cells), len(out)))
    offsets = np.ascontiguousarray(cells.offsets, np.int64)
    if len(cells) and (offsets[0] < 0 or offsets[-1] > cells.data.size
                       or (np.diff(offsets) < 0).any()):
        raise ValueError('cell offsets run outside their buffer')
    done = int(fn(cells.data.ctypes.data, offsets.ctypes.data, len(cells), out.ctypes.data,
                  *args))
    if not metrics_disabled():
        get_registry().counter(DECODED_CELLS, library=library).inc(done)
    return done


def decode_npy_batch(cells, out, descr, shape_str, threads):
    """``.npy`` cells into the rows of ``out``, checked against the dtype
    string ``descr`` (``'<f4'``) and numpy's header text ``shape_str``
    (``"'shape': (2, 3)"``)."""
    row_bytes = out.nbytes // len(out) if len(out) else 0
    return _call('npy_batch', cells, out, row_bytes, descr.encode(), shape_str.encode(),
                 threads)


def _check_rgb(out):
    if out.dtype != np.uint8 or out.ndim != 4 or out.shape[3] != 3:
        raise ValueError('the image decoders write (n, H, W, 3) uint8, not %s %s'
                         % (out.shape, out.dtype))


def decode_jpeg_batch(cells, out, fancy, threads):
    """JPEG cells into ``out`` ``(n, H, W, 3)`` uint8; ``fancy`` 1 / 0 / -1
    (fancy, merged, or ``PETASTORM_TPU_JPEG_FANCY``)."""
    _check_rgb(out)
    return _call('jpeg_batch', cells, out, out.shape[1], out.shape[2], fancy, threads)


def decode_png_batch(cells, out, threads):
    """8-bit RGB PNG cells into ``out`` ``(n, H, W, 3)`` uint8."""
    _check_rgb(out)
    return _call('png_batch', cells, out, out.shape[1], out.shape[2], threads)
