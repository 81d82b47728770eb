"""Field codecs: (de)serialize field values into Parquet-storable cells.

Counterpart of ``petastorm_tpu/codecs.py``: the on-disk byte formats and
the JSON codec descriptions are the same, so datasets interoperate.
Fixed-shape ``NdarrayCodec`` columns and 8-bit RGB image columns decode a
whole batch in one call of the native decoders
(:mod:`petastorm_tpu_torch.native`), with ``decode_batch(..., out=)``
writing the rows straight into a caller's buffer (a column slab or a
pinned staging slot); everything else, and every cell a native decoder
declines, decodes per cell as before.
"""

import logging
import os
import statistics
import threading
import time
from abc import ABCMeta, abstractmethod
from decimal import Decimal
from io import BytesIO

import numpy as np
import pyarrow as pa

from petastorm_tpu_torch import faults, native
from petastorm_tpu_torch.telemetry import knobs
from petastorm_tpu_torch.unischema import numpy_to_arrow_type

logger = logging.getLogger(__name__)

_IMAGE_POOL = None
_IMAGE_POOL_DISABLED = object()
_IMAGE_POOL_LOCK = threading.Lock()

# the JPEG chroma upsampling mode this process decodes in (1 fancy, 0
# merged, -1 the C decoder's env default), or None until a batch decides
_JPEG_FANCY_MODE = None
_JPEG_FANCY_LOCK = threading.Lock()
_JPEG_FANCY_ATTEMPTS = 0
_JPEG_FANCY_MAX_ATTEMPTS = 5


# the staging autotuner's in-process override of the decoder-thread knob
# (None: the knob rules); never an os.environ write, which child processes
# and later readers would inherit
_DECODER_THREADS_OVERRIDE = None


def set_image_decoder_threads_override(value):
    """Set (int) or clear (None) the in-process override that
    :func:`image_decoder_threads` returns. The staging autotuner owns it
    and clears it when its loader stops."""
    global _DECODER_THREADS_OVERRIDE
    _DECODER_THREADS_OVERRIDE = None if value is None else max(0, int(value))


def image_decoder_threads():
    """Decode width: the autotuner's override when set, else
    :func:`image_decoder_threads_from_knob`. It sizes whichever pool runs a
    batch: the native decoders' pthreads (one call per column, GIL
    released) or, without them, the cv2 thread pool; never both on one
    batch. Concurrent reader workers each get this width, so a process
    decodes on up to workers × this threads."""
    if _DECODER_THREADS_OVERRIDE is not None:
        return _DECODER_THREADS_OVERRIDE
    return image_decoder_threads_from_knob()


def image_decoder_threads_from_knob():
    """``PETASTORM_TPU_IMAGE_DECODER_THREADS`` alone, ignoring any override
    (0 or 1: serial; default ``min(4, cpu_count)``): the autotuner's
    restore ceiling."""
    text = knobs.get_str('PETASTORM_TPU_IMAGE_DECODER_THREADS')
    if not text:
        return min(4, os.cpu_count() or 1)
    try:
        return max(0, int(text))
    except ValueError:
        logger.warning('PETASTORM_TPU_IMAGE_DECODER_THREADS=%r is not an integer; '
                       'threaded image decode disabled', text)
        return 0


def _image_decode_pool():
    """The shared cv2 decode thread pool (cv2 releases the GIL), or None
    when the knob says serial. Only the per-cell path uses it."""
    global _IMAGE_POOL
    if _IMAGE_POOL is None:
        with _IMAGE_POOL_LOCK:
            if _IMAGE_POOL is None:
                workers = image_decoder_threads()
                if workers <= 1:
                    _IMAGE_POOL = _IMAGE_POOL_DISABLED
                else:
                    from concurrent.futures import ThreadPoolExecutor
                    _IMAGE_POOL = ThreadPoolExecutor(max_workers=workers,
                                                     thread_name_prefix='img-decode')
    return None if _IMAGE_POOL is _IMAGE_POOL_DISABLED else _IMAGE_POOL


def _jpeg_mode_cache_path():
    """The file that keeps the calibrated mode for this build of the JPEG
    decoder, under the checkout's ``build/`` directory."""
    from petastorm_tpu_torch.ops import build
    library = os.path.basename(build.library_path('jpeg_batch'))
    return os.path.join(build.BUILD_DIR, 'jpeg-fancy-%s.txt' % library[:-len('.so')])


def _jpeg_upsampling_mode(cells, image_shape):
    """The faster of libjpeg's two chroma upsampling modes on this host
    (fancy or merged: which wins depends on the libjpeg build), timed once
    per process on the first batch of at least 4 cells, interleaved over 3
    rounds (median per mode), and kept in a file per decoder build. A set
    ``PETASTORM_TPU_JPEG_FANCY`` skips this and returns -1 (the decoder
    reads the variable; ``=1`` is bit-identical to cv2). Both modes are
    faithful decodes, so a wrong pick costs only rate."""
    global _JPEG_FANCY_MODE, _JPEG_FANCY_ATTEMPTS
    if knobs.get_str('PETASTORM_TPU_JPEG_FANCY'):
        return -1
    if _JPEG_FANCY_MODE is not None:
        return _JPEG_FANCY_MODE
    if len(cells) < 4:
        return -1  # too few to time; calibration stays open
    with _JPEG_FANCY_LOCK:
        if _JPEG_FANCY_MODE is not None:
            return _JPEG_FANCY_MODE
        cache_path = _jpeg_mode_cache_path()
        try:
            with open(cache_path) as f:
                cached = f.read().strip()
            if cached in ('0', '1'):
                _JPEG_FANCY_MODE = int(cached)
                return _JPEG_FANCY_MODE
        except OSError:
            pass
        sample = cells[:8]
        scratch = np.empty((len(sample),) + tuple(image_shape), np.uint8)
        timings = {0: [], 1: []}
        for mode in (0, 1):
            native.decode_jpeg_batch(sample, scratch, mode, 1)  # warm up
        for round_idx in range(3):
            for mode in ((0, 1) if round_idx % 2 == 0 else (1, 0)):
                start = time.perf_counter()
                done = native.decode_jpeg_batch(sample, scratch, mode, 1)
                timings[mode].append(time.perf_counter() - start)
                if done != len(sample):
                    # oddball cells time different work: retry on a later
                    # batch, a bounded number of times
                    _JPEG_FANCY_ATTEMPTS += 1
                    if _JPEG_FANCY_ATTEMPTS >= _JPEG_FANCY_MAX_ATTEMPTS:
                        _JPEG_FANCY_MODE = -1
                    return -1
        medians = {m: statistics.median(t) for m, t in timings.items()}
        _JPEG_FANCY_MODE = min(medians, key=medians.get)
        logger.info('jpeg upsampling calibrated: %s (merged %.1f img/s, fancy %.1f img/s)',
                    'fancy' if _JPEG_FANCY_MODE else 'merged',
                    len(sample) / medians[0], len(sample) / medians[1])
        try:
            tmp_path = '%s.%d' % (cache_path, os.getpid())
            with open(tmp_path, 'w') as f:
                f.write(str(_JPEG_FANCY_MODE))
            os.replace(tmp_path, cache_path)
        except OSError:
            pass  # the cache only keeps the pick stable across runs
        return _JPEG_FANCY_MODE


class DataframeColumnCodec(metaclass=ABCMeta):
    """Abstract codec contract."""

    @abstractmethod
    def encode(self, unischema_field, value):
        """Encode a single value into its parquet-storable form."""

    @abstractmethod
    def decode(self, unischema_field, encoded):
        """Decode a single stored cell back into its numpy form."""

    def decode_batch(self, unischema_field, encoded_iterable, out=None):
        """Decode many cells (a list, one value per cell). With ``out=``, a
        preallocated ``(n,) + shape`` array, the rows are written into it
        and it is returned; a cell that cannot land in its row raises."""
        values = [self.decode(unischema_field, v) for v in encoded_iterable]
        if out is None:
            return values
        for i, value in enumerate(values):
            _assign_row(out, i, value, unischema_field)
        return out

    @abstractmethod
    def arrow_type(self, unischema_field):
        """The arrow DataType of the stored column."""

    def to_json_dict(self):
        return {'type': type(self).__name__}


def _check_out_destination(unischema_field, out, n):
    """The one check of a ``decode_batch(out=)`` destination: a fixed-shape
    field, and ``out`` exactly ``(n,) + shape`` in the field's dtype."""
    shape = unischema_field.shape
    if not shape or any(d is None for d in shape):
        raise ValueError('decode_batch(out=) requires a fixed-shape field; %r has shape %r'
                         % (unischema_field.name, shape))
    expected = (n,) + tuple(shape)
    dtype = np.dtype(unischema_field.numpy_dtype)
    if out.shape != expected or out.dtype != dtype:
        raise ValueError('decode_batch(out=): destination %s %s does not match the declared '
                         '%s %s' % (out.shape, out.dtype, expected, dtype))


def _assign_row(out, i, value, unischema_field):
    """One decoded cell into row ``i`` of ``out``. The shape must match
    exactly: ``out[i] = value`` alone would broadcast a smaller cell
    across the row."""
    value = np.asarray(value)
    if value.shape != out.shape[1:]:
        raise ValueError('decode_batch(out=): field %r cell decoded to shape %s, not the '
                         'declared %s' % (unischema_field.name, value.shape, out.shape[1:]))
    out[i] = value


def decode_batch_with_nulls(unischema_field, values, out=None):
    """Batch-decode a column whose cells may be None: null cells stay None,
    the others go through the codec's ``decode_batch``; positions are kept.

    With ``out=``, each run of non-null cells decodes in one call into its
    rows and null rows are zero-filled (the buffer may be a recycled slot
    holding an earlier batch); returns ``out``. A
    :class:`~petastorm_tpu_torch.native.PackedCells` holds no nulls and
    goes to the codec whole."""
    if faults.ARMED:
        # the one decode seam every path shares (native batch, cv2, into
        # a slot), so an injected poisoned cell reaches whichever runs
        faults.fault_hit('decode.batch', key=getattr(unischema_field, 'name', None))
    codec = unischema_field.codec
    if isinstance(values, native.PackedCells):
        return codec.decode_batch(unischema_field, values, out=out)
    if out is not None:
        n = len(values)
        i = 0
        while i < n:
            j = i
            if values[i] is None:
                while j < n and values[j] is None:
                    j += 1
                out[i:j] = 0
            else:
                while j < n and values[j] is not None:
                    j += 1
                codec.decode_batch(unischema_field, values[i:j], out=out[i:j])
            i = j
        return out
    non_null_idx = [i for i, v in enumerate(values) if v is not None]
    if len(non_null_idx) == len(values):
        return codec.decode_batch(unischema_field, values)
    decoded = codec.decode_batch(unischema_field, [values[i] for i in non_null_idx])
    result = [None] * len(values)
    for slot, i in enumerate(non_null_idx):
        result[i] = decoded[slot]
    return result


def _fixed_shape(shape):
    return bool(shape) and not any(d is None for d in shape)


class CompressedImageCodec(DataframeColumnCodec):
    """uint8/uint16 images as png or jpeg bytes, as OpenCV writes them; RGB
    at the API boundary, BGR on disk for 3/4-channel images.

    ``decode_batch`` of 8-bit RGB cells of a fixed shape runs the native
    decoders; per-cell ``decode`` and declined cells run cv2, which
    upsamples JPEG chroma in fancy mode. The native JPEG decoder's mode is
    calibrated per host (:func:`_jpeg_upsampling_mode`), so set
    ``PETASTORM_TPU_JPEG_FANCY=1`` for JPEG pixels bit-identical to cv2's
    on every path. PNG decode is lossless, so it is identical either way.
    """

    def __init__(self, image_codec='png', quality=80):
        if image_codec not in ('png', 'jpeg', 'jpg'):
            raise ValueError('Unsupported image codec: %r' % image_codec)
        self._image_codec = '.' + image_codec
        self._quality = quality

    @property
    def image_codec(self):
        return self._image_codec[1:]

    def encode(self, unischema_field, value):
        import cv2
        if unischema_field.numpy_dtype != value.dtype:
            raise ValueError('Field %r dtype %s != value dtype %s'
                             % (unischema_field.name, unischema_field.numpy_dtype, value.dtype))
        if not unischema_field.is_shape_compliant(value.shape):
            raise ValueError('Field %r: image shape %s does not match %s'
                             % (unischema_field.name, value.shape, unischema_field.shape))
        if value.ndim == 3 and value.shape[2] not in (3, 4):
            raise ValueError('Field %r: images must be 2-d, HxWx3 or HxWx4; got shape %s'
                             % (unischema_field.name, value.shape))
        if value.ndim == 3:
            code = (cv2.COLOR_RGB2BGR if value.shape[2] == 3
                    else cv2.COLOR_RGBA2BGRA)
            bgr = cv2.cvtColor(np.ascontiguousarray(value), code)
        else:
            bgr = value
        params = ([int(cv2.IMWRITE_JPEG_QUALITY), self._quality]
                  if self._image_codec in ('.jpeg', '.jpg') else [])
        ok, encoded = cv2.imencode(self._image_codec, bgr, params)
        if not ok:
            raise RuntimeError('cv2.imencode failed for field %r' % unischema_field.name)
        return bytearray(encoded)

    @staticmethod
    def _as_uint8(encoded):
        """Cell bytes as a uint8 array, zero-copy for ndarray views."""
        if isinstance(encoded, np.ndarray) and encoded.dtype == np.uint8:
            return encoded
        return np.frombuffer(bytes(encoded), dtype=np.uint8)

    def decode(self, unischema_field, encoded):
        import cv2
        image = cv2.imdecode(self._as_uint8(encoded), cv2.IMREAD_UNCHANGED)
        if image is None:
            raise ValueError('cv2.imdecode failed for field %r' % unischema_field.name)
        if image.ndim == 3 and image.shape[2] in (3, 4):
            code = (cv2.COLOR_BGR2RGB if image.shape[2] == 3
                    else cv2.COLOR_BGRA2RGBA)
            image = cv2.cvtColor(image, code)
        # Every branch above leaves `image` a buffer cv2 freshly
        # allocated for THIS call (imdecode or cvtColor); when no cast is
        # needed astype(copy=False) returns that same owned array, so
        # ownership transfers cleanly to the caller.  # pipesan: owns
        return image.astype(unischema_field.numpy_dtype, copy=False)

    def _decode_into(self, unischema_field, encoded, dst):
        """One cell through cv2 into a row of a batch; raises on a decode
        failure or a shape other than the row's."""
        image = self.decode(unischema_field, encoded)
        if image.shape != dst.shape:
            raise ValueError('field %r: decoded shape %s != declared %s'
                             % (unischema_field.name, image.shape, dst.shape))
        dst[...] = image

    def decode_batch(self, unischema_field, encoded_iterable, out=None):
        """Fixed-shape fields decode into one ``(n,) + shape`` array (the
        native decoders, else cv2 on a small thread pool); any surprise
        falls back to the per-cell path, which returns a list. With
        ``out=`` (``(n,) + shape`` in the field's dtype) the rows land in
        the caller's buffer and a surprise raises instead."""
        cells = encoded_iterable if isinstance(encoded_iterable, (list, native.PackedCells)) \
            else list(encoded_iterable)
        n = len(cells)
        if out is not None:
            _check_out_destination(unischema_field, out, n)
            self._decode_dense(unischema_field, cells, out)
            return out
        if n >= 4 and _fixed_shape(unischema_field.shape):
            try:
                dense = np.empty((n,) + tuple(unischema_field.shape),
                                 dtype=unischema_field.numpy_dtype)
                self._decode_dense(unischema_field, cells, dense)
                return dense
            except Exception:  # noqa: BLE001 - the dense path is an accelerator
                logger.debug('Dense batched image decode failed; falling back to the '
                             'per-cell path', exc_info=True)
        return [self.decode(unischema_field, v) for v in cells]

    def _decode_dense(self, unischema_field, cells, out):
        """Every cell into its row of ``out``: the native decoders, or cv2
        on the shared pool when they decline the batch."""
        if self._native_image_batch(unischema_field, cells, out):
            return
        pool = _image_decode_pool()
        if pool is None:
            for i in range(len(cells)):
                self._decode_into(unischema_field, cells[i], out[i])
        else:
            list(pool.map(lambda i: self._decode_into(unischema_field, cells[i], out[i]),
                          range(len(cells))))

    def _native_image_batch(self, unischema_field, cells, out):
        """Decode a batch of 8-bit RGB cells with one native call (its
        pthreads sized by :func:`image_decoder_threads`, GIL released);
        True when ``out`` is filled. A cell the decoder rejects (another
        shape, channel count or depth) goes through cv2 alone, and the
        decoder takes the rest again."""
        if out.dtype != np.uint8 or out.ndim != 4 or out.shape[3] != 3:
            return False
        jpeg = self._image_codec in ('.jpeg', '.jpg')
        if not native.available('jpeg_batch' if jpeg else 'png_batch'):
            return False
        if not isinstance(cells, native.PackedCells):
            cells = native.PackedCells.from_cells(cells)
        threads = image_decoder_threads()
        if jpeg:
            mode = _jpeg_upsampling_mode(cells, out.shape[1:])

            def decode(lo):
                return native.decode_jpeg_batch(cells[lo:], out[lo:], mode, threads)
        else:
            def decode(lo):
                return native.decode_png_batch(cells[lo:], out[lo:], threads)
        lo = 0
        while lo < len(cells):
            lo += decode(lo)
            if lo < len(cells):
                self._decode_into(unischema_field, cells[lo], out[lo])
                lo += 1
        return True

    def arrow_type(self, unischema_field):
        return pa.binary()

    def to_json_dict(self):
        return {'type': 'CompressedImageCodec',
                'image_codec': self.image_codec, 'quality': self._quality}


class NdarrayCodec(DataframeColumnCodec):
    """Any numpy ndarray as ``np.save`` .npy bytes."""

    def encode(self, unischema_field, value):
        _check_ndarray(unischema_field, value)
        buf = BytesIO()
        np.save(buf, value, allow_pickle=False)
        return bytearray(buf.getvalue())

    def decode(self, unischema_field, encoded):
        return np.load(BytesIO(bytes(encoded)), allow_pickle=False)

    def decode_batch(self, unischema_field, encoded_iterable, out=None):
        """Fixed-shape numeric fields take the native decoder (headers
        checked, payloads copied by its pthreads with the GIL released)
        into one ``(n,) + shape`` array; anything else (wildcard dims,
        strings, cells the decoder rejects) decodes per cell. With
        ``out=``, the rows land in the caller's buffer (fixed-shape fields
        only; a cell of another shape raises)."""
        cells = encoded_iterable if isinstance(encoded_iterable, (list, native.PackedCells)) \
            else list(encoded_iterable)
        shape = unischema_field.shape
        if out is not None and not len(cells):
            return out
        try:
            dtype = np.dtype(unischema_field.numpy_dtype)
        except TypeError:
            dtype = None
        if not len(cells) or not _fixed_shape(shape) or dtype is None \
                or dtype.kind not in 'iufb':
            if out is not None:
                raise ValueError('decode_batch(out=) requires a fixed-shape numeric field; '
                                 '%r has shape %r' % (unischema_field.name, shape))
            return super().decode_batch(unischema_field, cells)
        if out is not None:
            _check_out_destination(unischema_field, out, len(cells))
        if not native.available('npy_batch'):
            return super().decode_batch(unischema_field, cells, out=out)
        dense = out if out is not None else np.empty((len(cells),) + shape, dtype=dtype)
        # numpy writes the header's shape with canonical spacing, so an
        # exact match rejects a cell of another shape whose byte count
        # happens to agree ((3, 2) against (2, 3)); it decodes per cell
        shape_str = "'shape': %r" % (tuple(int(d) for d in shape),)
        done = native.decode_npy_batch(cells, dense, dtype.str, shape_str,
                                       image_decoder_threads())
        if done == len(cells):
            return dense
        if out is not None:
            for i in range(done, len(cells)):
                _assign_row(out, i, self.decode(unischema_field, cells[i]), unischema_field)
            return out
        rows = list(dense[:done])
        rows.extend(self.decode(unischema_field, cells[i]) for i in range(done, len(cells)))
        return rows

    def arrow_type(self, unischema_field):
        return pa.binary()


class CompressedNdarrayCodec(DataframeColumnCodec):
    """A numpy ndarray as ``np.savez_compressed`` bytes."""

    def encode(self, unischema_field, value):
        _check_ndarray(unischema_field, value)
        buf = BytesIO()
        np.savez_compressed(buf, arr=value)
        return bytearray(buf.getvalue())

    def decode(self, unischema_field, encoded):
        with np.load(BytesIO(bytes(encoded)), allow_pickle=False) as npz:
            return npz['arr']

    def arrow_type(self, unischema_field):
        return pa.binary()


class ScalarCodec(DataframeColumnCodec):
    """A scalar as a typed parquet cell, parameterized with an arrow type
    (a numpy dtype or an arrow type string is converted)."""

    def __init__(self, storage_type):
        self._arrow_type = _as_arrow_type(storage_type)

    def encode(self, unischema_field, value):
        at = self._arrow_type
        if pa.types.is_integer(at):
            return int(value)
        if pa.types.is_floating(at):
            return float(value)
        if pa.types.is_boolean(at):
            return bool(value)
        if pa.types.is_string(at) or pa.types.is_large_string(at):
            if isinstance(value, bytes):
                return value.decode('utf-8')
            return str(value)
        if pa.types.is_binary(at) or pa.types.is_large_binary(at):
            return bytes(value)
        if pa.types.is_decimal(at):
            return Decimal(str(value))
        if pa.types.is_timestamp(at) or pa.types.is_date(at):
            return value
        raise ValueError('ScalarCodec: unsupported storage type %s' % at)

    def decode(self, unischema_field, encoded):
        if unischema_field.numpy_dtype is Decimal:
            return Decimal(encoded)
        return unischema_field.numpy_dtype(encoded)

    def decode_batch(self, unischema_field, encoded_iterable):
        if unischema_field.numpy_dtype is Decimal:
            return [Decimal(v) for v in encoded_iterable]
        return np.asarray(list(encoded_iterable)).astype(unischema_field.numpy_dtype)

    def arrow_type(self, unischema_field):
        return self._arrow_type

    def to_json_dict(self):
        return {'type': 'ScalarCodec', 'arrow_type': str(self._arrow_type)}


def _check_ndarray(unischema_field, value):
    if not isinstance(value, np.ndarray):
        raise ValueError('Field %r: expected ndarray, got %s'
                         % (unischema_field.name, type(value)))
    want = np.dtype(unischema_field.numpy_dtype)
    # flexible dtypes (str/bytes) carry an item length; compare by kind only
    matches = (want.kind == value.dtype.kind if want.kind in 'SU'
               else want == value.dtype)
    if not matches:
        raise ValueError('Field %r dtype %s != value dtype %s'
                         % (unischema_field.name, unischema_field.numpy_dtype, value.dtype))
    if not unischema_field.is_shape_compliant(value.shape):
        raise ValueError('Field %r: shape %s does not match %s'
                         % (unischema_field.name, value.shape, unischema_field.shape))


_ARROW_TYPE_PARSERS = {
    'bool': pa.bool_, 'int8': pa.int8, 'uint8': pa.uint8, 'int16': pa.int16,
    'uint16': pa.uint16, 'int32': pa.int32, 'uint32': pa.uint32,
    'int64': pa.int64, 'uint64': pa.uint64, 'halffloat': pa.float16,
    'float': pa.float32, 'double': pa.float64, 'string': pa.string,
    'large_string': pa.large_string, 'binary': pa.binary,
    'large_binary': pa.large_binary,
}


def _parse_arrow_type(type_str):
    if type_str in _ARROW_TYPE_PARSERS:
        return _ARROW_TYPE_PARSERS[type_str]()
    if type_str.startswith('timestamp'):
        inner = type_str[type_str.index('[') + 1:type_str.index(']')]
        if ',' in inner:  # e.g. 'timestamp[us, tz=UTC]'
            unit, tz_part = (s.strip() for s in inner.split(',', 1))
            tz = tz_part.split('=', 1)[1] if '=' in tz_part else None
            return pa.timestamp(unit, tz)
        return pa.timestamp(inner)
    if type_str.startswith('date32'):
        return pa.date32()
    if type_str.startswith('date64'):
        return pa.date64()
    if type_str.startswith('decimal'):
        inner = type_str[type_str.index('(') + 1:type_str.index(')')]
        precision, scale = (int(x) for x in inner.split(','))
        return pa.decimal128(precision, scale)
    raise ValueError('Cannot parse arrow type string %r' % type_str)


def _as_arrow_type(storage_type):
    """Accept an arrow DataType, an arrow type string or a numpy dtype."""
    if isinstance(storage_type, pa.DataType):
        return storage_type
    if isinstance(storage_type, str):
        return _parse_arrow_type(storage_type)
    return numpy_to_arrow_type(storage_type)


#: arrow type (by ``str()``) → pyspark type class name, the reference's
#: table: the footer's pickled schema for the original petastorm
#: (:mod:`petastorm_tpu_torch.etl.legacy`) names these classes
ARROW_TO_SPARK_TYPE_NAME = {
    'bool': 'BooleanType', 'int8': 'ByteType', 'int16': 'ShortType',
    'int32': 'IntegerType', 'int64': 'LongType',
    'uint8': 'ShortType', 'uint16': 'IntegerType', 'uint32': 'LongType',
    'halffloat': 'FloatType', 'float': 'FloatType', 'double': 'DoubleType',
    'string': 'StringType', 'large_string': 'StringType',
    'binary': 'BinaryType', 'large_binary': 'BinaryType',
    'date32[day]': 'DateType',
}


def codec_to_json(codec):
    return None if codec is None else codec.to_json_dict()


def codec_from_json(d):
    if d is None:
        return None
    kind = d['type']
    if kind == 'CompressedImageCodec':
        return CompressedImageCodec(d['image_codec'], d['quality'])
    if kind == 'NdarrayCodec':
        return NdarrayCodec()
    if kind == 'CompressedNdarrayCodec':
        return CompressedNdarrayCodec()
    if kind == 'ScalarCodec':
        return ScalarCodec(_parse_arrow_type(d['arrow_type']))
    raise ValueError('Unknown codec type in schema JSON: %r' % kind)
