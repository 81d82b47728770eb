"""Field codecs: (de)serialize field values into Parquet-storable cells.

Counterpart of ``petastorm_tpu/codecs.py`` on its pure-Python decode path
(the ``PETASTORM_TPU_NATIVE=0`` behaviour): the on-disk byte formats and
the JSON codec descriptions are the same, so datasets interoperate. The
native batched C decoders wait for the image-path slice.
"""

from abc import ABCMeta, abstractmethod
from decimal import Decimal
from io import BytesIO

import numpy as np
import pyarrow as pa

from petastorm_tpu_torch.unischema import numpy_to_arrow_type


class DataframeColumnCodec(metaclass=ABCMeta):
    """Abstract codec contract."""

    @abstractmethod
    def encode(self, unischema_field, value):
        """Encode a single value into its parquet-storable form."""

    @abstractmethod
    def decode(self, unischema_field, encoded):
        """Decode a single stored cell back into its numpy form."""

    def decode_batch(self, unischema_field, encoded_iterable):
        """Decode many cells (a list, one value per cell)."""
        return [self.decode(unischema_field, v) for v in encoded_iterable]

    @abstractmethod
    def arrow_type(self, unischema_field):
        """The arrow DataType of the stored column."""

    def to_json_dict(self):
        return {'type': type(self).__name__}


def decode_batch_with_nulls(unischema_field, values):
    """Batch-decode a column whose cells may be None: null cells stay None,
    the others go through the codec's ``decode_batch``; positions are kept."""
    non_null_idx = [i for i, v in enumerate(values) if v is not None]
    if len(non_null_idx) == len(values):
        return unischema_field.codec.decode_batch(unischema_field, values)
    decoded = unischema_field.codec.decode_batch(
        unischema_field, [values[i] for i in non_null_idx])
    result = [None] * len(values)
    for slot, i in enumerate(non_null_idx):
        result[i] = decoded[slot]
    return result


class CompressedImageCodec(DataframeColumnCodec):
    """uint8/uint16 images as png or jpeg bytes, as OpenCV writes them; RGB
    at the API boundary, BGR on disk for 3/4-channel images."""

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

    def decode(self, unischema_field, encoded):
        import cv2
        image = cv2.imdecode(np.frombuffer(bytes(encoded), dtype=np.uint8),
                             cv2.IMREAD_UNCHANGED)
        if image is None:
            raise ValueError('cv2.imdecode failed for field %r' % unischema_field.name)
        if image.ndim == 3 and image.shape[2] in (3, 4):
            code = (cv2.COLOR_BGR2RGB if image.shape[2] == 3
                    else cv2.COLOR_BGRA2RGBA)
            image = cv2.cvtColor(image, code)
        return image.astype(unischema_field.numpy_dtype, copy=False)

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
