"""Schemas pickled into footers by the original petastorm, read and written.

Counterpart of ``petastorm_tpu/etl/legacy.py``. The original petastorm
stores its ``Unischema`` as a Python pickle under
``dataset-toolkit.unischema.v1``, with class paths under ``petastorm.*``
(or, in its oldest releases, ``av.experimental.deepdrive.dataset_toolkit.*``)
and ``pyspark.sql.types.*``. Neither package is needed here:

* :func:`depickle_legacy_unischema` loads such a blob through a restricted
  unpickler that resolves only an allowlist (numpy scalar types and dtype
  helpers, ``OrderedDict``, ``Decimal``) and maps every petastorm and
  pyspark class onto an inert shim; anything else raises. Footers are
  untrusted input;
* :func:`pickle_unischema_for_reference` pickles the port's schema under
  those class paths (protocol 2), so the original petastorm opens a
  dataset the port wrote. Its bytes are the JAX package's for the same
  schema.
"""

import io
import pickle
import sys
import threading
import types
from collections import OrderedDict, namedtuple
from decimal import Decimal

import numpy as np
import pyarrow as pa

from petastorm_tpu_torch import codecs
from petastorm_tpu_torch.codecs import ARROW_TO_SPARK_TYPE_NAME
from petastorm_tpu_torch.errors import MetadataError
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

_LEGACY_PACKAGES = ('petastorm', 'av.experimental.deepdrive.dataset_toolkit')

# numpy names a pickled schema may reference: the dtype machinery and the
# scalar type classes; nothing that does I/O or runs code
_SAFE_NUMPY_NAMES = frozenset([
    'dtype', 'ndarray', '_reconstruct', 'scalar',
    'bool_', 'int8', 'uint8', 'int16', 'uint16', 'int32', 'uint32',
    'int64', 'uint64', 'float16', 'float32', 'float64', 'longdouble',
    'complex64', 'complex128', 'str_', 'bytes_', 'unicode_', 'string_',
    'object_', 'datetime64', 'timedelta64', 'void', 'generic', 'number',
    'integer', 'signedinteger', 'unsignedinteger', 'floating', 'inexact',
    'flexible', 'character', 'intc', 'intp', 'int_', 'uint', 'single', 'double',
])

# the original UnischemaField is a NamedTuple of these fields in this
# order; pickles rebuild it positionally
_ShimField = namedtuple('_ShimField', ['name', 'numpy_dtype', 'shape', 'codec', 'nullable'])
_ShimField.__new__.__defaults__ = (None, False)


class _ShimObject:
    """Inert stand-in for a pickled petastorm or pyspark object: it records
    its constructor arguments and takes any instance state."""

    _shim_module = None
    _shim_name = None

    def __init__(self, *args, **kwargs):
        self._shim_args = args
        self._shim_kwargs = kwargs

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__['_shim_state'] = state


def _make_shim(module, name):
    return type('_Shim_%s' % name, (_ShimObject,),
                {'_shim_module': module, '_shim_name': name})


def _numpy_multiarray():
    try:  # numpy >= 2.0
        from numpy._core import multiarray
    except ImportError:  # numpy 1.x
        from numpy.core import multiarray
    return multiarray


class _RestrictedUnpickler(pickle.Unpickler):
    _ALLOWED = {
        ('collections', 'OrderedDict'): OrderedDict,
        ('decimal', 'Decimal'): Decimal,
        ('builtins', 'frozenset'): frozenset,
        ('builtins', 'set'): set,
        ('builtins', 'object'): object,
        ('copyreg', '_reconstructor'): __import__('copyreg')._reconstructor,
        # Python 2 spellings: the oldest petastorm datasets were pickled
        # under Python 2
        ('copy_reg', '_reconstructor'): __import__('copyreg')._reconstructor,
        ('__builtin__', 'frozenset'): frozenset,
        ('__builtin__', 'set'): set,
        ('__builtin__', 'object'): object,
        ('__builtin__', 'tuple'): tuple,
        ('__builtin__', 'list'): list,
        ('__builtin__', 'dict'): dict,
    }

    # scalar-type names numpy 2.0 removed, which Python 2 pickles name
    _NUMPY_RENAMES = {'unicode_': 'str_', 'string_': 'bytes_'}

    def find_class(self, module, name):
        if (module, name) in self._ALLOWED:
            return self._ALLOWED[(module, name)]
        if module == 'numpy' or module.startswith('numpy.'):
            # a fixed allowlist of dtype helpers and scalar types, never an
            # arbitrary numpy callable (numpy.load must stay unreachable)
            if name in _SAFE_NUMPY_NAMES:
                if module in ('numpy.core.multiarray', 'numpy._core.multiarray'):
                    return getattr(_numpy_multiarray(), name)
                return getattr(np, self._NUMPY_RENAMES.get(name, name))
            raise pickle.UnpicklingError(
                'Refusing to depickle numpy attribute %s.%s from a dataset footer'
                % (module, name))
        for pkg in _LEGACY_PACKAGES:
            if module == pkg + '.unischema' and name == 'UnischemaField':
                return _ShimField
            if module.startswith(pkg + '.') or module == pkg:
                return _make_shim(module, name)
        if module.startswith('pyspark.'):
            return _make_shim(module, name)
        raise pickle.UnpicklingError(
            'Refusing to depickle %s.%s from a dataset footer' % (module, name))


def _loads(blob):
    # latin1 maps each byte of a Python 2 str payload 1:1 (numpy scalar
    # bytes survive); Python 3 pickles carry no such strings
    return _RestrictedUnpickler(io.BytesIO(blob), encoding='latin1').load()


_SPARK_TYPE_NAME_TO_ARROW = {
    'BooleanType': pa.bool_(), 'ByteType': pa.int8(), 'ShortType': pa.int16(),
    'IntegerType': pa.int32(), 'LongType': pa.int64(), 'FloatType': pa.float32(),
    'DoubleType': pa.float64(), 'StringType': pa.string(),
    'BinaryType': pa.binary(), 'TimestampType': pa.timestamp('us'),
    'DateType': pa.date32(),
}


def _convert_codec(shim):
    if shim is None:
        return None
    name = getattr(type(shim), '_shim_name', None)
    state = getattr(shim, '__dict__', {})
    if name == 'NdarrayCodec':
        return codecs.NdarrayCodec()
    if name == 'CompressedNdarrayCodec':
        return codecs.CompressedNdarrayCodec()
    if name == 'CompressedImageCodec':
        image_codec = state.get('_image_codec', '.png').lstrip('.')
        return codecs.CompressedImageCodec(image_codec, state.get('_quality', 80))
    if name == 'ScalarCodec':
        return codecs.ScalarCodec(_convert_spark_type(state.get('_spark_type')))
    raise MetadataError('Unknown legacy codec class %r in pickled schema' % name)


def _convert_spark_type(shim):
    name = getattr(type(shim), '_shim_name', None)
    if name in _SPARK_TYPE_NAME_TO_ARROW:
        return _SPARK_TYPE_NAME_TO_ARROW[name]
    if name == 'DecimalType':
        state = getattr(shim, '__dict__', {})
        return pa.decimal128(state.get('precision', 38), state.get('scale', 18))
    raise MetadataError('Unknown legacy spark type %r in pickled schema' % name)


def _convert_field(shim_field):
    if isinstance(shim_field, _ShimField):
        name, numpy_dtype, shape, codec, nullable = shim_field
    else:
        # releases before 0.7.6 rebuild fields through a namedtuple-restore
        # helper, which the shim records as (typename, field_names, values)
        d = dict(getattr(shim_field, '__dict__', {}))
        args = d.get('_shim_args')
        if (args and len(args) == 3 and isinstance(args[1], (tuple, list))
                and isinstance(args[2], (tuple, list))):
            if len(args[1]) != len(args[2]):
                # zip would truncate a malformed pickle into undecoded columns
                raise MetadataError('Pickled field restore has %d names but %d values'
                                    % (len(args[1]), len(args[2])))
            d.update(zip(args[1], args[2]))
        missing = {'name', 'numpy_dtype', 'shape'} - set(d)
        if missing:
            raise MetadataError('Pickled field has unexpected structure: missing %s in %r'
                                % (sorted(missing), sorted(d)))
        name, numpy_dtype, shape = d['name'], d['numpy_dtype'], d['shape']
        codec, nullable = d.get('codec'), d.get('nullable', False)
    return UnischemaField(name, numpy_dtype, tuple(shape), _convert_codec(codec),
                          bool(nullable))


def depickle_legacy_unischema(blob):
    """The port's :class:`~petastorm_tpu_torch.unischema.Unischema` of a
    schema blob the original petastorm pickled."""
    obj = _loads(blob)
    d = getattr(obj, '__dict__', None)
    if d is None:
        raise MetadataError('Pickled schema has unexpected structure: %r' % type(obj))
    fields = d.get('_fields')
    if fields is None:
        raise MetadataError('Pickled schema carries no _fields')
    shim_fields = list(fields.values()) if isinstance(fields, dict) else list(fields)
    return Unischema(d.get('_name', 'legacy'), [_convert_field(f) for f in shim_fields])


# -- the port's schema → a pickle the original petastorm loads ----------------
#
# The original petastorm loads a schema only by unpickling the footer blob,
# so its classes must resolve under ``petastorm.unischema``,
# ``petastorm.codecs`` and ``pyspark.sql.types``. Where those packages are
# not installed, lookalike classes under those names are registered in
# ``sys.modules`` for one ``pickle.dumps`` call, under a lock, and the
# previous entries are restored afterwards. Instance state carries the
# schema; the unpickling side rebuilds its own real classes.

_EXPORT_LOCK = threading.Lock()

_EXPORT_MODULES = ('petastorm', 'pyspark', 'pyspark.sql', 'petastorm.unischema',
                   'petastorm.codecs', 'pyspark.sql.types')
_CODEC_NAMES = ('ScalarCodec', 'NdarrayCodec', 'CompressedNdarrayCodec',
                'CompressedImageCodec')


def _spark_type_names():
    return set(ARROW_TO_SPARK_TYPE_NAME.values()) | {'DecimalType', 'TimestampType'}


def _real_modules_if_importable():
    """The classes of a genuinely installed petastorm and pyspark, which
    pickle with full fidelity and need no ``sys.modules`` stubs; None
    where either is missing or broken."""
    import importlib.util
    try:
        if (importlib.util.find_spec('petastorm') is None
                or importlib.util.find_spec('pyspark') is None):
            return None
        import petastorm.codecs as pc
        import petastorm.unischema as pu
        import pyspark.sql.types as pt
    except Exception:  # noqa: BLE001 - any breakage falls back to stubs
        return None
    ns = {name: getattr(pu, name) for name in ('Unischema', 'UnischemaField')}
    ns.update((name, getattr(pc, name)) for name in _CODEC_NAMES)
    ns.update((name, getattr(pt, name)) for name in _spark_type_names())
    return ns


def _install_export_modules():
    """Register stub modules whose classes pickle under the original
    names. Returns ``(namespace, saved sys.modules entries)``; the caller
    restores the saved entries."""
    mods = {name: types.ModuleType(name) for name in _EXPORT_MODULES}
    m_uni, m_cod = mods['petastorm.unischema'], mods['petastorm.codecs']
    m_spark = mods['pyspark.sql.types']
    ns = {}

    # a namedtuple pickles as class(*values), which the original rebuilds
    # positionally
    field_cls = namedtuple('UnischemaField', ['name', 'numpy_dtype', 'shape', 'codec',
                                              'nullable'])
    field_cls.__module__ = 'petastorm.unischema'
    field_cls.__qualname__ = 'UnischemaField'
    m_uni.UnischemaField = ns['UnischemaField'] = field_cls

    schema_cls = type('Unischema', (), {})
    schema_cls.__module__ = 'petastorm.unischema'
    m_uni.Unischema = ns['Unischema'] = schema_cls

    for name in _CODEC_NAMES:
        cls = type(name, (), {})
        cls.__module__ = 'petastorm.codecs'
        setattr(m_cod, name, cls)
        ns[name] = cls
    for name in _spark_type_names():
        cls = type(name, (), {})
        cls.__module__ = 'pyspark.sql.types'
        setattr(m_spark, name, cls)
        ns[name] = cls

    saved = {k: sys.modules.get(k) for k in mods}
    sys.modules.update(mods)
    return ns, saved


def _restore_modules(saved):
    for k, v in saved.items():
        if v is None:
            sys.modules.pop(k, None)
        else:
            sys.modules[k] = v


def _export_spark_type(ns, arrow_type, real_ctors):
    if pa.types.is_decimal(arrow_type):
        if real_ctors:
            return ns['DecimalType'](arrow_type.precision, arrow_type.scale)
        t = ns['DecimalType']()
        t.precision = arrow_type.precision
        t.scale = arrow_type.scale
        t.hasPrecisionInfo = True
        return t
    if pa.types.is_timestamp(arrow_type):
        return ns['TimestampType']()
    name = ARROW_TO_SPARK_TYPE_NAME.get(str(arrow_type))
    if name is None:
        raise MetadataError('No pyspark equivalent for arrow type %s' % arrow_type)
    return ns[name]()


def _export_codec(ns, codec, real_ctors):
    if codec is None:
        return None
    cls_name = type(codec).__name__
    if cls_name in ('NdarrayCodec', 'CompressedNdarrayCodec'):
        return ns[cls_name]()
    if cls_name == 'CompressedImageCodec':
        if real_ctors:
            return ns[cls_name](codec.image_codec, codec._quality)
        out = ns[cls_name]()
        out._image_codec = '.' + codec.image_codec
        out._quality = codec._quality
        return out
    if cls_name == 'ScalarCodec':
        spark_type = _export_spark_type(ns, codec._arrow_type, real_ctors)
        if real_ctors:
            return ns[cls_name](spark_type)
        out = ns[cls_name]()
        out._spark_type = spark_type
        return out
    raise MetadataError('Codec %s has no reference equivalent' % cls_name)


def _build_export_schema(ns, schema, real_ctors):
    fields = OrderedDict()
    for f in schema.fields.values():
        fields[f.name] = ns['UnischemaField'](
            f.name, f.numpy_dtype, tuple(f.shape),
            _export_codec(ns, f.codec, real_ctors), bool(f.nullable))
    if real_ctors:
        return ns['Unischema'](schema._name, list(fields.values()))
    out = ns['Unischema']()
    out._name = schema._name
    out._fields = fields
    for name, field in fields.items():
        setattr(out, name, field)
    return out


def pickle_unischema_for_reference(schema):
    """Pickle the port's schema so the original petastorm (with pyspark)
    loads it: protocol 2, naming only ``petastorm.unischema``,
    ``petastorm.codecs``, ``pyspark.sql.types``, numpy and the standard
    library. A codec or arrow type without an original counterpart raises
    :class:`~petastorm_tpu_torch.errors.MetadataError`.

    While the stub modules are registered (one ``dumps`` call, under the
    lock), an ``import pyspark`` racing it on another thread could bind a
    stub; that is reachable only where pyspark is not installed."""
    real = _real_modules_if_importable()
    if real is not None:
        return pickle.dumps(_build_export_schema(real, schema, real_ctors=True), protocol=2)
    with _EXPORT_LOCK:
        ns, saved = _install_export_modules()
        try:
            return pickle.dumps(_build_export_schema(ns, schema, real_ctors=False),
                                protocol=2)
        finally:
            _restore_modules(saved)
