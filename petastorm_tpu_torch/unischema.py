"""Unischema: one schema definition for Parquet, numpy and torch.

Counterpart of ``petastorm_tpu/unischema.py``. The on-disk form is the same
versioned JSON (``to_json_dict``/``from_json_dict``), so a dataset written
by either package reads in the other. The Spark bridge and the legacy
pickled-schema reader are not ported.
"""

import re
from collections import OrderedDict, namedtuple
from decimal import Decimal

import numpy as np
import pyarrow as pa

_NUMPY_TO_ARROW = {
    np.bool_: pa.bool_(),
    np.int8: pa.int8(),
    np.uint8: pa.uint8(),
    np.int16: pa.int16(),
    np.uint16: pa.uint16(),
    np.int32: pa.int32(),
    np.uint32: pa.uint32(),
    np.int64: pa.int64(),
    np.uint64: pa.uint64(),
    np.float16: pa.float16(),
    np.float32: pa.float32(),
    np.float64: pa.float64(),
    np.str_: pa.string(),
    np.bytes_: pa.binary(),
    np.datetime64: pa.timestamp('ns'),
    Decimal: pa.string(),
}

_ARROW_TO_NUMPY = {
    pa.bool_(): np.bool_,
    pa.int8(): np.int8,
    pa.uint8(): np.uint8,
    pa.int16(): np.int16,
    pa.uint16(): np.uint16,
    pa.int32(): np.int32,
    pa.uint32(): np.uint32,
    pa.int64(): np.int64,
    pa.uint64(): np.uint64,
    pa.float16(): np.float16,
    pa.float32(): np.float32,
    pa.float64(): np.float64,
    pa.string(): np.str_,
    pa.large_string(): np.str_,
    pa.binary(): np.bytes_,
    pa.large_binary(): np.bytes_,
    pa.date32(): np.datetime64,
    pa.date64(): np.datetime64,
}


def arrow_to_numpy_dtype(arrow_type):
    """Map an arrow DataType to the numpy dtype class used in UnischemaField."""
    if arrow_type in _ARROW_TO_NUMPY:
        return _ARROW_TO_NUMPY[arrow_type]
    if pa.types.is_timestamp(arrow_type):
        return np.datetime64
    if pa.types.is_decimal(arrow_type):
        return Decimal
    if pa.types.is_dictionary(arrow_type):
        return arrow_to_numpy_dtype(arrow_type.value_type)
    raise ValueError('Cannot map arrow type %s to a numpy dtype' % arrow_type)


def numpy_to_arrow_type(numpy_dtype):
    """Map a numpy dtype (class or instance) to an arrow DataType."""
    key = np.dtype(numpy_dtype).type if numpy_dtype is not Decimal else Decimal
    if key in _NUMPY_TO_ARROW:
        return _NUMPY_TO_ARROW[key]
    raise ValueError('Cannot map numpy dtype %s to an arrow type' % numpy_dtype)


class UnischemaField:
    """A single typed field of a :class:`Unischema`: ``name``,
    ``numpy_dtype``, ``shape`` (``None`` entries are wildcard dims),
    ``codec`` (None for plain-parquet columns) and ``nullable``.

    Equality and hashing ignore the codec: two fields that produce the same
    in-memory value are the same field even if stored differently.
    """

    __slots__ = ('name', 'numpy_dtype', 'shape', 'codec', 'nullable')

    def __init__(self, name, numpy_dtype, shape=(), codec=None, nullable=False):
        if not isinstance(shape, tuple):
            raise ValueError('shape must be a tuple, got %r' % (shape,))
        object.__setattr__(self, 'name', name)
        object.__setattr__(self, 'numpy_dtype', numpy_dtype)
        object.__setattr__(self, 'shape', shape)
        object.__setattr__(self, 'codec', codec)
        object.__setattr__(self, 'nullable', nullable)

    def __setattr__(self, key, value):
        raise AttributeError('UnischemaField is immutable')

    def __reduce__(self):
        # immutability breaks pickle's default slot restore, which uses
        # setattr: rebuild through __init__ instead
        return (UnischemaField,
                (self.name, self.numpy_dtype, self.shape, self.codec, self.nullable))

    def _key(self):
        return (self.name, self.numpy_dtype, self.shape, self.nullable)

    def __eq__(self, other):
        if not isinstance(other, UnischemaField):
            return NotImplemented
        return self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return ('UnischemaField(name=%r, numpy_dtype=%r, shape=%r, codec=%r, nullable=%r)'
                % (self.name, self.numpy_dtype, self.shape, self.codec, self.nullable))

    @property
    def is_scalar(self):
        return len(self.shape) == 0

    def is_shape_compliant(self, value_shape):
        """True when ``value_shape`` matches ``self.shape`` with None wildcards."""
        if len(value_shape) != len(self.shape):
            return False
        return all(want is None or want == got
                   for want, got in zip(self.shape, value_shape))

    def arrow_storage_type(self):
        """The arrow type this field occupies in a materialized Parquet file."""
        if self.codec is not None:
            return self.codec.arrow_type(self)
        if self.shape:
            return pa.list_(numpy_to_arrow_type(self.numpy_dtype))
        return numpy_to_arrow_type(self.numpy_dtype)

    def to_json_dict(self):
        from petastorm_tpu_torch.codecs import codec_to_json
        if self.numpy_dtype is Decimal:
            dtype_name = 'decimal'
        elif self.numpy_dtype is np.str_:
            dtype_name = 'str'
        elif self.numpy_dtype is np.bytes_:
            dtype_name = 'bytes'
        else:
            dtype_name = np.dtype(self.numpy_dtype).name
        return {
            'name': self.name,
            'numpy_dtype': dtype_name,
            'shape': list(self.shape),
            'codec': codec_to_json(self.codec),
            'nullable': bool(self.nullable),
        }

    @classmethod
    def from_json_dict(cls, d):
        from petastorm_tpu_torch.codecs import codec_from_json
        dtype_name = d['numpy_dtype']
        if dtype_name == 'decimal':
            numpy_dtype = Decimal
        elif dtype_name == 'str':
            numpy_dtype = np.str_
        elif dtype_name == 'bytes':
            numpy_dtype = np.bytes_
        else:
            numpy_dtype = np.dtype(dtype_name).type
        shape = tuple(None if s is None else int(s) for s in d['shape'])
        return cls(d['name'], numpy_dtype, shape, codec_from_json(d['codec']),
                   bool(d['nullable']))


_NAMEDTUPLES = {}


def _stable_namedtuple(type_name, field_names):
    """The same namedtuple class for the same (name, fields) pair, so a
    recreated reader yields batches of an identical type."""
    key = (type_name, tuple(field_names))
    if key not in _NAMEDTUPLES:
        _NAMEDTUPLES[key] = namedtuple(type_name, field_names)
    return _NAMEDTUPLES[key]


class Unischema:
    """An ordered collection of :class:`UnischemaField`, exposed as
    attributes (``schema.field_name``) and via the ``fields`` OrderedDict in
    declaration order."""

    def __init__(self, name, fields):
        self._name = name
        self._fields = OrderedDict((f.name, f) for f in fields)
        if len(self._fields) != len(fields):
            seen, dupes = set(), []
            for f in fields:
                if f.name in seen:
                    dupes.append(f.name)
                seen.add(f.name)
            raise ValueError('Duplicate field names in schema %r: %s' % (name, dupes))
        for f in fields:
            if hasattr(self, f.name):
                raise ValueError('Field name %r collides with a Unischema attribute' % f.name)
            setattr(self, f.name, f)

    @property
    def fields(self):
        return self._fields

    def __iter__(self):
        return iter(self._fields.values())

    def __len__(self):
        return len(self._fields)

    def __repr__(self):
        lines = ['%s(%s: [' % (type(self).__name__, self._name)]
        lines.extend('  %r,' % f for f in self)
        lines.append('])')
        return '\n'.join(lines)

    def create_schema_view(self, fields):
        """A new Unischema with a subset of fields, given as
        :class:`UnischemaField` instances (matched by name) or regex strings."""
        regexes = [f for f in fields if isinstance(f, str)]
        explicit = [f for f in fields if not isinstance(f, str)]
        for f in explicit:
            if f.name not in self._fields:
                raise ValueError('Field %r does not belong to schema %r'
                                 % (f.name, self._name))
        matched = set(f.name for f in match_unischema_fields(self, regexes)) if regexes else set()
        keep = matched | set(f.name for f in explicit)
        return Unischema('%s_view' % self._name,
                         [f for f in self if f.name in keep])

    def as_arrow_schema(self):
        """Arrow schema of the materialized (encoded) representation."""
        return pa.schema([pa.field(f.name, f.arrow_storage_type(), nullable=f.nullable)
                          for f in self])

    def make_namedtuple(self, **kwargs):
        """One row (or batch) of this schema's namedtuple, None-filled."""
        return self.namedtuple(**{k: kwargs.get(k) for k in self._fields})

    @property
    def namedtuple(self):
        return _stable_namedtuple('%s_row' % self._name, list(self._fields))

    def to_json_dict(self):
        return {
            'version': 1,
            'name': self._name,
            'fields': [f.to_json_dict() for f in self],
        }

    @classmethod
    def from_json_dict(cls, d):
        if d.get('version') != 1:
            raise ValueError('Unsupported unischema JSON version: %r' % d.get('version'))
        return cls(d['name'], [UnischemaField.from_json_dict(fd) for fd in d['fields']])

    @classmethod
    def from_arrow_schema(cls, arrow_schema, omit_unsupported_fields=True,
                          partition_columns=(), partition_types=None,
                          name='inferred'):
        """Infer a Unischema from a plain (non-petastorm) arrow schema:
        list<primitive> columns become 1-d wildcard arrays; nested lists are
        skipped unless ``omit_unsupported_fields`` is False."""
        fields = []
        for arrow_field in arrow_schema:
            atype = arrow_field.type
            try:
                if pa.types.is_list(atype) or pa.types.is_large_list(atype):
                    value_type = atype.value_type
                    if pa.types.is_nested(value_type):
                        raise ValueError('Nested list field %r is not supported' % arrow_field.name)
                    fields.append(UnischemaField(arrow_field.name,
                                                 arrow_to_numpy_dtype(value_type),
                                                 (None,), None, arrow_field.nullable))
                else:
                    fields.append(UnischemaField(arrow_field.name,
                                                 arrow_to_numpy_dtype(atype),
                                                 (), None, arrow_field.nullable))
            except ValueError:
                if not omit_unsupported_fields:
                    raise
        for part in partition_columns:
            if part not in {f.name for f in fields}:
                dtype = (partition_types or {}).get(part, np.str_)
                fields.append(UnischemaField(part, dtype, (), None, False))
        return cls(name, fields)


def match_unischema_fields(schema, field_regexes):
    """Fields of ``schema`` whose names fully match any of the regexes."""
    if not field_regexes:
        return []
    compiled = [re.compile(p) for p in field_regexes]
    return [f for f in schema if any(c.fullmatch(f.name) for c in compiled)]


def dict_to_encoded_row(schema, row_dict):
    """Validate and codec-encode a row dict into parquet-storable values."""
    if not isinstance(row_dict, dict):
        raise TypeError('row must be a dict, got %s' % type(row_dict))
    unknown = set(row_dict.keys()) - set(schema.fields.keys())
    if unknown:
        raise ValueError('Attempt to write fields not in schema %s: %s'
                         % (schema._name, sorted(unknown)))
    encoded = {}
    for field in schema:
        value = row_dict.get(field.name)
        if value is None:
            if not field.nullable:
                raise ValueError('Field %r is not nullable but got None' % field.name)
            encoded[field.name] = None
        elif field.codec is not None:
            encoded[field.name] = field.codec.encode(field, value)
        else:
            encoded[field.name] = _encode_plain(field, value)
    return encoded


def insert_explicit_nulls(schema, row_dict):
    """Add an explicit ``None`` for each nullable field missing from
    ``row_dict`` (in place; returned); a missing non-nullable field raises."""
    for field in schema:
        if field.name in row_dict:
            continue
        if field.nullable:
            row_dict[field.name] = None
        else:
            raise ValueError('Field %r is not found in row and is not nullable' % field.name)
    return row_dict


def _encode_plain(field, value):
    """Encode a codec-less field: scalars, and 1-d arrays as list<primitive>
    (a >=2-d value would lose its shape in the flat list)."""
    if field.shape:
        if len(field.shape) > 1:
            raise ValueError(
                'Field %r: %d-dimensional data cannot be stored without a '
                'codec (the flat parquet list loses the shape). Use '
                'NdarrayCodec/CompressedNdarrayCodec.' % (field.name, len(field.shape)))
        arr = np.asarray(value)
        if not field.is_shape_compliant(arr.shape):
            raise ValueError('Field %r: value shape %s does not match %s'
                             % (field.name, arr.shape, field.shape))
        return arr.ravel().tolist()
    if isinstance(value, np.generic):
        return value.item()
    return value
