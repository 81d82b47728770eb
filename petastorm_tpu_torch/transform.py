"""TransformSpec: user transforms run on the decode workers (counterpart of
``petastorm_tpu/transform.py``). The callable receives a whole row-group
as a pandas DataFrame; device-side transforms belong in
:mod:`petastorm_tpu_torch.ops`."""

from petastorm_tpu_torch.errors import unported
from petastorm_tpu_torch.unischema import Unischema, UnischemaField


class TransformSpec:
    """A worker-side transform and its effect on the schema.

    :param func: callable on a row-group pandas DataFrame (None for pure
        schema edits).
    :param edit_fields: ``UnischemaField``s (or ``(name, numpy_dtype,
        shape, nullable)`` tuples) added or replaced by the transform.
    :param removed_fields: field names the transform deletes.
    :param selected_fields: if not None, exactly these fields remain, in
        this order (exclusive with ``removed_fields``).
    :param cacheable: the decoded cache's opt-in; not ported yet.
    """

    def __init__(self, func=None, edit_fields=None, removed_fields=None,
                 selected_fields=None, cacheable=None):
        if cacheable is not None:
            raise unported('TransformSpec(cacheable=)', 3)
        if removed_fields and selected_fields:
            raise ValueError('removed_fields and selected_fields are mutually exclusive')
        self.func = func
        self.edit_fields = [self._as_field(f) for f in (edit_fields or [])]
        self.removed_fields = list(removed_fields or [])
        self.selected_fields = list(selected_fields) if selected_fields is not None else None

    @staticmethod
    def _as_field(f):
        if isinstance(f, UnischemaField):
            return f
        name, numpy_dtype, shape, nullable = f
        return UnischemaField(name, numpy_dtype, shape, None, nullable)

    def __call__(self, data):
        return self.func(data) if self.func is not None else data


def transform_schema(schema, transform_spec):
    """Apply a TransformSpec's declarative edits to a schema."""
    edited = dict(schema.fields)
    for f in transform_spec.edit_fields:
        edited[f.name] = f
    for name in transform_spec.removed_fields:
        edited.pop(name, None)
    if transform_spec.selected_fields is not None:
        missing = [n for n in transform_spec.selected_fields if n not in edited]
        if missing:
            raise ValueError('selected_fields not present after edits: %s' % missing)
        ordered = [edited[n] for n in transform_spec.selected_fields]
    else:
        ordered = list(edited.values())
    return Unischema('%s_transformed' % schema._name, ordered)
