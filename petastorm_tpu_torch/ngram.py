"""NGram: sliding-window readout over timestamp-sorted rows.

Counterpart of ``petastorm_tpu/ngram.py``. Window admission is computed
vectorized on the timestamp column (a cumulative count of delta-threshold
violations makes each window's validity an O(1) lookup), and only the
admitted windows are built. Semantics:

* ``fields``: ``{timestep(int): [UnischemaField | regex str]}``; the window
  length is ``max(keys) - min(keys) + 1``; keys may have gaps (the
  timesteps in between carry no fields but still take a row).
* ``delta_threshold``: the largest gap allowed between consecutive rows
  inside a window (inclusive), measured on ``timestamp_field``.
* ``timestamp_overlap=False``: windows may not share timestamps; a window
  is admitted only if it starts strictly after the previous admitted
  window's end.
* Rows must already be sorted by timestamp within the row-group; unsorted
  data raises ``NotImplementedError``. Windows never cross row-group
  boundaries.
"""

import numbers

import numpy as np

from petastorm_tpu_torch.unischema import UnischemaField, match_unischema_fields


class NGram:
    """Sliding-window readout: each emitted item is
    ``{timestep: namedtuple-of-fields-at-that-timestep}``."""

    def __init__(self, fields, delta_threshold, timestamp_field,
                 timestamp_overlap=True):
        self._validate(fields, delta_threshold, timestamp_field, timestamp_overlap)
        self._fields = fields
        self._delta_threshold = delta_threshold
        self._timestamp_field = timestamp_field
        self.timestamp_overlap = timestamp_overlap

    # -- construction --------------------------------------------------------

    @staticmethod
    def _validate(fields, delta_threshold, timestamp_field, timestamp_overlap):
        if not isinstance(fields, dict) or not fields:
            raise ValueError('fields must be a non-empty dict of '
                             '{timestep: [field|regex]}')
        for key, value in fields.items():
            if not isinstance(key, numbers.Integral):
                raise ValueError('fields keys must be integers; got %r' % (key,))
            if not isinstance(value, list):
                raise ValueError('Each fields value must be a list of unischema '
                                 'fields / regular expressions')
            for f in value:
                if not isinstance(f, (UnischemaField, str)):
                    raise ValueError('All field values must be UnischemaField '
                                     'or regular expression strings')
        if not isinstance(delta_threshold, numbers.Number) or \
                isinstance(delta_threshold, bool):
            raise ValueError('delta_threshold must be a number')
        if not isinstance(timestamp_field, (UnischemaField, str)):
            raise ValueError('timestamp_field must be a UnischemaField or a '
                             'regular expression string')
        if not isinstance(timestamp_overlap, bool):
            raise ValueError('timestamp_overlap must be a bool')

    @property
    def length(self):
        return max(self._fields) - min(self._fields) + 1

    @property
    def fields(self):
        return self._fields

    @property
    def delta_threshold(self):
        return self._delta_threshold

    @property
    def timestamp_field(self):
        return self._timestamp_field

    def resolve_regex_field_names(self, schema):
        """Replace regex strings in ``fields`` and ``timestamp_field`` with
        the matching :class:`UnischemaField` objects."""
        self._fields = {k: self._convert_fields(schema, v)
                        for k, v in self._fields.items()}
        ts = self._convert_fields(schema, [self._timestamp_field])
        if len(ts) != 1:
            raise ValueError('timestamp_field must match exactly one unischema '
                             'field; matched %d' % len(ts))
        self._timestamp_field = ts[0]

    @staticmethod
    def _convert_fields(schema, field_list):
        regexes = [f for f in field_list if isinstance(f, str)]
        fields = [f for f in field_list if isinstance(f, UnischemaField)]
        if len(fields) + len(regexes) != len(field_list):
            raise ValueError('fields/timestamp_field entries must be '
                             'UnischemaField objects or regex strings')
        return fields + match_unischema_fields(schema, regexes)

    # -- schema queries ------------------------------------------------------

    def get_field_names_at_timestep(self, timestep):
        if timestep not in self._fields:
            return []
        return [f.name for f in self._fields[timestep]]

    def get_schema_at_timestep(self, schema, timestep):
        # memoized per (schema, timestep): the consumer calls this once per
        # window, and building a view walks the whole schema
        cache = self.__dict__.setdefault('_view_cache', {})
        key = (id(schema), timestep)
        view = cache.get(key)
        if view is None:
            names = set(self.get_field_names_at_timestep(timestep))
            view = schema.create_schema_view(
                [schema.fields[n] for n in schema.fields if n in names])
            cache[key] = view
            # hold the schema so its id() stays unique while cached
            self.__dict__.setdefault('_view_cache_schemas', []).append(schema)
        return view

    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop('_view_cache', None)
        state.pop('_view_cache_schemas', None)
        return state

    def get_field_names_at_all_timesteps(self):
        """The union of the fields over all timesteps plus the timestamp
        field (always loaded, so window admission can be evaluated)."""
        fields = {f for flist in self._fields.values() for f in flist}
        fields.add(self._timestamp_field)
        return list(fields)

    # -- window formation ----------------------------------------------------

    def form_ngram(self, batch, schema):
        """All admitted windows of a decoded column batch, as
        ``{timestep: {field: value}}`` plain dicts; the consumer turns them
        into namedtuples with :meth:`make_namedtuple`.

        :param batch: a :class:`~petastorm_tpu_torch.arrow_worker.ColumnBatch`
            whose columns include the timestamp field.
        :param schema: the loaded :class:`Unischema` (field-name source).
        """
        ts_name = self._ts_name()
        ts = np.asarray(batch.columns[ts_name])
        n = int(ts.shape[0])
        L = self.length
        if n < L:
            return []
        if np.any(ts[1:] < ts[:-1]):
            raise NotImplementedError(
                'NGram assumes data sorted by the %s field within each '
                'row-group, which is not the case' % ts_name)
        # valid_start[i] <=> no delta violation inside rows [i, i+L)
        if L > 1:
            violations = (np.diff(ts) > self._delta_threshold).astype(np.int64)
            cum = np.concatenate([[0], np.cumsum(violations)])
            valid_start = (cum[L - 1:] - cum[:n - L + 1]) == 0
        else:
            valid_start = np.ones(n, dtype=bool)

        starts = np.flatnonzero(valid_start)
        if not self.timestamp_overlap:
            kept = []
            prev_end_ts = None
            for i in starts:
                if prev_end_ts is not None and ts[i] <= prev_end_ts:
                    continue
                kept.append(i)
                prev_end_ts = ts[i + L - 1]
            starts = kept

        base = min(self._fields)
        ts_names = {k: list(self.get_schema_at_timestep(schema, k).fields)
                    for k in self._fields}
        windows = []
        for i in starts:
            window = {}
            for key in self._fields:
                offset = int(i) + (key - base)
                window[key] = {name: batch.columns[name][offset]
                               for name in ts_names[key]}
            windows.append(window)
        return windows

    def make_namedtuple(self, schema, ngram_as_dicts):
        """``{timestep: dict}`` → ``{timestep: namedtuple}`` using the
        schema view at each timestep."""
        out = {}
        for timestep, row in ngram_as_dicts.items():
            view = self.get_schema_at_timestep(schema, timestep)
            out[timestep] = view.make_namedtuple(**row)
        return out

    def _ts_name(self):
        ts = self._timestamp_field
        return ts.name if isinstance(ts, UnischemaField) else ts

    # -- comparison ----------------------------------------------------------

    def __eq__(self, other):
        if not isinstance(other, NGram):
            return NotImplemented
        if set(self._fields) != set(other._fields):
            return False
        return all(set(self._fields[k]) == set(other._fields[k])
                   for k in self._fields)

    def __ne__(self, other):
        return not self == other
