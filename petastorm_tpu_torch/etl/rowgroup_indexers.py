"""Built-in row-group indexers (counterpart of
``petastorm_tpu/etl/rowgroup_indexers.py``); their JSON forms are the
reference's, so either package reads the other's footer index."""

from collections import defaultdict

from petastorm_tpu_torch.etl import RowGroupIndexerBase


class SingleFieldIndexer(RowGroupIndexerBase):
    """Maps every observed value of one field to the set of row-group
    ordinals holding it. Values are stringified: the footer form is JSON."""

    def __init__(self, index_name, index_field):
        self._index_name = index_name
        self._field = index_field
        self._index = defaultdict(set)

    @property
    def index_name(self):
        return self._index_name

    @property
    def column_names(self):
        return [self._field]

    @property
    def indexed_values(self):
        return list(self._index.keys())

    def get_row_group_indexes(self, value_key):
        return self._index.get(str(value_key), set())

    def build_index(self, decoded_rows, piece_index):
        for row in decoded_rows:
            value = row[self._field]
            if value is None:
                continue
            self._index[str(value)].add(piece_index)

    def __add__(self, other):
        if self._field != other._field:
            raise ValueError('Cannot merge indexers of different fields')
        merged = SingleFieldIndexer(self._index_name, self._field)
        for value, groups in self._index.items():
            merged._index[value] |= groups
        for value, groups in other._index.items():
            merged._index[value] |= groups
        return merged

    def to_json_dict(self):
        return {'type': 'SingleFieldIndexer', 'index_name': self._index_name,
                'field': self._field,
                'index': {k: sorted(v) for k, v in self._index.items()}}

    @classmethod
    def from_json_dict(cls, d):
        idx = cls(d['index_name'], d['field'])
        for value, groups in d['index'].items():
            idx._index[value] = set(groups)
        return idx


class FieldNotNullIndexer(RowGroupIndexerBase):
    """The row-groups holding at least one non-null value of a field."""

    def __init__(self, index_name, index_field):
        self._index_name = index_name
        self._field = index_field
        self._not_null_groups = set()

    @property
    def index_name(self):
        return self._index_name

    @property
    def column_names(self):
        return [self._field]

    @property
    def indexed_values(self):
        return ['false_values_not_indexed']

    def get_row_group_indexes(self, value_key=None):
        return self._not_null_groups

    def build_index(self, decoded_rows, piece_index):
        for row in decoded_rows:
            if row[self._field] is not None:
                self._not_null_groups.add(piece_index)
                return

    def to_json_dict(self):
        return {'type': 'FieldNotNullIndexer', 'index_name': self._index_name,
                'field': self._field, 'groups': sorted(self._not_null_groups)}

    @classmethod
    def from_json_dict(cls, d):
        idx = cls(d['index_name'], d['field'])
        idx._not_null_groups = set(d['groups'])
        return idx


_INDEXER_TYPES = {
    'SingleFieldIndexer': SingleFieldIndexer,
    'FieldNotNullIndexer': FieldNotNullIndexer,
}


def indexer_from_json(d):
    """The indexer a ``to_json_dict`` form describes."""
    if d['type'] not in _INDEXER_TYPES:
        raise ValueError('Unknown indexer type %r' % d['type'])
    return _INDEXER_TYPES[d['type']].from_json_dict(d)
