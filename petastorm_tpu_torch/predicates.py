"""Row-level predicates evaluated on the decode workers.

Counterpart of ``petastorm_tpu/predicates.py``: composable predicates
that declare the fields they read (``get_fields``) and vote per row
(``do_include``) or per column batch (``do_include_batch``, a boolean
mask, or None when a predicate has no columnar form). A predicate on
partition columns only prunes whole row-groups in the Reader, and
:mod:`petastorm_tpu_torch.pushdown` proves row-groups empty from footer
statistics for ``in_set``, ``in_reduce`` and DNF filters.

``in_pseudorandom_split`` buckets with the same md5 arithmetic as the JAX
package (and petastorm's), so a split keeps the same rows in both.
"""

import hashlib
from abc import ABCMeta, abstractmethod

import numpy as np


class PredicateBase(metaclass=ABCMeta):
    @abstractmethod
    def get_fields(self):
        """Set of field names this predicate reads."""

    @abstractmethod
    def do_include(self, values):
        """True to keep the row; ``values`` is a dict of the requested fields."""

    def do_include_batch(self, columns):
        """Columnar evaluation: ``columns`` maps each requested field to a
        full column (ndarray or list); returns a boolean mask over rows, or
        None when this predicate has no columnar form (the worker then
        calls ``do_include`` row by row)."""
        return None


class in_set(PredicateBase):
    """Keep rows whose field value is in a given set.

    Note ``in_set`` is a plain membership test: ``None`` in the value
    set **matches null rows** — unlike DNF ``filters`` terms, where
    nulls never match. The statistics planner
    (:mod:`petastorm_tpu_torch.pushdown`) relies on this distinction for
    null-safe row-group pruning.
    """

    def __init__(self, inclusion_values, predicate_field):
        self._values = set(inclusion_values)
        self._field = predicate_field

    @property
    def values(self):
        """The inclusion set (read-only view for the pushdown planner)."""
        return frozenset(self._values)

    @property
    def field(self):
        return self._field

    def get_fields(self):
        return {self._field}

    def do_include(self, values):
        return values[self._field] in self._values

    def do_include_batch(self, columns):
        col = columns[self._field]
        if isinstance(col, np.ndarray) and col.dtype.kind in 'iufb':
            # np.isin only when BOTH sides are plainly numeric: numpy
            # coerces mixed-type value lists (e.g. {1, 'a'} -> strings),
            # which would silently diverge from `in`-set semantics
            values_arr = np.asarray(list(self._values))
            if values_arr.dtype.kind in 'iufb':
                return np.isin(col, values_arr)
        # everything else: set-membership semantics must match the row
        # path exactly, so hash-based `in` per value (no per-row dicts)
        return np.fromiter((v in self._values for v in col),
                           dtype=bool, count=len(col))


class in_intersection(PredicateBase):
    """Keep rows whose (array) field intersects a given set."""

    def __init__(self, inclusion_values, predicate_field):
        self._values = set(inclusion_values)
        self._field = predicate_field

    def get_fields(self):
        return {self._field}

    def do_include(self, values):
        return not self._values.isdisjoint(values[self._field])

    def do_include_batch(self, columns):
        col = columns[self._field]
        return np.fromiter((not self._values.isdisjoint(v) for v in col),
                           dtype=bool, count=len(col))


class in_lambda(PredicateBase):
    """Arbitrary user function over a set of fields (runs on workers, host-side)."""

    def __init__(self, predicate_fields, predicate_func, state_arg=None):
        self._fields = set(predicate_fields)
        self._func = predicate_func
        self._state_arg = state_arg

    def get_fields(self):
        return self._fields

    def do_include(self, values):
        if self._state_arg is not None:
            return self._func(values, self._state_arg)
        return self._func(values)


class in_negate(PredicateBase):
    def __init__(self, predicate):
        self._predicate = predicate

    def get_fields(self):
        return self._predicate.get_fields()

    def do_include(self, values):
        return not self._predicate.do_include(values)

    def do_include_batch(self, columns):
        mask = self._predicate.do_include_batch(columns)
        return None if mask is None else ~np.asarray(mask, dtype=bool)


class in_reduce(PredicateBase):
    """Combine several predicates with a reduction (e.g. ``all``/``any``)."""

    def __init__(self, predicate_list, reduce_func):
        self._predicates = list(predicate_list)
        self._reduce_func = reduce_func

    @property
    def predicates(self):
        """The child predicates (read-only view for the pushdown
        planner, which prunes through ``all``/``any`` compositions)."""
        return tuple(self._predicates)

    @property
    def reduce_func(self):
        return self._reduce_func

    def get_fields(self):
        return set().union(*(p.get_fields() for p in self._predicates))

    def do_include(self, values):
        return self._reduce_func([p.do_include(values) for p in self._predicates])

    def do_include_batch(self, columns):
        masks = []
        for p in self._predicates:
            mask = p.do_include_batch(columns)
            if mask is None:  # any non-columnar child defeats the fast path
                return None
            masks.append(np.asarray(mask, dtype=bool))
        if not masks:
            return None
        if self._reduce_func is all:
            return np.logical_and.reduce(masks)
        if self._reduce_func is any:
            return np.logical_or.reduce(masks)
        n = len(masks[0])
        return np.fromiter(
            (self._reduce_func([m[i] for m in masks]) for i in range(n)),
            dtype=bool, count=n)


def _string_to_bucket(value):
    """md5 of ``str(value)`` mapped onto [0, sys.maxsize): the JAX
    package's bucketing, so splits agree value for value."""
    import sys
    digest = hashlib.md5(str(value).encode('utf-8')).hexdigest()
    return int(digest, 16) % sys.maxsize


class in_pseudorandom_split(PredicateBase):
    """Deterministic fractional split on a hash of a field value.

    ``fraction_list`` partitions [0,1); a row belongs to subset ``i`` when
    its md5 bucket (``int(md5, 16) % sys.maxsize``) falls in the i-th
    interval of ``fraction * (sys.maxsize - 1)`` borders.
    """

    def __init__(self, fraction_list, subset_index, predicate_field):
        import sys
        if not 0 <= subset_index < len(fraction_list):
            raise ValueError('subset_index out of range')
        if sum(fraction_list) > 1.0 + 1e-9:
            raise ValueError('fractions must sum to at most 1')
        self._field = predicate_field
        starts = [0.0]
        for f in fraction_list:
            starts.append(starts[-1] + f)
        self._bucket_low = starts[subset_index] * (sys.maxsize - 1)
        self._bucket_high = starts[subset_index + 1] * (sys.maxsize - 1)

    def get_fields(self):
        return {self._field}

    def do_include(self, values):
        if self._field not in values:
            raise ValueError('Tested values do not have split key: %s'
                             % self._field)
        bucket = _string_to_bucket(values[self._field])
        return self._bucket_low <= bucket < self._bucket_high

    def do_include_batch(self, columns):
        # md5 is per value, but reading the column skips the per-row dicts
        return np.fromiter(
            (self._bucket_low <= _string_to_bucket(v) < self._bucket_high
             for v in columns[self._field]),
            dtype=bool, count=len(columns[self._field]))
