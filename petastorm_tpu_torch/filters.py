"""PyArrow-style DNF ``filters`` for the reader factories.

Counterpart of ``petastorm_tpu/filters.py``. ``filters`` is a list of
``(column, op, value)`` tuples (ANDed) or a list of such lists (an OR of
AND-clauses); ops ``= == != < > <= >= in not in``. The Reader first drops
row-groups that provably cannot match (hive partition values, then footer
statistics through :mod:`petastorm_tpu_torch.pushdown`), and the workers
then filter rows exactly with :class:`FiltersPredicate`'s columnar mask.
Nulls never match a term, as in pyarrow.
"""

import numpy as np

from petastorm_tpu_torch.predicates import PredicateBase

_OPS = ('=', '==', '!=', '<', '>', '<=', '>=', 'in', 'not in')


def _is_term(t):
    return (isinstance(t, (tuple, list)) and len(t) == 3
            and isinstance(t[0], str) and isinstance(t[1], str))


def normalize_filters(filters):
    """Validate and normalize to DNF: a list of AND-clauses (each a list of
    ``(column, op, value)`` tuples). Returns None for empty input."""
    if not filters:
        return None
    if all(_is_term(t) for t in filters):
        clauses = [list(map(tuple, filters))]
    elif all(isinstance(c, (tuple, list)) and not _is_term(c)
             for c in filters):
        clauses = []
        for clause in filters:
            if not clause:
                raise ValueError('Empty AND-clause in filters')
            bad = [t for t in clause if not _is_term(t)]
            if bad:
                raise ValueError('Filter terms must be (column, op, value) '
                                 'tuples with string column/op, got %r'
                                 % (bad[0],))
            clauses.append(list(map(tuple, clause)))
    else:
        raise ValueError(
            'filters must be a flat list of (column, op, value) tuples OR a '
            'list of such lists (DNF); got a mix: %r' % (filters,))
    for clause in clauses:
        for col, op, value in clause:
            if op not in _OPS:
                raise ValueError('Unsupported filter op %r (supported: %s)'
                                 % (op, ', '.join(_OPS)))
            if op in ('in', 'not in'):
                if isinstance(value, (str, bytes)) or not hasattr(
                        value, '__iter__'):
                    raise ValueError(
                        "%r value for %r must be a non-string collection "
                        '(got %r); for a single value use %r'
                        % (op, col, value, '=' if op == 'in' else '!='))
    return clauses


def _eval_term(op, actual, value):
    if actual is None:
        return False  # pyarrow DNF semantics: nulls never match any term
    if op in ('=', '=='):
        return actual == value
    if op == '!=':
        return actual != value
    if op == '<':
        return actual < value
    if op == '>':
        return actual > value
    if op == '<=':
        return actual <= value
    if op == '>=':
        return actual >= value
    if op == 'in':
        return actual in value
    if op == 'not in':
        return actual not in value
    raise AssertionError(op)


def _eval_term_columnar(op, col, value):
    """Vectorized term over a column; ``col`` is ndarray or list.
    Nulls (None cells in object columns) never match, per pyarrow DNF."""
    arr = col if isinstance(col, np.ndarray) else np.asarray(col, dtype=object)
    if op in ('in', 'not in'):
        if arr.dtype.kind in 'iufb':
            # same dtype-guarded np.isin fast path as predicates.in_set
            values_arr = np.asarray(list(value))
            if values_arr.dtype.kind in 'iufb':
                mask = np.isin(arr, values_arr)
                return ~mask if op == 'not in' else mask
        values = set(value)
        mask = np.fromiter(
            (v is not None and v in values for v in arr),
            dtype=bool, count=len(arr))
        if op == 'not in':
            valid = np.fromiter((v is not None for v in arr),
                                dtype=bool, count=len(arr))
            return valid & ~mask
        return mask
    if arr.dtype == object:
        return np.fromiter(
            (_eval_term(op, v, value) for v in arr), dtype=bool,
            count=len(arr))
    if op in ('=', '=='):
        return arr == value
    if op == '!=':
        return arr != value
    if op == '<':
        return arr < value
    if op == '>':
        return arr > value
    if op == '<=':
        return arr <= value
    return arr >= value


class FiltersPredicate(PredicateBase):
    """DNF filters as a composable predicate with a columnar fast path."""

    def __init__(self, filters):
        clauses = normalize_filters(filters)
        if clauses is None:
            raise ValueError('filters must be non-empty')
        self._clauses = clauses
        self._fields = {term[0] for clause in clauses for term in clause}

    @property
    def clauses(self):
        return self._clauses

    def get_fields(self):
        return set(self._fields)

    def do_include(self, values):
        return any(all(_eval_term(op, values[col], v) for col, op, v in clause)
                   for clause in self._clauses)

    def do_include_batch(self, columns):
        n = len(next(iter(columns.values())))
        mask = np.zeros(n, dtype=bool)
        for clause in self._clauses:
            clause_mask = np.ones(n, dtype=bool)
            for col, op, value in clause:
                clause_mask &= np.asarray(
                    _eval_term_columnar(op, columns[col], value), dtype=bool)
                if not clause_mask.any():
                    break
            mask |= clause_mask
            if mask.all():
                break
        return mask


# ---------------------------------------------------------------------------
# Row-group pruning
# ---------------------------------------------------------------------------

def _term_maybe_matches(term, partition_values, typed_partition):
    """Conservative per-row-group test on PARTITION evidence only: False
    only when a hive partition value proves the term can match no row.
    File-column terms always maybe-match here: the statistics pass
    (:mod:`petastorm_tpu_torch.pushdown`) owns that half."""
    col, op, value = term
    if col not in partition_values:
        return True
    try:
        return bool(_eval_term(op, typed_partition(col), value))
    except TypeError:
        return True  # incomparable types: keep, the worker decides


def prune_row_group_indices(dataset_info, pieces, piece_indices, clauses,
                            stored_schema=None):
    """Drop row-group indices that provably cannot satisfy the filters.

    Two passes, cheapest first: hive partition values prune with no I/O;
    then the footer-statistics prover
    (:func:`petastorm_tpu_torch.pushdown.plan_rowgroup_pruning`, one
    footer read per file, memoized process-wide) runs over the survivors,
    when a filtered column lives in the files. ``PETASTORM_TPU_PUSHDOWN=0``
    (or ``PETASTORM_TPU_PUSHDOWN_PRUNE=0``) keeps only the first pass.
    """
    from petastorm_tpu_torch.arrow_worker import typed_partition_value

    def typed_for(piece):
        def typed(col):
            field = (stored_schema.fields.get(col)
                     if stored_schema is not None else None)
            return typed_partition_value(field, piece.partition_values[col])
        return typed

    def keep(piece):
        return any(
            all(_term_maybe_matches(t, piece.partition_values,
                                    typed_for(piece))
                for t in clause)
            for clause in clauses)

    # pass 1: partition values only (zero I/O)
    survivors = [i for i in piece_indices if keep(pieces[i])]

    needs_stats = any(
        t[0] not in pieces[i].partition_values
        for i in survivors for clause in clauses for t in clause)
    if not needs_stats:
        return survivors

    # pass 2: footer statistics for the survivors (lazy import: pushdown
    # imports this module at its top)
    from petastorm_tpu_torch import pushdown
    if not pushdown.pushdown_enabled():
        return survivors
    plan = pushdown.plan_rowgroup_pruning(dataset_info, pieces, survivors,
                                          clauses=clauses,
                                          stored_schema=stored_schema)
    return plan.kept


def describe_clauses(clauses):
    """Human-readable filter rendering for error messages."""
    return ' OR '.join(
        '(' + ' AND '.join('%s %s %r' % t for t in clause) + ')'
        for clause in clauses)


__all__ = ['FiltersPredicate', 'normalize_filters',
           'prune_row_group_indices', 'describe_clauses']
