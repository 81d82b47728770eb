"""Statistics-driven row-group pruning: the selective-read planner.

Counterpart of ``petastorm_tpu/pushdown.py``. Before any row-group is
ventilated, the planner reads each Parquet file's footer (one read per
file, memoized process-wide by file identity, so later readers of the same
dataset read no footer) and proves row-groups empty against the predicate
from their column statistics (min, max, null count). The Reader never
ventilates a proven-empty row-group: its items stay in the item list and
count as completed with zero rows, so shard assignment, item indices and
``state_dict`` are those of an unpruned reader.

Whatever is uncertain is kept: a failed footer read, a column without
statistics, an incomparable type, an arbitrary predicate. A wrong prune
would lose rows silently.

What the prover understands (anything else declines as
``arbitrary-predicate``):

* :class:`~petastorm_tpu_torch.filters.FiltersPredicate`: interval logic
  per DNF clause. Equality, range and ``in`` terms prune on the non-null
  min/max alone (a null cell, None in an object column or NaN in a
  numeric one, never compares true there); ``!=`` and ``not in`` also
  need a null-free row-group with non-float statistics, because a NaN
  cell IS ``!=`` any value at worker evaluation.
* :class:`~petastorm_tpu_torch.predicates.in_set`: interval logic over the
  value set; ``None`` in the set matches null rows, so a row-group that
  may hold nulls is then never pruned.
* :class:`~petastorm_tpu_torch.predicates.in_reduce`: with ``all``, pruned
  when any prunable child proves the row-group empty; with ``any``, only
  when every child is prunable and proves it empty.

Knobs: ``PETASTORM_TPU_PUSHDOWN=0`` turns the planner and the worker's
late materialization off (the decode-everything-then-filter oracle);
``PETASTORM_TPU_PUSHDOWN_PRUNE=0`` turns only the planner off;
``PETASTORM_TPU_PUSHDOWN_WORKERS`` sets the footer-read threads (8).
The public read of the plans and counters is
``pipeline_report()['pushdown']``, built from :func:`planner_summary`
and the counters below. The JAX
package's fault-injection site in the footer read waits for the port of
``faults.py`` (ROADMAP item 3, caches).
"""

import logging
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

from petastorm_tpu_torch import filters as _filters
from petastorm_tpu_torch.predicates import in_reduce, in_set
from petastorm_tpu_torch.telemetry import get_registry, knobs, metrics_disabled

logger = logging.getLogger(__name__)

#: registry counters: row-groups and rows the planner pruned (counted at
#: Reader construction), and rows whose heavy columns the workers decoded
#: only after the predicate kept them
ROWGROUPS_PRUNED = 'petastorm_tpu_rowgroups_pruned_total'
ROWS_PRUNED = 'petastorm_tpu_rows_pruned_total'
LATE_MATERIALIZED_ROWS = 'petastorm_tpu_late_materialized_rows_total'

#: decline reasons in the planner summary: ``arbitrary-predicate`` and
#: ``low-selectivity`` count planner runs, ``no-statistics`` counts
#: row-groups kept for want of usable statistics
DECLINE_ARBITRARY = 'arbitrary-predicate'
DECLINE_NO_STATS = 'no-statistics'
DECLINE_LOW_SELECTIVITY = 'low-selectivity'

#: process-wide footer memo: (dataset url, file path, size-mtime) ->
#: per-row-group [(column stats, num_rows), ...]; FIFO-bounded, and a
#: rewritten file changes its key
_FOOTER_CACHE_MAX_FILES = 4096
_footer_cache_lock = threading.Lock()
_footer_cache = OrderedDict()

_summary_lock = threading.Lock()


def _fresh_summary():
    return {'planner_runs': 0, 'rowgroups_considered': 0,
            'rowgroups_pruned': 0, 'rows_pruned': 0, 'declines': {}}


_summary = _fresh_summary()


def pushdown_enabled():
    """The planner's gate, read at Reader construction:
    ``PETASTORM_TPU_PUSHDOWN=0`` and ``PETASTORM_TPU_PUSHDOWN_PRUNE=0``
    both turn it off."""
    return (not knobs.is_disabled('PETASTORM_TPU_PUSHDOWN')
            and not knobs.is_disabled('PETASTORM_TPU_PUSHDOWN_PRUNE'))


def fullscan_oracle():
    """True when ``PETASTORM_TPU_PUSHDOWN=0`` asks the workers for the
    decode-everything-then-filter shape: the comparison baseline of the
    parity tests, never the default."""
    return knobs.is_disabled('PETASTORM_TPU_PUSHDOWN')


def planner_summary():
    """This process's planner activity: runs, row-groups considered and
    pruned, rows pruned, decline reasons."""
    with _summary_lock:
        out = dict(_summary)
        out['declines'] = dict(_summary['declines'])
        return out


def reset_for_tests():
    """A fresh planner summary and an empty footer memo."""
    global _summary
    with _summary_lock:
        _summary = _fresh_summary()
    with _footer_cache_lock:
        _footer_cache.clear()


def _note_run(considered, pruned=0, rows=0, declines=None):
    with _summary_lock:
        _summary['planner_runs'] += 1
        _summary['rowgroups_considered'] += considered
        _summary['rowgroups_pruned'] += pruned
        _summary['rows_pruned'] += rows
        for reason, count in (declines or {}).items():
            if count:
                _summary['declines'][reason] = _summary['declines'].get(reason, 0) + count


def dataset_file_fingerprint(dataset_info, path):
    """Identity of one file's bytes: ``'<size>-<mtime>'`` when the
    filesystem gives them, else ``'nostat'``."""
    try:
        info = dataset_info.fs.info(path)
        size = info.get('size')
        mtime = info.get('mtime') or info.get('LastModified')
        return '%s-%s' % (size, mtime)
    except Exception:  # noqa: BLE001 - an exotic filesystem: no identity
        return 'nostat'


# -- footer statistics index -------------------------------------------------


class StatsIndex:
    """Per-file footer statistics, read lazily and in parallel
    (``PETASTORM_TPU_PUSHDOWN_WORKERS`` threads) and memoized process-wide
    by file identity; a file whose footer fails to read yields None, and
    every one of its row-groups is kept."""

    def __init__(self, dataset_info):
        self._info = dataset_info
        self._per_file = {}

    def prefetch(self, paths):
        todo = sorted(set(paths) - set(self._per_file))
        if not todo:
            return
        workers = knobs.get_int('PETASTORM_TPU_PUSHDOWN_WORKERS', 8, floor=1)
        with ThreadPoolExecutor(max_workers=min(workers, len(todo))) as ex:
            for path, stats in zip(todo, ex.map(self._load, todo)):
                self._per_file[path] = stats

    def get(self, path, row_group):
        """``(column stats dict, num_rows)`` of one row-group, or None when
        its file has no statistics."""
        stats = self._per_file.get(path)
        if stats is None or row_group >= len(stats):
            return None
        return stats[row_group]

    def _load(self, path):
        key = None
        fingerprint = dataset_file_fingerprint(self._info, path)
        if fingerprint != 'nostat':
            # an unidentifiable file is read every time rather than risk
            # stale statistics
            key = (str(self._info.url), path, fingerprint)
            with _footer_cache_lock:
                if key in _footer_cache:
                    _footer_cache.move_to_end(key)
                    return _footer_cache[key]
        stats = self._read_footer(path)
        if stats is not None and key is not None:
            with _footer_cache_lock:
                _footer_cache[key] = stats
                while len(_footer_cache) > _FOOTER_CACHE_MAX_FILES:
                    _footer_cache.popitem(last=False)
        return stats

    def _read_footer(self, path):
        import pyarrow.parquet as pq
        try:
            with self._info.fs.open(path, 'rb') as f:
                meta = pq.ParquetFile(f).metadata
        except Exception:  # noqa: BLE001 - degrade to unpruned, loudly
            logger.warning('pushdown: failed to read parquet footer of %s; its '
                           'row-groups will not be pruned', path, exc_info=True)
            return None
        out = []
        for rg in range(meta.num_row_groups):
            row_group = meta.row_group(rg)
            cols = {}
            for ci in range(row_group.num_columns):
                col = row_group.column(ci)
                st = col.statistics
                if st is None or not st.has_min_max:
                    continue
                null_count = int(st.null_count) if st.has_null_count else None
                cols[col.path_in_schema.split('.')[0]] = (st.min, st.max, null_count)
            out.append((cols, int(row_group.num_rows)))
        return out


# -- the prover --------------------------------------------------------------


class _Ctx:
    """One row-group's evidence: hive partition values (exact) and footer
    column statistics (min/max over the non-null values and the null
    count; None when the footer was unreadable). ``missing`` is set by a
    term that wanted statistics and found none."""

    __slots__ = ('partition_values', 'stats', 'missing', '_schema')

    def __init__(self, piece, stats, stored_schema):
        self.partition_values = piece.partition_values
        self.stats = stats
        self.missing = False
        self._schema = stored_schema

    def typed(self, col):
        from petastorm_tpu_torch.arrow_worker import typed_partition_value
        field = self._schema.fields.get(col) if self._schema is not None else None
        return typed_partition_value(field, self.partition_values.get(col))

    def column_stats(self, col):
        if self.stats is None:
            self.missing = True
            return None
        st = self.stats.get(col)
        if st is None:
            self.missing = True
        return st


def _may_have_nulls(null_count):
    return null_count is None or null_count > 0


def _negative_op_unprovable(lo, hi, null_count):
    """A ``!=``/``not in`` term cannot be proven empty when the row-group
    may hold a null (numeric nulls decode to NaN) or its statistics are
    float (a stored NaN is left out of min/max without counting as a
    null): ``NaN != value`` is true at worker evaluation."""
    return _may_have_nulls(null_count) or isinstance(lo, float) or isinstance(hi, float)


def _term_provably_empty(term, ctx):
    """True when no row of the row-group can satisfy one DNF term;
    anything incomparable keeps the row-group."""
    col, op, value = term
    if col in ctx.partition_values:
        try:
            return not _filters._eval_term(op, ctx.typed(col), value)
        except TypeError:
            return False
    st = ctx.column_stats(col)
    if st is None:
        return False
    lo, hi, null_count = st
    try:
        if op in ('=', '=='):
            return not bool(lo <= value <= hi)
        if op == '!=':
            return bool(lo == hi == value) and not _negative_op_unprovable(lo, hi, null_count)
        if op == '<':
            return not bool(lo < value)
        if op == '>':
            return not bool(hi > value)
        if op == '<=':
            return not bool(lo <= value)
        if op == '>=':
            return not bool(hi >= value)
        if op == 'in':
            # a None member matches neither a None nor a NaN cell under `in`
            return not any(v is not None and bool(lo <= v <= hi) for v in value)
        if op == 'not in':
            return (bool(lo == hi) and lo in set(value)
                    and not _negative_op_unprovable(lo, hi, null_count))
    except TypeError:
        return False
    return False


def _compile_clauses(clauses):
    """Prover for DNF clauses: empty iff every OR-clause is empty, and an
    AND-clause is empty iff any of its terms matches nothing."""
    fields = {t[0] for clause in clauses for t in clause}

    def prove(ctx):
        return all(any(_term_provably_empty(t, ctx) for t in clause) for clause in clauses)

    return prove, fields


def _compile_in_set(field, values):
    """Prover for ``in_set``: ``None`` in the set matches null rows, so a
    row-group that may hold nulls then stays."""
    matches_null = any(v is None for v in values)

    def prove(ctx):
        if field in ctx.partition_values:
            try:
                return ctx.typed(field) not in values
            except TypeError:
                return False
        st = ctx.column_stats(field)
        if st is None:
            return False
        lo, hi, null_count = st
        if matches_null and _may_have_nulls(null_count):
            return False
        try:
            return not any(v is not None and bool(lo <= v <= hi) for v in values)
        except TypeError:
            return False

    return prove, {field}


def _compile(predicate):
    """Predicate tree -> ``(prove_empty(ctx), fields)``, or None when no
    part of the tree is understood."""
    if isinstance(predicate, _filters.FiltersPredicate):
        return _compile_clauses(predicate.clauses)
    if isinstance(predicate, in_set):
        return _compile_in_set(predicate.field, predicate.values)
    if isinstance(predicate, in_reduce):
        children = [_compile(p) for p in predicate.predicates]
        if predicate.reduce_func is all:
            # AND: an arbitrary child just brings no evidence
            usable = [c for c in children if c is not None]
            if not usable:
                return None

            def prove_all(ctx):
                return any(prove(ctx) for prove, _ in usable)

            return prove_all, set().union(*(f for _, f in usable))
        if predicate.reduce_func is any:
            if not children or any(c is None for c in children):
                return None

            def prove_any(ctx):
                return all(prove(ctx) for prove, _ in children)

            return prove_any, set().union(*(f for _, f in children))
    return None


# -- the planner -------------------------------------------------------------


class PushdownPlan:
    """One Reader's pruning decision: ``kept``/``pruned`` piece indices
    (``pruned`` provably deliver no row), ``rows_pruned`` from the
    footers, and ``decline``, the reason nothing could be pruned (None
    when the prover ran)."""

    __slots__ = ('kept', 'pruned', 'rows_pruned', 'considered', 'no_stats_rowgroups',
                 'decline')

    def __init__(self, kept, pruned, rows_pruned, considered, no_stats_rowgroups, decline):
        self.kept = kept
        self.pruned = pruned
        self.rows_pruned = rows_pruned
        self.considered = considered
        self.no_stats_rowgroups = no_stats_rowgroups
        self.decline = decline


def plan_rowgroup_pruning(dataset_info, pieces, piece_indices, predicate=None, clauses=None,
                          stored_schema=None):
    """Prove row-groups empty against a predicate tree (``predicate=``) or
    normalized DNF ``clauses`` (the ``filters=`` path) before any is
    ventilated. Only provably empty row-groups land in ``plan.pruned``."""
    piece_indices = list(piece_indices)
    considered = len(piece_indices)
    compiled = _compile_clauses(clauses) if clauses is not None else _compile(predicate)
    if compiled is None:
        _note_run(considered, declines={DECLINE_ARBITRARY: 1})
        return PushdownPlan(kept=piece_indices, pruned=[], rows_pruned=0,
                            considered=considered, no_stats_rowgroups=0,
                            decline=DECLINE_ARBITRARY)
    prove, fields = compiled

    index = StatsIndex(dataset_info)
    index.prefetch({pieces[i].path for i in piece_indices
                    if any(f not in pieces[i].partition_values for f in fields)})

    kept, pruned = [], []
    rows_pruned = 0
    no_stats = 0
    for i in piece_indices:
        piece = pieces[i]
        entry = index.get(piece.path, piece.row_group)
        cols, num_rows = entry if entry is not None else (None, 0)
        ctx = _Ctx(piece, cols, stored_schema)
        if prove(ctx):
            pruned.append(i)
            rows_pruned += num_rows
        else:
            kept.append(i)
            if ctx.missing:
                no_stats += 1

    declines = {}
    if no_stats:
        declines[DECLINE_NO_STATS] = no_stats
    if not pruned and not no_stats:
        # usable statistics everywhere, and every row-group's range matches
        declines[DECLINE_LOW_SELECTIVITY] = 1
    _note_run(considered, pruned=len(pruned), rows=rows_pruned, declines=declines)
    if pruned and not metrics_disabled():
        registry = get_registry()
        registry.counter(ROWGROUPS_PRUNED).inc(len(pruned))
        if rows_pruned:
            registry.counter(ROWS_PRUNED).inc(rows_pruned)
    if pruned:
        logger.debug('pushdown: pruned %d/%d row-group(s) (%d rows) against the predicate',
                     len(pruned), considered, rows_pruned)
    return PushdownPlan(kept=kept, pruned=pruned, rows_pruned=rows_pruned,
                        considered=considered, no_stats_rowgroups=no_stats, decline=None)
