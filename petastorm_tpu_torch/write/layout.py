"""Read-optimized layout: row-groups sized to the readahead window, and the
post-write self-check that proves it.

Counterpart of ``petastorm_tpu/write/layout.py``. A row-group whose column
chunks coalesce under the readahead window
(``PETASTORM_TPU_READAHEAD_MAX_RANGE_MB``/``_GAP_KB``) is read in a few
sequential ranges, and footers with statistics and sorted-column metadata
let pushdown prune instead of scan. :func:`self_check` reads a freshly
written dataset's footers back through the read path's own planners
(``pushdown.StatsIndex``, ``readahead.coalesce_ranges``) and reports the
predicted prune and coalesce quality, so a layout that reads
full-scan-priced is caught at write time.
"""

import logging

from petastorm_tpu_torch import readahead
from petastorm_tpu_torch.etl.dataset_metadata import (
    DEFAULT_ROW_GROUP_SIZE_MB, ParquetDatasetInfo, load_row_groups,
)
from petastorm_tpu_torch.telemetry import knobs

logger = logging.getLogger(__name__)

_MB = 1024 * 1024

#: the self-check warns when fewer of a dataset's coalesced reads than
#: this share fit one readahead window
_FITS_WINDOW_FLOOR = 0.8
#: ... or, on a sorted dataset, when a mid-range point probe on the sort
#: key would prune fewer row-groups than this share
_PRUNE_SHARE_FLOOR = 0.5


def target_rowgroup_bytes():
    """The write plane's row-group byte target:
    ``PETASTORM_TPU_WRITE_ROWGROUP_MB`` when set, else the smaller of the
    classic 32 MB parquet block and the readahead window (a row-group
    larger than the window is never fetched as one coalesced read)."""
    configured = knobs.get_int('PETASTORM_TPU_WRITE_ROWGROUP_MB', 0, floor=0)
    if configured:
        return configured * _MB
    return min(DEFAULT_ROW_GROUP_SIZE_MB * _MB, readahead.max_range_bytes())


def _overlaps(lo, hi, value):
    try:
        return lo <= value <= hi
    except TypeError:  # statistics of another type: kept, as pushdown keeps them
        return True


def self_check(dataset_url_or_info, sort_key=None, storage_options=None):
    """Layout quality of a dataset through the read path's planners, from
    its footers alone (no data page is read). Returns::

        {'files': N, 'row_groups': N,
         'stats_coverage': share of row-groups with min/max statistics,
         'predicted_prune_share': share a mid-range point predicate on
                                  sort_key prunes (None without one),
         'sort_key': the checked key or None,
         'coalesce': {'raw_ranges', 'coalesced_ranges', 'ratio',
                      'mean_range_bytes', 'fits_window_share'} or None,
         'warnings': [strings]}
    """
    from petastorm_tpu_torch.pushdown import StatsIndex

    info = (dataset_url_or_info if isinstance(dataset_url_or_info, ParquetDatasetInfo)
            else ParquetDatasetInfo(dataset_url_or_info, storage_options))
    pieces = load_row_groups(info)
    index = StatsIndex(info)
    index.prefetch({p.path for p in pieces})
    gap = readahead.gap_bytes()
    window = readahead.max_range_bytes()

    with_stats = 0
    key_ranges = []
    raw_ranges = 0
    coalesced = []
    for piece in pieces:
        got = index.get(piece.path, piece.row_group)
        if got is not None and got[0]:
            with_stats += 1
            if sort_key is not None and sort_key in got[0]:
                lo, hi, _ = got[0][sort_key]
                key_ranges.append((lo, hi))
        ranges = index.get_ranges(piece.path, piece.row_group)
        if ranges:
            chunks = sorted(r for per_col in ranges.values() for r in per_col)
            raw_ranges += len(chunks)
            coalesced.extend(readahead.coalesce_ranges(chunks, gap, window))

    total = len(pieces)
    report = {
        'files': len(info.file_paths),
        'row_groups': total,
        'stats_coverage': (with_stats / total) if total else 0.0,
        'sort_key': sort_key,
        'predicted_prune_share': None,
        'coalesce': None,
        'warnings': [],
    }
    if coalesced:
        lengths = [length for _, length in coalesced]
        report['coalesce'] = {
            'raw_ranges': raw_ranges,
            'coalesced_ranges': len(coalesced),
            'ratio': raw_ranges / len(coalesced),
            'mean_range_bytes': int(sum(lengths) / len(lengths)),
            'fits_window_share': sum(1 for n in lengths if n <= window) / len(lengths),
        }
    if sort_key is not None and key_ranges and total:
        # a point probe at the median low bound: on a sorted layout each
        # value lands in about one row-group; overlapping spans are what
        # defeat pushdown on real predicates
        lows = sorted(lo for lo, _ in key_ranges)
        probe = lows[len(lows) // 2]
        kept = sum(1 for lo, hi in key_ranges if _overlaps(lo, hi, probe))
        kept += total - len(key_ranges)  # row-groups without statistics are never pruned
        report['predicted_prune_share'] = 1.0 - kept / total
    _warn(report, total)
    return report


def _warn(report, total):
    """Attach the self-check's warnings to ``report`` and log them."""
    warnings = report['warnings']
    if total and report['stats_coverage'] < 1.0:
        warnings.append(
            'footer statistics missing on %.0f%% of row-groups — pushdown will decline '
            'with no-statistics; rewrite with write_statistics=True (DatasetWriter '
            'default)' % (100 * (1 - report['stats_coverage'])))
    prune = report['predicted_prune_share']
    if prune is not None and total > 2 and prune < _PRUNE_SHARE_FLOOR:
        warnings.append(
            'sort key %r prunes only %.0f%% of row-groups on a point probe — row-group '
            'key spans overlap; feed rows in sorted order or re-shard with '
            'compact_dataset(sort_key=...)' % (report['sort_key'], 100 * prune))
    co = report['coalesce']
    if co is not None and co['fits_window_share'] < _FITS_WINDOW_FLOOR:
        warnings.append(
            'only %.0f%% of coalesced reads fit one readahead window — row-groups are '
            'larger than PETASTORM_TPU_READAHEAD_MAX_RANGE_MB; lower '
            'PETASTORM_TPU_WRITE_ROWGROUP_MB toward the window'
            % (100 * co['fits_window_share']))
    for message in warnings:
        logger.warning('write layout self-check: %s', message)
