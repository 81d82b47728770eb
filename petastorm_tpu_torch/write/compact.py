"""Compaction: fold small part files into readahead-sized ones, atomically.

Counterpart of ``petastorm_tpu/write/compact.py``. Appends land many small
part files, each a footer read and a request of its own.
:func:`compact_dataset` folds them:

* **At the arrow level.** Source parts are read as arrow tables,
  concatenated (and sorted by the dataset's sort key) and rewritten in
  row-groups near the layout's byte target; cells stay codec-encoded
  bytes, so the schema is untouched.
* **Atomic swap.** Folded files are published tmp + rename, then one
  manifest swap replaces the source entries with them. A reader that
  resolved the previous generation keeps reading the old files (on disk
  until :func:`~petastorm_tpu_torch.write.manifest.gc_superseded`); one
  that resolves after the swap sees only folded files. The commit section
  holds the manifest lease, so a racing append rebases instead of being
  lost.
* **A standing job.** :class:`CompactionDaemon` re-plans on an interval and
  folds whenever at least ``PETASTORM_TPU_COMPACT_MIN_FILES`` parts are
  under the ``PETASTORM_TPU_COMPACT_TARGET_MB`` target.
"""

import json
import logging
import posixpath
import threading

import pyarrow as pa
import pyarrow.parquet as pq

from petastorm_tpu_torch import faults
from petastorm_tpu_torch.etl.dataset_metadata import (
    LEGACY_ROW_GROUPS_PER_FILE_KEY, ROW_GROUPS_PER_FILE_KEY, ParquetDatasetInfo,
    _row_group_counts_from_common_metadata, update_dataset_metadata,
)
from petastorm_tpu_torch.fs import get_filesystem_and_path_or_paths, normalize_dir_url
from petastorm_tpu_torch.telemetry import get_registry, knobs, metrics_disabled, span
from petastorm_tpu_torch.write import layout, manifest
from petastorm_tpu_torch.write.manifest import TMP_PREFIX

logger = logging.getLogger(__name__)

COMPACT_RUNS = 'petastorm_tpu_compact_runs_total'
COMPACT_FILES_FOLDED = 'petastorm_tpu_compact_files_folded_total'

_MB = 1024 * 1024


def target_file_bytes():
    """The fold target, ``PETASTORM_TPU_COMPACT_TARGET_MB`` (default 64 MB:
    a few readahead-window row-groups a file)."""
    return knobs.get_int('PETASTORM_TPU_COMPACT_TARGET_MB', 64, floor=1) * _MB


def min_files():
    return knobs.get_int('PETASTORM_TPU_COMPACT_MIN_FILES', 4, floor=2)


def plan_compaction(committed, target_bytes=None, minimum=None):
    """Groups of manifest entries worth folding: runs of files under the
    target (in manifest path order), packed greedily up to
    ``target_bytes`` a fold. Returns ``[[entry, ...], ...]``, empty when
    nothing is worth folding."""
    target = target_bytes or target_file_bytes()
    small = [e for e in committed['files'] if e['bytes'] < target]
    if len(small) < (minimum or min_files()):
        return []
    groups = []
    group = []
    group_bytes = 0
    for entry in small:
        if group and group_bytes + entry['bytes'] > target:
            groups.append(group)
            group, group_bytes = [], 0
        group.append(entry)
        group_bytes += entry['bytes']
    groups.append(group)
    return [g for g in groups if len(g) >= 2]


def _fold_group(fs, root_path, group, generation, group_id, rowgroup_bytes, sort_key=None):
    """Rewrite one group's rows into one tmp part, rename it into place and
    return its manifest entry (``replaces`` names the sources)."""
    with span('compact'):
        tables = []
        for entry in group:
            with fs.open(posixpath.join(root_path, entry['path']), 'rb') as f:
                tables.append(pq.read_table(f))
        folded = pa.concat_tables(tables)
        sorting = None
        if sort_key is not None and sort_key in folded.schema.names:
            # the fold keeps (or, after appends interleaved key ranges,
            # restores) the declared order, and restamps it in the footer
            folded = folded.sort_by(sort_key)
            sorting = [pq.SortingColumn(folded.schema.get_field_index(sort_key))]
        final_name = 'part-g%04d-c%05d-00000.parquet' % (generation, group_id)
        final_path = posixpath.join(root_path, final_name)
        tmp_path = posixpath.join(root_path, TMP_PREFIX + final_name)
        if faults.ARMED:
            faults.fault_hit('io.write', key='%s#part' % final_path)
        # rows a row-group so that each lands near the layout's byte target
        bytes_per_row = max(1, folded.nbytes // max(1, folded.num_rows))
        rows_per_group = max(1, rowgroup_bytes // bytes_per_row)
        with fs.open(tmp_path, 'wb') as sink:
            pq.write_table(folded, sink, row_group_size=rows_per_group,
                           write_statistics=True, sorting_columns=sorting)
        if faults.ARMED:
            faults.fault_hit('io.write', key='%s#rename' % final_path)
        try:
            fs.mv(tmp_path, final_path)
        except FileExistsError:
            fs.rm(final_path)
            fs.mv(tmp_path, final_path)
    with fs.open(final_path, 'rb') as f:
        meta = pq.read_metadata(f)
    return manifest.file_entry(final_name, meta.num_rows, meta.num_row_groups,
                               int(fs.info(final_path)['size']), source='compact',
                               replaces=[e['path'] for e in group])


def compact_dataset(dataset_url, storage_options=None, target_bytes=None, minimum=None,
                    gc_grace_s=None):
    """One compaction pass. Returns the new committed manifest, or None
    when there was nothing to fold (or no manifest to fold under).

    The fold runs without the lease; the commit section (rebase onto the
    latest manifest, footer restamp, swap) holds it, so an append that
    landed mid-fold keeps its files, and a fold whose sources a concurrent
    committer already replaced is dropped rather than resurrecting rows.
    Source files stay on disk for readers of the previous generation;
    ``gc_grace_s`` also sweeps superseded files once the swap is that
    old."""
    url = normalize_dir_url(dataset_url)
    fs, root_path = get_filesystem_and_path_or_paths(url, storage_options)
    committed = manifest.load(fs, root_path)
    if committed is None:
        return None
    groups = plan_compaction(committed, target_bytes, minimum)
    if not groups:
        return None
    generation = committed['generation'] + 1
    rowgroup_bytes = layout.target_rowgroup_bytes()
    folded_entries = [_fold_group(fs, root_path, group, generation, group_id, rowgroup_bytes,
                                  sort_key=committed.get('sort_key'))
                      for group_id, group in enumerate(groups)]
    with manifest.commit_lock(fs, root_path):
        latest = manifest.load(fs, root_path) or committed
        latest_paths = {e['path'] for e in latest['files']}
        surviving_folds = []
        for entry in folded_entries:
            if all(p in latest_paths for p in entry['replaces']):
                surviving_folds.append(entry)
                continue
            try:
                fs.rm(posixpath.join(root_path, entry['path']))
            except (OSError, ValueError):
                pass
        if not surviving_folds:
            return None
        generation = latest['generation'] + 1
        replaced = {p for e in surviving_folds for p in e['replaces']}
        survivors = [e for e in latest['files'] if e['path'] not in replaced]
        new_manifest = manifest.build_manifest(survivors + surviving_folds,
                                               generation=generation,
                                               sort_key=latest.get('sort_key'))
        _restamp_footer(url, fs, root_path, new_manifest, storage_options)
        published = manifest.publish(fs, root_path, new_manifest, locked=True)
    if not metrics_disabled():
        registry = get_registry()
        registry.counter(COMPACT_RUNS).inc()
        registry.counter(COMPACT_FILES_FOLDED).inc(len(replaced))
    logger.info('compact: folded %d file(s) into %d under %s (generation %d)',
                len(replaced), len(surviving_folds), root_path, generation)
    if gc_grace_s is not None:
        manifest.gc_superseded(fs, root_path, grace_s=gc_grace_s)
    return published


def _restamp_footer(url, fs, root_path, new_manifest, storage_options):
    """Refresh the row-group counts in ``_common_metadata`` for the new
    file set, merged over the stamped ones, so a reader holding the
    previous generation's list still finds its files' counts. The other
    entries stay as they are (the original petastorm's count key is
    restamped too when the footer has it)."""
    info = ParquetDatasetInfo(url, storage_options, validate=False)
    info.file_paths = sorted(manifest.committed_paths(new_manifest, root_path))
    try:
        previous = _row_group_counts_from_common_metadata(info)
    except (OSError, ValueError):
        previous = None
    counts = manifest.merge_footer_counts(fs, root_path, manifest.row_group_counts(new_manifest),
                                          previous)
    counts_json = json.dumps(counts, sort_keys=True).encode('utf-8')
    entries = {ROW_GROUPS_PER_FILE_KEY: counts_json}
    cm = info.common_metadata
    if cm is not None and cm.metadata and LEGACY_ROW_GROUPS_PER_FILE_KEY in cm.metadata:
        entries[LEGACY_ROW_GROUPS_PER_FILE_KEY] = counts_json
    update_dataset_metadata(info, entries)


class CompactionDaemon:
    """A standing compaction job: re-plans every ``interval_s``, folds when
    enough small files have gathered, and sweeps superseded files once
    their swap is ``gc_grace_s`` old. ``start``/``stop`` are idempotent.

    With ``PETASTORM_TPU_OBS_PORT`` armed, ``/health`` carries a
    ``compaction-daemon`` section: the last published generation, folds
    completed, files swept and the latest self-check's warnings."""

    def __init__(self, dataset_url, interval_s=30.0, gc_grace_s=300.0, storage_options=None):
        self._url = dataset_url
        self._interval_s = interval_s
        self._gc_grace_s = gc_grace_s
        self._storage_options = storage_options
        self._stop = threading.Event()
        self._thread = None
        self._mount = None
        self.runs = 0
        self.generation = None  #: the last generation this daemon published
        self.gc_files = 0  #: superseded files this daemon swept
        self.last_warnings = []  #: the latest fold's self-check warnings

    def start(self):
        if self._thread is not None:
            return
        from petastorm_tpu_torch.telemetry import obs_server
        self._stop.clear()
        self._mount = obs_server.mount('compaction-daemon', health=self.health)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name='petastorm-tpu-torch-compactd')
        self._thread.start()

    def health(self):
        """The ``/health`` section."""
        return {
            'dataset_url': self._url,
            'interval_s': self._interval_s,
            'runs': self.runs,
            'generation': self.generation,
            'gc_files': self.gc_files,
            'self_check_warnings': list(self.last_warnings),
        }

    def _run(self):
        while not self._stop.wait(self._interval_s):
            try:
                published = compact_dataset(self._url, storage_options=self._storage_options)
                if published is not None:
                    self.runs += 1
                    self.generation = published['generation']
                    self._self_check(published)
                # every pass sweeps: files an earlier fold superseded age
                # out of their grace window in quiet intervals too
                fs, root_path = get_filesystem_and_path_or_paths(
                    normalize_dir_url(self._url), self._storage_options)
                self.gc_files += len(manifest.gc_superseded(fs, root_path,
                                                            grace_s=self._gc_grace_s))
            except Exception:  # noqa: BLE001 - a standing job outlives one failed pass
                logger.exception('compaction daemon: pass failed for %s', self._url)

    def _self_check(self, published):
        """Refresh the section's warnings from a layout self-check of the
        folded dataset (footers only; off with the writer's knob)."""
        if knobs.is_disabled('PETASTORM_TPU_WRITE_SELF_CHECK'):
            return
        try:
            report = layout.self_check(self._url, sort_key=published.get('sort_key'),
                                       storage_options=self._storage_options)
            self.last_warnings = list(report.get('warnings') or [])
        except Exception:  # noqa: BLE001 - analysis must not end the job
            logger.exception('compaction daemon: self-check failed for %s', self._url)

    def stop(self):
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=30)
        if self._mount is not None:
            self._mount.close()
            self._mount = None
