"""The commit manifest: atomic, monotonic dataset generations.

Counterpart of ``petastorm_tpu/write/manifest.py``; the file's name, its
canonical bytes and the lease file are the reference's, so either package
commits onto a dataset the other committed.

A manifest-bearing dataset has one commit point: ``_manifest.json`` at the
dataset root, swapped atomically (tmp + rename) by every writer commit,
compaction fold and append. It is the committed truth about which part
files are the dataset:

* **Exactly-once publication.** Part files are written under invisible
  ``.tmp.`` names and renamed into place before the manifest swap; a
  writer killed mid-write leaves only tmp litter (purged by a later
  commit) and the previous generation committed. Readers
  (:class:`~petastorm_tpu_torch.etl.dataset_metadata.ParquetDatasetInfo`
  reads the manifest before any directory walk) never see a torn dataset.
* **Determinism.** The manifest carries no wall-clock state: the same
  rows committed through any backend or retry serialize to the same
  bytes. Staleness is read from the manifest file's mtime.
* **Monotonic generations.** Every commit adds one to ``generation``; an
  append adds entries, a compaction replaces them (``replaces`` names the
  folded files, left on disk for in-flight readers until
  :func:`gc_superseded`).
* **Serialized commits.** Every load → swap section holds the
  ``_manifest.lock`` lease (:class:`CommitLock`), so concurrent
  committers (an appender and the compaction daemon) rebase onto each
  other instead of the last rename dropping the loser's files.
"""

import json
import logging
import posixpath
import time

from petastorm_tpu_torch import faults
from petastorm_tpu_torch.telemetry import get_registry, metrics_disabled

logger = logging.getLogger(__name__)

MANIFEST_NAME = '_manifest.json'
MANIFEST_VERSION = 1

#: the latest generation this process published (commits and folds)
MANIFEST_GENERATION = 'petastorm_tpu_write_manifest_generation'
WRITE_COMMITS = 'petastorm_tpu_write_commits_total'

#: name prefix of in-flight part files and manifest swaps; the leading
#: '.' keeps them out of every discovery walk
TMP_PREFIX = '.tmp.'

#: tmp litter older than this is presumed orphaned by a dead writer and
#: purged at the next commit
_TMP_PURGE_AGE_S = 3600.0

#: lease file serializing manifest commits; the underscore keeps it out of
#: every discovery walk and of the gc sweep
LOCK_NAME = '_manifest.lock'
_LOCK_STALE_S = 60.0
_LOCK_TIMEOUT_S = 120.0
_LOCK_POLL_S = 0.05


class ManifestError(RuntimeError):
    """A manifest that exists but cannot be trusted (unparseable, another
    version, a swap that is not monotonic)."""


def manifest_path(root_path):
    return posixpath.join(root_path, MANIFEST_NAME)


def file_entry(path, rows, row_groups, nbytes, source='append', replaces=()):
    """One committed part file; ``path`` is relative to the dataset root."""
    return {'path': path, 'rows': int(rows), 'row_groups': int(row_groups),
            'bytes': int(nbytes), 'source': source, 'replaces': sorted(replaces)}


def build_manifest(files, generation=0, sort_key=None):
    """A manifest dict, entries sorted by path (deterministic bytes)."""
    return {
        'version': MANIFEST_VERSION,
        'generation': int(generation),
        'sort_key': sort_key,
        'files': sorted(files, key=lambda e: e['path']),
    }


def dumps(manifest):
    """Canonical manifest bytes: sorted keys, fixed separators."""
    return json.dumps(manifest, sort_keys=True, separators=(',', ':')).encode('utf-8')


def _mtime(info):
    mtime = info.get('mtime')
    if hasattr(mtime, 'timestamp'):
        mtime = mtime.timestamp()
    return None if mtime is None else float(mtime)


def load(fs, root_path):
    """The committed manifest at ``root_path``, or None when the dataset
    has none. Only a missing manifest maps to None: a transient IO error
    propagates, so a caller never falls back to the torn directory-walk
    view because storage hiccuped."""
    path = manifest_path(root_path)
    try:
        if not fs.exists(path):
            return None
        with fs.open(path, 'rb') as f:
            raw = f.read()
    except FileNotFoundError:
        return None
    try:
        manifest = json.loads(raw.decode('utf-8'))
    except (ValueError, UnicodeDecodeError) as e:
        raise ManifestError('Unparseable manifest at %r: %s' % (path, e))
    if manifest.get('version') != MANIFEST_VERSION:
        raise ManifestError('Unsupported manifest version %r at %r'
                            % (manifest.get('version'), path))
    return manifest


def staleness_s(fs, root_path):
    """Age in seconds of the committed manifest (None without one), from
    the file's mtime: the manifest bytes stay deterministic."""
    try:
        mtime = _mtime(fs.info(manifest_path(root_path)))
    except (OSError, ValueError):
        return None
    if mtime is None:
        return None
    return max(0.0, time.time() - mtime)


class CommitLock:
    """Lease file serializing manifest commits under one dataset root.

    Without it two committers (an appender racing the compaction daemon)
    can both load generation G and both swap G+1: the last rename wins and
    the loser's files leave the manifest, to be deleted by
    :func:`gc_superseded`. :func:`publish` and the writer's and
    compactor's commit sections hold this lease across load → swap, so
    racers serialize and rebase.

    The lease is taken by exclusive create (``xb``); one older than
    ``stale_s`` is presumed orphaned by a dead committer and broken.
    Waiting past ``timeout_s`` raises :class:`ManifestError`.
    """

    def __init__(self, fs, root_path, timeout_s=_LOCK_TIMEOUT_S, stale_s=_LOCK_STALE_S):
        self._fs = fs
        self._path = posixpath.join(root_path, LOCK_NAME)
        self._timeout_s = timeout_s
        self._stale_s = stale_s
        self._held = False

    def _try_create(self):
        try:
            with self._fs.open(self._path, 'xb') as f:
                f.write(b'petastorm_tpu commit lease')
            return True
        except FileExistsError:
            return False
        except (ValueError, NotImplementedError):
            # no exclusive create on this filesystem: check, then create
            if self._fs.exists(self._path):
                return False
            with self._fs.open(self._path, 'wb') as f:
                f.write(b'petastorm_tpu commit lease')
            return True

    def _break_if_stale(self):
        try:
            mtime = _mtime(self._fs.info(self._path))
        except (OSError, ValueError):
            return
        if mtime is None or time.time() - mtime < self._stale_s:
            return
        logger.warning('write: breaking stale commit lease %s (older than %.0fs)',
                       self._path, self._stale_s)
        try:
            self._fs.rm(self._path)
        except (OSError, ValueError):
            pass

    def acquire(self):
        deadline = time.monotonic() + self._timeout_s
        while True:
            if self._try_create():
                self._held = True
                return self
            self._break_if_stale()
            if time.monotonic() >= deadline:
                raise ManifestError(
                    'Commit lease %r held past the %.1fs timeout: another committer is '
                    'live (or died inside the stale window)' % (self._path, self._timeout_s))
            time.sleep(_LOCK_POLL_S)

    def release(self):
        if not self._held:
            return
        self._held = False
        try:
            self._fs.rm(self._path)
        except (OSError, ValueError):
            pass

    def __enter__(self):
        return self.acquire()

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.release()


def commit_lock(fs, root_path, **kwargs):
    """The commit lease for ``root_path`` (see :class:`CommitLock`)."""
    return CommitLock(fs, root_path, **kwargs)


def publish(fs, root_path, manifest, locked=False, lock_timeout_s=None):
    """Atomically swap the committed manifest (tmp + rename) after proving
    the swap monotonic against the generation on storage. Load, check and
    swap run under the commit lease; pass ``locked=True`` only when the
    caller holds it already (the writer's and compactor's commit
    sections)."""
    if not locked:
        kwargs = {} if lock_timeout_s is None else {'timeout_s': lock_timeout_s}
        with CommitLock(fs, root_path, **kwargs):
            return publish(fs, root_path, manifest, locked=True)
    current = load(fs, root_path)
    if current is not None and manifest['generation'] <= current['generation']:
        raise ManifestError(
            'Manifest swap is not monotonic: committed generation %d, attempted %d'
            % (current['generation'], manifest['generation']))
    path = manifest_path(root_path)
    tmp = posixpath.join(root_path, TMP_PREFIX + MANIFEST_NAME)
    if faults.ARMED:
        faults.fault_hit('io.write', key='%s#manifest' % path)
    with fs.open(tmp, 'wb') as f:
        f.write(dumps(manifest))
    fs.mv(tmp, path)
    if not metrics_disabled():
        registry = get_registry()
        registry.counter(WRITE_COMMITS).inc()
        registry.gauge(MANIFEST_GENERATION).set(manifest['generation'])
    logger.debug('write: committed manifest generation %d (%d files)',
                 manifest['generation'], len(manifest['files']))
    return manifest


def committed_paths(manifest, root_path):
    """Absolute paths of the manifest's committed part files."""
    return [posixpath.join(root_path, e['path']) for e in manifest['files']]


def row_group_counts(manifest):
    """``{relative path: row-group count}`` for the metadata footer: the
    commit knows every count, so the footer costs no footer scan."""
    return {e['path']: e['row_groups'] for e in manifest['files']}


def purge_stale_tmp(fs, root_path, max_age_s=_TMP_PURGE_AGE_S):
    """Remove ``.tmp.`` litter orphaned by dead writers; age-gated, so a
    live writer's in-flight tmp file is never removed. Returns the count
    purged (a racing delete is not an error)."""
    try:
        listing = fs.ls(root_path, detail=True)
    except (OSError, ValueError):
        return 0
    purged = 0
    now = time.time()
    for entry in listing:
        if not posixpath.basename(entry.get('name', '')).startswith(TMP_PREFIX):
            continue
        mtime = _mtime(entry)
        if mtime is not None and now - mtime < max_age_s:
            continue
        try:
            fs.rm(entry['name'])
            purged += 1
        except (OSError, ValueError):
            pass
    if purged:
        logger.info('write: purged %d stale tmp file(s) under %s', purged, root_path)
    return purged


def gc_superseded(fs, root_path, grace_s=0.0):
    """Delete data files on disk that the committed manifest no longer
    names (compaction leftovers), once the grace window has passed.

    The window runs from the manifest swap (the manifest file's mtime is
    the moment the files were superseded), so a reader that resolved the
    previous generation just before the swap keeps its files however old
    they are. Each candidate must also be ``grace_s`` old itself, which
    protects parts an in-flight writer renamed but has not committed.
    Returns the removed paths, relative to the root."""
    committed_manifest = load(fs, root_path)
    if committed_manifest is None:
        return []
    committed = {e['path'] for e in committed_manifest['files']}
    if grace_s > 0:
        swap_age = staleness_s(fs, root_path)
        if swap_age is None or swap_age < grace_s:
            return []
    try:
        listing = fs.find(root_path, detail=True)
    except TypeError:
        listing = {p: fs.info(p) for p in fs.find(root_path)}
    removed = []
    now = time.time()
    for path, entry in sorted(listing.items()):
        rel = posixpath.relpath(path, root_path.rstrip('/'))
        if any(seg.startswith(('.', '_')) for seg in rel.split('/')) or rel in committed:
            continue
        if grace_s > 0:
            mtime = _mtime(entry)
            if mtime is None or now - mtime < grace_s:
                continue
        try:
            fs.rm(path)
            removed.append(rel)
        except (OSError, ValueError):
            pass
    if removed:
        logger.info('write: garbage-collected %d superseded file(s) under %s',
                    len(removed), root_path)
    return removed


def merge_footer_counts(fs, root_path, counts, previous):
    """Row-group counts for a ``_common_metadata`` restamp: the new
    generation's ``counts`` merged over the ``previous`` stamped map, so a
    reader holding the previous generation's file list still finds the
    superseded files' counts. A stale key is dropped once its file has
    left the disk."""
    merged = dict(previous or {})
    merged.update(counts)
    for rel in list(merged):
        if rel in counts:
            continue
        try:
            if not fs.exists(posixpath.join(root_path, rel)):
                del merged[rel]
        except (OSError, ValueError):
            pass
    return merged
