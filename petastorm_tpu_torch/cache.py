"""Row-group caches (counterpart of ``petastorm_tpu/cache.py``).

:class:`NullCache` never caches; :class:`LocalDiskCache` is a small file
cache of pickled values in sharded directories, bounded by size with LRU
eviction by access time. The disk helpers here (tmp-name publishing with
``os.replace``, host-pid tmp markers, the attach scan, the LRU walk) are
shared with the decoded cache
(:mod:`petastorm_tpu_torch.materialized_cache`).
"""

import hashlib
import logging
import os
import pickle
import re
import socket
import threading
import time
from abc import ABCMeta, abstractmethod

logger = logging.getLogger(__name__)

#: every disk tier writes entries as ``<entry><_TMP_MARKER><host>-<pid>``
#: and publishes them with an atomic ``os.replace``
_TMP_MARKER = '.tmp.'

#: pid liveness can only be checked on the writer's own host; a FOREIGN
#: host's tmp file is purged only once it is old enough that its writer
#: has certainly crashed or finished (a write takes seconds, not an hour)
_FOREIGN_TMP_TTL_S = 3600.0

_HOST = re.sub(r'[^A-Za-z0-9]', '', socket.gethostname())[:32] or 'host'


def is_tmp_entry(name):
    """True for an in-flight (or orphaned) writer's tmp file."""
    return _TMP_MARKER in name


def tmp_entry_path(entry):
    """The tmp name a writer publishes ``entry`` through. Carries host AND
    pid: pid liveness is only checkable on the writer's own host, so a
    cache directory on shared storage (the multi-host service-fleet
    shape) must be able to tell a local writer from a remote one."""
    return '%s%s%s-%d' % (entry, _TMP_MARKER, _HOST, os.getpid())


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True  # e.g. EPERM: the pid exists, just isn't ours
    return True


def _tmp_status(full, name, now):
    """``None`` for a real entry, ``'live'`` for an in-flight writer's
    tmp file, ``'stale'`` for a dead writer's orphan. This host's tmp
    files are judged by pid liveness; a foreign host's (shared-storage
    fleet directory) only by age past :data:`_FOREIGN_TMP_TTL_S` —
    ``os.kill`` on another host's pid would misread a LIVE remote writer
    as dead and delete the file out from under its rename."""
    i = name.rfind(_TMP_MARKER)
    if i < 0:
        return None
    suffix = name[i + len(_TMP_MARKER):]
    host, _, pid_text = suffix.rpartition('-')
    if not pid_text.isdigit():
        return 'live'  # not our naming: excluded from scans, never purged
    if host in ('', _HOST):
        # this host (or a legacy pid-only suffix): liveness check
        return 'live' if _pid_alive(int(pid_text)) else 'stale'
    try:
        age = now - os.stat(full).st_mtime
    except OSError:
        return 'live'
    return 'stale' if age >= _FOREIGN_TMP_TTL_S else 'live'


def purge_stale_tmp_files(path):
    """Delete tmp files whose writer is dead (see :func:`_tmp_status`).

    A writer killed between its tmp write and the ``os.replace`` leaks an
    orphan that would otherwise inflate every size scan forever and — if
    the eviction walk saw it — could be "evicted" out from under a LIVE
    writer's in-flight rename. Returns the number removed."""
    removed = 0
    now = time.time()
    for root, _, files in os.walk(path):
        for name in files:
            full = os.path.join(root, name)
            if _tmp_status(full, name, now) == 'stale':
                try:
                    os.remove(full)
                    removed += 1
                except OSError:
                    pass
    return removed


def attach_scan(path):
    """Cache-init walk: purge stale tmp files AND total the surviving
    entries in ONE pass — a fleet directory can hold tens of thousands of
    entries on network storage, and two back-to-back walks would double
    an already slow startup stat storm. Returns the entry byte total."""
    total = 0
    now = time.time()
    for root, _, files in os.walk(path):
        for name in files:
            full = os.path.join(root, name)
            status = _tmp_status(full, name, now)
            if status is None:  # a real entry: count it
                try:
                    total += os.stat(full).st_size
                except OSError:
                    pass
            elif status == 'stale':
                try:
                    os.remove(full)
                except OSError:
                    pass
    return total


def publish_entry(entry, write_func):
    """Atomic cache-entry publish, shared by both disk tiers: write the
    payload to the entry's tmp name via ``write_func(tmp_path)``, then
    ``os.replace`` it into place — concurrent readers see the old bytes
    or the new, never a partial file. Returns ``(size, replaced)``:
    the new entry's size and the size of any entry it overwrote (the
    caller's running-total accounting needs the difference; forgetting
    the overwrite would inflate the total until the next full rescan)."""
    os.makedirs(os.path.dirname(entry), exist_ok=True)
    tmp = tmp_entry_path(entry)
    write_func(tmp)
    size = os.stat(tmp).st_size
    try:
        replaced = os.stat(entry).st_size
    except OSError:
        replaced = 0
    os.replace(tmp, entry)
    return size, replaced


def scan_dir_entries(path):
    """``([(atime, size, path), ...], total_bytes)`` over a cache
    directory, skipping in-flight tmp files (they aren't entries and must
    never be size-accounted or evicted). Shared by both disk tiers."""
    entries, total = [], 0
    for root, _, files in os.walk(path):
        for name in files:
            if is_tmp_entry(name):
                continue
            p = os.path.join(root, name)
            try:
                st = os.stat(p)
            except OSError:
                continue
            entries.append((st.st_atime, st.st_size, p))
            total += st.st_size
    return entries, total


def evict_lru(path, size_limit):
    """Walk ``path`` and LRU-delete entries (oldest atime first) until it
    fits ``size_limit``. Returns ``(total_after, evictions,
    bytes_evicted)``. Deliberately lock-free: callers must NOT hold their
    cache lock across this filesystem walk (it would serialize every
    concurrent hit behind I/O); concurrent evictors/re-writers are
    tolerated — sizes are re-measured at eviction time and races surface
    as the OSError passes."""
    entries, total = scan_dir_entries(path)
    evictions = bytes_evicted = 0
    if total > size_limit:
        entries.sort()  # oldest access first
        for _, _, p in entries:
            try:
                # Size measured at EVICTION time, not scan time: another
                # process may have re-written the entry since (atomic
                # rename), and accounting the stale size would drift the
                # running total.
                size = os.stat(p).st_size
                os.remove(p)
                total -= size
                evictions += 1
                bytes_evicted += size
            except OSError:
                pass
            if total <= size_limit:
                break
    return total, evictions, bytes_evicted


#: name prefix of the placement marker files a decode fleet drops into a
#: cache directory to advertise what it holds
MARKER_PREFIX = '.fp_'


def purge_stale_markers(path):
    """Remove every placement marker (:data:`MARKER_PREFIX`) from a cache
    directory that holds no real entry: a re-rooted or cleaned-up cache
    must not keep advertising entries it no longer backs. Returns the
    number removed: 0 when any real entry exists, or on any failure."""
    try:
        if not path or not os.path.isdir(path):
            return 0
        markers = []
        for root, _, files in os.walk(path):
            for name in files:
                if name.startswith(MARKER_PREFIX):
                    markers.append(os.path.join(root, name))
                elif not is_tmp_entry(name):
                    return 0  # a real entry: the markers are earned
        removed = 0
        for p in markers:
            try:
                os.remove(p)
                removed += 1
            except OSError:
                pass
        return removed
    except Exception:  # noqa: BLE001 - markers are advisory
        from petastorm_tpu_torch.telemetry import count_swallowed
        count_swallowed('placement-marker-purge')
        return 0


# telemetry counter names (read back by telemetry.pipeline_report's cache
# section); a worker process's increments ride the pool delta channel
CACHE_HITS = 'petastorm_tpu_cache_hits_total'
CACHE_MISSES = 'petastorm_tpu_cache_misses_total'
CACHE_EVICTIONS = 'petastorm_tpu_cache_evictions_total'
CACHE_BYTES_WRITTEN = 'petastorm_tpu_cache_bytes_written_total'
CACHE_BYTES_EVICTED = 'petastorm_tpu_cache_bytes_evicted_total'
CACHE_SIZE_BYTES = 'petastorm_tpu_cache_size_bytes'


class CacheBase(metaclass=ABCMeta):
    @abstractmethod
    def get(self, key, fill_cache_func):
        """Value for ``key``; on miss call ``fill_cache_func``, store, return."""

    def cleanup(self):
        """Release resources (no-op by default)."""


class NullCache(CacheBase):
    """Never caches (reference: ``cache.py:30-39``)."""

    def get(self, key, fill_cache_func):
        return fill_cache_func()


class LocalDiskCache(CacheBase):
    """File-backed cache with a soft size bound and LRU eviction.

    :param path: cache directory (created if needed).
    :param size_limit_bytes: soft cap; least-recently-accessed entries are
        evicted when exceeded.
    :param expected_row_size_bytes: accepted for reference API compatibility.
    """

    _SHARDS = 64

    def __init__(self, path, size_limit_bytes, expected_row_size_bytes=None,
                 cleanup=False, **_unused):
        self._path = path
        self._size_limit = size_limit_bytes
        self._cleanup_on_exit = cleanup
        self._lock = threading.Lock()
        os.makedirs(path, exist_ok=True)
        # One walk purges dead writers' tmp files AND totals the entries.
        # The running byte total avoids re-walking the tree on every
        # store; full walks happen only here and when the cap is crossed.
        self._total = attach_scan(path)

    def _scan_total(self):
        return scan_dir_entries(self._path)[1]

    def __getstate__(self):
        # Locks don't cross the process-pool spawn boundary; each process
        # gets its own (the cache is safe across processes via atomic rename).
        state = self.__dict__.copy()
        del state['_lock']
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def _entry_path(self, key):
        digest = hashlib.sha1(str(key).encode('utf-8')).hexdigest()
        shard = digest[:2]
        return os.path.join(self._path, shard, digest + '.pkl')

    @staticmethod
    def _registry():
        from petastorm_tpu_torch.telemetry import get_registry
        return get_registry()

    def _size_gauge(self):
        # labeled per process so last-writer-wins gauge merges from
        # different workers don't interleave into flicker. Every process's
        # running total covers the WHOLE shared cache directory, so the
        # consumer aggregates these series with max (freshest estimate of
        # the one directory), never sum — see telemetry.export's cache
        # section.
        return self._registry().gauge(CACHE_SIZE_BYTES, pid=str(os.getpid()))

    def get(self, key, fill_cache_func):
        entry = self._entry_path(key)
        try:
            with open(entry, 'rb') as f:
                value = pickle.load(f)
            os.utime(entry)  # LRU touch
            self._registry().counter(CACHE_HITS).inc()
            return value
        except OSError:
            pass  # plain miss: no entry yet
        except (pickle.UnpicklingError, ValueError, EOFError,
                AttributeError):
            # Corrupt entry (UnpicklingError and its subclasses, numpy's
            # truncated-read ValueError, a short file's EOFError, a
            # missing-attribute unpickle): delete it NOW so every other
            # process stops re-reading the bad bytes until our re-fill
            # below lands — and keep the running total honest.
            logger.warning('LocalDiskCache entry for %r corrupt; deleting',
                           key, exc_info=True)
            try:
                size = os.stat(entry).st_size
                os.remove(entry)
                with self._lock:
                    self._total -= size
            except OSError:
                pass
        self._registry().counter(CACHE_MISSES).inc()
        value = fill_cache_func()
        try:
            def write(tmp):
                with open(tmp, 'wb') as f:
                    pickle.dump(value, f,
                                protocol=pickle.HIGHEST_PROTOCOL)
            size, replaced = publish_entry(entry, write)
            self._registry().counter(CACHE_BYTES_WRITTEN).inc(size)
            with self._lock:
                self._total += size - replaced
                over_limit = self._total > self._size_limit
            self._size_gauge().set(self._total)
            if over_limit:
                self._maybe_evict()
        except OSError:
            logger.warning('LocalDiskCache failed to store %r', key, exc_info=True)
        return value

    def _maybe_evict(self):
        # the walk runs OUTSIDE the lock (an eviction pass over a large
        # tier must not serialize every concurrent get behind disk I/O);
        # only the running-total update is guarded
        with self._lock:
            before = self._total
        total, evictions, bytes_evicted = evict_lru(self._path,
                                                    self._size_limit)
        with self._lock:
            # merge, don't assign: entries published DURING the walk
            # bumped _total concurrently, and a plain overwrite would
            # lose them (cap overrun with no eviction trigger). Keeping
            # their delta can at worst double-count a publish the walk
            # also saw — an overestimate that only triggers an extra
            # self-correcting walk, never a silent overrun.
            self._total = total + (self._total - before)
        if evictions:
            registry = self._registry()
            registry.counter(CACHE_EVICTIONS).inc(evictions)
            registry.counter(CACHE_BYTES_EVICTED).inc(bytes_evicted)
        self._size_gauge().set(self._total)

    def cleanup(self):
        if self._cleanup_on_exit:
            import shutil
            shutil.rmtree(self._path, ignore_errors=True)
