"""Materialized decoded-row-group cache: decode once, serve many
(counterpart of ``petastorm_tpu/materialized_cache.py``).

:class:`MaterializedRowGroupCache` stores the finished columnar batch of a
row-group (after decode, filter and TransformSpec) as one Arrow IPC file,
keyed by the dataset file's identity, the row-group and the decode
fingerprint (schema view with its codecs, TransformSpec, NGram; see
:func:`decode_fingerprint`). Entries are published through a tmp name and
``os.replace``, so concurrent readers never see a partial entry.

On a hit the batch is memory-mapped back zero-copy: numeric and string
columns are read-only ``np.frombuffer`` views over the file's mapping (the
hit path records only the ``cache_hit_read`` stage), object columns come
back from an embedded pickle cell. A bounded in-memory LRU tier sits over
the size-bounded disk tier. A disk fault (a full disk, EIO, a read-only
remount) degrades the disk tier to decode-through for the rest of the
process, announced once by a ``cache_degraded`` anomaly.

The port differs from the reference in two places. The decision to count
a disk failure, degrade and announce is taken under the tier's lock, so
stores already in flight when the tier degrades are not counted as further
failures (the reference counts each). And the arrays the memory tier holds
are read-only whether or not the sanitizer is armed, the fill path's batch
included, so an in-place write on a consumer's batch cannot change what a
later epoch is served.
"""

import errno
import hashlib
import json
import logging
import os
import pickle
import re
import tempfile
import threading
import time
import types
from collections import OrderedDict

import numpy as np

from petastorm_tpu_torch import faults, sanitizer
from petastorm_tpu_torch.cache import (
    CacheBase, attach_scan, evict_lru, publish_entry, purge_stale_markers,
)
from petastorm_tpu_torch.telemetry import span
from petastorm_tpu_torch.telemetry.registry import get_registry
from petastorm_tpu_torch.telemetry.timeseries import record_anomaly

logger = logging.getLogger(__name__)

# telemetry counter names (read back by telemetry.export's decoded-cache
# section); a worker process's increments ride the pool delta channels
DECODED_CACHE_HITS = 'petastorm_tpu_decoded_cache_hits_total'
DECODED_CACHE_MISSES = 'petastorm_tpu_decoded_cache_misses_total'
DECODED_CACHE_MEM_HITS = 'petastorm_tpu_decoded_cache_mem_hits_total'
DECODED_CACHE_EVICTIONS = 'petastorm_tpu_decoded_cache_evictions_total'
DECODED_CACHE_BYTES_WRITTEN = \
    'petastorm_tpu_decoded_cache_bytes_written_total'
DECODED_CACHE_BYTES_READ = 'petastorm_tpu_decoded_cache_bytes_read_total'
DECODED_CACHE_MMAP_READS = 'petastorm_tpu_decoded_cache_mmap_reads_total'
DECODED_CACHE_COPY_READS = 'petastorm_tpu_decoded_cache_copy_reads_total'
DECODED_CACHE_SIZE_BYTES = 'petastorm_tpu_decoded_cache_size_bytes'
DECODED_CACHE_DISK_FAILURES = \
    'petastorm_tpu_decoded_cache_disk_failures_total'
DECODED_CACHE_DEGRADED = 'petastorm_tpu_decoded_cache_degraded'
DECODED_CACHE_SKIPPED = 'petastorm_tpu_decoded_cache_skipped_total'


def count_cache_skip(reason):
    """One reader left uncached by the decoded-cache arming logic, by
    reason (today: ``predicate`` — an arbitrary predicate has no stable
    cache identity, so ``PETASTORM_TPU_DECODED_CACHE=1`` reads it
    uncached; ``FiltersPredicate`` readers DO cache, their clause digest
    joins the key), so a reader the fleet knob left uncached shows."""
    from petastorm_tpu_torch.telemetry.spans import metrics_disabled
    if not metrics_disabled():
        get_registry().counter(DECODED_CACHE_SKIPPED, reason=reason).inc()

#: errnos that mean the MEDIUM (or the directory) is the problem, not
#: one entry, when a STORE fails: disk full, quota, read-only remount,
#: directory permissions, I/O error. One of these degrades the disk
#: tier immediately — retrying per-row-group would fail the same way
#: and bill every row-group an fsync-deep error path.
_STORE_FAULT_ERRNOS = frozenset(
    e for e in (errno.ENOSPC, getattr(errno, 'EDQUOT', None), errno.EROFS,
                errno.EACCES, errno.EPERM, errno.EIO) if e is not None)

#: on a READ only EIO indicts the medium. EACCES/EPERM are frequently
#: ENTRY-shaped there — one foreign-UID file in a shared per-host
#: directory must not disarm the tier for every other readable entry —
#: so they ride the consecutive-failure ramp instead.
_READ_FAULT_ERRNOS = frozenset((errno.EIO,))

#: entry-shaped failures (serialization oddities, transient weirdness)
#: tolerate this many CONSECUTIVE occurrences before degrading anyway —
#: a tier failing every single store is not caching, just burning time
_CONSECUTIVE_FAILURE_LIMIT = 5

#: memory-tier hits LRU-touch their backing disk entry at most this
#: often per entry: the disk LRU only needs coarse freshness, and a hot
#: in-memory loop must not pay one utime syscall per hit
_UTIME_INTERVAL_S = 5.0
_UTIME_TRACKED_CAP = 4096


# -- publish notifications ----------------------------------------------------
# A peer-cache serve plane advertises entries the moment THIS process
# publishes them instead of waiting out its directory rescan;
# module-level so one hook covers every cache object.

_PUBLISH_LISTENERS = []


def add_publish_listener(listener):
    """Register ``listener(entry_path, size)`` to run after every
    successful disk-tier publish in this process."""
    _PUBLISH_LISTENERS.append(listener)


def remove_publish_listener(listener):
    try:
        _PUBLISH_LISTENERS.remove(listener)
    except ValueError:
        pass


def _notify_published(entry, size):
    for listener in list(_PUBLISH_LISTENERS):
        try:
            listener(entry, size)
        except Exception:  # noqa: BLE001 - adverts are advisory
            from petastorm_tpu_torch.telemetry import count_swallowed
            count_swallowed('cache-publish-listener')

#: dtype kinds whose flat buffer round-trips through np.frombuffer —
#: these columns mmap back zero-copy; everything else ('O' object arrays:
#: ragged rows, None-bearing nullables, Decimals) embeds a pickle cell
_RAW_KINDS = 'biufcmMSU'

_LENGTH_META = b'petastorm_tpu.length'
_VERSION_META = b'petastorm_tpu.version'
_FORMAT_VERSION = b'1'


def default_cache_dir():
    """Shared-by-default location: every process (and every locally
    spawned worker fleet) on the host resolves the same directory, so the
    decode-once-serve-many property holds without configuration."""
    return os.path.join(tempfile.gettempdir(),
                        'petastorm-tpu-decoded-cache')


# -- fingerprints ------------------------------------------------------------
#
# The cache key must change whenever the *content* of a decoded batch
# could: a different TransformSpec (code, closure, or schema edits), a
# different codec configuration, a different loaded column set, or a
# rewritten dataset file. Serving a stale decoded batch is silent data
# corruption, so every fingerprint errs toward over-invalidation.


def _sha1(*parts):
    h = hashlib.sha1()
    for part in parts:
        h.update(part if isinstance(part, bytes) else str(part).encode())
        h.update(b'\x00')
    return h.hexdigest()


#: CPython's default object repr embeds the allocation address — useless
#: (and actively harmful) as a cross-process identity, so it is scrubbed
#: from every repr-based fallback digest below
_ADDR_RE = re.compile(r' at 0x[0-9a-f]+')


def _value_digest(value, depth=0):
    """Deterministic-across-processes digest of a Python value.

    ``repr`` is NOT enough for two reasons this function exists to fix:
    numpy truncates large arrays (two different 10k-element lookup tables
    repr identically — a collision would serve stale decoded rows), and
    nested code objects / default object reprs embed memory addresses
    (a new address every process — the shared cache would never hit).
    """
    if depth > 8:  # deep/self-referential structures: coarse but stable
        return _sha1('deep', _ADDR_RE.sub('', repr(value)))
    if value is None or isinstance(value, (bool, int, float, complex,
                                           str, bytes)):
        return repr(value)
    if isinstance(value, np.ndarray):
        return _sha1('nd', value.dtype.str, value.shape,
                     np.ascontiguousarray(value).tobytes())
    if isinstance(value, types.CodeType):
        return _code_digest(value, depth + 1)
    if isinstance(value, (tuple, list)):
        return _sha1(type(value).__name__,
                     *[_value_digest(v, depth + 1) for v in value])
    if isinstance(value, (set, frozenset)):
        return _sha1('set', *sorted(_value_digest(v, depth + 1)
                                    for v in value))
    if isinstance(value, dict):
        return _sha1('dict', *sorted(
            '%s:%s' % (_value_digest(k, depth + 1),
                       _value_digest(v, depth + 1))
            for k, v in value.items()))
    if callable(value):
        return callable_fingerprint(value, depth + 1)
    try:
        return _sha1('pkl', pickle.dumps(value, protocol=4))
    except Exception:  # noqa: BLE001 - unpicklable: scrubbed-repr fallback
        return _sha1('repr', _ADDR_RE.sub('', repr(value)))


def _code_digest(code, depth=0):
    """Digest of a code object, recursing into nested code consts (a
    lambda/inner def inside a transform) instead of repr'ing them —
    ``repr(code)`` carries the object's address and would differ every
    process."""
    return _sha1(code.co_code,
                 *[_value_digest(c, depth) for c in code.co_consts],
                 repr(code.co_names), repr(code.co_varnames))


def callable_fingerprint(func, _depth=0):
    """Deterministic-across-processes identity of a transform callable:
    code bytes + consts + defaults + closure cell contents. Two processes
    importing the same function agree; editing the function body, its
    constants, or the values it closes over (``seq_len`` in a
    packing-transform factory, a numpy lookup table of any size) changes
    the fingerprint."""
    if func is None:
        return 'none'
    code = getattr(func, '__code__', None)
    if code is None:
        # partials / callable objects: best-effort over their visible state
        inner = getattr(func, 'func', None)
        if inner is not None and callable(inner):
            return _sha1('partial', callable_fingerprint(inner, _depth + 1),
                         _value_digest(getattr(func, 'args', ()), _depth),
                         _value_digest(getattr(func, 'keywords', None),
                                       _depth))
        state = vars(func) if hasattr(func, '__dict__') else {}
        return _sha1(type(func).__module__, type(func).__qualname__,
                     _value_digest(state, _depth))
    cells = []
    for cell in func.__closure__ or ():
        try:
            cells.append(_value_digest(cell.cell_contents, _depth + 1))
        except ValueError:  # empty cell
            cells.append('<empty>')
    return _sha1(_code_digest(code, _depth),
                 _value_digest(getattr(func, '__defaults__', None), _depth),
                 *cells)


def transform_fingerprint(spec):
    """Identity of a TransformSpec: the callable plus its declarative
    schema edits. None (no transform) has the stable identity 'none'."""
    if spec is None:
        return 'none'
    fields = [(f.name, repr(f.numpy_dtype), f.shape, f.nullable)
              for f in getattr(spec, 'edit_fields', ())]
    return _sha1(callable_fingerprint(getattr(spec, 'func', None)),
                 repr(fields), repr(getattr(spec, 'removed_fields', None)),
                 repr(getattr(spec, 'selected_fields', None)))


def _codec_fingerprint(codec):
    if codec is None:
        return 'plain'
    return _sha1(type(codec).__module__, type(codec).__qualname__,
                 repr(sorted(vars(codec).items())))


def schema_fingerprint(schema):
    """Identity of the loaded schema view: field names, dtypes, shapes
    and full codec configuration (quality, image format, …) — a codec
    parameter change decodes different bytes and must miss."""
    parts = []
    for name in sorted(schema.fields):
        f = schema.fields[name]
        parts.append('%s|%r|%r|%r|%s' % (f.name, f.numpy_dtype, f.shape,
                                         f.nullable,
                                         _codec_fingerprint(f.codec)))
    return _sha1(*parts)


def ngram_fingerprint(ngram):
    """Identity of an NGram configuration. It belongs in the key because
    the ngram's *length* changes the cached rows themselves: with
    ``shuffle_row_drop_partitions > 1`` each partition borrows
    ``length - 1`` overlap rows from the next (see
    ``arrow_worker._apply_row_drop``), so two jobs sharing a cache
    directory with different ngram shapes must not serve each other."""
    if ngram is None:
        return 'none'
    fields = {k: sorted(getattr(f, 'name', f) for f in v)
              for k, v in ngram.fields.items()}
    ts = ngram.timestamp_field
    return _sha1(repr(sorted(fields.items())),
                 repr(getattr(ts, 'name', ts)),
                 repr(ngram.delta_threshold),
                 repr(getattr(ngram, 'timestamp_overlap', None)))


def decode_fingerprint(loaded_schema, transform_spec, ngram=None):
    """The decode-identity half of a cache key: what was read+decoded
    (schema view incl. codecs), what transformed it, and the ngram shape
    (which leaks into the rows via the row-drop overlap)."""
    return _sha1(schema_fingerprint(loaded_schema),
                 transform_fingerprint(transform_spec),
                 ngram_fingerprint(ngram))


def dataset_file_fingerprint(dataset_info, path):
    """Identity of one parquet file's bytes (size + mtime when the
    filesystem provides them): rewriting the dataset in place invalidates
    its cached decoded row-groups."""
    try:
        info = dataset_info.fs.info(path)
        size = info.get('size')
        mtime = info.get('mtime') or info.get('LastModified')
        return '%s-%s' % (size, mtime)
    except Exception:  # noqa: BLE001 - exotic fs: fall back to path-only
        # counted: the path-only fallback weakens invalidation (a
        # rewritten file could serve stale rows), so it must be visible
        from petastorm_tpu_torch.telemetry import count_swallowed
        count_swallowed('cache-fingerprint-stat')
        return 'nostat'


# -- Arrow IPC entry format --------------------------------------------------
#
# One IPC file per entry, holding ONE record batch with one large_binary
# column per decoded column (each a single cell: the column's raw flat
# bytes, or a pickle for object columns). Field metadata carries the
# numpy dtype + shape so the read path can np.frombuffer the cell's data
# buffer straight off the memory map — the arrays alias the mmap (their
# base chain holds the pyarrow Buffer), no allocation, no pickle.


def _column_payload(col):
    """``(kind, flat uint8 view-or-bytes, meta)`` for one decoded column."""
    if (isinstance(col, np.ndarray) and col.dtype.kind in _RAW_KINDS
            and col.dtype.itemsize):
        raw = np.ascontiguousarray(col)
        return ('raw', raw.view(np.uint8).reshape(-1),
                {b'kind': b'raw', b'dtype': col.dtype.str.encode(),
                 b'shape': json.dumps(list(col.shape)).encode()})
    payload = pickle.dumps(col, protocol=pickle.HIGHEST_PROTOCOL)
    # The view's .base holds the freshly pickled bytes (this frame's
    # only reference), so the caller owns the memory.  # pipesan: owns
    return ('pickle', np.frombuffer(payload, dtype=np.uint8),
            {b'kind': b'pickle'})


def write_entry(path, columns, length):
    """Serialize a decoded batch to ``path`` as one Arrow IPC file.
    Returns the file's size in bytes. Not atomic by itself — callers
    write to a tmp name and ``os.replace`` (see :meth:`~
    MaterializedRowGroupCache.get`)."""
    import pyarrow as pa
    fields, arrays = [], []
    for name, col in columns.items():
        _, data, meta = _column_payload(col)
        offsets = np.array([0, data.nbytes], dtype=np.int64)
        arrays.append(pa.Array.from_buffers(
            pa.large_binary(), 1,
            [None, pa.py_buffer(offsets), pa.py_buffer(data)]))
        fields.append(pa.field(name, pa.large_binary(), metadata=meta))
    schema = pa.schema(fields, metadata={
        _LENGTH_META: str(int(length)).encode(),
        _VERSION_META: _FORMAT_VERSION,
    })
    with pa.OSFile(path, 'wb') as sink:
        with pa.ipc.new_file(sink, schema) as writer:
            writer.write_batch(pa.RecordBatch.from_arrays(arrays,
                                                          schema=schema))
    return os.stat(path).st_size


def read_entry(path):
    """``(columns, length, mmap_columns, copy_columns)`` from an entry.

    EVERY returned column arrives ``writeable=False``: raw columns are
    ``np.frombuffer`` views whose base chain holds the IPC file's
    read-only memory-map buffer (zero-copy; the mmap stays alive exactly
    as long as any returned array), and pickle-fallback columns — fresh
    allocations that would otherwise come back writable — are explicitly
    frozen, because the same array objects are shared through the memory
    tier with every later hit: a consumer's in-place write must raise
    (``ValueError: assignment destination is read-only``) instead of
    silently corrupting the shared entry. Raises on a malformed/truncated
    file — callers treat that as a miss and re-fill."""
    import pyarrow as pa
    source = pa.memory_map(path, 'r')
    reader = pa.ipc.open_file(source)
    meta = reader.schema.metadata or {}
    if meta.get(_VERSION_META) != _FORMAT_VERSION:
        raise ValueError('decoded-cache entry %s: unknown format version'
                         % path)
    length = int(meta[_LENGTH_META])
    batch = reader.get_batch(0)
    columns = {}
    mmap_columns = copy_columns = 0
    for i, field in enumerate(reader.schema):
        fmeta = field.metadata or {}
        cell = batch.column(i)
        if fmeta.get(b'kind') == b'raw':
            dtype = np.dtype(fmeta[b'dtype'].decode())
            shape = tuple(json.loads(fmeta[b'shape'].decode()))
            count = int(np.prod(shape, dtype=np.int64)) if shape else 1
            # read-only by construction: the mmap buffer is immutable
            columns[field.name] = np.frombuffer(
                cell.buffers()[2], dtype=dtype, count=count).reshape(shape)
            mmap_columns += 1
        else:
            col = pickle.loads(cell[0].as_py())
            if isinstance(col, np.ndarray):
                col.flags.writeable = False
            columns[field.name] = col
            copy_columns += 1
    return columns, length, mmap_columns, copy_columns


class MaterializedRowGroupCache(CacheBase):
    """Decoded row-group cache: bounded memory tier over a size-bounded
    Arrow-IPC disk tier.

    The ``get`` contract stores/returns decoded
    :class:`~petastorm_tpu_torch.arrow_worker.ColumnBatch` values (or None for
    row-groups the filter emptied — cached as a zero-length tombstone so
    warm epochs skip the re-read too). Safe across threads (internal
    lock) and across processes (atomic rename; pickling drops the lock
    and memory tier, so each pool worker gets a private hot tier over the
    one shared directory).

    :param path: cache directory (created if needed; stale tmp files of
        dead writers are purged at init).
    :param disk_limit_bytes: soft cap on the directory; least-recently-
        accessed entries are evicted when exceeded.
    :param mem_limit_bytes: cap of the in-memory tier (0 disables it).
    :param cleanup: remove the directory on :meth:`cleanup`.
    :param implicit_upgrade: True when this cache came from the
        fleet-wide ``PETASTORM_TPU_DECODED_CACHE=1`` upgrade rather than
        an explicit ``cache_type='decoded'``: the worker then refuses to
        cache TransformSpecs that never declared ``cacheable=True`` (the
        knob must not silently freeze an unmarked — possibly stochastic —
        transform's output).
    """

    def __init__(self, path, disk_limit_bytes, mem_limit_bytes=0,
                 cleanup=False, implicit_upgrade=False, **_unused):
        self._disk_limit = disk_limit_bytes
        self._mem_limit = mem_limit_bytes
        self._cleanup_on_exit = cleanup
        self.implicit_upgrade = implicit_upgrade
        self._lock = threading.Lock()
        self._mem = OrderedDict()   # key -> (columns, length, nbytes)
        self._mem_bytes = 0
        # degrade-don't-die state: a disk-fault errno (or a
        # run of consecutive store failures) disarms the DISK tier for
        # the rest of this process — reads decode through, the memory
        # tier keeps serving — instead of failing the epoch or paying a
        # failing syscall per row-group forever.
        self._degraded = False
        self._consecutive_failures = 0
        # fleet peer-fetch hook, armed only by a decode service's
        # worker wiring; None = plain host-local cache
        self._peer = None
        self._utime_at = {}  # entry path -> monotonic time of last touch
        self._attach(path)

    def _attach(self, path):
        self._path = path
        os.makedirs(path, exist_ok=True)
        # one walk: purge dead writers' tmp files + total the entries
        self._total = attach_scan(path)

    @property
    def degraded(self):
        """True when the disk tier disarmed itself after disk faults."""
        return self._degraded

    def reroot(self, path):
        """Re-point the cache at a different directory (a decode
        service's host-local ``PETASTORM_TPU_DECODED_CACHE_DIR``, whatever
        directory the client named). Re-arms a degraded tier: the fault
        belonged to the OLD medium."""
        with self._lock:
            self._mem.clear()
            self._mem_bytes = 0
            was_degraded = self._degraded
            self._degraded = False
            self._consecutive_failures = 0
            self._utime_at.clear()
        if was_degraded:
            # clear the stale telemetry too: a re-armed tier must not
            # keep reporting degraded=1
            self._registry().gauge(DECODED_CACHE_DEGRADED,
                                   pid=str(os.getpid())).set(0)
        self._attach(path)
        # a re-rooted dir that holds no real entries must not keep
        # advertising placement markers it no longer backs
        purge_stale_markers(path)

    def __getstate__(self):
        # Crosses the process-pool/service spawn boundary: the lock can't
        # travel and the memory tier shouldn't (each worker builds its own
        # hot set; the disk directory is the shared tier).
        state = self.__dict__.copy()
        del state['_lock']
        state['_mem'] = OrderedDict()
        state['_mem_bytes'] = 0
        state['_peer'] = None    # the fetch client owns sockets
        state['_utime_at'] = {}
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()
        # entries pickled by a pre-fleet-tier build
        self.__dict__.setdefault('_peer', None)
        self.__dict__.setdefault('_utime_at', {})

    @property
    def path(self):
        return self._path

    def _entry_path(self, key):
        digest = hashlib.sha1(str(key).encode('utf-8')).hexdigest()
        return os.path.join(self._path, digest[:2], digest + '.arrow')

    @staticmethod
    def _registry():
        return get_registry()

    def _size_gauge(self):
        # per-process series over the ONE shared directory; aggregated
        # with max, never sum (see telemetry.export's cache sections)
        return self._registry().gauge(DECODED_CACHE_SIZE_BYTES,
                                      pid=str(os.getpid()))

    # -- memory tier ---------------------------------------------------------

    @staticmethod
    def _columns_nbytes(columns):
        return sum(col.nbytes for col in columns.values()
                   if isinstance(col, np.ndarray))

    def _mem_get(self, key):
        if not self._mem_limit:
            return None
        with self._lock:
            entry = self._mem.get(key)
            if entry is not None:
                self._mem.move_to_end(key)
            return entry

    def _mem_put(self, key, columns, length):
        if not self._mem_limit:
            return
        nbytes = self._columns_nbytes(columns)
        if nbytes > self._mem_limit:
            return  # a single oversized batch would just thrash the tier
        # the tier SHARES these array objects with every later hit (and, on
        # the fill path, with the batch just returned to the consumer):
        # frozen, an in-place write raises at the write site instead of
        # corrupting the entry, and the torch bridges copy them. Armed,
        # the sanitizer freezes them and counts the views; unarmed they
        # are frozen all the same, where the reference leaves them
        # writable. AFTER the oversized bail-out: a batch the tier never
        # stores stays the consumer's own writable memory.
        if sanitizer.sanitize_enabled():
            sanitizer.guard_payload(columns)
        else:
            for col in columns.values():
                if isinstance(col, np.ndarray):
                    col.flags.writeable = False
        with self._lock:
            old = self._mem.pop(key, None)
            if old is not None:
                self._mem_bytes -= old[2]
            self._mem[key] = (columns, length, nbytes)
            self._mem_bytes += nbytes
            while self._mem_bytes > self._mem_limit and self._mem:
                _, (_, _, evicted) = self._mem.popitem(last=False)
                self._mem_bytes -= evicted

    # -- the cache contract --------------------------------------------------

    def get(self, key, fill_cache_func):
        from petastorm_tpu_torch.arrow_worker import ColumnBatch
        registry = self._registry()
        entry = self._entry_path(key)
        hit = self._mem_get(key)
        if hit is not None:
            registry.counter(DECODED_CACHE_HITS).inc()
            registry.counter(DECODED_CACHE_MEM_HITS).inc()
            # LRU touch even on memory-tier hits: the backing disk
            # entry's atime is what eviction sorts by, and without it
            # the disk LRU would evict exactly the hot working set —
            # invisible to THIS process, devastating to every fresh
            # pool worker and co-trained job sharing the directory.
            # Rate-limited: coarse freshness is all the LRU needs.
            self._touch_entry(entry)
            columns, length, _ = hit
            return ColumnBatch(dict(columns), length) if length else None
        if not self._degraded:
            try:
                if faults.ARMED:
                    faults.fault_hit('cache.read', key=entry)
                # stat BEFORE the span: a plain miss must not record a
                # cache_hit_read call or bill its failed open as hit time
                # (that would inflate the hit_side term the cache-phase
                # verdict weighs decode time against)
                size = os.stat(entry).st_size
                with span('cache_hit_read'):
                    columns, length, mmaped, copied = read_entry(entry)
                os.utime(entry)  # LRU touch
                registry.counter(DECODED_CACHE_HITS).inc()
                registry.counter(DECODED_CACHE_BYTES_READ).inc(size)
                registry.counter(DECODED_CACHE_MMAP_READS).inc(mmaped)
                registry.counter(DECODED_CACHE_COPY_READS).inc(copied)
                self._consecutive_failures = 0
                self._mem_put(key, columns, length)
                # a fresh wrapper per hit: workers stamp item_index/epoch
                # on the returned batch, and concurrent hits of one key
                # (two epochs in flight on a thread pool) must not race
                # that write
                return (ColumnBatch(dict(columns), length) if length
                        else None)
            except OSError as e:
                # ENOENT is the plain miss; anything else is the MEDIUM
                # failing (EIO, EACCES after a remount, ...) — counted,
                # and disk-fault errnos degrade the tier
                if e.errno not in (None, errno.ENOENT):
                    self._note_disk_failure('read', e)
            except Exception:  # noqa: BLE001 - truncated/corrupt entry
                logger.warning('decoded cache entry %s unreadable; '
                               'refilling', entry, exc_info=True)
                registry.counter(DECODED_CACHE_DISK_FAILURES,
                                 op='corrupt').inc()
                self._remove_entry(entry)
        registry.counter(DECODED_CACHE_MISSES).inc()
        if self._peer is not None and not self._degraded:
            # fleet tier: a known
            # holder serves the finished entry at wire price before we
            # pay the decode; ANY failure returns None and the local
            # fill below proceeds — degraded is never wrong
            served = self._peer.fetch(key, entry, self)
            if served is not None:
                columns, length = served
                self._mem_put(key, columns, length)
                return (ColumnBatch(dict(columns), length) if length
                        else None)
        batch = fill_cache_func()
        columns = dict(batch.columns) if batch is not None else {}
        length = batch.length if batch is not None else 0
        if self._degraded:
            # decode-through: the memory tier still serves repeats, the
            # broken disk is never touched again this process
            self._mem_put(key, columns, length)
            return batch
        try:
            with span('cache_fill'):
                if faults.ARMED:
                    faults.fault_hit('cache.write', key=entry)
                size, replaced = publish_entry(
                    entry, lambda tmp: write_entry(tmp, columns, length))
            registry.counter(DECODED_CACHE_BYTES_WRITTEN).inc(size)
            with self._lock:
                self._total += size - replaced
                over_limit = self._total > self._disk_limit
            self._size_gauge().set(self._total)
            self._consecutive_failures = 0
            self._mem_put(key, columns, length)
            _notify_published(entry, size)
            if over_limit:
                self._maybe_evict()
        except (OSError, ValueError, pickle.PicklingError) as e:
            logger.warning('decoded cache failed to store %r', key,
                           exc_info=True)
            self._note_disk_failure('store', e)
        return batch

    def _note_disk_failure(self, op, exc):
        """Count one swallowed disk-tier failure; degrade to
        decode-through on medium-indicting errnos (immediately — the set
        depends on the operation, see the errno-set comments above) or a
        run of consecutive failures of any shape. Every swallow is
        visible: the counter carries the op, the anomaly event carries
        the cause.

        The decision is taken under the tier's lock, once per degrade: an
        operation already in flight when another thread degraded the
        tier fails on the same fault, which was counted and announced
        once; it is not counted again."""
        errno_ = getattr(exc, 'errno', None)
        immediate = (_STORE_FAULT_ERRNOS if op == 'store'
                     else _READ_FAULT_ERRNOS)
        reason = None
        with self._lock:
            if self._degraded:
                return
            self._consecutive_failures += 1
            if errno_ in immediate:
                reason = '%s failed with %s (%s)' % (
                    op, errno.errorcode.get(errno_, errno_), exc)
            elif self._consecutive_failures >= _CONSECUTIVE_FAILURE_LIMIT:
                reason = '%d consecutive disk-tier failures (last: %s)' % (
                    self._consecutive_failures, exc)
            if reason is not None:
                self._degraded = True
        self._registry().counter(DECODED_CACHE_DISK_FAILURES, op=op).inc()
        if reason is not None:
            self._announce_degraded(reason)

    def _announce_degraded(self, reason):
        """Say ONCE that the disk tier is disarmed for the rest of this
        process: gauge, ``cache_degraded`` anomaly event (with its
        runbook), log. Reads decode through from here on — an epoch on a
        full disk finishes slower, it does not fail."""
        self._registry().gauge(DECODED_CACHE_DEGRADED,
                               pid=str(os.getpid())).set(1)
        record_anomaly('cache_degraded',
                       detail={'path': self._path, 'reason': reason})
        logger.warning('Decoded cache at %s degraded to decode-through: '
                       '%s', self._path, reason)

    def _touch_entry(self, entry):
        """Rate-limited LRU touch of a disk entry backing a memory-tier
        hit (at most once per entry per :data:`_UTIME_INTERVAL_S`)."""
        now = time.monotonic()
        with self._lock:
            last = self._utime_at.get(entry)
            if last is not None and now - last < _UTIME_INTERVAL_S:
                return
            if len(self._utime_at) > _UTIME_TRACKED_CAP:
                self._utime_at.clear()  # worst case: one extra utime each
            self._utime_at[entry] = now
        try:
            os.utime(entry)
        except OSError:
            pass

    # -- the fleet peer tier -------------------------------------------------

    def attach_peer_client(self, client):
        """Arm the fleet peer-fetch path (service worker wiring): on a
        local disk miss, ``client.fetch`` is tried before the decode."""
        self._peer = client

    def publish_fetched(self, entry, write_func):
        """Publish a peer-fetched entry into the disk tier with the same
        atomic tmp+rename discipline and size/eviction accounting as a
        local fill — on disk the peer path must be indistinguishable.
        Returns the published size; raises on failure (the fetch path
        degrades to local decode)."""
        size, replaced = publish_entry(entry, write_func)
        self._registry().counter(DECODED_CACHE_BYTES_WRITTEN).inc(size)
        with self._lock:
            self._total += size - replaced
            over_limit = self._total > self._disk_limit
        self._size_gauge().set(self._total)
        _notify_published(entry, size)
        if over_limit:
            self._maybe_evict()
        return size

    def _remove_entry(self, entry):
        try:
            size = os.stat(entry).st_size
            os.remove(entry)
            with self._lock:
                self._total -= size
        except OSError:
            pass

    def _maybe_evict(self):
        # shared LRU walk, OUTSIDE the lock: _mem_get/_mem_put take the
        # same lock on every get, and an eviction pass over a large tier
        # must not stall pure memory-tier hits behind disk I/O. Removal
        # under a live mmap is safe (POSIX keeps the pages mapped).
        with self._lock:
            before = self._total
        total, evictions, _ = evict_lru(self._path, self._disk_limit)
        with self._lock:
            # merge, don't assign (see LocalDiskCache._maybe_evict): a
            # concurrent publish during the walk must not be lost —
            # over-counting only costs an extra self-correcting walk
            self._total = total + (self._total - before)
        if evictions:
            self._registry().counter(DECODED_CACHE_EVICTIONS).inc(evictions)
        self._size_gauge().set(self._total)

    def cleanup(self):
        if self._cleanup_on_exit:
            import shutil
            shutil.rmtree(self._path, ignore_errors=True)
            return
        # a kept directory must not advertise placement markers for
        # entries that no longer exist
        purge_stale_markers(self._path)
