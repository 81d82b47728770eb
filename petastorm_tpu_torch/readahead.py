"""The readahead plane: coalesced column-chunk prefetch for the decode
workers (counterpart of ``petastorm_tpu/readahead.py``).

The ventilator fixes the order of the row-groups well before a worker
reads them, so storage I/O can run ahead of decode. Per process:

* a :class:`ReadaheadManager`, shared by every thread-pool worker of a
  reader, mirrors the ventilator's sequence arithmetically (the same
  per-epoch permutation, the same statistics-pruned exclusions, the same
  reset-stride seed advance), so it knows the upcoming row-groups without
  any extra channel;
* for each of them it plans the exact byte ranges of the needed column
  chunks from the memoized footer
  (:meth:`petastorm_tpu_torch.pushdown.StatsIndex.get_ranges`) and merges
  neighbouring ranges into large sequential reads
  (``PETASTORM_TPU_READAHEAD_GAP_KB``, ``.._MAX_RANGE_MB``);
* ``PETASTORM_TPU_READAHEAD_THREADS`` fetch threads
  (``petastorm-tpu-torch-readahead-<n>``) read them ``depth`` row-groups
  ahead into a byte-budgeted pool (``PETASTORM_TPU_READAHEAD_POOL_MB``),
  under the ``readahead_fetch`` stage;
* the worker's column read is then served zero-copy from the fetched
  buffers, through ``pq.ParquetFile(..., metadata=)`` over a file-like of
  the fetched ranges, and the pool holds the bytes until the served table
  dies.

A failure never changes an answer: a fetch error (the ``io.read``
faultpoint with a ``#readahead`` key), an unreadable footer, an exhausted
pool or a deserialization surprise degrades to the worker's blocking read,
counted in ``petastorm_tpu_readahead_degraded_total{reason=...}``.
``PETASTORM_TPU_READAHEAD=0`` keeps the blocking read everywhere, the
exact-parity oracle. Under a predicate only the predicate's columns
prefetch; the survivors' other columns stay on demand.

Where the port differs from the reference, on purpose: the fetch threads
carry the port's thread prefix, :meth:`ReadaheadManager.close` joins them
and leaves the live set at once, so a stopped and joined reader leaves no
manager and no fetch thread behind; the live set is read and written
under a lock, since a reader's close can race a tuner reading the set; an
entry lets go of its pool slot once every position it was fetched for has
been served, so the bytes return when the served table dies rather than
when the clock retires the entry (the retire slack keeps unserved entries
alive; a served one needs no slack); and a manager's first observe also
fetches its own item and the ones the other workers may be starting
beside it, which nothing earlier in the sequence could have scheduled.
"""

import logging
import math
import os
import threading
import weakref

from petastorm_tpu_torch import faults
from petastorm_tpu_torch.telemetry import (
    get_registry, knobs, metrics_disabled, register_refresh, span,
)

logger = logging.getLogger(__name__)

READAHEAD_HITS = 'petastorm_tpu_readahead_hits_total'
READAHEAD_MISSES = 'petastorm_tpu_readahead_misses_total'
READAHEAD_BYTES = 'petastorm_tpu_readahead_bytes_total'
READAHEAD_COALESCED_READS = 'petastorm_tpu_readahead_coalesced_reads_total'
READAHEAD_DEGRADED = 'petastorm_tpu_readahead_degraded_total'
READAHEAD_POOL_BYTES = 'petastorm_tpu_readahead_pool_bytes'

#: the reasons a fetch or a serve degrades to the blocking read
DEGRADE_REASONS = ('fetch-error', 'pool-exhausted', 'no-footer', 'no-columns',
                   'deserialize', 'fetch-timeout', 'cache')

#: the fetch threads' name prefix
THREAD_PREFIX = 'petastorm-tpu-torch-readahead-'

#: how long a serve waits on an in-flight fetch before it reads blocking
_SERVE_WAIT_S = 30.0
#: how long close() waits for each fetch thread to end
_JOIN_TIMEOUT_S = 10.0

#: bound on the per-manager order cache (current epoch and lookahead)
_ORDER_CACHE_MAX = 4
#: bound on the sweep-detection seen-sets (epochs retained)
_SEEN_EPOCHS_MAX = 4

#: the worker-args key the manager parks under (set on the worker side by
#: :func:`attach`, so it never crosses a pickling boundary)
_ARGS_KEY = '_readahead_manager'

# cached enablement knob (telemetry.refresh re-reads it)
_enabled = None

#: the autotuner's depth override, one per process: None = the knob rules
_depth_override = None

#: managers alive in this process; readers' workers add and close them
#: while a tuner on a staging thread reads the set, hence the lock
_live_managers = weakref.WeakSet()
_live_lock = threading.Lock()


def _live():
    with _live_lock:
        return list(_live_managers)


def readahead_enabled():
    """True unless ``PETASTORM_TPU_READAHEAD=0`` pins the blocking read (a
    miss is exactly the blocking read, so on is parity-safe)."""
    global _enabled
    if _enabled is None:
        _enabled = not knobs.is_disabled('PETASTORM_TPU_READAHEAD')
    return _enabled


def readahead_depth():
    """Row-groups fetched ahead of the sequence position, by the knob
    (:func:`current_depth` folds in the autotuner's override)."""
    return knobs.get_int('PETASTORM_TPU_READAHEAD_DEPTH', 4, floor=1)


def readahead_max_depth():
    """The autotuner's ceiling on the depth."""
    return knobs.get_int('PETASTORM_TPU_READAHEAD_MAX_DEPTH', 16, floor=1)


def readahead_threads():
    return knobs.get_int('PETASTORM_TPU_READAHEAD_THREADS', 2, floor=1)


def pool_budget_bytes():
    return knobs.get_int('PETASTORM_TPU_READAHEAD_POOL_MB', 256, floor=1) * 2 ** 20


def gap_bytes():
    """Neighbouring chunk ranges closer than this merge into one read (the
    gap is read and dropped: cheaper than a second request)."""
    return knobs.get_int('PETASTORM_TPU_READAHEAD_GAP_KB', 64, floor=0) * 1024


def max_range_bytes():
    """Upper bound on one merged read; a larger single chunk keeps its own
    undivided read."""
    return knobs.get_int('PETASTORM_TPU_READAHEAD_MAX_RANGE_MB', 16, floor=1) * 2 ** 20


def refresh_readahead():
    """Re-read the cached enablement knob (part of
    :func:`petastorm_tpu_torch.telemetry.refresh`); the sizing knobs are
    read at manager construction and per scheduling pass."""
    global _enabled
    _enabled = None


register_refresh(refresh_readahead)


def current_depth():
    """The live depth: the autotuner's override when set, else the knob."""
    override = _depth_override
    return override if override is not None else readahead_depth()


def depth_override():
    """The autotuner's depth override, or None."""
    return _depth_override


def set_depth_override(depth):
    """In-process override of the depth knob (the autotuner's seam, never
    an ``os.environ`` write); None restores the knob."""
    global _depth_override
    _depth_override = None if depth is None else max(1, int(depth))


def count_degrade(reason):
    """One degrade to the blocking read, by reason (one of
    :data:`DEGRADE_REASONS`)."""
    if not metrics_disabled():
        get_registry().counter(READAHEAD_DEGRADED, reason=reason).inc()


def live_manager_count():
    """Managers alive in this process (the autotuner moves the depth only
    where a manager can see it)."""
    return len(_live())


def pool_status():
    """``(bytes in use, budget bytes)`` over this process's live managers:
    the autotuner's memory-pressure signal."""
    used = 0
    budget = 0
    for manager in _live():
        used += manager._pool.used
        budget += manager._pool.budget
    return used, budget


def health_snapshot():
    """JSON-ready readahead state of this process for ``/health``."""
    used, budget = pool_status()
    registry = get_registry()
    return {
        'enabled': readahead_enabled(),
        'managers': live_manager_count(),
        'depth': current_depth(),
        'hits': int(registry.counter_value(READAHEAD_HITS)),
        'misses': int(registry.counter_value(READAHEAD_MISSES)),
        'pool_bytes': int(used),
        'pool_budget_bytes': int(budget),
    }


def _reset_for_tests():
    global _enabled, _depth_override
    _enabled = None
    _depth_override = None
    for manager in _live():
        manager.close()


# -- the ventilation-sequence plan (built by the Reader, rides worker_args) ---


def build_plan(items, pieces, randomize, seed, iterations, exclude, workers=None,
               interleave=None):
    """A picklable description of the ventilator's upcoming items.
    ``items`` are the ventilator's work items (each with ``piece_index``),
    ``pieces`` the row-group list, ``seed`` the ventilator's resolved seed,
    ``exclude`` the statistics-pruned item indices (never ventilated, so
    never fetched) and ``workers`` the pool's worker count, which sizes the
    retire slack.

    ``interleave``, for one source of a weighted mixture, carries that
    source's normalized ``share`` in (0, 1]: the source's ventilation order
    is its upcoming order, so only the prefetch depth scales by the share,
    and the sources split the window in mixing proportion."""
    if interleave is not None:
        share = float(interleave.get('share', 1.0))
        if not 0.0 < share <= 1.0:
            raise ValueError('interleave share must be in (0, 1], got %r' % (share,))
        interleave = dict(interleave, share=share)
    return {
        'version': 1,
        'items': [(pieces[it['piece_index']].path, pieces[it['piece_index']].row_group)
                  for it in items],
        'randomize': bool(randomize),
        'seed': int(seed),
        'iterations': iterations,
        'exclude': sorted(exclude or ()),
        'workers': workers,
        'interleave': interleave,
    }


def attach(args):
    """The worker side: this reader's manager, created at the first call
    and counted once per worker. None when the plane is off or the reader
    shipped no plan (a caching reader)."""
    plan = args.get('readahead_plan') if isinstance(args, dict) else None
    if plan is None or not readahead_enabled():
        return None
    manager = args.get(_ARGS_KEY)
    if manager is None:
        manager = ReadaheadManager(args['dataset_info'], plan)
        args[_ARGS_KEY] = manager
    manager.acquire()
    return manager


def release(args):
    """One worker out; the last one closes the manager."""
    manager = args.get(_ARGS_KEY) if isinstance(args, dict) else None
    if manager is not None and manager.release() == 0:
        args.pop(_ARGS_KEY, None)


# -- the bounded buffer pool --------------------------------------------------


class _BufferPool:
    """Byte budget over in-flight and served fetch buffers. ``acquire`` is
    all or nothing: a fetch that does not fit degrades to the blocking read
    rather than evicting another's bytes."""

    def __init__(self, budget):
        self.budget = budget
        self.used = 0
        self._lock = threading.Lock()

    def acquire(self, nbytes):
        with self._lock:
            if self.used + nbytes > self.budget:
                return False
            self.used += nbytes
        self._note_gauge()
        return True

    def free(self, nbytes):
        with self._lock:
            self.used = max(0, self.used - nbytes)
        self._note_gauge()

    def _note_gauge(self):
        if not metrics_disabled():
            get_registry().gauge(READAHEAD_POOL_BYTES, pid=str(os.getpid())).set(self.used)


# -- one prefetched row-group -------------------------------------------------


_PENDING, _READY, _FAILED = 'pending', 'ready', 'failed'


class _Fetch:
    """One scheduled row-group fetch. ``refs`` starts at 1 (the manager's
    slot); each served table adds one and drops it from a
    ``weakref.finalize``, so the pooled bytes live exactly as long as
    something can read them. The fetch thread, serving workers, the retire
    sweep and finalizers share one per-entry lock."""

    __slots__ = ('rgkey', 'max_gpos', 'state', 'event', 'columns', 'ranges', 'nbytes',
                 'file_size', 'refs', 'unserved', 'slotted', '_lock', '_pool', '_guards',
                 '__weakref__')

    def __init__(self, rgkey, max_gpos, pool):
        self.rgkey = rgkey
        self.max_gpos = max_gpos
        self.state = _PENDING
        self.event = threading.Event()
        self.columns = frozenset()
        self.ranges = []
        self.nbytes = 0
        self.file_size = None
        self.refs = 1
        # positions still to serve; the manager's slot holds until none is
        self.unserved = 1
        self.slotted = True
        self._lock = threading.Lock()
        self._pool = pool
        self._guards = []

    def add_position(self, gpos):
        """Sequence position ``gpos`` wants this row-group too. A later
        position is one more serve before the slot lets go; False when the
        slot already let go (every earlier position was served), so the
        caller fetches anew."""
        with self._lock:
            if gpos <= self.max_gpos:
                return True
            if not self.slotted:
                return False
            self.max_gpos = gpos
            self.unserved += 1
            return True

    def served(self):
        """One position served; after the last the slot lets go, and the
        bytes return to the pool when the served tables die."""
        with self._lock:
            self.unserved -= 1
            last = self.unserved <= 0
        if last:
            self.retire()

    def complete(self, ranges, guards, nbytes, columns, file_size):
        """The fetch thread hands over the bytes; False when the entry was
        retired meanwhile (the caller returns the pool bytes)."""
        with self._lock:
            if self.state != _PENDING:
                return False
            self.ranges = ranges
            self._guards = guards
            self.nbytes = nbytes
            self.columns = frozenset(columns)
            self.file_size = file_size
            self.state = _READY
        self.event.set()
        return True

    def fail(self):
        """A pending fetch failed or was declined (idempotent)."""
        with self._lock:
            if self.state == _PENDING:
                self.state = _FAILED
        self.event.set()

    def retire(self):
        """The manager's slot lets go, once: a pending entry is cancelled,
        a ready one drops the slot's reference."""
        with self._lock:
            if not self.slotted:
                return
            self.slotted = False
            if self.state == _PENDING:
                self.state = _FAILED
                drop = False
            else:
                drop = self.state == _READY
        self.event.set()
        if drop:
            self.drop_ref()

    def try_add_ref(self):
        """One more holder, only while the entry can still serve."""
        with self._lock:
            if self.state != _READY:
                return False
            self.refs += 1
            return True

    def drop_ref(self):
        """The last holder out (on any thread, a finalizer too) checks the
        canaries, drops the buffers and returns the pool bytes, once."""
        with self._lock:
            self.refs -= 1
            reclaim = self.refs <= 0 and self.state == _READY
            if reclaim:
                self.state = _FAILED
                ranges, self.ranges = self.ranges, []
                guards, self._guards = self._guards, []
        if reclaim:
            self._check_guards(guards)
            del ranges
            self._pool.free(self.nbytes)

    def _check_guards(self, guards):
        """Armed fetch buffers sit between red zones: a trampled zone means
        something wrote through a served zero-copy view."""
        if not guards:
            return
        from petastorm_tpu_torch import sanitizer
        for guard in guards:
            if not sanitizer.check_canaries(guard):
                sanitizer.record_violation('readahead-canary',
                                           {'path': self.rgkey[0], 'row_group': self.rgkey[1]})


# -- zero-copy range-backed file ----------------------------------------------


class _OutsideRanges(Exception):
    """A read fell outside the fetched ranges: the serve degrades."""


class _RangeSource:
    """A minimal file-like over the fetched ranges for
    ``pq.ParquetFile(..., metadata=)``: a read inside a range returns a
    zero-copy :class:`pyarrow.Buffer` slice; any other raises
    :class:`_OutsideRanges`."""

    def __init__(self, ranges, file_size):
        import pyarrow as pa
        # a borrow of the entry's pooled buffers: the serving caller holds
        # an entry reference for as long as this source and every slice it
        # hands out live (weakref.finalize on the served table)  # pipesan: owns
        self._readers = [(start, len(buf), pa.BufferReader(buf)) for start, buf in ranges]
        self._size = file_size
        self._pos = 0
        self.closed = False

    def seekable(self):
        return True

    def readable(self):
        return True

    def writable(self):
        return False

    def tell(self):
        return self._pos

    def size(self):
        if self._size is None:
            raise _OutsideRanges('file size unknown')
        return self._size

    def seek(self, offset, whence=0):
        if whence == 0:
            self._pos = offset
        elif whence == 1:
            self._pos += offset
        else:
            self._pos = self.size() + offset
        return self._pos

    def read(self, nbytes=-1):
        if nbytes is None or nbytes < 0:
            raise _OutsideRanges('unbounded read at %d' % self._pos)
        for start, length, reader in self._readers:
            if start <= self._pos and self._pos + nbytes <= start + length:
                reader.seek(self._pos - start)
                out = reader.read_buffer(nbytes)
                self._pos += nbytes
                return out
        raise _OutsideRanges('read [%d, +%d) outside fetched ranges' % (self._pos, nbytes))

    def close(self):
        self.closed = True


# -- range planning -----------------------------------------------------------


def coalesce_ranges(chunk_ranges, gap, max_range):
    """Merge ``(start, length)`` chunk ranges, sorted first: neighbours at
    most ``gap`` bytes apart merge while the merged read stays within
    ``max_range``; a single larger chunk keeps its own read."""
    merged = []
    for start, length in sorted(chunk_ranges):
        if merged:
            last_start, last_len = merged[-1]
            end = last_start + last_len
            if start - end <= gap and max(end, start + length) - last_start <= max_range:
                merged[-1] = (last_start, max(end, start + length) - last_start)
                continue
        merged.append((start, length))
    return merged


# -- the per-reader manager ---------------------------------------------------


class ReadaheadManager:
    """One reader's readahead scheduler in this process (module docstring).

    Thread-safe: every worker calls :meth:`observe` and :meth:`serve`; the
    fetch threads complete entries. A mispredicted order (a resumed epoch's
    exclusions, a restored seed) costs misses, which are the blocking read.
    """

    def __init__(self, dataset_info, plan):
        from petastorm_tpu_torch.pushdown import StatsIndex
        self._info = dataset_info
        self._items = [tuple(item) for item in plan['items']]
        self._randomize = plan['randomize']
        self._seed = plan['seed']
        self._iterations = plan.get('iterations')
        self._exclude = frozenset(plan.get('exclude') or ())
        self._stats = StatsIndex(dataset_info)
        self._pool = _BufferPool(pool_budget_bytes())
        self._gap = gap_bytes()
        self._max_range = max_range_bytes()
        # retire slack: up to N workers can sit between their observe (which
        # advances the clock) and their serve, so only entries further
        # behind retire; too small a slack costs misses, never rows
        self._workers = plan.get('workers') or 1
        self._retire_slack = max(4, 2 * self._workers)
        # a mixture source's share scales its prefetch depth
        self._mix_share = (plan.get('interleave') or {}).get('share')
        self._lock = threading.Lock()
        self._footer_lock = threading.Lock()
        self._columns = None
        self._entries = {}
        self._orders = {}     # (sweep, epoch) -> (order, pos_map, base)
        self._next_base = 0
        self._clock = -1
        self._sweep = 0
        self._seen_by_epoch = {}
        self._max_epoch = -1
        self._dup_streak = 0
        self._refs = 0
        self._closed = False
        self._queue = None
        self._threads = []
        with _live_lock:
            _live_managers.add(self)

    # -- lifecycle ------------------------------------------------------------

    def acquire(self):
        with self._lock:
            self._refs += 1

    def release(self):
        with self._lock:
            self._refs -= 1
            refs = self._refs
        if refs <= 0:
            self.close()
        return refs

    def close(self):
        """Stop and join the fetch threads, retire every entry and leave
        the live set (idempotent)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            threads, self._threads = self._threads, []
            entries, self._entries = dict(self._entries), {}
            q = self._queue
        with _live_lock:
            _live_managers.discard(self)
        if q is not None:
            # one sentinel each; a fetch still mid-read completes into a
            # retired entry and returns its bytes itself
            for _ in threads:
                q.put(None)
        for entry in entries.values():
            entry.retire()
        current = threading.current_thread()
        for thread in threads:
            if thread is not current:
                thread.join(_JOIN_TIMEOUT_S)

    # -- worker-facing API ----------------------------------------------------

    def observe(self, item_index, epoch, columns):
        """A worker is loading ``item_index`` of ``epoch``: advance the
        sequence clock, retire passed entries and schedule fetches ``depth``
        positions ahead. ``columns``, fixed at the first call, is the
        prefetchable set (the predicate's columns under a predicate)."""
        if item_index is None or epoch is None:
            return
        tasks = []
        with self._lock:
            if self._closed:
                return
            if self._columns is None:
                self._columns = frozenset(columns)
            sweep = self._advance_sweep_locked(item_index, epoch)
            gpos = self._position_locked(sweep, epoch, item_index)
            if gpos is None:
                return
            # the first observe fetches its own item and the workers - 1
            # before it too: nothing earlier scheduled them
            start = 1
            if self._clock < 0:
                base = self._order_for_locked(sweep, epoch)[2]
                start = -min(gpos - base, self._workers - 1)
            if gpos > self._clock:
                self._clock = gpos
            self._retire_passed_locked()
            # the window counts global sequence positions, at least the
            # worker count wide
            depth = current_depth()
            if self._mix_share:
                depth = max(1, int(math.ceil(depth * self._mix_share)))
            depth = max(depth, self._workers)
            for offset in range(start, depth + 1):
                upcoming = self._at_locked(sweep, epoch, gpos + offset)
                if upcoming is None:
                    break
                next_gpos, next_item = upcoming
                rgkey = self._items[next_item]
                entry = self._entries.get(rgkey)
                if entry is not None and entry.add_position(next_gpos):
                    continue
                entry = _Fetch(rgkey, next_gpos, self._pool)
                self._entries[rgkey] = entry
                tasks.append(entry)
        for entry in tasks:
            self._submit(entry)

    def serve(self, pf, path, row_group, columns):
        """The prefetched row-group as a :class:`pyarrow.Table`, or None
        (the caller's blocking read is the fallback). ``pf`` supplies the
        parsed footer, so a hit reads nothing from storage."""
        wanted = set(columns)
        with self._lock:
            entry = self._entries.get((path, row_group))
            configured = self._columns
        if configured is None or not wanted <= configured:
            # an on-demand column set (late-materialized columns) passes by
            # uncounted: no fetch was ever meant to serve it
            return None
        if entry is None:
            self._count(READAHEAD_MISSES)
            return None
        if not entry.event.wait(timeout=_SERVE_WAIT_S):
            count_degrade('fetch-timeout')
            self._count(READAHEAD_MISSES)
            return None
        if entry.state != _READY or not wanted <= entry.columns or not entry.try_add_ref():
            self._count(READAHEAD_MISSES)
            return None
        table = None
        try:
            import pyarrow.parquet as pq
            source = _RangeSource(entry.ranges, entry.file_size)
            table = pq.ParquetFile(source, metadata=pf.metadata).read_row_group(
                row_group, columns=sorted(wanted))
        except Exception:  # noqa: BLE001 - degrade, never a wrong answer
            logger.debug('readahead: serving %s#rg%d from the pool failed; reading it '
                         'blocking', path, row_group, exc_info=True)
            count_degrade('deserialize')
            self._count(READAHEAD_MISSES)
            return None
        finally:
            if table is None:
                entry.drop_ref()
        # the table may hold zero-copy slices of the pooled buffers: the
        # finalizer keeps the pool's accounting to the table's lifetime
        weakref.finalize(table, entry.drop_ref)
        entry.served()
        self._count(READAHEAD_HITS)
        return table

    # -- sequence arithmetic (mirrors workers/ventilator.py) ------------------

    def _advance_sweep_locked(self, item_index, epoch):
        """Detect a ventilator ``reset()`` sweep (epochs restart at 0, the
        seed advances by the reset stride) from the item stream: two
        consecutive repeated (epoch, item) pairs (a lone redelivery repeats
        one item and must not desync the seed), or an epoch three or more
        below the highest seen (pipelining straddles at most a couple of
        epoch boundaries). A wrong guess costs misses, never rows."""
        restarted = epoch <= self._max_epoch - 3
        seen = self._seen_by_epoch.get(epoch)
        duplicate = seen is not None and item_index in seen
        self._dup_streak = self._dup_streak + 1 if duplicate else 0
        if restarted or self._dup_streak >= 2:
            self._sweep += 1
            self._dup_streak = 0
            self._seen_by_epoch = {}
            self._orders = {}
            self._max_epoch = epoch
            seen = None
        elif epoch > self._max_epoch:
            self._max_epoch = epoch
        if seen is None:
            seen = self._seen_by_epoch.setdefault(epoch, set())
            while len(self._seen_by_epoch) > _SEEN_EPOCHS_MAX:
                self._seen_by_epoch.pop(min(self._seen_by_epoch))
        seen.add(item_index)
        return self._sweep

    def _epoch_order(self, sweep, epoch):
        """The ventilator's order of ``epoch`` (its own ``epoch_order``) at
        the sweep-advanced seed, without the pruned items."""
        from petastorm_tpu_torch.workers.ventilator import _RESET_SEED_STRIDE, epoch_order
        seed = (self._seed + sweep * _RESET_SEED_STRIDE) % (2 ** 32)
        order = epoch_order(len(self._items), seed, epoch, self._randomize)
        if self._exclude:
            order = [i for i in order if i not in self._exclude]
        return order

    def _order_for_locked(self, sweep, epoch):
        key = (sweep, epoch)
        cached = self._orders.get(key)
        if cached is None:
            order = self._epoch_order(sweep, epoch)
            pos_map = {item: i for i, item in enumerate(order)}
            cached = (order, pos_map, self._next_base)
            self._next_base += max(1, len(order))
            self._orders[key] = cached
            while len(self._orders) > _ORDER_CACHE_MAX:
                self._orders.pop(min(self._orders))
        return cached

    def _position_locked(self, sweep, epoch, item_index):
        _, pos_map, base = self._order_for_locked(sweep, epoch)
        pos = pos_map.get(item_index)
        return None if pos is None else base + pos

    def _at_locked(self, sweep, epoch, gpos):
        """``(gpos, item_index)`` at sequence position ``gpos``, spilling
        into the next epoch where the iteration count allows, or None past
        the end of ventilation."""
        for _ in range(2):
            order, _, base = self._order_for_locked(sweep, epoch)
            if base <= gpos < base + len(order):
                return gpos, order[gpos - base]
            if gpos < base:
                return None
            if self._iterations is not None and epoch + 1 >= self._iterations:
                return None
            epoch += 1
        return None

    def _retire_passed_locked(self):
        """Drop the entries whose last position fell behind the clock by
        more than the retire slack: their pool bytes fund the fetches
        ahead."""
        if not self._entries:
            return
        horizon = self._clock - self._retire_slack
        passed = [key for key, entry in self._entries.items() if entry.max_gpos < horizon]
        for key in passed:
            self._entries.pop(key).retire()

    # -- the fetch side -------------------------------------------------------

    def _submit(self, entry):
        import queue as queue_mod
        with self._lock:
            if self._closed:
                entry.fail()
                return
            if self._queue is None:
                self._queue = queue_mod.Queue()
                for i in range(readahead_threads()):
                    thread = threading.Thread(target=self._fetch_loop, args=(self._queue,),
                                              daemon=True, name='%s%d' % (THREAD_PREFIX, i))
                    thread.start()
                    self._threads.append(thread)
            q = self._queue
        q.put(entry)

    def _fetch_loop(self, q):
        while True:
            entry = q.get()
            if entry is None:
                return
            if entry.state != _PENDING:
                continue  # retired while queued
            try:
                with span('readahead_fetch'):
                    self._fetch(entry)
            except Exception:  # noqa: BLE001 - degrade, never crash
                logger.warning('readahead: fetch of %s#rg%d failed; the worker will read '
                               'it blocking', entry.rgkey[0], entry.rgkey[1], exc_info=True)
                count_degrade('fetch-error')
                entry.fail()

    def _fetch(self, entry):
        path, row_group = entry.rgkey
        if faults.ARMED:
            # the worker's blocking-read faultpoint; match=#readahead
            # targets fetches alone, which must degrade, never lose a row
            faults.fault_hit('io.read', key='%s#rg%d#readahead' % (path, row_group))
        planned, decline = self._plan_ranges(path, row_group)
        if planned is None:
            count_degrade(decline)
            entry.fail()
            return
        ranges, colnames = planned
        nbytes = sum(length for _, length in ranges)
        if not self._pool.acquire(nbytes):
            count_degrade('pool-exhausted')
            entry.fail()
            return
        try:
            buffers, guards, file_size = self._read_ranges(path, ranges)
        except Exception:
            entry.fail()
            self._pool.free(nbytes)
            raise
        if not entry.complete(buffers, guards, nbytes, colnames, file_size):
            self._pool.free(nbytes)  # retired while in flight
            return
        if not metrics_disabled():
            registry = get_registry()
            registry.counter(READAHEAD_BYTES).inc(nbytes)
            registry.counter(READAHEAD_COALESCED_READS).inc(len(ranges))

    def _plan_ranges(self, path, row_group):
        """``((merged reads, column names), None)`` over the configured
        columns' chunks of one row-group, or ``(None, reason)``:
        ``no-footer`` when the footer is unreadable, ``no-columns`` when no
        configured column has chunks in the file."""
        with self._footer_lock:
            self._stats.prefetch([path])
            chunk_ranges = self._stats.get_ranges(path, row_group)
        if not chunk_ranges:
            return None, 'no-footer'
        with self._lock:
            columns = self._columns or frozenset()
        chunks = []
        colnames = []
        for name in sorted(columns):
            col_chunks = chunk_ranges.get(name)
            if col_chunks:
                chunks.extend(col_chunks)
                colnames.append(name)
        if not chunks:
            return None, 'no-columns'
        return (coalesce_ranges(chunks, self._gap, self._max_range), colnames), None

    def _read_ranges(self, path, ranges):
        """One open, one sequential read per merged range. Returns the
        ``(start, pyarrow buffer)`` pairs, the sanitizer's guard slabs
        (armed only) and the file size."""
        import pyarrow as pa

        from petastorm_tpu_torch import sanitizer
        armed = sanitizer.sanitize_enabled()
        buffers = []
        guards = []
        with self._info.open(path) as f:
            file_size = getattr(f, 'size', None)
            if callable(file_size):
                file_size = file_size()
            for start, length in ranges:
                f.seek(start)
                data = f.read(length)
                if len(data) != length:
                    raise IOError('short read of %s [%d, +%d): got %d'
                                  % (path, start, length, len(data)))
                if armed:
                    import torch
                    slab, view = sanitizer.allocate_guarded((length,), torch.uint8)
                    view.numpy()[:] = memoryview(data)
                    guards.append(slab)
                    buffers.append((start, pa.py_buffer(view.numpy())))
                else:
                    buffers.append((start, pa.py_buffer(data)))
        return buffers, guards, file_size

    @staticmethod
    def _count(name):
        if not metrics_disabled():
            get_registry().counter(name).inc()


__all__ = ['DEGRADE_REASONS', 'ReadaheadManager', 'attach', 'build_plan', 'coalesce_ranges',
           'count_degrade', 'current_depth', 'depth_override', 'health_snapshot',
           'live_manager_count', 'pool_status', 'readahead_enabled', 'release',
           'set_depth_override']
