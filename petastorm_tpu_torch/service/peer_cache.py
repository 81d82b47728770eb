"""The fleet-wide decoded-cache tier (counterpart of
``petastorm_tpu/service/peer_cache.py``): decode once per fleet, not per
host. Four planes:

* **Advert**: each worker server's :class:`PeerCacheServer` scans its
  decoded-cache directory at start-up and advertises the entry digests it
  holds, in full on REGISTER and then as bounded add/remove/touch deltas in
  the heartbeat summary (``summary['peer']``).
* **Directory**: the dispatcher folds the adverts into a
  :class:`FleetCacheDirectory` (digest → holders), prunes it on deregister,
  replicates it into the standby snapshot, answers ``DIRGET`` and
  piggybacks recent rows on WORK frames.
* **Peer fetch**: on a local disk miss with a known holder,
  :class:`PeerCacheClient` fetches the finished Arrow IPC entry from the
  holder's serve socket into a byte-budgeted arena, checks its length and
  sha1, publishes it through the cache's atomic tmp+rename path and serves
  it under the ``peer_fetch`` stage: no decode runs. Every failure returns
  None, is counted by reason and falls back to the local decode.
* **Global eviction**: the dispatcher ships advisory evict hints for
  over-replicated cold entries on heartbeat ACKs; the holder re-checks its
  own atime first.

``PETASTORM_TPU_PEER_CACHE=0`` turns every plane off and is the host-local
oracle. The frames are the reference's, so a port holder serves a JAX
fetcher and the other way round.
"""

import hashlib
import json
import logging
import os
import re
import threading
import time

from petastorm_tpu_torch import faults
from petastorm_tpu_torch.service import protocol as proto
from petastorm_tpu_torch.telemetry import count_swallowed, knobs, span
from petastorm_tpu_torch.telemetry.registry import get_registry

logger = logging.getLogger(__name__)

# telemetry counter names; hits/bytes count successful fetches on the
# FETCHING worker, misses carry the degrade reason, evict_hints counts
# dispatcher hints
PEER_CACHE_HITS = 'petastorm_tpu_peer_cache_hits_total'
PEER_CACHE_MISSES = 'petastorm_tpu_peer_cache_misses_total'
PEER_CACHE_BYTES = 'petastorm_tpu_peer_cache_bytes_total'
PEER_CACHE_EVICT_HINTS = 'petastorm_tpu_peer_cache_evict_hints_total'

#: a decoded-cache entry basename is its key's sha1 hexdigest
_DIGEST_RE = re.compile(r'[0-9a-f]{40}')
_ENTRY_SUFFIX = '.arrow'

#: serve-side chunking: slices of ONE read, sent zero-copy
_CHUNK_BYTES = 4 << 20

# advert bounds: the heartbeat frame stays small however big the tier is;
# anything over a cap carries over to the next heartbeat
_ADVERT_CAP = 64
_TOUCH_CAP = 32
_REGISTER_CAP = 1024
_RESCAN_INTERVAL_S = 2.0
#: atime churn below this granularity is not re-advertised
_TOUCH_GRANULARITY_S = 5.0

# dispatcher-side bounds
_DIR_LOG_CAP = 512          # recent-digest log feeding WORK piggybacks
_WORK_PIGGYBACK_CAP = 32    # digests per WORK trailing frame
_HINTS_PER_ACK_CAP = 16     # evict-hints per heartbeat ACK
_PENDING_HINTS_CAP = 64     # queued hints per worker
_SNAPSHOT_CAP = 4096        # digests replicated to the standby
_SEED_TTL_S = 60.0          # failover-seeded entries age out unclaimed
_SEED_PREFIX = b'@seed/'    # synthetic holder identity for seeded rows

#: a digest the directory just said nobody holds is not re-asked for this
#: long (the first epoch would otherwise pay one DIRGET round-trip a miss)
_NEGATIVE_TTL_S = 3.0
_MIRROR_CAP = 8192


def peer_cache_enabled():
    """On by default; ``PETASTORM_TPU_PEER_CACHE=0`` is the host-local
    exact-parity oracle."""
    return not knobs.is_disabled('PETASTORM_TPU_PEER_CACHE')


def materialized_cache_of(worker_args):
    """The job's materialized decoded cache (``worker_args['cache']``), or
    None."""
    from petastorm_tpu_torch.materialized_cache import MaterializedRowGroupCache
    cache = worker_args.get('cache') if isinstance(worker_args, dict) else None
    return cache if isinstance(cache, MaterializedRowGroupCache) else None


def entry_digest(path):
    """The advertised digest of a decoded-cache entry path (the sha1
    basename), or None for anything that is not an entry."""
    name = os.path.basename(path)
    if not name.endswith(_ENTRY_SUFFIX):
        return None
    stem = name[:-len(_ENTRY_SUFFIX)]
    return stem if _DIGEST_RE.fullmatch(stem) else None


def digest_entry_path(cache_dir, digest):
    """Inverse of :func:`entry_digest` under the cache's sharded layout."""
    return os.path.join(cache_dir, digest[:2], digest + _ENTRY_SUFFIX)


# -- worker side: the serve socket and the advert source ---------------------


class PeerCacheServer:
    """One per worker-server process: a ROUTER serving finished entry bytes
    to fleet peers, plus the digest registry the adverts are cut from (a
    start-up directory scan, so it survives restarts; a periodic rescan and
    this process's publish notifications keep it fresh)."""

    def __init__(self, cache_dir, host=None):
        import zmq
        self.cache_dir = cache_dir
        host = host or knobs.get_str('PETASTORM_TPU_PEER_CACHE_HOST') or '127.0.0.1'
        self._context = zmq.Context()
        self._sock = self._context.socket(zmq.ROUTER)
        self._sock.setsockopt(zmq.LINGER, 0)
        port = self._sock.bind_to_random_port('tcp://%s' % host)
        self.endpoint = 'tcp://%s:%d' % (host, port)
        self._lock = threading.Lock()
        self._entries = {}     # digest -> (size, atime)
        self._announced = {}   # digest -> (size, atime) as last advertised
        self._last_scan = 0.0
        self._closed = threading.Event()
        self.served = 0
        self.evicted_on_hint = 0
        self._rescan(force=True)
        self._thread = threading.Thread(target=self._serve_loop, daemon=True,
                                        name='petastorm-tpu-torch-peer-cache-serve')
        self._thread.start()
        # entries THIS process publishes are advertised at once (the scan
        # would lag by its rescan interval)
        from petastorm_tpu_torch import materialized_cache
        materialized_cache.add_publish_listener(self._note_published)
        logger.info('Peer cache serving %s at %s', cache_dir, self.endpoint)

    # -- digest registry -----------------------------------------------------

    def _note_published(self, path, size):
        digest = entry_digest(path)
        if digest is None or os.path.dirname(os.path.dirname(path)) \
                != self.cache_dir.rstrip(os.sep):
            return
        with self._lock:
            self._entries[digest] = (size, time.time())

    def _rescan(self, force=False):
        now = time.monotonic()
        if not force and now - self._last_scan < _RESCAN_INTERVAL_S:
            return
        self._last_scan = now
        from petastorm_tpu_torch.cache import scan_dir_entries
        try:
            found, _ = scan_dir_entries(self.cache_dir)
        except Exception:  # noqa: BLE001 - adverts are advisory
            count_swallowed('peer-cache-scan')
            return
        entries = {}
        for atime, size, path in found:
            digest = entry_digest(path)
            if digest:
                entries[digest] = (size, atime)
        with self._lock:
            self._entries = entries

    def full_advert(self):
        """The REGISTER advert: every held digest (freshest first, capped;
        an over-cap tier trickles its tail through heartbeat deltas). Resets
        the delta baseline to what this advert carries."""
        self._rescan(force=True)
        with self._lock:
            items = sorted(self._entries.items(), key=lambda kv: -kv[1][1])[:_REGISTER_CAP]
            self._announced = dict(items)
            full = [[d, size, int(atime)] for d, (size, atime) in items]
        return {'ep': self.endpoint, 'full': full}

    def advert_delta(self):
        """The bounded per-heartbeat delta (``summary['peer']``): adds,
        removes and coarse last-touch updates since the previous advert,
        capped with carry-over. None when nothing changed."""
        self._rescan()
        adds, removes, touches = [], [], []
        with self._lock:
            for digest, (size, atime) in self._entries.items():
                old = self._announced.get(digest)
                if old is None:
                    if len(adds) < _ADVERT_CAP:
                        adds.append([digest, size, int(atime)])
                        self._announced[digest] = (size, atime)
                elif atime - old[1] >= _TOUCH_GRANULARITY_S:
                    if len(touches) < _TOUCH_CAP:
                        touches.append([digest, int(atime)])
                        self._announced[digest] = (size, atime)
            for digest in list(self._announced):
                if digest not in self._entries and len(removes) < _ADVERT_CAP:
                    removes.append(digest)
                    del self._announced[digest]
        if not (adds or removes or touches):
            return None
        out = {'ep': self.endpoint}
        if adds:
            out['add'] = adds
        if removes:
            out['rm'] = removes
        if touches:
            out['t'] = touches
        return out

    def apply_evict_hints(self, digests):
        """Advisory global-eviction hints: drop an over-replicated entry only
        if it is cold here too (local recency and size bounds stay
        authoritative). Returns the number removed."""
        cold_s = knobs.get_float('PETASTORM_TPU_PEER_CACHE_COLD_S', 300.0, floor=0.0)
        removed = 0
        now = time.time()
        for digest in list(digests)[:_HINTS_PER_ACK_CAP]:
            if not isinstance(digest, str) or not _DIGEST_RE.fullmatch(digest):
                continue
            path = digest_entry_path(self.cache_dir, digest)
            try:
                if now - os.stat(path).st_atime < cold_s:
                    continue  # locally hot: decline the hint
                os.remove(path)
            except OSError:
                continue
            removed += 1
            with self._lock:
                self._entries.pop(digest, None)
        if removed:
            self.evicted_on_hint += removed
        return removed

    # -- the serve loop ------------------------------------------------------

    def _serve_loop(self):
        import zmq
        poller = zmq.Poller()
        poller.register(self._sock, zmq.POLLIN)
        while not self._closed.is_set():
            try:
                if not poller.poll(100):
                    continue
                frames = self._sock.recv_multipart()
            except Exception:  # noqa: BLE001 - context shut down under us
                if self._closed.is_set():
                    return
                count_swallowed('peer-serve-recv')
                continue
            try:
                self._serve_one(frames)
            except Exception:  # noqa: BLE001 - the fetcher times out into a decode
                count_swallowed('peer-serve')

    def _serve_one(self, frames):
        if len(frames) < 3 or frames[1] != proto.MSG_PEER_FETCH:
            return  # unknown vocabulary: ignored (additive compatibility)
        identity, digest_frame = frames[0], frames[2]
        digest = digest_frame.decode('ascii', 'replace')
        reply = None
        if _DIGEST_RE.fullmatch(digest):
            reply = self._entry_reply(digest, digest_frame)
        if reply is None:
            reply = [proto.MSG_PEER_MISS, digest_frame]
        if faults.ARMED and faults.fault_hit('zmq.peer_serve', key=digest) == 'drop':
            return  # injected peer loss: no reply, the fetcher degrades
        self._sock.send_multipart([identity] + reply, copy=False)
        if reply[0] == proto.MSG_PEER_ENTRY:
            self.served += 1

    def _entry_reply(self, digest, digest_frame):
        path = digest_entry_path(self.cache_dir, digest)
        try:
            with open(path, 'rb') as f:
                data = f.read()
        except OSError:
            return None  # evicted since advertised: an honest PMISS
        meta = {'size': len(data), 'sha1': hashlib.sha1(data).hexdigest()}
        # memoryview slices of the one read: zmq ships each chunk frame
        # without another copy
        view = memoryview(data)
        chunks = [view[i:i + _CHUNK_BYTES] for i in range(0, len(data), _CHUNK_BYTES)]
        return [proto.MSG_PEER_ENTRY, digest_frame, proto.dump_json_params(meta)] + chunks

    # -- observability and lifecycle -----------------------------------------

    def health_snapshot(self):
        with self._lock:
            entries = len(self._entries)
            nbytes = sum(size for size, _ in self._entries.values())
        return {'endpoint': self.endpoint, 'cache_dir': self.cache_dir, 'entries': entries,
                'bytes': nbytes, 'served': self.served,
                'evicted_on_hint': self.evicted_on_hint}

    def close(self):
        self._closed.set()
        from petastorm_tpu_torch import materialized_cache
        materialized_cache.remove_publish_listener(self._note_published)
        self._thread.join(2.0)
        try:
            self._sock.close(0)
            self._context.term()
        except Exception:  # noqa: BLE001 - best-effort shutdown
            count_swallowed('peer-serve-close')


_SERVER = None
_SERVER_LOCK = threading.Lock()


def get_server(cache_dir, host=None):
    """The process-wide peer serve socket over ``cache_dir``, started on
    first use (restarted when a job reroots to another directory)."""
    global _SERVER
    with _SERVER_LOCK:
        if _SERVER is not None and _SERVER.cache_dir != cache_dir:
            _SERVER.close()
            _SERVER = None
        if _SERVER is None:
            _SERVER = PeerCacheServer(cache_dir, host=host)
        return _SERVER


def server_snapshot():
    """The live server's health view, or None when none is running."""
    server = _SERVER
    return server.health_snapshot() if server is not None else None


def close_server():
    """Shut the process-wide serve socket down (worker-server exit)."""
    global _SERVER
    with _SERVER_LOCK:
        if _SERVER is not None:
            _SERVER.close()
            _SERVER = None


# -- worker side: the fetch path ---------------------------------------------


class PeerCacheClient:
    """The miss-path fetcher a job's
    :class:`~petastorm_tpu_torch.materialized_cache.MaterializedRowGroupCache`
    calls before paying a decode. It owns its own DEALER sockets (the
    worker's network loop owns the dispatcher socket, and the fetch runs on
    the executor thread). Every failure degrades to the local decode,
    counted by reason."""

    def __init__(self, dispatcher_endpoint, self_endpoint=None):
        self._dispatcher_endpoint = dispatcher_endpoint
        self._self_endpoint = self_endpoint
        self._timeout_s = knobs.get_float('PETASTORM_TPU_PEER_CACHE_TIMEOUT_S', 2.0, floor=0.05)
        budget_mb = knobs.get_int('PETASTORM_TPU_PEER_CACHE_BUDGET_MB', 64, floor=1)
        # the readahead plane's all-or-nothing arena: an oversized fetch
        # degrades to a decode instead of buffering without bound
        from petastorm_tpu_torch.readahead import _BufferPool
        self._pool = _BufferPool(budget_mb << 20)
        self._lock = threading.Lock()
        self._mirror = {}    # digest -> [[endpoint, size], ...]
        self._negative = {}  # digest -> monotonic expiry of "nobody has it"
        self._context = None
        self._dir_sock = None
        self._acquired_now = 0
        self.hits = 0
        self.misses = 0

    # -- directory mirror ----------------------------------------------------

    def update_directory(self, mapping):
        """Fold a directory fragment (WORK piggyback or DIR reply) into the
        local mirror. Called from the worker's network loop."""
        if not isinstance(mapping, dict):
            return
        with self._lock:
            for digest, holders in mapping.items():
                if not isinstance(holders, list):
                    continue
                if holders:
                    self._mirror[digest] = holders
                    self._negative.pop(digest, None)
                else:
                    self._mirror.pop(digest, None)
            while len(self._mirror) > _MIRROR_CAP:
                self._mirror.pop(next(iter(self._mirror)))

    def _resolve(self, digest):
        now = time.monotonic()
        with self._lock:
            holders = self._mirror.get(digest)
            if holders:
                return holders
            if self._negative.get(digest, 0.0) > now:
                return None
        holders = self._dir_lookup(digest)
        if not holders:
            with self._lock:
                if len(self._negative) > 4096:
                    self._negative = {d: t for d, t in self._negative.items() if t > now}
                self._negative[digest] = now + _NEGATIVE_TTL_S
            return None
        return holders

    def _dir_lookup(self, digest):
        """One on-demand DIRGET round-trip on the client's own DEALER."""
        try:
            sock = self._dir_socket()
            sock.send_multipart([proto.MSG_DIR_GET, json.dumps([digest]).encode()])
            deadline = time.monotonic() + self._timeout_s
            while True:
                remaining_ms = int((deadline - time.monotonic()) * 1000)
                if remaining_ms <= 0 or not sock.poll(remaining_ms):
                    self._reset_dir_socket()
                    return None
                frames = sock.recv_multipart()
                if not frames or frames[0] != proto.MSG_DIR:
                    continue  # a foreign frame on our private socket
                mapping = proto.load_json_params(frames[1] if len(frames) > 1 else b'')
                self.update_directory(mapping)
                if digest in mapping:
                    holders = mapping[digest]
                    return holders if holders else None
                # a late reply to an earlier timed-out lookup: folded into
                # the mirror above; keep draining for ours
        except Exception:  # noqa: BLE001 - the directory is advisory
            count_swallowed('peer-dir-lookup')
            self._reset_dir_socket()
            return None

    def _dir_socket(self):
        import zmq
        with self._lock:
            if self._context is None:
                self._context = zmq.Context()
            if self._dir_sock is None:
                sock = self._context.socket(zmq.DEALER)
                sock.setsockopt(zmq.LINGER, 0)
                sock.connect(self._dispatcher_endpoint)
                self._dir_sock = sock
            return self._dir_sock

    def _reset_dir_socket(self):
        # a timed-out lookup may leave a late reply in flight: a fresh socket
        # next time beats matching stale replies forever
        with self._lock:
            if self._dir_sock is not None:
                try:
                    self._dir_sock.close(0)
                except Exception:  # noqa: BLE001 - already dead
                    pass
                self._dir_sock = None

    def _forget(self, digest, endpoint):
        with self._lock:
            holders = self._mirror.get(digest)
            if not holders:
                return
            holders = [h for h in holders if not h or h[0] != endpoint]
            if holders:
                self._mirror[digest] = holders
            else:
                self._mirror.pop(digest, None)

    # -- the fetch -----------------------------------------------------------

    def fetch(self, key, entry, cache):
        """Fetch the finished entry for ``key`` from a peer, publish it into
        ``cache``'s disk tier and return ``(columns, length)``, or None after
        any failure (counted by reason; the caller then decodes)."""
        digest = entry_digest(entry)
        if digest is None:
            return None
        holders = [h for h in (self._resolve(digest) or ())
                   if isinstance(h, (list, tuple)) and len(h) >= 2
                   and h[0] != self._self_endpoint]
        if not holders:
            return self._miss('no_holder')
        endpoint, advertised_size = str(holders[0][0]), int(holders[0][1])
        acquired = max(advertised_size, 1)
        if not self._pool.acquire(acquired):
            return self._miss('budget')
        self._acquired_now = acquired
        try:
            with span('peer_fetch'):
                # The fetched entry's mmap'd views transfer to the caller
                # exactly like a local cache hit: the published disk
                # entry owns the memory.  # pipesan: owns
                return self._fetch_from(endpoint, digest, entry, cache, acquired)
        except faults.FaultInjected:
            return self._miss('injected')
        except Exception:  # noqa: BLE001 - degrade to the local decode
            logger.debug('peer fetch of %s from %s failed', digest, endpoint, exc_info=True)
            count_swallowed('peer-fetch')
            return self._miss('error')
        finally:
            self._pool.free(self._acquired_now)

    def _fetch_from(self, endpoint, digest, entry, cache, acquired):
        self._acquired_now = acquired
        if faults.ARMED and faults.fault_hit('zmq.peer_fetch', key=digest) == 'drop':
            return self._miss('injected')
        frames = self._request(endpoint, digest)
        if frames is None:
            self._forget(digest, endpoint)
            return self._miss('timeout')
        if frames and frames[0] == proto.MSG_PEER_MISS:
            self._forget(digest, endpoint)
            return self._miss('peer_miss')
        if len(frames) < 3 or frames[0] != proto.MSG_PEER_ENTRY:
            return self._miss('protocol')
        meta = proto.load_json_params(frames[2])
        chunks = frames[3:]
        got = sum(len(c) for c in chunks)
        if got != int(meta.get('size', -1)):
            return self._miss('corrupt')
        if got > acquired:
            # the advert under-sold the entry (re-written since): the arena
            # stays authoritative, grow or degrade
            if not self._pool.acquire(got - acquired):
                return self._miss('budget')
            self._acquired_now = got
        sha = hashlib.sha1()
        for chunk in chunks:
            sha.update(chunk)
        if meta.get('sha1') and sha.hexdigest() != meta['sha1']:
            return self._miss('corrupt')

        def write(tmp):
            with open(tmp, 'wb') as f:
                for chunk in chunks:
                    f.write(chunk)

        cache.publish_fetched(entry, write)
        from petastorm_tpu_torch.materialized_cache import read_entry
        try:
            columns, length, _, _ = read_entry(entry)
        except Exception:  # noqa: BLE001 - the holder's entry itself is corrupt
            cache._remove_entry(entry)
            return self._miss('corrupt')
        registry = get_registry()
        registry.counter(PEER_CACHE_HITS).inc()
        registry.counter(PEER_CACHE_BYTES).inc(got)
        self.hits += 1
        # read_entry's views are backed by the just-published disk entry
        # (mmap'd, the same contract as a cache hit).  # pipesan: owns
        return columns, length

    def _request(self, endpoint, digest):
        """One fetch round-trip on a fresh DEALER. None on timeout."""
        import zmq
        with self._lock:
            if self._context is None:
                self._context = zmq.Context()
            context = self._context
        sock = context.socket(zmq.DEALER)
        try:
            sock.setsockopt(zmq.LINGER, 0)
            sock.connect(endpoint)
            sock.send_multipart([proto.MSG_PEER_FETCH, digest.encode()])
            if not sock.poll(int(self._timeout_s * 1000)):
                return None
            return sock.recv_multipart()
        finally:
            sock.close(0)

    def _miss(self, reason):
        self.misses += 1
        get_registry().counter(PEER_CACHE_MISSES, reason=reason).inc()
        return None

    def stats(self):
        return {'hits': self.hits, 'misses': self.misses, 'mirror': len(self._mirror),
                'budget_bytes': self._pool.budget, 'budget_used': self._pool.used}

    def close(self):
        self._reset_dir_socket()
        with self._lock:
            if self._context is not None:
                try:
                    self._context.term()
                except Exception:  # noqa: BLE001 - already dead
                    pass
                self._context = None


# -- dispatcher side: the fleet directory ------------------------------------


class FleetCacheDirectory:
    """The dispatcher's fold of every worker's adverts: entry digest →
    holder identities (endpoint, size, last touch). Single-threaded with
    the dispatcher loop; every public mutation swallows its own failures
    — the directory is advisory, a stale or lost row costs a wire fetch
    or a redundant decode, never correctness."""

    def __init__(self):
        self._holders = {}        # digest -> {identity: [ep, size, atime]}
        self._digests_of = {}     # identity -> set(digests)
        self._version = 0
        self._log = []            # (version, digest) ring for piggybacks
        self._pending_hints = {}  # identity -> set(digests)
        self._seed_until = 0.0
        self.hints_queued = 0

    # -- folding adverts -----------------------------------------------------

    def note_advert(self, identity, info):
        """Fold one advert dict (REGISTER ``full`` or heartbeat delta)."""
        try:
            self._note_advert(identity, info)
        except Exception:  # noqa: BLE001 - adverts are advisory
            count_swallowed('peer-directory-advert')

    def _note_advert(self, identity, info):
        if not isinstance(info, dict):
            return
        endpoint = info.get('ep')
        if not isinstance(endpoint, str) or not endpoint:
            return
        # a live advert for this endpoint supersedes its failover seed
        self.drop(_SEED_PREFIX + endpoint.encode())
        if 'full' in info:
            self.drop(identity)
            for item in info.get('full') or ():
                self._add(identity, endpoint, item)
            return
        for item in info.get('add') or ():
            self._add(identity, endpoint, item)
        for digest in info.get('rm') or ():
            self._remove(identity, digest)
        for pair in info.get('t') or ():
            self._touch(identity, pair)

    def _add(self, identity, endpoint, item):
        digest = item[0]
        if not isinstance(digest, str) or not _DIGEST_RE.fullmatch(digest):
            return
        self._holders.setdefault(digest, {})[identity] = [
            endpoint, int(item[1]), float(item[2])]
        self._digests_of.setdefault(identity, set()).add(digest)
        self._version += 1
        self._log.append((self._version, digest))
        del self._log[:-_DIR_LOG_CAP]

    def _remove(self, identity, digest):
        holders = self._holders.get(digest)
        if holders is not None:
            holders.pop(identity, None)
            if not holders:
                self._holders.pop(digest, None)
        digests = self._digests_of.get(identity)
        if digests is not None:
            digests.discard(digest)

    def _touch(self, identity, pair):
        digest, atime = pair[0], float(pair[1])
        info = (self._holders.get(digest) or {}).get(identity)
        if info is not None:
            info[2] = atime

    def drop(self, identity):
        """Prune every row of a deregistered worker."""
        for digest in self._digests_of.pop(identity, ()):
            holders = self._holders.get(digest)
            if holders is not None:
                holders.pop(identity, None)
                if not holders:
                    self._holders.pop(digest, None)
        self._pending_hints.pop(identity, None)

    # -- serving lookups -----------------------------------------------------

    def lookup(self, digests, exclude_identity=None):
        """``{digest: [[endpoint, size], ...]}`` (freshest holder first;
        an unknown digest maps to ``[]`` so the asker can negative-cache
        it)."""
        out = {}
        for digest in digests:
            if not isinstance(digest, str):
                continue
            rows = [info for identity, info in
                    (self._holders.get(digest) or {}).items()
                    if identity != exclude_identity]
            rows.sort(key=lambda info: -info[2])
            out[digest] = [[info[0], info[1]] for info in rows]
        return out

    def delta_since(self, since_version, exclude_identity=None):
        """``(new_version, mapping-or-None)`` of digests advertised after
        ``since_version`` — the WORK-frame piggyback, capped; anything
        beyond the window is served by DIRGET on demand."""
        if since_version >= self._version:
            return self._version, None
        seen = set()
        digests = []
        for version, digest in reversed(self._log):
            if version <= since_version:
                break
            if digest in seen:
                continue
            seen.add(digest)
            digests.append(digest)
            if len(digests) >= _WORK_PIGGYBACK_CAP:
                break
        mapping = {d: rows for d, rows in
                   self.lookup(digests, exclude_identity).items() if rows}
        return self._version, (mapping or None)

    # -- global eviction -----------------------------------------------------

    def compute_evict_hints(self, now_epoch):
        """Fleet-global LRU pressure: an entry held by more than one
        worker whose FLEET-WIDE freshest touch is older than the cold
        threshold gets hinted away on every holder except the freshest
        — K copies of cold data shrink toward one while hot single-copy
        entries are never touched. Hints queue per worker (bounded) and
        ride the next heartbeat ACK; the holder re-checks its own atime,
        so this stays advisory."""
        cold_s = knobs.get_float('PETASTORM_TPU_PEER_CACHE_COLD_S', 300.0,
                                 floor=0.0)
        if cold_s <= 0:
            return
        for digest, holders in self._holders.items():
            if len(holders) < 2:
                continue
            freshest = max(holders.values(), key=lambda info: info[2])
            if now_epoch - freshest[2] < cold_s:
                continue
            for identity, info in holders.items():
                if info is freshest or identity.startswith(_SEED_PREFIX):
                    continue
                pending = self._pending_hints.setdefault(identity, set())
                if digest not in pending \
                        and len(pending) < _PENDING_HINTS_CAP:
                    pending.add(digest)
                    self.hints_queued += 1

    def take_hints(self, identity):
        """Up to :data:`_HINTS_PER_ACK_CAP` queued hints for one worker's
        heartbeat ACK (the rest stay queued), or None."""
        pending = self._pending_hints.pop(identity, None)
        if not pending:
            return None
        hints = sorted(pending)[:_HINTS_PER_ACK_CAP]
        leftover = pending.difference(hints)
        if leftover:
            self._pending_hints[identity] = leftover
        return hints

    # -- failover ------------------------------------------------------------

    def snapshot(self):
        """Replication view for the standby: the digest → holder map
        keyed by ENDPOINT (identities die with the primary; the serve
        sockets — and their entries — survive it)."""
        out = []
        for digest, holders in self._holders.items():
            out.append([digest, [list(info) for info in holders.values()]])
            if len(out) >= _SNAPSHOT_CAP:
                break
        return out

    def seed(self, snapshot, now_mono):
        """Adopt a failed-over primary's directory under synthetic
        per-endpoint holder identities: DIRGET answers stay warm through
        the failover window. A worker's first real advert for an
        endpoint supersedes its seed; unclaimed seeds age out
        (:data:`_SEED_TTL_S`) via :meth:`expire_seeds`."""
        try:
            for digest, holders in snapshot:
                for info in holders:
                    endpoint = str(info[0])
                    self._add(_SEED_PREFIX + endpoint.encode(), endpoint,
                              [digest, info[1], info[2]])
            self._seed_until = now_mono + _SEED_TTL_S
        except Exception:  # noqa: BLE001 - replication is advisory
            count_swallowed('peer-directory-seed')

    def expire_seeds(self, now_mono):
        if not self._seed_until or now_mono < self._seed_until:
            return
        self._seed_until = 0.0
        for identity in [i for i in self._digests_of
                         if i.startswith(_SEED_PREFIX)]:
            self.drop(identity)

    # -- observability -------------------------------------------------------

    def held_count(self, identity):
        """How many entries one worker advertises (fleet-view row)."""
        return len(self._digests_of.get(identity, ()))

    def stats(self):
        try:
            return {
                'digests': len(self._holders),
                'holders': sum(len(h) for h in self._holders.values()),
                'pending_hints': sum(len(p) for p in
                                     self._pending_hints.values()),
                'hints_queued': self.hints_queued,
                'seeded': any(i.startswith(_SEED_PREFIX)
                              for i in self._digests_of),
            }
        except Exception:  # noqa: BLE001 - racing the dispatcher loop
            return {'digests': -1}
