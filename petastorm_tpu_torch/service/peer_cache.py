"""The fleet-wide decoded-cache tier's directory half (counterpart of
``petastorm_tpu/service/peer_cache.py``): the counter names, the entry
digests, and :class:`FleetCacheDirectory`, the dispatcher's fold of every
worker's adverts (digest → holders), which it answers on ``DIRGET``,
piggybacks on WORK frames, replicates into the standby snapshot and turns
into advisory evict-hints on heartbeat ACKs.

The holders' half, ``PeerCacheServer`` and ``PeerCacheClient`` (serving and
fetching finished Arrow IPC entries between worker servers), is not ported
yet: where the reference would start it, :func:`refuse_peer_cache_tier`
raises ``NotImplementedError`` (ROADMAP.md, Queue 1 item 9).
``PETASTORM_TPU_PEER_CACHE=0`` turns the tier off and is the reference's own
host-local oracle.
"""

import os
import re

from petastorm_tpu_torch.errors import unported
from petastorm_tpu_torch.telemetry import count_swallowed, knobs

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

# dispatcher-side bounds
_DIR_LOG_CAP = 512          # recent-digest log feeding WORK piggybacks
_WORK_PIGGYBACK_CAP = 32    # digests per WORK trailing frame
_HINTS_PER_ACK_CAP = 16     # evict-hints per heartbeat ACK
_PENDING_HINTS_CAP = 64     # queued hints per worker
_SNAPSHOT_CAP = 4096        # digests replicated to the standby
_SEED_TTL_S = 60.0          # failover-seeded entries age out unclaimed
_SEED_PREFIX = b'@seed/'    # synthetic holder identity for seeded rows


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


def refuse_peer_cache_tier(worker_args=None):
    """Raise the ``unported`` error where the reference's worker server
    starts the tier's holder side: the tier on and a host-local
    ``PETASTORM_TPU_DECODED_CACHE_DIR`` set, or a job whose workers decode
    into a healthy materialized cache. The service pool calls it in the
    consumer, before a spawned fleet would die of it out of sight."""
    if not peer_cache_enabled():
        return
    cache = materialized_cache_of(worker_args)
    if knobs.get_str('PETASTORM_TPU_DECODED_CACHE_DIR') or (
            cache is not None and not cache.degraded):
        raise unported('the fleet cache tier (PETASTORM_TPU_PEER_CACHE)', 9)


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
