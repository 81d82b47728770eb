"""Dispatcher: the decode service's item scheduler, job registry and
liveness tracker (counterpart of ``petastorm_tpu/service/dispatcher.py``).

Runs as a single thread that owns the ROUTER socket (ZMQ sockets are not
thread-safe; every socket operation happens here). Other threads interact
through three thread-safe surfaces only: :meth:`Dispatcher.submit` (the
ventilator hands in work items), the per-job ``deliver`` callback (results
flow out to the :class:`~petastorm_tpu_torch.service.service_pool.ServicePool`'s
bounded queue), and :meth:`Dispatcher.stats`.

The dispatcher is multi-job: a job registry maps job ids to their spec
payload, their result destination and their slice of the worker fleet.

* The **local job** (id 0) is the embedded :class:`ServicePool` case: spec
  fixed at construction, results delivered through a callback into the
  consumer's bounded queue.
* **Client jobs** register over the wire (REGISTER_JOB). Results travel back
  as RESULT frames keyed by the client's own item ids, delivery is gated by
  a per-job credit (the client's queue capacity), and a lease reclaims
  everything when a client dies without a goodbye.

Worker servers are partitioned across jobs: each is bound to one job at
registration (the job spec IS the worker build), least-loaded first, and
the sweep rebalances by STOPping one idle worker of an over-served job per
interval. Each live, READY worker holds at most ``max_inflight_per_worker``
assigned items.

Exactly once:

* every ventilated item gets a monotonically increasing id, and ownership
  (``item id -> worker identity``) is recorded at assignment;
* a worker whose heartbeat lapses past ``liveness_timeout_s`` is
  deregistered and its in-flight items go back to the front of its job's
  pending queue (re-ventilation);
* completions of re-ventilated items are deduplicated by item id, and worker
  servers send an item's results in a single DONE, so a worker killed
  mid-item has delivered nothing for it.

Failure domains:

* **Retry budgets**: every failed attempt of an item (an ERROR, or a
  heartbeat-lapse re-ventilation) counts against
  ``PETASTORM_TPU_SERVICE_MAX_RETRIES`` total attempts; failed items re-enter
  the queue after an exponential, deterministically jittered backoff.
* **Suspect isolation**: an item with a failed attempt behind it is only
  ever assigned alone to an idle worker.
* **Quarantine**: an item that exhausts its budget is skipped with a
  ``('poisoned', info)`` delivery (the pool applies ``poison_policy``),
  recorded on :meth:`Dispatcher.health`, counted and announced as a
  ``row_group_poisoned`` anomaly.
* **Incarnation token**: SPEC replies and heartbeat ACKs carry this
  dispatcher's random token, so a worker that sees another knows its
  dispatcher was replaced and re-registers.
* **Job leases** and **drain**: a silent client job is garbage-collected
  (``job_lease_expired`` anomaly); :meth:`Dispatcher.begin_drain` and a full
  registry (``PETASTORM_TPU_SERVICE_MAX_JOBS``) answer REGISTER_JOB with a
  retryable BUSY.
"""

import collections
import heapq
import logging
import threading
import time
import uuid

from petastorm_tpu_torch import faults
from petastorm_tpu_torch.service import protocol as proto
from petastorm_tpu_torch.service.peer_cache import (
    PEER_CACHE_EVICT_HINTS, FleetCacheDirectory,
)
from petastorm_tpu_torch.telemetry import (
    count_swallowed, get_registry, knobs, merge_worker_delta,
    metrics_disabled, note_producer_wait, tracing,
)
from petastorm_tpu_torch.telemetry.timeseries import record_anomaly

logger = logging.getLogger(__name__)

_POLL_INTERVAL_MS = 50
_STOP_BROADCASTS = 3

#: how often the sweep recomputes fleet-global eviction hints from the
#: peer-cache directory (hint queues drain on heartbeat ACKs between
#: recomputes; coarser than the cold threshold is all that's needed)
_PEER_HINT_INTERVAL_S = 5.0

#: digests answered per DIRGET request (the asker re-asks for the rest;
#: in practice it asks for one digest per fetch)
_DIRGET_CAP = 64

#: liveness floor for workers WAITING for a job (job_id None): their
#: only liveness signal is the REGISTER re-send, whose worker-side
#: backoff caps at 2s — a tight heartbeat-tuned window would lapse and
#: re-admit every healthy idle worker in a pointless churn loop. They
#: hold no in-flight work, so the slow detection costs nothing.
_UNBOUND_LIVENESS_FLOOR_S = 5.0

#: quarantined-item descriptors retained for /health (count is unbounded,
#: the descriptor list is not — an operator needs the recent offenders,
#: not an ever-growing ledger in a long-lived daemon)
_POISONED_KEEP = 100

#: the embedded (callback-delivery) job's fixed id; client jobs count up
#: from 1
LOCAL_JOB_ID = 0

# Fleet-health metric names (docs/telemetry.md): the dispatcher runs in
# the CONSUMER process (or the standing daemon), so these land straight
# in its process-wide registry and surface through pipeline_report()'s
# `service` section — re-ventilation/dedupe activity visible without
# reading dispatcher logs.
SERVICE_REVENTILATED = 'petastorm_tpu_service_reventilated_total'
SERVICE_DUPLICATE_DONE = 'petastorm_tpu_service_duplicate_done_total'
SERVICE_WORKERS_ALIVE = 'petastorm_tpu_service_workers_alive'
SERVICE_WORKERS_REGISTERED = 'petastorm_tpu_service_workers_registered'
SERVICE_ITEMS_PENDING = 'petastorm_tpu_service_items_pending'
SERVICE_ITEMS_ASSIGNED = 'petastorm_tpu_service_items_assigned'
SERVICE_RETRIES = 'petastorm_tpu_service_retries_total'
SERVICE_POISONED = 'petastorm_tpu_service_items_poisoned_total'
SERVICE_JOBS = 'petastorm_tpu_service_jobs_active'
# cache-aware placement + QoS (docs/service.md, "High availability"):
# a placement hit is a job bound to a worker already advertising the
# job's decode fingerprint (its host holds the warm cache); a
# preemption is a worker cordoned away from a lower-priority job for a
# higher-priority one at row-group granularity
SERVICE_PLACEMENT_HITS = 'petastorm_tpu_service_placement_hits_total'
SERVICE_PLACEMENT_MISSES = 'petastorm_tpu_service_placement_misses_total'
SERVICE_PREEMPTIONS = 'petastorm_tpu_service_preemptions_total'


class _WorkerState:
    __slots__ = ('identity', 'last_heartbeat', 'ready', 'inflight',
                 'job_id', 'cordoned', 'pid', 'cache_fps', 'preempted_to',
                 'peer_dir_seen')

    def __init__(self, identity, now):
        self.identity = identity
        self.last_heartbeat = now
        self.ready = False
        self.inflight = set()
        #: the job this worker was built for (its SPEC); None while the
        #: worker awaits a job to exist
        self.job_id = None
        #: True once the supervisor marked this worker for release: no
        #: new assignments, terminated once idle
        self.cordoned = False
        #: learned from the REGISTER pid frame (new-build workers) or
        #: the heartbeat summaries; None on old builds until the first
        #: summary arrives
        self.pid = None
        #: decode fingerprints the worker's host advertises (REGISTER
        #: advert frame / heartbeat summaries) — the dispatcher's slice
        #: of the fleet cache directory (docs/service.md)
        self.cache_fps = set()
        #: job id a pending preemption is cordoning this worker toward:
        #: no new assignments, STOPped once its in-flight drains (never
        #: mid-item), then re-bound by priority. Distinct from
        #: ``cordoned``, which is the supervisor's TERMINATE path.
        self.preempted_to = None
        #: peer-cache directory version last piggybacked to this worker
        #: on a WORK frame (fleet cache tier, docs/service.md)
        self.peer_dir_seen = 0


class _Job:
    """One registry entry: where a job's items come from and where its
    results go. ``deliver`` set = the local (embedded-pool) job;
    ``client`` set = a remote client job speaking RESULT frames."""

    __slots__ = ('job_id', 'name', 'spec_payload', 'deliver', 'client',
                 'client_key', 'lease_s', 'last_client_seen', 'credit',
                 'markers_sent', 'markers_acked', 'pending', 'pending_ids',
                 'client_item_ids', 'live_cids', 'out', 'workers',
                 'submitted', 'completed', 'created_at', 'weight',
                 'priority', 'fingerprint')

    def __init__(self, job_id, spec_payload, deliver=None, client=None,
                 client_key=None, lease_s=None, credit=None, name=None,
                 weight=None, priority=None, fingerprint=None):
        self.job_id = job_id
        self.name = name or 'job-%d' % job_id
        self.spec_payload = spec_payload
        self.deliver = deliver
        self.client = client
        self.client_key = client_key
        self.lease_s = lease_s
        self.last_client_seen = time.monotonic()
        self.credit = credit
        # QoS (docs/service.md, "High availability"): weight scales the
        # job's fair share of the worker fleet (weight 3 ≈ 3× the
        # workers of a weight-1 co-tenant); priority is strict admission
        # — a higher tier with pending work takes workers from lower
        # tiers (preemption), never the reverse. Defaults reproduce the
        # pre-QoS equal-share scheduler exactly.
        self.weight = max(float(weight), 1e-6) if weight else 1.0
        self.priority = int(priority) if priority else 0
        #: decode fingerprint for cache-aware placement; None opts out
        self.fingerprint = fingerprint or None
        # delivery-credit clock for client jobs: markers sent vs markers
        # the client reports consumed; the gap bounds everything buffered
        # between the two processes, so a stalled consumer quiesces ITS
        # job's slice of the fleet without touching co-tenants
        self.markers_sent = 0
        self.markers_acked = 0
        self.pending = collections.deque()    # (item_id, payload)
        self.pending_ids = set()
        self.client_item_ids = {}             # item_id -> client item id
        #: live client item ids — dedups a reconnected client's
        #: re-submission of items this job still holds (its marker was
        #: in flight when the client's socket reset)
        self.live_cids = set()
        # undelivered outbound entries: local = delivery tuples awaiting
        # queue space; client = RESULT frame lists awaiting socket space
        self.out = collections.deque()
        self.workers = set()                  # bound worker identities
        self.submitted = 0
        self.completed = 0
        self.created_at = time.time()

    @property
    def is_local(self):
        return self.deliver is not None

    def gated(self):
        """True when assigning more of this job's items would only grow
        an unbounded buffer: the local consumer's queue is full
        (backlog), or a client job's delivery credit is spent."""
        if self.out:
            return True
        return (self.credit is not None
                and self.markers_sent - self.markers_acked >= self.credit)

    def descriptor(self):
        return {
            'job_id': self.job_id,
            'name': self.name,
            'local': self.is_local,
            'pending': len(self.pending),
            'workers': len(self.workers),
            'submitted': self.submitted,
            'completed': self.completed,
            'unacked': self.markers_sent - self.markers_acked,
            'credit': self.credit,
            'lease_s': self.lease_s,
            'out_backlog': len(self.out),
            'weight': self.weight,
            'priority': self.priority,
            'fingerprint': self.fingerprint,
        }


class _TraceEntry:
    """Lifecycle of one traced item at the dispatcher: how many times it
    was dispatched, and — once delivered while still dedup-risky — when,
    so the sweep can age the retained entry out."""

    __slots__ = ('ctx', 'attempts', 'completed_at')

    def __init__(self, ctx):
        self.ctx = ctx
        self.attempts = 0
        self.completed_at = None


class Dispatcher:
    """Single-threaded scheduler loop behind a :class:`ServicePool` or a
    standing daemon (the reference's ``ServiceDaemon``; not ported yet).

    :param endpoint: ``tcp://host:port`` to bind; port ``0`` binds a random
        free port (the resolved endpoint appears as :attr:`endpoint` once
        :meth:`wait_bound` returns).
    :param job_spec_payload: :func:`protocol.dump_job_spec` bytes replied to
        every REGISTER for the embedded local job; ``None`` for a standing
        daemon (jobs arrive over the wire instead).
    :param deliver: NON-BLOCKING callable ``(kind, payload) -> bool``
        pushing ``('result', bytes)`` / ``('error', exc)`` /
        ``('marker', None)`` entries to the consumer; returns False when
        the consumer queue is momentarily full (the entry is then kept in
        an internal backlog and retried) and True when accepted or the
        pool is stopping. It must never block: this thread also acks
        worker heartbeats, and a consumer pause (recompile, checkpoint
        save) must quiesce the fleet, not starve its liveness protocol.
        ``None`` for a standing daemon.
    :param stop_event: shared :class:`threading.Event`; setting it makes
        :meth:`run` broadcast STOP to all workers and exit.
    :param standing: True for a daemonized dispatcher: zero live workers
        with work outstanding is a supervisor condition to repair, not a
        fatal error, and client REGISTER_JOB frames are expected traffic.
    """

    def __init__(self, endpoint, job_spec_payload, deliver, stop_event,
                 heartbeat_interval_s=1.0, liveness_timeout_s=4.0,
                 max_inflight_per_worker=2, no_workers_timeout_s=30.0,
                 max_retries=None, retry_backoff_s=None, standing=False,
                 max_jobs=None, default_lease_s=None, seed_state=None):
        self._requested_endpoint = endpoint
        self._deliver = deliver
        self._stop_event = stop_event
        self._heartbeat_interval_s = heartbeat_interval_s
        self._liveness_timeout_s = liveness_timeout_s
        self._max_inflight_per_worker = max_inflight_per_worker
        self._no_workers_timeout_s = no_workers_timeout_s
        self._standing = standing
        # per-item retry budget (total attempts) + backoff base; knob
        # defaults so a standing fleet is governed without code changes
        self._max_retries = (max_retries if max_retries is not None
                             else knobs.get_int(
                                 'PETASTORM_TPU_SERVICE_MAX_RETRIES', 3,
                                 floor=1))
        self._retry_backoff_s = (retry_backoff_s
                                 if retry_backoff_s is not None
                                 else knobs.get_float(
                                     'PETASTORM_TPU_SERVICE_RETRY'
                                     '_BACKOFF_S', 0.05, floor=0.0))
        # job-registry governance (standing service): admission ceiling
        # and the default lease clients inherit when they name none
        self._max_jobs = (max_jobs if max_jobs is not None
                          else knobs.get_int(
                              'PETASTORM_TPU_SERVICE_MAX_JOBS', 16,
                              floor=1))
        self._default_lease_s = (default_lease_s
                                 if default_lease_s is not None
                                 else knobs.get_float(
                                     'PETASTORM_TPU_SERVICE_LEASE_S',
                                     30.0, floor=1.0))
        # cache-aware placement toggle: on by default, a kill switch for
        # fleets where fingerprint adverts misbehave
        self._placement_enabled = not knobs.is_disabled(
            'PETASTORM_TPU_SERVICE_PLACEMENT')
        # fleet cache tier (docs/service.md, "Fleet cache tier"): the
        # digest -> holders directory folded from worker adverts, plus
        # the advisory global-eviction machinery. On by default;
        # PETASTORM_TPU_PEER_CACHE=0 is the host-local oracle.
        self._peer_enabled = not knobs.is_disabled(
            'PETASTORM_TPU_PEER_CACHE')
        self._peer_dir = FleetCacheDirectory()
        self._peer_hint_at = 0.0
        self._peer_evict_hints_sent = 0
        #: this dispatcher incarnation's identity, riding every SPEC and
        #: HEARTBEAT_ACK: a worker that sees the token change knows its
        #: dispatcher was replaced and must re-register for the new job
        self.token = uuid.uuid4().hex[:16].encode()

        self.endpoint = None
        self._bound = threading.Event()
        self._lock = threading.Lock()
        # the job registry: LOCAL_JOB_ID (embedded callback delivery) +
        # wire-registered client jobs; _item_job maps every live item's
        # GLOBAL id to its job, which is what keeps N jobs' item spaces
        # collision-free over one worker wire protocol
        self._jobs = collections.OrderedDict()
        self._job_seq = LOCAL_JOB_ID
        self._item_job = {}
        self._draining = False
        if job_spec_payload is not None:
            self._jobs[LOCAL_JOB_ID] = _Job(LOCAL_JOB_ID, job_spec_payload,
                                            deliver=deliver, name='local')
        self._next_item_id = 0
        self._workers = {}                    # identity -> _WorkerState
        self._inflight = {}                   # item_id -> (identity, payload)
        # Completion dedup applies ONLY to items that were ever
        # re-ventilated (or reclaimed by a job GC): a single-assignment
        # item produces exactly one DONE (one WORK message -> one
        # completion), so keeping every finished id would leak memory
        # across an infinite-epoch stream for nothing. _risky_ids marks
        # re-ventilated items; _done records their completions. Both stay
        # bounded by failure churn, not stream length.
        self._risky_ids = set()
        self._done = set()
        # failure-domain state: failed-attempt counts (an item present
        # here is a SUSPECT and is assigned in isolation), the last
        # worker exception per suspect (delivered on quarantine so
        # poison_policy='raise' surfaces the real error), the backoff
        # heap of (ready_at, seq, item_id, payload), and the quarantine
        # ledger. All bounded by failure churn, never by stream length.
        self._attempts = {}
        self._last_error = {}
        # item_id -> identities EVER assigned that item by THIS
        # dispatcher incarnation. Completion acceptance is gated on it:
        # a ghost DONE from a lapsed prior owner is legitimate (the
        # exactly-once dedup handles it), but a STALE DONE from another
        # incarnation's worker — its socket flushing on reconnect after
        # a daemon restart, carrying an item id that COLLIDES with this
        # incarnation's id space — must be dropped, or it completes the
        # wrong item with the wrong rows (duplicate + loss). Entries
        # drop with their item (completion/quarantine/job GC).
        self._item_owners = {}
        self._retry = []
        self._retry_seq = 0
        self._poisoned = collections.OrderedDict()
        self._poisoned_count = 0
        self._retried_count = 0
        self._completed_count = 0
        self._reventilated_count = 0
        self._duplicate_done_count = 0
        self._workers_seen = 0
        self._jobs_seen = 1 if job_spec_payload is not None else 0
        self._jobs_expired = 0
        self._metrics_deltas_merged = 0
        # QoS / placement / HA accounting (docs/service.md, "High
        # availability"): binding placement hits/misses, preemptions,
        # and the replication pulls served to a warm standby
        self._placement_hits = 0
        self._placement_misses = 0
        self._preemptions = 0
        self._standby_syncs_served = 0
        self._last_standby_sync = None
        # identity -> latest heartbeat-piggybacked observability summary
        # (JSON dict); the per-worker breakdown of the fleet view. Kept
        # alongside _workers and pruned on deregister, so it is bounded
        # by fleet size.
        self._worker_obs = {}
        # identity -> job_id at deregistration time: a lapsed worker
        # resurfacing via heartbeat is still RUNNING the spec of the job
        # it lapsed from — re-binding it anywhere else would hand job
        # B's items to job A's decode worker. Bounded: lapse churn only.
        self._lapsed_bindings = collections.OrderedDict()
        self._fatal_error = None
        self._no_workers_since = None
        # the ROUTER socket, owned by the dispatcher thread; deep
        # delivery paths (quarantine inside a sweep) reach it here
        # instead of threading it through six call layers. Only the
        # dispatcher thread may touch it.
        self._sock = None
        # item_id -> _TraceEntry for traced items: the
        # work payload is opaque dill here, so the ServicePool registers
        # the context at submit time and the dispatcher stamps lifecycle
        # instants (dispatch/reventilate/done/duplicate_done) — which is
        # exactly what makes the exactly-once machinery OBSERVABLE: a
        # re-ventilated item's timeline shows every dispatch attempt and
        # its single deduped completion. Entries drop at completion; risky
        # ones are retained briefly for dedup marking and aged out by the
        # sweep, so the map stays bounded by in-flight work, never by
        # stream length or failure churn.
        self._trace_ctx = {}
        if seed_state:
            self._adopt_seed_state(seed_state)

    def _adopt_seed_state(self, state):
        """Adopt a promoted standby's replicated registry snapshot
        (:meth:`standby_snapshot` of the dead primary). Jobs come back
        with their identity (job id, client key), lease, credit and QoS
        params but with ``client=None`` and a zeroed credit window: the
        clients' re-registration (triggered by this incarnation's fresh
        token) re-binds them by key and re-submits every un-markered
        item, which is also why no in-flight items replicate — they
        re-ventilate from the client side. ``next_item_id`` seeds ABOVE
        the dead primary's watermark so late cross-incarnation frames
        can never collide with this incarnation's id space (they are
        dropped by the ``_item_owners`` gate regardless)."""
        try:
            for desc in state.get('jobs', ()):
                job = _Job(int(desc['job_id']), desc['spec_payload'],
                           client=None, client_key=desc.get('client_key'),
                           lease_s=desc.get('lease_s'),
                           credit=desc.get('credit'),
                           name=desc.get('name'),
                           weight=desc.get('weight'),
                           priority=desc.get('priority'),
                           fingerprint=desc.get('fingerprint'))
                self._jobs[job.job_id] = job
                self._jobs_seen += 1
            self._job_seq = max([self._job_seq,
                                 int(state.get('job_seq', 0))]
                                + [j.job_id for j in self._jobs.values()])
            self._next_item_id = max(self._next_item_id,
                                     int(state.get('next_item_id', 0)))
            # the replicated peer-cache directory: seeded under synthetic
            # per-endpoint identities so DIRGET stays warm through the
            # failover window (workers' re-REGISTER full adverts replace
            # the seeds; unclaimed seeds age out in the sweep)
            peer_snapshot = state.get('peer_directory')
            if peer_snapshot and self._peer_enabled:
                self._peer_dir.seed(peer_snapshot, time.monotonic())
        except Exception:  # noqa: BLE001 - degrade to a cold promote
            count_swallowed('dispatcher-seed-state')
            logger.warning('Unusable standby seed state; promoting cold '
                           '(clients re-register)', exc_info=True)

    def standby_snapshot(self):
        """The replication snapshot a warm standby pulls (SSYNC): client
        job identities and QoS/lease/credit params plus the id
        watermarks. Deliberately NOT replicated: in-flight items and
        delivery buffers (they re-ventilate via client re-submission),
        the worker roster beyond its cache adverts (workers re-register
        with the new incarnation within a heartbeat), and the local
        embedded job (it dies with its process)."""
        with self._lock:
            jobs = [{
                'job_id': job.job_id,
                'name': job.name,
                'spec_payload': job.spec_payload,
                'client_key': job.client_key,
                'lease_s': job.lease_s,
                'credit': job.credit,
                'weight': job.weight,
                'priority': job.priority,
                'fingerprint': job.fingerprint,
            } for job in self._jobs.values() if not job.is_local]
            next_item_id = self._next_item_id
        fleet_fps = set()
        for worker in list(self._workers.values()):
            fleet_fps.update(worker.cache_fps)
        return {'next_item_id': next_item_id,
                'job_seq': self._job_seq,
                'jobs': jobs,
                'fleet_cache_fps': sorted(fleet_fps),
                'peer_directory': self._peer_dir.snapshot()}

    # -- thread-safe surface (called from pool / ventilator threads) ---------

    def submit(self, payload, trace_ctx=None, job_id=LOCAL_JOB_ID,
               client_item_id=None):
        """Enqueue one dill-framed work item for ``job_id``; returns its
        GLOBAL item id (unique across every job this dispatcher ever
        scheduled). ``trace_ctx`` (when the item is traced) keys the
        dispatcher's lifecycle instants to the trace minted at
        ventilation; ``client_item_id`` is the wire id RESULT frames echo
        back to a client job."""
        with self._lock:
            job = self._jobs[job_id]
            item_id = self._next_item_id
            self._next_item_id += 1
            job.pending.append((item_id, payload))
            job.pending_ids.add(item_id)
            job.submitted += 1
            self._item_job[item_id] = job_id
            if client_item_id is not None:
                job.client_item_ids[item_id] = client_item_id
                job.live_cids.add(client_item_id)
            if trace_ctx is not None:
                self._trace_ctx[item_id] = _TraceEntry(trace_ctx)
            return item_id

    def wait_bound(self, timeout):
        """Block until the ROUTER socket is bound (or binding failed)."""
        if not self._bound.wait(timeout):
            raise RuntimeError('Dispatcher did not bind %r within %.1fs'
                               % (self._requested_endpoint, timeout))
        if self._fatal_error is not None:
            raise self._fatal_error

    @property
    def fatal_error(self):
        return self._fatal_error

    @property
    def draining(self):
        return self._draining

    def begin_drain(self):
        """Enter drain mode (the daemon's SIGTERM path): every later
        REGISTER_JOB answers a retryable BUSY; already-registered jobs
        keep running until they finish or their lease lapses."""
        self._draining = True
        logger.warning('Dispatcher draining: new jobs refused (BUSY), '
                       '%d job(s) finishing', len(self._jobs))

    def registered_workers(self):
        return len(self._workers)

    def active_jobs(self):
        """Live registry size (local + client jobs)."""
        return len(self._jobs)

    def _pending_total_locked(self):
        return sum(len(j.pending) for j in self._jobs.values())

    def stats(self):
        with self._lock:
            pending = self._pending_total_locked()
        # list() snapshots the dict at C level (atomic under the GIL):
        # the dispatcher thread may register/deregister workers while a
        # consumer thread polls diagnostics.
        workers = list(self._workers.values())
        live = sum(1 for w in workers
                   if time.monotonic() - w.last_heartbeat
                   <= self._liveness_timeout_s)
        return {
            'workers_alive': live,
            'workers_registered': len(self._workers),
            'workers_seen': self._workers_seen,
            'items_assigned': len(self._inflight),
            'items_pending': pending + len(self._retry),
            'items_reventilated': self._reventilated_count,
            'items_duplicate_done': self._duplicate_done_count,
            'items_retried': self._retried_count,
            'items_poisoned': self._poisoned_count,
            'metrics_deltas_merged': self._metrics_deltas_merged,
            'jobs_active': len(self._jobs),
            'jobs_seen': self._jobs_seen,
            'jobs_expired': self._jobs_expired,
        }

    def health(self):
        """The dispatcher's /health contribution: fleet liveness plus
        the back-pressure state an operator needs first — ``quiesced``
        means completions are backlogged behind a full consumer queue
        (or a client job's spent delivery credit), so the fleet is
        idling by design, not broken — plus the job registry (per-job
        pending/credit/lease state) and the quarantine ledger: every
        recently-poisoned item with its attempt count and last failure,
        so "which row-group is killing my workers" is a /health read,
        not a log dig."""
        stats = self.stats()
        jobs = list(self._jobs.values())
        stats['quiesced'] = any(job.gated() for job in jobs)
        stats['out_backlog'] = sum(len(job.out) for job in jobs)
        stats['endpoint'] = self.endpoint
        stats['items_completed'] = self._completed_count
        stats['max_retries'] = self._max_retries
        stats['draining'] = self._draining
        stats['max_jobs'] = self._max_jobs
        stats['jobs'] = [job.descriptor() for job in jobs]
        stats['poisoned'] = list(self._poisoned.values())
        # QoS / placement / HA surface (docs/service.md, "High
        # availability"): per-job delivery shares (worker fraction,
        # weight-normalized target), placement hit/miss counters, and
        # how recently a warm standby pulled a replication snapshot
        bound = sum(len(job.workers) for job in jobs) or 1
        weight_total = sum(job.weight for job in jobs) or 1.0
        stats['qos'] = [{
            'job_id': job.job_id, 'name': job.name,
            'weight': job.weight, 'priority': job.priority,
            'worker_share': round(len(job.workers) / bound, 4),
            'target_share': round(job.weight / weight_total, 4),
        } for job in jobs]
        stats['placement_enabled'] = self._placement_enabled
        stats['placement_hits'] = self._placement_hits
        stats['placement_misses'] = self._placement_misses
        stats['preemptions'] = self._preemptions
        stats['standby_syncs_served'] = self._standby_syncs_served
        stats['last_standby_sync_age_s'] = (
            round(time.monotonic() - self._last_standby_sync, 3)
            if self._last_standby_sync is not None else None)
        # fleet cache-tier directory view (docs/service.md, "Fleet cache
        # tier"): how many entries the fleet advertises, by how many
        # holders, and the advisory eviction-hint flow
        peer = dict(self._peer_dir.stats())
        peer['enabled'] = self._peer_enabled
        peer['hints_sent'] = self._peer_evict_hints_sent
        stats['peer_cache'] = peer
        return stats

    def fleet_view(self):
        """The merged fleet view the dispatcher's /report serves:
        per-worker breakdown (liveness, job binding, in-flight load, and
        the latest heartbeat-piggybacked observability summary — rates,
        pid, the worker's own obs endpoint port) plus the scheduler
        totals and the job registry. The *aggregate* metrics (fleet-wide
        stage seconds, anomaly counters) already live in this process's
        registry via the DONE-frame delta merges, so `pipeline_report()`
        alongside this IS the merged view."""
        now = time.monotonic()
        workers = {}
        for identity, worker in list(self._workers.items()):
            name = identity.decode('utf-8', 'replace')
            entry = {
                'alive': now - worker.last_heartbeat
                <= self._liveness_timeout_s,
                'ready': worker.ready,
                'inflight': len(worker.inflight),
                'heartbeat_age_s': round(now - worker.last_heartbeat, 3),
                'job_id': worker.job_id,
            }
            if worker.cordoned:
                entry['cordoned'] = True
            if worker.preempted_to is not None:
                entry['preempted_to'] = worker.preempted_to
            if worker.cache_fps:
                entry['cache_fps'] = sorted(worker.cache_fps)
            held = self._peer_dir.held_count(identity)
            if held:
                entry['peer_entries'] = held
            summary = self._worker_obs.get(identity)
            if summary is not None:
                entry['summary'] = summary
            workers[name] = entry
        view = {'workers': workers,
                'jobs': [job.descriptor()
                         for job in list(self._jobs.values())]}
        view.update(self.stats())
        return view

    # -- supervisor surface (called from the supervisor thread) --------------

    def _worker_pid(self, identity, worker):
        if worker.pid is not None:
            return worker.pid
        summary = self._worker_obs.get(identity)
        if summary and summary.get('pid'):
            return int(summary['pid'])
        return None

    def alive_worker_pids(self):
        """Pids of workers inside the liveness window — what the
        supervisor diffs against its spawned processes to find a
        wedged-but-running worker (process alive, heartbeats gone). A
        worker between jobs counts: its REGISTER re-sends refresh
        liveness and carry its pid."""
        now = time.monotonic()
        pids = set()
        for identity, worker in list(self._workers.items()):
            if now - worker.last_heartbeat > self._liveness_timeout_s:
                continue
            pid = self._worker_pid(identity, worker)
            if pid is not None:
                pids.add(pid)
        return pids

    def cordon_worker_by_pid(self, pid):
        """Stop assigning work to the worker running as ``pid`` (the
        supervisor's two-phase release: cordon, wait idle, terminate).
        Returns True when a live worker matched. The flag writes are
        benign cross-thread (single bool stores read by the dispatcher
        thread's next scheduling pass)."""
        for identity, worker in list(self._workers.items()):
            if self._worker_pid(identity, worker) == pid:
                worker.cordoned = True
                worker.ready = False
                return True
        return False

    def worker_inflight_by_pid(self, pid):
        """In-flight item count of the worker running as ``pid``; None
        when no such worker is registered (already gone)."""
        for identity, worker in list(self._workers.items()):
            if self._worker_pid(identity, worker) == pid:
                return len(worker.inflight)
        return None

    def _update_fleet_gauges(self):
        """Mirror fleet health into the process-wide registry so
        pipeline_report()'s `service` section (and the Prometheus/JSONL
        exporters) see it without holding a pool reference."""
        if metrics_disabled():
            return
        now = time.monotonic()
        workers = list(self._workers.values())
        live = sum(1 for w in workers
                   if now - w.last_heartbeat <= self._liveness_timeout_s)
        registry = get_registry()
        registry.gauge(SERVICE_WORKERS_ALIVE).set(live)
        registry.gauge(SERVICE_WORKERS_REGISTERED).set(len(workers))
        with self._lock:
            pending = self._pending_total_locked()
        # backoff-delayed retries are pending work too — stats()/health()
        # already count them, and the gauge must agree
        registry.gauge(SERVICE_ITEMS_PENDING).set(pending
                                                  + len(self._retry))
        registry.gauge(SERVICE_ITEMS_ASSIGNED).set(len(self._inflight))
        registry.gauge(SERVICE_JOBS).set(len(self._jobs))

    # -- dispatcher thread ---------------------------------------------------

    def run(self):
        import zmq

        context = zmq.Context()
        sock = context.socket(zmq.ROUTER)
        try:
            if self._requested_endpoint.endswith(':0'):
                base = self._requested_endpoint.rsplit(':', 1)[0]
                port = sock.bind_to_random_port(base)
                self.endpoint = '%s:%d' % (base, port)
            else:
                sock.bind(self._requested_endpoint)
                self.endpoint = self._requested_endpoint
        except Exception as e:  # noqa: BLE001 - surfaced to start()
            self._fatal_error = RuntimeError(
                'Dispatcher failed to bind %r: %s'
                % (self._requested_endpoint, e))
            self._bound.set()
            sock.close(linger=0)
            context.term()
            return
        self._sock = sock
        self._bound.set()

        last_sweep = time.monotonic()
        last_tick = last_sweep
        backlog_prev = False
        try:
            while not self._stop_event.is_set():
                self._flush_backlogs()
                # Time spent with completions backlogged behind a full
                # LOCAL consumer queue is the service-side back-pressure
                # clock: the fleet is quiesced because the CONSUMER is
                # slow — producer wait, consumer-bound evidence (the
                # remote workers never block locally; their out channel
                # is the dispatcher, so this is measured here). Client
                # jobs' credit gates are deliberately NOT on this clock:
                # a remote consumer's stall is that job's back-pressure,
                # not this process's. An interval counts only when the
                # backlog existed at BOTH of its ends: charging the
                # interval in which a backlog first appeared would bill
                # message-handling time that preceded it as a stall.
                tick = time.monotonic()
                backlogged = self._local_backlogged()
                if backlogged and backlog_prev:
                    note_producer_wait(tick - last_tick)
                backlog_prev = backlogged
                last_tick = tick
                # While completions are backlogged the consumer's next free
                # queue slot is the event that matters, and ZMQ cannot wake
                # us for it — poll short so drained slots refill within
                # ~5ms instead of a full poll interval (otherwise every
                # marker behind a full queue costs the consumer a phantom
                # ~50ms starvation wait).
                poll_ms = 5 if backlogged else _POLL_INTERVAL_MS
                if sock.poll(poll_ms):
                    # Drain everything queued before scheduling: completions
                    # free credit that the assignment pass below can use.
                    while True:
                        try:
                            frames = sock.recv_multipart(zmq.NOBLOCK)
                        except zmq.Again:
                            break
                        if faults.ARMED and faults.fault_hit(
                                'zmq.recv',
                                key=frames[1] if len(frames) > 1
                                else b'') == 'drop':
                            continue  # injected: message lost in flight
                        self._handle(sock, frames)
                self._assign(sock)
                now = time.monotonic()
                if now - last_sweep >= self._heartbeat_interval_s:
                    last_sweep = now
                    self._sweep(now)
                    self._update_fleet_gauges()
        except Exception as e:  # noqa: BLE001 - fatal for the whole pool
            logger.exception('Dispatcher loop died')
            self._fatal_error = e
        finally:
            for _ in range(_STOP_BROADCASTS):
                for identity in list(self._workers):
                    if faults.ARMED and faults.fault_hit(
                            'zmq.stop', key=identity) == 'drop':
                        continue  # injected: died without goodbye
                    try:
                        sock.send_multipart([identity, proto.MSG_STOP],
                                            flags=zmq.NOBLOCK)
                    except Exception:  # noqa: BLE001 - peer may be gone
                        count_swallowed('dispatcher-stop-broadcast')
                time.sleep(_POLL_INTERVAL_MS / 1000.0)
            self._sock = None
            sock.close(linger=500)
            context.term()

    # -- message handling ----------------------------------------------------

    def _handle(self, sock, frames):
        identity, msg = frames[0], frames[1]
        now = time.monotonic()
        if msg == proto.MSG_REGISTER:
            worker = self._workers.get(identity)
            if worker is None:
                worker = _WorkerState(identity, now)
                self._workers[identity] = worker
                self._workers_seen += 1
                logger.info('Worker %s registered (%d registered)',
                            identity, len(self._workers))
            else:
                worker.last_heartbeat = now
            if len(frames) > 2:
                try:
                    worker.pid = int(frames[2])
                except ValueError:
                    pass  # old/foreign build: pid arrives via summaries
            if len(frames) > 3:
                # optional cache-fingerprint advert (JSON list): the
                # worker's host already holds these decoded caches, so
                # binding MUST see them before its first heartbeat
                # summary arrives — placement at registration time is
                # the whole point (docs/service.md). Absent from older
                # builds; a bad frame degrades to no advert.
                self._note_cache_advert(worker, frames[3])
            if len(frames) > 4 and self._peer_enabled:
                # fleet cache tier: the FULL decoded-entry advert from
                # the worker's startup scan — the directory is complete
                # for this holder before its first WORK is assigned
                self._peer_dir.note_advert(
                    identity, proto.load_json_params(frames[4]))
            if worker.job_id is None:
                self._bind_worker(worker)
            job = self._jobs.get(worker.job_id)
            if job is not None:
                sock.send_multipart([identity, proto.MSG_SPEC,
                                     job.spec_payload, self.token])
            # no job to serve yet: stay silent — the worker re-sends
            # REGISTER with backoff (its re-sends double as liveness)
            self._update_fleet_gauges()
        elif msg == proto.MSG_READY:
            worker = self._workers.get(identity)
            if worker is not None:
                worker.ready = (not worker.cordoned
                                and worker.preempted_to is None)
                worker.last_heartbeat = now
        elif msg == proto.MSG_HEARTBEAT:
            summary = None
            if len(frames) > 2:
                # optional trailing frames: the worker's per-heartbeat
                # observability summary (docs/telemetry.md fleet view;
                # b'' when its advisory path degraded) and — its own
                # frame, never inside the summary, because correctness
                # must not ride an advisory channel — the worker's job
                # token. Absent from older builds; a bad summary frame
                # degrades to None and liveness never depends on either.
                summary = proto.load_obs_summary(frames[2])
            # a worker still serving ANOTHER dispatcher incarnation's
            # job (this one replaced it on the endpoint) advertises that
            # incarnation's token: keep its liveness, never assign it
            # work — our ACK's token will send it back to registration
            foreign = len(frames) > 3 and frames[3] != self.token
            worker = self._workers.get(identity)
            if worker is None:
                # A lapsed worker resurfacing (its items were already
                # re-ventilated): it still holds the spec and a live
                # decode worker OF THE JOB IT LAPSED FROM, so it may
                # only re-bind there — never to the least-loaded job,
                # which under multi-tenancy could be a different spec.
                worker = _WorkerState(identity, now)
                self._workers[identity] = worker
                lapsed_job = self._jobs.get(
                    self._lapsed_bindings.pop(identity, None))
                if foreign:
                    worker.ready = False
                elif lapsed_job is not None:
                    worker.job_id = lapsed_job.job_id
                    lapsed_job.workers.add(identity)
                    worker.ready = True
                else:
                    # its job is gone (or the binding aged out): STOP it
                    # back through registration so it picks up a LIVE
                    # job's spec instead of idling on a dead one
                    worker.ready = False
                    self._send_worker(identity, [proto.MSG_STOP])
                logger.info('Worker %s re-admitted after lapse%s',
                            identity,
                            ' (foreign incarnation; not assignable)'
                            if foreign else
                            ('' if lapsed_job is not None
                             else ' (job gone; sent back to register)'))
            else:
                worker.last_heartbeat = now
                if foreign:
                    worker.ready = False
            if summary is not None:
                self._worker_obs[identity] = summary
                fps = summary.get('cache_fp')
                if isinstance(fps, list):
                    worker.cache_fps.update(str(fp) for fp in fps if fp)
                if self._peer_enabled:
                    peer = summary.get('peer')
                    if peer:
                        # bounded add/evict/touch delta of the worker's
                        # decoded-cache entries (fleet cache tier)
                        self._peer_dir.note_advert(identity, peer)
            ack = [identity, proto.MSG_HEARTBEAT_ACK, self.token]
            if self._peer_enabled:
                hints = self._peer_dir.take_hints(identity)
                if hints:
                    # advisory global-eviction hints ride the ACK as one
                    # additive trailing frame (old workers ignore it)
                    ack.append(proto.dump_json_params({'evict': hints}))
                    self._peer_evict_hints_sent += len(hints)
                    if not metrics_disabled():
                        get_registry().counter(
                            PEER_CACHE_EVICT_HINTS).inc(len(hints))
            sock.send_multipart(ack)
        elif msg == proto.MSG_DONE:
            item_id = proto.unpack_item_id(frames[2])
            # frames: [identity, DONE, item_id, metrics, result*]. The
            # wire has no version marker, and externally-started worker
            # servers may run a pre-telemetry build whose DONE is
            # [identity, DONE, item_id, result*] — so the slot is claimed
            # as metrics ONLY when it is empty (b'': "nothing changed")
            # or passes load_metrics_delta's strict delta-shape check;
            # otherwise it is treated as the first result frame. Dropping
            # a result would be silent row loss; misreading one as a
            # delta is made implausible by the strict shape.
            payload = frames[3:]
            if payload and (payload[0] == b''
                            or self._merge_metrics(payload[0])):
                payload = payload[1:]
            self._complete(identity, item_id, ('result', payload), now)
        elif msg == proto.MSG_ERROR:
            item_id = proto.unpack_item_id(frames[2])
            exc = proto.load_exception(frames[3])
            if len(frames) > 4:
                self._merge_metrics(frames[4])
            self._fail(identity, item_id, exc, now)
        elif msg == proto.MSG_BYE:
            self._deregister(identity, 'said goodbye')
        elif msg == proto.MSG_DIR_GET:
            # fleet cache-tier directory lookup: a worker's peer-cache
            # client asking (on its OWN DEALER) who holds these entry
            # digests. Disabled tier answers the empty map — the asker
            # negative-caches and decodes locally. A malformed request
            # costs that request, nothing else.
            import json
            try:
                digests = json.loads(frames[2].decode('utf-8')) \
                    if len(frames) > 2 else []
                if not isinstance(digests, list):
                    digests = []
            except Exception:  # noqa: BLE001 - the directory is advisory
                count_swallowed('dispatcher-dirget')
                digests = []
            mapping = (self._peer_dir.lookup(digests[:_DIRGET_CAP])
                       if self._peer_enabled else {})
            sock.send_multipart([identity, proto.MSG_DIR,
                                 proto.dump_json_params(mapping)])
        elif msg == proto.MSG_STANDBY_SYNC:
            # a warm standby pulling its replication snapshot
            # (docs/service.md, "High availability"). The drop faultpoint
            # models a severed replication stream: the standby's snapshot
            # goes stale (or stays empty) and a later promotion degrades
            # to a cold promote — which the chaos suite proves is still
            # multiset-exact, just slower to re-admit.
            if faults.ARMED and faults.fault_hit(
                    'zmq.replicate', key=identity) == 'drop':
                return  # injected: snapshot lost in flight
            self._standby_syncs_served += 1
            self._last_standby_sync = now
            sock.send_multipart(
                [identity, proto.MSG_STANDBY_STATE, self.token,
                 proto.dump_standby_state(self.standby_snapshot())])
        elif msg in (proto.MSG_REGISTER_JOB, proto.MSG_SUBMIT,
                     proto.MSG_CLIENT_HB, proto.MSG_JOB_GONE):
            # client frames are OTHER PROCESSES' input: a malformed one
            # (truncated multipart, unparseable field) must cost that
            # frame, never the daemon — run()'s catch-all treats an
            # escaped exception as fatal for every co-tenant job
            try:
                self._handle_client_frame(sock, identity, msg, frames,
                                          now)
            except Exception:  # noqa: BLE001 - one bad client, not all
                logger.warning('Malformed client frame %r from %s '
                               'dropped', msg, identity, exc_info=True)
                count_swallowed('daemon-malformed-client-frame')
        else:
            logger.warning('Unknown service message type %r from %s',
                           msg, identity)

    def _handle_client_frame(self, sock, identity, msg, frames, now):
        if msg == proto.MSG_REGISTER_JOB:
            self._handle_register_job(sock, identity, frames, now)
        elif msg == proto.MSG_SUBMIT:
            self._handle_submit(sock, identity, frames, now)
        elif msg == proto.MSG_CLIENT_HB:
            self._handle_client_hb(sock, identity, frames, now)
        elif msg == proto.MSG_JOB_GONE:
            job = self._job_for_client(identity, frames[2])
            if job is not None:
                self._remove_job(job, 'client goodbye')

    # -- client-job handling (the standing-service registry) -----------------

    def _job_for_client(self, identity, job_id_frame):
        """The registry entry for a client frame, or None (expired /
        never existed / spoofed identity)."""
        try:
            job_id = int(job_id_frame)
        except (TypeError, ValueError):
            return None
        job = self._jobs.get(job_id)
        if job is None or job.client != identity:
            return None
        return job

    def _handle_register_job(self, sock, identity, frames, now):
        params = proto.load_json_params(frames[3] if len(frames) > 3
                                        else b'')
        client_key = params.get('key')
        # idempotent re-registration: a client whose JOB_OK was lost, who
        # timed out waiting, or who reconnected on a FRESH socket (new
        # ZMQ identity after an ack-timeout blip) re-sends REGISTER_JOB
        # with the same key — answer with the existing job instead of
        # double-registering. Matching is on the key ALONE (a 32-hex
        # client-minted uuid): the identity changes with every socket,
        # so requiring it to match would defeat exactly the reconnect
        # case; the rebind below points the job's results at the
        # client's live identity.
        # key-alone matching also covers a job SEEDED from a promoted
        # standby's snapshot (client=None until its owner re-registers
        # with this incarnation): the reconnecting client re-binds to
        # the job identity the dead primary leased it — same id, same
        # key — instead of double-registering
        if client_key:
            for job in self._jobs.values():
                if job.client_key == client_key:
                    job.client = identity
                    # reconcile the delivery-credit clock: markers sent
                    # toward the OLD identity during the blip were
                    # dropped by the ROUTER and will never be acked —
                    # left counted, they would inflate the unacked
                    # window forever (a full window would gate the job
                    # permanently). Zeroing the window is safe: the
                    # client re-submits every un-markered item, and
                    # each re-delivery re-counts. If the identity never
                    # actually changed (a lost JOB_OK re-send), live
                    # in-flight markers go briefly under-counted — the
                    # gate opens LATE by at most one credit window,
                    # bounded, never wedged.
                    job.markers_sent = job.markers_acked
                    # frames backlogged for the old socket must NOT
                    # flush to the new one: a stale bare marker (its
                    # result frames died with the old socket) would make
                    # the client count the item delivered with zero rows
                    # and drop the re-decoded real delivery. Every
                    # out-resident item is un-markered client-side, and
                    # every registration is followed by re-submission —
                    # dropping the backlog loses nothing.
                    job.out.clear()
                    job.last_client_seen = now
                    sock.send_multipart([identity, proto.MSG_JOB_OK,
                                         b'%d' % job.job_id, self.token])
                    return
        refusal = None
        if self._draining:
            refusal = {'reason': 'draining'}
        elif len(self._jobs) >= self._max_jobs:
            refusal = {'reason': 'saturated', 'jobs': len(self._jobs),
                       'max_jobs': self._max_jobs}
        if refusal is not None:
            # admission control: a retryable refusal, never an error —
            # the client backs off and retries within its own deadline
            sock.send_multipart([identity, proto.MSG_BUSY,
                                 proto.dump_json_params(refusal)])
            return
        lease_s = params.get('lease_s')
        lease_s = float(lease_s) if lease_s else self._default_lease_s
        credit = params.get('credit')
        credit = int(credit) if credit else None
        with self._lock:
            self._job_seq += 1
            job = _Job(self._job_seq, frames[2], client=identity,
                       client_key=client_key, lease_s=lease_s,
                       credit=credit, name=params.get('name'),
                       weight=params.get('weight'),
                       priority=params.get('priority'),
                       fingerprint=params.get('fingerprint'))
            job.last_client_seen = now
            self._jobs[job.job_id] = job
        self._jobs_seen += 1
        logger.info('Job %d (%s) registered; %d active', job.job_id,
                    job.name, len(self._jobs))
        tracing.record_instant('job_register', tracing.mint(job.job_id),
                               'daemon', job=job.job_id,
                               job_name=job.name)
        sock.send_multipart([identity, proto.MSG_JOB_OK,
                             b'%d' % job.job_id, self.token])
        self._rebalance_for(job)
        self._update_fleet_gauges()

    def _handle_submit(self, sock, identity, frames, now):
        job = self._job_for_client(identity, frames[2])
        if job is None:
            # the job is gone (lease lapsed, daemon restarted): tell the
            # client so it can re-register and re-submit what its own
            # accounting says is still owed — never silently eat work
            sock.send_multipart([identity, proto.MSG_JOB_EXPIRED,
                                 frames[2]])
            return
        job.last_client_seen = now
        cid = int(frames[3])
        if cid in job.live_cids:
            # a reconnected client re-submitting an item this job still
            # holds (registration survived the socket reset): one copy
            # is enough — the client's own cid accounting would drop the
            # second delivery anyway, so dedup here saves the decode
            return
        self.submit(frames[4], job_id=job.job_id, client_item_id=cid)

    def _handle_client_hb(self, sock, identity, frames, now):
        job = self._job_for_client(identity, frames[2])
        if job is None:
            sock.send_multipart([identity, proto.MSG_JOB_EXPIRED,
                                 frames[2]])
            return
        job.last_client_seen = now
        try:
            acked = int(frames[3])
        except (IndexError, ValueError):
            acked = job.markers_acked
        # monotonic: a reordered older heartbeat must not re-open credit
        job.markers_acked = max(job.markers_acked, acked)
        status = {
            'workers_alive': sum(
                1 for w in self._workers.values()
                if now - w.last_heartbeat <= self._liveness_timeout_s),
            'workers_registered': len(self._workers),
            'job_workers': len(job.workers),
            'jobs_active': len(self._jobs),
            'pending': len(job.pending),
            'unacked': job.markers_sent - job.markers_acked,
            'draining': self._draining,
        }
        sock.send_multipart([identity, proto.MSG_CLIENT_HB_ACK, self.token,
                             proto.dump_json_params(status)])

    def _remove_job(self, job, reason):
        """Take one job out of the registry: purge its waiting items,
        reclaim its in-flight work (late completions dedup away), and
        STOP its workers back into the registration pool so surviving
        jobs inherit them. Co-tenant jobs are untouched."""
        with self._lock:
            # under the lock: submit() (any pool/ventilator thread)
            # inserts into _item_job concurrently, and iterating it
            # unlocked would be a dict-changed-size crash in the
            # scheduler thread
            owned = {i for i, j in self._item_job.items()
                     if j == job.job_id}
            self._jobs.pop(job.job_id, None)
            purged_pending = len(job.pending)
            job.pending.clear()
            job.pending_ids.clear()
        if self._retry and any(e[2] in owned for e in self._retry):
            self._retry = [e for e in self._retry if e[2] not in owned]
            heapq.heapify(self._retry)
        reclaimed = 0
        for item_id in owned:
            self._item_job.pop(item_id, None)
            entry = self._inflight.pop(item_id, None)
            if entry is not None:
                reclaimed += 1
                owner = self._workers.get(entry[0])
                if owner is not None:
                    owner.inflight.discard(item_id)
                # a late DONE for reclaimed work must dedup away: the
                # job it belonged to no longer exists to deliver to
                self._done.add(item_id)
            self._attempts.pop(item_id, None)
            self._last_error.pop(item_id, None)
            self._trace_ctx.pop(item_id, None)
            self._item_owners.pop(item_id, None)
        job.client_item_ids.clear()
        job.live_cids.clear()
        job.out.clear()
        for identity in list(job.workers):
            worker = self._workers.get(identity)
            if worker is not None:
                worker.job_id = None
                worker.ready = False
                self._send_worker(identity, [proto.MSG_STOP])
        job.workers.clear()
        logger.warning('Job %d (%s) removed (%s): %d pending purged, '
                       '%d in-flight reclaimed', job.job_id, job.name,
                       reason, purged_pending, reclaimed)
        tracing.record_instant('job_gone', tracing.mint(job.job_id),
                               'daemon', job=job.job_id, reason=reason,
                               pending=purged_pending, inflight=reclaimed)
        self._update_fleet_gauges()

    def _send_worker(self, identity, frames):
        """Best-effort dispatcher-thread send to a worker peer."""
        import zmq
        if self._sock is None:
            return
        try:
            self._sock.send_multipart([identity] + frames,
                                      flags=zmq.NOBLOCK)
        except Exception:  # noqa: BLE001 - peer may be gone
            count_swallowed('dispatcher-worker-send')

    # -- worker <-> job binding ----------------------------------------------

    def _note_cache_advert(self, worker, frame):
        """Fold a worker's REGISTER-time cache advert (JSON list of
        decode fingerprints) into its fleet cache-directory entry. A
        bad frame degrades to no advert — placement is advisory."""
        import json
        try:
            fps = json.loads(bytes(frame).decode('utf-8'))
        except Exception:  # noqa: BLE001 - placement is advisory
            count_swallowed('dispatcher-cache-advert')
            return
        if isinstance(fps, list):
            worker.cache_fps.update(str(fp) for fp in fps if fp)

    def _bind_worker(self, worker):
        """Bind a fresh/unbound worker to the job that needs it most:
        jobs with pending work before idle ones (a drained tier —
        however senior — must not hoard fresh workers while a co-tenant
        has rows waiting; priority gates SERVICE, not possession), then
        highest priority tier, then lowest weight-normalized load, then
        cache-aware placement (the job whose decode fingerprint the
        worker's host already advertises wins the tie — its cache is
        warm there), ties to the oldest job. With default QoS params and
        no fingerprints this reduces exactly to the original
        least-loaded-first binding."""
        candidates = [job for job in self._jobs.values()]
        if not candidates:
            return None

        def warmth(job):
            if not (self._placement_enabled and job.fingerprint):
                return 1
            return 0 if job.fingerprint in worker.cache_fps else 1

        job = min(candidates,
                  key=lambda j: (0 if j.pending else 1,
                                 -j.priority if j.pending else 0,
                                 len(j.workers) / j.weight,
                                 warmth(j), j.job_id))
        if self._placement_enabled and job.fingerprint:
            if job.fingerprint in worker.cache_fps:
                self._placement_hits += 1
                if not metrics_disabled():
                    get_registry().counter(SERVICE_PLACEMENT_HITS).inc()
            else:
                self._placement_misses += 1
                if not metrics_disabled():
                    get_registry().counter(SERVICE_PLACEMENT_MISSES).inc()
        worker.job_id = job.job_id
        job.workers.add(worker.identity)
        return job

    def _rebalance_for(self, needy_job):
        """A newly-registered job with zero workers steals ONE idle
        worker from the best-served job (STOP → the worker re-registers
        with a fresh identity and lands on the needy job via
        :meth:`_bind_worker`); further convergence happens one worker
        per sweep, bounding churn."""
        if needy_job.workers:
            return
        self._rebalance_step()

    def _rebalance_step(self):
        """At most one worker moves per call: find the most-served and
        least-served jobs by WEIGHT-NORMALIZED load; when the move
        narrows the normalized gap (at equal weights: the raw gap
        exceeds one worker) or the least-served has none, STOP one IDLE
        worker of the donor. Idle only: STOPping a busy worker would
        re-ventilate its items and charge their retry budgets for a
        scheduling decision. Priority preemption runs first — it is the
        one path allowed to cordon a BUSY worker (drained at row-group
        granularity, never mid-item)."""
        self._preempt_step()
        jobs = list(self._jobs.values())
        if len(jobs) < 2:
            return
        # demand classes before load: a job with NO pending work is the
        # preferred donor (its workers are idle capital) and is never
        # needy, whatever its weight-normalized load — without this, an
        # idle high-priority job and a pending-first _bind_worker churn
        # a STOP/rebind loop while a busy co-tenant starves
        donor = max(jobs, key=lambda j: (0 if j.pending else 1,
                                         len(j.workers) / j.weight,
                                         -j.job_id))
        needy = min(jobs, key=lambda j: (0 if j.pending else 1,
                                         len(j.workers) / j.weight,
                                         j.job_id))
        if donor is needy or not donor.workers:
            return
        if needy.priority < donor.priority and donor.pending:
            # strict priority: a busy higher tier keeps its fleet — the
            # lower tier waits (the documented starvation semantics,
            # docs/troubleshoot.md). An IDLE higher tier still donates.
            return
        starved = len(needy.workers) == 0 and bool(needy.pending)
        idle_donor = not donor.pending and bool(needy.pending)
        donor_after = (len(donor.workers) - 1) / donor.weight
        needy_after = (len(needy.workers) + 1) / needy.weight
        if donor_after < needy_after and not starved and not idle_donor:
            # starved: a zero-worker job WITH pending work may steal an
            # idle worker even from a one-worker donor — with more jobs
            # than workers that degenerates to time-multiplexing at
            # sweep cadence (the donor steals back when ITS queue is
            # the starved one): crude, but strictly better than the 9th
            # job wedging against a fully-partitioned fleet.
            # idle_donor: a drained job's workers all flow to a pending
            # co-tenant, one per sweep, whatever the load gap says.
            return
        for identity in list(donor.workers):
            worker = self._workers.get(identity)
            if worker is None or worker.inflight or worker.cordoned \
                    or worker.preempted_to is not None:
                continue
            worker.job_id = None
            worker.ready = False
            donor.workers.discard(identity)
            self._send_worker(identity, [proto.MSG_STOP])
            logger.info('Rebalancing: moved worker %s off job %d toward '
                        'job %d', identity, donor.job_id, needy.job_id)
            return

    def _preempt_step(self):
        """Priority admission: the highest-priority job with pending
        work and no workers' worth of service takes ONE worker per sweep
        from a lower tier. An idle victim moves immediately (same STOP →
        re-register → priority-first rebind path as rebalancing); a busy
        one is marked ``preempted_to`` — no new assignments, drained at
        row-group granularity, moved once its in-flight empties — so
        exactly-once accounting is untouched and the preempted job is
        never charged a retry or a quarantine for the scheduling
        decision."""
        # release drained preempted workers first: their in-flight hit
        # zero since the mark, so the move completes this sweep
        for worker in list(self._workers.values()):
            if worker.preempted_to is None or worker.inflight:
                continue
            old_job = self._jobs.get(worker.job_id)
            if old_job is not None:
                old_job.workers.discard(worker.identity)
            worker.job_id = None
            worker.ready = False
            worker.preempted_to = None
            self._send_worker(worker.identity, [proto.MSG_STOP])
        jobs = [j for j in self._jobs.values()]
        if len(jobs) < 2:
            return
        contenders = [j for j in jobs
                      if j.pending and not j.gated() and not j.workers]
        if not contenders:
            return
        high = max(contenders, key=lambda j: (j.priority, -j.job_id))
        victims = [j for j in jobs if j.priority < high.priority
                   and j.workers]
        if not victims:
            return
        victim = max(victims, key=lambda j: (len(j.workers) / j.weight,
                                             -j.priority))
        # prefer an idle victim worker (moves this sweep); else cordon
        # one busy worker to drain — skip ones already marked
        chosen = None
        for identity in sorted(victim.workers):
            worker = self._workers.get(identity)
            if worker is None or worker.cordoned \
                    or worker.preempted_to is not None:
                continue
            if chosen is None or (chosen.inflight and not worker.inflight):
                chosen = worker
            if not worker.inflight:
                break
        if chosen is None:
            return
        self._preemptions += 1
        if not metrics_disabled():
            get_registry().counter(SERVICE_PREEMPTIONS).inc()
        tracing.record_instant(
            'job_preempt', tracing.mint(high.job_id), 'daemon',
            job=high.job_id, victim_job=victim.job_id,
            worker=chosen.identity.decode('utf-8', 'replace'),
            draining=bool(chosen.inflight))
        logger.warning('Preempting worker %s from job %d (priority %d) '
                       'toward job %d (priority %d)%s', chosen.identity,
                       victim.job_id, victim.priority, high.job_id,
                       high.priority,
                       ' after drain' if chosen.inflight else '')
        if chosen.inflight:
            chosen.preempted_to = high.job_id
            chosen.ready = False
            return
        victim.workers.discard(chosen.identity)
        chosen.job_id = None
        chosen.ready = False
        self._send_worker(chosen.identity, [proto.MSG_STOP])

    def _merge_metrics(self, frame):
        """Fold one worker server's piggybacked telemetry delta into this
        (client) process's registry — the dispatcher is where per-worker
        deltas become the fleet-wide aggregate. Returns whether the frame
        WAS a delta (the DONE path uses this to tell the metrics slot from
        a result frame sent by a pre-telemetry worker build). Duplicate
        completions double-merge in the worst case (telemetry is advisory;
        item delivery, not metrics, carries the exactly-once guarantee)."""
        delta = proto.load_metrics_delta(frame)
        if delta is None:
            return False
        self._metrics_deltas_merged += 1
        merge_worker_delta(delta)
        return True

    def _complete(self, identity, item_id, outcome, now):
        worker = self._workers.get(identity)
        if worker is not None:
            worker.last_heartbeat = now
            worker.inflight.discard(item_id)
        if item_id in self._done:
            # Duplicate completion from a lapsed-then-reassigned race (or
            # a late completion of lease-reclaimed work); the first DONE
            # already delivered this item's rows — or the job that owned
            # them was already declared gone.
            logger.debug('Dropping duplicate completion of item %d from %s',
                         item_id, identity)
            self._duplicate_done_count += 1
            if not metrics_disabled():
                get_registry().counter(SERVICE_DUPLICATE_DONE).inc()
            # both completions have now been seen: the trace entry has
            # served its purpose (the dedup drop is marked on the timeline)
            dup_entry = self._trace_ctx.pop(item_id, None)
            if dup_entry is not None:
                tracing.record_instant(
                    'duplicate_done', dup_entry.ctx, 'dispatcher',
                    worker=identity.decode('utf-8', 'replace'))
            return
        if identity not in self._item_owners.get(item_id, ()):
            # a completion from a worker this dispatcher NEVER assigned
            # the item to: stale cross-incarnation traffic (a restarted
            # daemon's id space collides with its predecessor's) — the
            # rows belong to some OTHER item/job and accepting them
            # would be silent duplication plus silent loss
            logger.warning('Dropping completion of item %d from %s: not '
                           'an owner (stale cross-incarnation frame?)',
                           item_id, identity)
            count_swallowed('dispatcher-stale-completion')
            return
        job = self._jobs.get(self._item_job.get(item_id))
        assignment = self._inflight.pop(item_id, None)
        if assignment is None:
            # Ghost completion: the item lapsed back onto the pending queue
            # (or the retry backoff heap) but its original owner finished
            # after all. Accept the result and withdraw the waiting copy
            # so it is not run twice.
            if not self._withdraw_waiting(item_id):
                logger.warning('Completion of unknown item %d from %s '
                               'dropped', item_id, identity)
                return
        else:
            owner = self._workers.get(assignment[0])
            if owner is not None:
                owner.inflight.discard(item_id)
        if job is None:
            # unreachable in practice (jobless live items are purged with
            # their job), kept as a loud guard instead of a KeyError in
            # the scheduler thread
            logger.warning('Completion of item %d belongs to no live job',
                           item_id)
            return
        # a delivered completion clears the item's suspect record: its
        # budget was for THIS traversal, and innocent items that shared a
        # dying worker must not carry the black mark forever
        self._attempts.pop(item_id, None)
        self._last_error.pop(item_id, None)
        if item_id in self._risky_ids:
            self._done.add(item_id)
            # a risky item keeps its trace entry so a RACED second DONE
            # can be marked as deduped — but a SIGKILLed first owner never
            # sends one, so stamp the completion time and let the sweep
            # age the entry out (the ghost race window is a few liveness
            # timeouts at most); without this the map would grow with
            # failure churn for the life of the process
            trace_entry = self._trace_ctx.get(item_id)
            if trace_entry is not None and trace_entry.completed_at is None:
                trace_entry.completed_at = now
        else:
            trace_entry = self._trace_ctx.pop(item_id, None)
        if trace_entry is not None:
            # the item's ONE delivered completion
            tracing.record_instant(
                'done', trace_entry.ctx, 'dispatcher',
                worker=identity.decode('utf-8', 'replace'),
                attempts=trace_entry.attempts, outcome=outcome[0])
        self._completed_count += 1
        self._item_job.pop(item_id, None)
        self._item_owners.pop(item_id, None)
        job.completed += 1
        kind, payload = outcome
        if kind == 'result':
            for result_frame in payload:
                self._emit(job, item_id, ('result', result_frame))
        else:
            self._emit(job, item_id, ('error', payload))
        self._emit(job, item_id, ('marker', item_id))

    # -- delivery (local callback or client RESULT frames) -------------------

    def _emit(self, job, item_id, entry):
        """Hand one entry toward ``job``'s consumer, preserving order:
        direct only while the job's backlog is empty AND the destination
        (bounded queue / socket) has room."""
        if job.is_local:
            if job.out or not self._deliver(entry):
                job.out.append(entry)
            return
        kind = entry[0]
        cid = job.client_item_ids.get(item_id)
        if kind == 'marker':
            job.client_item_ids.pop(item_id, None)
            if cid is not None:
                job.live_cids.discard(cid)
            job.markers_sent += 1
        cid_frame = b'%d' % (cid if cid is not None else -1)
        if kind == 'result':
            frames = [proto.MSG_RESULT, b'result', cid_frame, entry[1]]
        elif kind == 'error':
            frames = [proto.MSG_RESULT, b'error', cid_frame,
                      proto.dump_exception(entry[1])]
        elif kind == 'poisoned':
            frames = [proto.MSG_RESULT, b'poisoned', cid_frame,
                      proto.dump_poisoned_info(entry[1])]
        else:
            frames = [proto.MSG_RESULT, b'marker', cid_frame]
        if job.out or not self._send_client(job, frames):
            job.out.append(frames)

    def _send_client(self, job, frames):
        """Non-blocking RESULT send toward a client job; False when the
        socket's peer pipe is momentarily full (the frames then wait in
        the job's backlog — rare: credit gating keeps in-flight results
        far below the HWM)."""
        import zmq
        if self._sock is None:
            return True  # shutting down: accounting no longer matters
        try:
            self._sock.send_multipart([job.client] + frames,
                                      flags=zmq.NOBLOCK)
            return True
        except zmq.Again:
            return False
        except Exception:  # noqa: BLE001 - peer gone; lease will reap
            count_swallowed('daemon-client-send')
            return True

    def _local_backlogged(self):
        job = self._jobs.get(LOCAL_JOB_ID)
        return bool(job is not None and job.out)

    def _flush_backlogs(self):
        for job in list(self._jobs.values()):
            if job.is_local:
                while job.out:
                    if not self._deliver(job.out[0]):
                        break
                    job.out.popleft()
            else:
                while job.out:
                    if not self._send_client(job, job.out[0]):
                        break
                    job.out.popleft()

    # -- failure handling: retry budget, backoff, quarantine -----------------

    def _withdraw_waiting(self, item_id):
        """Remove a waiting (pending or backoff-heap) copy of ``item_id``
        after a ghost completion delivered it; False when no copy was
        waiting (a genuinely unknown completion)."""
        job = self._jobs.get(self._item_job.get(item_id))
        if job is None:
            return False
        with self._lock:
            if item_id not in job.pending_ids:
                return False
            job.pending_ids.discard(item_id)
            job.pending = collections.deque(
                (i, p) for i, p in job.pending if i != item_id)
        if any(entry[2] == item_id for entry in self._retry):
            self._retry = [entry for entry in self._retry
                           if entry[2] != item_id]
            heapq.heapify(self._retry)
        return True

    def _fail(self, identity, item_id, exc, now):
        """One failed worker attempt (an ERROR frame): charge the item's
        retry budget and reschedule with backoff — or quarantine."""
        worker = self._workers.get(identity)
        if worker is not None:
            worker.last_heartbeat = now
            worker.inflight.discard(item_id)
        if item_id in self._done:
            # raced failure of an item whose ghost already delivered —
            # same dedup shape as a duplicate DONE
            self._duplicate_done_count += 1
            if not metrics_disabled():
                get_registry().counter(SERVICE_DUPLICATE_DONE).inc()
            return
        assignment = self._inflight.get(item_id)
        if assignment is None:
            # ghost failure from a lapsed owner; the re-ventilated copy
            # is already waiting (or assigned) and will speak for itself
            return
        if assignment[0] != identity:
            # ghost ERROR from a PRIOR owner racing its replacement: the
            # live assignment stands — cancelling it here would charge a
            # phantom attempt and let the item run twice concurrently
            return
        self._inflight.pop(item_id)
        self._record_failure(item_id, assignment[1],
                             'worker error: %s: %s'
                             % (type(exc).__name__, exc), exc, now)

    @staticmethod
    def _jitter(item_id, attempt):
        """Deterministic backoff jitter factor in [0.5, 1.5): seeded by
        the item identity so replayed chaos runs reschedule identically
        (no ``random`` module state involved)."""
        return 0.5 + ((item_id * 2654435761 + attempt * 40503)
                      % 4093) / 4093.0

    def _record_failure(self, item_id, payload, reason, exc, now):
        """Charge one failed attempt. Under budget: backoff-requeue.
        Budget exhausted: quarantine."""
        job = self._jobs.get(self._item_job.get(item_id))
        if job is None:
            return  # the owning job is gone; nothing left to retry FOR
        attempt = self._attempts.get(item_id, 0) + 1
        self._attempts[item_id] = attempt
        if exc is not None:
            self._last_error[item_id] = exc
        if attempt >= self._max_retries:
            self._quarantine(job, item_id, reason, now)
            return
        delay = (self._retry_backoff_s * (2 ** (attempt - 1))
                 * self._jitter(item_id, attempt))
        heapq.heappush(self._retry,
                       (now + delay, self._retry_seq, item_id, payload))
        self._retry_seq += 1
        with self._lock:
            job.pending_ids.add(item_id)
        self._retried_count += 1
        if not metrics_disabled():
            get_registry().counter(SERVICE_RETRIES).inc()
        entry = self._trace_ctx.get(item_id)
        if entry is not None:
            tracing.record_instant('retry', entry.ctx, 'dispatcher',
                                   attempt=attempt, reason=reason,
                                   backoff_s=round(delay, 4))
        logger.warning('Item %d failed attempt %d/%d (%s); retrying in '
                       '%.3fs', item_id, attempt, self._max_retries,
                       reason, delay)

    def _quarantine(self, job, item_id, reason, now):
        """Retry budget exhausted: skip the item, record it, surface it.
        The consumer receives a ``('poisoned', info)`` entry (policy
        applied pool-side) plus the accounting marker, so the epoch
        completes with the loss REPORTED instead of the fleet
        crash-looping or the read wedging."""
        attempts = self._attempts.pop(item_id, 0)
        exc = self._last_error.pop(item_id, None)
        # late ghost completions of a quarantined item must dedup away:
        # its rows were declared lost, and delivering them afterwards
        # would turn "reported loss" into silent duplication
        self._done.add(item_id)
        info = {'item_id': item_id, 'attempts': attempts,
                'reason': reason, 'error': exc,
                'max_retries': self._max_retries}
        descriptor = {'item_id': item_id, 'attempts': attempts,
                      'reason': reason,
                      'error': repr(exc) if exc is not None else None,
                      'job_id': job.job_id,
                      'quarantined_at': time.time()}
        self._poisoned[item_id] = descriptor
        while len(self._poisoned) > _POISONED_KEEP:
            self._poisoned.popitem(last=False)
        self._poisoned_count += 1
        if not metrics_disabled():
            get_registry().counter(SERVICE_POISONED).inc()
        record_anomaly('row_group_poisoned',
                       detail={k: v for k, v in descriptor.items()
                               if k != 'quarantined_at'})
        trace_entry = self._trace_ctx.pop(item_id, None)
        if trace_entry is not None:
            tracing.record_instant('poisoned', trace_entry.ctx,
                                   'dispatcher', attempts=attempts,
                                   reason=reason)
        self._item_job.pop(item_id, None)
        self._item_owners.pop(item_id, None)
        job.completed += 1
        self._emit(job, item_id, ('poisoned', info))
        self._emit(job, item_id, ('marker', item_id))

    def _promote_due_retries(self, now):
        """Move backoff-expired retries to the FRONT of their job's
        pending queue (oldest first): lapsed work is the oldest and gates
        epoch completion through the ventilator's in-flight bound."""
        due = []
        while self._retry and self._retry[0][0] <= now:
            _, _, item_id, payload = heapq.heappop(self._retry)
            due.append((item_id, payload))
        if due:
            with self._lock:
                for item_id, payload in reversed(due):
                    job = self._jobs.get(self._item_job.get(item_id))
                    if job is not None and item_id in job.pending_ids:
                        job.pending.appendleft((item_id, payload))

    def _pop_assignable(self, job, allow_suspect):
        """Pop the leftmost assignable pending item of ``job``. Suspects
        (items with a failed attempt) are skipped unless
        ``allow_suspect`` — they are only ever assigned alone to an idle
        worker."""
        with self._lock:
            for idx in range(len(job.pending)):
                item_id, payload = job.pending[idx]
                if not allow_suspect and item_id in self._attempts:
                    continue
                del job.pending[idx]
                job.pending_ids.discard(item_id)
                return item_id, payload
        return None

    # -- scheduling ----------------------------------------------------------

    def _assign(self, sock):
        self._promote_due_retries(time.monotonic())
        # Least-loaded first, so a fresh (or re-admitted) worker fills up
        # before busy ones receive more. Each worker draws ONLY from the
        # job it was built for; a gated job (stalled local consumer /
        # spent client credit) idles its slice of the fleet — quiescence,
        # not decay — while co-tenant jobs keep flowing.
        workers = sorted((w for w in self._workers.values() if w.ready),
                         key=lambda w: len(w.inflight))
        for worker in workers:
            job = self._jobs.get(worker.job_id)
            if job is None or job.gated():
                continue
            if any(i in self._attempts for i in worker.inflight):
                # suspect isolation: a worker running a retried item gets
                # NOTHING else — if the item kills it, it dies alone and
                # no innocent item's budget is charged for the crash
                continue
            while len(worker.inflight) < self._max_inflight_per_worker:
                popped = self._pop_assignable(
                    job, allow_suspect=not worker.inflight)
                if popped is None:
                    break
                item_id, payload = popped
                if item_id in self._done:
                    continue
                if faults.ARMED and faults.fault_hit(
                        'zmq.work', key=item_id) == 'drop':
                    pass  # injected: WORK frame lost; accounting intact
                else:
                    work_frames = [worker.identity, proto.MSG_WORK,
                                   proto.pack_item_id(item_id), payload]
                    if self._peer_enabled:
                        # piggyback the directory entries advertised
                        # since this worker's last WORK (one additive
                        # trailing frame, capped; DIRGET covers the rest)
                        version, delta = self._peer_dir.delta_since(
                            worker.peer_dir_seen,
                            exclude_identity=worker.identity)
                        worker.peer_dir_seen = version
                        if delta:
                            work_frames.append(
                                proto.dump_json_params(delta))
                    sock.send_multipart(work_frames)
                self._inflight[item_id] = (worker.identity, payload)
                worker.inflight.add(item_id)
                self._item_owners.setdefault(item_id,
                                             set()).add(worker.identity)
                entry = self._trace_ctx.get(item_id)
                if entry is not None:
                    entry.attempts += 1
                    tracing.record_instant(
                        'dispatch', entry.ctx, 'dispatcher',
                        worker=worker.identity.decode('utf-8', 'replace'),
                        attempt=entry.attempts)
                if item_id in self._attempts:
                    break  # nothing rides along with a suspect

    def _sweep(self, now):
        for identity, worker in list(self._workers.items()):
            window = self._liveness_timeout_s if worker.job_id is not None \
                else max(self._liveness_timeout_s,
                         _UNBOUND_LIVENESS_FLOOR_S)
            if now - worker.last_heartbeat > window:
                self._deregister(
                    identity, 'heartbeat lapsed (%.1fs > %.1fs)'
                    % (now - worker.last_heartbeat, window))
        # job leases: a client that died without a goodbye stops
        # submitting AND heartbeating — reclaim its job so the fleet
        # serves the living (docs/service.md, "Standing service")
        for job in [j for j in list(self._jobs.values())
                    if not j.is_local and j.lease_s]:
            silent_s = now - job.last_client_seen
            if silent_s > job.lease_s:
                self._jobs_expired += 1
                # count in-flight via _inflight (dispatcher-thread-only;
                # iterating _item_job here would race submit()'s
                # under-lock inserts from pool threads)
                inflight_n = sum(
                    1 for iid in self._inflight
                    if self._item_job.get(iid) == job.job_id)
                record_anomaly('job_lease_expired', detail={
                    'job_id': job.job_id, 'name': job.name,
                    'silent_s': round(silent_s, 3),
                    'lease_s': job.lease_s,
                    'pending': len(job.pending),
                    'inflight': inflight_n})
                self._remove_job(
                    job, 'lease expired (%.1fs > %.1fs silent)'
                    % (silent_s, job.lease_s))
        self._rebalance_step()
        if self._peer_enabled \
                and now - self._peer_hint_at > _PEER_HINT_INTERVAL_S:
            # fleet-global eviction pressure, recomputed coarsely: hints
            # queue per worker and drain on heartbeat ACKs; failover
            # seeds nobody re-claimed age out here too
            self._peer_hint_at = now
            self._peer_dir.compute_evict_hints(time.time())
            self._peer_dir.expire_seeds(now)
        # age out trace entries retained past completion for dedup marking
        # (see _complete): a ghost DONE races within ZMQ buffering of one
        # lapse, so several liveness timeouts is a generous window
        retention_s = 10.0 * self._liveness_timeout_s
        stale = [item_id for item_id, entry in list(self._trace_ctx.items())
                 if entry.completed_at is not None
                 and now - entry.completed_at > retention_s]
        for item_id in stale:
            self._trace_ctx.pop(item_id, None)
        with self._lock:
            outstanding = self._pending_total_locked() > 0 \
                or bool(self._inflight) or bool(self._retry)
        if outstanding and not self._workers:
            if self._no_workers_since is None:
                self._no_workers_since = now
            elif not self._standing \
                    and now - self._no_workers_since \
                    > self._no_workers_timeout_s:
                # embedded pools fail fast; a STANDING dispatcher keeps
                # serving — zero workers is the supervisor's condition to
                # repair (respawn), not a reason to take jobs down
                raise RuntimeError(
                    'No live worker servers for %.1fs with work outstanding; '
                    'is the dispatcher endpoint (%s) reachable from the '
                    'workers?' % (self._no_workers_timeout_s, self.endpoint))
        else:
            self._no_workers_since = None

    _LAPSED_BINDINGS_KEEP = 512

    def _deregister(self, identity, reason):
        worker = self._workers.pop(identity, None)
        self._worker_obs.pop(identity, None)
        self._peer_dir.drop(identity)
        if worker is None:
            return
        job = self._jobs.get(worker.job_id)
        if job is not None:
            job.workers.discard(identity)
            # remember the binding: if this worker resurfaces (it was
            # stalled, not dead) it must re-bind HERE — it still runs
            # this job's spec
            self._lapsed_bindings[identity] = worker.job_id
            while len(self._lapsed_bindings) > self._LAPSED_BINDINGS_KEEP:
                self._lapsed_bindings.popitem(last=False)
        now = time.monotonic()
        reventilated = 0
        for item_id in worker.inflight:
            entry = self._inflight.pop(item_id, None)
            if entry is None or item_id in self._done:
                continue
            # From here the item can complete twice (ghost + reassigned
            # copy); only such items need completion dedup.
            self._risky_ids.add(item_id)
            reventilated += 1
            trace_entry = self._trace_ctx.get(item_id)
            if trace_entry is not None:
                tracing.record_instant(
                    'reventilate', trace_entry.ctx, 'dispatcher',
                    worker=identity.decode('utf-8', 'replace'),
                    reason=reason)
            # every re-ventilation charges the item's retry budget: a
            # row-group that deterministically kills its worker runs out
            # of budget and quarantines instead of crash-looping the
            # whole fleet forever (docs/service.md, failure semantics)
            self._record_failure(
                item_id, entry[1],
                'worker %s %s' % (identity.decode('utf-8', 'replace'),
                                  reason),
                None, now)
        self._reventilated_count += reventilated
        if reventilated and not metrics_disabled():
            get_registry().counter(SERVICE_REVENTILATED).inc(reventilated)
        self._update_fleet_gauges()
        logger.warning('Worker %s deregistered (%s); re-ventilated %d '
                       'in-flight item(s)', identity, reason, reventilated)
