"""The standing decode service: the daemonized dispatcher and its client
(counterpart of ``petastorm_tpu/service/daemon.py``).

* :class:`ServiceDaemon` is the standing process (``python -m
  petastorm_tpu_torch.service``): a multi-job
  :class:`~petastorm_tpu_torch.service.dispatcher.Dispatcher` (job registry,
  leases, per-job credit, admission control) and a
  :class:`~petastorm_tpu_torch.service.supervisor.WorkerSupervisor`
  (replacement, recruitment, release, circuit breaker). SIGTERM drains:
  registered jobs finish while new ones get a retryable BUSY; a second
  signal stops hard. With ``PETASTORM_TPU_OBS_PORT`` set it serves
  ``/health`` (jobs, leases, breakers) and ``/report`` (fleet view and the
  scaling-decision log).
* :class:`DaemonClientPool` is the consumer side, with the pool contract of
  :class:`~petastorm_tpu_torch.service.service_pool.ServicePool`, so
  ``reader_pool_type='service'`` with ``PETASTORM_TPU_SERVICE_DAEMON`` set
  (or a pool instance) reads through a shared standing fleet.

Exactly once over an unreliable control plane, on the client side:

* every ventilated item carries a client-side id, echoed on every RESULT
  frame;
* an item's result frames are buffered until their **marker**, so a daemon
  that dies mid-delivery leaves nothing half delivered;
* on daemon loss (heartbeat-ack silence, ``JOB_EXPIRED``, or a new
  incarnation token) the client re-registers its job under the same
  idempotency key and re-submits exactly the items its own accounting says
  were never markered; late duplicates of a re-submitted id are dropped.

The daemon and its fleet decode on the host: the CLI hides the GPUs
(``CUDA_VISIBLE_DEVICES=''``) and the supervisor spawns its worker servers
the same way. The frames are the reference's, so a port client reads from a
JAX daemon and a JAX client from a port daemon.
"""

import collections
import logging
import os
import queue
import signal
import threading
import time
import uuid

from petastorm_tpu_torch.errors import ServiceWedgedError
from petastorm_tpu_torch.serializers import PickleSerializer
from petastorm_tpu_torch.service import protocol as proto
from petastorm_tpu_torch.service.dispatcher import Dispatcher
from petastorm_tpu_torch.service.supervisor import WorkerSupervisor
from petastorm_tpu_torch.telemetry import count_swallowed, knobs

logger = logging.getLogger(__name__)

_POLL_INTERVAL_S = 0.05
_NET_POLL_MS = 50
_BIND_TIMEOUT_S = 10.0
_JOIN_TIMEOUT_S = 10.0
_REGISTER_RESEND_S = 1.0
_BUSY_BACKOFF_BASE_S = 0.25
_BUSY_BACKOFF_CAP_S = 5.0
#: fleet-size hint for the ventilator before the first heartbeat-ack
#: status arrives (mirrors ServicePool's hint)
_WORKERS_COUNT_HINT = 4


class ServiceDaemon:
    """The standing control plane: dispatcher + supervisor, one process.

    :param endpoint: ``tcp://host:port`` to bind (port 0 = random; the
        resolved address is :attr:`endpoint` after :meth:`start`).
    :param initial_workers: supervisor fleet size at boot.
    :param supervise: False runs a daemon with NO spawned fleet — for
        externally-managed worker servers (k8s, systemd) pointing their
        ``--endpoint`` here; replacement/recruitment is then the
        external manager's job.
    """

    def __init__(self, endpoint, initial_workers=1, min_workers=None,
                 max_workers=None, heartbeat_interval_s=1.0,
                 liveness_timeout_s=None, max_inflight_per_worker=2,
                 max_retries=None, retry_backoff_s=None, max_jobs=None,
                 lease_s=None, supervise=True, supervisor_tick_s=None,
                 spawn=None, seed_state=None):
        self._stop_event = threading.Event()
        self._heartbeat_interval_s = heartbeat_interval_s
        self._liveness_timeout_s = (liveness_timeout_s
                                    if liveness_timeout_s is not None
                                    else 4.0 * heartbeat_interval_s)
        # seed_state: a promoted standby's replicated registry snapshot
        # (docs/service.md, "High availability") — job identities and
        # QoS params survive the failover; items re-ventilate
        self.dispatcher = Dispatcher(
            endpoint, None, None, self._stop_event,
            heartbeat_interval_s=heartbeat_interval_s,
            liveness_timeout_s=self._liveness_timeout_s,
            max_inflight_per_worker=max_inflight_per_worker,
            max_retries=max_retries, retry_backoff_s=retry_backoff_s,
            standing=True, max_jobs=max_jobs, default_lease_s=lease_s,
            seed_state=seed_state)
        self._initial_workers = initial_workers
        self._min_workers = min_workers
        self._max_workers = max_workers
        self._supervise = supervise
        self._supervisor_tick_s = (supervisor_tick_s
                                   if supervisor_tick_s is not None
                                   else heartbeat_interval_s)
        self._spawn = spawn
        self.supervisor = None
        self._dispatcher_thread = None
        self._obs_mount = None
        self._signals = 0

    @property
    def endpoint(self):
        return self.dispatcher.endpoint

    def start(self):
        if self._dispatcher_thread is not None:
            raise RuntimeError('ServiceDaemon already started')
        self._dispatcher_thread = threading.Thread(
            target=self.dispatcher.run, daemon=True,
            name='petastorm-tpu-torch-service-daemon-dispatcher')
        self._dispatcher_thread.start()
        self.dispatcher.wait_bound(_BIND_TIMEOUT_S)
        if self._supervise:
            self.supervisor = WorkerSupervisor(
                self.dispatcher, self.dispatcher.endpoint,
                initial_workers=self._initial_workers,
                min_workers=self._min_workers,
                max_workers=self._max_workers,
                tick_s=self._supervisor_tick_s,
                heartbeat_interval_s=self._heartbeat_interval_s,
                spawn=self._spawn)
            self.supervisor.start()
        from petastorm_tpu_torch.telemetry import obs_server
        self._obs_mount = obs_server.mount(
            'service-daemon', health=self.health, report=self.report)
        logger.info('Service daemon up at %s (supervised fleet: %s)',
                    self.dispatcher.endpoint,
                    self._initial_workers if self._supervise
                    else 'external')

    def health(self):
        doc = self.dispatcher.health()
        # HA role: a ServiceDaemon is always the serving head; the warm
        # mirror is a StandbyDaemon whose /health says 'standby' (then
        # 'promoting' / 'primary' as it takes over)
        doc['role'] = 'primary'
        if self.supervisor is not None:
            doc['supervisor'] = self.supervisor.status()
        if doc.get('qos'):
            # per-job SLO view: while an error budget burns, jobs starved
            # below their declared share are flagged raise_weight and
            # over-share jobs lower_weight — advisory, the operator (or a
            # rebinding loop) acts on it
            from petastorm_tpu_torch.telemetry import slo
            doc['slo_advice'] = slo.qos_weight_advice(doc['qos'])
        return doc

    def report(self):
        doc = {'fleet': self.dispatcher.fleet_view(),
               'role': 'primary'}
        if self.supervisor is not None:
            doc['scaling_decisions'] = self.supervisor.decisions()
        return doc

    def begin_drain(self):
        self.dispatcher.begin_drain()

    @property
    def drained(self):
        """True once a draining daemon has no registered jobs left."""
        return self.dispatcher.active_jobs() == 0

    def stop(self):
        self._stop_event.set()
        if self.supervisor is not None:
            self.supervisor.stop()
        if self._obs_mount is not None:
            self._obs_mount.close()
        if self._dispatcher_thread is not None:
            # run() broadcasts STOP to every registered worker on its
            # way out
            self._dispatcher_thread.join(_JOIN_TIMEOUT_S)
            self._dispatcher_thread = None

    # -- the daemon main loop (CLI entry) ------------------------------------

    def _on_signal(self, signum, frame):
        self._signals += 1
        if self._signals == 1:
            logger.warning('Signal %s: draining (in-flight jobs finish; '
                           'new jobs get BUSY; signal again to stop '
                           'hard)', signum)
            self.begin_drain()
        else:
            logger.warning('Signal %s again: stopping hard', signum)
            self._stop_event.set()

    def run_forever(self, install_signals=True, drain_poll_s=0.2):
        """Serve until SIGTERM/SIGINT drains the registry empty (or a
        second signal forces a hard stop). The CLI's body."""
        if install_signals:
            signal.signal(signal.SIGTERM, self._on_signal)
            signal.signal(signal.SIGINT, self._on_signal)
        try:
            while not self._stop_event.is_set():
                if self.dispatcher.fatal_error is not None:
                    raise self.dispatcher.fatal_error
                if self.dispatcher.draining and self.drained:
                    logger.info('Drained: no jobs left; exiting')
                    break
                time.sleep(drain_poll_s)
        finally:
            self.stop()


class DaemonClientPool:
    """Client pool registering one job with a standing service daemon.

    Implements the local pools' contract, so the reader and
    ``make_torch_loader`` are unchanged — the decode fleet is simply *shared* and *standing*.
    The network loop owns the DEALER socket on its own thread; consumer
    threads interact through the bounded results queue and counters.
    """

    def __init__(self, endpoint=None, results_queue_size=50,
                 serializer=None, heartbeat_interval_s=1.0,
                 lease_s=None, connect_timeout_s=30.0,
                 ack_timeout_s=None, poison_policy='raise',
                 read_deadline_s=None, name=None, weight=None,
                 priority=None):
        """
        :param endpoint: the daemon's ``tcp://`` address (default: the
            ``PETASTORM_TPU_SERVICE_DAEMON`` knob).
        :param lease_s: job lease the daemon applies — the client goes
            this silent (no SUBMIT, no heartbeat) and the job is
            reclaimed (default: the daemon's
            ``PETASTORM_TPU_SERVICE_LEASE_S``).
        :param connect_timeout_s: how long ``start()`` (and any later
            re-registration after a daemon loss) retries REGISTER_JOB —
            including through retryable BUSY answers — before failing.
        :param ack_timeout_s: heartbeat-ack silence after which the
            daemon is presumed dead and re-registration begins
            (default ``max(10 × heartbeat_interval, 10s)``).
        :param weight: QoS fair-share weight the job registers with (a
            weight-3 job targets 3x the workers of a weight-1
            co-tenant); default: the ``PETASTORM_TPU_SERVICE_JOB_WEIGHT``
            knob, else the daemon's default of 1.
        :param priority: QoS priority tier (strict admission: a higher
            tier with pending work preempts workers from lower tiers);
            default: the ``PETASTORM_TPU_SERVICE_JOB_PRIORITY`` knob,
            else 0.
        """
        if poison_policy not in ('raise', 'skip'):
            raise ValueError("poison_policy must be 'raise' or 'skip'; "
                             'got %r' % (poison_policy,))
        endpoint = endpoint or knobs.get_str('PETASTORM_TPU_SERVICE_DAEMON')
        if not endpoint:
            raise ValueError('DaemonClientPool needs a daemon endpoint '
                             '(argument or PETASTORM_TPU_SERVICE_DAEMON)')
        self._endpoint = endpoint
        self._results_queue_size = results_queue_size
        self._serializer = serializer or PickleSerializer()
        self._heartbeat_interval_s = heartbeat_interval_s
        self._lease_s = lease_s
        self._connect_timeout_s = connect_timeout_s
        self._ack_timeout_s = (ack_timeout_s if ack_timeout_s is not None
                               else max(10 * heartbeat_interval_s, 10.0))
        self.poison_policy = poison_policy
        self._read_deadline_s = (read_deadline_s
                                 if read_deadline_s is not None
                                 else knobs.get_float(
                                     'PETASTORM_TPU_SERVICE_READ'
                                     '_DEADLINE_S', 300.0, floor=0.0))
        self._name = name or 'client-%d' % os.getpid()
        # QoS params ride the REGISTER_JOB params dict; knob defaults so
        # a Reader-embedded client is governable without code changes
        self._weight = (float(weight) if weight is not None
                        else knobs.get_float(
                            'PETASTORM_TPU_SERVICE_JOB_WEIGHT', 0.0,
                            floor=0.0)) or None
        self._priority = (int(priority) if priority is not None
                          else knobs.get_int(
                              'PETASTORM_TPU_SERVICE_JOB_PRIORITY', 0))
        #: decode fingerprint for cache-aware placement, derived from
        #: the job's worker args at start()
        self._fingerprint = None
        #: idempotency key: a re-sent REGISTER_JOB (lost JOB_OK, socket
        #: reset) answers with the SAME job instead of a duplicate
        self._client_key = uuid.uuid4().hex

        self.poisoned_items = []
        self._results_queue = queue.Queue(maxsize=results_queue_size)
        self._stop_event = threading.Event()
        self._lock = threading.Lock()
        self._ventilated_items = 0
        self._processed_items = 0
        #: markers consumed by get_results — the credit the heartbeat
        #: reports back, which is what lets the daemon bound what it
        #: buffers toward this client
        self._acked = 0
        #: _acked snapshot at the LAST successful registration: each
        #: registration creates a fresh daemon-side job whose
        #: markers_sent starts at 0, so the heartbeat must report the
        #: markers consumed AGAINST THAT JOB (lifetime totals would
        #: leave the new job's credit gate permanently open)
        self._acked_base = 0
        self._item_seq = 0
        #: client item id -> work payload, until its marker arrives:
        #: exactly the set a daemon restart requires re-submitting
        self._outstanding = collections.OrderedDict()
        self._submit_queue = collections.deque()
        self._spec_payload = None
        #: complete-item entries awaiting bounded-queue space. Survives
        #: re-registration: its items were popped from _outstanding (so
        #: they will never be re-submitted) and MUST reach the consumer.
        self._delivery = collections.deque()
        self._registered = threading.Event()
        self._job_id = None
        self._daemon_token = None
        self._job_identity = None
        self._status = {}
        self._reregistrations = 0
        self._net_thread = None
        self._ventilator = None
        self._error = None
        self._joined = False
        self._obs_mount = None
        self._last_progress = None

    # -- pool contract -------------------------------------------------------

    @property
    def workers_count(self):
        """This job's slice of the standing fleet (the ventilator
        re-reads it for its in-flight bound); the whole-fleet count
        before the first status arrives."""
        status = self._status
        count = status.get('job_workers') or status.get('workers_alive')
        return count or _WORKERS_COUNT_HINT

    @property
    def job_id(self):
        return self._job_id

    def start(self, worker_class, worker_args=None, ventilator=None,
              start_ventilator=True):
        if self._net_thread is not None:
            raise RuntimeError('DaemonClientPool already started')
        self._spec_payload = proto.dump_job_spec(worker_class, worker_args,
                                                 self._serializer)
        # cache-aware placement: stamp the registration with the SAME
        # fingerprint the worker servers advertise for their decoded
        # caches (one helper on both sides — placement.py), so the
        # dispatcher can bind this job to a warm host first
        from petastorm_tpu_torch.service.placement import placement_fingerprint
        self._fingerprint = placement_fingerprint(worker_args)
        self._net_thread = threading.Thread(
            target=self._net_loop, daemon=True, name='petastorm-tpu-torch-service-daemon-client')
        self._net_thread.start()
        deadline = time.monotonic() + self._connect_timeout_s + 1.0
        while not self._registered.wait(_POLL_INTERVAL_S):
            if self._error is not None:
                self.stop()
                self.join()
                raise self._error
            if time.monotonic() > deadline:
                self.stop()
                self.join()
                raise RuntimeError(
                    'No job registration with the service daemon at %s '
                    'within %.1fs (is the daemon running? is it '
                    'draining?)' % (self._endpoint,
                                    self._connect_timeout_s))
        # the net loop sets _registered on its way OUT too (so a failed
        # registration can't leave start() waiting forever) — the set
        # event alone is not success
        if self._error is not None or self._job_id is None:
            self.stop()
            self.join()
            raise (self._error if self._error is not None
                   else RuntimeError('Daemon-client network loop exited '
                                     'before registering a job'))
        from petastorm_tpu_torch.telemetry import obs_server
        self._obs_mount = obs_server.mount('service-daemon-client',
                                           health=self.client_health)
        self._ventilator = ventilator
        if ventilator is not None and start_ventilator:
            ventilator.start()

    def ventilate(self, *args, **kwargs):
        payload = proto.dump_work_item(args, kwargs)
        with self._lock:
            self._ventilated_items += 1
            cid = self._item_seq
            self._item_seq += 1
            self._outstanding[cid] = payload
            self._submit_queue.append(cid)

    def get_results(self, timeout=None):
        from petastorm_tpu_torch.service.service_pool import consume_results
        return consume_results(self, timeout, self._lock,
                               on_marker=self._on_marker,
                               wedge_error=self._wedge_error)

    def _on_marker(self):
        """Shared-loop hook, runs UNDER ``self._lock`` with the
        processed-item increment: count the marker into the ack credit
        the heartbeat reports back to the daemon."""
        self._acked += 1

    def _note_poisoned(self, info):
        """Shared ``poison_policy`` semantics with the embedded pool
        (:func:`~petastorm_tpu_torch.service.service_pool.apply_poison_policy`
        is the one implementation — the two topologies cannot drift)."""
        from petastorm_tpu_torch.service.service_pool import apply_poison_policy
        apply_poison_policy(self, info, "the daemon's /health")

    def _wedge_error(self, waited, inflight):
        """The daemon client's wedge diagnosis — carrying the last
        daemon status this client saw."""
        return ServiceWedgedError(
            'Daemon-backed service read made no progress for %.1fs with '
            '%d item(s) outstanding (deadline PETASTORM_TPU_SERVICE_READ'
            '_DEADLINE_S=%.1fs). Last daemon status: %r'
            % (waited, inflight, self._read_deadline_s, self._status),
            fleet=dict(self._status))

    def stop(self):
        if self._ventilator is not None:
            self._ventilator.stop()
        self._stop_event.set()

    def join(self):
        if not self._stop_event.is_set():
            raise RuntimeError('Must call stop() before join()')
        if self._joined:
            return
        self._joined = True
        if self._obs_mount is not None:
            self._obs_mount.close()
        if self._net_thread is not None:
            self._net_thread.join(_JOIN_TIMEOUT_S)

    @property
    def diagnostics(self):
        with self._lock:
            ventilated = self._ventilated_items
            processed = self._processed_items
        status = dict(self._status)
        return {
            'items_ventilated': ventilated,
            'items_processed': processed,
            'items_inflight': ventilated - processed,
            'output_queue_size': self._results_queue.qsize(),
            'job_id': self._job_id,
            'daemon_endpoint': self._endpoint,
            'daemon_status': status,
            'reregistrations': self._reregistrations,
            'workers_alive': status.get('workers_alive', 0),
            'workers_registered': status.get('workers_registered', 0),
            'items_pending': status.get('pending', 0),
        }

    def client_health(self):
        return self.diagnostics

    @property
    def results_qsize(self):
        return self._results_queue.qsize()

    # -- network loop (owns the DEALER socket) -------------------------------

    def _net_loop(self):
        import zmq
        try:
            while not self._stop_event.is_set():
                context = zmq.Context()
                sock = context.socket(zmq.DEALER)
                sock.setsockopt(zmq.LINGER, 500)
                sock.connect(self._endpoint)
                try:
                    if not self._register_job(sock):
                        return
                    self._serve_job(sock)
                finally:
                    sock.close(linger=500)
                    context.term()
        except Exception as e:  # noqa: BLE001 - surfaced to the consumer
            logger.exception('Daemon-client network loop died')
            if self._error is None:
                self._error = e
        finally:
            self._registered.set()  # unblock a start() still waiting

    def _register_job(self, sock):
        """REGISTER_JOB with resend + BUSY backoff until JOB_OK (True) or
        the connect deadline / stop (False, with ``self._error`` set on
        timeout)."""
        import zmq
        params = {'key': self._client_key, 'name': self._name,
                  'credit': self._results_queue_size}
        if self._lease_s:
            params['lease_s'] = self._lease_s
        if self._weight:
            params['weight'] = self._weight
        if self._priority:
            params['priority'] = self._priority
        if self._fingerprint:
            params['fingerprint'] = self._fingerprint
        deadline = time.monotonic() + self._connect_timeout_s
        busy_backoff = _BUSY_BACKOFF_BASE_S
        next_send = 0.0
        while not self._stop_event.is_set():
            now = time.monotonic()
            if now > deadline:
                if self._error is None:
                    self._error = RuntimeError(
                        'Service daemon at %s did not admit job %r '
                        'within %.1fs' % (self._endpoint, self._name,
                                          self._connect_timeout_s))
                return False
            if now >= next_send:
                sock.send_multipart([proto.MSG_REGISTER_JOB,
                                     self._spec_payload,
                                     proto.dump_json_params(params)])
                next_send = now + _REGISTER_RESEND_S
            if not sock.poll(_NET_POLL_MS):
                continue
            try:
                frames = sock.recv_multipart(zmq.NOBLOCK)
            except zmq.Again:
                continue
            if frames[0] == proto.MSG_JOB_OK:
                self._job_id = int(frames[1])
                self._daemon_token = frames[2] if len(frames) > 2 else None
                identity = (self._daemon_token, self._job_id)
                if identity != self._job_identity:
                    # a genuinely FRESH daemon-side job (its markers_sent
                    # starts at 0): re-base the ack clock so heartbeats
                    # report markers consumed against THIS job. The
                    # same-(token, id) case is the daemon deduping our
                    # key after a socket blip — the job kept its
                    # counters, so the base must keep too (re-basing
                    # there would under-report acks and wedge the gate).
                    # Markers still buffered toward the consumer
                    # (delivery deque + bounded queue) belong to the
                    # OLD job: they join the base, or their eventual
                    # consumption would count as acks against a job
                    # that never sent them and loosen its credit gate.
                    self._job_identity = identity
                    in_delivery = sum(1 for e in self._delivery
                                      if e[0] == 'marker')
                    with self._results_queue.mutex:
                        in_queue = sum(1 for e in self._results_queue.queue
                                       if e[0] == 'marker')
                    with self._lock:
                        self._acked_base = (self._acked + in_delivery
                                            + in_queue)
                self._registered.set()
                logger.info('Registered job %d (%s) with daemon %s',
                            self._job_id, self._name, self._endpoint)
                return True
            if frames[0] == proto.MSG_BUSY:
                info = proto.load_json_params(frames[1]
                                              if len(frames) > 1 else b'')
                logger.warning('Daemon busy (%s); retrying in %.2fs',
                               info.get('reason', '?'), busy_backoff)
                # back off instead of erroring: BUSY is retryable by
                # contract (drain / admission control)
                next_send = now + busy_backoff
                busy_backoff = min(busy_backoff * 2, _BUSY_BACKOFF_CAP_S)
            # other frames: stale RESULT traffic from a previous
            # incarnation of this socket — meaningless here

    def _resubmit_outstanding(self, sock):
        """After (re-)registration: re-send every item our accounting
        says was never markered. Late duplicate deliveries (the old
        daemon's copy racing the new submission) are dropped by the
        unknown-cid check in :meth:`_serve_job`."""
        with self._lock:
            pending = list(self._outstanding.items())
            self._submit_queue.clear()
        for cid, payload in pending:
            sock.send_multipart([proto.MSG_SUBMIT, b'%d' % self._job_id,
                                 b'%d' % cid, payload])
        if pending:
            logger.info('Re-submitted %d outstanding item(s) to job %d',
                        len(pending), self._job_id)

    def _serve_job(self, sock):
        """One job session: pump submits, heartbeats and results until
        the daemon is lost (→ return to re-register) or we stop."""
        import zmq
        self._resubmit_outstanding(sock)
        partial = {}          # cid -> [delivery entries]
        delivery = self._delivery
        last_hb_sent = 0.0
        last_ack = time.monotonic()
        while not self._stop_event.is_set():
            now = time.monotonic()
            if now - last_hb_sent >= self._heartbeat_interval_s:
                last_hb_sent = now
                with self._lock:
                    acked = max(0, self._acked - self._acked_base)
                sock.send_multipart([proto.MSG_CLIENT_HB,
                                     b'%d' % self._job_id, b'%d' % acked])
            # drain freshly-ventilated items
            while True:
                with self._lock:
                    if not self._submit_queue:
                        break
                    cid = self._submit_queue.popleft()
                    payload = self._outstanding.get(cid)
                if payload is not None:
                    sock.send_multipart([proto.MSG_SUBMIT,
                                         b'%d' % self._job_id,
                                         b'%d' % cid, payload])
            # feed buffered complete items into the bounded queue
            # (non-blocking: this thread must keep heartbeating through
            # a consumer stall; the daemon's credit gate bounds what can
            # pile up here)
            while delivery:
                try:
                    self._results_queue.put_nowait(delivery[0])
                except queue.Full:
                    break
                delivery.popleft()
            if sock.poll(_NET_POLL_MS):
                while True:
                    try:
                        frames = sock.recv_multipart(zmq.NOBLOCK)
                    except zmq.Again:
                        break
                    verdict = self._handle_frames(frames, partial,
                                                  delivery)
                    if verdict == 'reregister':
                        self._reregistrations += 1
                        return
                    if verdict == 'ack':
                        last_ack = time.monotonic()
            if time.monotonic() - last_ack > self._ack_timeout_s:
                logger.warning('No daemon heartbeat ack for %.1fs; '
                               're-registering job', self._ack_timeout_s)
                self._reregistrations += 1
                return
        # clean goodbye so the daemon reclaims the job NOW instead of at
        # lease expiry
        try:
            if self._job_id is not None:
                sock.send_multipart([proto.MSG_JOB_GONE,
                                     b'%d' % self._job_id])
        except Exception:  # noqa: BLE001 - daemon may be gone
            count_swallowed('daemon-client-goodbye')

    def _handle_frames(self, frames, partial, delivery):
        """One inbound message; returns 'reregister', 'ack' or None."""
        msg = frames[0]
        if msg == proto.MSG_RESULT:
            kind = frames[1]
            try:
                cid = int(frames[2])
            except ValueError:
                return None
            with self._lock:
                known = cid in self._outstanding
            if not known:
                # late duplicate from a pre-restart copy of a
                # re-submitted item (its first delivery already popped
                # the id) — dropping it is what keeps re-submission
                # duplicate-free
                logger.debug('Dropping duplicate/unknown result for '
                             'item %d', cid)
                return None
            if kind == b'result':
                partial.setdefault(cid, []).append(('result', frames[3]))
            elif kind == b'error':
                partial.setdefault(cid, []).append(
                    ('error', proto.load_exception(frames[3])))
            elif kind == b'poisoned':
                partial.setdefault(cid, []).append(
                    ('poisoned', proto.load_poisoned_info(frames[3])))
            elif kind == b'marker':
                # the item is COMPLETE: release its buffered entries +
                # the marker atomically — a daemon lost mid-item leaves
                # nothing half-delivered
                entries = partial.pop(cid, [])
                with self._lock:
                    self._outstanding.pop(cid, None)
                delivery.extend(entries)
                delivery.append(('marker', cid))
            return None
        if msg == proto.MSG_CLIENT_HB_ACK:
            token = frames[1] if len(frames) > 1 else None
            self._status = proto.load_json_params(frames[2]
                                                  if len(frames) > 2
                                                  else b'')
            if token and self._daemon_token and token != self._daemon_token:
                # a NEW daemon incarnation answered on this endpoint:
                # our job id lives in a dead registry — re-register
                logger.warning('Daemon incarnation changed; '
                               're-registering job')
                return 'reregister'
            return 'ack'
        if msg == proto.MSG_JOB_EXPIRED:
            logger.warning('Daemon reports job expired/unknown; '
                           're-registering')
            return 'reregister'
        if msg == proto.MSG_BUSY:
            return None  # stale refusal from a raced registration
        return None
