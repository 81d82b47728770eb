"""ServicePool: the decode service's client-side pool (counterpart of
``petastorm_tpu/service/service_pool.py``).

Implements the pool contract of
:class:`~petastorm_tpu_torch.workers.thread_pool.ThreadPool` and
:class:`~petastorm_tpu_torch.workers.process_pool.ProcessPool`
(``start / ventilate / get_results / stop / join / diagnostics``), so
``make_batch_reader(..., reader_pool_type='service')`` and
``make_torch_loader(...)`` work unchanged while the decode fleet lives in
other processes or on other hosts.

Two deployments:

* **External fleet**: pass ``endpoint='tcp://0.0.0.0:7777'`` (or set
  ``PETASTORM_TPU_SERVICE_DISPATCHER``); the pool hosts the dispatcher there
  and worker servers started anywhere (``python -m
  petastorm_tpu_torch.service.worker_server --endpoint ...``) register with
  it, before or after the pool starts.
* **Local fleet**: pass ``spawn_local_workers=N``; the pool binds a random
  loopback port and spawns N worker-server processes itself (spawned, never
  forked, with ``CUDA_VISIBLE_DEVICES=''``), reaping them on ``join()``.

Back-pressure is layered: the consumer-facing results queue is bounded
(``results_queue_size``), the dispatcher stops delivering completions when
it is full, and each worker server holds at most
``max_inflight_per_worker`` assigned items, so a stalled consumer quiesces
the whole fleet instead of buffering without bound.
"""

import logging
import os
import queue
import threading
import time

from petastorm_tpu_torch.errors import RowGroupPoisonedError, ServiceWedgedError
from petastorm_tpu_torch.serializers import PickleSerializer
from petastorm_tpu_torch.service import protocol as proto
from petastorm_tpu_torch.service.dispatcher import Dispatcher
from petastorm_tpu_torch.telemetry import knobs, tracing
from petastorm_tpu_torch.workers import (
    EmptyResultError, TimeoutWaitingForResultError,
)

logger = logging.getLogger(__name__)

_POLL_INTERVAL_S = 0.05
_BIND_TIMEOUT_S = 10.0
_JOIN_TIMEOUT_S = 10.0
# Ventilator-sizing hint before any worker has registered (external fleets
# announce themselves only at runtime).
_WORKERS_COUNT_HINT = 4


def apply_poison_policy(pool, info, health_owner):
    """Shared consumer-side handling of one quarantined-item delivery —
    the ONE implementation of ``poison_policy`` semantics for both
    service pool flavors (the embedded :class:`ServicePool` and the
    standing service's
    :class:`~petastorm_tpu_torch.service.daemon.DaemonClientPool`), so the
    policy can never drift between topologies.

    ``'skip'`` records the descriptor on ``pool.poisoned_items`` and
    reads on (the item's marker keeps the accounting exact, so the
    epoch ends with the loss reported, not wedged); ``'raise'``
    surfaces the poison — the original worker exception when the
    failures carried one, else :class:`RowGroupPoisonedError` — after
    stopping the pool. ``health_owner`` names where the operator finds
    the quarantine ledger (the error message's pointer)."""
    descriptor = {k: (repr(v) if k == 'error' and v is not None else v)
                  for k, v in info.items()}
    pool.poisoned_items.append(descriptor)
    if pool.poison_policy == 'skip':
        logger.warning(
            'Skipping quarantined item %s after %s attempt(s) (%s) — '
            "poison_policy='skip'", info.get('item_id'),
            info.get('attempts'), info.get('reason'))
        return
    error = info.get('error')
    if error is None:
        error = RowGroupPoisonedError(
            'Service work item %s was quarantined after %s failed '
            'attempt(s) (%s). Its workers died without reporting an '
            'exception; see %s `poisoned` list. '
            "Pass poison_policy='skip' to read past quarantined "
            'row-groups.' % (info.get('item_id'), info.get('attempts'),
                             info.get('reason'), health_owner),
            info=descriptor)
    pool._error = error
    pool.stop()
    pool.join()
    raise pool._error


def consume_results(pool, timeout, lock, check_fatal=None, on_marker=None,
                    wedge_error=None):
    """The ONE consumer read loop of the service pools (:class:`ServicePool`
    and :class:`~petastorm_tpu_torch.service.daemon.DaemonClientPool`),
    factored the way :func:`apply_poison_policy` is, so the wedge clock,
    the no-progress deadline and the marker/poison/error handling can
    never drift between topologies.

    ``pool`` provides the shared surface: ``_error``, ``_results_queue``,
    ``_stop_event``, ``_ventilated_items``/``_processed_items`` (guarded
    by ``lock``), ``_ventilator``, ``_serializer``, ``_last_progress``,
    ``_read_deadline_s``, ``_note_poisoned`` and ``stop``/``join``.
    ``check_fatal()`` (optional) runs on every empty poll and returns an
    exception to surface, or None — the embedded pool's dispatcher-death
    / dead-local-fleet probe. ``on_marker()`` (optional) runs UNDER
    ``lock`` together with the processed-item increment — the daemon
    client's ack credit. ``wedge_error(waited_s, inflight)`` builds the
    topology-specific :class:`~petastorm_tpu_torch.errors.ServiceWedgedError`
    when the no-progress deadline trips.
    """
    deadline = None if timeout is None else time.monotonic() + timeout
    # the wedge clock measures time blocked INSIDE this call: a consumer
    # pausing between calls (recompile, checkpoint save) is not service
    # starvation and must not trip the deadline on re-entry
    pool._last_progress = time.monotonic()
    while True:
        if pool._error is not None:
            raise pool._error
        try:
            kind, payload = pool._results_queue.get(
                timeout=_POLL_INTERVAL_S)
        except queue.Empty:
            if pool._stop_event.is_set():
                raise EmptyResultError()
            fatal = check_fatal() if check_fatal is not None else None
            if fatal is not None:
                pool._error = fatal
                pool.stop()
                pool.join()
                raise pool._error
            with lock:
                all_done = (pool._ventilated_items
                            == pool._processed_items)
            if all_done and (pool._ventilator is None
                             or pool._ventilator.completed()):
                raise EmptyResultError()
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutWaitingForResultError()
            if not all_done:
                _check_no_progress(pool, lock, wedge_error)
            continue
        pool._last_progress = time.monotonic()
        if kind == 'marker':
            with lock:
                pool._processed_items += 1
                if on_marker is not None:
                    on_marker()
            if pool._ventilator is not None:
                pool._ventilator.processed_item()
            continue
        if kind == 'poisoned':
            pool._note_poisoned(payload)
            continue
        if kind == 'error':
            pool._error = payload
            pool.stop()
            pool.join()
            raise pool._error
        return pool._serializer.deserialize(payload)


def _check_no_progress(pool, lock, wedge_error):
    """Raise the diagnosable wedge error when no entry reached this
    consumer for ``read_deadline_s`` with work outstanding — instead of
    a silent hang (lost WORK frame, dead-but-undetected workers, network
    partition, dead daemon)."""
    if not pool._read_deadline_s or wedge_error is None:
        return
    waited = time.monotonic() - pool._last_progress
    if waited <= pool._read_deadline_s:
        return
    with lock:
        inflight = pool._ventilated_items - pool._processed_items
    error = wedge_error(waited, inflight)
    pool._error = error
    pool.stop()
    pool.join()
    raise error


class ServicePool:
    """Client pool backed by remote worker servers over ``tcp://``."""

    def __init__(self, endpoint=None, expected_workers=None,
                 spawn_local_workers=None, results_queue_size=50,
                 serializer=None, heartbeat_interval_s=1.0,
                 liveness_timeout_s=None, connect_timeout_s=30.0,
                 no_workers_timeout_s=30.0, max_inflight_per_worker=2,
                 worker_ack_timeout_s=None, max_retries=None,
                 retry_backoff_s=None, poison_policy='raise',
                 read_deadline_s=None):
        """
        :param endpoint: ``tcp://host:port`` the dispatcher binds (port 0 =
            random). Default: random loopback port (local fleet mode).
        :param expected_workers: block ``start()`` until this many worker
            servers registered (default: the spawned count, else 1).
        :param spawn_local_workers: spawn this many localhost worker-server
            processes owned by this pool.
        :param liveness_timeout_s: heartbeat silence after which a worker is
            declared dead and its items re-ventilated (default 4 heartbeat
            intervals).
        :param connect_timeout_s: how long ``start()`` waits for the
            expected registrations before failing.
        :param no_workers_timeout_s: runtime failure threshold — work
            outstanding but zero live workers for this long.
        :param worker_ack_timeout_s: spawned-fleet only — how long a
            worker server tolerates missing dispatcher heartbeat acks
            before abandoning the job (default: the server's own
            ``max(10 * heartbeat_interval, 10s)``).
        :param max_retries: per-item retry budget, total attempts
            (default ``PETASTORM_TPU_SERVICE_MAX_RETRIES``); an item
            exhausting it is quarantined, not crash-looped.
        :param retry_backoff_s: base of the exponential retry backoff
            (default ``PETASTORM_TPU_SERVICE_RETRY_BACKOFF_S``).
        :param poison_policy: what a quarantined item does to this
            consumer: ``'raise'`` (default — surface the poison; the
            original worker exception when one exists, else
            :class:`~petastorm_tpu_torch.errors.RowGroupPoisonedError`) or
            ``'skip'`` (drop the quarantined item's rows, record it in
            :attr:`poisoned_items`, keep reading — degrade, don't die).
        :param read_deadline_s: ``get_results`` no-progress deadline with
            work outstanding, after which
            :class:`~petastorm_tpu_torch.errors.ServiceWedgedError` (carrying
            the live fleet view) is raised instead of wedging forever
            (default ``PETASTORM_TPU_SERVICE_READ_DEADLINE_S``; 0
            disables).
        """
        if poison_policy not in ('raise', 'skip'):
            raise ValueError("poison_policy must be 'raise' or 'skip'; "
                             'got %r' % (poison_policy,))
        self._endpoint_requested = endpoint or 'tcp://127.0.0.1:0'
        self._expected_workers = expected_workers
        self._spawn_local_workers = spawn_local_workers
        self._results_queue_size = results_queue_size
        self._serializer = serializer or PickleSerializer()
        self._heartbeat_interval_s = heartbeat_interval_s
        self._liveness_timeout_s = (liveness_timeout_s
                                    if liveness_timeout_s is not None
                                    else 4.0 * heartbeat_interval_s)
        self._connect_timeout_s = connect_timeout_s
        self._no_workers_timeout_s = no_workers_timeout_s
        self._max_inflight_per_worker = max_inflight_per_worker
        self._worker_ack_timeout_s = worker_ack_timeout_s
        self._max_retries = max_retries
        self._retry_backoff_s = retry_backoff_s
        self.poison_policy = poison_policy
        self._read_deadline_s = (read_deadline_s
                                 if read_deadline_s is not None
                                 else knobs.get_float(
                                     'PETASTORM_TPU_SERVICE_READ'
                                     '_DEADLINE_S', 300.0, floor=0.0))
        #: quarantine descriptors seen by THIS consumer (poison_policy=
        #: 'skip' keeps reading past them; the reader's report and the
        #: dispatcher /health carry the same records)
        self.poisoned_items = []
        self._last_progress = None

        self._results_queue = queue.Queue(maxsize=results_queue_size)
        self._stop_event = threading.Event()
        self._counter_lock = threading.Lock()
        self._ventilated_items = 0
        self._processed_items = 0
        self._ventilator = None
        self._dispatcher = None
        self._dispatcher_thread = None
        self._local_procs = []
        self._error = None
        self._joined = False
        self._obs_mount = None

    @property
    def workers_count(self):
        """Live fleet size (never below the configured floor). The reader's
        ventilator re-reads this for its in-flight bound, so worker servers
        joining a RUNNING job genuinely raise parallelism — the scale-out
        path autotune_report advises."""
        base = self._spawn_local_workers or self._expected_workers or 0
        registered = (self._dispatcher.registered_workers()
                      if self._dispatcher is not None else 0)
        return max(base, registered) or _WORKERS_COUNT_HINT

    @property
    def dispatcher_endpoint(self):
        """The resolved ``tcp://`` endpoint (after a random-port bind)."""
        return self._dispatcher.endpoint if self._dispatcher else None

    # -- lifecycle ----------------------------------------------------------

    def start(self, worker_class, worker_args=None, ventilator=None,
              start_ventilator=True):
        if self._dispatcher is not None:
            raise RuntimeError('ServicePool already started')
        job_spec = proto.dump_job_spec(worker_class, worker_args,
                                       self._serializer)
        self._dispatcher = Dispatcher(
            self._endpoint_requested, job_spec, self._deliver,
            self._stop_event,
            heartbeat_interval_s=self._heartbeat_interval_s,
            liveness_timeout_s=self._liveness_timeout_s,
            max_inflight_per_worker=self._max_inflight_per_worker,
            no_workers_timeout_s=self._no_workers_timeout_s,
            max_retries=self._max_retries,
            retry_backoff_s=self._retry_backoff_s)
        self._dispatcher_thread = threading.Thread(
            target=self._dispatcher.run, daemon=True,
            name='petastorm-tpu-torch-service-dispatcher')
        self._dispatcher_thread.start()
        self._dispatcher.wait_bound(_BIND_TIMEOUT_S)

        if self._spawn_local_workers:
            self._spawn_workers()
        self._await_registrations()

        # live observability plane: the dispatcher runs in THIS (consumer)
        # process, so its fleet view — per-worker heartbeat summaries on
        # top of the registry's already-merged fleet aggregate — mounts on
        # the same endpoint the reader and the torch loader use
        from petastorm_tpu_torch.telemetry import obs_server
        self._obs_mount = obs_server.mount(
            'service-dispatcher', health=self._dispatcher.health,
            report=self._fleet_report)

        self._ventilator = ventilator
        if ventilator is not None and start_ventilator:
            ventilator.start()

    def _fleet_report(self):
        return {'fleet': self._dispatcher.fleet_view()}

    def _spawn_workers(self):
        from petastorm_tpu_torch.service.worker_server import serve
        from petastorm_tpu_torch.workers.exec_in_new_process import (
            exec_in_new_process,
        )

        for worker_id in range(self._spawn_local_workers):
            proc = exec_in_new_process(
                serve, self._dispatcher.endpoint, worker_id=worker_id,
                heartbeat_interval_s=self._heartbeat_interval_s,
                ack_timeout_s=self._worker_ack_timeout_s,
                parent_pid=os.getpid(), once=True,
                register_timeout_s=self._connect_timeout_s)
            self._local_procs.append(proc)

    def _await_registrations(self):
        need = (self._expected_workers or self._spawn_local_workers or 1)
        deadline = time.monotonic() + self._connect_timeout_s
        while self._dispatcher.registered_workers() < need:
            if self._dispatcher.fatal_error is not None:
                self._abort_startup()
                raise self._dispatcher.fatal_error
            # ANY exit before registration is fatal here — including a
            # clean one (registration window closed, parent-death check):
            # the fleet will never reach the expected size.
            dead = [p.pid for p in self._local_procs if p.poll() is not None]
            if dead:
                self._abort_startup()
                raise RuntimeError(
                    'Service worker server process(es) %s exited during '
                    'startup — see their stderr for the reason' % dead)
            if time.monotonic() > deadline:
                registered = self._dispatcher.registered_workers()
                self._abort_startup()
                raise RuntimeError(
                    'Only %d of %d worker servers registered with the '
                    'dispatcher at %s within %.1fs (workers retry with '
                    'backoff — check endpoint reachability and that the '
                    'servers are running)'
                    % (registered, need, self._dispatcher.endpoint,
                       self._connect_timeout_s))
            time.sleep(_POLL_INTERVAL_S)

    def _abort_startup(self):
        self._stop_event.set()
        if self._dispatcher_thread is not None:
            self._dispatcher_thread.join(_JOIN_TIMEOUT_S)
        self._reap_local_procs()

    # -- data path ----------------------------------------------------------

    def ventilate(self, *args, **kwargs):
        with self._counter_lock:
            self._ventilated_items += 1
        # a traced item's context rides INSIDE the opaque work payload to
        # the worker server; the dispatcher additionally needs it BY item
        # id to stamp its lifecycle instants (dispatch/reventilate/done)
        self._dispatcher.submit(proto.dump_work_item(args, kwargs),
                                trace_ctx=kwargs.get(tracing.TRACE_CTX_KEY))

    def _deliver(self, entry):
        """Dispatcher-thread side of the results queue: NON-BLOCKING put.
        False = momentarily full (the dispatcher backlogs and retries);
        the dispatcher thread must stay free to ack worker heartbeats, so
        a stalled consumer quiesces the fleet instead of starving its
        liveness protocol. On stop the entry is dropped (True): accounting
        no longer matters and the backlog must not pin shutdown."""
        if self._stop_event.is_set():
            return True
        try:
            self._results_queue.put_nowait(entry)
            return True
        except queue.Full:
            return False

    def get_results(self, timeout=None):
        return consume_results(self, timeout, self._counter_lock,
                               check_fatal=self._check_fatal,
                               wedge_error=self._wedge_error)

    def _check_fatal(self):
        """Per-empty-poll fatal probe (shared loop hook): a dispatcher
        fatal error, or every spawned local worker dead with work still
        outstanding."""
        fatal = (self._dispatcher.fatal_error
                 if self._dispatcher else None)
        if fatal is None and self._local_procs and \
                all(p.poll() is not None for p in self._local_procs):
            with self._counter_lock:
                outstanding = (self._ventilated_items
                               != self._processed_items)
            if outstanding:
                fatal = RuntimeError(
                    'All spawned service worker servers died '
                    'unexpectedly: %s'
                    % [p.pid for p in self._local_procs])
        return fatal

    def _note_poisoned(self, info):
        """One quarantined item reached this consumer: apply the
        ``poison_policy`` (shared semantics: :func:`apply_poison_policy`)."""
        apply_poison_policy(self, info, "the dispatcher's /health")

    def _wedge_error(self, waited, inflight):
        """The embedded pool's wedge diagnosis — carrying the live fleet
        view, so the operator sees WHICH failure domain wedged."""
        fleet = {}
        try:
            fleet = self._dispatcher.fleet_view()
        except Exception:  # noqa: BLE001 - diagnosis must not mask itself
            pass
        return ServiceWedgedError(
            'Service read made no progress for %.1fs with %d item(s) '
            'outstanding (deadline PETASTORM_TPU_SERVICE_READ_DEADLINE_S'
            '=%.1fs). Live fleet view: %r'
            % (waited, inflight, self._read_deadline_s, fleet),
            fleet=fleet)

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
        if self._dispatcher_thread is not None:
            # run() broadcasts STOP to every registered worker on its way out
            self._dispatcher_thread.join(_JOIN_TIMEOUT_S)
        self._reap_local_procs()

    def _reap_local_procs(self):
        deadline = time.monotonic() + _JOIN_TIMEOUT_S
        for proc in self._local_procs:
            remaining = max(0.1, deadline - time.monotonic())
            try:
                proc.wait(timeout=remaining)
            except Exception:  # noqa: BLE001 - ignored stop; escalate
                proc.terminate()
                try:
                    proc.wait(timeout=2)
                except Exception:  # noqa: BLE001
                    proc.kill()
                    proc.wait()
        self._local_procs = []

    # -- observability ------------------------------------------------------

    @property
    def diagnostics(self):
        with self._counter_lock:
            ventilated = self._ventilated_items
            processed = self._processed_items
        diag = {
            'items_ventilated': ventilated,
            'items_processed': processed,
            'items_inflight': ventilated - processed,
            'output_queue_size': self._results_queue.qsize(),
        }
        if self._dispatcher is not None:
            diag.update(self._dispatcher.stats())
        else:
            diag.update({'workers_alive': 0, 'workers_registered': 0,
                         'workers_seen': 0, 'items_assigned': 0,
                         'items_pending': 0, 'items_reventilated': 0,
                         'items_duplicate_done': 0, 'items_retried': 0,
                         'items_poisoned': 0,
                         'metrics_deltas_merged': 0})
        return diag
