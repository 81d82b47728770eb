"""Spawned-process worker pool over ZeroMQ (counterpart of
``petastorm_tpu/workers/process_pool.py``), for GIL-heavy transforms.

Three sockets on ``ipc://`` endpoints in a private temporary directory::

    main:   PUSH work ──► worker PULL
    main:   PUB control ─► worker SUB          (stop broadcast)
    worker: PUSH results ► main PULL

* Workers are spawned, never forked
  (:func:`~petastorm_tpu_torch.workers.exec_in_new_process.exec_in_new_process`),
  with ``CUDA_VISIBLE_DEVICES=''``: a worker never opens a context on the
  trainer's card, and its results are plain numpy.
* Results ride :class:`~petastorm_tpu_torch.serializers.PickleSerializer`'s
  multipart frames, each ndarray its own pickle-5 out-of-band frame, and
  the consumer receives with ``copy=False``, so the arrays view the wire
  buffers. Back-pressure is the sockets' high-water marks, sized
  from ``results_queue_size``.
* A worker's exception is forwarded and raised in the consumer; each
  worker runs an orphan monitor and exits when the pool's process is gone;
  every worker checks in within ``_STARTUP_TIMEOUT_S``, and one that dies
  at start-up is reported; the stop broadcast repeats until every worker
  has exited, then the survivors are terminated.
* Each completion marker carries the worker's metrics delta and trace
  events (:func:`~petastorm_tpu_torch.telemetry.dump_delta_frame`).
"""

import logging
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import dill

from petastorm_tpu_torch import sanitizer
from petastorm_tpu_torch.serializers import PickleSerializer
from petastorm_tpu_torch.telemetry import (
    STALL_NOTE_FLOOR_S, dump_delta_frame, load_delta_frame, merge_worker_delta,
    note_producer_wait, tracing,
)
from petastorm_tpu_torch.workers import (
    EmptyResultError, TimeoutWaitingForResultError, WorkerTerminationRequested,
)

logger = logging.getLogger(__name__)

_STARTUP_TIMEOUT_S = 20
_POLL_INTERVAL_MS = 50
_JOIN_TIMEOUT_S = 10
_ORPHAN_CHECK_S = 1.0

# wire message types (the first frame)
_MSG_READY = b'R'
_MSG_RESULT = b'D'
_MSG_MARKER = b'M'
_MSG_ERROR = b'E'
_MSG_EXIT = b'X'
_CTRL_STOP = b'stop'

_SERIALIZER = PickleSerializer()


class ProcessPool:
    """N spawned decode processes; the contract of :class:`ThreadPool`.

    ``worker_reports`` holds what each worker said at check-in: its
    ``worker_id``, ``pid``, ``cuda_visible_devices`` and the top-level
    ``modules`` it had imported by then."""

    def __init__(self, workers_count, results_queue_size=50):
        self._workers_count = workers_count
        self._results_queue_size = results_queue_size
        self._processes = []
        self._ventilator = None
        self._ventilated_items = 0
        self._processed_items = 0
        self._error = None
        self._stop_event = threading.Event()
        self._ipc_dir = None
        self._context = None
        self._work_socket = None
        self._control_socket = None
        self._results_socket = None
        self.worker_reports = []

    @property
    def workers_count(self):
        return self._workers_count

    @property
    def worker_pids(self):
        return [p.pid for p in self._processes]

    def start(self, worker_class, worker_args=None, ventilator=None, start_ventilator=True):
        import zmq
        if self._processes:
            raise RuntimeError('ProcessPool already started')
        self._context = zmq.Context()
        # a short prefix: a unix socket's path must fit in ~107 bytes
        self._ipc_dir = tempfile.mkdtemp(prefix='ptt_pool_')
        work_ep = 'ipc://%s/work' % self._ipc_dir
        control_ep = 'ipc://%s/control' % self._ipc_dir
        results_ep = 'ipc://%s/results' % self._ipc_dir
        self._work_socket = self._context.socket(zmq.PUSH)
        self._work_socket.set_hwm(0)  # work items are small; never block
        self._work_socket.bind(work_ep)
        self._control_socket = self._context.socket(zmq.PUB)
        self._control_socket.bind(control_ep)
        # a high-water mark holds per connection, on each side: split the
        # pool's bound over both sides of every worker's connection, so the
        # whole buffer stays near results_queue_size items, as the thread
        # pool's one queue does
        per_worker_hwm = max(1, self._results_queue_size // (2 * self._workers_count))
        self._results_socket = self._context.socket(zmq.PULL)
        self._results_socket.set_hwm(per_worker_hwm)
        self._results_socket.bind(results_ep)

        from petastorm_tpu_torch.workers.exec_in_new_process import exec_in_new_process
        payload = dill.dumps((worker_class, worker_args))
        for worker_id in range(self._workers_count):
            self._processes.append(exec_in_new_process(
                _worker_bootstrap, worker_id, os.getpid(), work_ep, control_ep, results_ep,
                payload, per_worker_hwm))
        self._await_checkins()
        self._ventilator = ventilator
        if ventilator is not None and start_ventilator:
            ventilator.start()

    def _await_checkins(self):
        import zmq
        poller = zmq.Poller()
        poller.register(self._results_socket, zmq.POLLIN)
        deadline = time.monotonic() + _STARTUP_TIMEOUT_S
        while len(self.worker_reports) < self._workers_count:
            dead = self._dead_workers()
            if dead:
                self._abort_startup()
                raise RuntimeError('Pool worker process(es) %s died during startup; see '
                                   'their stderr for the traceback' % dead)
            if time.monotonic() > deadline:
                checked_in = len(self.worker_reports)
                self._abort_startup()
                raise RuntimeError('Only %d of %d pool workers checked in within %ds'
                                   % (checked_in, self._workers_count, _STARTUP_TIMEOUT_S))
            if poller.poll(_POLL_INTERVAL_MS):
                frames = self._results_socket.recv_multipart()
                if frames[0] == _MSG_READY:
                    self.worker_reports.append(dill.loads(frames[1]))

    def _abort_startup(self):
        """A failed start: reap the children and release every resource
        (``join`` needs a ``stop`` first, which was never called)."""
        self._terminate_all()
        for p in self._processes:
            try:
                p.wait(timeout=2)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self._processes = []
        self._close_sockets()

    def ventilate(self, *args, **kwargs):
        self._ventilated_items += 1
        self._work_socket.send(dill.dumps((args, kwargs)))

    def get_results(self, timeout=None):
        """Next result, blocking; raises :class:`EmptyResultError` once
        every ventilated item is processed and the ventilator has
        completed."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._error is not None:
                raise self._error
            if not self._results_socket.poll(_POLL_INTERVAL_MS):
                if self._stop_event.is_set():
                    raise EmptyResultError()
                if self._ventilated_items == self._processed_items and (
                        self._ventilator is None or self._ventilator.completed()):
                    raise EmptyResultError()
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutWaitingForResultError()
                dead = self._dead_workers()
                if dead:
                    self._error = RuntimeError('Pool worker process(es) died '
                                               'unexpectedly: %s' % dead)
                continue
            # copy=False: the frames stay in the socket's receive buffers,
            # and pickle-5 rebuilds the arrays as views over them
            frames = self._results_socket.recv_multipart(copy=False)
            kind = frames[0].bytes
            if kind == _MSG_MARKER:
                self._processed_items += 1
                if self._ventilator is not None:
                    self._ventilator.processed_item()
                if len(frames) > 1:
                    merge_worker_delta(load_delta_frame(frames[1].bytes))
                continue
            if kind == _MSG_ERROR:
                self._error = dill.loads(frames[1].bytes)
                self.stop()
                self.join()
                raise self._error
            if kind == _MSG_RESULT:
                payload = [f.buffer for f in frames[1:]]
                if sanitizer.sanitize_enabled():
                    # arrays rebuilt over read-only views are read-only: a
                    # consumer's write raises instead of touching the buffers
                    payload = [b.toreadonly() for b in payload]
                return _SERIALIZER.deserialize_frames(payload)
            if kind in (_MSG_READY, _MSG_EXIT):
                continue
            logger.warning('Unknown pool message type %r', kind)

    def _dead_workers(self):
        return [p.pid for p in self._processes if p.poll() is not None and p.returncode != 0]

    def stop(self):
        if self._ventilator is not None:
            self._ventilator.stop()
        self._stop_event.set()

    def join(self):
        if not self._stop_event.is_set():
            raise RuntimeError('Must call stop() before join()')
        if not self._processes:
            return
        # a worker whose control socket connected after the first broadcast
        # never heard it: repeat until every worker has exited
        deadline = time.monotonic() + _JOIN_TIMEOUT_S
        while any(p.poll() is None for p in self._processes):
            self._control_socket.send(_CTRL_STOP)
            if time.monotonic() > deadline:
                logger.warning('Terminating pool workers that ignored stop')
                self._terminate_all()
                break
            time.sleep(_POLL_INTERVAL_MS / 1000.0)
        for p in self._processes:
            try:
                p.wait(timeout=_JOIN_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self._processes = []
        self._close_sockets()

    def _terminate_all(self):
        for p in self._processes:
            if p.poll() is None:
                p.terminate()

    def _close_sockets(self):
        for sock in (self._work_socket, self._control_socket, self._results_socket):
            if sock is not None:
                sock.close(linger=0)
        self._work_socket = self._control_socket = self._results_socket = None
        if self._context is not None:
            self._context.term()
            self._context = None
        if self._ipc_dir:
            shutil.rmtree(self._ipc_dir, ignore_errors=True)
            self._ipc_dir = None

    @property
    def diagnostics(self):
        ventilated = self._ventilated_items
        processed = self._processed_items
        return {
            'items_ventilated': ventilated,
            'items_processed': processed,
            'items_inflight': max(0, ventilated - processed),
            'workers_alive': sum(1 for p in self._processes if p.poll() is None),
            # results wait in the sockets' buffers, which this process
            # cannot measure: no consumer-side queue holds any
            'output_queue_size': 0,
        }


def _worker_bootstrap(worker_id, main_pid, work_ep, control_ep, results_ep, class_payload,
                      results_hwm):
    """Entry point of a spawned decode process."""
    import zmq

    def _orphan_monitor():
        # the pool's process is this one's parent: once it is gone the
        # child is re-parented, and the worker has no one to serve
        while os.getppid() == main_pid:
            time.sleep(_ORPHAN_CHECK_S)
        os._exit(0)

    threading.Thread(target=_orphan_monitor, daemon=True,
                     name='petastorm-tpu-torch-orphan-monitor').start()

    worker_class, worker_args = dill.loads(class_payload)
    context = zmq.Context()
    work = context.socket(zmq.PULL)
    work.connect(work_ep)
    control = context.socket(zmq.SUB)
    control.setsockopt(zmq.SUBSCRIBE, b'')
    control.connect(control_ep)
    results = context.socket(zmq.PUSH)
    results.set_hwm(max(1, results_hwm))
    results.connect(results_ep)

    def send_or_stop(frames):
        """A worker parked on a full results channel still hears the stop
        broadcast. Time blocked is back-pressure from a slow consumer: it
        lands in this worker's registry and reaches the consumer with the
        next marker's delta."""
        start = time.monotonic()
        try:
            while True:
                if results.poll(_POLL_INTERVAL_MS, zmq.POLLOUT):
                    results.send_multipart(frames)
                    return
                if control.poll(0) and control.recv() == _CTRL_STOP:
                    raise WorkerTerminationRequested()
        finally:
            blocked = time.monotonic() - start
            if blocked > STALL_NOTE_FLOOR_S:
                note_producer_wait(blocked)

    def publish(value):
        send_or_stop([_MSG_RESULT] + list(_SERIALIZER.serialize_frames(value)))

    worker = worker_class(worker_id, publish, worker_args)
    worker.initialize()
    report = {'worker_id': worker_id, 'pid': os.getpid(),
              'cuda_visible_devices': os.environ.get('CUDA_VISIBLE_DEVICES'),
              'modules': sorted({name.split('.')[0] for name in list(sys.modules)})}
    results.send_multipart([_MSG_READY, dill.dumps(report)])

    poller = zmq.Poller()
    poller.register(work, zmq.POLLIN)
    poller.register(control, zmq.POLLIN)
    try:
        while True:
            events = dict(poller.poll())
            if control in events and control.recv() == _CTRL_STOP:
                break
            if work not in events:
                continue
            args, kwargs = dill.loads(work.recv())
            # a traced item's stage spans and attempt event land in this
            # process's recorder and ship back with the marker's delta
            ctx = kwargs.pop(tracing.TRACE_CTX_KEY, None)
            try:
                with tracing.attempt(ctx, 'process-%d' % worker_id):
                    worker.process(*args, **kwargs)
                send_or_stop([_MSG_MARKER, dump_delta_frame()])
            except WorkerTerminationRequested:
                break
            except Exception as e:  # noqa: BLE001 - forwarded to the consumer
                try:
                    err_payload = dill.dumps(e)
                except Exception:  # noqa: BLE001 - an unpicklable exception
                    err_payload = dill.dumps(RuntimeError('%s: %s' % (type(e).__name__, e)))
                try:
                    send_or_stop([_MSG_ERROR, err_payload])
                    send_or_stop([_MSG_MARKER, dump_delta_frame()])
                except WorkerTerminationRequested:
                    break
    finally:
        try:
            worker.shutdown()
        except Exception:  # noqa: BLE001 - best-effort shutdown
            pass
        try:
            results.send_multipart([_MSG_EXIT, b''], flags=zmq.NOBLOCK)
        except Exception:  # noqa: BLE001 - the channel may be full or closed
            pass
        for sock in (work, control, results):
            sock.close(linger=1000)
        context.term()
        os._exit(0)
