"""Thread worker pool (counterpart of
``petastorm_tpu/workers/thread_pool.py``): pyarrow reads and codec decode
release the GIL, so threads scale without spawn or serialization cost."""

import logging
import queue
import threading
import time

from petastorm_tpu_torch.telemetry import STALL_NOTE_FLOOR_S, note_producer_wait, tracing
from petastorm_tpu_torch.workers import (
    EmptyResultError, TimeoutWaitingForResultError, VentilatedItemProcessedMessage,
)

logger = logging.getLogger(__name__)

_RESULTS_QUEUE_SIZE_DEFAULT = 50
_POLL_INTERVAL_S = 0.05


class _WorkerExit(Exception):
    """Internal signal: the pool is stopping."""


class ThreadPool:
    """N daemon worker threads over stdlib queues. Worker exceptions are
    forwarded through the results queue and re-raised in the consumer."""

    def __init__(self, workers_count, results_queue_size=_RESULTS_QUEUE_SIZE_DEFAULT):
        self._workers_count = workers_count
        self._results_queue = queue.Queue(maxsize=results_queue_size)
        self._work_queue = queue.Queue()
        self._stop_event = threading.Event()
        self._threads = []
        self._workers = []
        self._ventilator = None
        self._ventilated_items = 0
        self._processed_items = 0
        self._counter_lock = threading.Lock()
        self._error = None

    @property
    def workers_count(self):
        return self._workers_count

    def start(self, worker_class, worker_args=None, ventilator=None,
              start_ventilator=True):
        if self._threads:
            raise RuntimeError('ThreadPool already started')
        for worker_id in range(self._workers_count):
            worker = worker_class(worker_id, self._publish, worker_args)
            self._workers.append(worker)
            thread = threading.Thread(target=self._worker_loop, args=(worker,), daemon=True,
                                      name='petastorm-tpu-torch-worker-%d' % worker_id)
            thread.start()
            self._threads.append(thread)
        self._ventilator = ventilator
        if ventilator is not None and start_ventilator:
            ventilator.start()

    def ventilate(self, *args, **kwargs):
        with self._counter_lock:
            self._ventilated_items += 1
        self._work_queue.put((args, kwargs))

    def get_results(self, timeout=None):
        """Next result, blocking; raises :class:`EmptyResultError` once the
        results queue is drained, every ventilated item is processed and
        the ventilator has completed."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._error is not None:
                # a worker error is terminal: every later read re-raises it
                raise self._error
            try:
                result = self._results_queue.get(timeout=_POLL_INTERVAL_S)
            except queue.Empty:
                if self._stop_event.is_set():
                    raise EmptyResultError()
                with self._counter_lock:
                    all_done = self._ventilated_items == self._processed_items
                if all_done and (self._ventilator is None or self._ventilator.completed()):
                    raise EmptyResultError()
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutWaitingForResultError()
                continue
            if isinstance(result, VentilatedItemProcessedMessage):
                with self._counter_lock:
                    self._processed_items += 1
                if self._ventilator is not None:
                    self._ventilator.processed_item()
                continue
            if isinstance(result, Exception):
                self._error = result
                self.stop()
                self.join()
                raise result
            return result

    def stop(self):
        if self._ventilator is not None:
            self._ventilator.stop()
        self._stop_event.set()

    def join(self):
        if not self._stop_event.is_set():
            raise RuntimeError('Must call stop() before join()')
        for thread in self._threads:
            thread.join()
        self._threads = []
        for worker in self._workers:
            worker.shutdown()
        self._workers = []

    @property
    def diagnostics(self):
        with self._counter_lock:
            ventilated = self._ventilated_items
            processed = self._processed_items
        return {
            'output_queue_size': self._results_queue.qsize(),
            'items_ventilated': ventilated,
            'items_processed': processed,
            'items_inflight': ventilated - processed,
            'workers_alive': sum(1 for t in self._threads if t.is_alive()),
        }

    def _publish(self, data):
        """Stop-aware put: never deadlocks a worker against a full results
        queue during shutdown; time blocked is producer wait."""
        start = time.monotonic()
        try:
            while not self._stop_event.is_set():
                try:
                    self._results_queue.put(data, timeout=_POLL_INTERVAL_S)
                    return
                except queue.Full:
                    continue
            raise _WorkerExit()
        finally:
            blocked = time.monotonic() - start
            if blocked > STALL_NOTE_FLOOR_S:
                note_producer_wait(blocked)

    def _worker_loop(self, worker):
        try:
            worker.initialize()
            while not self._stop_event.is_set():
                try:
                    args, kwargs = self._work_queue.get(timeout=_POLL_INTERVAL_S)
                except queue.Empty:
                    continue
                # a traced item carries its context as a reserved kwarg:
                # the worker's stage spans land on the item's timeline
                ctx = kwargs.pop(tracing.TRACE_CTX_KEY, None)
                try:
                    with tracing.attempt(ctx, 'thread-%d' % worker.worker_id):
                        worker.process(*args, **kwargs)
                    self._publish(VentilatedItemProcessedMessage())
                except _WorkerExit:
                    return
                except Exception as e:  # noqa: BLE001 - forwarded to consumer
                    logger.debug('Worker %d forwarding exception', worker.worker_id,
                                 exc_info=True)
                    self._publish(e)
                    # keep the ventilated/processed counters consistent
                    self._publish(VentilatedItemProcessedMessage())
        except _WorkerExit:
            pass
