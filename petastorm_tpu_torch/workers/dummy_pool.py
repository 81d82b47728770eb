"""Synchronous in-caller-thread pool for debugging and exact-order tests
(counterpart of ``petastorm_tpu/workers/dummy_pool.py``): work runs
lazily on the caller's thread inside ``get_results``."""

import time
from collections import deque

from petastorm_tpu_torch.telemetry import tracing
from petastorm_tpu_torch.workers import EmptyResultError


class DummyPool:
    def __init__(self):
        self._worker = None
        self._ventilator = None
        self._work_items = deque()
        self._results = deque()
        self._ventilated_items = 0
        self._processed_items = 0

    @property
    def workers_count(self):
        return 1

    def start(self, worker_class, worker_args=None, ventilator=None,
              start_ventilator=True):
        if self._worker is not None:
            raise RuntimeError('DummyPool already started')
        self._worker = worker_class(0, self._results.append, worker_args)
        self._worker.initialize()
        self._ventilator = ventilator
        if ventilator is not None and start_ventilator:
            ventilator.start()

    def ventilate(self, *args, **kwargs):
        self._ventilated_items += 1
        self._work_items.append((args, kwargs))

    def get_results(self, timeout=None):
        while True:
            if self._results:
                return self._results.popleft()
            if not self._work_items:
                if self._ventilator is None or self._ventilator.completed():
                    raise EmptyResultError()
                # the ventilator thread may still be pushing items
                time.sleep(0.001)
                continue
            args, kwargs = self._work_items.popleft()
            ctx = kwargs.pop(tracing.TRACE_CTX_KEY, None)
            try:
                with tracing.attempt(ctx, 'dummy-0'):
                    self._worker.process(*args, **kwargs)
            finally:
                self._processed_items += 1
                if self._ventilator is not None:
                    self._ventilator.processed_item()

    def stop(self):
        if self._ventilator is not None:
            self._ventilator.stop()

    def join(self):
        if self._worker is not None:
            self._worker.shutdown()
            self._worker = None

    @property
    def diagnostics(self):
        return {'items_ventilated': self._ventilated_items,
                'items_processed': self._processed_items,
                'items_inflight': len(self._work_items),
                'output_queue_size': len(self._results),
                'workers_alive': 1 if self._worker is not None else 0}
