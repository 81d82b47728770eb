"""Worker-pool runtime (counterpart of ``petastorm_tpu/workers``): the pool
contract ``start(worker_class, worker_args, ventilator) / ventilate /
get_results / stop / join`` on a thread pool, a spawned-process pool for
GIL-heavy transforms, and a synchronous dummy pool. The service pool
waits for its roadmap item."""


#: gauge names every pool flavor exposes through ``diagnostics``, so
#: dashboards and the autotuner read the same keys wherever decode runs
SHARED_POOL_GAUGES = frozenset([
    'items_ventilated', 'items_processed', 'items_inflight',
    'workers_alive', 'output_queue_size',
])


class EmptyResultError(Exception):
    """Raised by ``get_results`` when all ventilated work is done."""


class TimeoutWaitingForResultError(Exception):
    """Raised when a result did not arrive within the poll timeout."""


class VentilatedItemProcessedMessage:
    """Control message a worker publishes after finishing one work item."""


class WorkerTerminationRequested(Exception):
    """Raised inside a worker to abort processing during shutdown."""
