"""Worker-pool runtime (counterpart of ``petastorm_tpu/workers``): the pool
contract ``start(worker_class, worker_args, ventilator) / ventilate /
get_results / stop / join`` on a thread pool and a synchronous dummy pool.
The process and service pools wait for their roadmap item."""


class EmptyResultError(Exception):
    """Raised by ``get_results`` when all ventilated work is done."""


class TimeoutWaitingForResultError(Exception):
    """Raised when a result did not arrive within the poll timeout."""


class VentilatedItemProcessedMessage:
    """Control message a worker publishes after finishing one work item."""
