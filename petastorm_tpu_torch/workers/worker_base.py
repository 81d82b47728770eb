"""Worker contract (counterpart of ``petastorm_tpu/workers/worker_base.py``)."""

from abc import ABCMeta, abstractmethod


class WorkerBase(metaclass=ABCMeta):
    """A worker processes ventilated items and publishes results by calling
    ``self.publish_func(data)`` any number of times per item."""

    def __init__(self, worker_id, publish_func, args):
        self.worker_id = worker_id
        self.publish_func = publish_func
        self.args = args

    def initialize(self):
        """Called once on the worker's thread before any item."""

    def shutdown(self):
        """Called once when the pool stops."""

    @abstractmethod
    def process(self, *args, **kwargs):
        """Process a single ventilated work item."""
