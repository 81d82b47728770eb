"""The decode service: a worker fleet over ZeroMQ ``tcp://`` (counterpart of
``petastorm_tpu/service/``).

* :mod:`~petastorm_tpu_torch.service.dispatcher`: the item scheduler. It
  registers worker servers, hands out ventilated row-group items with
  per-worker credit and re-ventilates the items of workers whose heartbeats
  lapse, so every item is delivered exactly once.
* :mod:`~petastorm_tpu_torch.service.worker_server`: a standalone process
  (``python -m petastorm_tpu_torch.service.worker_server``) that runs the
  port's decode workers and streams results back over ``tcp://``.
* :class:`~petastorm_tpu_torch.service.service_pool.ServicePool`: the
  client, with the pool contract of the thread and process pools, so
  ``reader_pool_type='service'`` and ``make_torch_loader`` work unchanged.

* :mod:`~petastorm_tpu_torch.service.daemon`: the standing service
  (``python -m petastorm_tpu_torch.service``), a daemonized dispatcher that
  outlives any one job, with the client-side
  :class:`~petastorm_tpu_torch.service.daemon.DaemonClientPool`, the
  self-healing :mod:`~petastorm_tpu_torch.service.supervisor` and the warm
  :mod:`~petastorm_tpu_torch.service.standby`.
* :mod:`~petastorm_tpu_torch.service.peer_cache`: the fleet cache tier, so a
  fleet decodes each row-group once.
"""

from petastorm_tpu_torch.service.daemon import (  # noqa: F401
    DaemonClientPool, ServiceDaemon,
)
from petastorm_tpu_torch.service.service_pool import ServicePool  # noqa: F401
from petastorm_tpu_torch.service.supervisor import WorkerSupervisor  # noqa: F401
