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

The standing service (the reference's daemon, its client pool, the fleet
supervisor and the warm standby) is not ported yet (ROADMAP.md, Queue 1
item 9).
"""

from petastorm_tpu_torch.service.service_pool import ServicePool  # noqa: F401
