"""Ranks through ``torch.distributed`` (counterpart of
``petastorm_tpu/parallel``): shard defaults (``sharding``), named device
meshes (``mesh``), the differentiable collectives the tensor-, sequence-
and expert-parallel models run on (``collectives``) and the GPipe
pipeline (``pipeline``)."""
