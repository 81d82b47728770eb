"""Ranks through ``torch.distributed`` (counterpart of
``petastorm_tpu/parallel``): shard defaults (``sharding``), named device
meshes (``mesh``) and the differentiable collectives the tensor- and
sequence-parallel models run on (``collectives``); the pipeline module
waits for ROADMAP item 8."""
