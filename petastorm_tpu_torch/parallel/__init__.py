"""Data-parallel ranks through ``torch.distributed`` (counterpart of
``petastorm_tpu/parallel``: shard defaults; the mesh and pipeline modules
wait for ROADMAP item 8)."""
