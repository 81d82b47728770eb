"""petastorm_tpu_torch: the PyTorch and CUDA port of petastorm_tpu.

Reads Parquet datasets written by either package and feeds
``{field: torch.Tensor}`` batches to a training step on an NVIDIA GPU
(Hopper kernels in ``csrc/``). It imports nothing of the JAX package.

Entry points: :func:`petastorm_tpu_torch.reader.make_batch_reader`,
:func:`petastorm_tpu_torch.device.loader.make_torch_loader`,
:func:`petastorm_tpu_torch.etl.dataset_metadata.write_dataset` and
:func:`petastorm_tpu_torch.ops.normalize.normalize_images`.
"""
