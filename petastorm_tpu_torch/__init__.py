"""petastorm_tpu_torch: the PyTorch and CUDA port of petastorm_tpu.

Reads Parquet datasets written by either package and feeds
``{field: torch.Tensor}`` batches to a training step on an NVIDIA GPU
(Hopper kernels in ``csrc/``). It imports nothing of the JAX package.

Entry points: :func:`make_reader` (rows and NGram windows, from
:mod:`petastorm_tpu_torch.reader`) with
:class:`petastorm_tpu_torch.pytorch.DataLoader`, :func:`make_batch_reader`
with :class:`petastorm_tpu_torch.pytorch.BatchedDataLoader`,
:func:`petastorm_tpu_torch.device.loader.make_torch_loader`,
:func:`petastorm_tpu_torch.etl.dataset_metadata.write_dataset` and
:func:`petastorm_tpu_torch.ops.normalize.normalize_images`.
"""

from petastorm_tpu_torch.errors import NoDataAvailableError  # noqa: F401
from petastorm_tpu_torch.transform import TransformSpec  # noqa: F401


def make_reader(*args, **kwargs):
    from petastorm_tpu_torch.reader import make_reader as _make_reader
    return _make_reader(*args, **kwargs)


def make_batch_reader(*args, **kwargs):
    from petastorm_tpu_torch.reader import make_batch_reader as _make_batch_reader
    return _make_batch_reader(*args, **kwargs)


def make_torch_loader(*args, **kwargs):
    from petastorm_tpu_torch.device.loader import make_torch_loader as _make_torch_loader
    return _make_torch_loader(*args, **kwargs)
