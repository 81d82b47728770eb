"""The device stage (counterpart of ``petastorm_tpu/jax``): staging onto
the card and the loader that drives it."""

from petastorm_tpu_torch.device.loader import (  # noqa: F401
    MASK_FIELD, TorchLoader, make_torch_loader,
)
