"""Vision Transformer: the port's image-classification consumer.

Counterpart of ``petastorm_tpu/models/vit.py``: uint8 image batches from
the torch loader, normalized on the card → patch embedding (a
reshape/permute, no gather) → the LM transformer's pre-norm blocks
(:func:`petastorm_tpu_torch.models.transformer._block_forward`) run
bidirectionally (``causal=False``; with ``attn_impl='flash'`` through the
flash kernels) → RMSNorm → mean-pool → linear head → f32 logits.
``patch_embed``, ``pos_embed`` and ``head`` are f32 parameters cast to
``config.dtype`` for their products, as in the JAX model; the head's
product accumulates in f32 and is not rounded to ``config.dtype``, as
JAX's ``preferred_element_type=f32``. Weights carry across from the JAX
package with :func:`vit_params_from_jax`.

The JAX model runs its Pallas kernel only where
``kernel_supported(n_patches)`` and exact dense attention elsewhere; the
port's kernels take any sequence length, so ``'flash'`` is the same
function at every size.
"""

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from petastorm_tpu_torch.models.transformer import (
    TransformerConfig, _Block, _block_forward, _param, _rmsnorm, reset_block,
)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    channels: int = 3
    n_classes: int = 1000
    d_model: int = 256
    n_heads: int = 8
    n_layers: int = 6
    d_ff: int = 1024
    dtype: object = torch.bfloat16
    # the blocks' attention: 'dense' (plain torch) or 'flash' (the kernels)
    attn_impl: str = 'dense'

    def __post_init__(self):
        if self.image_size % self.patch_size:
            raise ValueError('image_size=%d not divisible by patch_size=%d'
                             % (self.image_size, self.patch_size))
        if self.attn_impl not in ('dense', 'flash'):
            raise ValueError("attn_impl must be 'dense' or 'flash'; got %r" % (self.attn_impl,))

    @property
    def n_patches(self):
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self):
        return self.patch_size * self.patch_size * self.channels

    def block_config(self):
        """The shared transformer blocks' view of this config."""
        return TransformerConfig(vocab_size=2, d_model=self.d_model, n_heads=self.n_heads,
                                 n_layers=self.n_layers, d_ff=self.d_ff,
                                 max_seq_len=self.n_patches, dtype=self.dtype,
                                 attn_impl=self.attn_impl)


class ViT(nn.Module):
    """The JAX model's parameter tree as an ``nn.Module``: ``patch_embed``
    ``(patch_dim, d_model)``, ``pos_embed`` ``(n_patches, d_model)``,
    ``blocks.<i>.*`` (the transformer's), ``ln_f`` and ``head``
    ``(d_model, n_classes)``."""

    def __init__(self, config):
        super().__init__()
        c = self.config = config
        self.patch_embed = _param(c.patch_dim, c.d_model)
        self.pos_embed = _param(c.n_patches, c.d_model)
        self.blocks = nn.ModuleList(_Block(c.block_config()) for _ in range(c.n_layers))
        self.ln_f = _param(c.d_model)
        self.head = _param(c.d_model, c.n_classes)

    @torch.no_grad()
    def reset_parameters(self, generator):
        """The JAX init's scales, drawn from ``generator``: patch
        embedding ``patch_dim**-0.5``, positions 0.02, the blocks as the
        transformer's, a zero head."""
        c = self.config
        self.patch_embed.copy_(torch.randn(self.patch_embed.shape, generator=generator)
                               * c.patch_dim ** -0.5)
        self.pos_embed.copy_(torch.randn(self.pos_embed.shape, generator=generator) * 0.02)
        for block in self.blocks:
            reset_block(block, c.block_config(), generator)
        self.ln_f.fill_(1.0)
        self.head.zero_()

    def forward(self, images):
        return vit_forward(self, images)


def init_vit(seed, config, device=None):
    """A :class:`ViT` with weights drawn from a CPU ``torch.Generator``
    seeded ``seed``, on ``device`` (``None`` means the card; raises
    without CUDA)."""
    from petastorm_tpu_torch.device.loader import resolve_device
    device = resolve_device(device)
    model = ViT(config)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device)


def vit_params_from_jax(params):
    """A :class:`ViT` ``state_dict`` from the JAX model's parameter pytree
    (numpy arrays): the same names and layouts, as f32 tensors."""
    state = {name: torch.tensor(np.asarray(params[name], np.float32))
             for name in ('patch_embed', 'pos_embed', 'ln_f', 'head')}
    for i, block in enumerate(params['blocks']):
        for name, value in block.items():
            state['blocks.%d.%s' % (i, name)] = torch.tensor(np.asarray(value, np.float32))
    return state


def _patchify(images, config):
    """``(B, H, W, C)`` → ``(B, n_patches, patch_dim)``, patches in raster
    order, each flattened (row, column, channel)."""
    c = config
    b = images.shape[0]
    g = c.image_size // c.patch_size
    x = images.reshape(b, g, c.patch_size, g, c.patch_size, c.channels)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, c.patch_dim)


def vit_forward(model, images):
    """images ``(B, H, W, C)``, float in [0, 1] or normalized → logits
    ``(B, n_classes)`` f32."""
    c = model.config
    dtype = c.dtype
    bc = c.block_config()
    x = torch.matmul(_patchify(images.to(dtype), c), model.patch_embed.to(dtype))
    x = x + model.pos_embed.to(dtype)
    for block in model.blocks:
        # bidirectional: every patch attends to every patch
        x = _block_forward(block, x, bc, causal=False)
    pooled = _rmsnorm(x, model.ln_f).mean(dim=1)
    # bf16 operands, f32 products and sums, no rounding of the result
    return torch.matmul(pooled.float(), model.head.to(dtype).float())


def vit_loss(model, images, labels):
    """Mean softmax cross-entropy of the f32 logits against int labels."""
    return F.cross_entropy(vit_forward(model, images), labels.long())


def vit_train_step(model, optimizer):
    """An ``(images, labels) -> loss`` step: forward, backward, one update."""

    def step(images, labels):
        optimizer.zero_grad(set_to_none=True)
        loss = vit_loss(model, images, labels)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
