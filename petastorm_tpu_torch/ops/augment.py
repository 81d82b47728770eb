"""Image augmentation on the card: flips, crops and cutout on NHWC batches.

Counterpart of ``petastorm_tpu/ops/augment.py``. Those are XLA ops on the
TPU, not Pallas kernels, so their counterparts are torch ops. Randomness
is per image and comes from an explicit ``torch.Generator`` on the
images' device. jax.random and torch draw different streams, so each op
is a draw (``*_flags``/``*_offsets``) and a pure apply (``apply_*``): the
applies agree exactly with the JAX ops given the flags or offsets JAX
drew.
"""

import torch


def flip_flags(generator, batch, p=0.5, device=None):
    """``(batch,)`` bools, each True with probability ``p``."""
    return torch.rand(batch, generator=generator, device=device) < p


def apply_flip(images, flags):
    """Flip left-right the images whose flag is set."""
    return torch.where(flags.view(-1, 1, 1, 1), images.flip(2), images)


def random_flip_horizontal(generator, images, p=0.5):
    """Flip each image left-right with probability ``p``."""
    return apply_flip(images, flip_flags(generator, images.shape[0], p, images.device))


def window_offsets(generator, batch, height, width, win_h, win_w, device=None):
    """Uniform top-left corners ``(ys, xs)`` of a ``win_h`` × ``win_w``
    window inside a ``height`` × ``width`` image, one per image."""
    if win_h > height or win_w > width:
        raise ValueError('window (%d, %d) exceeds image (%d, %d)'
                         % (win_h, win_w, height, width))
    ys = torch.randint(0, height - win_h + 1, (batch,), generator=generator, device=device)
    xs = torch.randint(0, width - win_w + 1, (batch,), generator=generator, device=device)
    return ys, xs


def apply_crop(images, ys, xs, crop_h, crop_w):
    """``(B, H, W, C)`` → ``(B, crop_h, crop_w, C)``: image ``i``'s window
    at ``(ys[i], xs[i])``, one gather for the batch."""
    b = images.shape[0]
    rows = ys.view(b, 1, 1) + torch.arange(crop_h, device=images.device).view(1, -1, 1)
    cols = xs.view(b, 1, 1) + torch.arange(crop_w, device=images.device).view(1, 1, -1)
    return images[torch.arange(b, device=images.device).view(b, 1, 1), rows, cols]


def random_crop(generator, images, crop_h, crop_w):
    """A random ``crop_h`` × ``crop_w`` window of each image."""
    b, h, w, _ = images.shape
    ys, xs = window_offsets(generator, b, h, w, crop_h, crop_w, images.device)
    return apply_crop(images, ys, xs, crop_h, crop_w)


def apply_cutout(images, ys, xs, size, fill=0):
    """Set each image's ``size`` × ``size`` square at ``(ys[i], xs[i])`` to
    ``fill``, as a mask (no scatter)."""
    _, h, w, _ = images.shape
    rows = torch.arange(h, device=images.device).view(1, h, 1)
    cols = torch.arange(w, device=images.device).view(1, 1, w)
    ys, xs = ys.view(-1, 1, 1), xs.view(-1, 1, 1)
    inside = (rows >= ys) & (rows < ys + size) & (cols >= xs) & (cols < xs + size)
    return torch.where(inside[..., None], torch.tensor(fill, dtype=images.dtype,
                                                       device=images.device), images)


def random_cutout(generator, images, size, fill=0):
    """Cut a random ``size`` × ``size`` square out of each image."""
    b, h, w, _ = images.shape
    if size > h or size > w:
        raise ValueError('cutout size %d exceeds image (%d, %d)' % (size, h, w))
    ys, xs = window_offsets(generator, b, h, w, size, size, images.device)
    return apply_cutout(images, ys, xs, size, fill)
