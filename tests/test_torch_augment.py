"""petastorm_tpu_torch augment ops against the JAX package's, on the CPU.

jax.random and torch draw different streams, so each JAX op runs with a
key, the flags or offsets that key draws are recomputed with the same
jax.random calls the op makes, and the port's apply runs on those: the
outputs must be equal exactly (the ops select and copy, no arithmetic).
Images are made with numpy from a seed, uint8 and float32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from petastorm_tpu.ops import augment as jax_augment
from petastorm_tpu_torch.ops import augment


def _images(dtype, seed=0, shape=(6, 12, 10, 3)):
    rng = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rng.randint(0, 256, shape).astype(np.uint8)
    return rng.rand(*shape).astype(np.float32)


@pytest.mark.parametrize('dtype', [np.uint8, np.float32])
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_flip_apply_matches_jax(dtype, seed):
    images = _images(dtype, seed)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_augment.random_flip_horizontal(key, jnp.asarray(images), p=0.5))
    flags = np.array(jax.random.bernoulli(key, 0.5, (images.shape[0],)))
    got = augment.apply_flip(torch.from_numpy(images), torch.from_numpy(flags))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('dtype', [np.uint8, np.float32])
@pytest.mark.parametrize('crop', [(5, 4), (12, 10), (1, 1)])
def test_crop_apply_matches_jax(dtype, crop):
    images = _images(dtype, 3)
    b, h, w, _ = images.shape
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_augment.random_crop(key, jnp.asarray(images), *crop))
    ky, kx = jax.random.split(key)
    ys = np.array(jax.random.randint(ky, (b,), 0, h - crop[0] + 1))
    xs = np.array(jax.random.randint(kx, (b,), 0, w - crop[1] + 1))
    got = augment.apply_crop(torch.from_numpy(images), torch.from_numpy(ys).long(),
                             torch.from_numpy(xs).long(), *crop)
    assert got.shape == (b,) + crop + (3,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('dtype', [np.uint8, np.float32])
@pytest.mark.parametrize('size,fill', [(4, 0), (1, 7), (10, 255)])
def test_cutout_apply_matches_jax(dtype, size, fill):
    images = _images(dtype, 4)
    b, h, w, _ = images.shape
    key = jax.random.PRNGKey(size)
    want = np.asarray(jax_augment.random_cutout(key, jnp.asarray(images), size, fill))
    ky, kx = jax.random.split(key)
    ys = np.array(jax.random.randint(ky, (b,), 0, h - size + 1))
    xs = np.array(jax.random.randint(kx, (b,), 0, w - size + 1))
    got = augment.apply_cutout(torch.from_numpy(images), torch.from_numpy(ys).long(),
                               torch.from_numpy(xs).long(), size, fill)
    np.testing.assert_array_equal(got.numpy(), want)


def test_random_ops_draw_from_the_generator():
    images = torch.from_numpy(_images(np.uint8, 5, shape=(64, 8, 8, 3)))
    out = [augment.random_flip_horizontal(torch.Generator().manual_seed(3), images)
           for _ in range(2)]
    assert torch.equal(out[0], out[1])  # same seed, same flips
    flipped = [not torch.equal(a, b) for a, b in zip(out[0], images)]
    assert 16 < sum(flipped) < 48  # about half of 64 at p = 0.5
    assert torch.equal(augment.random_flip_horizontal(torch.Generator(), images, p=0.0), images)
    gen = torch.Generator().manual_seed(4)
    crops = augment.random_crop(gen, images, 3, 5)
    assert crops.shape == (64, 3, 5, 3) and crops.dtype == torch.uint8
    cut = augment.random_cutout(gen, images, 3)
    # exactly one 3x3 square per image is zero, unless it was zero before
    changed = (cut != images).any(-1).sum((1, 2))
    assert (changed <= 9).all() and changed.sum() > 0
    with pytest.raises(ValueError, match='exceeds'):
        augment.random_crop(gen, images, 9, 2)
    with pytest.raises(ValueError, match='exceeds'):
        augment.random_cutout(gen, images, 9)
