"""uint8 → bf16/f32 image normalization: ``(x/255 - mean)/std`` per channel.

Counterpart of ``petastorm_tpu/ops/normalize.py``. On a CUDA tensor
:func:`normalize_images` launches the hand-written Hopper kernel in
``csrc/normalize.cu`` (it replaces the Pallas ``_norm_kernel``) or raises;
on a CPU tensor it runs :func:`normalize_images_reference`, the plain
PyTorch version of the same arithmetic. Layout stays NHWC, as in the
JAX package.
"""

import ctypes
import functools

import torch

from petastorm_tpu_torch.ops import build

_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1}
_MAX_CHANNELS = 4

#: kernel launches made by :func:`normalize_images` in this process
launches = 0


@functools.cache
def _kernel():
    """The kernel's C entry point, built and bound on first use."""
    fn = build.load('normalize').pt_normalize_u8
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _affine(mean, std):
    """``scale = 1/(255*std)`` and ``bias = -mean/std`` in f32, exactly as
    the JAX package precomputes them."""
    mean = torch.as_tensor(mean, dtype=torch.float32).cpu().reshape(-1)
    std = torch.as_tensor(std, dtype=torch.float32).cpu().reshape(-1)
    return 1.0 / (255.0 * std), -mean / std


def _check(images, mean, std, out_dtype):
    if images.dtype != torch.uint8:
        raise TypeError('normalize_images takes uint8 images, got %s' % images.dtype)
    if images.dim() != 4:
        raise ValueError('normalize_images takes NHWC images, got shape %s'
                         % (tuple(images.shape),))
    if out_dtype not in _OUT_KINDS:
        raise TypeError('out_dtype must be torch.bfloat16 or torch.float32, got %s'
                        % (out_dtype,))
    c = images.shape[-1]
    scale, bias = _affine(mean, std)
    if scale.numel() != c or bias.numel() != c:
        raise ValueError('mean/std need one value per channel (%d), got %d and %d'
                         % (c, scale.numel(), bias.numel()))
    return scale, bias


def normalize_images_reference(images, mean, std, out_dtype=torch.bfloat16):
    """Plain PyTorch version: ``(x.float() * scale + bias).to(out_dtype)``."""
    scale, bias = _check(images, mean, std, out_dtype)
    scale, bias = scale.to(images.device), bias.to(images.device)
    return (images.float() * scale + bias).to(out_dtype)


def normalize_images(images, mean, std, out_dtype=torch.bfloat16):
    """Normalize a uint8 NHWC batch ``(N, H, W, C)``, C ≤ 4.

    :param mean: per-channel mean in [0, 1], C values.
    :param std: per-channel std in [0, 1], C values.
    :param out_dtype: ``torch.bfloat16`` (default) or ``torch.float32``.
    """
    global launches
    if images.device.type == 'cpu':
        return normalize_images_reference(images, mean, std, out_dtype)
    if images.device.type != 'cuda':
        raise ValueError('normalize_images runs on cuda or cpu tensors, got %s'
                         % images.device)
    scale, bias = _check(images, mean, std, out_dtype)
    if not images.is_contiguous():
        raise ValueError('normalize_images needs a contiguous NHWC tensor')
    c = images.shape[-1]
    if c > _MAX_CHANNELS:
        raise ValueError('the normalize kernel takes at most %d channels, got %d'
                         % (_MAX_CHANNELS, c))
    out = torch.empty(images.shape, dtype=out_dtype, device=images.device)
    if images.numel() == 0:
        return out
    c_scale = (ctypes.c_float * c)(*scale.tolist())
    c_bias = (ctypes.c_float * c)(*bias.tolist())
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream(images.device).cuda_stream
        err = _kernel()(images.data_ptr(), out.data_ptr(), images.numel(), c,
                        c_scale, c_bias, _OUT_KINDS[out_dtype], stream)
    if err != 0:
        raise RuntimeError('normalize kernel launch failed: cudaError %d' % err)
    launches += 1
    return out
