"""Fused self-attention: the hand-written Hopper flash-attention kernels.

Counterpart of ``petastorm_tpu/ops/flash_attention.py``. Three CUDA
kernels in ``csrc/flash_attention.cu`` replace the three Pallas TPU
kernels that the JAX module reaches (forward, backward dK/dV, backward
dQ); :class:`_FlashAttention` puts them behind autograd. Each kernel has
a plain PyTorch version here with the kernel's signature.

On a CUDA tensor :func:`flash_attention_fused` launches the kernels or
raises: there is no dense branch on the card. On a CPU tensor it runs the
plain versions through the same ``autograd.Function``, so the backward
formulas the kernels implement are the ones the CPU tests exercise. The
kernels take any S ≥ 1 (the tail tile is masked) and a head dim D ≤ 128
that is a multiple of 8. bf16 inputs run all three kernels on the tensor
cores (``wgmma``), which copy rows in 16-byte pieces: a bf16 view whose
rows are not 16-byte aligned is copied first. f32 inputs run scalar f32
kernels.
"""

import ctypes
import functools
import math

import torch

from petastorm_tpu_torch.ops import build
from petastorm_tpu_torch.ops.ring_attention import reference_attention

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128

#: kernel launches made in this process, per kernel
fwd_launches = 0
bwd_dkv_launches = 0
bwd_dq_launches = 0


def reference_causal_attention(q, k, v, sm_scale):
    """Dense causal attention oracle (the one in :mod:`.ring_attention`)."""
    return reference_attention(q, k, v, causal=True, scale=sm_scale)


def kernel_supported(seq_len):
    """Would :func:`flash_attention_fused` run the kernels for this
    sequence length on the current device? On a CUDA device every
    ``seq_len >= 1`` does; without one nothing does."""
    return torch.cuda.is_available() and seq_len >= 1


def _check(q, k, v):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError('flash attention takes q, k, v of one (B, S, H, D) shape; got '
                         '%s, %s, %s' % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if not q.dtype == k.dtype == v.dtype or q.dtype not in _DTYPES:
        raise TypeError('flash attention takes bfloat16 or float32 q, k, v of one dtype; '
                        'got %s, %s, %s' % (q.dtype, k.dtype, v.dtype))
    d = q.shape[-1]
    if d % 8 or not 8 <= d <= _MAX_HEAD_DIM:
        raise ValueError('flash attention takes a head dim that is a multiple of 8 '
                         'and at most %d; got %d' % (_MAX_HEAD_DIM, d))
    if q.shape[1] < 1:
        raise ValueError('flash attention needs a sequence of at least 1')
    if not q.device == k.device == v.device:
        raise ValueError('q, k, v lie on different devices')


# -- plain PyTorch versions, one per kernel -----------------------------------

def _probs(q, k, lse, causal, sm_scale):
    """``P = exp(scale·QKᵀ − lse)`` in f32, ``(B, H, S, S)``, masked to 0."""
    scores = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * sm_scale
    p = torch.exp(scores - lse[..., None])
    if causal:
        s = q.shape[1]
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        p = p.masked_fill(~mask, 0.0)
    return p


def flash_fwd_reference(q, k, v, causal, sm_scale):
    """Plain version of the forward kernel: ``(o, lse)`` with ``o`` in
    ``q.dtype`` ``(B, S, H, D)`` and ``lse`` f32 ``(B, H, S)``."""
    scores = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * sm_scale
    if causal:
        s = q.shape[1]
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float('-inf'))
    lse = torch.logsumexp(scores, dim=-1)
    p = torch.exp(scores - lse[..., None])
    o = torch.einsum('bhqk,bkhd->bqhd', p, v.float())
    return o.to(q.dtype), lse


def _dscores(q, k, v, do, lse, di, causal, sm_scale):
    p = _probs(q, k, lse, causal, sm_scale)
    dp = torch.einsum('bqhd,bkhd->bhqk', do.float(), v.float())
    return p, p * (dp - di[..., None])


def flash_bwd_dkv_reference(q, k, v, do, lse, di, causal, sm_scale):
    """Plain version of the dK/dV kernel: ``dV = Pᵀ·dO`` and
    ``dK = scale·dSᵀ·Q`` with ``dS = P∘(dO·Vᵀ − Di)``, ``Di = rowsum(dO∘O)``
    f32 ``(B, H, S)``."""
    p, ds = _dscores(q, k, v, do, lse, di, causal, sm_scale)
    dv = torch.einsum('bhqk,bqhd->bkhd', p, do.float())
    dk = torch.einsum('bhqk,bqhd->bkhd', ds, q.float()) * sm_scale
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_reference(q, k, v, do, lse, di, causal, sm_scale):
    """Plain version of the dQ kernel: ``dQ = scale·dS·K``."""
    _, ds = _dscores(q, k, v, do, lse, di, causal, sm_scale)
    return (torch.einsum('bhqk,bkhd->bqhd', ds, k.float()) * sm_scale).to(q.dtype)


# -- the kernels ----------------------------------------------------------------

@functools.cache
def _kernels():
    """The three C entry points, built and bound on first use."""
    lib = build.load('flash_attention')
    p, i = ctypes.c_void_p, ctypes.c_int
    tail = [ctypes.POINTER(ctypes.c_longlong), i, i, i, i, i, ctypes.c_float, i, p]
    fwd, dkv, dq = lib.pt_flash_fwd, lib.pt_flash_bwd_dkv, lib.pt_flash_bwd_dq
    fwd.argtypes = [p] * 5 + tail
    dkv.argtypes = [p] * 8 + tail
    dq.argtypes = [p] * 7 + tail
    for fn in (fwd, dkv, dq):
        fn.restype = ctypes.c_int
    return fwd, dkv, dq


def _strides(*tensors):
    """``(b, s, h)`` element strides of each ``(B, S, H, D)`` tensor, which
    the kernels take with a unit stride on D."""
    flat = []
    for t in tensors:
        if t.stride(-1) != 1:
            raise ValueError('the flash kernels need a unit stride on the head dim')
        flat.extend(t.stride()[:3])
    return (ctypes.c_longlong * len(flat))(*flat)


def _rows_aligned(t):
    """Can the tensor-core kernels copy ``t``'s rows in 16-byte pieces: a
    16-byte aligned pointer and ``(b, s, h)`` strides in multiples of 8?"""
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])


def _tensor_core_operand(t):
    """``t`` itself, or a contiguous copy of a bf16 view with a unit stride
    on D that the tensor-core kernels could not read in place."""
    if t.dtype != torch.bfloat16 or t.stride(-1) != 1 or _rows_aligned(t):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _launch(fn, name, pointers, tensors, q, causal, sm_scale):
    b, s, h, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*pointers, _strides(*tensors), b, s, h, d, int(causal), float(sm_scale),
                 _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError('flash attention %s kernel launch failed: cudaError %d' % (name, err))


def _device_kind(q):
    if q.device.type not in ('cuda', 'cpu'):
        raise ValueError('flash attention runs on cuda or cpu tensors, got %s' % q.device)
    return q.device.type


def flash_fwd(q, k, v, causal, sm_scale):
    """Forward: ``(o, lse)``; the kernel on a CUDA tensor, the plain version
    on a CPU tensor."""
    global fwd_launches
    _check(q, k, v)
    if _device_kind(q) == 'cpu':
        return flash_fwd_reference(q, k, v, causal, sm_scale)
    q, k, v = (_tensor_core_operand(t) for t in (q, k, v))
    b, s, h, _ = q.shape
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _launch(_kernels()[0], 'forward',
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr()],
            [q, k, v, o], q, causal, sm_scale)
    fwd_launches += 1
    return o, lse


def _bwd_inputs(q, do, lse, di):
    b, s, h, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError('dO must match q in shape, dtype and device')
    for name, t in (('lse', lse), ('Di', di)):
        if t.shape != (b, h, s) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError('%s must be a contiguous f32 (B, H, S) tensor' % name)


def flash_bwd_dkv(q, k, v, do, lse, di, causal, sm_scale):
    """Backward ``(dk, dv)``; the kernel on a CUDA tensor, the plain version
    on a CPU tensor."""
    global bwd_dkv_launches
    _check(q, k, v)
    _bwd_inputs(q, do, lse, di)
    if _device_kind(q) == 'cpu':
        return flash_bwd_dkv_reference(q, k, v, do, lse, di, causal, sm_scale)
    q, k, v, do = (_tensor_core_operand(t) for t in (q, k, v, do))
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch(_kernels()[1], 'dK/dV',
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             di.data_ptr(), dk.data_ptr(), dv.data_ptr()],
            [q, k, v, do, dk, dv], q, causal, sm_scale)
    bwd_dkv_launches += 1
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, di, causal, sm_scale):
    """Backward ``dq``; the kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    global bwd_dq_launches
    _check(q, k, v)
    _bwd_inputs(q, do, lse, di)
    if _device_kind(q) == 'cpu':
        return flash_bwd_dq_reference(q, k, v, do, lse, di, causal, sm_scale)
    q, k, v, do = (_tensor_core_operand(t) for t in (q, k, v, do))
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(_kernels()[2], 'dQ',
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             di.data_ptr(), dq.data_ptr()],
            [q, k, v, do, dq], q, causal, sm_scale)
    bwd_dq_launches += 1
    return dq


def attention_delta(o, do):
    """``Di = rowsum(dO∘O)`` as f32 ``(B, H, S)``: plain torch, outside the
    kernels, as in the JAX backward."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


class _FlashAttention(torch.autograd.Function):
    """Forward kernel; backward = ``Di`` in torch, then the dK/dV and dQ
    kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        o, lse = flash_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        di = attention_delta(o, do)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, di, ctx.causal, ctx.sm_scale)
        dq = flash_bwd_dq(q, k, v, do, lse, di, ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention_fused(q, k, v, causal=True, sm_scale=None):
    """Self-attention through the flash kernels.

    :param q, k, v: ``(B, S, H, D)`` activations (the framework layout),
        bfloat16 or float32; any strides with a unit stride on D.
    :param causal: lower-triangular mask (LM) or bidirectional (encoder).
    :param sm_scale: score scale; default ``1/sqrt(D)``.
    :return: ``(B, S, H, D)`` context, same dtype as ``q``.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, bool(causal), float(sm_scale))


def flash_causal_attention(q, k, v, sm_scale=None):
    """Causal flash attention: :func:`flash_attention_fused` with the LM mask."""
    return flash_attention_fused(q, k, v, causal=True, sm_scale=sm_scale)
