"""Smoke run of petastorm_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero and the
final ``{"ok": true, ...}`` line is printed only when every phase passed:

1. ``build``: the card's name and power limit, and the ``nvcc`` build of
   every kernel source in ``petastorm_tpu_torch/csrc`` (all started
   together).
2. ``kernel``: the normalize kernel against its plain PyTorch version on
   the card, at the main path's shape and the others listed in
   ``KERNEL_CASES``, with the kernel's and the plain version's times (see
   ``time_ms``) and the least time the card could take (its bound).
3. ``flash_kernel``: each of the three flash-attention kernels (forward,
   backward dK/dV, backward dQ) against its plain version run in f32 on
   the same inputs, at the shapes in ``FLASH_CASES``, with its time, the
   plain version's, its bound, and ``scaled_dot_product_attention``'s
   forward and forward + backward as the yardstick.
4. ``reference``: the loader on the card against the loader on the CPU
   (same seed, dummy pool, batches held while later ones stage), the
   CNN's f32 logits on the card against the CPU, and the transformer at
   the flagship width with 2 layers (f32, TF32 off, flash attention): its
   logits and one parameter's loss gradient on the card (kernels) against
   the CPU (plain versions).
5. ``main_path``: a 60,000-row synthetic MNIST dataset (the size of the
   real training set) written with the port, then ``TRAIN_STEPS`` SGD
   steps through ``make_torch_loader`` on the card with every batch
   normalized by the kernel; the kernel's launch count must equal the
   steps taken.
6. ``lm_path``: a C4-like dataset of ``LM_DOCS`` variable-length token
   documents written with the port, then ``LM_STEPS`` AdamW steps of the
   full flagship LM (10 layers, d_model 1536, vocab 16384) on batches of 8
   rows packed to 1025 tokens, so that attention runs at 1024 positions
   through the flash kernels; each kernel's launch count must equal
   layers x steps.
7. ``lm_profile``: ``torch.profiler`` over a few more steps of the same
   model: device time per step by kind (each flash kernel, cuBLAS
   matmuls, AdamW, the rest) and the device's idle share.

Then the ``kernels`` summary, the ``nvidia-smi`` name and power limit, and
the ``ok`` line. The script needs CUDA and the repository beside it.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

TIMED_RUNS = 25
TRAIN_STEPS = 50
BATCH_SIZE = 64
MNIST_ROWS = 60000

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and f32 FLOP/s outside
# the tensor cores (the kernel's FMAs are scalar f32)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# (label, shape, out dtype, misaligned view)
KERNEL_CASES = [
    ('mnist_f32', (64, 28, 28, 1), torch.float32, False),
    ('mnist_bf16', (64, 28, 28, 1), torch.bfloat16, False),
    ('imagenet_bf16', (256, 224, 224, 3), torch.bfloat16, False),
    ('ragged_bf16', (3, 7, 5, 3), torch.bfloat16, False),
    ('ragged_f32', (3, 7, 5, 3), torch.float32, False),
    ('misaligned_bf16', (64, 28, 28, 1), torch.bfloat16, True),
    ('misaligned_f32', (5, 9, 11, 3), torch.float32, True),
]
MAIN_PATH_CASE = 'mnist_bf16'
NORMALIZE_REPLACES = 'petastorm_tpu/ops/normalize.py:20'

# dense tensor-core bf16 peak of the H100 SXM (NVIDIA data sheet)
BF16_FLOPS = 989e12

# (label, (B, S, H, D), dtype, causal); the main path runs the first
FLASH_CASES = [
    ('flagship_causal_bf16', (8, 1024, 16, 96), torch.bfloat16, True),
    ('flagship_bidir_bf16', (8, 1024, 16, 96), torch.bfloat16, False),
    ('jax_test_causal_f32', (1, 256, 2, 64), torch.float32, True),
    ('jax_test_bidir_f32', (1, 256, 2, 64), torch.float32, False),
    ('ragged1000_causal_bf16', (2, 1000, 4, 96), torch.bfloat16, True),
    ('ragged77_bidir_f32', (3, 77, 2, 96), torch.float32, False),
    ('d64_causal_bf16', (4, 512, 8, 64), torch.bfloat16, True),
    ('d128_bidir_bf16', (4, 512, 8, 128), torch.bfloat16, False),
    ('d128_ragged_causal_f32', (2, 130, 2, 128), torch.float32, True),
]
FLASH_MAIN_CASE = 'flagship_causal_bf16'
# name -> (launch counter in ops/flash_attention.py, key in a
# flash_kernel case, outputs, the jax Pallas TPU kernel that
# flash_attention_fused (petastorm_tpu/ops/flash_attention.py:59) reaches)
FLASH_KERNELS = {
    'flash_fwd': ('fwd_launches', 'fwd', ('o',),
                  'jax/experimental/pallas/ops/tpu/flash_attention.py:758'),
    'flash_bwd_dkv': ('bwd_dkv_launches', 'dkv', ('dk', 'dv'),
                      'jax/experimental/pallas/ops/tpu/flash_attention.py:1121'),
    'flash_bwd_dq': ('bwd_dq_launches', 'dq', ('dq',),
                     'jax/experimental/pallas/ops/tpu/flash_attention.py:1456'),
}

LM_DOCS = 8192
LM_STEPS = 20
LM_BATCH = 8
LM_SEQ = 1024
LM_PROFILE_STEPS = 3


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], check=True,
                         capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn):
    """Per-call time of ``fn``: ``(device_ms, wall_ms, timer)``.

    ``device_ms`` is the device time of the kernels and copies ``fn``
    issued, from ``torch.profiler`` over TIMED_RUNS calls after warm-up
    (the kernel's own time, without host launch overhead): the median
    call when each call issues one device activity, else the mean; ``wall_ms`` is
    CUDA events around the same run of calls, divided by the count. Where
    the profiler's trace is incomplete (no device time, fewer device
    activities than calls, or a count that is not a multiple of the
    calls: it has been seen to drop events on the card), ``device_ms``
    falls back to ``wall_ms`` and ``timer`` says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMED_RUNS):
        fn()
    end.record()
    end.synchronize()
    wall_ms = start.elapsed_time(end) / TIMED_RUNS
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(TIMED_RUNS):
            fn()
        torch.cuda.synchronize()
    device_us = [e.device_time_total for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
    if not sum(device_us) or len(device_us) % TIMED_RUNS:
        return wall_ms, wall_ms, 'cuda-events'
    if len(device_us) == TIMED_RUNS:
        # one device activity per call: the median call
        return statistics.median(device_us) / 1e3, wall_ms, 'torch.profiler median'
    return sum(device_us) / TIMED_RUNS / 1e3, wall_ms, 'torch.profiler mean'


def bf16_ulp_distance(a, b):
    """Largest distance between two bf16 tensors in units in the last place."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -32768 - i, i)
    return int((ordered(a) - ordered(b)).abs().max())


def phase_build():
    from petastorm_tpu_torch.ops import build
    sources = sorted(f[:-3] for f in os.listdir(build.CSRC_DIR) if f.endswith('.cu'))
    t0 = time.perf_counter()
    build.build(sources)
    emit({'phase': 'build', 'card': card_line(), 'sources': sources,
          'build_s': time.perf_counter() - t0,
          'ptxas': {name: [line for line in entry['log'].splitlines()
                           if 'registers' in line or 'spill' in line]
                    for name, entry in build.build_log.items()}})


def phase_kernel():
    from petastorm_tpu_torch.ops.normalize import (
        normalize_images, normalize_images_reference,
    )
    gen = torch.Generator(device='cuda').manual_seed(0)
    mean3, std3 = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
    results = {}
    for label, shape, out_dtype, misaligned in KERNEL_CASES:
        c = shape[-1]
        mean, std = (mean3, std3) if c == 3 else ([0.1307], [0.3081])
        numel = math.prod(shape)
        if misaligned:
            flat = torch.randint(0, 256, (numel + 1,), dtype=torch.uint8,
                                 device='cuda', generator=gen)
            x = flat[1:].view(shape)
            assert x.data_ptr() % 16 != 0
        else:
            x = torch.randint(0, 256, shape, dtype=torch.uint8, device='cuda',
                              generator=gen)
        got = normalize_images(x, mean, std, out_dtype)
        want = normalize_images_reference(x, mean, std, out_dtype)
        torch.cuda.synchronize()
        assert got.shape == x.shape and got.dtype == out_dtype and got.is_cuda
        max_abs_err = float((got.float() - want.float()).abs().max())
        if out_dtype == torch.float32:
            tolerance = 'f32 atol 1e-5'
            ok = max_abs_err <= 1e-5
            ulps = None
        else:
            tolerance = 'bf16 <= 1 ulp'
            ulps = bf16_ulp_distance(got, want)
            ok = ulps <= 1
        kernel_t = time_ms(lambda: normalize_images(x, mean, std, out_dtype))
        plain_t = time_ms(lambda: normalize_images_reference(x, mean, std, out_dtype))
        out_bytes = torch.empty((), dtype=out_dtype).element_size()
        bytes_ms = numel * (1 + out_bytes) / HBM_BYTES_PER_S * 1e3
        ops_ms = 2 * numel / F32_FLOPS * 1e3
        results[label] = {
            'shape': list(shape), 'out_dtype': str(out_dtype).replace('torch.', ''),
            'misaligned': misaligned, 'max_abs_err': max_abs_err, 'max_ulps': ulps,
            'tolerance': tolerance, 'ok': ok,
            'ms': kernel_t[0], 'wall_ms': kernel_t[1], 'timer': kernel_t[2],
            'plain_ms': plain_t[0], 'plain_wall_ms': plain_t[1],
            'bound_ms': max(bytes_ms, ops_ms),
            'bound_by': 'bytes' if bytes_ms >= ops_ms else 'operations',
        }
    emit({'phase': 'kernel', 'kernel': 'normalize_images',
          'library_yardstick': 'none: no single PyTorch call computes a fused '
                               'uint8 -> affine -> bf16/f32 normalize',
          'cases': results})
    bad = [label for label, r in results.items() if not r['ok']]
    if bad:
        raise AssertionError('normalize kernel disagrees with its plain version: %s' % bad)
    return results


def flash_bound_ms(kernel, shape, dtype, causal):
    """The least time the card could take for one call of a flash kernel:
    the larger of its operations over the peak for its input type (bf16
    tensor cores; f32 FMA pipes for f32) and its tensors, each read or
    written once, over HBM's rate. Causal counts the S(S+1)/2 visible
    score pairs."""
    b, s, h, d = shape
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = {'fwd': 4, 'dkv': 8, 'dq': 6}[kernel] * b * h * pairs * d
    n = b * s * h * d * torch.empty((), dtype=dtype).element_size()
    rows = b * h * s * 4  # one f32 per (b, h, row): lse, Di
    nbytes = {'fwd': 3 * n + n + rows,               # q, k, v -> o, lse
              'dkv': 4 * n + 2 * rows + 2 * n,       # q, k, v, dO, lse, Di -> dk, dv
              'dq': 4 * n + 2 * rows + n}[kernel]    # q, k, v, dO, lse, Di -> dq
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    ops_ms = flops / peak * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), 'operations' if ops_ms >= bytes_ms else 'bytes'


def phase_flash_kernel():
    """Each flash kernel against its plain version in f32 on the same
    inputs. The backward kernels take the plain forward's lse and Di, so
    each kernel is held alone. Tolerances: f32 as the JAX package's kernel
    tests, elementwise ``|err| <= 2e-5 + 2e-5|ref|`` on O and
    ``5e-4 + 5e-4|ref|`` on the grads; bf16 max-abs 2e-2 on O and 2e-2 on
    each grad divided by its max-abs (the kernel's one rounding of its f32
    result to bf16 is at most 2^-9 of a value); lse ``|err| <= 1e-4``."""
    import torch.nn.functional as F
    from petastorm_tpu_torch.ops import flash_attention as fa
    results = {}
    for seed, (label, shape, dtype, causal) in enumerate(FLASH_CASES):
        gen = torch.Generator(device='cuda').manual_seed(seed)
        q, k, v, do = (torch.randn(shape, generator=gen, device='cuda').to(dtype)
                       for _ in range(4))
        scale = 1.0 / math.sqrt(shape[-1])
        qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
        o_ref, lse_ref = fa.flash_fwd_reference(qf, kf, vf, causal, scale)
        di = fa.attention_delta(o_ref, dof)
        dk_ref, dv_ref = fa.flash_bwd_dkv_reference(qf, kf, vf, dof, lse_ref, di, causal,
                                                    scale)
        dq_ref = fa.flash_bwd_dq_reference(qf, kf, vf, dof, lse_ref, di, causal, scale)
        o, lse = fa.flash_fwd(q, k, v, causal, scale)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_ref, di, causal, scale)
        dq = fa.flash_bwd_dq(q, k, v, do, lse_ref, di, causal, scale)
        torch.cuda.synchronize()

        def err(got, want, rtol):
            diff = (got.float() - want).abs()
            return {'max_abs_err': float(diff.max()),
                    'scaled_err': float(diff.max() / want.abs().max()),
                    # max of |err| - rtol|ref|: at most atol where allclose holds
                    'allclose_excess': float((diff - rtol * want.abs()).max()),
                    'finite': bool(torch.isfinite(got).all())}

        errs = {'o': err(o, o_ref, 2e-5), 'dk': err(dk, dk_ref, 5e-4),
                'dv': err(dv, dv_ref, 5e-4), 'dq': err(dq, dq_ref, 5e-4)}
        lse_err = float((lse - lse_ref).abs().max())
        if dtype == torch.float32:
            tolerance = 'f32: |err| <= atol + rtol|ref|, O 2e-5/2e-5, grads 5e-4/5e-4'
            ok = (errs['o']['allclose_excess'] <= 2e-5
                  and all(errs[g]['allclose_excess'] <= 5e-4 for g in ('dk', 'dv', 'dq')))
        else:
            tolerance = 'bf16 vs f32 plain: O max-abs <= 2e-2, grads max-abs/max|ref| <= 2e-2'
            ok = (errs['o']['max_abs_err'] <= 2e-2
                  and all(errs[g]['scaled_err'] <= 2e-2 for g in ('dk', 'dv', 'dq')))
        ok = ok and lse_err <= 1e-4 and all(e['finite'] for e in errs.values())

        fwd_args = (q, k, v, causal, scale)
        bwd_args = (q, k, v, do, lse_ref, di, causal, scale)
        timed = {
            'fwd': (lambda: fa.flash_fwd(*fwd_args), lambda: fa.flash_fwd_reference(*fwd_args)),
            'dkv': (lambda: fa.flash_bwd_dkv(*bwd_args),
                    lambda: fa.flash_bwd_dkv_reference(*bwd_args)),
            'dq': (lambda: fa.flash_bwd_dq(*bwd_args),
                   lambda: fa.flash_bwd_dq_reference(*bwd_args)),
        }
        kernels = {}
        for name, (kernel_fn, plain_fn) in timed.items():
            kernel_t = time_ms(kernel_fn)
            plain_t = time_ms(plain_fn)
            bound, bound_by = flash_bound_ms(name, shape, dtype, causal)
            kernels[name] = {'ms': kernel_t[0], 'wall_ms': kernel_t[1], 'timer': kernel_t[2],
                             'plain_ms': plain_t[0], 'plain_wall_ms': plain_t[1],
                             'bound_ms': bound, 'bound_by': bound_by}
        # the yardstick: PyTorch's fused attention in (B, H, S, D) views
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, scale=scale)

        sdpa_fwd = time_ms(lambda: sdpa().detach())
        sdpa_fwd_bwd = time_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot))
        results[label] = {
            'shape': list(shape), 'dtype': str(dtype).replace('torch.', ''),
            'causal': causal, 'errors': errs, 'lse_max_abs_err': lse_err,
            'tolerance': tolerance, 'ok': ok, 'kernels': kernels,
            'sdpa_fwd_ms': sdpa_fwd[0], 'sdpa_fwd_bwd_ms': sdpa_fwd_bwd[0],
        }
    emit({'phase': 'flash_kernel', 'cases': results})
    bad = [label for label, r in results.items() if not r['ok']]
    if bad:
        raise AssertionError('flash kernels disagree with their plain versions: %s' % bad)
    return results


def phase_lm_reference():
    """The transformer at the flagship width with 2 layers, f32 (TF32 off)
    with flash attention: logits and one parameter's loss gradient on the
    card (the kernels) against the CPU (the plain versions)."""
    import numpy as np
    from petastorm_tpu_torch.examples.lm_pretrain import FLAGSHIP_LM_KW
    from petastorm_tpu_torch.models.transformer import (
        TransformerConfig, init_transformer, transformer_forward, transformer_loss,
    )
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    config = TransformerConfig(**dict(FLAGSHIP_LM_KW, n_layers=2), max_seq_len=128,
                               attn_impl='flash', dtype=torch.float32)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, config.vocab_size, (2, 129)).astype(np.int32))
    out = {}
    for device in ('cpu', 'cuda'):
        model = init_transformer(0, config, device)
        t = tokens.to(device)
        with torch.no_grad():
            logits = transformer_forward(model, t[:, :-1])
        transformer_loss(model, t).backward()
        out[device] = (logits.cpu(), model.blocks[0].qkv.grad.cpu())
    (want, want_grad), (got, got_grad) = out['cpu'], out['cuda']
    logits_err = float((got - want).abs().max())
    grad_err = float((got_grad - want_grad).abs().max() / want_grad.abs().max())
    emit({'phase': 'reference', 'model': 'transformer flagship width, 2 layers, f32, flash',
          'logits_shape': list(got.shape), 'logits_max_abs_err': logits_err,
          'logits_tolerance': 'atol 1e-4 (f32, TF32 off)',
          'grad': 'blocks.0.qkv', 'grad_err_over_max_abs': grad_err,
          'grad_tolerance': 'max-abs err / max|grad| <= 1e-4'})
    assert torch.isfinite(got).all() and got.shape == (2, 128, config.vocab_size)
    assert logits_err <= 1e-4, logits_err
    assert grad_err <= 1e-4, grad_err


def reset_launch_counts():
    from petastorm_tpu_torch.ops import flash_attention, normalize
    normalize.launches = 0
    for counter, *_ in FLASH_KERNELS.values():
        setattr(flash_attention, counter, 0)


def launch_counts():
    from petastorm_tpu_torch.ops import flash_attention, normalize
    counts = {name: getattr(flash_attention, counter)
              for name, (counter, *_) in FLASH_KERNELS.items()}
    counts['normalize_images'] = normalize.launches
    return counts


def stage_seconds():
    """Host seconds per pipeline stage, summed over threads (the decode
    workers overlap, so the sum can exceed the wall time)."""
    from petastorm_tpu_torch.telemetry import get_registry
    prefix = 'petastorm_tpu_stage_seconds_total{stage="'
    return {k[len(prefix):-2]: v for k, v in
            get_registry().snapshot()['counters'].items() if k.startswith(prefix)}


def phase_lm_path(url):
    from petastorm_tpu_torch.examples.lm_pretrain import FLAGSHIP_LM_KW, pretrain
    from petastorm_tpu_torch.telemetry import reset_registry
    reset_registry()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    result = pretrain(url, batch_size=LM_BATCH, steps=LM_STEPS, seq_len=LM_SEQ,
                      model_kw=FLAGSHIP_LM_KW, attn_impl='flash', device='cuda')
    torch.cuda.synchronize()
    launches = launch_counts()
    losses = result['losses']
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    emit({'phase': 'lm_path', 'model': FLAGSHIP_LM_KW, 'steps': len(losses),
          'batch_size': LM_BATCH, 'attention_positions': LM_SEQ,
          'packed_row_tokens': LM_SEQ + 1, 'launches': launches,
          'batch_devices': result['batch_devices'], 'losses': losses,
          'loss_first5_mean': first, 'loss_last5_mean': last,
          'tokens_per_s': result['tokens_per_s'], 'steps_per_s': result['steps_per_s'],
          'peak_memory_bytes': torch.cuda.max_memory_allocated(),
          'stage_seconds': stage_seconds()})
    assert len(losses) == LM_STEPS
    assert all(math.isfinite(v) for v in losses), losses
    assert last < first, (first, last)
    assert result['batch_devices'] == ['cuda:0'], result['batch_devices']
    want = FLAGSHIP_LM_KW['n_layers'] * LM_STEPS
    for name in FLASH_KERNELS:
        assert launches[name] == want, (name, launches[name], want)
    return launches


def _kernel_kind(name):
    """The layer a device activity of a train step belongs to, by name."""
    for kernel in FLASH_KERNELS:
        if kernel + '_kernel' in name:
            return kernel
    low = name.lower()
    if any(tag in low for tag in ('gemm', 'xmma', 'nvjet', 'cublas', 'cutlass')):
        return 'matmul (cuBLAS)'
    if 'multi_tensor_apply' in low or 'adam' in low:
        return 'optimizer (AdamW)'
    if 'memcpy' in low or 'memset' in low:
        return 'copy/memset'
    return 'other (elementwise, norms, softmax, loss)'


def phase_lm_profile():
    """Where a flagship step's device time goes: ``torch.profiler`` over
    ``LM_PROFILE_STEPS`` train steps (after 2 warm-up steps) of the same
    model on one packed batch, device time summed by kind, and the
    device's idle share of its window (profiling adds host work, so the
    share is an upper bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from petastorm_tpu_torch.examples.lm_pretrain import FLAGSHIP_LM_KW
    from petastorm_tpu_torch.models.transformer import (
        TransformerConfig, init_transformer, transformer_train_step,
    )
    config = TransformerConfig(max_seq_len=LM_SEQ, loss_chunk=256, attn_impl='flash',
                               **FLAGSHIP_LM_KW)
    model = init_transformer(0, config, 'cuda')
    step = transformer_train_step(model, torch.optim.AdamW(
        model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4))
    gen = torch.Generator(device='cuda').manual_seed(0)
    tokens = torch.randint(2, config.vocab_size, (LM_BATCH, LM_SEQ + 1), generator=gen,
                           device='cuda', dtype=torch.int32)
    for _ in range(2):
        step(tokens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(LM_PROFILE_STEPS):
            step(tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / LM_PROFILE_STEPS
    kinds = {}
    spans = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kind = _kernel_kind(e.name)
            kinds[kind] = kinds.get(kind, 0.0) + e.device_time_total / 1e3 / LM_PROFILE_STEPS
            spans.append((e.time_range.start, e.time_range.end))
    assert spans, 'the profiler saw no device time'
    # busy = the union of the device activities' intervals, over the
    # device's window from the first start to the last end
    spans.sort()
    busy_us, reach = 0.0, spans[0][0]
    for start, end in spans:
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    window_us = reach - spans[0][0]
    emit({'phase': 'lm_profile', 'steps': LM_PROFILE_STEPS, 'step_wall_ms': wall_ms,
          'device_window_ms_per_step': window_us / 1e3 / LM_PROFILE_STEPS,
          'device_busy_ms_per_step': busy_us / 1e3 / LM_PROFILE_STEPS,
          'idle_share': 1 - busy_us / window_us,
          'device_ms_per_step': dict(sorted(kinds.items(), key=lambda kv: -kv[1])),
          'share_of_device_time': {k: v / sum(kinds.values()) for k, v in kinds.items()}})


def phase_reference(url):
    """The loader on the card against the loader on the CPU, and the CNN's
    f32 logits on the card against the CPU."""
    from petastorm_tpu_torch.device.loader import make_torch_loader
    from petastorm_tpu_torch.models.mnist import init_mnist

    def batches(device, count):
        with make_torch_loader(url, batch_size=BATCH_SIZE, fields=['^digit$', '^image$'],
                               shuffle_rows=True, seed=0, device=device,
                               reader_pool_type='dummy') as loader:
            # all batches held: a recycled slot must not touch a held batch
            return [b for _, b in zip(range(count), loader)]

    on_card = batches('cuda', 20)
    on_host = batches('cpu', 20)
    torch.cuda.synchronize()
    assert all(t.is_cuda for b in on_card for t in b.values())
    for a, b in zip(on_card, on_host):
        assert sorted(a) == sorted(b)
        for name in a:
            assert torch.equal(a[name].cpu(), b[name]), name

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    images = on_host[0]['image'][..., None].float() / 255.0
    model_cpu = init_mnist(0, 'cpu', dtype=torch.float32)
    model_gpu = init_mnist(0, 'cuda', dtype=torch.float32)
    with torch.no_grad():
        want = model_cpu(images)
        got = model_gpu(images.cuda()).cpu()
    logits_err = float((got - want).abs().max())
    assert got.shape == (BATCH_SIZE, 10) and torch.isfinite(got).all()
    assert logits_err <= 1e-4, logits_err
    emit({'phase': 'reference', 'loader_batches_compared': len(on_card),
          'loader_equal': True, 'logits_f32_max_abs_err': logits_err,
          'logits_tolerance': 'atol 1e-4 (f32, TF32 off)'})


def phase_main_path(url):
    from petastorm_tpu_torch.examples.mnist import train
    from petastorm_tpu_torch.telemetry import reset_registry
    reset_registry()
    reset_launch_counts()
    result = train(url, batch_size=BATCH_SIZE, steps=TRAIN_STEPS, device='cuda')
    torch.cuda.synchronize()
    launches = launch_counts()
    losses = result['losses']
    first, last = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
    emit({'phase': 'main_path', 'rows': MNIST_ROWS, 'steps': len(losses),
          'batch_size': BATCH_SIZE, 'launches': launches,
          'batch_devices': result['batch_devices'],
          'loss_first10_mean': first, 'loss_last10_mean': last,
          'rows_per_s': result['rows_per_s'], 'steps_per_s': result['steps_per_s'],
          'stage_seconds': stage_seconds()})
    assert len(losses) == TRAIN_STEPS
    assert all(math.isfinite(v) for v in losses)
    assert last < first, (first, last)
    assert result['batch_devices'] == ['cuda:0'], result['batch_devices']
    assert launches['normalize_images'] == TRAIN_STEPS, launches
    return launches['normalize_images']


def write_lm_dataset(url):
    from petastorm_tpu_torch.examples.lm_pretrain import FLAGSHIP_LM_KW, generate_c4_like
    from petastorm_tpu_torch.reader import make_batch_reader
    t0 = time.perf_counter()
    generate_c4_like(url, num_docs=LM_DOCS, vocab_size=FLAGSHIP_LM_KW['vocab_size'], seed=0)
    seconds = time.perf_counter() - t0
    with make_batch_reader(url, reader_pool_type='dummy', num_epochs=1) as reader:
        tokens = sum(len(doc) for batch in reader for doc in batch.tokens)
    emit({'phase': 'write', 'dataset': 'c4_like', 'documents': LM_DOCS,
          'tokens': tokens, 'seconds': seconds})


def main():
    if not torch.cuda.is_available():
        print('chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False',
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    phase_build()
    kernel = phase_kernel()
    flash = phase_flash_kernel()
    from petastorm_tpu_torch.examples.mnist import generate_synthetic_mnist
    with tempfile.TemporaryDirectory() as tmp:
        url = 'file://' + os.path.join(tmp, 'mnist')
        t0 = time.perf_counter()
        generate_synthetic_mnist(url, num_rows=MNIST_ROWS)
        emit({'phase': 'write', 'rows': MNIST_ROWS, 'seconds': time.perf_counter() - t0})
        phase_reference(url)
        phase_lm_reference()
        normalize_launches = phase_main_path(url)
        lm_url = 'file://' + os.path.join(tmp, 'c4_like')
        write_lm_dataset(lm_url)
        lm_launches = phase_lm_path(lm_url)
    phase_lm_profile()
    main_case = kernel[MAIN_PATH_CASE]
    kernels = [{
        'name': 'normalize_images', 'route': 'cuda',
        'source': 'petastorm_tpu_torch/csrc/normalize.cu',
        'replaces': NORMALIZE_REPLACES, 'launches': normalize_launches,
        'max_abs_err': main_case['max_abs_err'], 'ms': main_case['ms'],
        'wall_ms': main_case['wall_ms'], 'timer': main_case['timer'],
        'plain_ms': main_case['plain_ms'], 'bound_ms': main_case['bound_ms'],
        'bound_by': main_case['bound_by'], 'library_ms': None,
        'shape': main_case['shape'],
        'imagenet_bf16': {k: kernel['imagenet_bf16'][k]
                          for k in ('ms', 'wall_ms', 'plain_ms', 'bound_ms',
                                    'max_abs_err')},
    }]
    flash_case = flash[FLASH_MAIN_CASE]
    for name, (_, key, outputs, replaces) in FLASH_KERNELS.items():
        timing = flash_case['kernels'][key]
        kernels.append({
            'name': name, 'route': 'cuda',
            'source': 'petastorm_tpu_torch/csrc/flash_attention.cu',
            'replaces': replaces, 'launches': lm_launches[name],
            'max_abs_err': max(flash_case['errors'][g]['max_abs_err'] for g in outputs),
            'ms': timing['ms'], 'wall_ms': timing['wall_ms'], 'timer': timing['timer'],
            'plain_ms': timing['plain_ms'], 'bound_ms': timing['bound_ms'],
            'bound_by': timing['bound_by'],
            # one PyTorch call computes the forward alone; none computes
            # dK/dV or dQ alone (SDPA's backward makes all three)
            'library_ms': flash_case['sdpa_fwd_ms'] if name == 'flash_fwd' else None,
            'sdpa_fwd_ms': flash_case['sdpa_fwd_ms'],
            'sdpa_fwd_bwd_ms': flash_case['sdpa_fwd_bwd_ms'],
            'shape': flash_case['shape'], 'dtype': flash_case['dtype'], 'causal': True,
        })
    emit({'kernels': kernels, 'seconds': time.perf_counter() - t_start})
    print(card_line(), flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
