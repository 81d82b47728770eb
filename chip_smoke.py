"""Smoke run of petastorm_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero and the
final ``{"ok": true, ...}`` line is printed only when every phase passed:

1. ``build``: the card's name and power limit, the ``nvcc`` build of
   every kernel source in ``petastorm_tpu_torch/csrc`` and the ``cc``
   build of the native host decoders in ``petastorm_tpu_torch/native``
   (all started together), and a ``probe`` of the machine's image stack
   (cv2, the libjpeg, libpng, zlib and Python headers, ``ldconfig``).
   Which decoders built decides the image codec of the ViT data: JPEG
   with libjpeg and cv2, else PNG with zlib and cv2, else raw ``.npy``.
2. ``kernel``: the normalize kernel against its plain PyTorch version on
   the card, at the main path's shape and the others listed in
   ``KERNEL_CASES``, with the kernel's and the plain version's times (see
   ``time_ms``) and the least time the card could take (its bound).
3. ``flash_kernel``: each of the three flash-attention kernels (forward,
   backward dK/dV, backward dQ) against its plain version run in f32 on
   the same inputs, at the shapes in ``FLASH_CASES``, with its time, the
   plain version's, its bound, and ``scaled_dot_product_attention``'s
   forward, backward and forward + backward as the yardstick.
4. ``reference``: the loader on the card against the loader on the CPU
   (same seed, dummy pool, batches held while later ones stage), the
   CNN's f32 logits on the card against the CPU, and the transformer at
   the flagship width with 2 layers (f32, TF32 off, flash attention): its
   logits and one parameter's loss gradient on the card (kernels) against
   the CPU (plain versions). ``reference_bf16``: the same model in bf16 at
   1024 positions on the card, flash attention (the tensor-core kernels)
   against dense attention with the same weights.
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
   matmuls, AdamW, the rest), the device's idle share, and the names of
   the flash kernels the step ran: every one must be a tensor-core
   (``wgmma``) kernel, since the step is bf16.
8. ``native_decode``: each native decoder that built against the per-cell
   path (cv2, ``np.load``) on cells made here at the ViT's image shape,
   byte for byte (JPEG in fancy upsampling), and its rate in images/s at
   1 thread and at the threads knob's default.
9. ``image_reference``: ``VIT_ROWS`` ImageNet-like 384×384 rows written
   with the port; the card loader, which decodes the encoded cells
   straight into its pinned slots (``fused-into-slot``), against the CPU
   loader decoding on the workers, byte for byte; then ViT-Base width with
   2 layers in f32 (TF32 off, flash attention): logits and one
   parameter's loss gradient on the card (kernels) against the CPU (plain
   versions).
10. ``vit_path``: ``VIT_STEPS`` AdamW steps of ViT-Base (``bench.py``'s
    ``vit_train`` configuration: 384/12, d 768, 12 heads of 64, 12
    layers, batch 16, bf16) on that data through the fused loader, flips
    and cutout on the card and the normalize kernel; normalize launches
    once a step and each flash kernel 12 times, all bidirectional.
11. ``vit_profile``: the ``lm_profile`` breakdown for a ViT-Base step.
12. ``varlen_reference``: the masked loss at the flagship width with 2
    layers on bucketed batches of the C4-like documents at widths 128 and
    512 (attention at S = 127 and 511): f32 on the card against the CPU,
    and bf16 flash against dense attention on the card.
13. ``varlen_path``: ``VARLEN_STEPS`` AdamW steps of the full flagship LM
    through ``make_torch_loader(bucket_boundaries=...)``, one document a
    row, bucketed at ``VARLEN_BOUNDARIES``, so the flash kernels run at S
    = 63, 127, 255 and 511 as the buckets come; every batch's width is a
    bound, at least three buckets are hit and each flash kernel launches
    layers x steps times. ``varlen_profile``: the ``lm_profile`` breakdown
    over one step of each bucket.
14. ``inmemory_replay``: the bucketed loader with ``inmemory_cache_all``
    over ``REPLAY_DOCS`` documents feeding the same step for two epochs;
    the replay epoch serves the first epoch's tensors, reads, decodes and
    stages nothing, and a profiled replay pass shows no host-to-device
    copy.
15. ``mixture_path`` (configuration lm-mixture-flagship): two token
    corpora written as ``bench.py``'s ``_build_mixture_source`` writes
    them (``web``, 3072 documents, and ``code``, 1024), mixed 3:1 and
    packed on the host into rows of 1025 tokens by
    ``make_torch_loader(mixture=)``, then ``MIXTURE_STEPS`` AdamW steps of
    the flagship LM (``pretrain_mixture``): packed tokens/s, the packer's
    fill ratio, the realized deviation from 3:1, documents per source,
    ``stage_seconds`` with ``pack``, and 10 launches of each flash kernel
    a step. ``mixture_profile``: the ``lm_profile`` breakdown over steps
    fed by that loader.
16. ``resume``: run A trains ``RESUME_STEPS`` unbroken steps on the
    mixture; run B trains half of them, saves model, optimizer and data
    position with ``TrainCheckpointer``, and a second call builds a fresh
    loader, model and optimizer, restores them and trains the rest. The
    token batches after the restore equal run A's bit for bit, and the
    losses agree within 1e-3 relative; the checkpoint's bytes and its save
    and restore seconds are printed.

Then the ``kernels`` summary (each kernel's launches on every path), the
``nvidia-smi`` name and power limit, and the ``ok`` line. The script
needs CUDA and the repository beside it.
"""

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

TIMED_RUNS = 25
# profiled windows tried before a time falls back to CUDA events
PROFILE_ATTEMPTS = 3
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
    ('vit_bf16', (16, 384, 384, 3), torch.bfloat16, False),
]
MAIN_PATH_CASE = 'mnist_bf16'
VIT_KERNEL_CASE = 'vit_bf16'
NORMALIZE_REPLACES = 'petastorm_tpu/ops/normalize.py:20'

# dense tensor-core bf16 peak of the H100 SXM (NVIDIA data sheet)
BF16_FLOPS = 989e12

# (label, (B, S, H, D), dtype, causal, factor on q and k); the main path
# runs the first. The peaked case multiplies q and k by 4, so each row's
# softmax puts nearly all its weight on a few keys: it stresses the running
# max and the bf16 rounding of P in the tensor-core kernels.
FLASH_CASES = [
    ('flagship_causal_bf16', (8, 1024, 16, 96), torch.bfloat16, True, 1.0),
    ('flagship_bidir_bf16', (8, 1024, 16, 96), torch.bfloat16, False, 1.0),
    ('jax_test_causal_f32', (1, 256, 2, 64), torch.float32, True, 1.0),
    ('jax_test_bidir_f32', (1, 256, 2, 64), torch.float32, False, 1.0),
    ('ragged1000_causal_bf16', (2, 1000, 4, 96), torch.bfloat16, True, 1.0),
    ('ragged77_bidir_f32', (3, 77, 2, 96), torch.float32, False, 1.0),
    ('d64_causal_bf16', (4, 512, 8, 64), torch.bfloat16, True, 1.0),
    ('d128_bidir_bf16', (4, 512, 8, 128), torch.bfloat16, False, 1.0),
    ('d128_ragged_causal_f32', (2, 130, 2, 128), torch.float32, True, 1.0),
    ('flagship_peaked_causal_bf16', (8, 1024, 16, 96), torch.bfloat16, True, 4.0),
    ('vit_bidir_bf16', (16, 1024, 12, 64), torch.bfloat16, False, 1.0),
    # the bucketed LM path's largest and a small bucket: S = bound - 1, a
    # masked tail tile in every kernel
    ('varlen511_causal_bf16', (16, 511, 16, 96), torch.bfloat16, True, 1.0),
    ('varlen127_causal_bf16', (16, 127, 16, 96), torch.bfloat16, True, 1.0),
    # the two other buckets: S = 63 is a single tile, where the diagonal
    # and the tail masks fall on the same tile
    ('varlen63_causal_bf16', (16, 63, 16, 96), torch.bfloat16, True, 1.0),
    ('varlen255_causal_bf16', (16, 255, 16, 96), torch.bfloat16, True, 1.0),
]
FLASH_MAIN_CASE = 'flagship_causal_bf16'
VIT_FLASH_CASE = 'vit_bidir_bf16'
VARLEN_FLASH_CASE = 'varlen511_causal_bf16'
# the bucketed path's other buckets, listed beside it in the kernels line
VARLEN_TAIL_CASES = ('varlen127_causal_bf16', 'varlen255_causal_bf16', 'varlen63_causal_bf16')
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

# the image path: ImageNet-like rows at the ViT's 384 x 384, 64-row groups
VIT_ROWS = 1024
VIT_STEPS = 20
VIT_BATCH = 16
VIT_PROFILE_STEPS = 3
NATIVE_DECODE_IMAGES = 64

# the variable-length LM path: one document a row, bucketed by length
VARLEN_STEPS = 40
VARLEN_BATCH = 16
VARLEN_BOUNDARIES = (64, 128, 256, 512)
VARLEN_REFERENCE_WIDTHS = (128, 512)  # attention at S = 127 and 511
VARLEN_PROFILE_STEPS = 4              # one step a bucket
REPLAY_DOCS = 512                     # the JAX example's num_docs

# lm-mixture-flagship: bench.py's mixture_stream corpora (MIXTURE_DOCS_A/B,
# seeds 1 and 2) mixed 3:1, packed to 1025 tokens, the flagship on them
MIXTURE_SOURCES = (('web', 3, 3072, 1), ('code', 1, 1024, 2))  # name, weight, docs, seed
MIXTURE_ROW = LM_SEQ + 1
MIXTURE_STEPS = 20
MIXTURE_PROFILE_STEPS = 3
RESUME_STEPS = 16
RESUME_LOSS_RTOL = 1e-3


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
    CUDA events around the same run of calls, divided by the count. The
    profiler has been seen to drop events on the card: a trace with no
    device time, or a count of device activities that is not a multiple
    of the calls, is incomplete, and the profiled window runs again, up
    to PROFILE_ATTEMPTS times. If every trace is incomplete, ``device_ms``
    is ``wall_ms`` and ``timer`` says ``'cuda-events (not a kernel
    time)'``: the host's launch rate bounds that number, so it is never
    reported as a kernel's time."""
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
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(TIMED_RUNS):
                fn()
            torch.cuda.synchronize()
        device_us = [e.device_time_total for e in prof.events()
                     if e.device_type == DeviceType.CUDA]
        if not sum(device_us) or len(device_us) % TIMED_RUNS:
            continue
        tried = '' if attempt == 1 else ' (trace %d of %d)' % (attempt, PROFILE_ATTEMPTS)
        if len(device_us) == TIMED_RUNS:
            # one device activity per call: the median call
            return (statistics.median(device_us) / 1e3, wall_ms,
                    'torch.profiler median' + tried)
        return sum(device_us) / TIMED_RUNS / 1e3, wall_ms, 'torch.profiler mean' + tried
    return wall_ms, wall_ms, 'cuda-events (not a kernel time)'


def bf16_ulp_distance(a, b):
    """Largest distance between two bf16 tensors in units in the last place."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -32768 - i, i)
    return int((ordered(a) - ordered(b)).abs().max())


_PTXAS_ENTRY = re.compile(r"Compiling entry function '.*?\d((?:flash_(?:fwd|bwd_dkv|bwd_dq)"
                          r"|normalize_u8)_kernel(?:_wgmma)?)I(?:Li(\d+)E|(13__nv_bfloat16|f))")


def ptxas_by_kernel(log):
    """``{'flash_bwd_dq_kernel_wgmma<96>': {'registers': n, 'spill_stores': n,
    'spill_loads': n}, ...}`` from ``nvcc -Xptxas -v`` output (a template
    instance is named by its padded head dim or its element type)."""
    out, name = {}, None
    for line in log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            arg = m.group(2) or ('bf16' if m.group(3).endswith('bfloat16') else 'f32')
            name = '%s<%s>' % (m.group(1), arg)
            continue
        if name is None:
            continue
        spill = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads', line)
        regs = re.search(r'Used (\d+) registers', line)
        if spill:
            out.setdefault(name, {}).update(spill_stores=int(spill.group(1)),
                                            spill_loads=int(spill.group(2)))
        if regs:
            out.setdefault(name, {})['registers'] = int(regs.group(1))
    return out


def probe_image_stack():
    """What the machine offers for image decode: cv2, the headers the
    native decoders and a CPython extension would need, and the image
    libraries ``ldconfig`` knows."""
    import sysconfig
    try:
        import cv2
        cv2_version = cv2.__version__
    except ImportError:
        cv2_version = None
    include_dirs = ('/usr/include', '/usr/local/include', '/usr/include/x86_64-linux-gnu')
    headers = {h: any(os.path.exists(os.path.join(d, h)) for d in include_dirs)
               for h in ('jpeglib.h', 'png.h', 'zlib.h')}
    headers['Python.h'] = os.path.exists(os.path.join(sysconfig.get_paths()['include'],
                                                       'Python.h'))
    ldconfig = shutil.which('ldconfig') or '/sbin/ldconfig'
    listing = (subprocess.run([ldconfig, '-p'], capture_output=True, text=True).stdout
               if os.path.exists(ldconfig) else '')
    libraries = {lib: sorted({line.split()[0] for line in listing.splitlines()
                              if line.strip().startswith(lib)})
                 for lib in ('libjpeg', 'libpng', 'libz.')}
    return {'cv2': cv2_version, 'headers': headers, 'ldconfig': libraries}


def image_codec_for(status, probe):
    """The ViT data's image codec: JPEG where libjpeg's decoder built and
    cv2 can encode, else PNG (zlib's decoder), else raw ``.npy`` cells."""
    if probe['cv2'] and status['jpeg_batch'] == 'live':
        return 'jpeg'
    if probe['cv2'] and status['png_batch'] == 'live':
        return 'png'
    return 'npy'


def phase_build():
    from petastorm_tpu_torch import native
    from petastorm_tpu_torch.ops import build
    sources = sorted(f[:-3] for f in os.listdir(build.CSRC_DIR) if f.endswith('.cu'))
    t0 = time.perf_counter()
    try:
        build.build(sources + list(native.DECODERS))
    except RuntimeError:
        # a host decoder may lack its library; every kernel must build
        if not all(os.path.exists(build.library_path(name)) for name in sources):
            raise
    status = native.load_all()
    probe = probe_image_stack()
    logs = {name: entry['log'] for name, entry in build.build_log.items()}
    kernels = {k: v for log in logs.values() for k, v in ptxas_by_kernel(log).items()}
    emit({'phase': 'build', 'card': card_line(), 'sources': sources,
          'build_s': time.perf_counter() - t0, 'ptxas_by_kernel': kernels,
          'native_decoders': status, 'probe': probe,
          'image_codec': image_codec_for(status, probe),
          'warnings': {name: [line for line in log.splitlines() if 'warning' in line.lower()]
                       for name, log in logs.items()}})
    # the tensor-core kernels keep their accumulators in registers, and
    # ptxas must not serialize their wgmma instructions
    spilled = [k for k, v in kernels.items()
               if '_wgmma' in k and (v.get('spill_stores') or v.get('spill_loads'))]
    assert not spilled, spilled
    serialized = [line for log in logs.values() for line in log.splitlines()
                  if 'wgmma' in line and 'serializ' in line.lower()]
    assert not serialized, serialized
    # a decoder whose headers are here must have built
    expected = {'npy_batch': True, 'jpeg_batch': probe['headers']['jpeglib.h'],
                'png_batch': probe['headers']['zlib.h']}
    missing = [name for name, want in expected.items() if want and status[name] != 'live']
    assert not missing, (missing, status)
    return status, probe


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
    each grad divided by its max-abs (rounding O to bf16 costs up to 2^-9
    of a value, 0.0156 at |O| in [4, 8); the tensor-core kernels also
    round P and dS to bf16 before their products, a relative 2^-9 on each
    term of sums whose f32 accumulation averages it out); lse
    ``|err| <= 1e-4``."""
    import torch.nn.functional as F
    from petastorm_tpu_torch.ops import flash_attention as fa
    results = {}
    for seed, (label, shape, dtype, causal, qk_factor) in enumerate(FLASH_CASES):
        gen = torch.Generator(device='cuda').manual_seed(seed)
        q, k, v, do = (torch.randn(shape, generator=gen, device='cuda').to(dtype)
                       for _ in range(4))
        if qk_factor != 1.0:
            q, k = q * qk_factor, k * qk_factor
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
        # the backward alone (dQ, dK, dV from one kept graph): several
        # device activities a call, so time_ms takes their mean
        sdpa_out = sdpa()
        sdpa_bwd = time_ms(lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dot,
                                                       retain_graph=True))
        del sdpa_out
        results[label] = {
            'shape': list(shape), 'dtype': str(dtype).replace('torch.', ''),
            'causal': causal, 'qk_factor': qk_factor, 'errors': errs,
            'lse_max_abs_err': lse_err, 'tolerance': tolerance, 'ok': ok,
            'kernels': kernels, 'sdpa_fwd_ms': sdpa_fwd[0], 'sdpa_bwd_ms': sdpa_bwd[0],
            'sdpa_bwd_timer': sdpa_bwd[2], 'sdpa_fwd_bwd_ms': sdpa_fwd_bwd[0],
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


def phase_lm_reference_bf16():
    """The transformer at the flagship width with 2 layers in bf16 at 1024
    attention positions on the card: flash attention (the bf16
    tensor-core kernels) against dense attention (plain torch) with the
    same weights. Logits and the ``blocks.0.qkv`` loss gradient agree to
    ``max|a - b| / max|b| <= 3e-2``: both paths round activations and P to
    bf16, at different places, through two layers of attention."""
    import numpy as np
    from petastorm_tpu_torch.examples.lm_pretrain import FLAGSHIP_LM_KW
    from petastorm_tpu_torch.models.transformer import (
        TransformerConfig, init_transformer, transformer_forward, transformer_loss,
    )
    from petastorm_tpu_torch.ops import flash_attention as fa
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, FLAGSHIP_LM_KW['vocab_size'], (2, LM_SEQ + 1)).astype(np.int32)).cuda()
    out = {}
    for impl in ('dense', 'flash'):
        config = TransformerConfig(**dict(FLAGSHIP_LM_KW, n_layers=2), max_seq_len=LM_SEQ,
                                   attn_impl=impl, dtype=torch.bfloat16)
        model = init_transformer(0, config, 'cuda')
        launches = fa.fwd_launches
        with torch.no_grad():
            logits = transformer_forward(model, tokens[:, :-1]).float()
        transformer_loss(model, tokens).backward()
        out[impl] = (logits, model.blocks[0].qkv.grad.float(), fa.fwd_launches - launches)
        del model
    (want, want_grad, _), (got, got_grad, flash_fwds) = out['dense'], out['flash']
    logits_err = float((got - want).abs().max() / want.abs().max())
    grad_err = float((got_grad - want_grad).abs().max() / want_grad.abs().max())
    emit({'phase': 'reference_bf16',
          'model': 'transformer flagship width, 2 layers, bf16, flash vs dense on the card',
          'attention_positions': LM_SEQ, 'logits_shape': list(got.shape),
          'flash_fwd_launches': flash_fwds, 'logits_err_over_max_abs': logits_err,
          'grad': 'blocks.0.qkv', 'grad_err_over_max_abs': grad_err,
          'tolerance': 'max|a - b| / max|b| <= 3e-2 on logits and grad'})
    assert torch.isfinite(got).all() and got.shape == (2, LM_SEQ, config.vocab_size)
    assert flash_fwds == 2 * 2, flash_fwds  # 2 layers, forward and loss
    assert logits_err <= 3e-2, logits_err
    assert grad_err <= 3e-2, grad_err


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
    if 'normalize_u8_kernel' in name:
        return 'normalize_images'
    low = name.lower()
    if any(tag in low for tag in ('gemm', 'xmma', 'nvjet', 'cublas', 'cutlass')):
        return 'matmul (cuBLAS)'
    if 'multi_tensor_apply' in low or 'adam' in low:
        return 'optimizer (AdamW)'
    if 'memcpy' in low or 'memset' in low:
        return 'copy/memset'
    return 'other (elementwise, norms, softmax, loss)'


def profile_steps(phase, run_step, steps):
    """Where a train step's device time goes: ``torch.profiler`` over
    ``steps`` calls of ``run_step`` (after 2 warm-up calls), device time
    summed by kind, and the device's idle share of its window (profiling
    adds host work, so the share is an upper bound). Fails unless every
    flash kernel the step ran is a tensor-core (``wgmma``) one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        run_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kinds = {}
    spans = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kind = _kernel_kind(e.name)
            kinds[kind] = kinds.get(kind, 0.0) + e.device_time_total / 1e3 / steps
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
    flash_names = {kernel: sorted({e.name for e in prof.events()
                                   if e.device_type == DeviceType.CUDA
                                   and _kernel_kind(e.name) == kernel})
                   for kernel in FLASH_KERNELS}
    result = {'phase': phase, 'steps': steps, 'step_wall_ms': wall_ms,
              'device_window_ms_per_step': window_us / 1e3 / steps,
              'device_busy_ms_per_step': busy_us / 1e3 / steps,
              'idle_share': 1 - busy_us / window_us,
              'device_ms_per_step': dict(sorted(kinds.items(), key=lambda kv: -kv[1])),
              'share_of_device_time': {k: v / sum(kinds.values()) for k, v in kinds.items()},
              'flash_kernel_names': flash_names}
    emit(result)
    # the bf16 step runs each flash kernel's tensor-core instance
    for kernel, names in flash_names.items():
        assert names and all('_wgmma' in n for n in names), (kernel, names)
    return result


def phase_lm_profile():
    """Where a flagship step's device time goes (``profile_steps``), on one
    packed batch."""
    from petastorm_tpu_torch.examples.lm_pretrain import FLAGSHIP_LM_KW
    from petastorm_tpu_torch.models.transformer import (
        TransformerConfig, adamw, init_transformer, transformer_train_step,
    )
    config = TransformerConfig(max_seq_len=LM_SEQ, loss_chunk=256, attn_impl='flash',
                               **FLAGSHIP_LM_KW)
    model = init_transformer(0, config, 'cuda')
    step = transformer_train_step(model, adamw(model))
    gen = torch.Generator(device='cuda').manual_seed(0)
    tokens = torch.randint(2, config.vocab_size, (LM_BATCH, LM_SEQ + 1), generator=gen,
                           device='cuda', dtype=torch.int32)
    profile_steps('lm_profile', lambda: step(tokens), LM_PROFILE_STEPS)


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


def phase_native_decode(status):
    """Each native decoder that built, against the per-cell path on cells
    encoded here at the ViT's image shape: ``np.load`` for ``.npy``, cv2
    for PNG and JPEG (the decoder in fancy upsampling, where libjpeg is
    bit-identical to cv2); byte for byte. Rates in images/s, best of 3
    passes, at 1 thread and at the threads knob's default."""
    import numpy as np
    from petastorm_tpu_torch import native
    from petastorm_tpu_torch.codecs import (
        CompressedImageCodec, NdarrayCodec, image_decoder_threads,
    )
    from petastorm_tpu_torch.examples.imagenet import imagenet_like_rows
    from petastorm_tpu_torch.unischema import UnischemaField
    images = [image for image, _ in imagenet_like_rows(NATIVE_DECODE_IMAGES, seed=0)]
    shape = images[0].shape
    threads = image_decoder_threads()
    results = {}
    for library in native.DECODERS:
        if status[library] != 'live':
            results[library] = {'status': status[library]}
            continue
        kind = library.split('_')[0]
        codec = NdarrayCodec() if kind == 'npy' else CompressedImageCodec(kind, quality=90)
        field = UnischemaField('image', np.uint8, shape, codec, False)
        cells = native.PackedCells.from_cells([bytes(codec.encode(field, im)) for im in images])
        if kind == 'npy':
            def decode(out, n_threads):
                return native.decode_npy_batch(cells, out, '|u1', "'shape': %r" % (shape,),
                                               n_threads)
        elif kind == 'png':
            def decode(out, n_threads):
                return native.decode_png_batch(cells, out, n_threads)
        else:
            def decode(out, n_threads):
                return native.decode_jpeg_batch(cells, out, 1, n_threads)
        t0 = time.perf_counter()
        want = np.stack([codec.decode(field, cell) for cell in cells])
        per_cell_s = time.perf_counter() - t0
        rates = {}
        for n_threads in (1, threads):
            best = None
            for _ in range(3):
                out = np.empty((len(images),) + shape, np.uint8)
                t0 = time.perf_counter()
                done = decode(out, n_threads)
                elapsed = time.perf_counter() - t0
                best = elapsed if best is None else min(best, elapsed)
                assert done == len(images), (library, done)
                assert np.array_equal(out, want), (library, n_threads)
            rates['threads_%d' % n_threads] = len(images) / best
        results[library] = {'status': 'live', 'images': len(images), 'shape': list(shape),
                            'encoded_bytes_per_image': cells.nbytes / len(images),
                            'byte_exact_vs_per_cell': True,
                            'images_per_s': rates,
                            'per_cell_images_per_s': len(images) / per_cell_s}
    emit({'phase': 'native_decode', 'threads_default': threads,
          'reference': 'per cell: np.load (npy), cv2.imdecode (png, jpeg); jpeg in fancy mode',
          'decoders': results})


def write_vit_dataset(url, image_codec):
    from petastorm_tpu_torch.examples.imagenet import generate_imagenet_like
    t0 = time.perf_counter()
    generate_imagenet_like(url, num_rows=VIT_ROWS, size=384, image_codec=image_codec)
    emit({'phase': 'write', 'dataset': 'imagenet_like_384', 'rows': VIT_ROWS,
          'image_codec': image_codec, 'rowgroup_rows': 64,
          'seconds': time.perf_counter() - t0})


def phase_image_reference(url, image_codec):
    """The card loader (encoded cells decoded straight into its pinned
    slots) against the CPU loader decoding on the workers, batch for batch
    on the dummy pool, byte for byte; then ViT-Base width with 2 layers in
    f32 (TF32 off, flash attention, a random head): logits and the
    ``blocks.0.qkv`` loss gradient on the card (kernels) against the CPU
    (plain versions)."""
    import copy
    import numpy as np
    from petastorm_tpu_torch.device.loader import make_torch_loader
    from petastorm_tpu_torch.examples.imagenet import VIT_BASE_KW
    from petastorm_tpu_torch.models.vit import ViTConfig, init_vit, vit_forward, vit_loss
    count = 8

    def batches(device, defer):
        with make_torch_loader(url, batch_size=VIT_BATCH, fields=['^image$', '^label$'],
                               device=device, reader_pool_type='dummy',
                               shuffle_row_groups=False, defer_image_decode=defer) as loader:
            # all batches held: a recycled slot must not touch a held batch
            held = [b for _, b in zip(range(count), loader)]
            return held, loader.diagnostics

    on_card, card_diag = batches('cuda', True)
    on_host, host_diag = batches('cpu', False)
    torch.cuda.synchronize()
    assert all(t.is_cuda for b in on_card for t in b.values())
    for a, b in zip(on_card, on_host):
        assert sorted(a) == sorted(b)
        for name in a:
            assert torch.equal(a[name].cpu(), b[name]), name
    want_mode = 'batched' if image_codec == 'npy' else 'fused-into-slot'
    assert card_diag['fused_decode_mode'] == want_mode, card_diag
    assert host_diag['fused_decode_mode'] == 'batched', host_diag

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    config = ViTConfig(**dict(VIT_BASE_KW, n_layers=2), attn_impl='flash',
                       dtype=torch.float32)
    model = init_vit(0, config, 'cpu')
    with torch.no_grad():
        model.head.copy_(torch.randn(model.head.shape, generator=torch.Generator().manual_seed(1))
                         * 0.02)
    images = (on_host[0]['image'][:2].float() / 255.0)
    labels = on_host[0]['label'][:2]
    out = {}
    for device in ('cpu', 'cuda'):
        m = copy.deepcopy(model).to(device)
        with torch.no_grad():
            logits = vit_forward(m, images.to(device))
        vit_loss(m, images.to(device), labels.to(device)).backward()
        out[device] = (logits.cpu(), m.blocks[0].qkv.grad.cpu())
    (want, want_grad), (got, got_grad) = out['cpu'], out['cuda']
    logits_err = float((got - want).abs().max())
    grad_err = float((got_grad - want_grad).abs().max() / want_grad.abs().max())
    emit({'phase': 'image_reference', 'image_codec': image_codec,
          'loader_batches_compared': len(on_card), 'loader_equal': True,
          'card_fused_decode_mode': card_diag['fused_decode_mode'],
          'card_fused_decode_rows': card_diag['fused_decode_rows'],
          'host_fused_decode_mode': host_diag['fused_decode_mode'],
          'model': 'ViT-Base width, 2 layers, f32, flash, 2 images',
          'logits_shape': list(got.shape), 'logits_max_abs_err': logits_err,
          'logits_max_abs': float(want.abs().max()),
          'logits_tolerance': 'atol 1e-4 (f32, TF32 off)',
          'grad': 'blocks.0.qkv', 'grad_err_over_max_abs': grad_err,
          'grad_tolerance': 'max-abs err / max|grad| <= 1e-4'})
    assert torch.isfinite(got).all() and got.shape == (2, 1000)
    assert logits_err <= 1e-4, logits_err
    assert grad_err <= 1e-4, grad_err


def phase_vit_path(url, image_codec):
    from petastorm_tpu_torch import native
    from petastorm_tpu_torch.examples.imagenet import VIT_BASE_KW, train_vit_fused
    from petastorm_tpu_torch.telemetry import get_registry, reset_registry
    reset_registry()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    result = train_vit_fused(url, steps=VIT_STEPS, batch_size=VIT_BATCH, device='cuda')
    torch.cuda.synchronize()
    launches = launch_counts()
    losses = result['losses']
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    diag = result['diagnostics']
    decoded = {k: v for k, v in get_registry().snapshot()['counters'].items()
               if k.startswith(native.DECODED_CELLS)}
    emit({'phase': 'vit_path', 'model': VIT_BASE_KW, 'image_codec': image_codec,
          'steps': len(losses), 'batch_size': VIT_BATCH,
          'attention_positions': 1024, 'causal': False, 'launches': launches,
          'batch_devices': result['batch_devices'], 'losses': losses,
          'loss_first5_mean': first, 'loss_last5_mean': last,
          'images_per_s': result['images_per_s'], 'steps_per_s': result['steps_per_s'],
          'peak_memory_bytes': torch.cuda.max_memory_allocated(),
          'fused_decode_mode': diag['fused_decode_mode'],
          'fused_decode_rows': diag['fused_decode_rows'],
          'native_decoded_cells': decoded,
          'consumer_wait_s': diag['consumer_wait_s'],
          'stage_backpressure_s': diag['stage_backpressure_s'],
          'stage_seconds': stage_seconds()})
    assert len(losses) == VIT_STEPS
    assert all(math.isfinite(v) for v in losses), losses
    assert last < first, (first, last)
    assert result['batch_devices'] == ['cuda:0'], result['batch_devices']
    assert launches['normalize_images'] == VIT_STEPS, launches
    want = VIT_BASE_KW['n_layers'] * VIT_STEPS
    for name in FLASH_KERNELS:
        assert launches[name] == want, (name, launches[name], want)
    library = {'jpeg': 'jpeg_batch', 'png': 'png_batch', 'npy': 'npy_batch'}[image_codec]
    key = '%s{library="%s"}' % (native.DECODED_CELLS, library)
    # the path decoded every staged row with the native decoder it expects
    assert decoded.get(key, 0) >= VIT_STEPS * VIT_BATCH, decoded
    if image_codec != 'npy':
        assert diag['fused_decode_mode'] == 'fused-into-slot', diag
    return launches


def phase_vit_profile():
    """Where a ViT-Base step's device time goes (``profile_steps``): flips,
    cutout and the normalize kernel on one uint8 batch on the card, then
    the train step."""
    from petastorm_tpu_torch.examples.imagenet import VIT_BASE_KW, _prepare
    from petastorm_tpu_torch.models.transformer import adamw
    from petastorm_tpu_torch.models.vit import ViTConfig, init_vit, vit_train_step
    config = ViTConfig(attn_impl='flash', **VIT_BASE_KW)
    model = init_vit(0, config, 'cuda')
    step = vit_train_step(model, adamw(model))
    gen = torch.Generator(device='cuda').manual_seed(0)
    images = torch.randint(0, 256, (VIT_BATCH, 384, 384, 3), generator=gen, device='cuda',
                           dtype=torch.uint8)
    labels = torch.randint(0, 1000, (VIT_BATCH,), generator=gen, device='cuda')
    profile_steps('vit_profile', lambda: step(_prepare(images, gen, True, 48), labels),
                  VIT_PROFILE_STEPS)


def phase_varlen_reference(url):
    """The masked loss at the flagship width with 2 layers on bucketed
    batches from the C4-like documents (CPU loader, dummy pool, in order)
    at widths 128 and 512, so attention runs at S = 127 and 511. In f32
    (TF32 off, flash, ``loss_chunk=256``) on two rows of each batch, the
    longest and the shortest: the loss and the ``blocks.0.qkv`` gradient on
    the card (kernels) against the CPU (plain versions), loss within 1e-4
    and ``max|err| / max|grad|`` within 1e-4. In bf16 on the whole batch on
    the card: flash attention (the tensor-core kernels) against dense
    attention with the same weights: the loss within 1e-3 relative and the
    gradient within 3e-2 of its max-abs. At init the loss sits near
    ln(vocab) whatever attention computes, so the gradient gate is the one
    that catches a wrong kernel."""
    from petastorm_tpu_torch.device.loader import make_torch_loader
    from petastorm_tpu_torch.examples.lm_pretrain import FLAGSHIP_LM_KW
    from petastorm_tpu_torch.models.transformer import (
        TransformerConfig, init_transformer, transformer_masked_loss,
    )
    from petastorm_tpu_torch.ops import flash_attention as fa
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batches = {}
    with make_torch_loader(url, batch_size=VARLEN_BATCH, fields=['^tokens$'], device='cpu',
                           reader_pool_type='dummy', shuffle_row_groups=False,
                           bucket_boundaries={'tokens': list(VARLEN_BOUNDARIES)}) as loader:
        for batch in loader:
            batches.setdefault(batch['tokens'].shape[1], batch)
            if all(w in batches for w in VARLEN_REFERENCE_WIDTHS):
                break

    def config(impl, dtype):
        return TransformerConfig(**dict(FLAGSHIP_LM_KW, n_layers=2),
                                 max_seq_len=VARLEN_BOUNDARIES[-1], loss_chunk=256,
                                 attn_impl=impl, dtype=dtype)

    def loss_and_grad(impl, dtype, device, tokens, lengths):
        model = init_transformer(0, config(impl, dtype), device)
        launches = fa.fwd_launches
        loss = transformer_masked_loss(model, tokens.to(device), lengths.to(device))
        loss.backward()
        return float(loss), model.blocks[0].qkv.grad.float().cpu(), fa.fwd_launches - launches

    cases = {}
    for width in VARLEN_REFERENCE_WIDTHS:
        tokens, lengths = batches[width]['tokens'], batches[width]['tokens_len']
        order = torch.argsort(lengths)
        rows = torch.stack([order[-1], order[0]])
        want_loss, want_grad, _ = loss_and_grad('flash', torch.float32, 'cpu',
                                                tokens[rows], lengths[rows])
        got_loss, got_grad, _ = loss_and_grad('flash', torch.float32, 'cuda',
                                              tokens[rows], lengths[rows])
        dense_loss, dense_grad, _ = loss_and_grad('dense', torch.bfloat16, 'cuda', tokens, lengths)
        flash_loss, flash_grad, flash_fwds = loss_and_grad('flash', torch.bfloat16, 'cuda',
                                                           tokens, lengths)
        torch.cuda.empty_cache()
        cases['S%d' % (width - 1)] = {
            'tokens_shape': list(tokens.shape), 'f32_rows_lengths': lengths[rows].tolist(),
            'batch_lengths': [int(lengths.min()), int(lengths.max())],
            'f32_loss': got_loss, 'f32_loss_abs_err': abs(got_loss - want_loss),
            'f32_grad_err_over_max_abs': float((got_grad - want_grad).abs().max()
                                               / want_grad.abs().max()),
            'bf16_flash_loss': flash_loss, 'bf16_dense_loss': dense_loss,
            'bf16_loss_rel_err': abs(flash_loss - dense_loss) / abs(dense_loss),
            'bf16_grad_err_over_max_abs': float((flash_grad - dense_grad).abs().max()
                                                / dense_grad.abs().max()),
            'bf16_flash_fwd_launches': flash_fwds,
            'finite': all(math.isfinite(v) for v in (got_loss, flash_loss, dense_loss)),
        }
    emit({'phase': 'varlen_reference',
          'model': 'transformer flagship width, 2 layers, masked loss, loss_chunk 256',
          'cases': cases,
          'f32_tolerance': 'card (kernels) vs CPU (plain), 2 rows: loss abs 1e-4, '
                           'grad max-abs err / max|grad| 1e-4 (TF32 off)',
          'bf16_tolerance': 'flash vs dense on the card, whole batch: loss rel 1e-3, '
                            'grad max-abs err / max|grad| 3e-2'})
    for name, c in cases.items():
        assert c['finite'], (name, c)
        assert c['f32_loss_abs_err'] <= 1e-4, (name, c)
        assert c['f32_grad_err_over_max_abs'] <= 1e-4, (name, c)
        assert c['bf16_loss_rel_err'] <= 1e-3, (name, c)
        assert c['bf16_grad_err_over_max_abs'] <= 3e-2, (name, c)
        assert c['bf16_flash_fwd_launches'] == 2, (name, c)  # 2 layers, one forward


def phase_varlen_path(url):
    """``train_variable_length`` on the card at the flagship widths: one
    document a row, bucketed at ``VARLEN_BOUNDARIES``, attention at S =
    bound - 1 through the flash kernels."""
    from petastorm_tpu_torch.examples.lm_pretrain import FLAGSHIP_LM_KW
    from petastorm_tpu_torch.device.staging import staging_slots
    from petastorm_tpu_torch.examples.variable_length import train_variable_length
    from petastorm_tpu_torch.telemetry import reset_registry
    reset_registry()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    result = train_variable_length(url, batch_size=VARLEN_BATCH, steps=VARLEN_STEPS,
                                   learning_rate=1e-3, boundaries=VARLEN_BOUNDARIES,
                                   model_kw=FLAGSHIP_LM_KW, attn_impl='flash',
                                   loss_chunk=256, dtype=torch.bfloat16, device='cuda')
    torch.cuda.synchronize()
    launches = launch_counts()
    losses = result['losses']
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    emit({'phase': 'varlen_path', 'model': FLAGSHIP_LM_KW, 'steps': len(losses),
          'batch_size': VARLEN_BATCH, 'boundaries': list(VARLEN_BOUNDARIES),
          'attention_positions_by_bucket': {b: b - 1 for b in VARLEN_BOUNDARIES},
          'bucket_steps': result['bucket_steps'], 'widths': result['widths'],
          'max_lens': result['max_lens'], 'launches': launches,
          'batch_devices': result['batch_devices'], 'losses': losses,
          'loss_first5_mean': first, 'loss_last5_mean': last,
          'steps_per_s': result['steps_per_s'],
          'target_tokens_per_s': result['target_tokens_per_s'],
          'padded_positions_per_s': result['padded_positions_per_s'],
          'pad_share': 1 - result['target_tokens_per_s'] / result['padded_positions_per_s'],
          'step_ms_by_bucket': result['step_ms_by_bucket'],
          'step_ms_timer': 'CUDA events around each step (device time incl. its gaps)',
          'staging_slots_allocated': result['diagnostics']['staging_slots_allocated'],
          'consumer_wait_s': result['diagnostics']['consumer_wait_s'],
          'peak_memory_bytes': torch.cuda.max_memory_allocated(),
          'stage_seconds': stage_seconds()})
    assert len(losses) == VARLEN_STEPS
    assert all(math.isfinite(v) for v in losses), losses
    assert last < first, (first, last)
    assert result['batch_devices'] == ['cuda:0'], result['batch_devices']
    assert all(w in VARLEN_BOUNDARIES for w in result['widths']), result['widths']
    assert all(m <= w for m, w in zip(result['max_lens'], result['widths']))
    assert len(result['bucket_steps']) >= 3, result['bucket_steps']
    # each bucket width staged through its own pinned ring
    slots = result['diagnostics']['staging_slots_allocated']
    assert (staging_slots() * len(result['bucket_steps']) <= slots
            <= staging_slots() * len(VARLEN_BOUNDARIES)), slots
    want = FLAGSHIP_LM_KW['n_layers'] * VARLEN_STEPS
    for name in FLASH_KERNELS:
        assert launches[name] == want, (name, launches[name], want)
    return launches


def phase_varlen_profile():
    """Where a bucketed flagship step's device time goes
    (``profile_steps``), one step at each bucket's width in turn; every
    flash kernel it sees must be a ``_wgmma`` one."""
    import itertools
    from petastorm_tpu_torch.examples.lm_pretrain import FLAGSHIP_LM_KW
    from petastorm_tpu_torch.models.transformer import (
        TransformerConfig, adamw, init_transformer, transformer_masked_train_step,
    )
    config = TransformerConfig(max_seq_len=VARLEN_BOUNDARIES[-1], loss_chunk=256,
                               attn_impl='flash', **FLAGSHIP_LM_KW)
    model = init_transformer(0, config, 'cuda')
    step = transformer_masked_train_step(model, adamw(model))
    gen = torch.Generator(device='cuda').manual_seed(0)
    batches = []
    for low, bound in zip((0,) + VARLEN_BOUNDARIES, VARLEN_BOUNDARIES):
        tokens = torch.randint(2, config.vocab_size, (VARLEN_BATCH, bound), generator=gen,
                               device='cuda', dtype=torch.int32)
        lengths = torch.randint(low + 1, bound + 1, (VARLEN_BATCH,), generator=gen,
                                device='cuda', dtype=torch.int32)
        batches.append((tokens, lengths))
    turns = itertools.cycle(batches[2:] + batches[:2])  # warm-up takes two
    profile_steps('varlen_profile', lambda: step(*next(turns)), VARLEN_PROFILE_STEPS)


def phase_inmemory_replay(url):
    """The bucketed loader with ``inmemory_cache_all=True`` over
    ``REPLAY_DOCS`` documents feeding the flagship masked train step for
    two epochs: the replay epoch yields the first epoch's batches (the same
    tensors, in another order), reads and decodes nothing and stages
    nothing; a third pass under ``torch.profiler`` shows no host-to-device
    copy on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from petastorm_tpu_torch.device.loader import make_torch_loader
    from petastorm_tpu_torch.device.staging import H2D_BYTES
    from petastorm_tpu_torch.examples.lm_pretrain import FLAGSHIP_LM_KW
    from petastorm_tpu_torch.models.transformer import (
        TransformerConfig, adamw, init_transformer, transformer_masked_train_step,
    )
    from petastorm_tpu_torch.telemetry import get_registry, reset_registry
    reset_registry()
    config = TransformerConfig(max_seq_len=VARLEN_BOUNDARIES[-1], loss_chunk=256,
                               attn_impl='flash', **FLAGSHIP_LM_KW)
    model = init_transformer(0, config, 'cuda')
    step = transformer_masked_train_step(model, adamw(model))
    epochs = []
    with make_torch_loader(url, batch_size=VARLEN_BATCH, fields=['^tokens$'],
                           num_epochs=None, bucket_boundaries={'tokens': list(VARLEN_BOUNDARIES)},
                           inmemory_cache_all=True, shuffle_row_groups=True,
                           device='cuda') as loader:
        for _ in range(2):
            stages = stage_seconds()
            h2d = get_registry().counter(H2D_BYTES).value
            t0 = time.perf_counter()
            batches, losses = [], []
            for batch in loader:
                losses.append(step(batch['tokens'], batch['tokens_len']))
                batches.append(batch)
            losses = [float(loss) for loss in losses]
            elapsed = time.perf_counter() - t0
            after = stage_seconds()
            epochs.append({'steps': len(batches), 'steps_per_s': len(batches) / elapsed,
                           'losses': losses, 'h2d_bytes': get_registry().counter(
                               H2D_BYTES).value - h2d,
                           'io_decode_s': {k: after.get(k, 0.0) - stages.get(k, 0.0)
                                           for k in ('io', 'decode')},
                           'tensor_ids': sorted(id(b['tokens']) for b in batches),
                           'widths': sorted(b['tokens'].shape[1] for b in batches)})
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            checksum = sum(int(b['tokens'].sum()) for b in loader)
            torch.cuda.synchronize()
    device_events = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    htod = [name for name in device_events if 'HtoD' in name]
    first, replay = epochs
    emit({'phase': 'inmemory_replay', 'documents': REPLAY_DOCS, 'model': FLAGSHIP_LM_KW,
          'batch_size': VARLEN_BATCH, 'boundaries': list(VARLEN_BOUNDARIES),
          'epoch_steps': [e['steps'] for e in epochs],
          'bucket_steps': {w: first['widths'].count(w) for w in sorted(set(first['widths']))},
          'steps_per_s': {'first_epoch': first['steps_per_s'],
                          'replay_epoch': replay['steps_per_s']},
          'h2d_bytes': {'first_epoch': first['h2d_bytes'], 'replay_epoch': replay['h2d_bytes']},
          'io_decode_s': {'first_epoch': first['io_decode_s'],
                          'replay_epoch': replay['io_decode_s']},
          'losses': {'first_epoch': first['losses'], 'replay_epoch': replay['losses']},
          'profiled_replay_pass': {'device_events': len(device_events), 'htod_copies': htod,
                                   'tokens_checksum': checksum}})
    assert first['steps'] > 0 and replay['steps'] == first['steps']
    # the same multiset of batches: the cached tensors themselves
    assert replay['tensor_ids'] == first['tensor_ids']
    assert first['h2d_bytes'] > 0 and replay['h2d_bytes'] == 0, epochs
    assert all(v == 0.0 for v in replay['io_decode_s'].values()), replay['io_decode_s']
    assert device_events and not htod, (len(device_events), htod)
    assert all(math.isfinite(v) for e in epochs for v in e['losses'])


def write_mixture_corpora(root):
    """The two token corpora of lm-mixture-flagship; returns its spec."""
    from petastorm_tpu_torch.examples.lm_pretrain import write_token_corpus
    from petastorm_tpu_torch.mixture import MixtureSource, MixtureSpec
    sources = []
    t0 = time.perf_counter()
    for name, weight, docs, seed in MIXTURE_SOURCES:
        url = write_token_corpus('file://' + os.path.join(root, name), docs, seed)
        sources.append(MixtureSource(name, weight, url=url))
    emit({'phase': 'write', 'dataset': 'lm-mixture-flagship',
          'sources': {name: {'documents': docs, 'weight': weight, 'seed': seed}
                      for name, weight, docs, seed in MIXTURE_SOURCES},
          'seconds': time.perf_counter() - t0})
    return MixtureSpec(sources, seed=0, seq_len=MIXTURE_ROW)


def phase_mixture_path(spec):
    """``pretrain_mixture`` on the card: the flagship on packed rows of the
    3:1 mixture, each flash kernel 10 times a step."""
    from petastorm_tpu_torch.examples.lm_pretrain import FLAGSHIP_LM_KW, pretrain_mixture
    from petastorm_tpu_torch.telemetry import reset_registry
    reset_registry()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    result = pretrain_mixture(spec, batch_size=LM_BATCH, steps=MIXTURE_STEPS,
                              model_kw=FLAGSHIP_LM_KW, attn_impl='flash', device='cuda')
    torch.cuda.synchronize()
    launches = launch_counts()
    stages = stage_seconds()
    losses = result['losses']
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    weights = {s.name: s.weight for s in spec.sources}
    docs = result['source_docs']
    emit({'phase': 'mixture_path', 'config': 'lm-mixture-flagship', 'model': FLAGSHIP_LM_KW,
          'steps': len(losses), 'batch_size': LM_BATCH, 'packed_row_tokens': MIXTURE_ROW,
          'attention_positions': MIXTURE_ROW - 1, 'weights': weights,
          'launches': launches,
          'launches_per_step': {k: v / MIXTURE_STEPS for k, v in launches.items()},
          'batch_devices': result['batch_devices'], 'losses': losses,
          'loss_first5_mean': first, 'loss_last5_mean': last,
          'tokens_per_s': result['tokens_per_s'], 'steps_per_s': result['steps_per_s'],
          'tokens_per_s_counts': 'trained positions: batch_size x (packed_row_tokens - 1) a step',
          'pack_stats': result['pack_stats'], 'source_docs': docs,
          'source_share': {k: v / sum(docs.values()) for k, v in docs.items()},
          'realized_deviation': result['realized_deviation'],
          'consumer_wait_s': result['diagnostics']['consumer_wait_s'],
          'peak_memory_bytes': torch.cuda.max_memory_allocated(),
          'stage_seconds': stages})
    assert len(losses) == MIXTURE_STEPS
    assert all(math.isfinite(v) for v in losses), losses
    assert last < first, (first, last)
    assert result['batch_devices'] == ['cuda:0'], result['batch_devices']
    assert stages.get('pack', 0.0) > 0.0, stages
    assert result['pack_stats']['rows'] >= MIXTURE_STEPS * LM_BATCH, result['pack_stats']
    assert result['realized_deviation'] <= 1.0, result['realized_deviation']
    want = FLAGSHIP_LM_KW['n_layers'] * MIXTURE_STEPS
    for name in FLASH_KERNELS:
        assert launches[name] == want, (name, launches[name], want)
    return launches


def phase_mixture_profile(spec):
    """Where a flagship step fed by the mixture loader goes
    (``profile_steps``): each profiled step pulls its packed batch from
    ``make_torch_loader(mixture=)``."""
    from petastorm_tpu_torch.device.loader import make_torch_loader
    from petastorm_tpu_torch.examples.lm_pretrain import FLAGSHIP_LM_KW
    from petastorm_tpu_torch.models.transformer import (
        TransformerConfig, adamw, init_transformer, transformer_train_step,
    )
    config = TransformerConfig(max_seq_len=MIXTURE_ROW - 1, loss_chunk=256, attn_impl='flash',
                               **FLAGSHIP_LM_KW)
    model = init_transformer(0, config, 'cuda')
    step = transformer_train_step(model, adamw(model))
    with make_torch_loader(None, batch_size=LM_BATCH, mixture=spec, num_epochs=None,
                           device='cuda') as loader:
        batches = iter(loader)
        profile_steps('mixture_profile', lambda: step(next(batches)['tokens']),
                      MIXTURE_PROFILE_STEPS)


def phase_resume(spec):
    """Run A: ``RESUME_STEPS`` unbroken steps. Run B: half of them and a
    ``TrainCheckpointer`` save, then a second call that builds a fresh
    loader, model and optimizer, restores all three and trains the rest.
    The token batches after the restore equal run A's bit for bit; the
    losses agree within ``RESUME_LOSS_RTOL``."""
    from petastorm_tpu_torch.examples.lm_pretrain import FLAGSHIP_LM_KW, pretrain_mixture
    half = RESUME_STEPS // 2

    def run(steps, checkpoint_dir=None, checkpoint_every=half):
        batches = {}
        result = pretrain_mixture(
            spec, batch_size=LM_BATCH, steps=steps, model_kw=FLAGSHIP_LM_KW,
            attn_impl='flash', device='cuda', checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every,
            on_step=lambda i, batch, loss: batches.__setitem__(i, batch['tokens'].cpu()))
        return result, batches

    unbroken, want = run(RESUME_STEPS)
    with tempfile.TemporaryDirectory() as directory:
        head, _ = run(half, directory)
        # restores step `half` and saves no more
        tail, got = run(RESUME_STEPS, directory, checkpoint_every=RESUME_STEPS + 1)
    same = [torch.equal(got[i], want[i]) for i in range(half + 1, RESUME_STEPS + 1)]
    pairs = list(zip(unbroken['losses'][half:], tail['losses']))
    gaps = [abs(b - a) / abs(a) for a, b in pairs]
    save = head['saves'][0]
    emit({'phase': 'resume', 'config': 'lm-mixture-flagship', 'steps': RESUME_STEPS,
          'restored_at': tail['start_step'], 'batches_bit_identical': same,
          'losses_unbroken': unbroken['losses'], 'losses_resumed': head['losses'] + tail['losses'],
          'max_loss_rel_gap': max(gaps), 'tolerance': 'rel <= %g' % RESUME_LOSS_RTOL,
          'checkpoint_bytes': save['bytes'], 'save_s': save['seconds'],
          'restore_s': tail['restore_s'],
          'restore_counts': 'restore_loader + restore_state, host seconds'})
    assert tail['start_step'] == half, tail['start_step']
    assert sorted(got) == list(range(half + 1, RESUME_STEPS + 1)), sorted(got)
    assert all(same), same
    assert max(gaps) <= RESUME_LOSS_RTOL, gaps


def write_lm_dataset(url, num_docs=LM_DOCS):
    from petastorm_tpu_torch.examples.lm_pretrain import FLAGSHIP_LM_KW, generate_c4_like
    from petastorm_tpu_torch.reader import make_batch_reader
    t0 = time.perf_counter()
    generate_c4_like(url, num_docs=num_docs, vocab_size=FLAGSHIP_LM_KW['vocab_size'], seed=0)
    seconds = time.perf_counter() - t0
    with make_batch_reader(url, reader_pool_type='dummy', num_epochs=1) as reader:
        tokens = sum(len(doc) for batch in reader for doc in batch.tokens)
    emit({'phase': 'write', 'dataset': 'c4_like', 'documents': num_docs,
          'tokens': tokens, 'seconds': seconds})


def _launches_by_path(name, paths):
    return {path: counts[name] for path, counts in paths.items() if name in counts}


def main():
    if not torch.cuda.is_available():
        print('chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False',
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    status, probe = phase_build()
    image_codec = image_codec_for(status, probe)
    kernel = phase_kernel()
    flash = phase_flash_kernel()
    phase_native_decode(status)
    from petastorm_tpu_torch.examples.mnist import generate_synthetic_mnist
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        url = 'file://' + os.path.join(tmp, 'mnist')
        t0 = time.perf_counter()
        generate_synthetic_mnist(url, num_rows=MNIST_ROWS)
        emit({'phase': 'write', 'rows': MNIST_ROWS, 'seconds': time.perf_counter() - t0})
        phase_reference(url)
        phase_lm_reference()
        phase_lm_reference_bf16()
        paths['main_path'] = {'normalize_images': phase_main_path(url)}
        lm_url = 'file://' + os.path.join(tmp, 'c4_like')
        write_lm_dataset(lm_url)
        paths['lm_path'] = phase_lm_path(lm_url)
        phase_lm_profile()
        phase_varlen_reference(lm_url)
        paths['varlen_path'] = phase_varlen_path(lm_url)
        phase_varlen_profile()
        replay_url = 'file://' + os.path.join(tmp, 'c4_like_%d' % REPLAY_DOCS)
        write_lm_dataset(replay_url, num_docs=REPLAY_DOCS)
        phase_inmemory_replay(replay_url)
        mixture = write_mixture_corpora(tmp)
        paths['mixture_path'] = phase_mixture_path(mixture)
        phase_mixture_profile(mixture)
        phase_resume(mixture)
        vit_url = 'file://' + os.path.join(tmp, 'imagenet_like')
        write_vit_dataset(vit_url, image_codec)
        phase_image_reference(vit_url, image_codec)
        paths['vit_path'] = phase_vit_path(vit_url, image_codec)
    phase_vit_profile()
    # the headline numbers are this slice's path's: the flash kernels' at
    # the mixture path's shape (the flagship's) and their launches there;
    # normalize's on the ViT path, the last path that runs it; the
    # earlier paths' shapes and launches stand beside them
    vit_case = kernel[VIT_KERNEL_CASE]
    main_case = kernel[MAIN_PATH_CASE]
    kernels = [{
        'name': 'normalize_images', 'route': 'cuda',
        'source': 'petastorm_tpu_torch/csrc/normalize.cu',
        'replaces': NORMALIZE_REPLACES, 'launches': paths['vit_path']['normalize_images'],
        'launches_by_path': _launches_by_path('normalize_images', paths),
        'max_abs_err': vit_case['max_abs_err'], 'ms': vit_case['ms'],
        'wall_ms': vit_case['wall_ms'], 'timer': vit_case['timer'],
        'plain_ms': vit_case['plain_ms'], 'bound_ms': vit_case['bound_ms'],
        'bound_by': vit_case['bound_by'], 'library_ms': None,
        'shape': vit_case['shape'],
        'mnist_bf16': {k: main_case[k] for k in ('shape', 'ms', 'wall_ms', 'timer', 'plain_ms',
                                                'bound_ms', 'max_abs_err')},
        'imagenet_bf16': {k: kernel['imagenet_bf16'][k]
                          for k in ('ms', 'wall_ms', 'timer', 'plain_ms', 'bound_ms',
                                    'max_abs_err')},
    }]
    for name, (_, key, outputs, replaces) in FLASH_KERNELS.items():
        entry = {'name': name, 'route': 'cuda',
                 # bf16 runs the tensor-core instances (the profiles check their names)
                 'instruction': 'wgmma',
                 'source': 'petastorm_tpu_torch/csrc/flash_attention.cu',
                 'replaces': replaces, 'launches': paths['mixture_path'][name],
                 'launches_by_path': _launches_by_path(name, paths)}
        for label in (VARLEN_FLASH_CASE, *VARLEN_TAIL_CASES, VIT_FLASH_CASE, FLASH_MAIN_CASE):
            case = flash[label]
            timing = case['kernels'][key]
            numbers = {
                'max_abs_err': max(case['errors'][g]['max_abs_err'] for g in outputs),
                'ms': timing['ms'], 'wall_ms': timing['wall_ms'], 'timer': timing['timer'],
                'plain_ms': timing['plain_ms'], 'bound_ms': timing['bound_ms'],
                'bound_by': timing['bound_by'],
                # SDPA's forward for the forward; SDPA's backward, which
                # makes dQ, dK and dV together, for the dK/dV + dQ pair
                'library_ms': case['sdpa_fwd_ms' if name == 'flash_fwd' else 'sdpa_bwd_ms'],
                'library_call': ('scaled_dot_product_attention forward' if name == 'flash_fwd'
                                 else 'scaled_dot_product_attention backward (dQ, dK, dV)'),
                'sdpa_fwd_ms': case['sdpa_fwd_ms'], 'sdpa_bwd_ms': case['sdpa_bwd_ms'],
                'sdpa_fwd_bwd_ms': case['sdpa_fwd_bwd_ms'],
                'shape': case['shape'], 'dtype': case['dtype'], 'causal': case['causal'],
            }
            entry[label] = numbers
            if label == FLASH_MAIN_CASE:
                entry.update(numbers)
        kernels.append(entry)
    emit({'kernels': kernels, 'seconds': time.perf_counter() - t_start})
    print(card_line(), flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
