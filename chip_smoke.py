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
Phases 17 to 21 run right after ``main_path``, on its dataset; 22 and 24
after ``lm_profile``, on its; 23 after ``vit_path``; 25 to 29 as each
says.

17. ``row_reference``: ``ROW_REFERENCE_STEPS`` steps of the PyTorch
    example (``examples/mnist_pytorch.py``: ``make_reader``, the row
    ``DataLoader`` onto the card, the example's CNN) from one set of
    initial weights, run twice on the same batches: normalized by the
    kernel and by its plain version; the normalized batches agree within
    1e-6 and the losses within 1e-5 relative (TF32 off, cuDNN
    deterministic). Phase ``kernel`` holds the kernel at the example's
    shape, (32, 28, 28, 1) u8 -> f32.
18. ``pytorch_path``: the example's ``train`` for one epoch of the
    60,000 MNIST rows (1,875 steps, thread pool), then ``evaluate``:
    rows/s, steps/s, consumer wait, stage seconds, one normalize launch a
    step, peak memory, the loss falling, the accuracy.
19. ``batched_bridge_path``: ``BatchedDataLoader(make_batch_reader)``
    (batch 64, 4,096-row shuffle buffer) into the same CNN for one epoch,
    again with ``inmemory_cache_all`` over two epochs (the replay copies
    host memory to the card again), and ``make_torch_loader`` into it too:
    the three ways in, by rows/s, beside ``main_path``'s.
20. ``row_resume``: a row reader stopped after 25,000 rows, its state
    restored in a new reader that reads on: every row read, repeats only
    from the row-group in flight; then ``WeightedSamplingReader``
    (deterministic, 3:1) over the two shards' row readers through
    ``DataLoader`` onto the card, the realized share within the
    schedule's bound.
21. ``ngram_path`` (configuration ngram-timeseries-100k): 100,000 rows of
    a driving log (``ts`` with a jump after every 997th row, a 128-float
    ``sensor`` frame, ``steering``) in 1,000-row groups, read as windows
    of three consecutive frames by ``make_reader(ngram=...)`` on the
    thread pool with two row-drop partitions, stacked 64 windows at a
    time onto the card: the window count equals the one worked out from
    the written ``ts``, every window's ``ts`` are consecutive on the card.
22. ``bridge_lm``: the C4-like documents packed by ``lm_path``'s
    ``TransformSpec`` through ``BatchedDataLoader(batch_size=8)`` into the
    full flagship for ``BRIDGE_LM_STEPS`` bf16 steps, each flash kernel
    10 times a step, tokens/s beside ``lm_path``'s; a profiled window
    (``bridge_lm_profile``) whose flash kernels are all ``_wgmma`` ones.
23. ``selective_vit_path`` (configuration vit-selective-quarter): the
    image path's ``VIT_ROWS`` rows written again in label order, with an
    ``id``, read through ``make_torch_loader(filters=[('label', 'in',
    <every 4th label>)])``: the ids equal a CPU full read filtered in
    numpy, the row-groups pruned equal what the footers' label statistics
    predict, images decoded and late-materialized rows equal the
    survivors, the card's batches equal the CPU loader's (dummy pool), and
    ``predicate=in_set(...)`` and the full-scan oracle
    (``PETASTORM_TPU_PUSHDOWN=0``) read the same rows; read seconds of
    the subset, of the subset priced as a full scan and of the full read;
    then ``SELECTIVE_STEPS`` ViT-Base steps on the subset with one
    normalize launch a step and 12 of each flash kernel.
24. ``dp_lm_path``: two spawned ranks in a gloo group on the one card,
    each with ``make_torch_loader(mesh=DeviceMesh over ('dp',))`` and no
    shard given, training the full flagship for ``DP_STEPS`` AdamW steps
    with gradients averaged through the host: the ranks' row-groups are
    disjoint and cover the epoch, ``loader.sharding`` rebuilds the global
    batch, the first averaged gradient matches one process's step on it,
    the replicas' weights stay equal, every flash kernel is ``_wgmma``;
    tokens/s and peak memory per rank.
25. ``traced_lm_path`` (after ``lm_path``): the flagship as ``lm_path``
    runs it, untraced and then traced (``PETASTORM_TPU_TRACE=1``, one
    row-group in ``TRACE_LM_SAMPLE`` sampled, a dump path armed), both on
    one pool worker so row-groups arrive in ventilation order: the traced
    run trains on the untraced run's batches (checksums in order), each
    flash kernel launches layers x steps times on bf16 inputs in each
    run, the traced row-groups are exactly the sampled ones of the
    ventilated prefix, the dumped trace loads as Chrome trace-event JSON
    with events on the ventilator, worker and stager tracks, and every
    traced stage is in ``pipeline_report()``; both reports, their stall
    verdicts, the critical path and the two runs' tokens/s are printed.
26. ``traced_vit_path`` (after ``vit_path``): ``VIT_STEPS`` traced
    ViT-Base steps: the stall verdict, ``h2d_overlap_share``, the
    critical path and the trace's tracks; launches exact.
27. ``pytorch_path_report`` (after ``pytorch_path``): that path's
    ``pipeline_report()``: the stall verdict, the wait clocks and the
    stage seconds against the epoch's wall time.
28. ``obs_lm_path`` (after ``traced_lm_path``): the same flagship run,
    unarmed and then with the live plane armed (``OBS_LM_KNOBS``: an
    endpoint on a free port, 0.25 s windows, ``h2d_overlap>=0.3`` and
    ``rows_per_sec>=1``, a flight-log directory, tracing off) while a
    scraper thread reads ``/metrics`` once a window and ``/health`` and
    ``/report`` at steps 5 and 20 (the run waiting at 20 one window and
    for the reads, left out of its tokens/s): the armed run trains on the
    unarmed run's batches with each flash kernel launched layers x steps
    times on bf16 inputs in each run; every ``/metrics`` body parses as
    Prometheus text, counters never fall between scrapes, the
    stage-seconds series equal the in-process ``prometheus_text()`` after
    the loader stops, ``/health`` is ``ok`` with the reader and the
    loader mounted,
    ``/report`` has 4 or more windows and no objective breaching, and
    ``python -m petastorm_tpu_torch.tools.obs_replay --json`` folds the
    windows the sampler closed. Tokens/s of both runs, scrape times by
    route, anomalies and the per-window H2D overlap are printed.
29. ``obs_drill_path`` (after ``batched_bridge_path``): the slow-consumer
    drill on mnist-synthetic-60k (``OBS_DRILL_KNOBS``): two thread
    workers, a results queue of one, the normalize kernel on each of
    ``OBS_DRILL_BATCHES`` batches and a 0.12 s sleep after each, under
    ``queue_wait_p99<=0.05ms`` with every row-group traced: ``/health``
    turns to ``slo-breach`` while the loader runs, ``OBS_DRILL_KINDS``
    appear in the live ``/report`` and the final report, the budget is
    spent, the flight log holds windows, verdicts and anomalies and its
    replay folds the breach, ``/trace`` has ventilator and worker tracks,
    ``/critpath`` names a bottleneck, and normalize launches once a batch.
Both tear the plane down after them: no endpoint or sampler thread
outlives its phase.
``--trace-dir DIR`` keeps the two Chrome traces in ``DIR``.

Then the ``kernels`` summary (each kernel's launches on every path), the
``nvidia-smi`` name and power limit, and the ``ok`` line. The script
needs CUDA and the repository beside it.
"""

import collections
import contextlib
import json
import math
import os
import queue
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
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
    ('mnist_pytorch_f32', (32, 28, 28, 1), torch.float32, False),
]
MAIN_PATH_CASE = 'mnist_bf16'
VIT_KERNEL_CASE = 'vit_bf16'
PYTORCH_KERNEL_CASE = 'mnist_pytorch_f32'
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

# the row reader and the PyTorch bridge: examples/mnist/pytorch_example.py
# on mnist-synthetic-60k (batch 32, row buffer 256), one epoch
PYTORCH_BATCH = 32
PYTORCH_STEPS = MNIST_ROWS // PYTORCH_BATCH    # 1875
ROW_REFERENCE_STEPS = 20
ROW_REFERENCE_NORM_ATOL = 1e-6
ROW_REFERENCE_LOSS_RTOL = 1e-5
# one epoch of the example's recipe separates 8-10 of the 10 synthetic
# classes (8 and 9 lie 19 grey levels apart); chance is 0.1
PYTORCH_MIN_ACCURACY = 0.3
BRIDGE_BATCH = 64
BRIDGE_SHUFFLE = 4096
BRIDGE_LM_STEPS = 10
BRIDGE_LM_PROFILE_STEPS = 2
# ngram-timeseries-100k: a driving log's consecutive sensor frames
NGRAM_ROWS = 100_000
NGRAM_ROWGROUP = 1000
NGRAM_JUMP_EVERY = 997       # ts steps by NGRAM_JUMP after every 997th row
NGRAM_JUMP = 5
NGRAM_SENSOR = 128
NGRAM_BATCH = 64
NGRAM_DROP_PARTITIONS = 2
NGRAM_FIELDS = {-1: ['ts', 'sensor'], 0: ['ts', 'sensor', 'steering'], 1: ['ts', 'steering']}
ROW_RESUME_STOP = 25_000
MNIST_ROWGROUP = 256         # generate_synthetic_mnist's row-group size
WEIGHTED_ROWS = 64 * 200
# vit-selective: the image path's rows in label order, read through
# filters= on every 4th of the distinct labels
SELECTIVE_LABEL_STRIDE = 4
SELECTIVE_STEPS = 8
# dp-lm: two gloo ranks on the one card feed the flagship
DP_RANKS = 2
DP_STEPS = 5                 # the first is held against one process; the rest timed
DP_TIMEOUT_S = 600
DP_GRAD_TOL = 3e-2           # max|avg - one process| / max|one process|, bf16
DP_LOSS_RTOL = 1e-3
# the traced paths: PETASTORM_TPU_TRACE=1; the LM run traces every other
# row-group (PETASTORM_TPU_TRACE_SAMPLE), the ViT run every one
TRACE_LM_SAMPLE = 2
TRACE_VIT_SAMPLE = 1
# tracks every traced path's trace must hold events on (pool workers by kind)
TRACE_TRACKS = ('ventilator', 'thread', 'stager')
# the live plane on the flagship: a 0.25 s window, two objectives the run
# should meet, tracing off; /health and /report are read at these steps
OBS_LM_KNOBS = {'PETASTORM_TPU_OBS_PORT': '0', 'PETASTORM_TPU_OBS_WINDOW_SEC': '0.25',
                'PETASTORM_TPU_SLO': 'h2d_overlap>=0.3;rows_per_sec>=1'}
OBS_LM_MARK_STEPS = (5, LM_STEPS)
# the slow-consumer drill: an objective below the first duration bucket,
# so every window with a pull is bad, and every row-group traced
OBS_DRILL_KNOBS = {'PETASTORM_TPU_OBS_PORT': '0', 'PETASTORM_TPU_OBS_WINDOW_SEC': '0.2',
                   'PETASTORM_TPU_SLO': 'queue_wait_p99<=0.05ms', 'PETASTORM_TPU_TRACE': '1'}
OBS_DRILL_BATCHES = 30
OBS_DRILL_SLEEP_S = 0.12
# the kinds the same drill fires through both packages' loaders on the CPU
# (tests/test_torch_obs_endpoint.py)
OBS_DRILL_KINDS = {'queue_saturated', 'slo_breach'}


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


def fresh_telemetry():
    """A fresh registry, stall attributor and flight recorder: a path's
    report and trace hold that path only."""
    from petastorm_tpu_torch import telemetry
    telemetry.reset_registry()
    telemetry.reset_attributor()
    telemetry.reset_recorder()


@contextlib.contextmanager
def knobs_set(values):
    """The ``PETASTORM_TPU_*`` knobs in ``values`` set for the block, with
    fresh telemetry; the knobs restored and re-read after."""
    from petastorm_tpu_torch import telemetry
    saved = {name: os.environ.get(name) for name in values}
    for name, value in values.items():
        telemetry.knobs.set_env(name, value)
    telemetry.refresh()
    fresh_telemetry()
    try:
        yield
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value
        telemetry.refresh()


def tracing_on(dump_path, sample):
    """``PETASTORM_TPU_TRACE=1``, one item in ``sample`` traced and a dump
    path for the block (:func:`knobs_set`)."""
    return knobs_set({'PETASTORM_TPU_TRACE': '1',
                      'PETASTORM_TPU_TRACE_SAMPLE': '1/%d' % sample,
                      'PETASTORM_TPU_TRACE_DUMP': dump_path})


def report_summary(report):
    """The parts of ``pipeline_report()`` a phase prints: stage seconds,
    calls and shares, the stall verdict with its windows counted by
    verdict, the H2D overlap share and the critical path."""
    stall = report['stall']
    out = {'stages': {k: {'seconds': round(v['seconds'], 6), 'calls': v['calls'],
                          'share': round(v['share'], 4)} for k, v in report['stages'].items()},
           'wall_time_s': report['wall_time_s'],
           'attributed_fraction': report['attributed_fraction'],
           'stall_verdict': stall['verdict'],
           'producer_wait_s': stall['producer_wait_s'],
           'consumer_wait_s': stall['consumer_wait_s'],
           'windows_by_verdict': dict(collections.Counter(w['verdict'] for w in stall['windows'])),
           'h2d_overlap_share': report.get('h2d_overlap_share')}
    critical = report.get('critical_path')
    if critical is not None:
        out['critical_path'] = {k: critical[k] for k in (
            'items', 'events', 'span_s', 'bottleneck', 'stages', 'recommendation')}
        out['critical_path']['what_if'] = [
            '%s => epoch %+.1f%%' % (w['scenario'], w['epoch_delta_pct'])
            for w in critical['what_if']]
    return out


def check_trace_file(path, events):
    """The dumped file loads as Chrome trace-event JSON, holds every
    recorded event, and has events on the ventilator, worker and stager
    tracks. Returns the events per track kind."""
    with open(path) as f:
        doc = json.load(f)
    names = {m['tid']: m['args']['name'] for m in doc['traceEvents'] if m['ph'] == 'M'}
    data = [e for e in doc['traceEvents'] if e['ph'] != 'M']
    assert len(data) == len(events), (len(data), len(events))
    for e in data:
        assert {'name', 'ph', 'ts', 'pid', 'tid', 'args'} <= set(e), e
        assert e['ph'] != 'X' or e['dur'] >= 0, e
    by_track = collections.Counter(re.sub(r'-\d+$', '', names[e['tid']]) for e in data)
    for track in TRACE_TRACKS:
        assert by_track[track], (track, dict(by_track))
    return dict(by_track)


def check_report_stages(report, events):
    """Every stage the traced events name is in the report, and every
    critical-path stage is one of the report's."""
    from petastorm_tpu_torch.telemetry import STAGES
    traced = {e['name'] for e in events if e['name'] in STAGES}
    assert traced <= set(report['stages']), (traced, sorted(report['stages']))
    critical = report['critical_path']
    assert set(critical['stages']) <= set(report['stages'])
    assert critical['bottleneck'] in critical['stages'] and critical['what_if']
    assert report['stall']['verdict'] in ('producer-bound', 'consumer-bound', 'balanced')
    return sorted(traced)


def flagship_run(url, scope, inside=None, on_step=None):
    """One ``lm_path`` run of the flagship (``FLAGSHIP_LM_KW``, batch 8,
    1024 positions, bf16, ``LM_STEPS`` steps) on one pool worker, so the
    row-groups arrive in ventilation order, inside the context ``scope``
    with fresh telemetry and launch counts. Returns the result, each
    batch's checksum, the launches and the flash kernels' launches by
    input dtype (``flash_attention._launch`` wrapped for the run), and
    whatever ``inside(result)``, called in the scope, adds."""
    from petastorm_tpu_torch.examples.lm_pretrain import FLAGSHIP_LM_KW, pretrain
    from petastorm_tpu_torch.ops import flash_attention
    launch = flash_attention._launch
    sums, dtypes = [], collections.Counter()
    weights = []

    def on_step_sum(step, batch, loss):
        tokens = batch['tokens'].to(torch.int64)
        if not weights:
            weights.append(torch.arange(1, tokens.numel() + 1, device=tokens.device,
                                        dtype=torch.int64).view(tokens.shape))
        sums.append((tokens * weights[0]).sum())      # read after the run: no sync
        if on_step is not None:
            on_step(step, batch, loss)

    def recording_launch(fn, name, pointers, tensors, q, *args):
        dtypes[str(q.dtype)] += 1
        return launch(fn, name, pointers, tensors, q, *args)

    fresh_telemetry()
    reset_launch_counts()
    flash_attention._launch = recording_launch
    try:
        with scope:
            result = pretrain(url, batch_size=LM_BATCH, steps=LM_STEPS, seq_len=LM_SEQ,
                              model_kw=FLAGSHIP_LM_KW, attn_impl='flash', device='cuda',
                              on_step=on_step_sum, workers_count=1)
            torch.cuda.synchronize()
            extra = inside(result) if inside is not None else {}
    finally:
        flash_attention._launch = launch
    return dict(extra, result=result, sums=[int(v) for v in sums], launches=launch_counts(),
                dtypes=dict(dtypes))


def phase_traced_lm_path(url, lm_tokens_per_s, trace_dir):
    """The flagship as ``lm_path`` runs it (``FLAGSHIP_LM_KW``, batch 8,
    1024 positions, bf16, ``LM_STEPS`` steps), untraced and then traced
    (one row-group in ``TRACE_LM_SAMPLE``, a dump path armed), both on
    one pool worker so the row-groups arrive in ventilation order: the
    traced run trains on the untraced run's batches (checksums in order),
    launches each flash kernel layers x steps times on bf16 inputs, and
    its trace holds every sampled row-group and no other."""
    from petastorm_tpu_torch import telemetry
    from petastorm_tpu_torch.examples.lm_pretrain import FLAGSHIP_LM_KW
    from petastorm_tpu_torch.reader import make_batch_reader
    runs = {}
    for mode in ('untraced', 'traced'):
        dump = os.path.join(trace_dir, 'lm_trace_autodump.json')
        scope = tracing_on(dump, TRACE_LM_SAMPLE) if mode == 'traced' else contextlib.nullcontext()

        def inside(result, mode=mode):
            report = telemetry.pipeline_report(wall_time_s=LM_STEPS / result['steps_per_s'])
            events = telemetry.get_recorder().snapshot()
            trace = None
            if mode == 'traced':
                trace = os.path.join(trace_dir, 'lm_trace.json')
                assert telemetry.dump_trace(trace) == len(events)
            return {'report': report, 'events': events, 'trace': trace}

        runs[mode] = flagship_run(url, scope, inside=inside)
    plain, traced = runs['untraced'], runs['traced']
    events = traced['events']
    tracks = check_trace_file(traced['trace'], events)
    stages = check_report_stages(traced['report'], events)
    # sampling: the traced row-groups are exactly the ventilated ones whose
    # index the stride divides, in ventilation order, up to the last traced
    with make_batch_reader(url, schema_fields=['^tokens$'], num_epochs=None) as reader:
        order = reader.ventilation_order(0)
    ventilated = [e['args']['item'] for e in sorted(events, key=lambda e: e['ts'])
                  if e['name'] == 'ventilate']
    assert ventilated and all(i % TRACE_LM_SAMPLE == 0 for i in ventilated), ventilated
    last = order.index(ventilated[-1])
    assert ventilated == [i for i in order[:last + 1] if i % TRACE_LM_SAMPLE == 0], \
        (ventilated, order[:last + 1])
    pulled = sorted(e['args']['item'] for e in events if e['name'] == 'queue_wait')
    assert set(pulled) <= set(ventilated) and pulled, pulled
    emit({'phase': 'traced_lm_path', 'model': FLAGSHIP_LM_KW, 'steps': LM_STEPS,
          'batch_size': LM_BATCH, 'attention_positions': LM_SEQ, 'workers_count': 1,
          'trace_sample': '1/%d' % TRACE_LM_SAMPLE,
          'tokens_per_s': {'lm_path': lm_tokens_per_s,
                           'untraced': plain['result']['tokens_per_s'],
                           'traced': traced['result']['tokens_per_s']},
          'traced_over_untraced': traced['result']['tokens_per_s']
          / plain['result']['tokens_per_s'],
          'batches_equal': plain['sums'] == traced['sums'], 'batches': len(traced['sums']),
          'launches': traced['launches'], 'launch_dtypes': traced['dtypes'],
          'trace_events': len(events), 'trace_tracks': tracks, 'traced_stages': stages,
          'ventilated_traced': len(ventilated), 'ventilation_prefix': last + 1,
          'losses_equal': plain['result']['losses'] == traced['result']['losses'],
          'report_untraced': report_summary(plain['report']),
          'report': report_summary(traced['report'])})
    print(telemetry.format_pipeline_report(traced['report']), flush=True)
    assert len(traced['sums']) == LM_STEPS
    assert plain['sums'] == traced['sums'], (plain['sums'], traced['sums'])
    assert all(math.isfinite(v) for v in traced['result']['losses'])
    want = FLAGSHIP_LM_KW['n_layers'] * LM_STEPS
    for run in (plain, traced):
        for name in FLASH_KERNELS:
            assert run['launches'][name] == want, (name, run['launches'][name], want)
        # bf16 inputs: the tensor-core (_wgmma) instances, whose names
        # lm_profile reads off the profiler in this call
        assert run['dtypes'] == {'torch.bfloat16': 3 * want}, run['dtypes']
    assert set(traced['report']['stages']) == set(plain['report']['stages']), \
        (sorted(traced['report']['stages']), sorted(plain['report']['stages']))
    assert 'critical_path' not in plain['report'] and not plain['events']
    return traced['launches']


def http_get(route):
    """``(body, ms)`` of one GET on this process's observability endpoint."""
    import urllib.request
    from petastorm_tpu_torch.telemetry import obs_server
    t0 = time.perf_counter()
    body = urllib.request.urlopen('http://127.0.0.1:%d%s' % (obs_server.server_port(), route),
                                  timeout=10).read()
    return body, (time.perf_counter() - t0) * 1e3


def parse_prometheus(text):
    """``({series_key: value}, {family: type})`` of one Prometheus text
    exposition. Fails unless every family has a ``# TYPE`` line before its
    series, every other line is ``key value``, and every histogram's
    ``_bucket`` counts rise to a ``+Inf`` bucket equal to its ``_count``."""
    types, series = {}, {}
    for line in text.splitlines():
        if line.startswith('# TYPE '):
            _, _, family, kind = line.split(' ')
            assert kind in ('counter', 'gauge', 'histogram'), line
            types[family] = kind
            continue
        key, value = line.rsplit(' ', 1)
        name = key.split('{', 1)[0]
        family = next((name[:-len(s)] for s in ('_bucket', '_sum', '_count')
                       if name.endswith(s) and types.get(name[:-len(s)]) == 'histogram'), name)
        assert family in types, line
        series[key] = float(value)
    buckets = collections.defaultdict(list)
    for key, value in series.items():
        if '_bucket{' in key:
            name, labels = key[:-1].split('_bucket{', 1)
            rest = ','.join(p for p in labels.split(',') if not p.startswith('le='))
            buckets[(name, rest)].append((key, value))
    for (name, rest), rows in buckets.items():
        values = [v for _, v in rows]
        assert values == sorted(values), (name, rest)
        assert rows[-1][0].endswith('le="+Inf"}'), rows[-1]
        count = '%s_count{%s}' % (name, rest) if rest else name + '_count'
        assert series[count] == values[-1], (count, series[count], values[-1])
    return series, types


class Scraper(threading.Thread):
    """A client of the live endpoint beside a run: ``/metrics`` once a
    window, and ``/health`` and ``/report`` each time :meth:`mark` is
    called (the event it returns is set once both are read). Keeps every
    body and every request's milliseconds by route."""

    def __init__(self, window_s):
        super().__init__(name='chip-smoke-scraper', daemon=True)
        self.window_s = window_s
        self.metrics, self.health, self.report = [], [], []
        self.ms = collections.defaultdict(list)
        self.error = None
        self._marks = queue.Queue()
        self._done = threading.Event()

    def mark(self):
        done = threading.Event()
        self._marks.put(done)
        return done

    def stop(self):
        self._done.set()
        self.join(timeout=30)
        assert not self.is_alive()
        if self.error is not None:
            raise self.error

    def _get(self, route):
        body, ms = http_get(route)
        self.ms[route].append(ms)
        return body

    def run(self):
        from petastorm_tpu_torch.telemetry import obs_server
        try:
            while obs_server.server_port() is None:
                if self._done.wait(0.01):
                    return
            next_metrics = 0.0
            while not self._done.is_set():
                if time.monotonic() >= next_metrics:
                    next_metrics = time.monotonic() + self.window_s
                    self.metrics.append(self._get('/metrics').decode())
                try:
                    done = self._marks.get(timeout=max(0.0, next_metrics - time.monotonic()))
                except queue.Empty:
                    continue
                self.health.append(json.loads(self._get('/health')))
                self.report.append(json.loads(self._get('/report')))
                done.set()
        except Exception as e:  # noqa: BLE001 - raised again by stop()
            self.error = e


def plane_torn_down():
    """Tear the live plane down (server, sampler, SLO policy, log writer)
    and check that none of its threads outlives the phase."""
    from petastorm_tpu_torch import telemetry
    telemetry.reset_for_tests()
    left = [t.name for t in threading.enumerate() if t.name.startswith('petastorm-tpu-torch-obs')]
    assert not left, left


def phase_obs_lm_path(url, tmp):
    """The flagship as ``traced_lm_path`` runs it, unarmed and then armed
    (``OBS_LM_KNOBS`` and a flight-log directory; tracing off) while a
    scraper reads ``/metrics`` once a window and ``/health`` and
    ``/report`` at ``OBS_LM_MARK_STEPS``: the armed run trains on the
    unarmed run's batches, launches each flash kernel layers x steps
    times on bf16 inputs in each run, and every route answers as the
    plane promises. At the last step the run waits, the card idle, one
    window (so the window holding the last steps closes) and then for
    that step's reads, while the loader still runs; the armed tokens/s
    leave that wait out."""
    from petastorm_tpu_torch import telemetry
    from petastorm_tpu_torch.examples.lm_pretrain import FLAGSHIP_LM_KW
    from petastorm_tpu_torch.telemetry import slo, timeseries
    from petastorm_tpu_torch.telemetry.spans import STAGE_SECONDS
    log_dir = os.path.join(tmp, 'obs_lm_log')
    knobs = dict(OBS_LM_KNOBS, PETASTORM_TPU_OBS_LOG_DIR=log_dir)
    unarmed = flagship_run(url, contextlib.nullcontext())
    scraper = Scraper(float(knobs['PETASTORM_TPU_OBS_WINDOW_SEC']))
    final_wait_s = []

    def on_step(step, batch, loss):
        if step == OBS_LM_MARK_STEPS[-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            time.sleep(scraper.window_s)
            assert scraper.mark().wait(60), 'the scraper did not answer'
            final_wait_s.append(time.perf_counter() - t0)
        elif step in OBS_LM_MARK_STEPS:
            scraper.mark()

    def inside(result):
        scraper.stop()
        collector = timeseries._collector
        return {'collector': collector, 'final_metrics': http_get('/metrics')[0].decode(),
                'in_process': telemetry.prometheus_text(),
                'report': telemetry.pipeline_report()}

    with knobs_set(knobs):
        scraper.start()
        armed = flagship_run(url, contextlib.nullcontext(), inside=inside, on_step=on_step)
        collector = armed['collector']
        collector.stop()
        windows = collector.rollup.windows()
        closed = collector.rollup.closed_total
        plane_torn_down()
    replay = subprocess.run([sys.executable, '-m', 'petastorm_tpu_torch.tools.obs_replay',
                             log_dir, '--json'], check=True, capture_output=True, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)), timeout=300)
    folded = json.loads(replay.stdout.strip().splitlines()[-1])
    parsed = [parse_prometheus(body) for body in scraper.metrics]
    for (before, types), (after, _) in zip(parsed, parsed[1:]):
        for key, value in before.items():
            if types.get(key.split('{', 1)[0]) == 'counter' and key in after:
                assert after[key] >= value, (key, value, after[key])
    stage_key = STAGE_SECONDS + '{'
    final, _ = parse_prometheus(armed['final_metrics'])
    in_process, _ = parse_prometheus(armed['in_process'])
    final_stages = {k: v for k, v in final.items() if k.startswith(stage_key)}
    # each window's fill/transfer overlap share, as the SLO reads it
    overlaps = [o for o in map(slo._resolve_h2d_overlap, windows) if o is not None]
    rollups = [r['rollup']['headline']['windows_sampled'] for r in scraper.report]
    slo_targets = [t for r in scraper.report for t in r['slo']['targets']]
    tokens = LM_STEPS * LM_BATCH * LM_SEQ
    armed_tokens_per_s = tokens / (LM_STEPS / armed['result']['steps_per_s'] - final_wait_s[0])
    ratio = armed_tokens_per_s / unarmed['result']['tokens_per_s']
    emit({'phase': 'obs_lm_path', 'model': FLAGSHIP_LM_KW, 'steps': LM_STEPS,
          'batch_size': LM_BATCH, 'attention_positions': LM_SEQ, 'workers_count': 1,
          'knobs': knobs,
          'tokens_per_s': {'unarmed': unarmed['result']['tokens_per_s'],
                           'armed': armed_tokens_per_s,
                           'armed_with_final_wait': armed['result']['tokens_per_s']},
          'final_wait_s': final_wait_s[0], 'armed_over_unarmed': ratio,
          'batches_equal': unarmed['sums'] == armed['sums'], 'batches': len(armed['sums']),
          'launches': armed['launches'], 'launch_dtypes': armed['dtypes'],
          'windows': closed, 'windows_replayed': folded['windows'],
          'scrapes': {route: len(ms) for route, ms in scraper.ms.items()},
          'scrape_ms': {route: {'median': statistics.median(ms), 'max': max(ms)}
                        for route, ms in scraper.ms.items()},
          'metrics_series': len(final),
          'anomalies_by_kind': armed['report'].get('anomalies', {}).get('by_kind'),
          'h2d_overlap_per_window': {'median': statistics.median(overlaps) if overlaps else None,
                                     'min': min(overlaps) if overlaps else None,
                                     'windows': len(overlaps)},
          'rollup_windows_sampled': rollups,
          'slo': armed['report'].get('slo'),
          'health_components': [sorted(h['components']) for h in scraper.health],
          'health_status': [h['status'] for h in scraper.health]})
    assert len(armed['sums']) == LM_STEPS and unarmed['sums'] == armed['sums'], \
        (unarmed['sums'], armed['sums'])
    assert all(math.isfinite(v) for v in armed['result']['losses'])
    want = FLAGSHIP_LM_KW['n_layers'] * LM_STEPS
    for run in (unarmed, armed):
        for name in FLASH_KERNELS:
            assert run['launches'][name] == want, (name, run['launches'][name], want)
        assert run['dtypes'] == {'torch.bfloat16': 3 * want}, run['dtypes']
    assert len(scraper.metrics) >= 2 and len(scraper.health) == len(OBS_LM_MARK_STEPS)
    assert final_stages and final_stages == {
        k: v for k, v in in_process.items() if k.startswith(stage_key)}, \
        (final_stages, in_process)
    for health in scraper.health:
        assert health['status'] == 'ok', health
        names = sorted(health['components'])
        assert any(n.startswith('reader') for n in names), names
        assert any(n.startswith('torch-loader') for n in names), names
    assert max(rollups) >= 4, rollups
    assert slo_targets and not any(t['breaching'] for t in slo_targets), slo_targets
    assert abs(folded['windows'] - closed) <= 1, (folded['windows'], closed)
    return armed['launches']


def phase_obs_drill_path(url, tmp):
    """The reference's slow-consumer drill on the card: mnist-synthetic-60k
    through ``make_torch_loader`` (batch 64, two thread workers, a results
    queue of one), the normalize kernel on every batch and a consumer that
    sleeps ``OBS_DRILL_SLEEP_S`` a batch for ``OBS_DRILL_BATCHES``
    batches, under ``OBS_DRILL_KNOBS``: ``/health`` turns to
    ``slo-breach`` while the loader runs, the drill's anomaly kinds appear
    live and in the final report, the budget is spent, the flight log
    replays the breach, and ``/trace`` and ``/critpath`` answer."""
    from petastorm_tpu_torch import telemetry
    from petastorm_tpu_torch.device.loader import make_torch_loader
    from petastorm_tpu_torch.examples.mnist import MNIST_MEAN, MNIST_STD
    from petastorm_tpu_torch.ops.normalize import normalize_images
    from petastorm_tpu_torch.telemetry import obslog
    from petastorm_tpu_torch.tools import obs_replay
    log_dir = os.path.join(tmp, 'obs_drill_log')
    knobs = dict(OBS_DRILL_KNOBS, PETASTORM_TPU_OBS_LOG_DIR=log_dir)
    breach_at = None
    with knobs_set(knobs):
        reset_launch_counts()
        t0 = time.perf_counter()
        with make_torch_loader(url, batch_size=BATCH_SIZE, fields=['^digit$', '^image$'],
                               num_epochs=None, workers_count=2, results_queue_size=1,
                               device='cuda') as loader:
            for i, batch in enumerate(loader.iter_steps(OBS_DRILL_BATCHES), 1):
                images = normalize_images(batch['image'][..., None], mean=MNIST_MEAN,
                                          std=MNIST_STD)
                assert images.device.type == 'cuda' and images.shape[0] == BATCH_SIZE
                time.sleep(OBS_DRILL_SLEEP_S)
                if breach_at is None and json.loads(http_get('/health')[0])['status'] == \
                        'slo-breach':
                    breach_at = i
            torch.cuda.synchronize()
            deadline = time.monotonic() + 10
            health = json.loads(http_get('/health')[0])
            while health['status'] != 'slo-breach' and time.monotonic() < deadline:
                time.sleep(0.05)
                health = json.loads(http_get('/health')[0])
            live = json.loads(http_get('/report')[0])
            trace = json.loads(http_get('/trace')[0])
            critpath = json.loads(http_get('/critpath')[0])
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        report = telemetry.pipeline_report()
        plane_torn_down()
    records = obslog.read_log(log_dir)
    summary = obs_replay.fold_summary(records)
    lines = []
    obs_replay.render_burn_report(summary['slo'], out=lines.append)
    tracks = collections.Counter(
        re.sub(r'-\d+$', '', m['args']['name']) for m in trace['traceEvents'] if m['ph'] == 'M')
    (target,) = report['slo']['targets']
    live_kinds = set((live.get('anomalies') or {}).get('by_kind') or {})
    final_kinds = set(report['anomalies']['by_kind'])
    emit({'phase': 'obs_drill_path', 'config': 'mnist-synthetic-60k', 'knobs': knobs,
          'batches': OBS_DRILL_BATCHES, 'sleep_s': OBS_DRILL_SLEEP_S,
          'batch_size': BATCH_SIZE, 'workers_count': 2, 'results_queue_size': 1,
          'seconds': seconds, 'launches': launches,
          'health_status': health['status'], 'breach_seen_at_batch': breach_at,
          'live_anomalies': sorted(live_kinds), 'final_anomalies': report['anomalies']['by_kind'],
          'slo': target, 'log_records': dict(collections.Counter(r['kind'] for r in records)),
          'replay': {k: summary[k] for k in ('windows', 'anomalies', 'anomaly_kinds')},
          'replay_burn': lines, 'trace_tracks': dict(tracks),
          'critpath_bottleneck': critpath.get('bottleneck'),
          'stall_verdict': report['stall']['verdict']})
    assert launches['normalize_images'] == OBS_DRILL_BATCHES, launches
    assert health['status'] == 'slo-breach', health
    assert OBS_DRILL_KINDS <= live_kinds and OBS_DRILL_KINDS <= final_kinds, \
        (live_kinds, final_kinds)
    assert target['target'] == 'queue_wait_p99' and target['breaching'], target
    assert target['budget_remaining'] == 0, target
    assert {'window', 'slo', 'anomaly'} <= {r['kind'] for r in records}
    folded = next(t for t in summary['slo'] if t['target'] == 'queue_wait_p99')
    assert folded['breaching_at_end'] and summary['anomaly_kinds'].get('slo_breach'), summary
    assert any('BREACHING' in line for line in lines), lines
    assert tracks['ventilator'] and tracks['thread'], dict(tracks)
    assert critpath.get('bottleneck'), critpath
    return launches


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
    return launches, result['tokens_per_s']


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
    return launches['normalize_images'], result['rows_per_s']


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
    return launches, result['images_per_s']


def phase_traced_vit_path(url, image_codec, vit_images_per_s, trace_dir):
    """``vit_path`` again, traced (every row-group, a dump path armed):
    the stall verdict, the staging engine's H2D overlap share, the
    critical path, the trace's tracks, and the launches exact."""
    from petastorm_tpu_torch import telemetry
    from petastorm_tpu_torch.examples.imagenet import VIT_BASE_KW, train_vit_fused
    reset_launch_counts()
    with tracing_on(os.path.join(trace_dir, 'vit_trace_autodump.json'), TRACE_VIT_SAMPLE):
        result = train_vit_fused(url, steps=VIT_STEPS, batch_size=VIT_BATCH, device='cuda')
        torch.cuda.synchronize()
        report = telemetry.pipeline_report(wall_time_s=VIT_STEPS / result['steps_per_s'])
        events = telemetry.get_recorder().snapshot()
        trace = os.path.join(trace_dir, 'vit_trace.json')
        assert telemetry.dump_trace(trace) == len(events)
    launches = launch_counts()
    tracks = check_trace_file(trace, events)
    stages = check_report_stages(report, events)
    emit({'phase': 'traced_vit_path', 'model': VIT_BASE_KW, 'steps': VIT_STEPS,
          'batch_size': VIT_BATCH, 'trace_sample': '1/%d' % TRACE_VIT_SAMPLE,
          'images_per_s': {'vit_path': vit_images_per_s, 'traced': result['images_per_s']},
          'traced_over_vit_path': result['images_per_s'] / vit_images_per_s,
          'launches': launches, 'trace_events': len(events), 'trace_tracks': tracks,
          'traced_stages': stages, 'fused_decode_mode': result['diagnostics']['fused_decode_mode'],
          'report': report_summary(report)})
    print(telemetry.format_pipeline_report(report), flush=True)
    assert all(math.isfinite(v) for v in result['losses']), result['losses']
    assert result['batch_devices'] == ['cuda:0'], result['batch_devices']
    assert launches['normalize_images'] == VIT_STEPS, launches
    want = VIT_BASE_KW['n_layers'] * VIT_STEPS
    for name in FLASH_KERNELS:
        assert launches[name] == want, (name, launches[name], want)
    assert report.get('h2d_overlap_share') is not None, sorted(report)
    staged = {'stage_fill', 'h2d_dispatch'} | ({'decode_fused'} if image_codec != 'npy' else set())
    assert staged <= set(report['stages']), sorted(report['stages'])
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
        # the profiler on the card has dropped every device event of a
        # window now and then: profile another replay pass, as time_ms does
        for attempt in range(1, PROFILE_ATTEMPTS + 1):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                checksum = sum(int(b['tokens'].sum()) for b in loader)
                torch.cuda.synchronize()
            device_events = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
            if device_events:
                break
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
                                   'tokens_checksum': checksum, 'attempts': attempt}})
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


def consumer_wait_s():
    """Seconds the consumer blocked on the reader (pulls over 10 ms)."""
    from petastorm_tpu_torch.telemetry import STALL_CONSUMER_WAIT, get_registry
    return get_registry().counter(STALL_CONSUMER_WAIT).value


def phase_row_reference(url):
    """``ROW_REFERENCE_STEPS`` steps of the PyTorch example's ``train`` on
    the card from one set of initial weights, twice on the same batches
    (dummy pool, seeded row buffer): once normalizing through the kernel,
    once through its plain version. TF32 off and cuDNN deterministic, so
    the two runs differ only by the normalize outputs."""
    from petastorm_tpu_torch.examples import mnist_pytorch
    from petastorm_tpu_torch.ops.normalize import normalize_images, normalize_images_reference
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.manual_seed(0)
    init = mnist_pytorch.Net().state_dict()
    runs = {}
    try:
        for name, normalize in (('kernel', normalize_images),
                                ('plain', normalize_images_reference)):
            seen = []

            def recording(images, normalize=normalize, seen=seen, **kw):
                out = normalize(images, **kw)
                seen.append(out.clone())
                return out

            model = mnist_pytorch.Net()
            model.load_state_dict(init)
            result = mnist_pytorch.train(url, device='cuda', model=model, seed=0,
                                         max_steps=ROW_REFERENCE_STEPS, reader_pool_type='dummy',
                                         log_interval=0, normalize=recording)
            runs[name] = (result, seen)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    torch.cuda.synchronize()
    (kernel, kernel_batches), (plain, plain_batches) = runs['kernel'], runs['plain']
    norm_err = max(float((a - b).abs().max()) for a, b in zip(kernel_batches, plain_batches))
    gaps = [abs(a - b) / abs(b) for a, b in zip(kernel['losses'], plain['losses'])]
    emit({'phase': 'row_reference', 'steps': ROW_REFERENCE_STEPS, 'batch_size': PYTORCH_BATCH,
          'normalized_batches': len(kernel_batches),
          'normalized_max_abs_err': norm_err,
          'normalized_tolerance': 'atol %g' % ROW_REFERENCE_NORM_ATOL,
          'losses_kernel': kernel['losses'], 'losses_plain': plain['losses'],
          'max_loss_rel_gap': max(gaps),
          'loss_tolerance': 'rel %g (TF32 off, cuDNN deterministic)' % ROW_REFERENCE_LOSS_RTOL,
          'batch_devices': kernel['batch_devices']})
    assert len(kernel_batches) == len(plain_batches) == ROW_REFERENCE_STEPS
    assert all(b.is_cuda and b.dtype == torch.float32
               and b.shape == (PYTORCH_BATCH, 28, 28, 1) for b in kernel_batches)
    assert norm_err <= ROW_REFERENCE_NORM_ATOL, norm_err
    assert all(math.isfinite(v) for v in kernel['losses'] + plain['losses'])
    assert max(gaps) <= ROW_REFERENCE_LOSS_RTOL, gaps
    assert kernel['batch_devices'] == ['cuda:0'], kernel['batch_devices']


def phase_pytorch_path(url):
    """The PyTorch example as a user runs it: ``train`` for one epoch of
    mnist-synthetic-60k (``make_reader`` on the thread pool, the row
    ``DataLoader`` onto the card, the normalize kernel, SGD), then
    ``evaluate``."""
    from petastorm_tpu_torch import telemetry
    from petastorm_tpu_torch.examples import mnist_pytorch
    fresh_telemetry()
    torch.cuda.reset_peak_memory_stats()
    torch.manual_seed(0)
    reset_launch_counts()
    result = mnist_pytorch.train(url, device='cuda', seed=0, log_interval=500)
    torch.cuda.synchronize()
    launches = launch_counts()
    wait = consumer_wait_s()
    stages = stage_seconds()
    # the row path's stall verdict and where its wall time goes
    report = telemetry.pipeline_report(wall_time_s=len(result['losses']) / result['steps_per_s'])
    t0 = time.perf_counter()
    accuracy = mnist_pytorch.evaluate(url, result['model'], device='cuda')
    evaluate_s = time.perf_counter() - t0
    losses = result['losses']
    first, last = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
    emit({'phase': 'pytorch_path', 'config': 'mnist-synthetic-60k',
          'entry': 'make_reader -> pytorch.DataLoader -> normalize kernel -> Net, SGD(0.01, 0.5)',
          'steps': len(losses), 'batch_size': PYTORCH_BATCH,
          'rows_per_s': result['rows_per_s'], 'steps_per_s': result['steps_per_s'],
          'consumer_wait_s': wait, 'stage_seconds': stages, 'launches': launches,
          'peak_memory_bytes': torch.cuda.max_memory_allocated(),
          'loss_first10_mean': first, 'loss_last10_mean': last, 'accuracy': accuracy,
          'accuracy_gate': '> %g (chance 0.1)' % PYTORCH_MIN_ACCURACY,
          'evaluate_s': evaluate_s, 'batch_devices': result['batch_devices']})
    emit({'phase': 'pytorch_path_report', 'report': report_summary(report)})
    print(telemetry.format_pipeline_report(report), flush=True)
    assert report['stall']['verdict'] in ('producer-bound', 'consumer-bound', 'balanced')
    assert report['stall']['consumer_wait_s'] == round(wait, 6), (report['stall'], wait)
    assert len(losses) == PYTORCH_STEPS, len(losses)
    assert all(math.isfinite(v) for v in losses)
    assert last < first, (first, last)
    assert launches['normalize_images'] == PYTORCH_STEPS, launches
    assert result['batch_devices'] == ['cuda:0'], result['batch_devices']
    assert accuracy > PYTORCH_MIN_ACCURACY, accuracy
    return launches


def _net_step(model, optimizer, batch):
    """One SGD step of the example's Net on a card batch; also the largest
    gap between an image's mean grey level and the one its digit encodes
    (``generate_synthetic_mnist``: 31.5 + 19 * digit on average), as a
    device scalar, so a row whose image and label parted would show."""
    import torch.nn.functional as F
    from petastorm_tpu_torch.examples.mnist_pytorch import normalized_images
    images, digits = batch['image'], batch['digit'].long()
    drift = (images.float().mean(dim=(1, 2)) - (31.5 + 19.0 * digits)).abs().max()
    optimizer.zero_grad()
    loss = F.nll_loss(model(normalized_images(images)), digits)
    loss.backward()
    optimizer.step()
    return loss.detach(), drift


def _net_epochs(loader, epochs):
    """``epochs`` passes of ``loader`` into a fresh Net: per pass rows,
    seconds, rows/s, H2D bytes and the largest label drift."""
    from petastorm_tpu_torch.device.staging import H2D_BYTES
    from petastorm_tpu_torch.examples.mnist_pytorch import Net
    from petastorm_tpu_torch.telemetry import get_registry
    torch.manual_seed(0)
    model = Net().cuda()
    optimizer = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.5)
    out = []
    for _ in range(epochs):
        h2d = get_registry().counter(H2D_BYTES).value
        rows, drifts, losses = 0, [], []
        t0 = time.perf_counter()
        for batch in loader:
            loss, drift = _net_step(model, optimizer, batch)
            losses.append(loss)
            drifts.append(drift)
            rows += len(batch['digit'])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        out.append({'rows': rows, 'seconds': seconds, 'rows_per_s': rows / seconds,
                    'h2d_bytes': get_registry().counter(H2D_BYTES).value - h2d,
                    'max_label_drift': float(torch.stack(drifts).max()),
                    'loss_first10_mean': float(torch.stack(losses[:10]).mean()),
                    'loss_last10_mean': float(torch.stack(losses[-10:]).mean())})
    return out


def phase_batched_bridge_path(url, main_rows_per_s):
    """Three ways into the PyTorch example's Net on mnist-synthetic-60k,
    each for one epoch: ``BatchedDataLoader(make_batch_reader)`` with a
    4096-row shuffle buffer, the same with ``inmemory_cache_all`` over two
    epochs (the second replays host memory), and ``make_torch_loader``;
    ``main_path``'s rows/s stands beside them."""
    from petastorm_tpu_torch.device.loader import make_torch_loader
    from petastorm_tpu_torch.pytorch import BatchedDataLoader
    from petastorm_tpu_torch.reader import make_batch_reader
    from petastorm_tpu_torch.telemetry import reset_registry
    fields = ['^digit$', '^image$']
    reset_registry()
    reset_launch_counts()

    def bridge(inmemory):
        return BatchedDataLoader(make_batch_reader(url, schema_fields=fields, num_epochs=1),
                                 batch_size=BRIDGE_BATCH, shuffling_queue_capacity=BRIDGE_SHUFFLE,
                                 seed=0, inmemory_cache_all=inmemory, device='cuda')

    with bridge(False) as loader:
        (plain,) = _net_epochs(loader, 1)
    launches = launch_counts()
    with bridge(True) as loader:
        cached, replay = _net_epochs(loader, 2)
    with make_torch_loader(url, batch_size=BRIDGE_BATCH, fields=fields, shuffle_rows=True,
                           seed=0, last_batch='short', device='cuda') as loader:
        (torch_loader,) = _net_epochs(loader, 1)
    wait = consumer_wait_s()
    runs = {'batched_bridge': plain, 'batched_bridge_inmemory_first': cached,
            'batched_bridge_inmemory_replay': replay, 'make_torch_loader': torch_loader}
    emit({'phase': 'batched_bridge_path', 'config': 'mnist-synthetic-60k',
          'batch_size': BRIDGE_BATCH, 'shuffling_queue_capacity': BRIDGE_SHUFFLE,
          'runs': runs, 'rows_per_s': {k: v['rows_per_s'] for k, v in runs.items()},
          'main_path_rows_per_s': main_rows_per_s,
          'main_path_note': 'make_torch_loader into the bf16 MnistCNN, batch 64, 50 steps',
          'replay_h2d_bytes': replay['h2d_bytes'], 'consumer_wait_s': wait,
          'launches': launches, 'stage_seconds': stage_seconds()})
    for name, run in runs.items():
        assert run['rows'] == MNIST_ROWS, (name, run['rows'])
        # half the 19 grey levels between two digits' means
        assert run['max_label_drift'] < 9.5, (name, run['max_label_drift'])
        assert math.isfinite(run['loss_last10_mean']), name
    assert plain['loss_last10_mean'] < plain['loss_first10_mean'], plain
    # the replay copies the cached host batches to the card again
    assert replay['h2d_bytes'] == cached['h2d_bytes'] > 0, (cached, replay)
    steps = -(-MNIST_ROWS // BRIDGE_BATCH)
    assert launches['normalize_images'] == steps, launches
    return launches


def phase_bridge_lm(url, lm_tokens_per_s):
    """The LM path through the bridge: the C4-like documents packed by
    ``lm_path``'s ``TransformSpec`` on the workers of ``make_batch_reader``,
    ``BatchedDataLoader(batch_size=8)`` onto the card, ``BRIDGE_LM_STEPS``
    bf16 AdamW steps of the full flagship; then a profiled window whose
    flash kernels must all be ``_wgmma`` ones."""
    from petastorm_tpu_torch.examples.lm_pretrain import FLAGSHIP_LM_KW, packing_transform
    from petastorm_tpu_torch.models.transformer import (
        TransformerConfig, adamw, init_transformer, transformer_train_step,
    )
    from petastorm_tpu_torch.pytorch import BatchedDataLoader
    from petastorm_tpu_torch.reader import make_batch_reader
    from petastorm_tpu_torch.telemetry import reset_registry
    reset_registry()
    torch.cuda.reset_peak_memory_stats()
    config = TransformerConfig(max_seq_len=LM_SEQ, loss_chunk=256, attn_impl='flash',
                               **FLAGSHIP_LM_KW)
    model = init_transformer(0, config, 'cuda')
    step = transformer_train_step(model, adamw(model))
    reader = make_batch_reader(url, schema_fields=['^tokens$'], num_epochs=None,
                               transform_spec=packing_transform(LM_SEQ + 1))
    with BatchedDataLoader(reader, batch_size=LM_BATCH, device='cuda') as loader:
        batches = iter(loader)
        reset_launch_counts()
        losses, devices, shapes = [], set(), set()
        start = time.perf_counter()
        for _ in range(BRIDGE_LM_STEPS):
            tokens = next(batches)['tokens']
            devices.add(str(tokens.device))
            shapes.add((tuple(tokens.shape), str(tokens.dtype)))
            losses.append(step(tokens))
        losses = [float(loss) for loss in losses]
        elapsed = time.perf_counter() - start
        launches = launch_counts()
        wait = consumer_wait_s()
        peak = torch.cuda.max_memory_allocated()
        profile = profile_steps('bridge_lm_profile', lambda: step(next(batches)['tokens']),
                                BRIDGE_LM_PROFILE_STEPS)
    tokens_per_s = BRIDGE_LM_STEPS * LM_BATCH * LM_SEQ / elapsed
    emit({'phase': 'bridge_lm', 'config': 'lm-c4like-flagship', 'model': FLAGSHIP_LM_KW,
          'entry': 'make_batch_reader(transform_spec=packing) -> pytorch.BatchedDataLoader',
          'steps': BRIDGE_LM_STEPS, 'batch_size': LM_BATCH, 'attention_positions': LM_SEQ,
          'batch_shapes': sorted(shapes), 'batch_devices': sorted(devices), 'losses': losses,
          'tokens_per_s': tokens_per_s, 'lm_path_tokens_per_s': lm_tokens_per_s,
          'steps_per_s': BRIDGE_LM_STEPS / elapsed, 'launches': launches,
          'launches_per_step': {k: v / BRIDGE_LM_STEPS for k, v in launches.items()},
          'consumer_wait_s': wait, 'peak_memory_bytes': peak,
          'flash_kernel_names': profile['flash_kernel_names']})
    assert devices == {'cuda:0'}, devices
    assert shapes == {((LM_BATCH, LM_SEQ + 1), 'torch.int32')}, shapes
    assert all(math.isfinite(v) for v in losses), losses
    want = FLAGSHIP_LM_KW['n_layers'] * BRIDGE_LM_STEPS
    for name in FLASH_KERNELS:
        assert launches[name] == want, (name, launches[name], want)
    return launches


def write_ngram_dataset(url):
    """ngram-timeseries-100k: ``NGRAM_ROWS`` rows of a driving log, ``ts``
    int64 stepping by 1 with a jump of ``NGRAM_JUMP`` after every
    ``NGRAM_JUMP_EVERY``-th row, a float32 ``sensor`` frame of
    ``NGRAM_SENSOR`` values and a float32 ``steering`` angle, in row-groups
    of ``NGRAM_ROWGROUP``; returns the written ``ts``."""
    import numpy as np
    import pyarrow as pa
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_dataset
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema('TimeseriesSchema', [
        UnischemaField('ts', np.int64, (), ScalarCodec(pa.int64()), False),
        UnischemaField('sensor', np.float32, (NGRAM_SENSOR,), NdarrayCodec(), False),
        UnischemaField('steering', np.float32, (), ScalarCodec(pa.float32()), False),
    ])
    steps = np.ones(NGRAM_ROWS, np.int64)
    steps[0] = 0
    steps[NGRAM_JUMP_EVERY::NGRAM_JUMP_EVERY] = NGRAM_JUMP
    ts = np.cumsum(steps)
    rng = np.random.RandomState(0)
    sensor = rng.standard_normal((NGRAM_ROWS, NGRAM_SENSOR)).astype(np.float32)
    steering = rng.uniform(-1.0, 1.0, NGRAM_ROWS).astype(np.float32)
    t0 = time.perf_counter()
    write_dataset(url, schema, [{'ts': int(ts[i]), 'sensor': sensor[i], 'steering': steering[i]}
                                for i in range(NGRAM_ROWS)],
                  rowgroup_size_rows=NGRAM_ROWGROUP)
    emit({'phase': 'write', 'dataset': 'ngram-timeseries-100k', 'rows': NGRAM_ROWS,
          'rowgroup_rows': NGRAM_ROWGROUP, 'jumps': int((steps > 1).sum()),
          'seconds': time.perf_counter() - t0})
    return ts


def expected_ngram_windows(ts, length):
    """Windows an NGram of ``length`` consecutive steps (delta threshold 1)
    admits in ``ts``: within each row-group, within each of the
    ``NGRAM_DROP_PARTITIONS`` row-drop partitions, each of which borrows
    the next partition's first ``length - 1`` rows."""
    count = 0
    for start in range(0, len(ts), NGRAM_ROWGROUP):
        rows = list(range(start, min(start + NGRAM_ROWGROUP, len(ts))))
        size = -(-len(rows) // NGRAM_DROP_PARTITIONS)
        for j in range(NGRAM_DROP_PARTITIONS):
            part = rows[j * size:(j + 1) * size + (length - 1)]
            t = [int(ts[i]) for i in part]
            count += sum(all(t[i + k + 1] - t[i + k] <= 1 for k in range(length - 1))
                         for i in range(len(t) - length + 1))
    return count


def phase_ngram_path(url, ts):
    """NGram windows of three consecutive frames from ``make_reader`` on
    the thread pool, with row-drop partitions: each batch of
    ``NGRAM_BATCH`` windows stacked per timestep and field and copied to
    the card, where every window's ``ts`` are checked consecutive."""
    import numpy as np
    from petastorm_tpu_torch.ngram import NGram
    from petastorm_tpu_torch.reader import make_reader
    from petastorm_tpu_torch.telemetry import reset_registry
    reset_registry()
    ngram = NGram(NGRAM_FIELDS, delta_threshold=1, timestamp_field='ts')
    expected = expected_ngram_windows(ts, ngram.length)
    bad = torch.zeros((), dtype=torch.int64, device='cuda')
    starts, shapes = [], set()

    def to_card(windows):
        nonlocal bad
        card = {k: {f: torch.from_numpy(np.stack([getattr(w[k], f) for w in windows]))
                    .pin_memory().to('cuda', non_blocking=True)
                    for f in windows[0][k]._fields} for k in windows[0]}
        shapes.update((k, f, tuple(t.shape[1:]), str(t.dtype))
                      for k, fields in card.items() for f, t in fields.items())
        bad = bad + ((card[0]['ts'] - card[-1]['ts'] != 1)
                     | (card[1]['ts'] - card[0]['ts'] != 1)).sum()

    with make_reader(url, ngram=ngram, reader_pool_type='thread',
                     shuffle_row_drop_partitions=NGRAM_DROP_PARTITIONS) as reader:
        t0 = time.perf_counter()
        pending = []
        for window in reader:
            starts.append(int(window[-1].ts))
            pending.append(window)
            if len(pending) == NGRAM_BATCH:
                to_card(pending)
                pending = []
        if pending:
            to_card(pending)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    bad = int(bad)
    emit({'phase': 'ngram_path', 'config': 'ngram-timeseries-100k', 'rows': NGRAM_ROWS,
          'ngram_fields': {str(k): v for k, v in NGRAM_FIELDS.items()}, 'length': ngram.length,
          'shuffle_row_drop_partitions': NGRAM_DROP_PARTITIONS, 'windows': len(starts),
          'expected_windows': expected, 'windows_per_s': len(starts) / seconds,
          'seconds': seconds, 'consumer_wait_s': consumer_wait_s(),
          'non_consecutive_windows': bad, 'card_shapes': sorted(map(str, shapes)),
          'stage_seconds': stage_seconds()})
    assert len(starts) == expected, (len(starts), expected)
    assert len(set(starts)) == len(starts), 'a window was read twice'
    assert bad == 0, bad
    # no admitted window spans a jump: no start within 2 rows before one
    jump_rows = set(np.flatnonzero(np.diff(ts) > 1).tolist())
    index = {int(t): i for i, t in enumerate(ts)}
    assert not any(index[s] in jump_rows or index[s] + 1 in jump_rows for s in starts)


def phase_row_resume(url):
    """A row reader (dummy pool, seed 0) stopped after ``ROW_RESUME_STOP``
    rows, its ``state_dict`` restored in a new reader that reads to the
    end: every row is read, and the only repeats are the row-group that
    was in flight. Then ``WeightedSamplingReader`` (deterministic, 3:1)
    over two row readers of the two shards, through ``DataLoader`` onto
    the card: the realized share stays within the schedule's bound."""
    from petastorm_tpu_torch.mixture import realized_deviation
    from petastorm_tpu_torch.pytorch import DataLoader
    from petastorm_tpu_torch.reader import make_reader
    from petastorm_tpu_torch.weighted_sampling_reader import WeightedSamplingReader
    kw = dict(reader_pool_type='dummy', seed=0, schema_fields=['^idx$', '^digit$'])
    t0 = time.perf_counter()
    with make_reader(url, **kw) as reader:
        head = [int(next(reader).idx) for _ in range(ROW_RESUME_STOP)]
        state = json.loads(json.dumps(reader.state_dict()))
    with make_reader(url, **kw) as reader:
        reader.load_state_dict(state)
        tail = [int(row.idx) for row in reader]
    resume_s = time.perf_counter() - t0
    repeated = set(head) & set(tail)
    in_flight = {i // MNIST_ROWGROUP for i in repeated}

    weights = [3, 1]
    readers = [make_reader(url, reader_pool_type='dummy', seed=0, num_epochs=None,
                           cur_shard=shard, shard_count=2,
                           schema_fields=['^idx$', '^digit$', '^image$'])
               for shard in range(2)]
    mix = WeightedSamplingReader(readers, weights, seed=0, deterministic=True)
    order, devices = [], set()
    t0 = time.perf_counter()
    with DataLoader(mix, batch_size=BRIDGE_BATCH, device='cuda') as loader:
        for batch in loader:
            devices.update(str(t.device) for t in batch.values())
            # shard s holds the row-groups n with n % 2 == s
            order.extend(((batch['idx'] // MNIST_ROWGROUP) % 2).tolist())
            if len(order) >= WEIGHTED_ROWS:
                break
    mix_s = time.perf_counter() - t0
    deviation = realized_deviation(order, weights)
    emit({'phase': 'row_resume', 'config': 'mnist-synthetic-60k', 'stopped_after': len(head),
          'state_epoch': state['epoch'], 'state_consumed_items': len(state['consumed_items']),
          'rows_after_restore': len(tail), 'repeated_rows': len(repeated),
          'repeated_rowgroups': sorted(in_flight), 'seconds': resume_s,
          'weighted': {'weights': weights, 'rows': len(order),
                       'share': [order.count(i) / len(order) for i in range(2)],
                       'realized_deviation': deviation, 'bound': 1.0,
                       'rows_per_s': len(order) / mix_s, 'batch_devices': sorted(devices)}})
    assert set(head) | set(tail) == set(range(MNIST_ROWS))
    assert len(head) + len(tail) - MNIST_ROWS == len(repeated)
    assert len(in_flight) <= 1 and len(repeated) <= MNIST_ROWGROUP, (len(repeated), in_flight)
    assert devices == {'cuda:0'}, devices
    assert len(order) >= WEIGHTED_ROWS and deviation <= 1.0, deviation


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


def write_selective_dataset(url, image_codec):
    """vit-selective: ``VIT_ROWS`` rows of the image path's content and
    codec, sorted by label (stable), with an int64 ``id`` in written
    order, in 64-row groups: each row-group then covers one or two labels,
    and its footer's label statistics say which. Returns the labels in
    written order."""
    import numpy as np
    import pyarrow as pa
    from petastorm_tpu_torch.codecs import ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_dataset
    from petastorm_tpu_torch.examples.imagenet import imagenet_like_rows, imagenet_like_schema
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    t0 = time.perf_counter()
    rows = sorted(imagenet_like_rows(VIT_ROWS, 384), key=lambda row: int(row[1]))
    schema = Unischema('SelectiveImagenetLike', list(imagenet_like_schema(384, image_codec)) + [
        UnischemaField('id', np.int64, (), ScalarCodec(pa.int64()), False)])
    write_dataset(url, schema, [{'image': image, 'label': label, 'id': np.int64(i)}
                                for i, (image, label) in enumerate(rows)],
                  rowgroup_size_rows=64)
    labels = [int(label) for _, label in rows]
    emit({'phase': 'write', 'dataset': 'vit_selective_384', 'rows': VIT_ROWS,
          'image_codec': image_codec, 'rowgroup_rows': 64, 'order': 'label',
          'labels': sorted(set(labels)), 'seconds': time.perf_counter() - t0})
    return labels


def footer_prediction(url, selected):
    """Row-groups (and their rows) whose ``label`` min/max in the Parquet
    footers holds none of ``selected``: what a statistics prune must drop,
    worked out here with pyarrow alone."""
    import pyarrow.parquet as pq
    root = url[len('file://'):]
    files = sorted(os.path.join(d, f) for d, _, names in os.walk(root) for f in names
                   if f.endswith('.parquet') and not f.startswith(('_', '.')))
    out = {'rowgroups': 0, 'rowgroups_pruned': 0, 'rows_pruned': 0}
    for path in files:
        meta = pq.ParquetFile(path).metadata
        column = meta.schema.to_arrow_schema().get_field_index('label')
        for rg in range(meta.num_row_groups):
            st = meta.row_group(rg).column(column).statistics
            out['rowgroups'] += 1
            if not any(st.min <= label <= st.max for label in selected):
                out['rowgroups_pruned'] += 1
                out['rows_pruned'] += meta.row_group(rg).num_rows
    return out


def _read_epoch(url, device, keep=False, **kwargs):
    """One epoch through ``make_torch_loader`` (every tail row kept) from
    a fresh registry and planner: ids, rows/s, counters, diagnostics, and
    with ``keep`` host copies of the batches."""
    from petastorm_tpu_torch import pushdown
    from petastorm_tpu_torch.device.loader import make_torch_loader
    from petastorm_tpu_torch.telemetry import get_registry, reset_registry
    reset_registry()
    pushdown.reset_for_tests()
    ids, batches = [], []
    with make_torch_loader(url, VIT_BATCH, fields=['^id$', '^image$', '^label$'],
                           num_epochs=1, last_batch='short', device=device,
                           **kwargs) as loader:
        start = time.perf_counter()
        for batch in loader:
            ids.append(batch['id'].cpu())
            if keep:
                batches.append({k: v.cpu() for k, v in batch.items()})
        if device == 'cuda':
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        diag = loader.diagnostics
        plan = loader.reader._pushdown_plan
    ids = torch.cat(ids).tolist()
    return {'ids': sorted(ids), 'rows': len(ids), 'seconds': elapsed,
            'images_per_s': len(ids) / elapsed,
            'counters': get_registry().snapshot()['counters'], 'diagnostics': diag,
            'summary': pushdown.planner_summary(), 'batches': batches,
            'plan_pruned': None if plan is None else len(plan.pruned),
            'consumer_wait_s': consumer_wait_s()}


def phase_selective_vit_path(url, image_codec, labels, vit_images_per_s):
    """A selective read on the image path: ``make_torch_loader(filters=
    [('label', 'in', <every 4th label>)])`` over the label-ordered dataset.
    The footer-statistics prune drops the row-groups the footers exclude,
    the workers read and test ``label`` first and hand on only the
    survivors' encoded cells, and the staging fill decodes just those into
    the pinned slots. Held: the ids equal a CPU full read filtered in
    numpy; the row-groups pruned equal ``footer_prediction``; images
    decoded and late-materialized rows equal the survivors; the card's
    batches equal the CPU loader's byte for byte (dummy pool); a read with
    ``predicate=in_set(...)`` (the planner, not the filters prune) gives
    the same rows. Then ``SELECTIVE_STEPS`` ViT-Base steps on the subset:
    one normalize launch a step and 12 of each flash kernel."""
    import numpy as np
    from petastorm_tpu_torch import native, pushdown
    from petastorm_tpu_torch.examples.imagenet import VIT_BASE_KW, train_vit_fused
    from petastorm_tpu_torch.predicates import in_set
    from petastorm_tpu_torch.reader import make_batch_reader
    from petastorm_tpu_torch.telemetry import FUSED_ROWS, reset_registry
    distinct = sorted(set(labels))
    selected = tuple(distinct[::SELECTIVE_LABEL_STRIDE])
    filters = [('label', 'in', selected)]
    predicted = footer_prediction(url, selected)
    with make_batch_reader(url, schema_fields=['^id$', '^label$'],
                           reader_pool_type='dummy') as reader:
        columns = [(b.id, b.label) for b in reader]
    all_ids = np.concatenate([c[0] for c in columns])
    all_labels = np.concatenate([c[1] for c in columns])
    want_ids = sorted(all_ids[np.isin(all_labels, selected)].tolist())
    library = {'jpeg': 'jpeg_batch', 'png': 'png_batch', 'npy': 'npy_batch'}[image_codec]
    decoded_key = '%s{library="%s"}' % (native.DECODED_CELLS, library)

    full = _read_epoch(url, 'cuda')
    selective = _read_epoch(url, 'cuda', filters=filters)
    # the same subset priced as a full scan: PETASTORM_TPU_PUSHDOWN=0 reads
    # and decodes every row, then filters
    os.environ['PETASTORM_TPU_PUSHDOWN'] = '0'
    try:
        full_scan = _read_epoch(url, 'cuda', filters=filters)
    finally:
        del os.environ['PETASTORM_TPU_PUSHDOWN']
    by_predicate = _read_epoch(url, 'cuda', predicate=in_set(set(selected), 'label'))
    card = _read_epoch(url, 'cuda', keep=True, filters=filters, reader_pool_type='dummy',
                       shuffle_row_groups=False)
    host = _read_epoch(url, 'cpu', keep=True, filters=filters, reader_pool_type='dummy',
                       shuffle_row_groups=False)
    counters = selective['counters']
    reset_registry()
    reset_launch_counts()
    result = train_vit_fused(url, steps=SELECTIVE_STEPS, batch_size=VIT_BATCH, device='cuda',
                             filters=filters)
    torch.cuda.synchronize()
    launches = launch_counts()
    losses = result['losses']
    emit({'phase': 'selective_vit_path', 'config': 'vit-selective-quarter',
          'entry': "make_torch_loader(filters=[('label', 'in', ...)]) -> normalize -> ViT-Base",
          'image_codec': image_codec, 'labels_selected': list(selected),
          'labels_total': len(distinct), 'rows_total': len(all_ids),
          'survivors': len(want_ids), 'footer_prediction': predicted,
          'rowgroups_pruned': counters.get(pushdown.ROWGROUPS_PRUNED, 0),
          'rows_pruned': counters.get(pushdown.ROWS_PRUNED, 0),
          'late_materialized_rows': counters.get(pushdown.LATE_MATERIALIZED_ROWS, 0),
          'images_decoded': counters.get(decoded_key, 0),
          'fused_decode_rows': counters.get(FUSED_ROWS, 0),
          'read_seconds': selective['seconds'], 'read_images_per_s': selective['images_per_s'],
          'full_scan_read_seconds': full_scan['seconds'],
          'full_scan_images_decoded': full_scan['counters'].get(decoded_key, 0),
          'full_read_seconds': full['seconds'], 'full_read_images_per_s': full['images_per_s'],
          'full_read_images_decoded': full['counters'].get(decoded_key, 0),
          'read_consumer_wait_s': selective['consumer_wait_s'],
          'full_read_consumer_wait_s': full['consumer_wait_s'],
          'fused_decode_mode': selective['diagnostics']['fused_decode_mode'],
          'predicate_read': {'rowgroups_pruned': by_predicate['summary']['rowgroups_pruned'],
                             'planner_runs': by_predicate['summary']['planner_runs'],
                             'images_per_s': by_predicate['images_per_s']},
          'card_vs_cpu_batches': len(card['batches']),
          'train': {'steps': len(losses), 'batch_size': VIT_BATCH, 'losses': losses,
                    'images_per_s': result['images_per_s'],
                    'vit_path_images_per_s': vit_images_per_s,
                    'consumer_wait_s': result['diagnostics']['consumer_wait_s'],
                    'launches': launches}})
    assert selective['ids'] == want_ids, 'the selective read lost or added rows'
    assert by_predicate['ids'] == want_ids == card['ids'] == host['ids'] == full_scan['ids']
    assert full_scan['counters'].get(decoded_key, 0) == VIT_ROWS
    assert full['ids'] == sorted(all_ids.tolist())
    assert 0 < predicted['rowgroups_pruned'] < predicted['rowgroups'], predicted
    assert counters.get(pushdown.ROWGROUPS_PRUNED, 0) == predicted['rowgroups_pruned']
    assert counters.get(pushdown.ROWS_PRUNED, 0) == predicted['rows_pruned']
    assert by_predicate['summary']['rowgroups_pruned'] == predicted['rowgroups_pruned']
    assert by_predicate['plan_pruned'] == predicted['rowgroups_pruned']
    assert counters.get(pushdown.LATE_MATERIALIZED_ROWS, 0) == len(want_ids)
    # images decoded equal survivors, against every row of the full read
    assert counters.get(decoded_key, 0) == len(want_ids), counters
    assert full['counters'].get(decoded_key, 0) == VIT_ROWS
    if image_codec != 'npy':
        assert selective['diagnostics']['fused_decode_mode'] == 'fused-into-slot'
        assert counters.get(FUSED_ROWS, 0) == len(want_ids)
    assert len(card['batches']) == len(host['batches']) > 0
    for a, b in zip(card['batches'], host['batches']):
        assert sorted(a) == sorted(b)
        for name in a:
            assert torch.equal(a[name], b[name]), name
    assert len(losses) == SELECTIVE_STEPS and all(math.isfinite(v) for v in losses), losses
    assert result['batch_devices'] == ['cuda:0'], result['batch_devices']
    assert launches['normalize_images'] == SELECTIVE_STEPS, launches
    want = VIT_BASE_KW['n_layers'] * SELECTIVE_STEPS
    for name in FLASH_KERNELS:
        assert launches[name] == want, (name, launches[name], want)
    return launches


def _flat_grads(params):
    return torch.cat([p.grad.reshape(-1).float() for p in params]).cpu()


def _dp_train(rank, url):
    """One rank's part of ``dp_lm_path``: the loader shards by the live
    group through the mesh, and each step all-reduces the gradients
    (through the host: gloo) before AdamW. On the first step rank 0 also
    runs the one-process step on the global batch that
    ``loader.sharding`` rebuilds, and holds the averaged gradient to it."""
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from torch.profiler import ProfilerActivity, profile
    from petastorm_tpu_torch.device.loader import make_torch_loader
    from petastorm_tpu_torch.examples.lm_pretrain import FLAGSHIP_LM_KW, packing_transform
    from petastorm_tpu_torch.models.transformer import (
        TransformerConfig, adamw, init_transformer, transformer_loss,
    )
    mesh = init_device_mesh('cpu', (DP_RANKS,), mesh_dim_names=('dp',))
    config = TransformerConfig(max_seq_len=LM_SEQ, loss_chunk=256, attn_impl='flash',
                               **FLAGSHIP_LM_KW)
    model = init_transformer(0, config, 'cuda')
    params = list(model.parameters())
    optimizer = adamw(model)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    out = {'rank': rank, 'losses': []}
    reference_launches = {name: 0 for name in FLASH_KERNELS}
    with make_torch_loader(url, LM_BATCH, mesh, ('dp',), fields=['^tokens$'],
                           transform_spec=packing_transform(LM_SEQ + 1), num_epochs=None,
                           shuffle_row_groups=True, device='cuda') as loader:
        out['shard'] = [loader.reader.cur_shard, loader.reader.shard_count]
        out['pieces'] = sorted({item[0] for item in loader.reader.state_dict()['items_global']})
        out['placements'] = [repr(p) for p in loader.sharding[1]]
        batches = iter(loader)
        for i in range(DP_STEPS):
            tokens = next(batches)['tokens']
            if i == 1:
                torch.cuda.synchronize()
                start = time.perf_counter()
            with (profile(activities=[ProfilerActivity.CUDA]) if i == 1
                  else contextlib.nullcontext()) as prof:
                optimizer.zero_grad(set_to_none=True)
                loss = transformer_loss(model, tokens)
                loss.backward()
                torch.cuda.synchronize()
            if i == 1:
                out['flash_kernel_names'] = sorted(
                    {e.name for e in prof.events() if e.device_type == DeviceType.CUDA
                     and _kernel_kind(e.name) in FLASH_KERNELS})
            grads = _flat_grads(params)
            dist.all_reduce(grads)
            grads /= DP_RANKS
            if i == 0:
                local = tokens.cpu()
                full = DTensor.from_local(local, *loader.sharding).full_tensor()
                gathered = [None] * DP_RANKS
                dist.all_gather_object(gathered, local)
                out['global_batch_equal'] = bool(torch.equal(full, torch.cat(gathered)))
                out['global_batch_shape'] = list(full.shape)
                mean_loss = loss.detach().float().reshape(1).cpu().clone()
                dist.all_reduce(mean_loss)
                out['mean_loss'] = float(mean_loss) / DP_RANKS
                if rank == 0:
                    before = launch_counts()
                    optimizer.zero_grad(set_to_none=True)
                    one = transformer_loss(model, full.to('cuda'))
                    one.backward()
                    reference = _flat_grads(params)
                    after = launch_counts()
                    reference_launches = {k: after[k] - before[k] for k in FLASH_KERNELS}
                    out['one_process_loss'] = float(one.detach())
                    out['grad_err_over_max_abs'] = float(
                        (grads - reference).abs().max() / reference.abs().max())
            offset = 0
            for p in params:
                n = p.numel()
                p.grad = grads[offset:offset + n].view_as(p).to(p.device, p.dtype)
                offset += n
            optimizer.step()
            out['losses'].append(float(loss.detach()))
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
    launches = launch_counts()
    out['launches'] = {k: launches[k] - reference_launches.get(k, 0) for k in launches}
    # the replicas stay equal: same initial weights, same averaged updates
    out['param_checksum'] = float(sum(p.detach().double().sum() for p in params))
    out['tokens_per_s'] = (DP_STEPS - 1) * LM_BATCH * LM_SEQ / elapsed
    out['peak_memory_bytes'] = torch.cuda.max_memory_allocated()
    return out


def _dp_rank(rank, port, url, out_dir):
    """A spawned rank of ``dp_lm_path``: joins the gloo group, trains, and
    leaves its result in ``out_dir``."""
    import datetime
    import torch.distributed as dist
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    dist.init_process_group('gloo', init_method='tcp://127.0.0.1:%d' % port, rank=rank,
                            world_size=DP_RANKS,
                            timeout=datetime.timedelta(seconds=DP_TIMEOUT_S))
    try:
        torch.cuda.set_device(0)
        result = _dp_train(rank, url)
        with open(os.path.join(out_dir, 'rank%d.json' % rank), 'w') as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()


def phase_dp_lm_path(url, lm_tokens_per_s):
    """Two data-parallel ranks on the one card: spawned processes in a gloo
    group (NCCL refuses two ranks on one GPU), each building
    ``make_torch_loader(url, 8, mesh=DeviceMesh over ('dp',))`` with no
    shard given, so the shard comes from the group, and training the full
    flagship for ``DP_STEPS`` AdamW steps with gradients averaged over the
    ranks. Held: the ranks' row-groups are disjoint and cover the epoch;
    ``loader.sharding`` rebuilds the global batch (``DTensor.from_local``)
    as the concatenation of the local ones; the first step's averaged
    gradient matches one process's step on that global batch within
    ``DP_GRAD_TOL`` of its max-abs (bf16, as the LM references hold); every
    flash kernel is a ``_wgmma`` one, launched layers x steps times on each
    rank. A rank that dies or outlives ``DP_TIMEOUT_S`` fails the phase."""
    from petastorm_tpu_torch.etl.dataset_metadata import ParquetDatasetInfo, load_row_groups
    from petastorm_tpu_torch.examples.lm_pretrain import FLAGSHIP_LM_KW
    torch.cuda.empty_cache()
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        port = sock.getsockname()[1]
    out_dir = tempfile.mkdtemp()
    ctx = torch.multiprocessing.get_context('spawn')
    procs = [ctx.Process(target=_dp_rank, args=(rank, port, url, out_dir))
             for rank in range(DP_RANKS)]
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + DP_TIMEOUT_S
        while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        assert codes == [0] * DP_RANKS, 'a dp rank failed or timed out: exit codes %s' % codes
        results = []
        for rank in range(DP_RANKS):
            with open(os.path.join(out_dir, 'rank%d.json' % rank)) as f:
                results.append(json.load(f))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    seconds = time.perf_counter() - t0
    n_pieces = len(load_row_groups(ParquetDatasetInfo(url)))
    first = results[0]
    loss_gap = abs(first['mean_loss'] - first['one_process_loss']) / abs(first['one_process_loss'])
    emit({'phase': 'dp_lm_path', 'config': 'lm-c4like-flagship, 2 ranks',
          'entry': "make_torch_loader(url, 8, mesh=DeviceMesh('cpu', ('dp',)), "
                   "data_axes=('dp',)) on a gloo group; gradients all-reduced through the host",
          'model': FLAGSHIP_LM_KW, 'ranks': DP_RANKS, 'steps': DP_STEPS,
          'batch_size_per_rank': LM_BATCH, 'attention_positions': LM_SEQ,
          'shards': [r['shard'] for r in results], 'placements': first['placements'],
          'rowgroups_per_rank': [len(r['pieces']) for r in results], 'rowgroups': n_pieces,
          'global_batch_shape': first['global_batch_shape'],
          'grad_err_over_max_abs': first['grad_err_over_max_abs'],
          'grad_tolerance': 'max|avg - one process| / max|one process| <= %g' % DP_GRAD_TOL,
          'loss_rel_gap': loss_gap, 'loss_tolerance': 'rel <= %g' % DP_LOSS_RTOL,
          'losses': [r['losses'] for r in results],
          'tokens_per_s_per_rank': [r['tokens_per_s'] for r in results],
          'tokens_per_s_timing': 'steps 2-%d, gloo all-reduce of f32 gradients included'
                                 % DP_STEPS,
          'lm_path_tokens_per_s': lm_tokens_per_s,
          'peak_memory_bytes_per_rank': [r['peak_memory_bytes'] for r in results],
          'launches_per_rank': [r['launches'] for r in results],
          'flash_kernel_names': sorted({n for r in results for n in r['flash_kernel_names']}),
          'param_checksums': [r['param_checksum'] for r in results], 'seconds': seconds})
    assert [r['shard'] for r in results] == [[rank, DP_RANKS] for rank in range(DP_RANKS)]
    pieces = [set(r['pieces']) for r in results]
    assert not pieces[0] & pieces[1], 'the ranks share row-groups'
    assert pieces[0] | pieces[1] == set(range(n_pieces)), 'the ranks miss row-groups'
    assert all(r['placements'] == ['Shard(dim=0)'] for r in results)
    assert all(r['global_batch_equal'] for r in results)
    assert len({r['param_checksum'] for r in results}) == 1, 'the replicas diverged'

    assert first['global_batch_shape'] == [DP_RANKS * LM_BATCH, LM_SEQ + 1]
    assert first['grad_err_over_max_abs'] <= DP_GRAD_TOL, first['grad_err_over_max_abs']
    assert loss_gap <= DP_LOSS_RTOL, loss_gap
    for r in results:
        assert len(r['losses']) == DP_STEPS and all(math.isfinite(v) for v in r['losses'])
        want = FLAGSHIP_LM_KW['n_layers'] * DP_STEPS
        for name in FLASH_KERNELS:
            assert r['launches'][name] == want, (r['rank'], name, r['launches'][name], want)
        assert r['flash_kernel_names'] and all('_wgmma' in n for n in r['flash_kernel_names'])
        for kernel in FLASH_KERNELS:
            assert any(_kernel_kind(n) == kernel for n in r['flash_kernel_names']), kernel
    return {name: sum(r['launches'][name] for r in results) for name in FLASH_KERNELS}


def _launches_by_path(name, paths):
    return {path: counts[name] for path, counts in paths.items() if name in counts}


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--trace-dir', default=None,
                        help='keep the traced paths\' Chrome traces here (default: a '
                             'temporary directory, removed at the end)')
    args = parser.parse_args(argv)
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
        trace_dir = args.trace_dir or os.path.join(tmp, 'traces')
        os.makedirs(trace_dir, exist_ok=True)
        url = 'file://' + os.path.join(tmp, 'mnist')
        t0 = time.perf_counter()
        generate_synthetic_mnist(url, num_rows=MNIST_ROWS)
        emit({'phase': 'write', 'rows': MNIST_ROWS, 'seconds': time.perf_counter() - t0})
        phase_reference(url)
        phase_lm_reference()
        phase_lm_reference_bf16()
        main_launches, main_rows_per_s = phase_main_path(url)
        paths['main_path'] = {'normalize_images': main_launches}
        phase_row_reference(url)
        paths['pytorch_path'] = {
            'normalize_images': phase_pytorch_path(url)['normalize_images']}
        paths['batched_bridge_path'] = {
            'normalize_images': phase_batched_bridge_path(url, main_rows_per_s)[
                'normalize_images']}
        paths['obs_drill_path'] = {
            'normalize_images': phase_obs_drill_path(url, tmp)['normalize_images']}
        phase_row_resume(url)
        ngram_url = 'file://' + os.path.join(tmp, 'ngram_timeseries')
        phase_ngram_path(ngram_url, write_ngram_dataset(ngram_url))
        lm_url = 'file://' + os.path.join(tmp, 'c4_like')
        write_lm_dataset(lm_url)
        paths['lm_path'], lm_tokens_per_s = phase_lm_path(lm_url)
        paths['traced_lm_path'] = phase_traced_lm_path(lm_url, lm_tokens_per_s, trace_dir)
        paths['obs_lm_path'] = phase_obs_lm_path(lm_url, tmp)
        phase_lm_profile()
        bridge = phase_bridge_lm(lm_url, lm_tokens_per_s)
        paths['bridge_lm'] = {name: bridge[name] for name in FLASH_KERNELS}
        paths['dp_lm_path'] = phase_dp_lm_path(lm_url, lm_tokens_per_s)
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
        paths['vit_path'], vit_images_per_s = phase_vit_path(vit_url, image_codec)
        paths['traced_vit_path'] = phase_traced_vit_path(vit_url, image_codec, vit_images_per_s,
                                                         trace_dir)
        selective_url = 'file://' + os.path.join(tmp, 'vit_selective')
        labels = write_selective_dataset(selective_url, image_codec)
        paths['selective_vit_path'] = phase_selective_vit_path(selective_url, image_codec,
                                                               labels, vit_images_per_s)
    phase_vit_profile()
    # the headline numbers are this slice's path's: the flash kernels' at
    # the mixture path's shape (the flagship's) and their launches there;
    # normalize's on the ViT path, the last path that runs it; the
    # earlier paths' shapes and launches stand beside them
    vit_case = kernel[VIT_KERNEL_CASE]
    main_case = kernel[MAIN_PATH_CASE]
    pytorch_case = kernel[PYTORCH_KERNEL_CASE]
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
        # the PyTorch example's batches (pytorch_path): (32, 28, 28, 1) -> f32
        PYTORCH_KERNEL_CASE: dict(
            {k: pytorch_case[k] for k in ('shape', 'out_dtype', 'ms', 'wall_ms', 'timer',
                                          'plain_ms', 'bound_ms', 'bound_by', 'max_abs_err')},
            launches=paths['pytorch_path']['normalize_images'], library_ms=None),
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
