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
   ``time_ms``) and the least time the card could take (its bound); and
   an empty launch (``torch.cuda._sleep(0)``) timed the same way, the
   floor below which no launch of the small MNIST shapes can go.
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
18. ``pytorch_path``: the example's ``train`` for three epochs of the
    60,000 MNIST rows (5,625 steps, thread pool), then ``evaluate``:
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
30. ``pipecheck`` (after ``build``): ``python -m petastorm_tpu_torch.analysis``
    over the shipped package, in the checkout beside the kernels' build
    directory: the rule count, the files scanned, the findings (none, or
    the phase fails) and the seconds.
31. ``sanitized_vit_path`` (after ``traced_vit_path``):
    vit-imagenetlike-384 with ``PETASTORM_TPU_SANITIZE=1`` (set through
    ``knobs.set_env``, restored after): read-only epochs through
    ``make_torch_loader(device='cuda')`` on one pool worker in turns,
    unarmed, armed, armed, unarmed, whose batches are equal in order;
    then ``VIT_STEPS`` armed ViT-Base steps, the decoders writing into
    guarded pinned slots: 20 normalize and 240 launches of each flash
    kernel, ``fused-into-slot``, no violation, a canary check for every
    slot refill, no slot quarantined, the report's ``pipesan`` section
    armed and clean; armed images/s beside ``vit_path``'s.
32. ``sanitize_drill``: on the card's ring, armed, one byte written into
    the rear red zone of a pinned slot's image slab while the slot is
    out: the slot's next refill records ``staging-canary-trampled``
    (counted, in the report's ``recent``), the zone is poisoned again and
    the refill after it is clean; and a non-blocking copy from a pinned
    slice keeps no Python reference to the slice.
33. ``decoded_cache_vit_path`` (after ``selective_vit_path``):
    vit-imagenetlike-384 through ``make_torch_loader(cache_type='decoded')``
    on the thread pool in dataset order: an uncached fused epoch, then one
    loader's cold epoch (the workers decode PNG and publish each row-group
    as an Arrow IPC entry) and its replay (entries memory-mapped back,
    the default 256 MB memory tier in play). Both epochs' batch and row
    digests equal the uncached epoch's; the warm epoch is all hits and
    ``cache-bound``; cold, warm and uncached images/s, memory hits, mmap
    reads and bytes written are printed. Then ``VIT_STEPS`` ViT-Base
    steps on batches the warm cache serves: 20 normalize and 240 launches
    of each flash kernel. Last, with ``PETASTORM_TPU_SANITIZE=1`` and a
    memory tier of ``CACHE_ARMED_MEM_MB``, a cold epoch in a fresh
    directory and its replay from memory: the same digests, views
    guarded, no violation.
34. ``chaos_path``: faults armed one at a time through
    ``PETASTORM_TPU_FAULTS``: ENOSPC on every decoded-cache store of a
    cold epoch (the uncached rows, one ``cache_degraded``, one failure
    counted, no entry), a poisoned row-group (``FaultInjected`` naming
    it, threads joined), a failed dispatch after three batches (three
    batches, then ``FaultInjected``; slots released; a fresh loader reads
    the epoch), a faulted footer under the selective read (nothing
    pruned, the 304 survivors); the injector's fires equal the injection
    counter per site.
35. ``readahead_vit_path``: the readahead plane and the staging autotuner
    (both on by default in every path above) on vit-imagenetlike-384.
    Cold uncached epochs on one pool worker in dataset order, the plane
    off, on, on, off (``PETASTORM_TPU_READAHEAD``): batch digests equal in
    order, hits, misses, coalesced reads, bytes, degrades by reason,
    images/s and the read path per epoch; the on epochs hit every
    row-group, with no miss and no degrade. A producer-bound drill: a
    read-only loader for ``READAHEAD_DRILL_EPOCHS`` epochs (at least the
    first, and on until a decision, at most the second) with the
    autotuner's window at ``READAHEAD_TUNE_WINDOW_S`` and the live plane
    armed: at least one decision, named by ``autotune_report()`` and by
    ``/report``'s ``autotune`` entry, and no degrade. Then ``VIT_STEPS``
    ViT-Base steps on a loader with both planes at their defaults: 20
    normalize and 240 launches of each flash kernel, no miss, no degrade,
    the decisions by action. After each loader closes: no readahead
    manager, fetch thread, override or tuner holding one. The ViT phases
    before it (``vit_path``, ``traced_vit_path``, the armed steps of
    ``sanitized_vit_path``, the uncached epoch of
    ``decoded_cache_vit_path``) print their readahead counts too and
    hold no degrade.
36. ``generate_reference`` (after ``reference_bf16``): KV-cache decoding
    and MoE on the card, f32 with TF32 off, against the CPU. Greedy
    tokens of ``tests/test_generate.py``'s tiny config and of a rope +
    GQA variant on the card equal the recompute oracle on the card and
    the CPU's greedy tokens; a small MoE transformer (``n_experts=4``):
    the loss within 1e-4 and the ``blocks.0.moe.w_in`` gradient within
    1e-4 of its max-abs of the CPU's.
37. ``generate_path`` (after ``resume``, on lm-c4like-flagship):
    ``pretrain`` trains the flagship ``GEN_TRAIN_STEPS`` steps with a
    checkpoint directory (each flash kernel 10 times a step); the
    generate example (``examples/generate.py``) restores the checkpoint
    and decodes ``GEN_NEW_TOKENS`` tokens from the EOS prompt, greedy
    (equal to ``greedy_generate`` on the restored model; rows freeze at
    EOS) and sampled (temperature 0.8, top-p 0.9). Then ``bench.py``'s
    decode shape (batch 8, a 128-token prompt from seed 0, 64 and 256 new
    tokens, median of ``DECODE_RUNS`` each): decode tokens/s from the two
    lengths' difference, the prefill's ms, the KV cache's bytes and peak
    memory, for full heads and for ``n_kv_heads = 4`` (the speedup); the
    flash kernels launch 0 times in every decode. A teacher-forced check
    of the bf16 decode: one dense ``transformer_forward`` over the 64-token
    decode gives logits within ``DECODE_TOL`` of the decode's (max-abs
    error over max-abs), and every emitted token is that forward's argmax
    or within the tolerance of it.
38. ``moe_path`` (configuration lm-c4like-moe-flagship): the flagship with
    ``MOE_EXPERTS`` Switch-MoE experts a block (capacity factor 1.25, aux
    weight 0.01, about 0.9B parameters) trained ``MOE_STEPS`` AdamW steps
    on the C4-like rows: each flash kernel 10 times a step, losses finite
    and falling; tokens/s, peak memory and the last step's aux loss.
39. ``modern_path``: the modern example (``examples/modern.py``: rope,
    GQA, swiglu, remat, two accumulated microbatches, f32) on the card on
    512 C4-like documents, then its 8-token greedy decode: losses finite,
    the decode equal to the recompute oracle on the card.
40. ``write_plane_vit_path`` (after ``readahead_vit_path``): the
    vit-imagenetlike-384 rows, in label order with an ``id``, through the
    port's write plane (``petastorm_tpu_torch.write``). Generation 1 (the
    first ``WRITE_GEN1_ROWS`` rows) by ``write_dataset_distributed`` on a
    ``ThreadPool(WRITE_WORKERS)`` in ``WRITE_SHARD_ROWS``-row shards,
    ``sort_by='label'``; an ``AppendFollower`` (``max_staleness_s=
    APPEND_MAX_STALENESS_S``, on its own thread) delivers it, then the rest
    is appended as generation 2 (four parts) and the follower delivers
    exactly those rows, the first within the bound of the commit. A
    ``make_batch_reader(max_staleness_s=)`` epoch opened before
    ``compact_dataset`` reads every row once; the generation rises,
    ``self_check`` is clean, and after ``gc_superseded`` no superseded part
    and no ``.tmp`` file is left. An ``io.write`` fault at ``#manifest``
    fails one more append: the generation stays and the dataset reads every
    row. ``WRITE_PARITY_ROWS`` rows written inline and on the pool give
    the same part and manifest bytes. Then ``VIT_STEPS`` ViT-Base steps on
    the compacted dataset (fused decode, normalize, flash): 20 normalize
    and 240 launches of each flash kernel, finite losses; one epoch's row
    digests equal the written rows'. Rows, generations, parts before and
    after, write/append/compaction seconds, write rows/s and MB/s, the
    follower's lag and images/s are printed.
41. ``etl_tools_vit_path`` (after ``write_plane_vit_path``): the ETL tools
    on the image path. (a) ``build_rowgroup_index`` of a ``label`` and an
    ``id`` ``SingleFieldIndexer`` over the folded write-plane dataset; a
    ``SingleIndexSelector`` of the labels of the first quarter of rows in
    label order keeps the row-groups a numpy scan of each row-group's
    labels predicts (a strict subset); ``make_torch_loader(rowgroup_selector=)``
    reads the union of their ids on the card, batch for batch equal to the
    CPU loader (dummy pool); ``SELECTIVE_STEPS`` ViT-Base steps on the
    subset. (b) A hard-linked copy of vit-selective whose
    ``_common_metadata`` keeps only the original petastorm's two
    ``dataset-toolkit.*`` keys (the port's pickled schema and counts): its
    schema equals the JSON one, its card batches equal the JSON-footer
    dataset's, then ``SELECTIVE_STEPS`` ViT-Base steps on it. Launches
    exact in both runs. (c) ``tests/data/reference_written``, written by
    the original petastorm: its 24 rows read by ``make_reader`` and
    ``make_batch_reader`` equal ``RandomState(42)``'s values, and its
    (24, 16, 32, 3) images go through the normalize kernel against its
    plain version (f32 1e-5, bf16 1 ulp). (d) ``copy_dataset`` of ``id``
    and ``label`` (rows equal the source's); its ``_common_metadata``
    deleted and rebuilt by ``generate_petastorm_metadata`` from the
    projected schema (the copy reads back); ``print_metadata`` of the
    source (row-groups and both indexes). Each step is timed.
42. ``sp_lm_path`` (after ``dp_lm_path``): two spawned ranks in a gloo
    group on the one card, each first pinning the card, over a ``{'data':
    1, 'seq': 2}`` mesh (``make_named_mesh``). ``ring_attention`` and
    ``ulysses_attention`` alone at (4, 2048, 16, 96) bf16, each rank's
    block within ``SP_ATTN_TOL`` of max-abs of ``reference_attention`` on
    the full sequence; then the flagship (``FLAGSHIP_LM_KW``) at batch
    ``SP_BATCH``, ``SP_SEQ`` global positions (rows of ``SP_SEQ + 1``
    tokens packed from the LM documents), ``remat=True``, ``SP_STEPS``
    AdamW steps with ``seq_impl='ring'`` and again with ``'ulysses'``:
    the first step's loss within ``DP_LOSS_RTOL`` and each gradient within
    ``DP_GRAD_TOL`` of its max-abs of one process's dense step on the full
    sequence (same weights and rows), ring and Ulysses within the same of
    each other, and 0 flash launches (with ``seq_axis`` set, ring and
    Ulysses own attention and ``attn_impl`` is ignored, the JAX package's
    rule). Tokens/s, peak memory, collective calls and host-copy seconds
    per rank are printed.
43. ``tp_path`` (after ``etl_tools_vit_path``): two spawned ranks over a
    ``{'data': 1, 'model': 2}`` mesh (``make_mesh(model=2)``), the
    Megatron split of each model. The flagship: ``TP_STEPS`` AdamW steps
    on packed 1025-token rows, both ranks reading the same rows; the
    first step's loss within ``DP_LOSS_RTOL`` and every gradient shard
    within ``DP_GRAD_TOL`` of its max-abs of one process's step with the
    same weights and batch; each flash kernel a ``_wgmma`` one launched
    layers x steps times per rank, every launch at (8, 1024, 8, 96).
    ViT-Base the same way on the PNG rows (a head drawn from a seed, so
    the first step has gradients below it): flash at (16, 1024, 6, 64),
    12 x ``TP_STEPS`` launches of each kernel and ``TP_STEPS`` normalize
    launches per rank. Tokens/s, images/s, peak memory, collective calls
    and host-copy seconds per rank are printed.
44. ``ep_pp_path`` (after ``tp_path``): two spawned ranks on the one card.
    (a) The MoE flagship (``moe_path``'s model: 4 experts, capacity factor
    1.25, aux weight 0.01) over ``{'data': 1, 'expert': 2}``, each rank
    holding 2 experts, ``EP_STEPS`` AdamW steps on packed 1025-token rows
    (both ranks read the same rows): the first step's loss within
    ``EP_LOSS_RTOL`` and its aux within ``EP_AUX_RTOL`` of one process's
    step from the same init (run first, then freed), each rank's expert
    weights' gradients within ``EP_GRAD_TOL`` of max-abs of that step's
    gradient slices, each flash kernel a ``_wgmma`` one launched layers x
    steps times per rank at (8, 1024, 16, 96). (b) The dense flagship over
    ``{'pipe': 2}`` (``init_pipelined_transformer``: 5 layers a stage),
    ``PP_MICROBATCHES`` microbatches, the same steps and rows: the first
    loss within ``EP_LOSS_RTOL`` of one process's, every parameter's
    gradient within ``EP_GRAD_TOL`` of max-abs (the embedding's on both
    stages included), each flash kernel launched (layers / stages) x
    microbatches x steps times per rank at (4, 1024, 16, 96): a stage
    skips the bubble ticks. Tokens/s, peak memory, collective calls
    (``ppermute`` the stage-to-stage sends and receives) and host-copy
    seconds per rank are printed.
45. ``uneven_pipe_path`` (after ``ep_pp_path``): four spawned ranks on
    the one card, a narrow f32 model (``UNEVEN_PIPE_KW``, flash attention)
    on the pipeline layouts whose global microbatches straddle the data
    ranks unevenly, each rank then holding no rows of some microbatch
    (``UNEVEN_PIPE_LAYOUTS``: ``{'data': 2, 'pipe': 2}`` with 3
    microbatches of a 6-row batch, dense and MoE at capacity factor 0.5,
    and ``{'data': 4, 'pipe': 1}`` with 2 of a 4-row batch). Held: one
    forward and backward's loss and every gradient within
    ``UNEVEN_PIPE_TOL`` of one process's mean over the microbatches (each
    through the layered model), and each flash kernel launched once per
    stage layer and microbatch the rank holds rows of, none for an empty
    one.
46. ``tp_decode_path`` (after ``uneven_pipe_path``): two spawned ranks over
    ``{'data': 1, 'model': 2}`` (``make_mesh(model=2)``), each holding its
    shards of the flagship drawn on the card (``_card_model``), decode
    bench.py's shape (``DECODE_BATCH`` rows, a ``DECODE_PROMPT``-token
    prompt, ``TP_DECODE_NEW`` new tokens) greedily, sampled
    (``GEN_TEMPERATURE``, ``GEN_TOP_P``, a generator seeded alike on both),
    and greedily for a GQA-4 variant (2 K/V heads a rank). Held: both
    ranks' tokens equal in all three; the greedy decode's gathered logits
    within ``DECODE_TOL`` of max-abs of one process's dense forward over
    the decoded sequence (unsplit, the same draws), each token its argmax
    or within the tolerance of it; 0 flash launches; each rank's KV cache
    half of one process's; ``2 x n_layers`` all-reduces and one all-gather
    a token. Tokens/s, prefill ms, peak memory, collective calls and
    seconds and host-copy seconds per rank are printed.
47. ``process_vit_path`` (after ``etl_tools_vit_path``): the ViT rows
    through the port's process pool (``reader_pool_type='process'``,
    spawned decode workers, ``PROCESS_WORKERS`` of them). The first
    ``PROCESS_PARITY_BATCHES`` batches on one worker and one epoch on
    four, each read once on the thread pool and once on the process pool
    with seed 0: ``(label, crc32 of the pixels)`` equal batch for batch
    and as multisets. Then ``train_vit_fused(..., reader_pool_type=
    'process', workers_count=PROCESS_WORKERS)``, ``PROCESS_VIT_STEPS``
    steps of ViT-Base: normalize once a step and 12 launches of each flash
    kernel a step, all on bf16 inputs (the ``wgmma`` instances); no worker
    pid among ``nvidia-smi``'s compute apps and no worker with
    ``libcuda.so`` mapped (``/proc/<pid>/maps``, which shows it in this
    process) while it runs; every worker reports
    ``CUDA_VISIBLE_DEVICES=''`` and neither ``jax`` nor
    ``petastorm_tpu`` loaded; ``io`` and ``decode`` seconds (which only
    the workers record) in this process's registry through the markers'
    deltas; ``workers_alive`` at the worker count while running and 0
    after the join, and no pool process left. Then ``PROCESS_WRITE_ROWS``
    ViT rows written on four worker processes and on four threads: parts
    and manifest byte-identical, and the process-pool read of the
    process-written dataset gives back the source rows. Images/s beside
    ``vit_path``'s (a ratio, no gate), the workers' start-up seconds and
    the peak memory are printed.
48. ``remote_store_vit_path`` (after ``process_vit_path``; configuration
    vit-imagenetlike-gs): fsspec's ``gs`` protocol bound to a strict
    in-memory store (``_remote_store_class``: only paths in
    ``REMOTE_BUCKET``, localizing calls refused, each instance's
    ``storage_options``, read opens, seeks and bytes recorded). The ViT
    rows written to ``gs://bucket/vit`` as ``write_vit_dataset`` writes
    them, with ``storage_options=REMOTE_TOKEN``; one epoch read from the
    bucket and one from the local copy, ``(label, crc32)`` equal as
    multisets; then ``train_vit_fused('gs://bucket/vit',
    storage_options=REMOTE_TOKEN)``, ``REMOTE_VIT_STEPS`` steps of
    ViT-Base: normalize once a step and 12 launches of each flash kernel
    a step, all on bf16; every part file opened through the store, seeks
    recorded, every instance built with the token, no path refused,
    readahead hits and no degrade. Then the flagship LM dataset read as
    ``hdfs://smokens/...`` (a ``$HADOOP_HOME`` naming two namenodes,
    ``HDFS_NAMENODES``, stood in for by the local disk: ``nn-a`` dies for
    good after ``HDFS_NN_A_OPENS`` opens) for ``HDFS_LM_STEPS`` flagship
    steps on the dummy pool with one readahead fetch thread, against the
    same steps read from ``file://``: one failover logged, the read ended
    on ``nn-b``, batch checksums and losses equal, each flash kernel
    launched layers x steps times in each. Images/s beside ``vit_path``'s,
    the bytes the store served and the phase seconds are printed.
``--trace-dir DIR`` keeps the two Chrome traces in ``DIR``.

The rank phases (24, 42-46) run one after another on one pool of
``RANK_POOL_SIZE`` spawned ranks (``_RankPool``), each in a new gloo
group on the pool's first ranks, and draw their models on the card with
a seeded card generator (``_card_model``): a split model and its
one-process reference share the draws.

Every phase runs through ``_phase``, and every spawned rank arms the
same timer for each of its tasks: ``faulthandler`` dumps every thread's
stack to stderr each ``PHASE_STACK_DUMP_S`` seconds the phase runs, so a
phase that stops leaves its stacks behind (the dump only reports); each
phase's wall seconds go to stderr as ``phase <name>: <s> s``.

Then the ``kernels`` summary (each kernel's launches on every path), the
``nvidia-smi`` name and power limit, and the ``ok`` line. The script
needs CUDA and the repository beside it.
"""

import collections
import contextlib
import faulthandler
import json
import math
import os
import queue
import re
import shutil
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
    # one rank's share of the flagship and of ViT-Base split over two
    # 'model' ranks (tp_path): half the heads each
    ('tp_causal_bf16', (8, 1024, 8, 96), torch.bfloat16, True, 1.0),
    ('tp_vit_bidir_bf16', (16, 1024, 6, 64), torch.bfloat16, False, 1.0),
    # one pipeline microbatch of the flagship's batch of 8 (ep_pp_path)
    ('pipe_causal_bf16', (4, 1024, 16, 96), torch.bfloat16, True, 1.0),
]
FLASH_MAIN_CASE = 'flagship_causal_bf16'
VIT_FLASH_CASE = 'vit_bidir_bf16'
VARLEN_FLASH_CASE = 'varlen511_causal_bf16'
# the bucketed path's other buckets, listed beside it in the kernels line
VARLEN_TAIL_CASES = ('varlen127_causal_bf16', 'varlen255_causal_bf16', 'varlen63_causal_bf16')
TP_FLASH_CASES = ('tp_causal_bf16', 'tp_vit_bidir_bf16')
PIPE_FLASH_CASE = 'pipe_causal_bf16'
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

# write_plane_vit_path: the ViT rows in label order written as generation
# 1 (its first rows) and appended as generation 2 (the rest) through the
# write plane on a thread pool, in 64-row shards
WRITE_GEN1_ROWS = 768
WRITE_SHARD_ROWS = 64
WRITE_WORKERS = 4
WRITE_PARITY_ROWS = 128
APPEND_MAX_STALENESS_S = 2.0

# etl_tools_vit_path: the rows of tests/data/reference_written (written by
# the original petastorm), and the projected schema the regenerated copy
# footer is located by (set by the phase)
PINNED_ROWS = 24
ETL_COPY_SCHEMA = None

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
# on mnist-synthetic-60k (batch 32, row buffer 256), three epochs
PYTORCH_BATCH = 32
PYTORCH_EPOCHS = 3
PYTORCH_STEPS = PYTORCH_EPOCHS * MNIST_ROWS // PYTORCH_BATCH    # 5625
ROW_REFERENCE_STEPS = 20
ROW_REFERENCE_NORM_ATOL = 1e-6
ROW_REFERENCE_LOSS_RTOL = 1e-5
# the synthetic classes differ only in mean grey level (19 levels apart),
# and after one epoch the recipe's SGD still moves the boundaries between
# neighbouring levels: a correct read then scores anywhere from 0.3 to 1.0
# on the row order the thread pool happens to deliver, in this package and
# in the JAX package's example alike; after three it separates 8-10 of the
# 10 classes. Chance is 0.1
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
# decoded_cache_vit_path: the disk tier's bound, and a memory tier that
# holds the whole decoded set (1,024 x 384 x 384 x 3 bytes = 453 MB)
CACHE_DISK_LIMIT = 2 * 10 ** 9
CACHE_ARMED_MEM_MB = 1024
# chaos_path: a drill that has not ended by then has hung
CHAOS_DEADLINE_S = 120
# readahead_vit_path: the autotuner's window; the producer-bound drill reads
# at least the first count of epochs and goes on, up to the second, until
# the tuner has decided
READAHEAD_TUNE_WINDOW_S = '0.25'
READAHEAD_DRILL_EPOCHS = (3, 12)
PROCESS_WORKERS = 4          # process_vit_path: the decode worker processes
PROCESS_VIT_STEPS = 10
PROCESS_PARITY_BATCHES = 10  # the first 160 rows, thread pool vs process pool
PROCESS_WRITE_ROWS = 256
REMOTE_BUCKET = 'bucket'     # remote_store_vit_path: the fake gs store's one bucket
REMOTE_TOKEN = {'token': 'chip-smoke-credential'}
REMOTE_VIT_STEPS = 10
REMOTE_READ_WORKERS = 4      # the epoch read of gs:// and file:// compared as multisets
HDFS_NAMESERVICE = 'smokens'
HDFS_NAMENODES = ('nn-a:8020', 'nn-b:8020')
HDFS_NN_A_OPENS = 6          # opens nn-a serves before it dies for good
HDFS_LM_STEPS = 5
# dp-lm: two gloo ranks on the one card feed the flagship
# KV-cache decoding and MoE
GEN_REFERENCE_KW = dict(vocab_size=32, d_model=16, n_heads=2, n_layers=2, d_ff=32,
                        max_seq_len=24)                    # tests/test_generate.py's
GEN_REFERENCE_NEW_TOKENS = 8
MOE_REFERENCE_KW = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=256,
                        max_seq_len=128, n_experts=4)
GEN_TRAIN_STEPS = 10
GEN_NEW_TOKENS = 32
GEN_TEMPERATURE, GEN_TOP_P = 0.8, 0.9
DECODE_BATCH, DECODE_PROMPT = 8, 128  # bench.py's _measure_lm_decode shape
DECODE_LENGTHS = (64, 256)
DECODE_RUNS = 3
DECODE_GQA_GROUP = 4
DECODE_KV_BYTES = (503_316_480, 125_829_120)  # K and V, 10 layers, 8 x 1024, bf16: 16 and 4 heads
DECODE_TOL = 3e-2                     # reference_bf16's
MOE_EXPERTS = 4                       # __graft_entry__.py: two experts a shard of a 2-way axis
MOE_STEPS = 20

DP_RANKS = 2
DP_STEPS = 3                 # the first is held against one process; the rest timed
DP_GRAD_TOL = 3e-2           # max|avg - one process| / max|one process|, bf16
DP_LOSS_RTOL = 1e-3
# tensor and sequence parallelism: two ranks on the one card (gloo)
PARALLEL_RANKS = 2
PARALLEL_TIMEOUT_S = 600
# a phase (or a spawned rank) still running after this many seconds dumps
# every thread's stack to stderr, and again each time as long again passes
PHASE_STACK_DUMP_S = 300
TP_STEPS = 3                 # the first is held against one process; the rest timed
SP_STEPS = 2
SP_BATCH = 4
REPLICA_READ_BATCHES = 16    # ViT batches a replica reads per worker count in tp_path
SP_SEQ = 2048                # global attention positions; rows of SP_SEQ + 1 tokens
SP_ATTN_TOL = 2e-2           # max|block - reference| / max|reference|, bf16
EP_STEPS = 3                 # ep_pp_path: the first held against one process; the rest timed
EP_LOSS_RTOL = 1e-4
EP_AUX_RTOL = 1e-3
EP_GRAD_TOL = 1e-2           # max|rank - one process| / max|one process|, bf16
PP_MICROBATCHES = 2
# uneven_pipe_path: (mesh, config changes, microbatches, global rows)
UNEVEN_PIPE_KW = dict(vocab_size=1024, d_model=256, n_heads=4, n_layers=4, d_ff=1024,
                      max_seq_len=128, attn_impl='flash', dtype=torch.float32)
UNEVEN_PIPE_LAYOUTS = {
    'data2-pipe2-m3-b6': ({'data': 2, 'pipe': 2}, {}, 3, 6),
    'data2-pipe2-moe-m3-b6': ({'data': 2, 'pipe': 2},
                              dict(n_experts=4, capacity_factor=0.5), 3, 6),
    'data4-pipe1-m2-b4': ({'data': 4, 'pipe': 1}, {}, 2, 4),
}
UNEVEN_PIPE_RANKS = 4
RANK_POOL_SIZE = UNEVEN_PIPE_RANKS   # the rank phases' spawned processes, started once
UNEVEN_PIPE_TOL = 1e-4       # f32: max|rank - one process| / max|one process|
TP_DECODE_NEW = 32           # tp_decode_path: half bench.py's shorter decode length
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
    # the floor any launch pays: a kernel with no work (torch.cuda._sleep's
    # spin kernel for 0 cycles), timed as the kernel is; the MNIST shapes'
    # bytes bounds sit far below it
    empty_t = time_ms(lambda: torch.cuda._sleep(0))
    empty = {'kernel': 'torch.cuda._sleep(0)', 'ms': empty_t[0], 'wall_ms': empty_t[1],
             'timer': empty_t[2]}
    for r in results.values():
        r['empty_launch_ms'] = empty['ms']
    emit({'phase': 'kernel', 'kernel': 'normalize_images',
          'library_yardstick': 'none: no single PyTorch call computes a fused '
                               'uint8 -> affine -> bf16/f32 normalize',
          'empty_launch': empty, 'cases': results})
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


def flagship_run(url, scope, inside=None, on_step=None, steps=LM_STEPS, **reader_kwargs):
    """One ``lm_path`` run of the flagship (``FLAGSHIP_LM_KW``, batch 8,
    1024 positions, bf16, ``steps`` steps) on one pool worker, so the
    row-groups arrive in ventilation order, inside the context ``scope``
    with fresh telemetry and launch counts. Returns the result, each
    batch's checksum, the launches and the flash kernels' launches by
    input dtype (``flash_attention._launch`` wrapped for the run), and
    whatever ``inside(result)``, called in the scope, adds.
    ``reader_kwargs`` go to the reader."""
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
            result = pretrain(url, batch_size=LM_BATCH, steps=steps, seq_len=LM_SEQ,
                              model_kw=FLAGSHIP_LM_KW, attn_impl='flash', device='cuda',
                              on_step=on_step_sum, **dict(dict(workers_count=1),
                                                          **reader_kwargs))
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
        Transformer, TransformerConfig, adamw, transformer_train_step,
    )
    config = TransformerConfig(max_seq_len=LM_SEQ, loss_chunk=256, attn_impl='flash',
                               **FLAGSHIP_LM_KW)
    model = _card_model(Transformer, config)
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
    """``generate_imagenet_like``, encoded on ``WRITE_WORKERS`` threads."""
    from petastorm_tpu_torch.examples.imagenet import generate_imagenet_like
    t0 = time.perf_counter()
    generate_imagenet_like(url, num_rows=VIT_ROWS, size=384, image_codec=image_codec,
                           rowgroup_size_rows=64, workers_count=WRITE_WORKERS)
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
    readahead_counts = _readahead_section()
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
          'native_decoded_cells': decoded, 'readahead': readahead_counts,
          'consumer_wait_s': diag['consumer_wait_s'],
          'stage_backpressure_s': diag['stage_backpressure_s'],
          'stage_seconds': stage_seconds()})
    assert len(losses) == VIT_STEPS
    assert not readahead_counts['degraded'], readahead_counts
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
        readahead_counts = _readahead_section()
    launches = launch_counts()
    tracks = check_trace_file(trace, events)
    stages = check_report_stages(report, events)
    emit({'phase': 'traced_vit_path', 'model': VIT_BASE_KW, 'steps': VIT_STEPS,
          'batch_size': VIT_BATCH, 'trace_sample': '1/%d' % TRACE_VIT_SAMPLE,
          'images_per_s': {'vit_path': vit_images_per_s, 'traced': result['images_per_s']},
          'traced_over_vit_path': result['images_per_s'] / vit_images_per_s,
          'launches': launches, 'trace_events': len(events), 'trace_tracks': tracks,
          'traced_stages': stages, 'fused_decode_mode': result['diagnostics']['fused_decode_mode'],
          'readahead': readahead_counts, 'report': report_summary(report)})
    print(telemetry.format_pipeline_report(report), flush=True)
    assert all(math.isfinite(v) for v in result['losses']), result['losses']
    assert result['batch_devices'] == ['cuda:0'], result['batch_devices']
    assert launches['normalize_images'] == VIT_STEPS, launches
    want = VIT_BASE_KW['n_layers'] * VIT_STEPS
    for name in FLASH_KERNELS:
        assert launches[name] == want, (name, launches[name], want)
    assert report.get('h2d_overlap_share') is not None, sorted(report)
    assert not readahead_counts['degraded'], readahead_counts
    staged = {'stage_fill', 'h2d_dispatch'} | ({'decode_fused'} if image_codec != 'npy' else set())
    assert staged <= set(report['stages']), sorted(report['stages'])
    return launches


def phase_pipecheck():
    """``python -m petastorm_tpu_torch.analysis`` over the shipped package,
    as a user runs it, in the checkout the kernels were just built in: the
    rule count, the files scanned, the findings (none) and the seconds."""
    from petastorm_tpu_torch.analysis import ALL_RULES, iter_python_files
    from petastorm_tpu_torch.ops import build
    root = os.path.dirname(os.path.abspath(__file__))
    files = list(iter_python_files([os.path.join(root, 'petastorm_tpu_torch')]))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, '-m', 'petastorm_tpu_torch.analysis', '--json',
                           'petastorm_tpu_torch'], cwd=root, capture_output=True, text=True,
                          timeout=300)
    seconds = time.perf_counter() - t0
    findings = [json.loads(line) for line in proc.stdout.splitlines() if line.strip()]
    emit({'phase': 'pipecheck', 'rules': len(ALL_RULES), 'files_scanned': len(files),
          'findings': findings, 'exit_code': proc.returncode, 'seconds': seconds,
          'build_dir': os.path.relpath(build.BUILD_DIR, root),
          'build_dir_present': os.path.isdir(build.BUILD_DIR)})
    assert proc.returncode == 0 and not findings, (proc.returncode, proc.stderr[-4000:])
    assert len(files) > 50, len(files)


def _epoch_digests(url):
    """One read-only epoch of the ViT rows through ``make_torch_loader`` on
    the card, on one pool worker in dataset order: a digest of each batch
    in order, the epoch's images/s and the loader's diagnostics."""
    import hashlib
    from petastorm_tpu_torch.device.loader import make_torch_loader
    digests = []
    with make_torch_loader(url, VIT_BATCH, fields=['^image$', '^label$'], num_epochs=1,
                           last_batch='short', device='cuda', workers_count=1,
                           shuffle_row_groups=False) as loader:
        start = time.perf_counter()
        for batch in loader:
            digest = hashlib.sha256()
            for name in sorted(batch):
                digest.update(name.encode())
                digest.update(batch[name].cpu().numpy().tobytes())
            digests.append(digest.hexdigest())
        elapsed = time.perf_counter() - start
        diag = loader.diagnostics
    return digests, VIT_BATCH * len(digests) / elapsed, diag


def phase_sanitized_vit_path(url, image_codec, vit_images_per_s):
    """vit-imagenetlike-384 with ``PETASTORM_TPU_SANITIZE=1``: read-only
    epochs in turns, unarmed, armed, armed, unarmed (batches equal in
    order, images/s of each), then ``VIT_STEPS`` armed ViT-Base steps,
    whose decoders write into guarded
    pinned slots: launches exact, no violation, a canary check for every
    slot refill, no slot quarantined, and the report's ``pipesan``
    section armed and clean."""
    from petastorm_tpu_torch import sanitizer, telemetry
    from petastorm_tpu_torch.examples.imagenet import VIT_BASE_KW, train_vit_fused
    sanitizer.reset_for_tests()
    fresh_telemetry()
    rates = {'unarmed': [], 'armed': []}
    unarmed, rate, _ = _epoch_digests(url)
    rates['unarmed'].append(rate)
    with knobs_set({'PETASTORM_TPU_SANITIZE': '1'}):
        assert sanitizer.sanitize_enabled()
        armed, rate, armed_diag = _epoch_digests(url)
        rates['armed'].append(rate)
        read_checks = telemetry.get_registry().counter_value(sanitizer.SANITIZER_CANARY_CHECKS)
        again, rate, _ = _epoch_digests(url)
        rates['armed'].append(rate)
        read_violations = sanitizer.violations()
        fresh_telemetry()
        reset_launch_counts()
        result = train_vit_fused(url, steps=VIT_STEPS, batch_size=VIT_BATCH, device='cuda')
        torch.cuda.synchronize()
        launches = launch_counts()
        report = telemetry.pipeline_report()
        registry = telemetry.get_registry()
        checks = registry.counter_value(sanitizer.SANITIZER_CANARY_CHECKS)
        counted = registry.counters_with_prefix(sanitizer.SANITIZER_VIOLATIONS)
        violations = sanitizer.violations()
        readahead_counts = _readahead_section()
    sanitizer.reset_for_tests()
    last, rate, _ = _epoch_digests(url)
    rates['unarmed'].append(rate)
    diag = result['diagnostics']
    emit({'phase': 'sanitized_vit_path', 'model': VIT_BASE_KW, 'image_codec': image_codec,
          'steps': len(result['losses']), 'batch_size': VIT_BATCH,
          'epoch_batches': len(armed),
          'epoch_equal_in_order': armed == unarmed == again == last,
          'epoch_images_per_s_in_turns': rates,
          'epoch_armed_over_unarmed': sum(rates['armed']) / sum(rates['unarmed']),
          'epoch_slot_refills': armed_diag['staging_slot_refills'],
          'epoch_canary_checks': read_checks,
          'epoch_slabs_quarantined': armed_diag['staging_slabs_quarantined'],
          'images_per_s': {'vit_path': vit_images_per_s, 'armed': result['images_per_s']},
          'armed_over_vit_path': result['images_per_s'] / vit_images_per_s,
          'launches': launches, 'fused_decode_mode': diag['fused_decode_mode'],
          'slot_refills': diag['staging_slot_refills'], 'canary_checks': checks,
          'slabs_quarantined': diag['staging_slabs_quarantined'],
          'violations': violations + read_violations, 'pipesan': report.get('pipesan'),
          'readahead': readahead_counts, 'losses': result['losses']})
    print(telemetry.format_pipeline_report(report), flush=True)
    assert armed == unarmed == again == last, 'the epochs differ'
    assert len(armed) == VIT_ROWS // VIT_BATCH, len(armed)
    assert not read_violations and not violations, (read_violations, violations)
    assert not any(counted.values()), counted
    assert not readahead_counts['degraded'], readahead_counts
    assert armed_diag['staging_slabs_quarantined'] == 0, armed_diag
    assert read_checks >= armed_diag['staging_slot_refills'] > 0, (read_checks, armed_diag)
    assert all(math.isfinite(v) for v in result['losses']), result['losses']
    assert result['batch_devices'] == ['cuda:0'], result['batch_devices']
    assert launches['normalize_images'] == VIT_STEPS, launches
    want = VIT_BASE_KW['n_layers'] * VIT_STEPS
    for name in FLASH_KERNELS:
        assert launches[name] == want, (name, launches[name], want)
    if image_codec != 'npy':
        assert diag['fused_decode_mode'] == 'fused-into-slot', diag
        assert armed_diag['fused_decode_mode'] == 'fused-into-slot', armed_diag
    assert diag['staging_slabs_quarantined'] == 0, diag
    assert checks >= diag['staging_slot_refills'] > 0, (checks, diag)
    pipesan = report.get('pipesan')
    assert pipesan is not None and pipesan['enabled'], sorted(report)
    assert pipesan['violations'] == 0 and pipesan['canary_checks'] == checks, pipesan
    return launches


def phase_sanitize_drill():
    """A trample drill on the card's ring, armed: one byte written into
    the rear red zone of a pinned slot's image slab while the slot is out.
    The slot's next refill records ``staging-canary-trampled`` (counted and
    in the report's ``recent``) and poisons the zone again; the refill
    after that is clean, and every staged batch arrives intact. Also: a
    non-blocking copy from a pinned slice keeps no Python reference to the
    slice (else the census would report false escapes)."""
    import weakref
    import numpy as np
    from petastorm_tpu_torch import sanitizer, telemetry
    from petastorm_tpu_torch.device import staging
    pinned = torch.zeros(1 << 20, dtype=torch.uint8, pin_memory=True)
    piece = pinned[:4096]
    ref = weakref.ref(piece)
    copied = piece.to('cuda', non_blocking=True)
    del piece
    copy_keeps_slice = ref() is not None
    torch.cuda.synchronize()
    del copied
    shape = (VIT_BATCH, 384, 384, 3)
    rng = np.random.RandomState(5)
    sanitizer.reset_for_tests()
    with knobs_set({'PETASTORM_TPU_SANITIZE': '1'}):
        engine = staging.StagingEngine(VIT_BATCH, None, 'drop',
                                       staging.CudaTarget(torch.device('cuda')))
        sources, seen = [], []

        def stage_one():
            batch = {'image': rng.randint(0, 256, shape, dtype=np.uint8),
                     'label': rng.randint(0, 1000, VIT_BATCH).astype(np.int64)}
            sources.append(batch)
            out = engine.stage(batch, VIT_BATCH).deliver()
            torch.cuda.current_stream().synchronize()
            for name, value in batch.items():
                assert np.array_equal(out[name].cpu().numpy(), value), name
            seen.append(len(sanitizer.violations()))

        stage_one()                          # slot 0 goes out
        (slots, _), = engine._rings.values()
        slab = slots[0].slabs['image']
        slab[-1] = 0                         # the trample, past the image's last byte
        stage_one()                          # slot 1, first fill
        stage_one()                          # slot 0 refilled: the trample is caught
        repoisoned = int(slab[-1]) == sanitizer.CANARY_BYTE
        report = telemetry.pipeline_report()
        counted = telemetry.get_registry().counter_value(
            sanitizer.SANITIZER_VIOLATIONS, kind='staging-canary-trampled')
        stage_one()                          # slot 1 refilled
        stage_one()                          # slot 0 refilled again: clean
        violations = sanitizer.violations()
        engine.release()
    sanitizer.reset_for_tests()
    pipesan = report.get('pipesan') or {}
    emit({'phase': 'sanitize_drill', 'batch_shape': list(shape), 'batches': len(sources),
          'violations_after_each_stage': seen, 'violations': violations,
          'counted': counted, 'repoisoned': repoisoned, 'pipesan': pipesan,
          'slabs_quarantined': engine.slabs_quarantined,
          'nonblocking_copy_keeps_pinned_slice': copy_keeps_slice})
    assert not copy_keeps_slice, 'a non-blocking copy kept its pinned source slice alive'
    assert seen == [0, 0, 1, 1, 1], seen
    assert [v['kind'] for v in violations] == ['staging-canary-trampled'], violations
    assert counted == 1, counted
    assert repoisoned
    assert pipesan.get('by_kind') == {'staging-canary-trampled': 1}, pipesan
    assert pipesan['recent'][-1]['kind'] == 'staging-canary-trampled', pipesan
    assert engine.slabs_quarantined == 0


def phase_vit_profile():
    """Where a ViT-Base step's device time goes (``profile_steps``): flips,
    cutout and the normalize kernel on one uint8 batch on the card, then
    the train step."""
    from petastorm_tpu_torch.examples.imagenet import VIT_BASE_KW, _prepare
    from petastorm_tpu_torch.models.transformer import adamw
    from petastorm_tpu_torch.models.vit import ViT, ViTConfig, vit_train_step
    config = ViTConfig(attn_impl='flash', **VIT_BASE_KW)
    model = _card_model(ViT, config)
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
        Transformer, TransformerConfig, adamw, transformer_masked_train_step,
    )
    config = TransformerConfig(max_seq_len=VARLEN_BOUNDARIES[-1], loss_chunk=256,
                               attn_impl='flash', **FLAGSHIP_LM_KW)
    model = _card_model(Transformer, config)
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
        Transformer, TransformerConfig, adamw, transformer_train_step,
    )
    config = TransformerConfig(max_seq_len=MIXTURE_ROW - 1, loss_chunk=256, attn_impl='flash',
                               **FLAGSHIP_LM_KW)
    model = _card_model(Transformer, config)
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


def phase_generate_reference():
    """Decoding and MoE on the card (f32, TF32 off) against the CPU. The
    tiny decode config of ``tests/test_generate.py`` and a rope + GQA
    variant: the card's greedy tokens equal the port's recompute oracle on
    the card and the CPU's greedy tokens. A small f32 MoE transformer
    (``n_experts=4``): the loss and the ``blocks.0.moe.w_in`` gradient on
    the card against the CPU, within ``reference``'s tolerances."""
    import numpy as np
    from petastorm_tpu_torch.models.generate import greedy_generate, reference_greedy_generate
    from petastorm_tpu_torch.models.transformer import (
        TransformerConfig, init_transformer, transformer_loss,
    )
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    decode = {}
    for label, kw in (('learned', {}), ('rope_gqa', dict(n_heads=4, n_kv_heads=2,
                                                         pos_encoding='rope'))):
        config = TransformerConfig(**dict(GEN_REFERENCE_KW, **kw), dtype=torch.float32)
        prompt = torch.from_numpy(np.random.RandomState(0).randint(
            0, config.vocab_size, (3, 5)).astype(np.int32))
        out = {}
        for device in ('cpu', 'cuda'):
            model = init_transformer(0, config, device)
            out[device] = greedy_generate(model, prompt, GEN_REFERENCE_NEW_TOKENS).cpu()
        oracle = reference_greedy_generate(model, prompt, GEN_REFERENCE_NEW_TOKENS).cpu()
        decode[label] = {'card': out['cuda'].tolist(), 'equals_oracle': torch.equal(
            out['cuda'], oracle), 'equals_cpu': torch.equal(out['cuda'], out['cpu'])}
    config = TransformerConfig(**MOE_REFERENCE_KW, dtype=torch.float32)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, config.vocab_size, (2, config.max_seq_len + 1)).astype(np.int32))
    moe = {}
    for device in ('cpu', 'cuda'):
        model = init_transformer(0, config, device)
        loss = transformer_loss(model, tokens.to(device))
        loss.backward()
        moe[device] = (loss.item(), model.blocks[0].moe.w_in.grad.cpu())
    (want, want_grad), (got, got_grad) = moe['cpu'], moe['cuda']
    grad_err = float((got_grad - want_grad).abs().max() / want_grad.abs().max())
    emit({'phase': 'generate_reference', 'decode_config': GEN_REFERENCE_KW, 'decode': decode,
          'moe_config': MOE_REFERENCE_KW, 'moe_loss': {'cpu': want, 'card': got},
          'moe_loss_abs_err': abs(got - want), 'moe_grad': 'blocks.0.moe.w_in',
          'moe_grad_err_over_max_abs': grad_err,
          'tolerance': 'tokens equal; loss atol 1e-4; max-abs grad err / max|grad| <= 1e-4 '
                       '(f32, TF32 off)'})
    for label, r in decode.items():
        assert r['equals_oracle'] and r['equals_cpu'], (label, r)
    assert math.isfinite(got) and abs(got - want) <= 1e-4, (got, want)
    assert grad_err <= 1e-4, grad_err


def _timed_decode(model, prompt, new_tokens):
    """Median host seconds of ``DECODE_RUNS`` greedy decodes of
    ``new_tokens`` (one untimed decode first), each to its last token on
    the card."""
    from petastorm_tpu_torch.models.generate import greedy_generate
    greedy_generate(model, prompt, new_tokens)
    torch.cuda.synchronize()
    samples = []
    for _ in range(DECODE_RUNS):
        t0 = time.perf_counter()
        greedy_generate(model, prompt, new_tokens)
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
    return statistics.median(samples), samples


def _decode_rate(model, prompt):
    """bench.py's decode rate: batch x (256 - 64) new tokens over the
    difference of the two lengths' median seconds, which cancels the
    prefill; the prefill's own median (a one-token decode) beside it."""
    short, long_ = DECODE_LENGTHS
    t_short, short_runs = _timed_decode(model, prompt, short)
    t_long, long_runs = _timed_decode(model, prompt, long_)
    t_prefill, _ = _timed_decode(model, prompt, 1)
    c = model.config
    kv_bytes = (2 * c.n_layers * prompt.shape[0] * c.max_seq_len * c.kv_heads
                * (c.d_model // c.n_heads) * torch.finfo(c.dtype).bits // 8)
    return {'tokens_per_s': prompt.shape[0] * (long_ - short) / (t_long - t_short),
            'seconds': {short: short_runs, long_: long_runs}, 'prefill_ms': t_prefill * 1e3,
            'kv_cache_bytes': kv_bytes}


def phase_generate_path(url, tmp):
    """The flagship trained ``GEN_TRAIN_STEPS`` steps with a checkpoint
    directory (each flash kernel 10 times a step), then the generate
    example: the checkpoint restored, 32 tokens decoded from the EOS
    prompt, greedy and sampled. Then bench.py's decode shape on the
    restored model (batch 8, a 128-token prompt, 64 and 256 new tokens)
    and on a GQA-4 flagship, the flash kernels launched 0 times in the
    decodes; and a teacher-forced check of the bf16 decode: one dense
    ``transformer_forward`` over the decoded sequence gives logits within
    ``DECODE_TOL`` of the decode's at every generated position, and each
    emitted token is its argmax or within the tolerance of it."""
    import dataclasses

    import numpy as np
    from petastorm_tpu_torch.checkpoint import TrainCheckpointer
    from petastorm_tpu_torch.examples.generate import generate_from_checkpoint
    from petastorm_tpu_torch.examples.lm_pretrain import (
        EOS, FLAGSHIP_LM_KW, lm_config, pretrain,
    )
    from petastorm_tpu_torch.models import generate
    from petastorm_tpu_torch.models.transformer import (
        Transformer, init_transformer, transformer_forward,
    )
    ckpt_dir = os.path.join(tmp, 'generate_ckpt')
    reset_launch_counts()
    result = pretrain(url, batch_size=LM_BATCH, steps=GEN_TRAIN_STEPS, seq_len=LM_SEQ,
                      model_kw=FLAGSHIP_LM_KW, attn_impl='flash', device='cuda',
                      checkpoint_dir=ckpt_dir, checkpoint_every=GEN_TRAIN_STEPS)
    torch.cuda.synchronize()
    train_launches = launch_counts()
    losses = result['losses']

    reset_launch_counts()
    t0 = time.perf_counter()
    greedy = generate_from_checkpoint(ckpt_dir, max_new_tokens=GEN_NEW_TOKENS, seq_len=LM_SEQ,
                                      device='cuda')
    greedy_s = time.perf_counter() - t0
    sampled = generate_from_checkpoint(ckpt_dir, max_new_tokens=GEN_NEW_TOKENS, seq_len=LM_SEQ,
                                       temperature=GEN_TEMPERATURE, top_p=GEN_TOP_P,
                                       device='cuda')
    torch.cuda.synchronize()
    example_launches = launch_counts()

    model = Transformer(lm_config(LM_SEQ)).to('cuda')
    TrainCheckpointer(ckpt_dir).restore_state({'model': model})
    shutil.rmtree(ckpt_dir)
    eos_prompt = torch.full((2, 1), EOS, dtype=torch.int32)
    same_greedy = np.array_equal(generate.greedy_generate(
        model, eos_prompt, GEN_NEW_TOKENS, eos_token=EOS).cpu().numpy(), greedy)
    prompt = torch.from_numpy(np.random.RandomState(0).randint(
        0, FLAGSHIP_LM_KW['vocab_size'], (DECODE_BATCH, DECODE_PROMPT)).astype(np.int32))
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    full = _decode_rate(model, prompt)
    decode_launches = launch_counts()
    full['peak_memory_bytes'] = torch.cuda.max_memory_allocated()

    # teacher-forced: the decode's logits against one dense forward
    short = DECODE_LENGTHS[0]
    logits = []
    decoded = generate._generate(model, prompt, short, None, on_logits=logits.append)
    model.config = dataclasses.replace(model.config, attn_impl='dense')
    with torch.no_grad():
        decode_logits = torch.stack(logits, dim=1)                      # (B, N, V)
        forward = transformer_forward(model, decoded[:, :-1])[:, DECODE_PROMPT - 1:]
        scale = forward.abs().max()
        logits_err = float((decode_logits - forward).abs().max() / scale)
        emitted = decoded[:, DECODE_PROMPT:].long()
        gap = forward.max(dim=-1).values - forward.gather(-1, emitted[..., None])[..., 0]
        argmax_equal = int((forward.argmax(dim=-1) == emitted).sum())
        near_ties = int(((gap > 0) & (gap <= DECODE_TOL * scale)).sum())
        outside = int((gap > DECODE_TOL * scale).sum())
    del model, forward, decode_logits, logits
    torch.cuda.empty_cache()

    gqa_config = dataclasses.replace(lm_config(LM_SEQ),
                                     n_kv_heads=FLAGSHIP_LM_KW['n_heads'] // DECODE_GQA_GROUP)
    gqa_model = init_transformer(0, gqa_config, 'cuda')
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    gqa = _decode_rate(gqa_model, prompt)
    gqa_launches = launch_counts()
    gqa['peak_memory_bytes'] = torch.cuda.max_memory_allocated()
    del gqa_model
    torch.cuda.empty_cache()
    emit({'phase': 'generate_path', 'config': 'lm-c4like-flagship', 'model': FLAGSHIP_LM_KW,
          'train_steps': len(losses), 'losses': losses, 'train_launches': train_launches,
          'checkpoint_save': result['saves'],
          'example': {'greedy': greedy.tolist(), 'sampled': sampled.tolist(),
                      'sampling': {'temperature': GEN_TEMPERATURE, 'top_p': GEN_TOP_P},
                      'greedy_s_with_restore': greedy_s, 'launches': example_launches,
                      'greedy_equals_restored_decode': same_greedy},
          'decode_shape': {'batch': DECODE_BATCH, 'prompt': DECODE_PROMPT,
                           'new_tokens': DECODE_LENGTHS, 'runs': DECODE_RUNS,
                           'rate': 'batch x (256 - 64) / (median t256 - median t64)'},
          'decode': full, 'decode_launches': decode_launches,
          'gqa': dict(gqa, kv_group=DECODE_GQA_GROUP, n_kv_heads=gqa_config.n_kv_heads,
                      launches=gqa_launches),
          'gqa_speedup': gqa['tokens_per_s'] / full['tokens_per_s'],
          'teacher_forced': {'new_tokens': short, 'logits_err_over_max_abs': logits_err,
                             'tolerance': 'max|a - b| / max|b| <= %g; a token off the '
                                          'argmax only within it' % DECODE_TOL,
                             'argmax_equal': argmax_equal, 'near_ties': near_ties,
                             'outside_tolerance': outside, 'tokens': emitted.numel()}})
    assert len(losses) == GEN_TRAIN_STEPS and all(math.isfinite(v) for v in losses), losses
    want = FLAGSHIP_LM_KW['n_layers'] * GEN_TRAIN_STEPS
    for name in FLASH_KERNELS:
        assert train_launches[name] == want, (name, train_launches[name], want)
        for launches in (example_launches, decode_launches, gqa_launches):
            assert launches[name] == 0, (name, launches)
    for out in (greedy, sampled):
        assert out.shape == (2, 1 + GEN_NEW_TOKENS), out.shape
        assert ((out >= 0) & (out < FLAGSHIP_LM_KW['vocab_size'])).all()
    for row in greedy[:, 1:]:
        if (row == EOS).any():
            assert (row[int(np.argmax(row == EOS)):] == EOS).all(), row
    assert same_greedy
    assert full['kv_cache_bytes'] == DECODE_KV_BYTES[0], full['kv_cache_bytes']
    assert gqa['kv_cache_bytes'] == DECODE_KV_BYTES[1], gqa['kv_cache_bytes']
    for rate in (full, gqa):
        assert rate['tokens_per_s'] > 0 and math.isfinite(rate['tokens_per_s']), rate
    assert logits_err <= DECODE_TOL, logits_err
    assert outside == 0, outside
    return train_launches, decode_launches


def phase_moe_path(url):
    """lm-c4like-moe-flagship: the flagship with ``n_experts=4`` Switch-MoE
    blocks (capacity factor 1.25, aux weight 0.01) trained ``MOE_STEPS``
    AdamW steps on the C4-like rows through ``pretrain``: each flash
    kernel 10 times a step, losses finite and falling; tokens/s, peak
    memory and the last step's summed aux loss (read from the loss's
    forward)."""
    from petastorm_tpu_torch.examples.lm_pretrain import FLAGSHIP_LM_KW, lm_config, pretrain
    from petastorm_tpu_torch.models import transformer
    from petastorm_tpu_torch.models.moe import expert_capacity
    model_kw = dict(FLAGSHIP_LM_KW, n_experts=MOE_EXPERTS)
    config = lm_config(LM_SEQ, model_kw)
    features = transformer._features_with_aux
    aux = []

    def recording_features(model, tokens):
        x, total = features(model, tokens)
        aux[:] = [total.detach()]
        return x, total

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    transformer._features_with_aux = recording_features
    try:
        result = pretrain(url, batch_size=LM_BATCH, steps=MOE_STEPS, seq_len=LM_SEQ,
                          model_kw=model_kw, attn_impl='flash', device='cuda')
        torch.cuda.synchronize()
    finally:
        transformer._features_with_aux = features
    launches = launch_counts()
    losses = result['losses']
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    with torch.device('meta'):
        params = sum(p.numel() for p in transformer.Transformer(config).parameters())
    emit({'phase': 'moe_path', 'config': 'lm-c4like-moe-flagship', 'model': model_kw,
          'capacity_factor': config.capacity_factor, 'moe_aux_weight': config.moe_aux_weight,
          'expert_capacity': expert_capacity(LM_BATCH * LM_SEQ, MOE_EXPERTS,
                                             config.capacity_factor),
          'parameters': params, 'steps': len(losses), 'batch_size': LM_BATCH,
          'attention_positions': LM_SEQ, 'launches': launches, 'losses': losses,
          'loss_first5_mean': first, 'loss_last5_mean': last, 'last_step_aux': float(aux[0]),
          'tokens_per_s': result['tokens_per_s'], 'steps_per_s': result['steps_per_s'],
          'peak_memory_bytes': torch.cuda.max_memory_allocated(),
          'batch_devices': result['batch_devices']})
    assert len(losses) == MOE_STEPS
    assert all(math.isfinite(v) for v in losses), losses
    assert last < first, (first, last)
    assert result['batch_devices'] == ['cuda:0'], result['batch_devices']
    want = FLAGSHIP_LM_KW['n_layers'] * MOE_STEPS
    for name in FLASH_KERNELS:
        assert launches[name] == want, (name, launches[name], want)
    return launches


def phase_modern_path(tmp):
    """The modern example (rope, GQA 4/2, swiglu, remat, two accumulated
    microbatches, f32) on the card at its own config over a small C4-like
    dataset, then its greedy decode of 8 tokens: losses finite, and the
    decode equals the port's recompute oracle on the card exactly (f32,
    TF32 off)."""
    import numpy as np
    from petastorm_tpu_torch.examples.lm_pretrain import generate_c4_like
    from petastorm_tpu_torch.examples.modern import modern_pretrain
    from petastorm_tpu_torch.models.generate import reference_greedy_generate
    url = generate_c4_like('file://' + os.path.join(tmp, 'c4_modern'))
    losses = []
    reset_launch_counts()
    t0 = time.perf_counter()
    loss, decoded, model = modern_pretrain(
        url, device='cuda', return_model=True,
        on_step=lambda step, batch, loss: losses.append(loss))
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    losses = [float(v) for v in losses]
    prompt = torch.from_numpy(np.asarray(decoded[:, :8]))
    oracle = reference_greedy_generate(model, prompt, decoded.shape[1] - 8).cpu().numpy()
    emit({'phase': 'modern_path', 'config': {k: str(v) for k, v in
                                             vars(model.config).items()},
          'steps': len(losses), 'losses': losses, 'final_loss': loss,
          'decoded': decoded.tolist(), 'equals_oracle': bool(np.array_equal(decoded, oracle)),
          'seconds': seconds, 'launches': launches,
          'device': str(model.embed.device)})
    assert losses and all(math.isfinite(v) for v in losses), losses
    assert model.embed.device.type == 'cuda'
    assert np.array_equal(decoded, oracle), (decoded, oracle)
    return launches


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
    """The PyTorch example as a user runs it: ``train`` for
    ``PYTORCH_EPOCHS`` epochs of mnist-synthetic-60k (``make_reader`` on
    the thread pool, the row ``DataLoader`` onto the card, the normalize
    kernel, SGD), then ``evaluate``."""
    from petastorm_tpu_torch import telemetry
    from petastorm_tpu_torch.examples import mnist_pytorch
    fresh_telemetry()
    torch.cuda.reset_peak_memory_stats()
    torch.manual_seed(0)
    reset_launch_counts()
    result = mnist_pytorch.train(url, device='cuda', epochs=PYTORCH_EPOCHS, seed=0,
                                 log_interval=500)
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
          'epochs': PYTORCH_EPOCHS, 'steps': len(losses), 'batch_size': PYTORCH_BATCH,
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
                  rowgroup_size_rows=64, workers_count=WRITE_WORKERS)
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


def _digest_pass(batches):
    """Sorted sha256 digests of a pass's batches and sha1 digests of its
    rows (image bytes, then label): each batch is a quarter of one 64-row
    group, so both multisets are the same for any completion order."""
    import hashlib
    batch_digests, row_digests = [], []
    for batch in batches:
        images = batch['image'].cpu().numpy()
        labels = batch['label'].cpu().numpy()
        digest = hashlib.sha256(images.tobytes())
        digest.update(labels.tobytes())
        batch_digests.append(digest.hexdigest())
        for image, label in zip(images, labels):
            row = hashlib.sha1(image.tobytes())
            row.update(label.tobytes())
            row_digests.append(row.hexdigest())
    return sorted(batch_digests), sorted(row_digests)


def _loader_passes(url, passes, **kwargs):
    """``passes`` epochs of the ViT rows through one ``make_torch_loader``
    on the card (the pool's default workers, row-groups in dataset order,
    every tail row kept); each pass after the first is a replay of the
    same reader, so a cache's memory tier carries over. Per pass: images/s
    with the card's batches held (no digest work in the timing), the
    digests (``_digest_pass``), the pass's ``decoded_cache`` section and
    stage seconds (``pipeline_report(baseline=)``) and the diagnostics."""
    from petastorm_tpu_torch import telemetry
    from petastorm_tpu_torch.device.loader import make_torch_loader
    out = []
    with make_torch_loader(url, VIT_BATCH, fields=['^image$', '^label$'], num_epochs=1,
                           last_batch='short', device='cuda', shuffle_row_groups=False,
                           **kwargs) as loader:
        for _ in range(passes):
            mid = telemetry.get_registry().snapshot()
            held = []
            start = time.perf_counter()
            for batch in loader:
                held.append(batch)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - start
            report = telemetry.pipeline_report(baseline=mid)
            batch_digests, row_digests = _digest_pass(held)
            del held
            out.append({'images_per_s': len(row_digests) / elapsed, 'seconds': elapsed,
                        'batch_digests': batch_digests, 'row_digests': row_digests,
                        'decoded_cache': report.get('decoded_cache'),
                        'stage_seconds': {name: round(info['seconds'], 6)
                                          for name, info in report['stages'].items()},
                        'fused_decode_mode': loader.diagnostics['fused_decode_mode']})
    return out


def _entry_bytes(path):
    """(count, bytes) of the decoded cache's published ``.arrow`` entries."""
    sizes = [os.path.getsize(os.path.join(d, f)) for d, _, names in os.walk(path)
             for f in names if f.endswith('.arrow')]
    return len(sizes), sum(sizes)


def phase_decoded_cache_vit_path(url, image_codec, vit_images_per_s, tmp):
    """vit-imagenetlike-384 through the decoded cache
    (``cache_type='decoded'``, ``CACHE_DISK_LIMIT``): an uncached fused
    epoch, then one loader's cold epoch (workers decode and publish Arrow
    IPC entries) and its replay (entries mapped back, the default 256 MB
    memory tier in play); both hold the uncached epoch's batch and row
    digests, the warm one all hits and ``cache-bound``. Then ``VIT_STEPS``
    ViT-Base steps on batches the warm cache serves (no miss): 20
    normalize and 240 launches of each flash kernel. Last, armed
    (``PETASTORM_TPU_SANITIZE=1``, a memory tier of
    ``CACHE_ARMED_MEM_MB`` that holds the set) in a fresh directory: the
    fill guards what the memory tier shares, the replay is served from
    memory, no violation."""
    from petastorm_tpu_torch import sanitizer, telemetry
    from petastorm_tpu_torch.examples.imagenet import VIT_BASE_KW, train_vit_fused
    rowgroups = VIT_ROWS // 64
    warm_dir = os.path.join(tmp, 'decoded_cache')
    cache = dict(cache_type='decoded', cache_location=warm_dir,
                 cache_size_limit=CACHE_DISK_LIMIT)
    fresh_telemetry()
    uncached, = _loader_passes(url, 1)
    uncached_readahead = _readahead_section()
    fresh_telemetry()
    cold, warm = _loader_passes(url, 2, **cache)
    entries, entry_bytes = _entry_bytes(warm_dir)
    fresh_telemetry()
    reset_launch_counts()
    result = train_vit_fused(url, steps=VIT_STEPS, batch_size=VIT_BATCH, device='cuda',
                             **cache)
    torch.cuda.synchronize()
    launches = launch_counts()
    train_cache = telemetry.decoded_cache_section()
    armed_dir = os.path.join(tmp, 'decoded_cache_armed')
    sanitizer.reset_for_tests()
    with knobs_set({'PETASTORM_TPU_SANITIZE': '1',
                    'PETASTORM_TPU_DECODED_CACHE_MEM_MB': str(CACHE_ARMED_MEM_MB)}):
        armed_fill, armed_memory = _loader_passes(
            url, 2, cache_type='decoded', cache_location=armed_dir,
            cache_size_limit=CACHE_DISK_LIMIT)
        registry = telemetry.get_registry()
        guarded = registry.counter_value(sanitizer.SANITIZER_VIEWS_GUARDED)
        counted = registry.counters_with_prefix(sanitizer.SANITIZER_VIOLATIONS)
        violations = sanitizer.violations()
    sanitizer.reset_for_tests()
    shutil.rmtree(armed_dir, ignore_errors=True)
    losses = result['losses']

    def summary(p):
        return {k: p[k] for k in ('images_per_s', 'seconds', 'decoded_cache', 'stage_seconds',
                                  'fused_decode_mode')}

    emit({'phase': 'decoded_cache_vit_path', 'config': 'vit-imagenetlike-384',
          'entry': "make_torch_loader(cache_type='decoded') -> normalize -> ViT-Base",
          'image_codec': image_codec, 'rows': VIT_ROWS, 'rowgroups': rowgroups,
          'uncached': summary(uncached) | {'readahead': uncached_readahead},
          'cold': summary(cold), 'warm': summary(warm),
          'warm_over_cold': warm['images_per_s'] / cold['images_per_s'],
          'warm_over_uncached': warm['images_per_s'] / uncached['images_per_s'],
          'warm_hit_share': warm['decoded_cache']['hit_rate'],
          'warm_verdict': warm['decoded_cache']['verdict'],
          'warm_mem_hits': warm['decoded_cache']['mem_hits'],
          'warm_mmap_reads': warm['decoded_cache']['mmap_reads'],
          'cold_bytes_written': cold['decoded_cache']['bytes_written'],
          'entries': entries, 'entry_bytes': entry_bytes,
          'equal_to_uncached': {'cold': cold['batch_digests'] == uncached['batch_digests'],
                                'warm': warm['batch_digests'] == uncached['batch_digests']},
          'train': {'steps': len(losses), 'batch_size': VIT_BATCH, 'losses': losses,
                    'images_per_s': result['images_per_s'],
                    'vit_path_images_per_s': vit_images_per_s,
                    'decoded_cache': train_cache, 'launches': launches,
                    'consumer_wait_s': result['diagnostics']['consumer_wait_s']},
          'armed': {'fill': summary(armed_fill), 'memory': summary(armed_memory),
                    'views_guarded': guarded, 'violations': violations,
                    'mem_limit_mb': CACHE_ARMED_MEM_MB}})
    for p in (uncached, cold, warm, armed_fill, armed_memory):
        assert len(p['row_digests']) == VIT_ROWS, len(p['row_digests'])
    assert not uncached_readahead['degraded'], uncached_readahead
    for p in (cold, warm, armed_fill, armed_memory):
        assert p['batch_digests'] == uncached['batch_digests'], 'a cached epoch differs'
        assert p['row_digests'] == uncached['row_digests'], 'a cached epoch differs'
    assert cold['decoded_cache']['misses'] == rowgroups, cold['decoded_cache']
    assert cold['decoded_cache']['bytes_written'] == entry_bytes > 0
    assert entries == rowgroups, entries
    section = warm['decoded_cache']
    assert section['hits'] == rowgroups and section['hit_rate'] == 1.0, section
    assert section['verdict'] == 'cache-bound', section
    assert section['mem_hits'] + section['mmap_reads'] // 2 == rowgroups, section
    assert cold['fused_decode_mode'] == warm['fused_decode_mode'] == 'batched'
    assert train_cache is not None and train_cache['misses'] == 0 and train_cache['hits'] > 0
    assert len(losses) == VIT_STEPS and all(math.isfinite(v) for v in losses), losses
    assert result['batch_devices'] == ['cuda:0'], result['batch_devices']
    assert launches['normalize_images'] == VIT_STEPS, launches
    want = VIT_BASE_KW['n_layers'] * VIT_STEPS
    for name in FLASH_KERNELS:
        assert launches[name] == want, (name, launches[name], want)
    assert not violations and not any(counted.values()), (violations, counted)
    assert guarded > 0, guarded
    assert armed_memory['decoded_cache']['mem_hits'] == rowgroups, armed_memory['decoded_cache']
    return {'launches': launches, 'uncached': uncached}


def _port_threads():
    return {t.name for t in threading.enumerate()
            if t.name.startswith('petastorm-tpu-torch-')}


def _threads_left(before, deadline_s=10.0):
    """The port threads started since ``before`` still alive after up to
    ``deadline_s``."""
    end = time.monotonic() + deadline_s
    while _port_threads() - before and time.monotonic() < end:
        time.sleep(0.01)
    return sorted(_port_threads() - before)


def _injections():
    """Per site: the armed plan's fires and the injection counter."""
    from petastorm_tpu_torch import faults, telemetry
    stats = faults.injection_stats()
    return {site: {'fired': s['fired'], 'hits': s['hits'],
                   'counted': telemetry.get_registry().counter_value(faults.FAULTS_INJECTED,
                                                                     site=site)}
            for site, s in stats.items()}


def _consume(loader, deadline_s):
    """Batches the consumer received and the exception that ended the
    pass (None at a clean end), within ``deadline_s``."""
    got, error = 0, None
    start = time.monotonic()
    try:
        with loader:
            for _ in loader:
                got += 1
                assert time.monotonic() - start < deadline_s, 'the drill hung'
    except Exception as e:  # noqa: BLE001 - the drill's outcome, checked by the caller
        error = e
    return got, error, time.monotonic() - start


def phase_chaos_path(url, selective_url, labels, uncached, tmp):
    """Faults armed one at a time through ``PETASTORM_TPU_FAULTS`` (set
    with ``knobs_set``, restored and disarmed after) on the card's paths:
    a full cache disk under a cold cached epoch (decode-through, one
    ``cache_degraded``, one failure counted, nothing published, the
    uncached epoch's rows); a poisoned row-group (``FaultInjected`` naming
    ``#rg3`` within ``CHAOS_DEADLINE_S``, the pool's and stager's threads
    joined); a failed host-to-device dispatch after three batches (the
    consumer gets exactly three, then ``FaultInjected``; the stager ends
    and its pinned slots are released; a fresh loader reads the whole
    epoch); a faulted footer read under the selective read (nothing
    pruned, the same survivors). In each, the injector's fires equal the
    injection counter per site."""
    from petastorm_tpu_torch import faults, telemetry
    from petastorm_tpu_torch import materialized_cache as mc
    from petastorm_tpu_torch import pushdown
    from petastorm_tpu_torch.device.loader import make_torch_loader
    before = _port_threads()
    drills = {}

    def armed(spec):
        return knobs_set({'PETASTORM_TPU_FAULTS': spec})

    full_dir = os.path.join(tmp, 'decoded_cache_full')
    with armed('cache.write:oserror:1:errno=28'):
        assert faults.ARMED is not None
        since = time.time()
        full, = _loader_passes(url, 1, cache_type='decoded', cache_location=full_dir,
                               cache_size_limit=CACHE_DISK_LIMIT)
        events = [e for e in telemetry.recent_anomalies()
                  if e['kind'] == 'cache_degraded' and e['ts'] >= since]
        failures = telemetry.get_registry().counters_with_prefix(mc.DECODED_CACHE_DISK_FAILURES)
        drills['disk_full'] = {'images_per_s': full['images_per_s'],
                               'anomalies': len(events),
                               'reason': events[0]['detail']['reason'] if events else None,
                               'failures': failures, 'entries': _entry_bytes(full_dir)[0],
                               'equal_to_uncached': full['row_digests'] == uncached['row_digests'],
                               'injections': _injections()}
    shutil.rmtree(full_dir, ignore_errors=True)

    def loader(**kwargs):
        return make_torch_loader(url, VIT_BATCH, fields=['^image$', '^label$'], num_epochs=1,
                                 last_batch='short', device='cuda', shuffle_row_groups=False,
                                 **kwargs)

    with armed('decode.rowgroup:error:1:match=#rg3'):
        got, error, seconds = _consume(loader(), CHAOS_DEADLINE_S)
        drills['poisoned_rowgroup'] = {'batches_before': got, 'error': repr(error)[:300],
                                       'seconds': seconds, 'threads_left': _threads_left(before),
                                       'injections': _injections()}
    with armed('staging.h2d:error:1:after=3:times=1'):
        dispatch = loader()
        got, error, seconds = _consume(dispatch, CHAOS_DEADLINE_S)
        drills['failed_dispatch'] = {
            'batches_before': got, 'error': repr(error)[:300], 'seconds': seconds,
            'stager_alive': dispatch._stage_thread.is_alive(),
            'slots_left': len(dispatch._stager._rings), 'threads_left': _threads_left(before),
            'injections': _injections()}
    fresh, = _loader_passes(url, 1)
    drills['failed_dispatch']['fresh_loader_equal'] = fresh['row_digests'] == uncached['row_digests']

    distinct = sorted(set(labels))
    selected = tuple(distinct[::SELECTIVE_LABEL_STRIDE])
    want_ids = sorted(i for i, label in enumerate(labels) if label in selected)
    with armed('io.read:error:1:match=#footer'):
        faulted = _read_epoch(selective_url, 'cuda', filters=[('label', 'in', selected)])
        drills['faulted_footer'] = {
            'survivors': faulted['rows'],
            'rowgroups_pruned': faulted['counters'].get(pushdown.ROWGROUPS_PRUNED, 0),
            'declines': faulted['summary']['declines'], 'injections': _injections()}
    emit({'phase': 'chaos_path', 'config': 'vit-imagenetlike-384, vit-selective-quarter',
          'deadline_s': CHAOS_DEADLINE_S, 'drills': drills,
          'disarmed': faults.ARMED is None})
    d = drills['disk_full']
    assert d['equal_to_uncached'], 'the degraded epoch lost or changed rows'
    assert d['anomalies'] == 1 and 'ENOSPC' in d['reason'], d
    assert sum(d['failures'].values()) == 1, d['failures']
    assert d['entries'] == 0, d
    d = drills['poisoned_rowgroup']
    assert 'FaultInjected' in d['error'] and '#rg3' in d['error'], d
    assert d['seconds'] < CHAOS_DEADLINE_S and not d['threads_left'], d
    assert d['injections']['decode.rowgroup']['fired'] == 1, d
    d = drills['failed_dispatch']
    assert d['batches_before'] == 3 and 'FaultInjected' in d['error'], d
    assert 'staging.h2d' in d['error'], d
    assert not d['stager_alive'] and d['slots_left'] == 0 and not d['threads_left'], d
    assert d['injections']['staging.h2d'] == {'fired': 1, 'hits': 4, 'counted': 1}, d
    assert d['fresh_loader_equal'], 'a fresh loader after the drill read other rows'
    d = drills['faulted_footer']
    assert faulted['ids'] == want_ids and d['survivors'] == len(want_ids), d
    assert d['rowgroups_pruned'] == 0, d
    assert d['injections']['io.read']['fired'] >= 1, d
    for name, drill in drills.items():
        for site, stats in drill['injections'].items():
            assert stats['fired'] == stats['counted'], (name, site, stats)
    assert faults.ARMED is None


def _plane_left():
    """What of the readahead plane and the autotuner outlives a closed
    loader: live managers, fetch threads, the two overrides and the tuners
    holding them (all empty when torn down)."""
    from petastorm_tpu_torch import codecs, readahead
    from petastorm_tpu_torch.device import autotune
    left = {'managers': readahead.live_manager_count(),
            'fetch_threads': sorted(t.name for t in threading.enumerate()
                                    if t.name.startswith(readahead.THREAD_PREFIX)),
            'depth_override': readahead.depth_override(),
            'decoder_threads_override': codecs._DECODER_THREADS_OVERRIDE,
            'owners': sum(o is not None for o in autotune.override_owners())}
    return {k: v for k, v in left.items() if v}


def _readahead_section():
    """The report's ``readahead`` section since the last fresh telemetry,
    zeros when the plane never ran."""
    from petastorm_tpu_torch import telemetry
    section = telemetry.pipeline_report().get('readahead') or {}
    return {k: section.get(k, 0) for k in ('hits', 'misses', 'coalesced_reads',
                                           'bytes_fetched')} | {
        'degraded': section.get('degraded', {})}


def _row_digest(image, label):
    """A row's digest as ``_digest_pass`` takes it."""
    import hashlib
    row = hashlib.sha1(image.tobytes())
    row.update(label.tobytes())
    return row.hexdigest()


def _file_hashes(root):
    """sha1 of every part file and of the manifest under ``root``."""
    import glob
    import hashlib
    paths = sorted(glob.glob(os.path.join(root, 'part-*'))) + [
        os.path.join(root, '_manifest.json')]
    return [(os.path.basename(p), hashlib.sha1(open(p, 'rb').read()).hexdigest())
            for p in paths]


def phase_write_plane_vit_path(image_codec, tmp):
    """vit-imagenetlike-384 written, appended, compacted and trained on
    through the port's write plane (module docstring, phase 40)."""
    import glob
    import numpy as np
    import pyarrow as pa
    from petastorm_tpu_torch import telemetry
    from petastorm_tpu_torch.codecs import ScalarCodec
    from petastorm_tpu_torch.examples.imagenet import (
        VIT_BASE_KW, imagenet_like_rows, imagenet_like_schema, train_vit_fused,
    )
    from petastorm_tpu_torch.faults import FaultInjected
    from petastorm_tpu_torch.fs import get_filesystem_and_path_or_paths
    from petastorm_tpu_torch.reader import make_batch_reader
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    from petastorm_tpu_torch.workers.thread_pool import ThreadPool
    from petastorm_tpu_torch.write import (
        AppendFollower, compact_dataset, gc_superseded, load_manifest, self_check,
        write_dataset_distributed,
    )
    from petastorm_tpu_torch.write.append import APPEND_STALENESS
    t_phase = time.perf_counter()
    threads_before = _port_threads()
    fresh_telemetry()
    rows = sorted(imagenet_like_rows(VIT_ROWS, 384), key=lambda row: int(row[1]))
    schema = Unischema('WritePlaneImagenetLike', list(imagenet_like_schema(384, image_codec)) + [
        UnischemaField('id', np.int64, (), ScalarCodec(pa.int64()), False)])
    dicts = [{'image': image, 'label': label, 'id': np.int64(i)}
             for i, (image, label) in enumerate(rows)]
    root = os.path.join(tmp, 'vit_write_plane')
    url = 'file://' + root
    fs, root_path = get_filesystem_and_path_or_paths(url)
    kw = dict(shard_rows=WRITE_SHARD_ROWS, rowgroup_size_rows=64, sort_by='label')

    def on_disk():
        return sorted(os.path.basename(p) for p in glob.glob(os.path.join(root, 'part-*')))

    def read_ids(**kwargs):
        with make_batch_reader(url, schema_fields=['^id$'], reader_pool_type='dummy',
                               shuffle_row_groups=False, **kwargs) as reader:
            return sorted(int(i) for b in reader for i in b.id)

    # 1. generation 1 on a thread pool
    t0 = time.perf_counter()
    gen1 = write_dataset_distributed(url, schema, dicts[:WRITE_GEN1_ROWS],
                                     pool=ThreadPool(WRITE_WORKERS), **kw)
    write_s = time.perf_counter() - t0
    gen1_bytes = sum(e['bytes'] for e in gen1.manifest['files'])

    # 2. generation 2 appended while a follower tails the dataset
    delivered, stamps = [], []
    pickup = {}

    def on_batch(batch):
        delivered.extend(int(i) for i in batch.id)
        stamps.append((time.time(), len(delivered)))
        if len(delivered) > WRITE_GEN1_ROWS and 'gauge_s' not in pickup:
            pickup['gauge_s'] = telemetry.get_registry().gauge_value(APPEND_STALENESS)

    def id_reader(urls):
        return make_batch_reader(urls, schema_fields=['^id$'], shuffle_row_groups=False,
                                 num_epochs=1)

    follower = AppendFollower(url, max_staleness_s=APPEND_MAX_STALENESS_S,
                              reader_factory=id_reader)
    follower.start(on_batch)
    try:
        deadline = time.monotonic() + 120
        while len(delivered) < WRITE_GEN1_ROWS and time.monotonic() < deadline \
                and follower.error is None:
            time.sleep(0.01)
        head = sorted(delivered)
        t0 = time.perf_counter()
        gen2 = write_dataset_distributed(url, schema, dicts[WRITE_GEN1_ROWS:],
                                         pool=ThreadPool(WRITE_WORKERS), append=True, **kw)
        append_s = time.perf_counter() - t0
        committed_at = os.path.getmtime(os.path.join(root, '_manifest.json'))
        while len(delivered) < VIT_ROWS and time.monotonic() < deadline \
                and follower.error is None:
            time.sleep(0.01)
    finally:
        follower.stop()
    # wall times of the batches of generation 2, against the commit's mtime
    tail_stamps = [t for t, count in stamps if count > WRITE_GEN1_ROWS]
    pickup_lag_s = (tail_stamps[0] - committed_at) if tail_stamps else None
    delivery_lag_s = (tail_stamps[-1] - committed_at) if tail_stamps else None
    write_report = telemetry.pipeline_report().get('write')
    parts_before = len(gen2.manifest['files'])

    # 3. compaction under an open bounded-staleness epoch
    got = []
    with make_batch_reader(url, schema_fields=['^id$'], reader_pool_type='dummy',
                           shuffle_row_groups=False, max_staleness_s=60) as reader:
        it = iter(reader)
        got.extend(int(i) for i in next(it).id)
        t0 = time.perf_counter()
        compacted = compact_dataset(url)
        compact_s = time.perf_counter() - t0
        for batch in it:
            got.extend(int(i) for i in batch.id)
    check = self_check(url, sort_key='label')
    committed = sorted(e['path'] for e in compacted['files'])
    superseded = sorted(set(on_disk()) - set(committed))
    removed = sorted(gc_superseded(fs, root_path, grace_s=0))
    litter = sorted(glob.glob(os.path.join(root, '.tmp.*')))
    after_gc = on_disk()
    ids_after = read_ids(max_staleness_s=60)

    # 4. fault drill: the manifest swap of one more append fails
    with knobs_set({'PETASTORM_TPU_FAULTS': 'io.write:error:1:match=#manifest'}):
        try:
            write_dataset_distributed(url, schema, dicts[:WRITE_SHARD_ROWS], append=True, **kw)
            drill_error = None
        except FaultInjected as e:
            drill_error = str(e)
    drill_generation = load_manifest(fs, root_path)['generation']
    drill_ids = read_ids()
    drill_orphans = sorted(gc_superseded(fs, root_path, grace_s=0))

    # 5. backend parity on this machine
    parity = {}
    for name, pool in (('local', None), ('thread', ThreadPool(WRITE_WORKERS))):
        parity_root = os.path.join(tmp, 'vit_write_parity_' + name)
        write_dataset_distributed('file://' + parity_root, schema, dicts[:WRITE_PARITY_ROWS],
                                  pool=pool, **kw)
        parity[name] = _file_hashes(parity_root)

    # 6. training on the compacted dataset, then one epoch's row digests
    fresh_telemetry()
    reset_launch_counts()
    result = train_vit_fused(url, steps=VIT_STEPS, batch_size=VIT_BATCH, device='cuda')
    torch.cuda.synchronize()
    launches = launch_counts()
    epoch = _loader_passes(url, 1)[0]
    if image_codec in ('png', 'npy'):
        want_digests = sorted(_row_digest(image, label) for image, label in rows)
    else:
        # lossy cells: the CPU's decode of what was committed
        with make_batch_reader(url, schema_fields=['^image$', '^label$'],
                               reader_pool_type='dummy') as reader:
            want_digests = sorted(_row_digest(image, label) for b in reader
                                  for image, label in zip(b.image, b.label))
    losses = result['losses']
    threads_left = _threads_left(threads_before)
    emit({'phase': 'write_plane_vit_path', 'image_codec': image_codec, 'rows': VIT_ROWS,
          'gen1_rows': WRITE_GEN1_ROWS, 'shard_rows': WRITE_SHARD_ROWS,
          'pool': 'ThreadPool(%d)' % WRITE_WORKERS, 'sort_by': 'label',
          'generations': {'written': gen1.manifest['generation'],
                          'appended': gen2.manifest['generation'],
                          'compacted': compacted['generation'],
                          'after_fault_drill': drill_generation},
          'parts': {'gen1': len(gen1.manifest['files']), 'before_compaction': parts_before,
                    'after_compaction': len(compacted['files']),
                    'superseded_removed': len(removed), 'on_disk_after_gc': len(after_gc)},
          'write_s': write_s, 'write_rows_per_s': WRITE_GEN1_ROWS / write_s,
          'write_mb_per_s': gen1_bytes / write_s / 1e6, 'gen1_bytes': gen1_bytes,
          'append_s': append_s, 'compact_s': compact_s,
          'follower': {'max_staleness_s': APPEND_MAX_STALENESS_S,
                       'pickup_lag_s': pickup_lag_s, 'delivery_lag_s': delivery_lag_s,
                       'staleness_gauge_s': pickup.get('gauge_s'),
                       'delivered': len(delivered), 'generation': follower.generation},
          'write_report': write_report, 'self_check': check,
          'epoch_rows_across_compaction': len(got), 'tmp_litter': litter,
          'fault_drill': {'error': drill_error, 'orphans_removed': drill_orphans},
          'backend_parity': {'files': len(parity['local']),
                             'equal': parity['local'] == parity['thread']},
          'train': {'steps': len(losses), 'batch_size': VIT_BATCH, 'losses': losses,
                    'images_per_s': result['images_per_s'],
                    'batch_devices': result['batch_devices'],
                    'fused_decode_mode': result['diagnostics']['fused_decode_mode']},
          'launches': launches,
          'epoch': {'rows': len(epoch['row_digests']),
                    'images_per_s': epoch['images_per_s'],
                    'digests_equal_written': epoch['row_digests'] == want_digests},
          'threads_left': threads_left, 'seconds': time.perf_counter() - t_phase})
    assert follower.error is None, follower.error
    assert head == list(range(WRITE_GEN1_ROWS)), len(head)
    assert sorted(delivered) == list(range(VIT_ROWS)), len(delivered)
    assert pickup_lag_s is not None and pickup_lag_s <= APPEND_MAX_STALENESS_S, pickup_lag_s
    assert (gen1.manifest['generation'], gen2.manifest['generation']) == (1, 2)
    assert parts_before == WRITE_GEN1_ROWS // WRITE_SHARD_ROWS + \
        (VIT_ROWS - WRITE_GEN1_ROWS) // WRITE_SHARD_ROWS, parts_before
    assert sorted(got) == list(range(VIT_ROWS)), len(got)
    assert compacted['generation'] == 3 and len(compacted['files']) < parts_before
    assert check['warnings'] == [] and check['stats_coverage'] == 1.0, check
    assert removed == superseded and superseded, (removed, superseded)
    assert after_gc == committed and not litter, (after_gc, litter)
    assert ids_after == list(range(VIT_ROWS))
    assert drill_error is not None and 'io.write' in drill_error, drill_error
    assert drill_generation == 3 and drill_ids == list(range(VIT_ROWS))
    assert parity['local'] == parity['thread'], parity
    assert len(losses) == VIT_STEPS and all(math.isfinite(v) for v in losses), losses
    assert result['batch_devices'] == ['cuda:0'], result['batch_devices']
    assert launches['normalize_images'] == VIT_STEPS, launches
    for name in FLASH_KERNELS:
        assert launches[name] == VIT_BASE_KW['n_layers'] * VIT_STEPS, (name, launches)
    assert epoch['row_digests'] == want_digests, 'epoch rows differ from the written set'
    assert not threads_left, threads_left
    return launches


def _rowgroup_columns(url, columns):
    """``[{column: values}]`` of every row-group in ``load_row_groups``
    order (the ordinals an index names), read with pyarrow alone."""
    import pyarrow.parquet as pq
    from petastorm_tpu_torch.etl.dataset_metadata import ParquetDatasetInfo, load_row_groups
    info = ParquetDatasetInfo(url)
    out = []
    for piece in load_row_groups(info):
        with info.open(piece.path) as f:
            table = pq.ParquetFile(f).read_row_group(piece.row_group, columns=list(columns))
        out.append({c: table.column(c).to_numpy() for c in columns})
    return out


def _legacy_only_copy(src_root, dst_root):
    """A copy of a dataset whose parts are hard links and whose
    ``_common_metadata`` keeps only the original petastorm's two keys: the
    footer the original petastorm writes."""
    import pyarrow.parquet as pq
    from petastorm_tpu_torch.etl.dataset_metadata import (
        LEGACY_ROW_GROUPS_PER_FILE_KEY, LEGACY_UNISCHEMA_KEY,
    )
    os.makedirs(dst_root)
    for name in sorted(os.listdir(src_root)):
        if name.endswith('.parquet') and not name.startswith(('_', '.')):
            os.link(os.path.join(src_root, name), os.path.join(dst_root, name))
    cm = pq.read_metadata(os.path.join(src_root, '_common_metadata'))
    keep = {k: v for k, v in cm.metadata.items()
            if k in (LEGACY_UNISCHEMA_KEY, LEGACY_ROW_GROUPS_PER_FILE_KEY)}
    pq.write_metadata(cm.schema.to_arrow_schema().with_metadata(keep),
                      os.path.join(dst_root, '_common_metadata'))
    return sorted(keep)


def _pinned_expected_rows():
    """The values ``tests/data/reference_written`` (written by the original
    petastorm) holds: ``RandomState(42)``'s draws, as
    ``tests/test_interop_pinned.py`` regenerates them."""
    import numpy as np
    rng = np.random.RandomState(42)
    rows = {}
    for i in range(PINNED_ROWS):
        vec = rng.rand(8).astype(np.float32)
        rng.rand(4)                                      # cvec
        rows[i] = {'vec': vec, 'img': rng.randint(0, 255, (16, 32, 3), np.uint8)}
    return rows


def _check_normalize(x):
    """The normalize kernel on ``x`` against its plain version, f32 within
    1e-5 and bf16 within 1 ulp: ``{dtype: max error}``."""
    from petastorm_tpu_torch.ops.normalize import normalize_images, normalize_images_reference
    mean, std = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        got = normalize_images(x, mean, std, dtype)
        want = normalize_images_reference(x, mean, std, dtype)
        torch.cuda.synchronize()
        assert got.shape == x.shape and got.dtype == dtype and got.is_cuda
        if dtype == torch.float32:
            err = float((got - want).abs().max())
            assert err <= 1e-5, err
            out['f32_max_abs_err'] = err
        else:
            ulps = bf16_ulp_distance(got, want)
            assert ulps <= 1, ulps
            out['bf16_max_ulps'] = ulps
    return out


def phase_etl_tools_vit_path(selective_url, tmp):
    """Item 10b on the image path (module docstring, phase 41): a row-group
    index and a selector over the write plane's folded dataset, a
    legacy-only footer, the pinned dataset the original petastorm wrote,
    and the host tools."""
    import io
    import numpy as np
    from petastorm_tpu_torch.etl.dataset_metadata import (
        ParquetDatasetInfo, get_schema, get_schema_from_dataset_url,
    )
    from petastorm_tpu_torch.etl.metadata_util import print_metadata
    from petastorm_tpu_torch.etl.petastorm_generate_metadata import (
        generate_petastorm_metadata,
    )
    from petastorm_tpu_torch.etl.rowgroup_indexers import SingleFieldIndexer
    from petastorm_tpu_torch.etl.rowgroup_indexing import (
        build_rowgroup_index, get_row_group_indexes,
    )
    from petastorm_tpu_torch.examples.imagenet import VIT_BASE_KW, train_vit_fused
    from petastorm_tpu_torch.reader import make_batch_reader, make_reader
    from petastorm_tpu_torch.selectors import SingleIndexSelector
    from petastorm_tpu_torch.tools.copy_dataset import copy_dataset
    global ETL_COPY_SCHEMA
    t_phase = time.perf_counter()
    threads_before = _port_threads()
    root = os.path.join(tmp, 'vit_write_plane')
    url = 'file://' + root
    launches = {name: 0 for name in (*FLASH_KERNELS, 'normalize_images')}

    def train(dataset_url, **kwargs):
        fresh_telemetry()
        reset_launch_counts()
        result = train_vit_fused(dataset_url, steps=SELECTIVE_STEPS, batch_size=VIT_BATCH,
                                 device='cuda', **kwargs)
        torch.cuda.synchronize()
        counts = launch_counts()
        for name, n in counts.items():
            launches[name] += n
        losses = result['losses']
        assert len(losses) == SELECTIVE_STEPS and all(math.isfinite(v) for v in losses), losses
        assert result['batch_devices'] == ['cuda:0'], result['batch_devices']
        assert counts['normalize_images'] == SELECTIVE_STEPS, counts
        for name in FLASH_KERNELS:
            assert counts[name] == VIT_BASE_KW['n_layers'] * SELECTIVE_STEPS, (name, counts)
        return {'steps': len(losses), 'losses': losses, 'images_per_s': result['images_per_s'],
                'fused_decode_mode': result['diagnostics']['fused_decode_mode'],
                'launches': counts}

    def same_batches(a, b):
        assert len(a) == len(b) > 0, (len(a), len(b))
        for x, y in zip(a, b):
            assert sorted(x) == sorted(y)
            for name in x:
                assert torch.equal(x[name], y[name]), name

    # (a) an index and a selector over the folded, committed dataset
    t0 = time.perf_counter()
    build_rowgroup_index(url, [SingleFieldIndexer('label_index', 'label'),
                               SingleFieldIndexer('id_index', 'id')])
    index_s = time.perf_counter() - t0
    groups = _rowgroup_columns(url, ('label', 'id'))
    labels_in_order = sorted(int(v) for g in groups for v in g['label'])
    selected_labels = sorted(set(labels_in_order[:len(labels_in_order) // 4]))
    predicted = sorted(i for i, g in enumerate(groups)
                       if np.isin(g['label'], selected_labels).any())
    want_ids = sorted(int(v) for i in predicted for v in groups[i]['id'])
    selector = SingleIndexSelector('label_index', selected_labels)
    indexes = get_row_group_indexes(ParquetDatasetInfo(url))
    selected = sorted(selector.select_row_groups(indexes))
    read_kw = dict(rowgroup_selector=selector, reader_pool_type='dummy',
                   shuffle_row_groups=False)
    card = _read_epoch(url, 'cuda', keep=True, **read_kw)
    host = _read_epoch(url, 'cpu', keep=True, **read_kw)
    same_batches(card['batches'], host['batches'])
    del card['batches'], host['batches']
    selected_train = train(url, rowgroup_selector=selector)

    # (b) a legacy-only footer: a hard-linked copy of vit_selective
    legacy_root = os.path.join(tmp, 'vit_legacy_footer')
    legacy_url = 'file://' + legacy_root
    legacy_keys = _legacy_only_copy(selective_url[len('file://'):], legacy_root)
    legacy_schema = get_schema_from_dataset_url(legacy_url)
    json_schema = get_schema_from_dataset_url(selective_url)
    epoch_kw = dict(reader_pool_type='dummy', shuffle_row_groups=False)
    legacy_epoch = _read_epoch(legacy_url, 'cuda', keep=True, **epoch_kw)
    json_epoch = _read_epoch(selective_url, 'cuda', keep=True, **epoch_kw)
    same_batches(legacy_epoch['batches'], json_epoch['batches'])
    legacy_batches = len(legacy_epoch['batches'])
    del legacy_epoch['batches'], json_epoch['batches']
    legacy_train = train(legacy_url)

    # (c) the dataset the original petastorm wrote
    pinned_url = 'file://' + os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                          'tests', 'data', 'reference_written')
    expected = _pinned_expected_rows()
    with make_reader(pinned_url, reader_pool_type='dummy', shuffle_row_groups=False) as reader:
        pinned_rows = {int(r.id): r for r in reader}
    with make_batch_reader(pinned_url, reader_pool_type='dummy', shuffle_row_groups=False,
                           schema_fields=['^id$', '^img$']) as reader:
        pinned_batch = {int(i): img for b in reader for i, img in zip(b.id, b.img)}
    assert sorted(pinned_rows) == sorted(pinned_batch) == list(range(PINNED_ROWS))
    for i, want in expected.items():
        np.testing.assert_array_equal(pinned_rows[i].vec, want['vec'])
        np.testing.assert_array_equal(pinned_rows[i].img, want['img'])
        np.testing.assert_array_equal(pinned_batch[i], want['img'])
    images = torch.from_numpy(np.stack([pinned_batch[i] for i in range(PINNED_ROWS)])).cuda()
    pinned_kernel = dict(_check_normalize(images), shape=list(images.shape))

    # (d) the host tools
    copy_root = os.path.join(tmp, 'vit_copy')
    copy_url = 'file://' + copy_root
    t0 = time.perf_counter()
    copied = copy_dataset(url, copy_url, field_regex=['^id$', '^label$'])
    copy_s = time.perf_counter() - t0

    def id_label_pairs(dataset_url):
        with make_batch_reader(dataset_url, schema_fields=['^id$', '^label$'],
                               reader_pool_type='dummy') as reader:
            return sorted((int(i), int(v)) for b in reader for i, v in zip(b.id, b.label))

    source_pairs = id_label_pairs(url)
    copy_pairs = id_label_pairs(copy_url)
    os.remove(os.path.join(copy_root, '_common_metadata'))
    projected = get_schema(ParquetDatasetInfo(url)).create_schema_view(['^id$', '^label$'])
    ETL_COPY_SCHEMA = projected
    t0 = time.perf_counter()
    generated = generate_petastorm_metadata(copy_url,
                                            unischema_class=__name__ + '.ETL_COPY_SCHEMA')
    generate_s = time.perf_counter() - t0
    regenerated_schema = get_schema_from_dataset_url(copy_url)
    regenerated_pairs = id_label_pairs(copy_url)
    t0 = time.perf_counter()
    printed = io.StringIO()
    print_metadata(url, out=printed)
    print_s = time.perf_counter() - t0
    text = printed.getvalue()
    threads_left = _threads_left(threads_before)
    emit({'phase': 'etl_tools_vit_path', 'config': 'vit-imagenetlike-write-plane',
          'entry': 'build_rowgroup_index -> make_torch_loader(rowgroup_selector=) -> '
                   'normalize -> ViT-Base',
          'index': {'seconds': index_s, 'indexes': sorted(indexes),
                    'label_values': len(indexes['label_index'].indexed_values),
                    'id_values': len(indexes['id_index'].indexed_values)},
          'selector': {'labels': selected_labels, 'rowgroups_before': len(groups),
                       'rowgroups_after': len(selected), 'predicted': predicted,
                       'rows_selected': len(want_ids), 'card_rows': card['rows'],
                       'read_images_per_s': card['images_per_s'],
                       'card_vs_cpu_equal': True},
          'selected_train': selected_train,
          'legacy_footer': {'keys': [k.decode() for k in legacy_keys],
                            'schema_equal_json': legacy_schema.to_json_dict() ==
                            json_schema.to_json_dict(),
                            'rows': legacy_epoch['rows'], 'batches': legacy_batches,
                            'read_images_per_s': legacy_epoch['images_per_s'],
                            'json_read_images_per_s': json_epoch['images_per_s']},
          'legacy_train': legacy_train,
          'pinned': {'rows': len(pinned_rows), 'normalize': pinned_kernel},
          'copy': {'seconds': copy_s, 'rows': copied,
                   'rows_per_s': copied / copy_s if copy_s else None},
          'generate_metadata': {'seconds': generate_s, 'fields': list(generated.fields)},
          'print_metadata': {'seconds': print_s, 'lines': len(text.splitlines())},
          'launches': launches, 'threads_left': threads_left,
          'seconds': time.perf_counter() - t_phase})
    print(text, end='', flush=True)
    assert 0 < len(selected) < len(groups), (len(selected), len(groups))
    assert selected == predicted, (selected, predicted)
    assert card['ids'] == host['ids'] == want_ids, (card['rows'], len(want_ids))
    assert legacy_keys == [b'dataset-toolkit.num_row_groups_per_file.v1',
                           b'dataset-toolkit.unischema.v1'], legacy_keys
    assert legacy_schema.to_json_dict() == json_schema.to_json_dict()
    assert legacy_epoch['ids'] == json_epoch['ids'] == list(range(VIT_ROWS))
    assert copied == VIT_ROWS and copy_pairs == source_pairs, (copied, len(copy_pairs))
    assert generated.to_json_dict() == projected.to_json_dict()
    assert regenerated_schema.to_json_dict() == projected.to_json_dict()
    assert regenerated_pairs == source_pairs
    assert 'Row-groups: %d over ' % len(groups) in text, text
    assert "  label_index: fields=['label'] values=%d" % len(
        indexes['label_index'].indexed_values) in text, text
    assert "  id_index: fields=['id'] values=%d" % VIT_ROWS in text, text
    assert not threads_left, threads_left
    return launches


def phase_readahead_vit_path(url, image_codec, vit_images_per_s, tmp):
    """vit-imagenetlike-384 through the readahead plane and the staging
    autotuner (module docstring, phase 35)."""
    from petastorm_tpu_torch import readahead, telemetry
    from petastorm_tpu_torch.device.loader import make_torch_loader
    from petastorm_tpu_torch.examples.imagenet import VIT_BASE_KW, train_vit_fused
    t_phase = time.perf_counter()
    epochs = []
    for mode in ('off', 'on', 'on', 'off'):
        with knobs_set({'PETASTORM_TPU_READAHEAD': '1' if mode == 'on' else '0'}):
            digests, rate, diag = _epoch_digests(url)
            epochs.append({'readahead': mode, 'images_per_s': rate, 'digests': digests,
                           'read_path': diag['fused_decode_mode'],
                           'counts': _readahead_section()})
        assert not _plane_left(), _plane_left()
    on_rates = [e['images_per_s'] for e in epochs if e['readahead'] == 'on']
    off_rates = [e['images_per_s'] for e in epochs if e['readahead'] == 'off']
    # the producer-bound drill: a read-only loader, the tuner on a short window
    drill_knobs = {'PETASTORM_TPU_STAGING_AUTOTUNE_WINDOW_SEC': READAHEAD_TUNE_WINDOW_S,
                   'PETASTORM_TPU_OBS_PORT': '0'}
    with knobs_set(drill_knobs):
        rates = []
        with make_torch_loader(url, VIT_BATCH, fields=['^image$', '^label$'], num_epochs=1,
                               last_batch='short', device='cuda',
                               shuffle_row_groups=False) as loader:
            least, most = READAHEAD_DRILL_EPOCHS
            while len(rates) < most and (len(rates) < least
                                         or not loader._autotuner.decisions):
                start, rows = time.perf_counter(), 0
                for batch in loader:
                    rows += int(batch['label'].shape[0])
                torch.cuda.synchronize()
                rates.append(rows / (time.perf_counter() - start))
            own = loader.autotune_report()
            served = json.loads(http_get('/report')[0])
            drill_workers = loader.reader._pool.workers_count
        drill_counts = _readahead_section()
        drill_left = _plane_left()
    plane_torn_down()
    own_actions = [d['action'] for d in own['staging_autotune']['recent']]
    served_actions = [d['action'] for d in served['autotune']['staging_autotune']['recent']]
    # ViT-Base steps on a loader with both planes on, at their defaults
    fresh_telemetry()
    reset_launch_counts()
    result = train_vit_fused(url, steps=VIT_STEPS, batch_size=VIT_BATCH, device='cuda')
    torch.cuda.synchronize()
    launches = launch_counts()
    train_counts = _readahead_section()
    tuned = telemetry.pipeline_report().get('staging_autotune') or {}
    train_left = _plane_left()
    losses = result['losses']
    emit({'phase': 'readahead_vit_path', 'config': 'vit-imagenetlike-384',
          'entry': 'make_torch_loader (readahead + autotune on) -> normalize -> ViT-Base',
          'image_codec': image_codec, 'rows': VIT_ROWS, 'rowgroups': VIT_ROWS // 64,
          'cold_epochs': [{k: e[k] for k in ('readahead', 'images_per_s', 'read_path', 'counts')}
                          for e in epochs],
          'cold_equal_in_order': all(e['digests'] == epochs[0]['digests'] for e in epochs),
          'cold_on_over_off': sum(on_rates) / sum(off_rates),
          'drill': {'epochs': len(rates), 'window_s': float(READAHEAD_TUNE_WINDOW_S),
                    'images_per_s': rates, 'workers': drill_workers,
                    'bottleneck': own['bottleneck'],
                    'decisions': own['staging_autotune']['decisions'],
                    'actions': own_actions, 'report_actions': served_actions,
                    'summary': {k: v for k, v in own['staging_autotune'].items()
                                if k != 'recent'},
                    'readahead': drill_counts, 'left_after_close': drill_left},
          'train': {'steps': len(losses), 'batch_size': VIT_BATCH, 'losses': losses,
                    'images_per_s': result['images_per_s'],
                    'vit_path_images_per_s': vit_images_per_s, 'launches': launches,
                    'pool_budget_mb': readahead.pool_budget_bytes() / 2 ** 20,
                    'readahead': train_counts,
                    'decisions_by_action': tuned.get('by_action', {}),
                    'loader_decisions': result['diagnostics']['staging_autotune_decisions'],
                    'fused_decode_mode': result['diagnostics']['fused_decode_mode'],
                    'left_after_close': train_left},
          'seconds': time.perf_counter() - t_phase})
    for e in epochs:
        assert len(e['digests']) == VIT_ROWS // VIT_BATCH, len(e['digests'])
        assert e['digests'] == epochs[0]['digests'], 'a readahead epoch differs'
        if e['readahead'] == 'on':
            # the first observe fetches its own item: every row-group hits
            assert e['counts']['hits'] == VIT_ROWS // 64, e['counts']
            assert e['counts']['misses'] == 0 and not e['counts']['degraded'], e['counts']
        else:
            assert e['counts']['hits'] == e['counts']['misses'] == 0, e['counts']
    assert own['staging_autotune']['decisions'] >= 1 and own_actions, own
    assert own_actions == served_actions, (own_actions, served_actions)
    assert not drill_left, drill_left
    assert not drill_counts['degraded'], drill_counts
    assert len(losses) == VIT_STEPS and all(math.isfinite(v) for v in losses), losses
    assert result['batch_devices'] == ['cuda:0'], result['batch_devices']
    assert launches['normalize_images'] == VIT_STEPS, launches
    want = VIT_BASE_KW['n_layers'] * VIT_STEPS
    for name in FLASH_KERNELS:
        assert launches[name] == want, (name, launches[name], want)
    assert not train_counts['degraded'], train_counts
    assert train_counts['hits'] > 0 and train_counts['misses'] == 0, train_counts
    assert not train_left, train_left
    return launches


def _nvidia_smi_compute_pids():
    """The pids ``nvidia-smi`` lists as compute apps on the card."""
    out = subprocess.run(['nvidia-smi', '--query-compute-apps=pid', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60)
    return {int(line) for line in out.stdout.split() if line.strip().isdigit()}


def _maps_libcuda(pid):
    """Whether process ``pid`` has ``libcuda.so`` mapped (read from its
    ``/proc/<pid>/maps``; False once it is gone)."""
    try:
        with open('/proc/%d/maps' % pid) as f:
            return 'libcuda.so' in f.read()
    except OSError:
        return False


def _pool_rows(url, pool_type, workers, batches=None, **reader_kwargs):
    """``(label, crc32 of the uint8 pixels)`` of each row the loader gives
    on ``pool_type`` with ``workers`` workers, shuffled with seed 0, by
    batch: the first ``batches`` or one epoch."""
    import zlib
    from petastorm_tpu_torch.device.loader import make_torch_loader
    out = []
    with make_torch_loader(url, VIT_BATCH, fields=['^image$', '^label$'], num_epochs=1,
                           shuffle_row_groups=True, seed=0, device='cuda',
                           reader_pool_type=pool_type, workers_count=workers,
                           **reader_kwargs) as loader:
        for batch in loader:
            images = batch['image'].cpu().numpy()
            labels = batch['label'].cpu().numpy()
            out.append([(int(label), zlib.crc32(image.tobytes()))
                        for image, label in zip(images, labels)])
            if batches is not None and len(out) == batches:
                break
    return out


def phase_process_vit_path(url, image_codec, vit_images_per_s, tmp):
    """vit-imagenetlike-384 through the port's process pool (module
    docstring, phase 47)."""
    import zlib

    import numpy as np
    import psutil
    import pyarrow as pa
    from petastorm_tpu_torch.codecs import ScalarCodec
    from petastorm_tpu_torch.examples.imagenet import (
        VIT_BASE_KW, imagenet_like_rows, imagenet_like_schema, train_vit_fused,
    )
    from petastorm_tpu_torch.ops import flash_attention
    from petastorm_tpu_torch.reader import make_batch_reader
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    from petastorm_tpu_torch.workers import process_pool
    from petastorm_tpu_torch.workers.thread_pool import ThreadPool
    from petastorm_tpu_torch.write import write_dataset_distributed
    t_phase = time.perf_counter()
    threads_before = _port_threads()
    # 1. rows through either pool: the first batches on one worker (the
    # ventilation order, so batch for batch), one epoch on four
    first = {kind: _pool_rows(url, kind, 1, PROCESS_PARITY_BATCHES)
             for kind in ('thread', 'process')}
    epoch = {kind: _pool_rows(url, kind, PROCESS_WORKERS) for kind in ('thread', 'process')}

    def multiset(batches):
        return collections.Counter(row for batch in batches for row in batch)

    # 2. ViT-Base trained from a process-pool read, its pools and the card watched
    pools, sampled = [], {'workers_alive': [], 'card_pids': set(), 'cuda_mapped': set()}
    start = process_pool.ProcessPool.start
    launch = flash_attention._launch
    dtypes = collections.Counter()

    def recording_start(self, *args, **kwargs):
        t0 = time.perf_counter()
        start(self, *args, **kwargs)
        pools.append({'pool': self, 'startup_s': time.perf_counter() - t0,
                      'pids': list(self.worker_pids)})

    def recording_launch(fn, name, pointers, tensors, q, *args):
        dtypes[str(q.dtype)] += 1
        return launch(fn, name, pointers, tensors, q, *args)

    done = threading.Event()

    def watch():
        while not done.is_set():
            if pools:
                sampled['workers_alive'].append(pools[-1]['pool'].diagnostics['workers_alive'])
                sampled['card_pids'] |= _nvidia_smi_compute_pids()
                for pid in pools[-1]['pids']:
                    if _maps_libcuda(pid):
                        sampled['cuda_mapped'].add(pid)
            done.wait(0.5)

    fresh_telemetry()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    process_pool.ProcessPool.start = recording_start
    flash_attention._launch = recording_launch
    watcher = threading.Thread(target=watch, name='process-vit-watch', daemon=True)
    watcher.start()
    try:
        result = train_vit_fused(url, steps=PROCESS_VIT_STEPS, batch_size=VIT_BATCH,
                                 device='cuda', reader_pool_type='process',
                                 workers_count=PROCESS_WORKERS)
        torch.cuda.synchronize()
    finally:
        done.set()
        watcher.join()
        process_pool.ProcessPool.start = start
        flash_attention._launch = launch
    launches = launch_counts()
    stages = stage_seconds()
    counters = _readahead_section()
    (train_pool,) = pools
    reports = train_pool['pool'].worker_reports
    worker_pids = set(train_pool['pids'])
    alive_after = train_pool['pool'].diagnostics['workers_alive']
    losses = result['losses']
    # 3. the write plane on four worker processes, against four threads
    rows = list(imagenet_like_rows(PROCESS_WRITE_ROWS, 384, seed=11))
    schema = Unischema('ProcessImagenetLike', list(imagenet_like_schema(384, image_codec)) + [
        UnischemaField('id', np.int64, (), ScalarCodec(pa.int64()), False)])
    dicts = [{'image': image, 'label': label, 'id': np.int64(i)}
             for i, (image, label) in enumerate(rows)]
    kw = dict(shard_rows=WRITE_SHARD_ROWS, rowgroup_size_rows=64, sort_by='id')
    written, write_s = {}, {}
    for kind, pool in (('thread', ThreadPool(PROCESS_WORKERS)),
                       ('process', process_pool.ProcessPool(PROCESS_WORKERS))):
        root = os.path.join(tmp, 'vit_process_write_%s' % kind)
        t0 = time.perf_counter()
        write_dataset_distributed('file://' + root, schema, dicts, pool=pool, **kw)
        write_s[kind] = time.perf_counter() - t0
        written[kind] = root
    with make_batch_reader('file://' + written['process'], reader_pool_type='process',
                           workers_count=PROCESS_WORKERS) as reader:
        read_back = sorted((int(i), int(label), zlib.crc32(image.tobytes()))
                           for b in reader for i, label, image in zip(b.id, b.label, b.image))
    source = sorted((i, int(label), zlib.crc32(image.tobytes()))
                    for i, (image, label) in enumerate(rows))
    file_hashes = {kind: _file_hashes(root) for kind, root in written.items()}
    children = {}
    for child in psutil.Process().children(recursive=True):
        try:
            children[child.pid] = ' '.join(child.cmdline())
        except psutil.Error:  # gone since it was listed
            pass
    pool_children = sorted(pid for pid, cmd in children.items()
                           if 'exec_in_new_process' in cmd or pid in worker_pids)
    emit({'phase': 'process_vit_path', 'config': 'vit-imagenetlike-384',
          'entry': "train_vit_fused(reader_pool_type='process') -> make_torch_loader -> "
                   'normalize -> ViT-Base',
          'model': VIT_BASE_KW, 'image_codec': image_codec, 'workers': PROCESS_WORKERS,
          'steps': len(losses), 'batch_size': VIT_BATCH, 'losses': losses,
          'launches': launches, 'launch_dtypes': dict(dtypes),
          'images_per_s': result['images_per_s'], 'vit_path_images_per_s': vit_images_per_s,
          'over_vit_path': result['images_per_s'] / vit_images_per_s,
          'worker_startup_s': train_pool['startup_s'],
          'peak_memory_bytes': torch.cuda.max_memory_allocated(),
          'fused_decode_mode': result['diagnostics']['fused_decode_mode'],
          'consumer_wait_s': result['diagnostics']['consumer_wait_s'],
          'stage_seconds': stages, 'readahead': counters,
          'worker_reports': [{k: r[k] for k in ('worker_id', 'pid', 'cuda_visible_devices')}
                             | {'torch_loaded': 'torch' in r['modules'],
                                'jax_loaded': 'jax' in r['modules'],
                                'petastorm_tpu_loaded': 'petastorm_tpu' in r['modules']}
                             for r in reports],
          'card_pids_seen': sorted(sampled['card_pids']),
          'workers_with_libcuda': sorted(sampled['cuda_mapped']),
          'consumer_has_libcuda': _maps_libcuda(os.getpid()),
          'workers_alive_while_running': sorted(set(sampled['workers_alive'])),
          'workers_alive_after_join': alive_after, 'children': sorted(children),
          'pool_children_left': pool_children,
          'parity': {'first_batches': PROCESS_PARITY_BATCHES,
                     'first_rows': sum(len(b) for b in first['process']),
                     'first_equal_in_order': first['thread'] == first['process'],
                     'epoch_rows': sum(len(b) for b in epoch['process']),
                     'epoch_multisets_equal': multiset(epoch['thread'])
                     == multiset(epoch['process'])},
          'write': {'rows': PROCESS_WRITE_ROWS, 'seconds': write_s,
                    'parts_and_manifest_equal': file_hashes['thread'] == file_hashes['process'],
                    'files': len(file_hashes['process']),
                    'read_back_equal': read_back == source},
          'seconds': time.perf_counter() - t_phase})
    assert len(first['process']) == PROCESS_PARITY_BATCHES, len(first['process'])
    assert multiset(first['thread']) == multiset(first['process'])
    assert first['thread'] == first['process']
    assert sum(len(b) for b in epoch['process']) == VIT_ROWS
    assert multiset(epoch['thread']) == multiset(epoch['process'])
    assert len(losses) == PROCESS_VIT_STEPS and all(math.isfinite(v) for v in losses), losses
    assert result['batch_devices'] == ['cuda:0'], result['batch_devices']
    assert launches['normalize_images'] == PROCESS_VIT_STEPS, launches
    want = VIT_BASE_KW['n_layers'] * PROCESS_VIT_STEPS
    for name in FLASH_KERNELS:
        assert launches[name] == want, (name, launches[name], want)
    assert sorted(r['worker_id'] for r in reports) == list(range(PROCESS_WORKERS)), reports
    for r in reports:
        assert r['cuda_visible_devices'] == '', r
        assert not {'jax', 'petastorm_tpu'} & set(r['modules']), r['modules']
    assert not worker_pids & sampled['card_pids'], (worker_pids, sampled['card_pids'])
    assert not sampled['cuda_mapped'], sampled['cuda_mapped']
    assert PROCESS_WORKERS in sampled['workers_alive'], sampled['workers_alive']
    assert alive_after == 0
    assert not pool_children, children
    assert not [pid for pid in worker_pids if psutil.pid_exists(pid)], worker_pids
    # io and decode run only in the workers: these seconds came in their deltas
    assert stages.get('io', 0) > 0 and stages.get('decode', 0) > 0, stages
    assert file_hashes['thread'] == file_hashes['process'], file_hashes
    assert read_back == source
    left = _threads_left(threads_before)
    assert not left, left
    # the libcuda check can see a context: this process holds one
    assert _maps_libcuda(os.getpid())
    # bf16 inputs dispatch to the wgmma instances (the build phase checks them)
    assert dtypes == {'torch.bfloat16': 3 * want}, dtypes
    return launches


def _remote_store_class():
    """A strict in-memory ``gs`` store standing in for a bucket (neither the
    card's machine nor a test machine has a network): only paths in
    ``REMOTE_BUCKET`` reach it, ``get``/``get_file``/``download``/
    ``open_local`` raise, and it records each instance's
    ``storage_options``, every read open, every seek and the bytes read.
    A read open is a handle of its own over the object's bytes, as an
    object store's stream is; the bytes are taken from the written object
    once (``frozen``), not copied again at each open."""
    from fsspec.implementations.memory import MemoryFile, MemoryFileSystem

    class RemoteStore(MemoryFileSystem):
        protocol = 'gs'
        cachable = False
        store = {}
        pseudo_dirs = ['']
        options = []
        opens = collections.Counter()
        seeks = collections.Counter()      # path -> seeks to a nonzero offset
        bytes_read = [0]
        refused = []                       # non-bucket paths and localizing calls
        frozen = {}                        # path -> (written object, its bytes)
        lock = threading.Lock()

        def __init__(self, **storage_options):
            type(self).options.append(dict(storage_options))
            super().__init__()

        @classmethod
        def _strip_protocol(cls, path):
            path = str(path)
            if path.startswith('gs://'):
                path = path[len('gs://'):]
            path = '/' + path.lstrip('/')
            if not (path == '/' or path == '/' + REMOTE_BUCKET
                    or path.startswith('/%s/' % REMOTE_BUCKET)):
                cls.refused.append(('path', path))
                raise AssertionError('non-bucket path reached the store: %r' % path)
            return path

        def _localizing(self, *args, **kwargs):
            type(self).refused.append(('localizing', repr(args[:1])))
            raise AssertionError('localizing call on a remote store')

        get = get_file = download = open_local = _localizing

        def _open(self, path, mode='rb', **kwargs):
            path = self._strip_protocol(path)
            if mode != 'rb' or path not in self.store:
                return super()._open(path, mode=mode, **kwargs)
            cls = type(self)
            written = self.store[path]
            with cls.lock:
                cls.opens[path] += 1
                kept = cls.frozen.get(path)
                if kept is None or kept[0] is not written:
                    kept = cls.frozen[path] = (written, written.getvalue())
            return _Handle(cls, path, kept[1])

    class _Handle(MemoryFile):
        def __init__(self, cls, path, data):
            super().__init__(None, path, data)
            self._cls = cls
            self._nbytes = len(data)

        @property
        def size(self):
            # MemoryFile's size exports a writable buffer, which copies the
            # bytes this handle shares with the store
            return self._nbytes

        def seek(self, pos, whence=0):
            if pos:
                with self._cls.lock:
                    self._cls.seeks[self.path] += 1
            return super().seek(pos, whence)

        def read(self, size=-1):
            data = super().read(size)
            with self._cls.lock:
                self._cls.bytes_read[0] += len(data)
            return data

        def readinto(self, buffer):
            n = super().readinto(buffer)
            with self._cls.lock:
                self._cls.bytes_read[0] += n
            return n

    return RemoteStore


@contextlib.contextmanager
def _gs_bound_to(cls):
    """fsspec's ``gs`` protocol bound to ``cls`` for the block, then what
    was bound before (or nothing)."""
    import fsspec
    from fsspec.registry import _registry
    before = _registry.get('gs')
    fsspec.register_implementation('gs', cls, clobber=True)
    try:
        yield cls
    finally:
        if before is not None:
            fsspec.register_implementation('gs', before, clobber=True)
        else:
            _registry.pop('gs', None)


def _hadoop_home(root):
    """A Hadoop configuration under ``root`` naming ``HDFS_NAMESERVICE``'s
    two namenodes, as a cluster's ``hdfs-site.xml`` and ``core-site.xml``
    do; returns the directory for ``$HADOOP_HOME``."""
    conf = os.path.join(root, 'etc', 'hadoop')
    os.makedirs(conf, exist_ok=True)
    ids = ['nn%d' % (i + 1) for i in range(len(HDFS_NAMENODES))]
    props = {'dfs.nameservices': HDFS_NAMESERVICE,
             'dfs.ha.namenodes.%s' % HDFS_NAMESERVICE: ','.join(ids)}
    for nn, address in zip(ids, HDFS_NAMENODES):
        props['dfs.namenode.rpc-address.%s.%s' % (HDFS_NAMESERVICE, nn)] = address

    def site(values):
        return '<configuration>%s</configuration>' % ''.join(
            '<property><name>%s</name><value>%s</value></property>' % item
            for item in values.items())

    with open(os.path.join(conf, 'hdfs-site.xml'), 'w') as f:
        f.write(site(props))
    with open(os.path.join(conf, 'core-site.xml'), 'w') as f:
        f.write(site({'fs.defaultFS': 'hdfs://%s' % HDFS_NAMESERVICE}))
    return root


def _namenodes(opens_before_death):
    """A ``connect_fn`` for two stand-in namenodes over the local disk:
    ``nn-a`` serves ``opens_before_death`` opens, then dies for good (its
    opens raise ``OSError`` and it refuses new connections); ``nn-b``
    stays up. Returns the function and its record (connections, opens
    served, the thread of the open that found ``nn-a`` dead)."""
    import fsspec
    local = fsspec.filesystem('file')
    record = {'connects': [], 'opens': collections.Counter(), 'died_in': None}
    state = {'a_left': opens_before_death}
    lock = threading.Lock()

    class Namenode:
        def __init__(self, host):
            self.host = host

        def __getattr__(self, name):
            attr = getattr(local, name)
            if name != 'open':
                return attr

            def open_(*args, **kwargs):
                with lock:
                    if self.host == 'nn-a':
                        if state['a_left'] <= 0:
                            record['died_in'] = (record['died_in']
                                                 or threading.current_thread().name)
                            raise OSError('namenode nn-a lost')
                        state['a_left'] -= 1
                    record['opens'][self.host] += 1
                return attr(*args, **kwargs)
            return open_

    def connect(host, port, storage_options):
        record['connects'].append(host)
        if host == 'nn-a' and state['a_left'] <= 0:
            raise ConnectionError('nn-a refused the connection')
        return Namenode(host)

    return connect, record


def phase_remote_store_vit_path(vit_url, lm_url, image_codec, vit_images_per_s, tmp):
    """vit-imagenetlike-gs and the HDFS failover read (module docstring,
    phase 48)."""
    import logging

    from petastorm_tpu_torch import hdfs
    from petastorm_tpu_torch.etl.dataset_metadata import write_dataset
    from petastorm_tpu_torch.examples.imagenet import (
        VIT_BASE_KW, imagenet_like_rows, imagenet_like_schema, train_vit_fused,
    )
    from petastorm_tpu_torch.examples.lm_pretrain import FLAGSHIP_LM_KW
    from petastorm_tpu_torch.ops import flash_attention
    t_phase = time.perf_counter()
    threads_before = _port_threads()
    store = _remote_store_class()
    url = 'gs://%s/vit' % REMOTE_BUCKET
    with _gs_bound_to(store):
        # (a) the ViT rows written to the bucket, as write_vit_dataset writes them
        t0 = time.perf_counter()
        rows = [{'image': image, 'label': label}
                for image, label in imagenet_like_rows(VIT_ROWS, 384, seed=7)]
        write_dataset(url, imagenet_like_schema(384, image_codec), rows,
                      rowgroup_size_rows=64, workers_count=WRITE_WORKERS,
                      storage_options=REMOTE_TOKEN)
        del rows
        write_s = time.perf_counter() - t0
        parts = sorted(p for p in store.store if p.endswith('.parquet'))
        stored_bytes = sum(store.store[p].size for p in store.store)
        # one epoch from the bucket against one from the local copy
        store.opens.clear()
        fresh_telemetry()
        epoch_s = {}
        t0 = time.perf_counter()
        epoch = {'gs': _pool_rows(url, 'thread', REMOTE_READ_WORKERS,
                                  storage_options=REMOTE_TOKEN)}
        epoch_s['gs'] = time.perf_counter() - t0
        epoch_readahead = _readahead_section()
        epoch_opens = dict(store.opens)
        t0 = time.perf_counter()
        epoch['file'] = _pool_rows(vit_url, 'thread', REMOTE_READ_WORKERS)
        epoch_s['file'] = time.perf_counter() - t0
        # (b) ViT-Base trained from the bucket
        store.seeks.clear()
        store.bytes_read[0] = 0
        launch = flash_attention._launch
        dtypes = collections.Counter()

        def recording_launch(fn, name, pointers, tensors, q, *args):
            dtypes[str(q.dtype)] += 1
            return launch(fn, name, pointers, tensors, q, *args)

        fresh_telemetry()
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        flash_attention._launch = recording_launch
        try:
            result = train_vit_fused(url, steps=REMOTE_VIT_STEPS, batch_size=VIT_BATCH,
                                     device='cuda', storage_options=REMOTE_TOKEN)
            torch.cuda.synchronize()
        finally:
            flash_attention._launch = launch
        launches = launch_counts()
        train_readahead = _readahead_section()
        train_bytes = store.bytes_read[0]
        options = list(store.options)
        seeks = dict(store.seeks)
        refused = list(store.refused)
        store.store.clear()
        store.frozen.clear()
    losses = result['losses']

    # (c) the flagship LM read through an HA nameservice whose first namenode
    # dies, against the same steps from file://; one fetch thread, so nn-a's
    # death is met by one thread and fails over once
    knobs = {'PETASTORM_TPU_READAHEAD_THREADS': '1'}

    def read(dataset_url):
        return flagship_run(dataset_url, knobs_set(knobs), inside=lambda _: {
            'readahead': _readahead_section()}, steps=HDFS_LM_STEPS, reader_pool_type='dummy')

    on_file = read(lm_url)
    connect, record = _namenodes(HDFS_NN_A_OPENS)
    failovers, proxies = [], []

    class Failovers(logging.Handler):
        def emit(self, log_record):
            if log_record.getMessage().startswith('HDFS failover'):
                failovers.append(log_record.getMessage())

    init = hdfs.HAHdfsFilesystem.__init__

    def recording_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        proxies.append(self)

    handler = Failovers()
    logger = logging.getLogger(hdfs.__name__)
    saved_env = {var: os.environ.pop(var, None)
                 for var in ('HADOOP_HOME', 'HADOOP_PREFIX', 'HADOOP_INSTALL')}
    connect_one = hdfs.HdfsConnector._connect_one
    os.environ['HADOOP_HOME'] = _hadoop_home(os.path.join(tmp, 'hadoop'))
    hdfs.HdfsConnector._connect_one = staticmethod(connect)
    hdfs.HAHdfsFilesystem.__init__ = recording_init
    logger.addHandler(handler)
    try:
        on_hdfs = read('hdfs://%s%s' % (HDFS_NAMESERVICE, lm_url[len('file://'):]))
    finally:
        logger.removeHandler(handler)
        hdfs.HAHdfsFilesystem.__init__ = init
        hdfs.HdfsConnector._connect_one = connect_one
        os.environ.pop('HADOOP_HOME')
        os.environ.update({var: value for var, value in saved_env.items() if value is not None})
    active = [p._namenodes[p._active] for p in proxies]

    def multiset(batches):
        return collections.Counter(row for batch in batches for row in batch)

    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(on_hdfs['result']['losses'],
                                                        on_file['result']['losses']))
    emit({'phase': 'remote_store_vit_path', 'config': 'vit-imagenetlike-gs',
          'entry': "train_vit_fused('gs://%s/vit', storage_options=...) -> make_torch_loader "
                   '-> normalize -> ViT-Base' % REMOTE_BUCKET,
          'model': VIT_BASE_KW, 'image_codec': image_codec, 'steps': len(losses),
          'batch_size': VIT_BATCH, 'losses': losses, 'launches': launches,
          'launch_dtypes': dict(dtypes), 'images_per_s': result['images_per_s'],
          'vit_path_images_per_s': vit_images_per_s,
          'over_vit_path': result['images_per_s'] / vit_images_per_s,
          'peak_memory_bytes': torch.cuda.max_memory_allocated(),
          'fused_decode_mode': result['diagnostics']['fused_decode_mode'],
          'consumer_wait_s': result['diagnostics']['consumer_wait_s'],
          'store': {'write_s': write_s, 'rows': VIT_ROWS, 'parts': len(parts),
                    'stored_bytes': stored_bytes, 'train_bytes_read': train_bytes,
                    'epoch_opens': epoch_opens, 'train_seeks': seeks,
                    'options_seen': options[:4], 'instances_built': len(options),
                    'refused': refused},
          'readahead': {'epoch': epoch_readahead, 'train': train_readahead},
          'epoch': {'rows': sum(len(b) for b in epoch['gs']),
                    'multisets_equal': multiset(epoch['gs']) == multiset(epoch['file']),
                    'images_per_s': {k: VIT_ROWS / v for k, v in epoch_s.items()}},
          'hdfs': {'config': 'lm-c4like-flagship over hdfs://%s' % HDFS_NAMESERVICE,
                   'namenodes': list(HDFS_NAMENODES), 'nn_a_opens': HDFS_NN_A_OPENS,
                   'connects': record['connects'], 'opens': dict(record['opens']),
                   'died_in_thread': record['died_in'], 'failovers': failovers,
                   'proxies': len(proxies), 'active_after': active,
                   'steps': HDFS_LM_STEPS, 'losses': on_hdfs['result']['losses'],
                   'file_losses': on_file['result']['losses'], 'max_loss_rel_gap': loss_gap,
                   'batches_equal': on_hdfs['sums'] == on_file['sums'],
                   'launches': on_hdfs['launches'],
                   'tokens_per_s': on_hdfs['result']['tokens_per_s'],
                   'file_tokens_per_s': on_file['result']['tokens_per_s'],
                   'readahead': on_hdfs['readahead']},
          'seconds': time.perf_counter() - t_phase})
    # (b): the bucket's epoch is the local copy's, ViT-Base trained through the kernels
    assert sum(len(b) for b in epoch['gs']) == VIT_ROWS
    assert multiset(epoch['gs']) == multiset(epoch['file'])
    assert len(losses) == REMOTE_VIT_STEPS and all(math.isfinite(v) for v in losses), losses
    assert result['batch_devices'] == ['cuda:0'], result['batch_devices']
    assert launches['normalize_images'] == REMOTE_VIT_STEPS, launches
    want = VIT_BASE_KW['n_layers'] * REMOTE_VIT_STEPS
    for name in FLASH_KERNELS:
        assert launches[name] == want, (name, launches[name], want)
    assert dtypes == {'torch.bfloat16': 3 * want}, dtypes
    # every part opened through the store, read by ranges, the credential seen
    assert parts and set(parts) <= set(epoch_opens), (parts, epoch_opens)
    assert any(path.endswith('.parquet') for path in seeks), seeks
    assert train_bytes > 0
    assert options and all(o == REMOTE_TOKEN for o in options), options
    assert not refused, refused
    assert epoch_readahead['hits'] + train_readahead['hits'] > 0, (epoch_readahead,
                                                                    train_readahead)
    assert not epoch_readahead['degraded'] and not train_readahead['degraded']
    # (c): one failover, the read ended on nn-b, the file:// read's batches and losses
    assert record['died_in'] is not None, record
    assert len(failovers) == 1, failovers
    assert active and set(active) == {HDFS_NAMENODES[1]}, active
    assert on_hdfs['sums'] == on_file['sums']
    hdfs_losses, file_losses = on_hdfs['result']['losses'], on_file['result']['losses']
    assert hdfs_losses == file_losses, (hdfs_losses, file_losses)
    want = FLAGSHIP_LM_KW['n_layers'] * HDFS_LM_STEPS
    for run in (on_hdfs, on_file):
        assert all(run['launches'][name] == want for name in FLASH_KERNELS), run['launches']
        assert run['dtypes'] == {'torch.bfloat16': 3 * want}, run['dtypes']
    left = _threads_left(threads_before)
    assert not left, left
    return {'vit': launches, 'hdfs_lm': on_hdfs['launches']}


def _card_model(model_class, config, *args):
    """``model_class(config, *args)`` built on the card, its weights drawn
    there by ``reset_parameters`` from a card generator seeded 0: the
    library init's order and scales, where ``init_transformer`` and
    ``init_vit`` draw on one host thread. The rank phases build every
    model this way (each compares a split model with one process's model
    from the same draws), and so do the profile phases, whose weights
    only have to be the model's shapes and scales."""
    with torch.device('cuda'):
        model = model_class(config, *args)
        model.reset_parameters(torch.Generator('cuda').manual_seed(0))
    return model.to('cuda')


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
        Transformer, TransformerConfig, adamw, transformer_loss,
    )
    mesh = init_device_mesh('cpu', (DP_RANKS,), mesh_dim_names=('dp',))
    config = TransformerConfig(max_seq_len=LM_SEQ, loss_chunk=256, attn_impl='flash',
                               **FLAGSHIP_LM_KW)
    model = _card_model(Transformer, config)
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
    rank. A rank that dies or outlives ``PARALLEL_TIMEOUT_S`` fails the phase."""
    from petastorm_tpu_torch.etl.dataset_metadata import ParquetDatasetInfo, load_row_groups
    from petastorm_tpu_torch.examples.lm_pretrain import FLAGSHIP_LM_KW
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    results = _run_ranks(_dp_train, (url,), world=DP_RANKS)
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



@contextlib.contextmanager
def _stack_dump_armed():
    """Every thread's stack to stderr each ``PHASE_STACK_DUMP_S`` seconds
    while the block runs, then nothing: a stop leaves the stacks behind.
    It only reports (the block's exceptions pass through)."""
    faulthandler.dump_traceback_later(PHASE_STACK_DUMP_S, repeat=True, exit=False)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()


def _phase(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, one phase of :func:`main`, under the stack
    dump (:func:`_stack_dump_armed`); its wall seconds go to stderr, so a
    run's time can be read phase by phase against the script's limit."""
    t0 = time.perf_counter()
    with _stack_dump_armed():
        result = fn(*args, **kwargs)
    print('phase %s: %.1f s' % (fn.__name__, time.perf_counter() - t0), file=sys.stderr,
          flush=True)
    return result


class _RankPool:
    """``size`` spawned rank processes on the one card that serve every
    rank phase in turn, so torch's import, the CUDA context and the
    kernels' load are paid once for all of them. :meth:`run` hands
    ``body(rank, *args)`` to the first ``world`` ranks, which join a new
    gloo group for it (NCCL refuses two ranks on one GPU) and leave it
    after; their JSON results come back in rank order. ``startup_s`` is
    the seconds until every rank was up, its context on the card made."""

    def __init__(self, size):
        ctx = torch.multiprocessing.get_context('spawn')
        self._dir = tempfile.mkdtemp()
        self._tasks = 0
        self._queues = [ctx.SimpleQueue() for _ in range(size)]
        self._procs = [ctx.Process(target=_parallel_rank,
                                   args=(rank, self._queues[rank], self._dir))
                       for rank in range(size)]
        t0 = time.perf_counter()
        for p in self._procs:
            p.start()
        self._await([os.path.join(self._dir, 'ready%d' % rank) for rank in range(size)],
                    'start-up')
        self.startup_s = time.perf_counter() - t0

    @property
    def pids(self):
        return [p.pid for p in self._procs]

    def run(self, body, args, world):
        """``body``'s results, one a rank. A rank that dies or outlives
        ``PARALLEL_TIMEOUT_S`` fails the task and stops the pool."""
        assert world <= len(self._procs), (world, len(self._procs))
        self._tasks += 1
        task_dir = os.path.join(self._dir, 'task%d' % self._tasks)
        os.makedirs(task_dir)
        for rank in range(world):
            self._queues[rank].put((body, args, world, task_dir))
        paths = [os.path.join(task_dir, 'rank%d.json' % rank) for rank in range(world)]
        self._await(paths, body.__name__)
        results = []
        for path in paths:
            with open(path) as f:
                results.append(json.load(f))
        return results

    def _await(self, paths, what):
        """Until every file of ``paths`` exists; a rank that dies, or
        ``PARALLEL_TIMEOUT_S`` passing, stops the pool and fails."""
        deadline = time.monotonic() + PARALLEL_TIMEOUT_S
        while not all(os.path.exists(path) for path in paths):
            codes = [p.exitcode for p in self._procs]
            if any(code is not None for code in codes) or time.monotonic() > deadline:
                self.stop()
                raise AssertionError('%s: a rank failed or timed out: exit codes %s'
                                     % (what, codes))
            time.sleep(0.2)

    def stop(self):
        """Every rank asked to leave, and one that does not within 10 s
        (a rank stuck in a collective) terminated; nothing is left."""
        for q, p in zip(self._queues, self._procs):
            if p.is_alive():
                q.put(None)
        for p in self._procs:
            p.join(10)
            if p.is_alive():
                p.terminate()
                p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(self._dir, ignore_errors=True)


_rank_pool = None


def _run_ranks(body, args, world=PARALLEL_RANKS):
    """``body(rank, *args)`` on ``world`` ranks of the rank pool, started
    at the first call (``RANK_POOL_SIZE`` ranks); each rank's JSON result,
    in rank order."""
    global _rank_pool
    if _rank_pool is None:
        _rank_pool = _RankPool(RANK_POOL_SIZE)
        print('rank pool: %d ranks up in %.1f s' % (RANK_POOL_SIZE, _rank_pool.startup_s),
              file=sys.stderr, flush=True)
    return _rank_pool.run(body, args, world)


def _stop_rank_pool():
    global _rank_pool
    if _rank_pool is not None:
        _rank_pool.stop()
        _rank_pool = None


def _parallel_rank(rank, tasks, pool_dir):
    """A rank of the pool: pins the card (when there is one) and says so
    in ``pool_dir``, then takes ``(body, args, world, task_dir)`` tasks
    until ``None``. Each task joins
    a gloo group through a file in ``task_dir``, runs ``body`` under the
    stack dump, leaves its result there and leaves the group; the card's
    cached blocks are freed before the next. A task that raises ends the
    rank, with its traceback on stderr."""
    import datetime
    import gc
    import torch.distributed as dist
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if torch.cuda.is_available():
        torch.cuda.set_device(0)
        torch.cuda.synchronize()
    open(os.path.join(pool_dir, 'ready%d' % rank), 'w').close()
    while True:
        task = tasks.get()
        if task is None:
            return
        body, args, world, task_dir = task
        with _stack_dump_armed():
            dist.init_process_group('gloo', init_method='file://' + os.path.join(
                task_dir, 'rendezvous'), rank=rank, world_size=world,
                timeout=datetime.timedelta(seconds=PARALLEL_TIMEOUT_S))
            try:
                result = body(rank, *args)
            finally:
                dist.destroy_process_group()
        path = os.path.join(task_dir, 'rank%d.json' % rank)
        with open(path + '.tmp', 'w') as f:
            json.dump(result, f)
        os.replace(path + '.tmp', path)
        del result
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def _same_on_every_rank(value):
    """Whether every rank of the default group holds the same ``value``."""
    import torch.distributed as dist
    values = [None] * dist.get_world_size()
    dist.all_gather_object(values, value)
    return all(v == values[0] for v in values)


def _grads(model):
    return {name: p.grad.detach() for name, p in model.named_parameters()}


def _grad_errors(grads, reference, shard=None):
    """``{name: max|grad - reference| / max|reference|}``; ``shard(name,
    full)`` cuts a full reference gradient to a tensor-parallel rank's
    part."""
    errors = {}
    for name, grad in grads.items():
        want = reference[name] if shard is None else shard(name, reference[name])
        scale = float(want.abs().max())
        diff = float((grad.float() - want.float()).abs().max())
        errors[name] = diff / scale if scale else diff
    return errors


def _recording_flash_shapes():
    """Wrap ``flash_attention._launch`` to count launches by kernel and
    ``q`` shape; returns the counter and a function that unwraps."""
    from petastorm_tpu_torch.ops import flash_attention
    launch = flash_attention._launch
    shapes = collections.Counter()

    def recording(fn, name, pointers, tensors, q, *args):
        shapes['%s %s' % (name, tuple(q.shape))] += 1
        return launch(fn, name, pointers, tensors, q, *args)

    flash_attention._launch = recording

    def restore():
        flash_attention._launch = launch
    return shapes, restore


def _split_steps(split, full_grads, full_loss, run_step, inputs, per_step, steps=TP_STEPS):
    """The split model's steps, the first held against one process's
    ``full_loss`` and ``full_grads`` (same weights, same inputs): launch,
    collective and peak-memory counts start here; step 2 is profiled for
    the flash kernels' names; steps 2.. are timed. ``inputs(i)`` makes
    step i's arguments (counted launches included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from petastorm_tpu_torch.parallel import collectives
    shapes, restore = _recording_flash_shapes()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    collectives.reset_counts()
    out = {'losses': []}
    try:
        for i in range(steps):
            args = inputs(i)
            if i == 1:
                torch.cuda.synchronize()
                start = time.perf_counter()
            with (profile(activities=[ProfilerActivity.CUDA]) if i == 1
                  else contextlib.nullcontext()) as prof:
                loss = run_step(*args)
                if i == 1:
                    torch.cuda.synchronize()
            if i == 1:
                out['flash_kernel_names'] = sorted(
                    {e.name for e in prof.events() if e.device_type == DeviceType.CUDA
                     and _kernel_kind(e.name) in FLASH_KERNELS})
            if i == 0:
                out['first_loss'] = float(loss)
                out['one_process_loss'] = full_loss
                errors = _grad_errors(_grads(split), full_grads, split.parallel.shard)
                out['grad_errors'] = errors
                out['grad_err_over_max_abs'] = max(errors.values())
                out['worst_grad'] = max(errors, key=errors.get)
                full_grads.clear()
            out['losses'].append(loss)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
    finally:
        restore()
    out['losses'] = [float(v) for v in out['losses']]
    out['rate'] = (steps - 1) * per_step / elapsed
    out['launches'] = launch_counts()
    out['flash_shapes'] = dict(shapes)
    out['collectives'] = collectives.counts()
    out['peak_memory_bytes'] = torch.cuda.max_memory_allocated()
    return out


def _one_process(full, loss_of):
    """One process's loss and gradients (on the card, unsplit)."""
    full.zero_grad(set_to_none=True)
    loss = loss_of(full)
    loss.backward()
    return _grads(full), float(loss)


def _replica_read(url, mesh, workers):
    """One replica's in-order ViT loader over ``REPLICA_READ_BATCHES``
    batches with ``workers`` reader threads (None: the reader's default):
    images/s from the first batch to the last, the pool's worker count,
    and whether every rank read the same rows."""
    from petastorm_tpu_torch.device.loader import make_torch_loader
    from petastorm_tpu_torch.parallel.mesh import DATA_AXIS
    kw = {} if workers is None else {'workers_count': workers}
    sums = []
    with make_torch_loader(url, VIT_BATCH, mesh, (DATA_AXIS,), fields=['^image$', '^label$'],
                           num_epochs=None, shuffle_row_groups=True, device='cuda',
                           **kw) as loader:
        for i, batch in enumerate(loader.iter_steps(REPLICA_READ_BATCHES)):
            sums.append(int(batch['image'].long().sum()))
            if i == 0:
                start = time.perf_counter()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        count = loader.reader._pool.workers_count
    return {'images_per_s': (REPLICA_READ_BATCHES - 1) * VIT_BATCH / elapsed,
            'workers_count': count, 'same_rows': _same_on_every_rank(sums)}


def _tp_train(rank, lm_url, vit_url):
    """One rank's part of ``tp_path``: the flagship and then ViT-Base split
    over a ``(1, 2)`` ``('data', 'model')`` mesh."""
    from petastorm_tpu_torch.device.loader import make_torch_loader
    from petastorm_tpu_torch.examples.imagenet import VIT_BASE_KW, _prepare
    from petastorm_tpu_torch.examples.lm_pretrain import FLAGSHIP_LM_KW, packing_transform
    from petastorm_tpu_torch.models.transformer import (
        Transformer, TransformerConfig, adamw, transformer_loss, transformer_train_step,
    )
    from petastorm_tpu_torch.models.vit import ViT, ViTConfig, vit_loss, vit_train_step
    from petastorm_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh
    mesh = make_mesh(data=1, model=PARALLEL_RANKS, device_type='cuda')
    out = {'rank': rank, 'coordinate': list(mesh.get_coordinate())}

    config = TransformerConfig(max_seq_len=LM_SEQ, loss_chunk=256, attn_impl='flash',
                               **FLAGSHIP_LM_KW)
    with make_torch_loader(lm_url, LM_BATCH, mesh, (DATA_AXIS,), fields=['^tokens$'],
                           transform_spec=packing_transform(LM_SEQ + 1), num_epochs=None,
                           shuffle_row_groups=True, device='cuda') as loader:
        batches = [b['tokens'].clone() for b in loader.iter_steps(TP_STEPS)]
    out['same_rows'] = _same_on_every_rank([int(b.long().sum()) for b in batches])
    full = _card_model(Transformer, config)
    grads, loss = _one_process(full, lambda m: transformer_loss(m, batches[0]))
    del full
    split = _card_model(Transformer, config, mesh)
    step = transformer_train_step(split, adamw(split))
    out['lm'] = _split_steps(split, grads, loss, step, lambda i: (batches[i],),
                             LM_BATCH * LM_SEQ)
    out['lm']['params_per_rank'] = sum(p.numel() for p in split.parameters())
    del split, step, grads
    torch.cuda.empty_cache()

    vit_config = ViTConfig(attn_impl='flash', **VIT_BASE_KW)
    with make_torch_loader(vit_url, VIT_BATCH, mesh, (DATA_AXIS,),
                           fields=['^image$', '^label$'], num_epochs=None,
                           shuffle_row_groups=True, device='cuda') as loader:
        raw = [(b['image'].clone(), b['label'].clone()) for b in loader.iter_steps(TP_STEPS)]
    out['same_images'] = _same_on_every_rank([int(x.long().sum()) for x, _ in raw])
    # the in-order read of a replica: one reader thread against the default
    out['replica_read'] = [_replica_read(vit_url, mesh, w) for w in (1, None)]

    def prepared(seed=1):
        # flips and cutout from one seeded generator, then the normalize kernel
        gen = torch.Generator(device='cuda').manual_seed(seed)
        return lambda i: (_prepare(raw[i][0], gen, True, vit_config.image_size // 8),
                          raw[i][1])

    def vit(m):
        # a head drawn from a seed in place of the init's zeros, so the
        # first step has gradients below the head
        head = torch.Generator().manual_seed(2)
        with torch.no_grad():
            m.head.copy_(torch.randn(m.head.shape, generator=head) * 0.02)
        return m

    full = vit(_card_model(ViT, vit_config))
    images, labels = prepared()(0)
    grads, loss = _one_process(full, lambda m: vit_loss(m, images, labels))
    del full, images
    split = vit(_card_model(ViT, vit_config, mesh))
    step = vit_train_step(split, adamw(split))
    out['vit'] = _split_steps(split, grads, loss, step, prepared(), VIT_BATCH)
    out['vit']['params_per_rank'] = sum(p.numel() for p in split.parameters())
    return out


def _split_flash_shape(model_kw, batch, positions):
    """The ``(B, S, H, D)`` of one rank's flash launches when the heads
    split over ``PARALLEL_RANKS``."""
    heads = model_kw['n_heads']
    return (batch, positions, heads // PARALLEL_RANKS, model_kw['d_model'] // heads)


def phase_tp_path(lm_url, vit_url, lm_tokens_per_s, vit_images_per_s):
    """Tensor parallelism over ``'model'``: the flagship and ViT-Base each
    split over two ranks on the one card (see ``_tp_train``). Held: the
    first step's loss and every gradient shard against one process's
    step; each flash kernel a ``_wgmma`` one, layers x steps launches per
    rank at the split shape; ``TP_STEPS`` normalize launches per rank."""
    from petastorm_tpu_torch.examples.imagenet import VIT_BASE_KW
    from petastorm_tpu_torch.examples.lm_pretrain import FLAGSHIP_LM_KW
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    results = _run_ranks(_tp_train, (lm_url, vit_url))
    seconds = time.perf_counter() - t0
    report = {'phase': 'tp_path', 'mesh': {'data': 1, 'model': PARALLEL_RANKS},
              'entry': 'Transformer/ViT(config, make_mesh(data=1, model=2)) drawn on the '
                       'card, '
                       'transformer_train_step/vit_train_step on a gloo group',
              'steps': TP_STEPS, 'seconds': seconds,
              'coordinates': [r['coordinate'] for r in results]}
    for part, model_kw, shape, rate_name, one_rank in (
            ('lm', FLAGSHIP_LM_KW, _split_flash_shape(FLAGSHIP_LM_KW, LM_BATCH, LM_SEQ),
             'tokens_per_s', lm_tokens_per_s),
            ('vit', VIT_BASE_KW, _split_flash_shape(
                VIT_BASE_KW, VIT_BATCH,
                (VIT_BASE_KW['image_size'] // VIT_BASE_KW['patch_size']) ** 2),
             'images_per_s', vit_images_per_s)):
        runs = [r[part] for r in results]
        first = runs[0]
        loss_gap = abs(first['first_loss'] - first['one_process_loss']) / abs(
            first['one_process_loss'])
        report[part] = {
            'model': model_kw, 'flash_shape': list(shape),
            'loss_rel_gap': [abs(r['first_loss'] - r['one_process_loss'])
                             / abs(r['one_process_loss']) for r in runs],
            'loss_tolerance': 'rel <= %g' % DP_LOSS_RTOL,
            'grad_err_over_max_abs': [r['grad_err_over_max_abs'] for r in runs],
            'worst_grad': [r['worst_grad'] for r in runs],
            'grad_tolerance': 'each max|shard - one process| / max|one process| <= %g'
                              % DP_GRAD_TOL,
            'losses': [r['losses'] for r in runs],
            rate_name + '_per_rank': [r['rate'] for r in runs],
            'one_device_' + rate_name: one_rank,
            'rate_timing': 'steps 2-%d, gloo all-reduces through the host included'
                           % TP_STEPS,
            'peak_memory_bytes_per_rank': [r['peak_memory_bytes'] for r in runs],
            'params_per_rank': [r['params_per_rank'] for r in runs],
            'launches_per_rank': [r['launches'] for r in runs],
            'flash_shapes_per_rank': [r['flash_shapes'] for r in runs],
            'flash_kernel_names': sorted({n for r in runs for n in r['flash_kernel_names']}),
            'collectives_per_rank': [r['collectives'] for r in runs]}
        assert loss_gap <= DP_LOSS_RTOL, (part, loss_gap)
        want = model_kw['n_layers'] * TP_STEPS
        for r in runs:
            assert len(r['losses']) == TP_STEPS and all(math.isfinite(v) for v in r['losses'])
            assert abs(r['first_loss'] - r['one_process_loss']) <= DP_LOSS_RTOL * abs(
                r['one_process_loss']), (part, r['first_loss'], r['one_process_loss'])
            assert r['grad_err_over_max_abs'] <= DP_GRAD_TOL, (part, r['worst_grad'],
                                                               r['grad_err_over_max_abs'])
            for name in FLASH_KERNELS:
                assert r['launches'][name] == want, (part, name, r['launches'][name], want)
            assert all(key.endswith(str(tuple(shape))) for key in r['flash_shapes']), \
                r['flash_shapes']
            assert sum(r['flash_shapes'].values()) == 3 * want, r['flash_shapes']
            assert r['flash_kernel_names'] and all('_wgmma' in n
                                                   for n in r['flash_kernel_names'])
            assert r['collectives']['calls'].get('reduce_from_model', 0) > 0
        assert len({r['params_per_rank'] for r in runs}) == 1
    report['vit_replica_read'] = {
        'images_per_s_per_rank': {'workers_%d' % run['workers_count']: [
            r['replica_read'][i]['images_per_s'] for r in results]
            for i, run in enumerate(results[0]['replica_read'])},
        'timing': '%d ViT batches of %d through make_torch_loader on a (1, 2) mesh, '
                  'in ventilation order, batch 2 to the last' % (REPLICA_READ_BATCHES,
                                                                  VIT_BATCH)}
    emit(report)
    assert all(r['same_rows'] and r['same_images'] for r in results)
    assert all(run['same_rows'] for r in results for run in r['replica_read'])
    for r in results:
        assert r['vit']['launches']['normalize_images'] == TP_STEPS, r['vit']['launches']
        assert r['lm']['launches']['normalize_images'] == 0
    return {name: sum(r[part]['launches'][name] for r in results for part in ('lm', 'vit'))
            for name in (*FLASH_KERNELS, 'normalize_images')}


def _stage_grads(grads, stage):
    """One process's ``grads`` a pipeline ``stage`` holds, under the
    stage's own block numbers."""
    first, per = stage.first_layer, len(stage.blocks)
    out = {}
    for name, grad in grads.items():
        if name.startswith('blocks.'):
            _, index, rest = name.split('.', 2)
            if first <= int(index) < first + per:
                out['blocks.%d.%s' % (int(index) - first, rest)] = grad
        else:
            out[name] = grad
    return out


def _ep_pp_train(rank, lm_url):
    """One rank's part of ``ep_pp_path``: the MoE flagship with its
    experts split over ``'expert'``, then the dense flagship as a 2-stage
    pipeline, each after one process's step from the same init."""
    from petastorm_tpu_torch.device.loader import make_torch_loader
    from petastorm_tpu_torch.examples.lm_pretrain import (
        FLAGSHIP_LM_KW, lm_config, packing_transform,
    )
    from petastorm_tpu_torch.models import transformer
    from petastorm_tpu_torch.parallel.mesh import (
        DATA_AXIS, EXPERT_AXIS, PIPE_AXIS, make_named_mesh,
    )
    ep_mesh = make_named_mesh({DATA_AXIS: 1, EXPERT_AXIS: PARALLEL_RANKS}, device_type='cuda')
    pipe_mesh = make_named_mesh({PIPE_AXIS: PARALLEL_RANKS}, device_type='cuda')
    out = {'rank': rank, 'coordinate': {'ep': list(ep_mesh.get_coordinate()),
                                        'pp': list(pipe_mesh.get_coordinate())}}
    with make_torch_loader(lm_url, LM_BATCH, ep_mesh, (DATA_AXIS,), fields=['^tokens$'],
                           transform_spec=packing_transform(LM_SEQ + 1), num_epochs=None,
                           shuffle_row_groups=True, device='cuda') as loader:
        batches = [b['tokens'].clone() for b in loader.iter_steps(EP_STEPS)]
    out['same_rows'] = _same_on_every_rank([int(b.long().sum()) for b in batches])

    def reference_step(config):
        """One process's step on the first batch. The ranks draw the whole
        model at once, then step in turn: each holds a whole model's
        activations while it runs."""
        import torch.distributed as dist
        full = _card_model(transformer.Transformer, config)
        result = None
        for turn in range(PARALLEL_RANKS):
            if turn == rank:
                result = _one_process(full,
                                      lambda m: transformer.transformer_loss(m, batches[0]))
            dist.barrier()
        del full
        torch.cuda.empty_cache()
        return result

    # (a) expert parallelism; the aux of each forward is recorded
    moe_config = lm_config(LM_SEQ, dict(FLAGSHIP_LM_KW, n_experts=MOE_EXPERTS))
    features, aux = transformer._features_with_aux, []

    def recording_features(model, tokens):
        x, total = features(model, tokens)
        aux.append(float(total.detach()))
        return x, total

    transformer._features_with_aux = recording_features
    try:
        grads, loss = reference_step(moe_config)
        full_aux = aux[-1]
        split = _card_model(transformer.Transformer, moe_config, ep_mesh)
        step = transformer.transformer_train_step(split, transformer.adamw(split))
        aux.clear()
        out['ep'] = _split_steps(split, grads, loss, step, lambda i: (batches[i],),
                                 LM_BATCH * LM_SEQ, steps=EP_STEPS)
    finally:
        transformer._features_with_aux = features
    out['ep'].update(first_aux=aux[0], one_process_aux=full_aux,
                     params_per_rank=sum(p.numel() for p in split.parameters()),
                     experts_per_rank=split.blocks[0].moe.n_local)
    del split, step, grads
    torch.cuda.empty_cache()

    # (b) the pipeline: a stage's gradients against one process's, under
    # the stage's own block numbers
    config = lm_config(LM_SEQ)
    grads, loss = reference_step(config)
    stage = _card_model(transformer.PipelinedTransformer, config, pipe_mesh)
    first, per = stage.first_layer, len(stage.blocks)
    stage_grads = _stage_grads(grads, stage)
    del grads
    step = transformer.pipelined_transformer_train_step(stage, transformer.adamw(stage),
                                                        n_microbatches=PP_MICROBATCHES)
    out['pp'] = _split_steps(stage, stage_grads, loss, step, lambda i: (batches[i],),
                             LM_BATCH * LM_SEQ, steps=EP_STEPS)
    out['pp'].update(first_layer=first, layers=per,
                     params_per_rank=sum(p.numel() for p in stage.parameters()))
    return out


def phase_ep_pp_path(lm_url, lm_tokens_per_s):
    """Expert parallelism and the GPipe pipeline on the one card (see
    ``_ep_pp_train``). Held: each part's first loss against one process's
    step, the MoE aux, the expert weights' (the pipeline: every)
    gradients, the flash kernels' launches per rank and their shape, and
    that each is a ``_wgmma`` one."""
    from petastorm_tpu_torch.examples.lm_pretrain import FLAGSHIP_LM_KW
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    results = _run_ranks(_ep_pp_train, (lm_url,))
    seconds = time.perf_counter() - t0
    heads, d = FLAGSHIP_LM_KW['n_heads'], FLAGSHIP_LM_KW['d_model']
    layers = FLAGSHIP_LM_KW['n_layers']
    parts = {
        'ep': {'mesh': {'data': 1, 'expert': PARALLEL_RANKS},
               'model': dict(FLAGSHIP_LM_KW, n_experts=MOE_EXPERTS),
               'entry': 'Transformer(config, make_named_mesh({data: 1, expert: 2})) '
                        'drawn on the card, '
                        'transformer_train_step',
               'flash_shape': (LM_BATCH, LM_SEQ, heads, d // heads),
               'launches': layers * EP_STEPS},
        'pp': {'mesh': {'pipe': PARALLEL_RANKS}, 'model': FLAGSHIP_LM_KW,
               'n_microbatches': PP_MICROBATCHES,
               'entry': 'PipelinedTransformer(config, make_named_mesh({pipe: 2})) '
                        'drawn on the card, '
                        'pipelined_transformer_train_step(n_microbatches=2)',
               'flash_shape': (LM_BATCH // PP_MICROBATCHES, LM_SEQ, heads, d // heads),
               # a stage's layers, each microbatch once a step: no bubble compute
               'launches': layers // PARALLEL_RANKS * PP_MICROBATCHES * EP_STEPS},
    }
    report = {'phase': 'ep_pp_path', 'steps': EP_STEPS, 'batch_size': LM_BATCH,
              'attention_positions': LM_SEQ, 'seconds': seconds,
              'one_device_tokens_per_s': lm_tokens_per_s,
              'coordinates': [r['coordinate'] for r in results],
              'tolerances': 'loss rel <= %g; aux rel <= %g; gradients max|rank - one process| / '
                            'max|one process| <= %g' % (EP_LOSS_RTOL, EP_AUX_RTOL, EP_GRAD_TOL)}
    for part, spec in parts.items():
        runs = [r[part] for r in results]
        entry = {k: (list(v) if isinstance(v, tuple) else v) for k, v in spec.items()}
        entry.update({
            'loss_rel_gap': [abs(r['first_loss'] - r['one_process_loss'])
                             / abs(r['one_process_loss']) for r in runs],
            'first_loss': [r['first_loss'] for r in runs],
            'one_process_loss': runs[0]['one_process_loss'],
            'grad_err_over_max_abs': [r['grad_err_over_max_abs'] for r in runs],
            'worst_grad': [r['worst_grad'] for r in runs],
            'losses': [r['losses'] for r in runs],
            'tokens_per_s_per_rank': [r['rate'] for r in runs],
            'rate_timing': 'steps 2-%d, host copies of the collectives included' % EP_STEPS,
            'peak_memory_bytes_per_rank': [r['peak_memory_bytes'] for r in runs],
            'params_per_rank': [r['params_per_rank'] for r in runs],
            'launches_per_rank': [r['launches'] for r in runs],
            'flash_shapes_per_rank': [r['flash_shapes'] for r in runs],
            'flash_kernel_names': sorted({n for r in runs for n in r['flash_kernel_names']}),
            'collectives_per_rank': [r['collectives'] for r in runs]})
        if part == 'ep':
            experts = [{k: v for k, v in r['grad_errors'].items()
                        if k.endswith(('.w_in', '.w_out'))} for r in runs]
            entry.update(
                expert_grad_err_over_max_abs=[max(e.values()) for e in experts],
                aux_rel_gap=[abs(r['first_aux'] - r['one_process_aux'])
                             / abs(r['one_process_aux']) for r in runs],
                first_aux=[r['first_aux'] for r in runs],
                one_process_aux=runs[0]['one_process_aux'],
                experts_per_rank=[r['experts_per_rank'] for r in runs])
        else:
            entry.update(first_layer=[r['first_layer'] for r in runs],
                         embed_grad_err_over_max_abs=[r['grad_errors']['embed'] for r in runs])
        report[part] = entry
    emit(report)
    for r in results:
        assert r['same_rows']
        for part, spec in parts.items():
            run = r[part]
            assert len(run['losses']) == EP_STEPS and all(math.isfinite(v)
                                                          for v in run['losses'])
            assert abs(run['first_loss'] - run['one_process_loss']) <= EP_LOSS_RTOL * abs(
                run['one_process_loss']), (part, run['first_loss'], run['one_process_loss'])
            for name in FLASH_KERNELS:
                assert run['launches'][name] == spec['launches'], (
                    part, name, run['launches'][name], spec['launches'])
            assert all(key.endswith(str(spec['flash_shape'])) for key in run['flash_shapes']), \
                (part, run['flash_shapes'])
            assert sum(run['flash_shapes'].values()) == 3 * spec['launches'], run['flash_shapes']
            assert run['flash_kernel_names'] and all('_wgmma' in n
                                                     for n in run['flash_kernel_names'])
        ep, pp = r['ep'], r['pp']
        assert ep['experts_per_rank'] == MOE_EXPERTS // PARALLEL_RANKS
        assert abs(ep['first_aux'] - ep['one_process_aux']) <= EP_AUX_RTOL * abs(
            ep['one_process_aux']), (ep['first_aux'], ep['one_process_aux'])
        for name, err in ep['grad_errors'].items():
            if name.endswith(('.w_in', '.w_out')):
                assert err <= EP_GRAD_TOL, (name, err)
        assert ep['collectives']['calls'].get('reduce_from_model', 0) > 0, ep['collectives']
        assert pp['grad_err_over_max_abs'] <= EP_GRAD_TOL, (pp['worst_grad'],
                                                             pp['grad_err_over_max_abs'])
        assert pp['collectives']['calls'].get('ppermute', 0) > 0, pp['collectives']
    assert sorted(r['pp']['first_layer'] for r in results) == [0, layers // PARALLEL_RANKS]
    return {name: sum(r[part]['launches'][name] for r in results for part in parts)
            for name in FLASH_KERNELS}


def _attention_blocks(rank, mesh):
    """``ring_attention`` and ``ulysses_attention`` alone at (SP_BATCH,
    SP_SEQ, 16, 96) bf16: this rank's block against ``reference_attention``
    on the full sequence, causal."""
    from petastorm_tpu_torch.ops.ring_attention import reference_attention, ring_attention
    from petastorm_tpu_torch.ops.ulysses_attention import ulysses_attention
    gen = torch.Generator(device='cuda').manual_seed(3)
    q, k, v = (torch.randn((SP_BATCH, SP_SEQ, 16, 96), generator=gen, device='cuda').to(
        torch.bfloat16) for _ in range(3))
    n = SP_SEQ // PARALLEL_RANKS
    block = slice(rank * n, (rank + 1) * n)
    want = reference_attention(q, k, v, causal=True)[:, block].float()
    scale = float(want.abs().max())
    out = {}
    for name, fn in (('ring', ring_attention), ('ulysses', ulysses_attention)):
        got = fn(q[:, block], k[:, block], v[:, block], mesh, causal=True)
        torch.cuda.synchronize()
        out[name] = float((got.float() - want).abs().max()) / scale
    return out


def _sp_train(rank, lm_url):
    """One rank's part of ``sp_lm_path``: the attention blocks alone, one
    process's dense step on the full sequence, then the flagship with the
    sequence split, ring and then Ulysses."""
    import dataclasses
    from petastorm_tpu_torch.device.loader import make_torch_loader
    from petastorm_tpu_torch.examples.lm_pretrain import FLAGSHIP_LM_KW, packing_transform
    from petastorm_tpu_torch.models.transformer import (
        Transformer, TransformerConfig, adamw, transformer_loss, transformer_train_step,
    )
    from petastorm_tpu_torch.parallel import collectives
    from petastorm_tpu_torch.parallel.mesh import DATA_AXIS, SEQ_AXIS, make_named_mesh
    mesh = make_named_mesh({DATA_AXIS: 1, SEQ_AXIS: PARALLEL_RANKS}, device_type='cuda')
    out = {'rank': rank, 'coordinate': list(mesh.get_coordinate())}
    out['attention_err_over_max_abs'] = _attention_blocks(rank, mesh)
    with make_torch_loader(lm_url, SP_BATCH, mesh, (DATA_AXIS,), fields=['^tokens$'],
                           transform_spec=packing_transform(SP_SEQ + 1), num_epochs=None,
                           shuffle_row_groups=True, device='cuda') as loader:
        batches = [b['tokens'].clone() for b in loader.iter_steps(SP_STEPS)]
    out['same_rows'] = _same_on_every_rank([int(b.long().sum()) for b in batches])
    dense = TransformerConfig(max_seq_len=SP_SEQ + 1, loss_chunk=256, attn_impl='dense',
                              remat=True, **FLAGSHIP_LM_KW)
    full = _card_model(Transformer, dense)
    reference, reference_loss = _one_process(full, lambda m: transformer_loss(m, batches[0]))
    del full
    first_grads = {}
    for impl in ('ring', 'ulysses'):
        # attn_impl='flash' is ignored with seq_axis set, as in the JAX package
        config = dataclasses.replace(dense, seq_axis=SEQ_AXIS, seq_impl=impl,
                                     attn_impl='flash')
        model = _card_model(Transformer, config, mesh)
        step = transformer_train_step(model, adamw(model))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        collectives.reset_counts()
        losses = []
        for i, tokens in enumerate(batches):
            if i == 1:
                torch.cuda.synchronize()
                start = time.perf_counter()
            losses.append(step(tokens))
            if i == 0:
                errors = _grad_errors(_grads(model), reference)
                run = {'first_loss': float(losses[0]), 'grad_err_over_max_abs':
                       max(errors.values()), 'worst_grad': max(errors, key=errors.get)}
                first_grads[impl] = {n: g.clone() for n, g in _grads(model).items()}
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        run.update(losses=[float(v) for v in losses], launches=launch_counts(),
                   tokens_per_s=(SP_STEPS - 1) * SP_BATCH * SP_SEQ / elapsed,
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   collectives=collectives.counts(), one_process_loss=reference_loss)
        out[impl] = run
        del model, step
        torch.cuda.empty_cache()
    reference.clear()
    ring_vs_ulysses = _grad_errors(first_grads['ulysses'], first_grads['ring'])
    out['ring_vs_ulysses_grad_err'] = max(ring_vs_ulysses.values())
    return out


def phase_sp_lm_path(url, lm_tokens_per_s):
    """Sequence parallelism: the flagship with its 2048 positions split
    over two ranks on the one card (see ``_sp_train``)."""
    from petastorm_tpu_torch.examples.lm_pretrain import FLAGSHIP_LM_KW
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    results = _run_ranks(_sp_train, (url,))
    seconds = time.perf_counter() - t0
    report = {'phase': 'sp_lm_path', 'mesh': {'data': 1, 'seq': PARALLEL_RANKS},
              'entry': "Transformer(TransformerConfig(seq_axis='seq', seq_impl=...), "
                       "make_named_mesh({'data': 1, 'seq': 2})) drawn on the card, transformer_train_step "
                       'on a gloo group', 'model': FLAGSHIP_LM_KW, 'batch_size': SP_BATCH,
              'attention_positions': SP_SEQ, 'positions_per_rank': SP_SEQ // PARALLEL_RANKS,
              'remat': True, 'steps': SP_STEPS, 'seconds': seconds,
              'coordinates': [r['coordinate'] for r in results],
              'attention_err_over_max_abs': [r['attention_err_over_max_abs'] for r in results],
              'attention_tolerance': 'max|block - reference_attention| / max|reference| <= %g'
                                     ' at (%d, %d, 16, 96) bf16' % (SP_ATTN_TOL, SP_BATCH,
                                                                   SP_SEQ),
              'ring_vs_ulysses_grad_err': [r['ring_vs_ulysses_grad_err'] for r in results],
              'flash_launches_why': 'seq_axis set: ring and Ulysses own attention and '
                                    "attn_impl='flash' is ignored, the JAX package's rule",
              'lm_path_tokens_per_s': lm_tokens_per_s}
    for impl in ('ring', 'ulysses'):
        runs = [r[impl] for r in results]
        report[impl] = {
            'loss_rel_gap': [abs(r['first_loss'] - r['one_process_loss'])
                             / abs(r['one_process_loss']) for r in runs],
            'grad_err_over_max_abs': [r['grad_err_over_max_abs'] for r in runs],
            'worst_grad': [r['worst_grad'] for r in runs],
            'losses': [r['losses'] for r in runs],
            'tokens_per_s_per_rank': [r['tokens_per_s'] for r in runs],
            'peak_memory_bytes_per_rank': [r['peak_memory_bytes'] for r in runs],
            'launches_per_rank': [r['launches'] for r in runs],
            'collectives_per_rank': [r['collectives'] for r in runs]}
    report['tolerances'] = ('loss rel <= %g; each gradient max|split - one process| / '
                            'max|one process| <= %g' % (DP_LOSS_RTOL, DP_GRAD_TOL))
    emit(report)
    for r in results:
        assert r['same_rows']
        for name, err in r['attention_err_over_max_abs'].items():
            assert err <= SP_ATTN_TOL, (name, err)
        assert r['ring_vs_ulysses_grad_err'] <= DP_GRAD_TOL, r['ring_vs_ulysses_grad_err']
        assert abs(r['ring']['first_loss'] - r['ulysses']['first_loss']) <= DP_LOSS_RTOL * abs(
            r['ring']['first_loss'])
        for impl in ('ring', 'ulysses'):
            run = r[impl]
            assert len(run['losses']) == SP_STEPS and all(math.isfinite(v)
                                                          for v in run['losses'])
            assert abs(run['first_loss'] - run['one_process_loss']) <= DP_LOSS_RTOL * abs(
                run['one_process_loss']), (impl, run['first_loss'], run['one_process_loss'])
            assert run['grad_err_over_max_abs'] <= DP_GRAD_TOL, (impl, run['worst_grad'],
                                                                 run['grad_err_over_max_abs'])
            for name in FLASH_KERNELS:
                assert run['launches'][name] == 0, (impl, name, run['launches'][name])
            assert run['collectives']['calls'].get(
                'ppermute' if impl == 'ring' else 'all_to_all', 0) > 0, run['collectives']
    return {name: 0 for name in FLASH_KERNELS}

def _uneven_pipe(rank):
    """One rank's part of ``uneven_pipe_path``: per layout, one process's
    loss and gradients (each microbatch through the layered model, then
    their mean), then the pipelined model's on this rank's rows, with the
    flash launches and this rank's microbatch rows."""
    from petastorm_tpu_torch.models import transformer
    from petastorm_tpu_torch.parallel.mesh import make_named_mesh
    out = {}
    for name, (dims, changes, n_micro, batch) in UNEVEN_PIPE_LAYOUTS.items():
        config = transformer.TransformerConfig(**dict(UNEVEN_PIPE_KW, **changes))
        tokens = torch.randint(0, config.vocab_size, (batch, config.max_seq_len),
                               generator=torch.Generator().manual_seed(0)).cuda()
        size = batch // n_micro
        full = transformer.init_transformer(0, config, 'cuda')
        grads, loss = _one_process(full, lambda m: sum(
            transformer.transformer_loss(m, tokens[k * size:(k + 1) * size])
            for k in range(n_micro)) / n_micro)
        del full
        mesh = make_named_mesh(dims, device_type='cuda')
        stage = transformer.init_pipelined_transformer(0, config, mesh, device='cuda')
        par = stage.parallel
        rows = batch // par.dp
        reset_launch_counts()
        got = transformer.pipelined_transformer_loss(
            stage, tokens[par.dp_rank * rows:(par.dp_rank + 1) * rows], n_micro)
        got.backward()
        par.sync_grads(stage)
        torch.cuda.synchronize()
        errors = _grad_errors(_grads(stage), _stage_grads(grads, stage))
        out[name] = {'loss': float(got.detach()), 'one_process_loss': loss,
                     'grad_err_over_max_abs': max(errors.values()),
                     'worst_grad': max(errors, key=errors.get),
                     'microbatch_rows': transformer._microbatch_plan(par, n_micro, rows)[0],
                     'stage_layers': len(stage.blocks), 'launches': launch_counts()}
        del stage, grads
        torch.cuda.empty_cache()
    return out


def phase_uneven_pipe_path():
    """The pipeline layouts whose microbatches straddle the data ranks
    unevenly, on the card with the flash kernels (see ``_uneven_pipe``):
    a rank holding no rows of a microbatch still runs its stage for it
    (the MoE routing is a collective) and launches no kernel on it."""
    t0 = time.perf_counter()
    results = _run_ranks(_uneven_pipe, (), world=UNEVEN_PIPE_RANKS)
    report = {'phase': 'uneven_pipe_path', 'model': {k: str(v) for k, v in
                                                     UNEVEN_PIPE_KW.items()},
              'seconds': time.perf_counter() - t0,
              'tolerance': 'loss rel and gradients max|rank - one process| / max|one process| '
                           '<= %g (f32)' % UNEVEN_PIPE_TOL}
    for name in UNEVEN_PIPE_LAYOUTS:
        report[name] = {key: [r[name][key] for r in results]
                        for key in ('loss', 'one_process_loss', 'grad_err_over_max_abs',
                                    'worst_grad', 'microbatch_rows', 'launches')}
    emit(report)
    totals = {kernel: 0 for kernel in FLASH_KERNELS}
    for name in UNEVEN_PIPE_LAYOUTS:
        assert any(0 in r[name]['microbatch_rows'] for r in results), (name, report[name])
        for r in results:
            run = r[name]
            assert abs(run['loss'] - run['one_process_loss']) <= UNEVEN_PIPE_TOL * abs(
                run['one_process_loss']), (name, run['loss'], run['one_process_loss'])
            assert run['grad_err_over_max_abs'] <= UNEVEN_PIPE_TOL, (name, run['worst_grad'],
                                                                     run['grad_err_over_max_abs'])
            held = sum(1 for n in run['microbatch_rows'] if n)
            for kernel in FLASH_KERNELS:
                assert run['launches'][kernel] == run['stage_layers'] * held, (
                    name, kernel, run['launches'][kernel], run['microbatch_rows'])
                totals[kernel] += run['launches'][kernel]
    return totals


def _split_decode(model, prompt, logits=None):
    """One greedy decode of ``TP_DECODE_NEW`` tokens on a split model:
    the tokens, its K and V caches' bytes, and the collectives it ran with
    their host seconds beside the decode's own."""
    from petastorm_tpu_torch.models import generate
    from petastorm_tpu_torch.parallel import collectives
    kv_bytes = []
    collectives.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = generate._generate(
        model, prompt, TP_DECODE_NEW, None,
        on_logits=None if logits is None else logits.append,
        on_cache=lambda k, v: kv_bytes.append(sum(t.numel() * t.element_size() for t in (k, v))))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(collectives.counts(), decode_seconds=seconds)
    return tokens, kv_bytes[0], counts


def _timed_split_decode(model, prompt, new_tokens):
    """Median host seconds of ``DECODE_RUNS`` greedy decodes of
    ``new_tokens`` on a split model (one untimed decode first), each to its
    last token on the card; the ranks start each decode together."""
    import torch.distributed as dist
    from petastorm_tpu_torch.models.generate import greedy_generate
    greedy_generate(model, prompt, new_tokens)
    samples = []
    for _ in range(DECODE_RUNS):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        greedy_generate(model, prompt, new_tokens)
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
    return statistics.median(samples), samples


def _tp_decode(rank):
    """One rank's part of ``tp_decode_path``: the flagship and its GQA-4
    variant split over ``{'data': 1, 'model': 2}``, decoded greedily and
    sampled at bench.py's decode shape; rank 0 then holds the greedy
    decode's gathered logits against one process's dense forward."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist
    from petastorm_tpu_torch.examples.lm_pretrain import FLAGSHIP_LM_KW, lm_config
    from petastorm_tpu_torch.models import generate
    from petastorm_tpu_torch.models.transformer import Transformer, transformer_forward
    from petastorm_tpu_torch.parallel import collectives
    from petastorm_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(model=PARALLEL_RANKS, device_type='cuda')
    prompt = torch.from_numpy(np.random.RandomState(0).randint(
        0, FLAGSHIP_LM_KW['vocab_size'], (DECODE_BATCH, DECODE_PROMPT)).astype(np.int32))
    out = {'rank': rank, 'coordinate': list(mesh.get_coordinate())}
    config = lm_config(LM_SEQ)
    gqa_config = dataclasses.replace(
        config, n_kv_heads=FLAGSHIP_LM_KW['n_heads'] // DECODE_GQA_GROUP)
    for label, cfg in (('full', config), ('gqa', gqa_config)):
        model = _card_model(Transformer, cfg, mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        logits = [] if label == 'full' else None
        tokens, kv_bytes, counts = _split_decode(model, prompt, logits)
        t_new, runs = _timed_split_decode(model, prompt, TP_DECODE_NEW)
        t_prefill, _ = _timed_split_decode(model, prompt, 1)
        run = {'tokens': tokens.cpu().tolist(), 'kv_cache_bytes': kv_bytes,
               'collective_calls': counts['calls'],
               'host_copy_seconds': counts['host_copy_seconds'],
               'collective_seconds': counts['seconds'],
               'decode_seconds': counts['decode_seconds'],
               'seconds': runs, 'prefill_ms': t_prefill * 1e3,
               'tokens_per_s': DECODE_BATCH * (TP_DECODE_NEW - 1) / (t_new - t_prefill),
               'heads': model.parallel.heads, 'kv_heads': model.parallel.kv_heads}
        if label == 'full':
            sampled = generate.sample_generate(
                model, prompt, TP_DECODE_NEW, torch.Generator('cuda').manual_seed(1),
                temperature=GEN_TEMPERATURE, top_p=GEN_TOP_P)
            run['sampled'] = sampled.cpu().tolist()
        torch.cuda.synchronize()
        run['launches'] = launch_counts()
        run['peak_memory_bytes'] = torch.cuda.max_memory_allocated()
        run['same_tokens'] = _same_on_every_rank(run['tokens'])
        if label == 'full':
            run['same_sampled'] = _same_on_every_rank(run['sampled'])
        out[label] = run
        del model
        torch.cuda.empty_cache()
        if label != 'full':
            continue
        # teacher-forced on rank 0: one process's dense forward over the
        # decoded sequence, the unsplit weights (the same draws)
        if rank == 0:
            full = _card_model(Transformer, dataclasses.replace(config, attn_impl='dense'))
            with torch.no_grad():
                decode_logits = torch.stack(logits, dim=1)                      # (B, N, V)
                forward = transformer_forward(full, tokens[:, :-1])[:, DECODE_PROMPT - 1:]
                scale = forward.abs().max()
                emitted = tokens[:, DECODE_PROMPT:].long()
                gap = forward.max(dim=-1).values - forward.gather(-1, emitted[..., None])[..., 0]
                run['teacher_forced'] = {
                    'logits_err_over_max_abs': float((decode_logits - forward).abs().max()
                                                     / scale),
                    'argmax_equal': int((forward.argmax(dim=-1) == emitted).sum()),
                    'near_ties': int(((gap > 0) & (gap <= DECODE_TOL * scale)).sum()),
                    'outside_tolerance': int((gap > DECODE_TOL * scale).sum()),
                    'tokens': emitted.numel()}
                # one process's cache for the same decode, for the halving gate
                run['one_process_kv_cache_bytes'] = _split_decode(full, prompt)[1]
            del full, forward, decode_logits
            torch.cuda.empty_cache()
        logits = None
        dist.barrier()
    collectives.reset_counts()
    return out


def phase_tp_decode_path():
    """Decoding the flagship split over ``'model'`` on the one card (see
    ``_tp_decode``). Held: both ranks emit the same tokens, greedy and
    sampled, and for GQA-4; the gathered logits within ``DECODE_TOL`` of
    one process's dense forward at every generated position, each token
    its argmax or within the tolerance of it; 0 flash launches; each
    rank's KV cache half of one process's; per decode step ``2 x
    n_layers`` all-reduces and one all-gather of the logits."""
    import numpy as np
    from petastorm_tpu_torch.examples.lm_pretrain import FLAGSHIP_LM_KW
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    results = _run_ranks(_tp_decode, ())
    seconds = time.perf_counter() - t0
    layers = FLAGSHIP_LM_KW['n_layers']
    report = {'phase': 'tp_decode_path', 'config': 'lm-c4like-flagship',
              'model': FLAGSHIP_LM_KW, 'mesh': {'data': 1, 'model': PARALLEL_RANKS},
              'entry': 'Transformer(config, make_mesh(model=2)) drawn on the card, '
                       'greedy_generate, '
                       'sample_generate', 'seconds': seconds,
              'decode_shape': {'batch': DECODE_BATCH, 'prompt': DECODE_PROMPT,
                               'new_tokens': TP_DECODE_NEW, 'runs': DECODE_RUNS,
                               'rate': 'batch x (%d - 1) / (median t%d - median t1)'
                                       % (TP_DECODE_NEW, TP_DECODE_NEW)},
              'sampling': {'temperature': GEN_TEMPERATURE, 'top_p': GEN_TOP_P},
              'coordinates': [r['coordinate'] for r in results],
              'teacher_forced': dict(results[0]['full']['teacher_forced'],
                                     tolerance='max|a - b| / max|b| <= %g; a token off the '
                                               'argmax only within it' % DECODE_TOL),
              'one_process_kv_cache_bytes': results[0]['full']['one_process_kv_cache_bytes']}
    for label in ('full', 'gqa'):
        runs = [r[label] for r in results]
        report[label] = {
            'heads_per_rank': [r['heads'] for r in runs],
            'kv_heads_per_rank': [r['kv_heads'] for r in runs],
            'kv_cache_bytes_per_rank': [r['kv_cache_bytes'] for r in runs],
            'tokens_per_s_per_rank': [r['tokens_per_s'] for r in runs],
            'seconds_per_rank': [r['seconds'] for r in runs],
            'prefill_ms_per_rank': [r['prefill_ms'] for r in runs],
            'peak_memory_bytes_per_rank': [r['peak_memory_bytes'] for r in runs],
            'host_copy_seconds_per_rank': [r['host_copy_seconds'] for r in runs],
            'collective_seconds_per_rank': [r['collective_seconds'] for r in runs],
            'decode_seconds_per_rank': [r['decode_seconds'] for r in runs],
            'collective_calls_per_rank': [r['collective_calls'] for r in runs],
            'launches_per_rank': [r['launches'] for r in runs],
            'same_tokens': runs[0]['same_tokens']}
    report['full']['same_sampled'] = results[0]['full']['same_sampled']
    emit(report)
    tf = report['teacher_forced']
    assert [tuple(c) for c in report['coordinates']] == [(0, 0), (0, 1)], report['coordinates']
    for label, kv_full in (('full', DECODE_KV_BYTES[0]), ('gqa', DECODE_KV_BYTES[1])):
        entry = report[label]
        assert entry['same_tokens'], label
        for r in results:
            run = r[label]
            tokens = np.asarray(run['tokens'])
            assert tokens.shape == (DECODE_BATCH, DECODE_PROMPT + TP_DECODE_NEW), tokens.shape
            assert ((tokens >= 0) & (tokens < FLAGSHIP_LM_KW['vocab_size'])).all()
            assert math.isfinite(run['tokens_per_s']) and run['tokens_per_s'] > 0, run
            for name in FLASH_KERNELS:
                assert run['launches'][name] == 0, (label, name, run['launches'])
            # each rank holds half the K/V heads: half of one process's cache
            assert 2 * run['kv_cache_bytes'] == kv_full, (label, run['kv_cache_bytes'])
            # one all-gather of the logits and a sum over 'model' after each
            # block's attention and FFN, a token (the prefill chooses one)
            assert run['collective_calls'] == {'reduce_from_model': 2 * layers * TP_DECODE_NEW,
                                               'all_gather': TP_DECODE_NEW}, run
    assert report['one_process_kv_cache_bytes'] == DECODE_KV_BYTES[0]
    assert report['full']['same_sampled']
    assert tf['logits_err_over_max_abs'] <= DECODE_TOL, tf
    assert tf['outside_tolerance'] == 0, tf
    return {name: sum(r['full']['launches'][name] + r['gqa']['launches'][name]
                      for r in results) for name in FLASH_KERNELS}


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
    status, probe = _phase(phase_build)
    _phase(phase_pipecheck)
    image_codec = image_codec_for(status, probe)
    kernel = _phase(phase_kernel)
    flash = _phase(phase_flash_kernel)
    _phase(phase_native_decode, status)
    from petastorm_tpu_torch.examples.mnist import generate_synthetic_mnist
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        trace_dir = args.trace_dir or os.path.join(tmp, 'traces')
        os.makedirs(trace_dir, exist_ok=True)
        url = 'file://' + os.path.join(tmp, 'mnist')
        t0 = time.perf_counter()
        _phase(generate_synthetic_mnist, url, num_rows=MNIST_ROWS)
        emit({'phase': 'write', 'rows': MNIST_ROWS, 'seconds': time.perf_counter() - t0})
        _phase(phase_reference, url)
        _phase(phase_lm_reference)
        _phase(phase_lm_reference_bf16)
        _phase(phase_generate_reference)
        main_launches, main_rows_per_s = _phase(phase_main_path, url)
        paths['main_path'] = {'normalize_images': main_launches}
        _phase(phase_row_reference, url)
        paths['pytorch_path'] = {
            'normalize_images': _phase(phase_pytorch_path, url)['normalize_images']}
        paths['batched_bridge_path'] = {
            'normalize_images': _phase(phase_batched_bridge_path, url, main_rows_per_s)[
                'normalize_images']}
        paths['obs_drill_path'] = {
            'normalize_images': _phase(phase_obs_drill_path, url, tmp)['normalize_images']}
        _phase(phase_row_resume, url)
        ngram_url = 'file://' + os.path.join(tmp, 'ngram_timeseries')
        _phase(phase_ngram_path, ngram_url, _phase(write_ngram_dataset, ngram_url))
        lm_url = 'file://' + os.path.join(tmp, 'c4_like')
        _phase(write_lm_dataset, lm_url)
        paths['lm_path'], lm_tokens_per_s = _phase(phase_lm_path, lm_url)
        paths['traced_lm_path'] = _phase(phase_traced_lm_path, lm_url, lm_tokens_per_s,
                                         trace_dir)
        paths['obs_lm_path'] = _phase(phase_obs_lm_path, lm_url, tmp)
        _phase(phase_lm_profile)
        bridge = _phase(phase_bridge_lm, lm_url, lm_tokens_per_s)
        paths['bridge_lm'] = {name: bridge[name] for name in FLASH_KERNELS}
        _phase(phase_varlen_reference, lm_url)
        paths['varlen_path'] = _phase(phase_varlen_path, lm_url)
        _phase(phase_varlen_profile)
        replay_url = 'file://' + os.path.join(tmp, 'c4_like_%d' % REPLAY_DOCS)
        _phase(write_lm_dataset, replay_url, num_docs=REPLAY_DOCS)
        _phase(phase_inmemory_replay, replay_url)
        mixture = _phase(write_mixture_corpora, tmp)
        paths['mixture_path'] = _phase(phase_mixture_path, mixture)
        _phase(phase_mixture_profile, mixture)
        _phase(phase_resume, mixture)
        paths['generate_path'], paths['generate_decode'] = _phase(phase_generate_path, lm_url,
                                                                  tmp)
        paths['moe_path'] = _phase(phase_moe_path, lm_url)
        paths['modern_path'] = _phase(phase_modern_path, tmp)
        vit_url = 'file://' + os.path.join(tmp, 'imagenet_like')
        _phase(write_vit_dataset, vit_url, image_codec)
        _phase(phase_image_reference, vit_url, image_codec)
        paths['vit_path'], vit_images_per_s = _phase(phase_vit_path, vit_url, image_codec)
        paths['traced_vit_path'] = _phase(phase_traced_vit_path, vit_url, image_codec,
                                          vit_images_per_s, trace_dir)
        paths['sanitized_vit_path'] = _phase(phase_sanitized_vit_path, vit_url, image_codec,
                                             vit_images_per_s)
        _phase(phase_sanitize_drill)
        selective_url = 'file://' + os.path.join(tmp, 'vit_selective')
        labels = _phase(write_selective_dataset, selective_url, image_codec)
        paths['selective_vit_path'] = _phase(phase_selective_vit_path, selective_url,
                                             image_codec, labels, vit_images_per_s)
        cached = _phase(phase_decoded_cache_vit_path, vit_url, image_codec, vit_images_per_s,
                        tmp)
        paths['decoded_cache_vit_path'] = cached['launches']
        _phase(phase_chaos_path, vit_url, selective_url, labels, cached['uncached'], tmp)
        paths['readahead_vit_path'] = _phase(phase_readahead_vit_path, vit_url, image_codec,
                                             vit_images_per_s, tmp)
        paths['write_plane_vit_path'] = _phase(phase_write_plane_vit_path, image_codec, tmp)
        paths['etl_tools_vit_path'] = _phase(phase_etl_tools_vit_path, selective_url, tmp)
        paths['process_vit_path'] = _phase(phase_process_vit_path, vit_url, image_codec,
                                           vit_images_per_s, tmp)
        remote = _phase(phase_remote_store_vit_path, vit_url, lm_url, image_codec,
                        vit_images_per_s, tmp)
        paths['remote_store_vit_path'] = remote['vit']
        paths['remote_store_hdfs_lm'] = remote['hdfs_lm']
        # the rank phases, one after another on the rank pool's processes
        try:
            paths['dp_lm_path'] = _phase(phase_dp_lm_path, lm_url, lm_tokens_per_s)
            paths['sp_lm_path'] = _phase(phase_sp_lm_path, lm_url, lm_tokens_per_s)
            paths['tp_path'] = _phase(phase_tp_path, lm_url, vit_url, lm_tokens_per_s,
                                      vit_images_per_s)
            paths['ep_pp_path'] = _phase(phase_ep_pp_path, lm_url, lm_tokens_per_s)
            paths['uneven_pipe_path'] = _phase(phase_uneven_pipe_path)
            paths['tp_decode_path'] = _phase(phase_tp_decode_path)
        finally:
            _stop_rank_pool()
    _phase(phase_vit_profile)
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
                                                'bound_ms', 'max_abs_err', 'empty_launch_ms')},
        # the PyTorch example's batches (pytorch_path): (32, 28, 28, 1) -> f32
        PYTORCH_KERNEL_CASE: dict(
            {k: pytorch_case[k] for k in ('shape', 'out_dtype', 'ms', 'wall_ms', 'timer',
                                          'plain_ms', 'bound_ms', 'bound_by', 'max_abs_err',
                                          'empty_launch_ms')},
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
        for label in (VARLEN_FLASH_CASE, *VARLEN_TAIL_CASES, VIT_FLASH_CASE, *TP_FLASH_CASES,
                      PIPE_FLASH_CASE, FLASH_MAIN_CASE):
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
