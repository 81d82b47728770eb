"""Device stage: Parquet row-groups → ``{field: torch.Tensor}`` batches on
the card.

Counterpart of ``petastorm_tpu/jax/loader.py``. Decoded column batches are
re-batched to a fixed size, optionally row-shuffled, cast per a dtype
policy and staged onto the device by a background thread through the
pinned slot ring of :mod:`petastorm_tpu_torch.device.staging`, ``prefetch``
batches ahead of the consumer. When it can (no row shuffle, the slot ring
on), the loader asks the reader to leave fixed-shape image columns encoded
and the staging fill decodes them straight into the pinned slot's rows
(:mod:`petastorm_tpu_torch.fused`). Checkpoints are delivery-accurate: a
row-group counts as consumed only once every one of its rows reached the
consumer.

Variable-shape fields densify to static shapes with ``pad_ragged=`` or
batch by length with ``bucket_boundaries=`` (one static width per
bucket, each bucket with its own pinned slots), with a ``<field>_len``
column of true sizes; ``inmemory_cache_all=True`` keeps the first pass's
batches on the device and replays them (:class:`InMemoryCachedLoader`).
``mixture=`` feeds the loader packed token rows from a weighted mixture
of datasets (:mod:`petastorm_tpu_torch.mixture`).

The loader runs on the card (``device='cuda'``, the default) unless the
caller asks for the CPU; it never falls back to the CPU on its own.
"""

import contextlib
import logging
import queue
import threading
import time

import numpy as np
import torch

from petastorm_tpu_torch import fused
from petastorm_tpu_torch.device import staging
from petastorm_tpu_torch.mixture import MixtureBatchReader, MixtureStream
from petastorm_tpu_torch.telemetry import (
    STALL_NOTE_FLOOR_S, get_registry, note_consumer_wait, note_producer_wait, obs_server, span,
    tracing,
)
from petastorm_tpu_torch.telemetry.export import _h2d_overlap_share
from petastorm_tpu_torch.telemetry.registry import metric_key
from petastorm_tpu_torch.telemetry.spans import STAGE_SECONDS

logger = logging.getLogger(__name__)

_SENTINEL_END = object()
_NO_ITEM = object()

MASK_FIELD = staging.MASK_FIELD
#: suffix of the true-size column added per pad_ragged/bucket_boundaries field
LEN_SUFFIX = '_len'
# hidden per-row provenance column: maps each row back to the reader pull
# (row-group) it came from; added after the reader, stripped before staging
_PULL_FIELD = '__petastorm_tpu_pull__'


def _object_cells(col, name, policy):
    """An object column as per-row ndarrays (None kept) and its first
    non-None cell, which fixes the cells' dtype and trailing shape."""
    cells = [None if c is None else np.asarray(c) for c in col]
    first = next((c for c in cells if c is not None), None)
    if first is None:
        raise ValueError(
            '%s[%r]: every cell in this batch is None; cell dtype/trailing shape '
            'cannot be inferred. Filter all-null batches, or drop the field'
            % (policy, name))
    return cells, first


def _reserve_len_column(columns, name, policy):
    """The ``<name>_len`` column's name, after checking the batch does not
    already carry one."""
    len_name = name + LEN_SUFFIX
    if len_name in columns:
        raise ValueError('%s would add column %r but the batch already has one; '
                         'rename the source column' % (policy, len_name))
    return len_name


def _densify_ragged(columns, pad_ragged, policy='pad_ragged'):
    """Apply a ``pad_ragged`` policy (``{field: sizes tuple}``) to one
    reader chunk: each variable-shape column becomes a static-shape array
    padded with zeros (or truncated), plus its ``<field>_len`` column of
    true sizes. A None cell densifies to zeros with size 0. A chunk comes
    as an object array from a ragged row-group or as a dense array from
    a uniform one; both give the same static shape. ``policy`` names the
    option in error messages."""
    out = dict(columns)
    for name, targets in pad_ragged.items():
        if name not in out:
            # readers yield a stable schema: a field missing here is a wrong
            # name, and skipping it would emit inconsistent column sets
            raise ValueError(
                '%s field %r is not in the batch (available: %s); check the '
                'name against fields=/the schema'
                % (policy, name, sorted(n for n in columns if n != _PULL_FIELD)))
        len_name = _reserve_len_column(out, name, policy)
        col = out[name]
        k = len(targets)
        n = len(col)
        if n == 0:
            continue
        if col.dtype == object:
            cells, first = _object_cells(col, name, policy)
            trailing = first.shape[k:]
            dense = np.zeros((n,) + targets + trailing, first.dtype)
            lens = np.zeros((n, k), np.int32)
            for i, cell in enumerate(cells):
                if cell is None:
                    continue
                if cell.ndim != k + len(trailing):
                    raise ValueError(
                        '%s[%r]: row has %d dims but the policy names %d '
                        'variable dim(s) over trailing shape %r'
                        % (policy, name, cell.ndim, k, trailing))
                lens[i] = cell.shape[:k]
                clipped = tuple(slice(0, min(cell.shape[d], targets[d])) for d in range(k))
                dense[(i,) + clipped] = cell[clipped]
        else:
            if col.ndim < 1 + k:
                raise ValueError('%s[%r]: dense chunk has %d row dims but the '
                                 'policy names %d variable dim(s)'
                                 % (policy, name, col.ndim - 1, k))
            trailing = col.shape[1 + k:]
            dense = np.zeros((n,) + targets + trailing, col.dtype)
            region = (slice(None),) + tuple(slice(0, min(col.shape[1 + d], targets[d]))
                                            for d in range(k))
            dense[region] = col[region]
            lens = np.broadcast_to(np.asarray(col.shape[1:1 + k], np.int32), (n, k)).copy()
        out[name] = dense
        out[len_name] = lens[:, 0] if k == 1 else lens
    return out


def _split_by_bucket(columns, name, bounds):
    """Split one chunk by field ``name``'s per-row leading length. Yields
    ``(bound, subcolumns)`` with the field densified to ``(rows, bound,
    *trailing)`` and its ``<name>_len`` column of true lengths; rows longer
    than the last bound truncate into the last bucket."""
    col = columns.get(name)
    if col is not None and len(col):
        if col.dtype == object:
            if _object_cells(col, name, 'bucket_boundaries')[1].ndim < 1:
                raise ValueError('bucket_boundaries[%r]: cells are scalars; bucketing '
                                 'needs a leading sequence dim' % name)
        elif col.ndim < 2:
            raise ValueError('bucket_boundaries[%r]: column is scalar per row; '
                             'bucketing needs a leading sequence dim' % name)
    # densify once at the last bound, then cut each bucket's rows to its own
    out = _densify_ragged(columns, {name: (int(bounds[-1]),)}, 'bucket_boundaries')
    len_name = name + LEN_SUFFIX
    if len_name not in out:
        return  # an empty chunk
    # the smallest bound >= the length; longer rows clamp into the last
    bucket_idx = np.minimum(np.searchsorted(bounds, out[len_name], side='left'),
                            len(bounds) - 1)
    for b in np.unique(bucket_idx):
        bound = int(bounds[b])
        rows = np.flatnonzero(bucket_idx == b)
        yield bound, {k: (v[rows, :bound] if k == name else v[rows]) for k, v in out.items()}


def resolve_device(device):
    """``None`` means the card (the current CUDA device, with its index).
    A CUDA device without CUDA raises: the loader never drops to the CPU
    unasked."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'petastorm_tpu_torch runs on the CUDA device by default, but CUDA '
            'is not available; pass device="cpu" to run on the host')
    if device.type not in ('cuda', 'cpu'):
        raise ValueError('device must be a cuda device or "cpu", got %s' % device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    return device


def make_torch_loader(dataset_url_or_urls, batch_size, mesh=None, data_axes=None,
                      fields=None, shuffle_rows=False, shuffling_queue_capacity=None,
                      min_after_retrieve=None, extra_capacity=None, seed=0,
                      last_batch='drop', dtypes=None, prefetch=2, num_epochs=1,
                      inmemory_cache_all=False, pad_ragged=None,
                      bucket_boundaries=None, reader_factory=None, mixture=None,
                      device=None, **reader_kwargs):
    """A :class:`TorchLoader` over a Parquet dataset. The parameters take
    ``make_jax_loader``'s names and positions, with ``device`` last.

    :param batch_size: rows per emitted batch, on this rank.
    :param mesh: a ``torch.distributed.device_mesh.DeviceMesh`` with
        ``mesh_dim_names``, the counterpart of a ``jax.sharding.Mesh``:
        the global batch splits over ``data_axes`` and is replicated over
        the mesh's other dims. The loader only reads the mesh (its names,
        sizes and this rank's coordinate) and runs no collective. Batches
        stay local ``batch_size``-row tensors on this rank; unless the
        reader kwargs give ``cur_shard``/``shard_count``, the rank reads
        the shard of its coordinate over the data dims (ranks that differ
        only on the other dims read the same rows), and :attr:`TorchLoader.sharding`
        gives ``DTensor.from_local`` what it needs to build the global
        batch.
    :param data_axes: mesh dim name(s) the batch splits over (default: all
        of them); ``batch_size`` times the mesh's ranks must divide evenly
        over their shards, which a ``DeviceMesh`` always satisfies.
    :param fields: field name/regex list forwarded to the reader.
    :param shuffle_rows: decorrelate rows across row-groups with a
        :class:`~petastorm_tpu_torch.buffers.BatchedRandomShufflingBuffer`
        seeded from ``seed`` (plus the replay epoch).
    :param last_batch: ``'drop'`` (constant shapes), ``'pad'`` (zero-pad
        plus a ``valid_mask`` bool column) or ``'short'`` (emit the tail).
    :param dtypes: ``{field: numpy or torch dtype}`` casts; see
        :mod:`~petastorm_tpu_torch.device.staging` for where each applies.
    :param prefetch: device batches staged ahead of the consumer.
    :param num_epochs: reader epochs; None = infinite.
    :param inmemory_cache_all: keep the first pass's batches on the device
        and replay them (see :class:`InMemoryCachedLoader`); needs
        ``num_epochs`` 1 or None: re-iterate for more epochs.
    :param pad_ragged: ``{field: size or (sizes...)}``: each variable dim
        of a variable-shape field pads with zeros (or truncates) to a
        static size, and a ``<field>_len`` int32 column carries each row's
        true size(s), ``(B,)`` for one variable dim, ``(B, k)`` for ``k``.
        A truncated row's length exceeds the padded extent, so
        ``arange(L) < len`` masks saturate.
    :param bucket_boundaries: ``{field: [b1, b2, ...]}`` (one field):
        length-bucketed batching. Each row goes to the smallest bound at
        least its leading length (longer rows truncate into the last
        bucket), each bucket fills its own ``batch_size`` batches under
        its own ``last_batch`` policy, and the field pads to the bucket's
        bound, with the ``<field>_len`` column of true lengths. Shapes are
        static per bucket, and each bucket's batches stage through their
        own pinned slots. With ``shuffle_rows`` each bucket keeps its own
        shuffling buffer. A bucket's rows wait until it fills or the
        stream ends. Composes with ``pad_ragged`` on other fields.
    :param reader_factory: reader constructor in place of
        :func:`~petastorm_tpu_torch.reader.make_batch_reader`, called as it
        is; the loader then asks it for no deferred image decode.
    :param mixture: a :class:`petastorm_tpu_torch.mixture.MixtureSpec`:
        feed the loader a deterministic weighted mixture of several
        datasets, packed into rows of ``seq_len`` tokens (``tokens``,
        ``loss_mask`` and ``segment_ids`` int32 columns; the spec needs
        ``seq_len``), in place of one dataset: ``dataset_url_or_urls``
        must then be None, as the sources carry their own URLs.
        ``reader_kwargs`` flow to every source's reader. Each batch is one
        pull of ``batch_size`` rows from the mixture, and the loader's
        ``state_dict`` is the mixture's position, the same JSON as the JAX
        loader's.
    :param device: ``None``/``'cuda'``/``'cuda:N'`` (raises without CUDA)
        or ``'cpu'``.
    :param reader_kwargs: forwarded to the reader factory (pool type,
        ``cur_shard``/``shard_count``, ``shuffle_row_groups``,
        ``filters``, ``predicate``, ...).
    """
    sharding = resolve_mesh(mesh, data_axes, batch_size)
    if sharding is not None and 'cur_shard' not in reader_kwargs \
            and 'shard_count' not in reader_kwargs:
        reader_kwargs['cur_shard'], reader_kwargs['shard_count'] = mesh_shard(*sharding)
    if mixture is not None:
        if dataset_url_or_urls is not None:
            raise ValueError('mixture= and dataset_url_or_urls are mutually '
                             'exclusive: the MixtureSpec sources carry their '
                             'own URLs')
        if reader_factory is not None:
            raise ValueError('mixture= builds its own source readers; give '
                             'per-source factories on the MixtureSource '
                             'entries instead of reader_factory=')
        if fields is not None:
            raise ValueError('mixture= emits fixed packed columns (tokens/'
                             'loss_mask/segment_ids); fields= does not apply')
        if inmemory_cache_all:
            raise ValueError('mixture= does not support inmemory_cache_all')
    elif inmemory_cache_all and num_epochs not in (1, None):
        raise ValueError(
            'inmemory_cache_all caches exactly one epoch and replays it; '
            'pass num_epochs=1 (the default) and re-iterate the loader for '
            'more epochs (got num_epochs=%r)' % (num_epochs,))
    device = resolve_device(device)
    if mixture is not None:
        reader = _mixture_reader(mixture, batch_size, num_epochs, reader_kwargs)
    else:
        if reader_factory is None:
            from petastorm_tpu_torch.reader import make_batch_reader as reader_factory
            # the fused-decode hand-shake: ask for encoded image cells
            # whenever this loader's batch path can decode them into its
            # staging buffers; other cases materialize them in the loader,
            # so asking is never a bet. A custom factory may not know the
            # kwarg.
            reader_kwargs.setdefault(
                'defer_image_decode',
                not shuffle_rows and bucket_boundaries is None
                and staging.staging_enabled())
        reader = reader_factory(dataset_url_or_urls, schema_fields=fields,
                                num_epochs=1 if inmemory_cache_all else num_epochs,
                                **reader_kwargs)
    try:
        loader = TorchLoader(reader, batch_size, device=device,
                             shuffle_rows=shuffle_rows,
                             shuffling_queue_capacity=shuffling_queue_capacity,
                             min_after_retrieve=min_after_retrieve,
                             extra_capacity=extra_capacity, seed=seed,
                             last_batch=last_batch, dtypes=dtypes,
                             prefetch=prefetch, pad_ragged=pad_ragged,
                             bucket_boundaries=bucket_boundaries, sharding=sharding)
    except Exception:
        reader.stop()
        reader.join()
        raise
    if inmemory_cache_all:
        return InMemoryCachedLoader(loader, seed=seed)
    return loader


def resolve_mesh(mesh, data_axes, batch_size):
    """``(mesh, placements)`` for a loader over ``mesh``, or None without
    one: ``Shard(0)`` on the data dims, ``Replicate()`` on the others.
    Raises as ``make_jax_loader`` does: ``KeyError`` for a data axis the
    mesh lacks, ``ValueError`` when the global batch does not divide over
    the data shards. The global batch counts the mesh's own ranks, each
    with ``batch_size`` rows of its shard, so for a ``DeviceMesh`` it always
    divides (a JAX host may drive several devices; a rank drives one)."""
    if mesh is None:
        return None
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names or ())
    if not names:
        raise ValueError('make_torch_loader(mesh=) needs a DeviceMesh with '
                         'mesh_dim_names')
    axes = tuple(data_axes) if data_axes is not None else names
    n_shards = 1
    for a in axes:
        if a not in names:
            raise KeyError(a)
        n_shards *= mesh.size(names.index(a))
    world = int(np.prod([mesh.size(d) for d in range(len(names))]))
    if batch_size * world % max(1, n_shards):
        raise ValueError(
            'global batch (%d per host x %d hosts) must divide evenly '
            'over the %d data shards of mesh axes %s'
            % (batch_size, world, n_shards, axes))
    return mesh, tuple(Shard(0) if name in axes else Replicate() for name in names)


def mesh_shard(mesh, placements):
    """``(cur_shard, shard_count)`` of this rank: its coordinate over the
    mesh's ``Shard`` dims, row-major in mesh dim order (the order
    ``DTensor`` concatenates local batches in). When the data dims hold
    one shard it is ``(0, 1)``, so a live group's rank and world size never
    override the mesh: ranks that differ only on the other dims read the
    same rows."""
    coordinate = mesh.get_coordinate()
    if coordinate is None:
        raise ValueError('this rank is not in the mesh given to make_torch_loader')
    cur, count = 0, 1
    for dim, placement in enumerate(placements):
        if placement.is_shard():
            size = mesh.size(dim)
            cur, count = cur * size + coordinate[dim], count * size
    return cur, count


def _mixture_reader(spec, batch_size, num_epochs, reader_kwargs):
    """The mixture's packed rows as a batched reader: one pull of
    ``batch_size`` rows a batch (the JAX loader's ``mixture=`` build)."""
    stream = MixtureStream(spec, num_epochs=num_epochs, **reader_kwargs)
    try:
        return MixtureBatchReader(stream, rows_per_pull=batch_size)
    except Exception:
        stream.stop()
        stream.join()
        raise


class TorchLoader:
    """Iterator of ``{field: torch.Tensor}`` batches over a batched reader.

    A fully consumed loader may be iterated again: the reader resets and
    the dataset replays, reshuffled wherever shuffling is on.
    """

    def __init__(self, reader, batch_size, device, shuffle_rows=False,
                 shuffling_queue_capacity=None, min_after_retrieve=None,
                 extra_capacity=None, seed=0, last_batch='drop', dtypes=None,
                 prefetch=2, pad_ragged=None, bucket_boundaries=None, sharding=None):
        if last_batch not in ('drop', 'pad', 'short'):
            raise ValueError("last_batch must be 'drop', 'pad' or 'short'; "
                             'got %r' % (last_batch,))
        self._pad_ragged = {
            name: (sizes,) if np.ndim(sizes) == 0 else tuple(sizes)
            for name, sizes in (pad_ragged or {}).items()}
        for name, sizes in self._pad_ragged.items():
            if not all(isinstance(s, (int, np.integer)) and s > 0 for s in sizes):
                raise ValueError('pad_ragged[%r] must be a positive int or tuple of '
                                 'positive ints; got %r' % (name, sizes))
        self._bucket_field = None
        self._bucket_bounds = None
        if bucket_boundaries:
            if len(bucket_boundaries) != 1:
                raise ValueError('bucket_boundaries supports exactly one field; got %s'
                                 % sorted(bucket_boundaries))
            ((name, bounds),) = bucket_boundaries.items()
            bounds = [int(b) for b in bounds]
            if not bounds or bounds != sorted(set(bounds)) or bounds[0] <= 0:
                raise ValueError('bucket_boundaries[%r] must be strictly ascending '
                                 'positive ints; got %r' % (name, bounds))
            if name in self._pad_ragged:
                raise ValueError('field %r cannot be in both pad_ragged and '
                                 'bucket_boundaries (the boundaries define its '
                                 'padding)' % name)
            self._bucket_field = name
            self._bucket_bounds = np.asarray(bounds, np.int64)
        if not getattr(reader, 'batched_output', True):
            raise ValueError('TorchLoader requires a batched reader '
                             '(make_batch_reader), which decodes codec fields too')
        self._reader = reader
        self._batch_size = batch_size
        self._sharding = sharding
        self._device = resolve_device(device)
        self._last_batch = last_batch
        self._dtypes = dict(dtypes or {})
        staging.resolve_cast_policy(self._dtypes)  # reject bad dtypes early
        self._prefetch = max(1, prefetch)
        self._seed = seed
        self._shuffle_rows = shuffle_rows
        self._shuffling_queue_capacity = shuffling_queue_capacity
        self._min_after_retrieve = min_after_retrieve
        self._extra_capacity = extra_capacity
        self._target = (staging.CudaTarget(self._device)
                        if self._device.type == 'cuda' else None)
        self._stager = None
        self._stage_thread = None
        self._out_queue = None
        self._stop_event = threading.Event()
        self._stage_error = None
        self._exhausted = False
        self._drain_lock = threading.Lock()
        # batches drained by __iter__'s boundary probe, served first
        self._leftovers = []
        self._epoch = 0
        self._produce_done = threading.Event()
        # delivery-accurate checkpoint provenance (see state_dict)
        self._prov_lock = threading.Lock()
        self._pull_info = {}        # pull_id -> (epoch, item_index, n_rows)
        self._pull_delivered = {}   # pull_id -> rows delivered so far
        self._delivered_by_epoch = {}
        self._next_pull_id = 0
        # trace context of the latest reader pull (staging thread only): a
        # batch mixes rows of several pulls, so the staging-side events
        # (collate, stage_fill, h2d_*) go to the pull being folded in
        self._last_pull_ctx = None
        self._consumer_wait_s = 0.0
        self._stage_blocked_s = 0.0
        self._batches_delivered = 0
        # the reason this loader last decoded a deferred column itself
        # instead of letting the staging fill fuse it (None: never)
        self._fused_fallback = None
        # the live plane's /health and /report entries; unarmed, a shared
        # no-op handle and no thread or socket
        self._obs_mount = obs_server.mount('torch-loader', health=self._obs_health,
                                           report=self._obs_report)

    # -- iteration -----------------------------------------------------------

    def __iter__(self):
        """Start a pass, resume the pass in progress, or replay the dataset
        when the previous pass is exhausted (``iter(it) is it``)."""
        if self._stage_thread is not None:
            if self._stop_event.is_set():
                raise RuntimeError('TorchLoader was stopped; construct a new '
                                   'loader to iterate again')
            if not self._exhausted:
                # the pass may have ended with its sentinel still in flight:
                # wait until a real batch lands (resume) or the producer is
                # done. _produce_done is set BEFORE the sentinel put, so
                # "queue non-empty while done is unset" means real batches.
                while True:
                    with self._drain_lock:
                        if (self._produce_done.is_set()
                                or not self._stage_thread.is_alive()):
                            pending = list(self._leftovers)
                            self._leftovers = []
                            try:
                                while True:
                                    pending.append(self._out_queue.get_nowait())
                            except queue.Empty:
                                pass
                            if pending == [_SENTINEL_END]:
                                self._exhausted = True
                                break
                            if pending:
                                self._leftovers = pending
                                break
                            if not self._stage_thread.is_alive():
                                break
                        elif self._leftovers or not self._out_queue.empty():
                            if not self._produce_done.is_set():
                                break
                            continue
                    if self._stop_event.is_set():
                        break
                    if self._produce_done.is_set():
                        time.sleep(0.001)  # sentinel put in flight
                    else:
                        self._produce_done.wait(0.05)
                if not self._exhausted:
                    return self
            if self._stage_error is not None:
                raise RuntimeError('TorchLoader cannot restart after a staging '
                                   'error') from self._stage_error
            self._stage_thread.join(timeout=10)
            # replay: restart the fully consumed reader for a fresh pass
            self._reader.reset()
            self._exhausted = False
            self._epoch += 1
            with self._prov_lock:
                self._pull_info.clear()
                self._pull_delivered.clear()
                self._delivered_by_epoch = {}
            with self._drain_lock:
                self._leftovers = []
        self._produce_done = threading.Event()
        self._staging_on = staging.staging_enabled()
        self._stager = staging.StagingEngine(
            self._batch_size, self._dtypes, self._last_batch,
            self._target if self._staging_on else None,
            num_slots=staging.staging_slots(), device=self._device)
        self._out_queue = queue.Queue(maxsize=self._prefetch)
        self._stage_thread = threading.Thread(target=self._stage_loop, daemon=True,
                                              name='petastorm-tpu-torch-stager')
        self._stage_thread.start()
        return self

    def __next__(self):
        if self._out_queue is None:
            iter(self)
        if self._exhausted:
            raise StopIteration
        while True:
            with self._drain_lock:
                item = self._leftovers.pop(0) if self._leftovers else _NO_ITEM
            if item is _NO_ITEM:
                try:
                    t0 = time.monotonic()
                    try:
                        item = self._out_queue.get(timeout=0.1)
                    finally:
                        waited = time.monotonic() - t0
                        self._consumer_wait_s += waited
                        if waited > STALL_NOTE_FLOOR_S:
                            note_consumer_wait(waited)
                except queue.Empty:
                    if self._stage_error is not None:
                        raise self._stage_error
                    if self._stop_event.is_set():
                        self._exhausted = True
                        raise StopIteration
                    with self._drain_lock:
                        if (self._stage_thread is not None
                                and not self._stage_thread.is_alive()
                                and not self._leftovers
                                and self._out_queue.empty()):
                            self._exhausted = True
                            raise StopIteration
                    continue
            if item is _SENTINEL_END:
                self._exhausted = True
                if self._stage_error is not None:
                    raise self._stage_error
                raise StopIteration
            handoff, pull_counts = item
            if pull_counts:
                self._record_delivery(pull_counts)
            self._batches_delivered += 1
            return handoff.deliver()

    def _record_delivery(self, pull_counts):
        """Credit delivered rows to their pulls; a pull whose every row has
        reached the consumer marks its row-group delivered."""
        with self._prov_lock:
            for pull_id, n in pull_counts.items():
                info = self._pull_info.get(pull_id)
                if info is None:
                    continue  # stale (pre-replay) sidecar
                seen = self._pull_delivered.get(pull_id, 0) + n
                if seen >= info[2]:
                    epoch, item_index, _ = info
                    self._delivered_by_epoch.setdefault(epoch, set()).add(item_index)
                    del self._pull_info[pull_id]
                    self._pull_delivered.pop(pull_id, None)
                else:
                    self._pull_delivered[pull_id] = seen

    def iter_steps(self, num_steps):
        """Yield exactly ``num_steps`` batches, continuing across calls and
        replaying across epoch boundaries; raises RuntimeError if a finite
        loader runs dry first (use ``num_epochs=None``)."""
        if self._out_queue is None or self._exhausted:
            iter(self)
        for step in range(num_steps):
            try:
                yield next(self)
                continue
            except StopIteration:
                pass
            # a previous call may have consumed the pass exactly to its
            # end: that is an epoch boundary, so replay and retry
            if (step == 0 and not self._stop_event.is_set()
                    and self._stage_error is None):
                iter(self)
                try:
                    yield next(self)
                    continue
                except StopIteration:
                    pass
            if self._stop_event.is_set():
                raise RuntimeError('loader was stopped after %d of %d steps'
                                   % (step, num_steps))
            raise RuntimeError(
                'loader exhausted after %d of %d steps; use '
                'num_epochs=None so fixed-step epochs never run dry'
                % (step, num_steps)) from None

    # -- staging pipeline (background thread) --------------------------------

    def _make_buffer(self):
        from petastorm_tpu_torch.buffers import (
            BatchedNoopShufflingBuffer, BatchedRandomShufflingBuffer,
        )
        if not self._shuffle_rows:
            return BatchedNoopShufflingBuffer(self._batch_size)
        capacity = self._shuffling_queue_capacity or 4 * self._batch_size
        min_after = (self._min_after_retrieve
                     if self._min_after_retrieve is not None else capacity // 2)
        extra = (self._extra_capacity if self._extra_capacity is not None
                 else capacity)
        # seed offset by the replay epoch: a replay must not repeat epoch 0
        seed = None if self._seed is None else (self._seed + self._epoch) % (2 ** 32)
        return BatchedRandomShufflingBuffer(capacity, min_after, self._batch_size,
                                            extra_capacity=extra, seed=seed)

    def _pull_batches(self):
        """Column dicts from the reader, each row tagged with its pull id."""
        while True:
            try:
                columns, item_index, epoch = self._reader.next_batch_info()
            except StopIteration:
                return
            if tracing.trace_enabled():
                self._last_pull_ctx = tracing.ctx_for(
                    item_index, epoch, getattr(self._reader, 'cur_shard', None))
            n = len(next(iter(columns.values()))) if columns else 0
            with self._prov_lock:
                pull_id = self._next_pull_id
                self._next_pull_id += 1
                self._pull_info[pull_id] = (epoch, item_index, n)
            columns[_PULL_FIELD] = np.full(n, pull_id, np.int64)
            yield columns

    def _stage_loop(self):
        context = (self._target.thread_context() if self._target is not None
                   else contextlib.nullcontext())
        try:
            with context:
                self._stage_buffers()
        except Exception as e:  # noqa: BLE001 - surfaced to the consumer
            self._stage_error = e
        finally:
            self._stager.release()
            # set happens-before put: see __iter__'s boundary probe
            self._produce_done.set()
            self._put_blocking(_SENTINEL_END)

    def _stage_buffers(self):
        """Reader chunks through the re-batching buffers to the stager.
        Unbucketed, one buffer takes every chunk. Bucketed, each chunk
        splits by the bucket field's per-row length, densified to its
        bucket's bound, and each bucket keeps its own buffer; a batch
        emits whenever a buffer fills, and at the end of the stream every
        buffer flushes under the tail policy."""
        buffers = {}
        for columns in self._pull_batches():
            # the staging spans land on the pull just folded in (no-op
            # untraced)
            with tracing.activate(self._last_pull_ctx, track='stager'):
                columns = self._materialize_encoded(columns)
                with span('collate'):
                    # densify before the buffers: a variable field comes as
                    # an object array from a ragged row-group and as a dense
                    # array from a uniform one, and a buffer holds one
                    # static shape
                    if self._pad_ragged:
                        columns = _densify_ragged(columns, self._pad_ragged)
                    if self._bucket_field is None:
                        split = [(None, columns)]
                    else:
                        split = list(_split_by_bucket(columns, self._bucket_field,
                                                      self._bucket_bounds))
                for key, part in split:
                    buf = buffers.get(key)
                    if buf is None:
                        buf = buffers[key] = self._make_buffer()
                    with span('collate'):
                        buf.add_many(part)
                    while buf.can_retrieve:
                        self._retrieve_and_emit(buf)
                        if self._stop_event.is_set():
                            return
            if self._stop_event.is_set():
                return
        for buf in buffers.values():
            buf.finish()
            while buf.can_retrieve:
                self._retrieve_and_emit(buf)
                if self._stop_event.is_set():
                    return

    def _materialize_encoded(self, columns):
        """Decode the deferred image columns this pass cannot fuse: the
        slot ring is off, rows are shuffled (the random buffer gathers
        decoded rows), batching is bucketed, or a ``dtypes=`` cast
        retargets the column (the fill writes the codec's dtype only).
        Still one batched decode per column; each decline is counted by
        reason."""
        out = None
        for name, column in columns.items():
            if not isinstance(column, fused.EncodedImageColumn):
                continue
            if not self._staging_on:
                reason = 'staging-off'
            elif self._shuffle_rows:
                reason = 'shuffled-rows'
            elif self._bucket_field is not None:
                reason = 'bucketed'
            else:
                # a device cast (bf16) applies after the copy, so the slot
                # keeps the codec's dtype and the fill still fuses
                host_cast = staging.resolve_cast_policy(
                    {name: self._dtypes[name]} if name in self._dtypes else {})[0].get(name)
                if host_cast is None or host_cast == column.dtype:
                    continue  # fusable: the staging fill decodes it
                reason = 'dtype-cast'
            if out is None:
                out = dict(columns)
            with span('decode'):
                out[name] = column.materialize()
            fused.count_fallback(reason)
            self._fused_fallback = reason
        return out if out is not None else columns

    def _fused_decode_mode(self):
        """Where image decode ran this pass: ``'fused-into-slot'`` (the
        pinned slot ring), ``'fused-into-slab'`` (fresh assembly),
        ``'batched'`` (worker-side or loader-materialized batch decode), or
        ``'pending'`` before the first delivery says which."""
        stager = self._stager
        if stager is not None and stager.fused_rows:
            return stager.fused_mode
        if self._fused_fallback is not None or self._batches_delivered:
            return 'batched'
        return 'pending'

    def _retrieve_and_emit(self, buf):
        """One batch out of ``buf``: the noop re-batcher hands out chunk
        views the stager copies straight into its slot."""
        with span('collate'):
            if hasattr(buf, 'retrieve_parts'):
                parts = [dict(p) for p in buf.retrieve_parts()]
            else:
                parts = [dict(buf.retrieve())]
            pulls = [p.pop(_PULL_FIELD) for p in parts]
            n = sum(len(pull) for pull in pulls)
            if n < self._batch_size and self._last_batch == 'drop':
                return  # dropped rows: their pulls stay incomplete (sound)
            ids, counts = np.unique(np.concatenate(pulls), return_counts=True)
            pull_counts = dict(zip(ids.tolist(), counts.tolist()))
        handoff = self._stager.stage(parts, n)
        # provenance rides the queue: rows count as delivered only when the
        # consumer receives this item in __next__
        self._put_blocking((handoff, pull_counts))

    def _put_blocking(self, item):
        start = time.monotonic()
        try:
            while not self._stop_event.is_set():
                try:
                    self._out_queue.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue
        finally:
            blocked = time.monotonic() - start
            self._stage_blocked_s += blocked
            if blocked > STALL_NOTE_FLOOR_S:
                note_producer_wait(blocked)

    # -- lifecycle -----------------------------------------------------------

    @property
    def schema(self):
        return self._reader.schema

    @property
    def reader(self):
        return self._reader

    @property
    def device(self):
        return self._device

    @property
    def batch_size(self):
        return self._batch_size

    @property
    def last_batch(self):
        return self._last_batch

    @property
    def shuffle_rows(self):
        return self._shuffle_rows

    @property
    def bucket_field(self):
        """The ``bucket_boundaries`` field, or None."""
        return self._bucket_field

    @property
    def sharding(self):
        """``(mesh, placements)`` for ``DTensor.from_local(batch[name],
        mesh, placements)``, which builds the global batch from the ranks'
        local ones; None without a mesh."""
        return self._sharding

    @property
    def epoch(self):
        """Number of completed replay passes (0 during the first pass)."""
        return self._epoch

    @property
    def diagnostics(self):
        """Reader pool gauges plus the staging layer's: high
        ``consumer_wait_s`` means the input side is slow, high
        ``stage_backpressure_s`` means the training step is."""
        diag = dict(self._reader.diagnostics)
        diag.update({
            'stage_queue_depth': (self._out_queue.qsize()
                                  if self._out_queue is not None else 0),
            'batches_delivered': self._batches_delivered,
            'consumer_wait_s': round(self._consumer_wait_s, 3),
            'stage_backpressure_s': round(self._stage_blocked_s, 3),
            'pulls_in_flight': len(self._pull_info),
            'staging_slots_allocated': (self._stager.slabs_allocated
                                        if self._stager is not None else 0),
            'fused_decode_mode': self._fused_decode_mode(),
            'fused_decode_rows': self._stager.fused_rows if self._stager is not None else 0,
        })
        if self._fused_fallback is not None:
            diag['fused_decode_fallback'] = self._fused_fallback
        return diag

    def pipeline_report(self, wall_time_s=None):
        """Process-wide per-stage breakdown and stall attribution
        (:func:`petastorm_tpu_torch.telemetry.pipeline_report`): the
        reader's worker stages and this loader's staging stages."""
        from petastorm_tpu_torch.telemetry import pipeline_report
        return pipeline_report(wall_time_s=wall_time_s)

    def dump_trace(self, path):
        """Write the per-item trace (ventilate, the worker's stages,
        queue_wait, then collate and staging on the ``stager`` track) as
        Chrome trace-event JSON; needs ``PETASTORM_TPU_TRACE=1`` during
        the run. Returns the number of events written."""
        from petastorm_tpu_torch.telemetry import dump_trace
        return dump_trace(path)

    def state_dict(self):
        """Row-group-granular, at-least-once checkpoint of the position AS
        DELIVERED: rows still in the shuffling buffer or prefetch queue are
        re-read on resume, never skipped. Same shape as the JAX loader's."""
        with self._prov_lock:
            delivered = {epoch: set(items) for epoch, items
                         in self._delivered_by_epoch.items()}
        return self._reader.resume_state_from(delivered)

    def load_state_dict(self, state):
        self._reader.load_state_dict(state)
        with self._prov_lock:
            self._delivered_by_epoch = \
                self._reader.consumption_record_for_resume(state)

    def _obs_health(self):
        """This loader's ``/health`` entry: who waits on whom right now
        (the reader mounts its own entry with the pool's gauges). The
        reference's ``staging_autotune_decisions`` reads 0 until the port
        has the autotuner."""
        slots = self._stager.num_slots if self._stager is not None else 0
        return {
            'epoch': self._epoch,
            'exhausted': self._exhausted,
            'batches_delivered': self._batches_delivered,
            'stage_queue_depth': (self._out_queue.qsize()
                                  if self._out_queue is not None else 0),
            'prefetch': self._prefetch,
            'consumer_wait_s': round(self._consumer_wait_s, 3),
            'stage_backpressure_s': round(self._stage_blocked_s, 3),
            'staging_enabled': self._stager is not None,
            'fused_decode_mode': self._fused_decode_mode(),
            'h2d_overlap_share': self._h2d_overlap_share(),
            'staging_prefetch': self._prefetch,
            'staging_slot_depth': slots,
            'staging_autotune_decisions': 0,
        }

    @staticmethod
    def _h2d_overlap_share():
        """This process's live fill/transfer overlap share (None before
        anything was staged), from the three stage counters directly:
        ``/health`` is polled and must not build a whole report."""
        counters = get_registry().counters_with_prefix(STAGE_SECONDS)
        stages = {stage: {'seconds': counters.get(metric_key(STAGE_SECONDS, {'stage': stage}),
                                                  0.0)}
                  for stage in ('stage_fill', 'h2d_dispatch', 'h2d_ready')}
        return _h2d_overlap_share(stages)

    def _obs_report(self):
        """This loader's ``/report`` entry: its diagnostics (pool and
        staging gauges). The reference's ``autotune`` entry comes with
        the autotuner."""
        return {'torch_loader': self.diagnostics}

    def stop(self):
        self._obs_mount.close()
        self._stop_event.set()
        # stop the reader first: a staging thread blocked in the reader is
        # waiting on it, and the stop event alone cannot wake it
        self._reader.stop()
        if self._stage_thread is not None:
            self._stage_thread.join(timeout=10)
        self._reader.join()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()


class InMemoryCachedLoader:
    """Epoch replay from device memory: read and decode once, train many
    epochs.

    Wraps a single-epoch :class:`TorchLoader`. The first pass streams as
    usual and keeps every delivered batch; later passes serve those
    tensors again, with no Parquet read, no decode and no host-to-device
    copy of data, in a reshuffled order. The whole epoch must fit in the
    device's memory. Replay has no reader position, so there is no
    ``state_dict``.

    Order: each replay draws from ``numpy.random.RandomState(seed +
    replay epoch)``, as the JAX package's loader does. Without
    ``shuffle_rows`` the batch order is shuffled and batch membership
    stays. With ``shuffle_rows`` the epoch's valid rows are pooled on the
    device (once, at the first replay) and re-batched under a fresh
    permutation with ``index_select``; the permutation (8 bytes a row) is
    the one host-to-device copy of such an epoch. Bucketed batches have a
    width per bucket and cannot pool, so they replay in batch order.
    """

    def __init__(self, loader, seed=0):
        self._loader = loader
        self._seed = seed
        self._cache = []
        self._row_cache = None     # field -> one concatenated device tensor
        self._row_count = 0
        self._cache_epoch = None
        self._complete = False
        self._produced_any = False
        self._stopped = False
        self._replay_epoch = 0
        self._steps_iter = None

    def __iter__(self):
        self._check_live()
        if not self._complete:
            return self._first_pass()
        return self._replay()

    def _check_live(self):
        if self._stopped:
            raise RuntimeError('InMemoryCachedLoader was stopped (its cache is '
                               'released); construct a new loader to iterate again')

    def _first_pass(self):
        it = iter(self._loader)
        if self._loader.epoch != self._cache_epoch:
            # the wrapped loader began a new pass (an earlier first-pass
            # generator was dropped at the epoch boundary): batches cached
            # from the stale pass would duplicate every row
            self._cache = []
            self._cache_epoch = self._loader.epoch
        for batch in it:
            self._cache.append(batch)
            self._produced_any = True
            yield batch
        self._complete = True

    def _replay(self):
        self._replay_epoch += 1
        rng = np.random.RandomState(
            None if self._seed is None else (self._seed + self._replay_epoch) % (2 ** 32))
        if self._loader.shuffle_rows and self._loader.bucket_field is None:
            yield from self._replay_rows(rng)
            return
        cache = self._cache
        order = np.arange(len(cache))
        rng.shuffle(order)
        for i in order:
            self._check_live()
            yield cache[i]

    def _ensure_row_cache(self):
        """Pool the cached epoch's valid rows into one device tensor per
        field, releasing the per-batch cache as the pooled copy replaces
        it."""
        if self._row_cache is not None:
            return
        if not self._cache:
            self._row_cache, self._row_count = {}, 0
            return
        names = [n for n in self._cache[0] if n != MASK_FIELD]
        parts = {n: [] for n in names}
        for b in self._cache:
            mask = b.get(MASK_FIELD)
            for n in names:
                parts[n].append(b[n] if mask is None else b[n][mask])
        self._cache = []
        pooled = {}
        try:
            for n in names:
                pooled[n] = torch.cat(parts.pop(n), dim=0)
        except Exception:
            # the per-batch cache is gone: further replays must fail loudly
            self._stopped = True
            raise
        self._row_cache = pooled
        self._row_count = int(next(iter(pooled.values())).shape[0])

    def _replay_rows(self, rng):
        self._ensure_row_cache()
        n = self._row_count
        if n == 0:
            return
        bs = self._loader.batch_size
        policy = self._loader.last_batch
        row_cache = self._row_cache
        device = next(iter(row_cache.values())).device
        perm = torch.from_numpy(rng.permutation(n)).to(device)
        stop = n - (n % bs) if policy == 'drop' else n
        for start in range(0, stop, bs):
            self._check_live()
            idx = perm[start:start + bs]
            k = int(idx.shape[0])
            batch = {name: t.index_select(0, idx) for name, t in row_cache.items()}
            if policy == 'pad':
                if k < bs:
                    batch = {name: torch.cat([t, t.new_zeros((bs - k,) + t.shape[1:])])
                             for name, t in batch.items()}
                batch[MASK_FIELD] = torch.arange(bs, device=device) < k
            yield batch

    def iter_steps(self, num_steps):
        """Exactly ``num_steps`` batches, continuing across calls and epoch
        boundaries (see :meth:`TorchLoader.iter_steps`)."""
        self._check_live()
        it = self._steps_iter
        for _ in range(num_steps):
            while True:
                if it is None:
                    it = iter(self)
                try:
                    yield next(it)
                    break
                except StopIteration:
                    if not self._produced_any:
                        raise RuntimeError(
                            'inmemory_cache_all loader produced no batches; the '
                            "dataset is empty (or every batch was dropped by "
                            "last_batch='drop')") from None
                    it = None
        self._steps_iter = it

    @property
    def schema(self):
        return self._loader.schema

    @property
    def reader(self):
        return self._loader.reader

    @property
    def batch_size(self):
        return self._loader.batch_size

    @property
    def diagnostics(self):
        return self._loader.diagnostics

    def pipeline_report(self, wall_time_s=None):
        """See :meth:`TorchLoader.pipeline_report`."""
        return self._loader.pipeline_report(wall_time_s)

    def dump_trace(self, path):
        """See :meth:`TorchLoader.dump_trace` (replay epochs add no events:
        they never touch the reader)."""
        return self._loader.dump_trace(path)

    def state_dict(self):
        raise RuntimeError(
            'inmemory_cache_all loaders have no checkpointable reader position '
            '(replay epochs never touch the reader); checkpoint the train state '
            'alone and replay the cached epoch on resume')

    def load_state_dict(self, state):
        raise RuntimeError(
            'inmemory_cache_all loaders have no checkpointable reader position to '
            'restore; replay the cached epoch from its start instead')

    def stop(self):
        self._stopped = True
        self._loader.stop()
        self._cache = []
        self._row_cache = None
        # a saved iter_steps cursor over the released cache must not survive
        self._steps_iter = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()
