"""MixtureStream: deterministic multi-source document mixing
(counterpart of ``petastorm_tpu/mixture/engine.py``).

The engine composes the subsystem's layers into one iterator:

1. each source's batched reader (``make_batch_reader`` on the dummy or
   thread pool) is wrapped in a :class:`_OrderedDocSource` that
   *resequences* the pool's completion-order deliveries back into the
   ventilator's deterministic order and serves per-row token documents;
2. the :class:`~petastorm_tpu_torch.mixture.interleave.InterleaveSchedule`
   picks the source of every document position arithmetically;
3. the :class:`~petastorm_tpu_torch.mixture.packing.SequencePacker` folds
   the document stream into fixed ``(seq_len,)`` rows (optional: with
   ``seq_len=None`` raw documents stream through);
4. every emitted row gets a **global ordinal**, and a consumer shard
   ``(cur_shard, shard_count)`` delivers exactly the ordinals with
   ``ordinal % shard_count == cur_shard``.

Step 4 is what makes the mixture *elastic*: every rank computes the
same global stream (steps 1-3 are pure functions of the spec), so a
rank's checkpoint is a consistent snapshot of the whole mixture at its
cursor, and :func:`merge_mixture_states` can re-shard a saved run onto
any consumer count by replaying from the earliest snapshot and fast-
forwarding to the aligned resume ordinal. When every rank checkpointed
at the same per-rank delivery count (the training-step-boundary case),
the restored stream is bit-identical to the uninterrupted run; a
mid-step checkpoint degrades to the package-wide at-least-once
contract (rows re-delivered, never lost).

The states are the JAX package's, key for key, so a mixture saved by
either package resumes in the other. Each source's readahead plan scales
its prefetch depth to the source's share. Not ported yet: sources on a
standing decode daemon (item 9).
"""

import logging
import time
from collections import deque

import numpy as np

from petastorm_tpu_torch.errors import unported
from petastorm_tpu_torch.mixture.interleave import InterleaveSchedule
from petastorm_tpu_torch.mixture.packing import SequencePacker
from petastorm_tpu_torch.mixture.spec import MixtureSpec
from petastorm_tpu_torch.telemetry import get_registry, knobs, metrics_disabled, tracing

logger = logging.getLogger(__name__)

MIXTURE_DOCS = 'petastorm_tpu_mixture_docs_total'

_STATE_VERSION = 1

#: Default bound on out-of-order batches a source resequencer may hold
#: (overridable via PETASTORM_TPU_MIXTURE_RESEQ_MAX).
DEFAULT_RESEQ_MAX = 256


def _doc_rows(column):
    """Split one batch's token column into per-row 1-D arrays."""
    arr = column
    if isinstance(arr, np.ndarray) and arr.dtype != object:
        if arr.ndim >= 2:
            return [arr[i].ravel() for i in range(arr.shape[0])]
        # scalar column: each row is a single token
        return [arr[i:i + 1] for i in range(len(arr))]
    return [np.asarray(row).ravel() for row in arr]


class Resequencer:
    """One batched Reader's row-group batches in its ventilation order.

    Pools deliver row-group batches in COMPLETION order — whichever
    worker finishes first — which varies run to run. Batches are
    buffered here by their ``(epoch, item_index)`` provenance
    (``next_batch_info``) and released strictly in the ventilator's
    arithmetic order
    (:meth:`~petastorm_tpu_torch.reader.Reader.ventilation_order`), so
    what a consumer sees is a pure function of the reader's (seed, shard,
    epoch), independent of pool flavor, worker count and scheduling
    jitter. The reorder buffer is bounded (``reseq_max``, default
    ``PETASTORM_TPU_MIXTURE_RESEQ_MAX``): ventilation back-pressure keeps
    in-flight items near the pool size, so the bound trips only on a
    contract violation, and loudly.

    An item that yields no rows (a predicate kept none of them) is
    released as None once the reader reports it
    (``take_zero_row_items``), so an endless read goes on past it.

    ``prepare(columns, item, epoch, started)`` turns each pulled batch
    into what is held and returned (default: the columns), ``started``
    being the ``time.time()`` the pull began at.
    """

    def __init__(self, reader, prepare=None, reseq_max=None, epoch=0):
        if reseq_max is None:
            reseq_max = knobs.get_int('PETASTORM_TPU_MIXTURE_RESEQ_MAX',
                                      DEFAULT_RESEQ_MAX, floor=1)
        self._reader = reader
        self._prepare = prepare
        self._reseq_max = int(reseq_max)
        self.restart(epoch)

    def restart(self, epoch):
        """Start over at ``epoch``'s ventilation order, holding nothing
        (the reader was just reset or restored to that epoch)."""
        self.epoch = epoch
        self._order = deque(self._reader.ventilation_order(epoch))
        self._buffer = {}
        self._drained = False
        # drop what an earlier pass reported (the first call starts the
        # reader's record)
        self._take_zero_rows()

    def _take_zero_rows(self):
        take = getattr(self._reader, 'take_zero_row_items', None)
        return take() if take is not None else []

    def next(self):
        """``((epoch, item), value)`` of the next item in ventilation
        order. ``value`` is None for an item that yielded no rows (known
        when the reader reports it, or once it is drained). Raises
        StopIteration at the end."""
        while True:
            if not self._order:
                if self._drained and not self._buffer:
                    raise StopIteration
                nxt = self.epoch + 1
                epochs = self._reader.num_epochs
                if epochs is not None and nxt >= epochs:
                    if self._drained:
                        raise StopIteration
                else:
                    self.epoch = nxt
                    self._order = deque(self._reader.ventilation_order(nxt))
                    continue
            if self._order:
                key = (self.epoch, self._order[0])
                if key in self._buffer:
                    self._order.popleft()
                    return key, self._buffer.pop(key)
                if self._drained:
                    self._order.popleft()
                    return key, None
            self._pull()

    def _pull(self):
        t0 = time.time()
        try:
            columns, item, epoch = self._reader.next_batch_info()
        except StopIteration:
            self._drained = True
            return
        finally:
            for key in self._take_zero_rows():
                self._buffer[key] = None
        self._buffer[(epoch, item)] = (columns if self._prepare is None
                                       else self._prepare(columns, item, epoch, t0))
        if len(self._buffer) > self._reseq_max:
            raise RuntimeError(
                'Resequencer overflow: %d out-of-order batches '
                'held (bound %d, PETASTORM_TPU_MIXTURE_RESEQ_MAX) waiting '
                'for item %r of epoch %d — the pool is delivering items '
                'the ventilator never ordered'
                % (len(self._buffer), self._reseq_max,
                   self._order[0] if self._order else None, self.epoch))


class _OrderedDocSource:
    """Deterministic per-row document stream over one batched Reader: its
    row-group batches through a :class:`Resequencer`, served row by row,
    so the document sequence any consumer observes is a pure function of
    the reader's (seed, shard, epoch).

    Checkpointing rides the reader's at-least-once machinery: an item is
    recorded consumed only when its LAST row was handed out, and a
    partially-consumed batch checkpoints as ``(item, row_offset)`` so
    resume re-delivers the batch and skips the first ``row_offset``
    rows — exact delivery-granular resume.

    ``source`` is the source's index in the mixture: traced, each pull
    records a ``mixture_pull`` event on the ``mixture-src-<source>`` track
    of the pulled row-group's trace.
    """

    def __init__(self, reader, token_field, reseq_max=None, source=None):
        if not getattr(reader, 'batched_output', False):
            raise ValueError('Mixture sources need batched readers '
                             '(make_batch_reader)')
        self._reader = reader
        self._token_field = token_field
        self._source = source
        self._reseq = Resequencer(reader, self._docs, reseq_max)
        self._delivered = {}
        self._current = None
        self._current_key = None
        self._row = 0
        self._skip_item = None
        self._skip_rows = 0

    @property
    def reader(self):
        return self._reader

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            if self._current is not None:
                if self._row < len(self._current):
                    doc = self._current[self._row]
                    self._row += 1
                    return doc
                epoch, item = self._current_key
                self._delivered.setdefault(epoch, set()).add(item)
                self._current = None
            key, docs = self._reseq.next()
            if docs is None:
                # the pool never produced this item: completed with zero rows
                self._delivered.setdefault(key[0], set()).add(key[1])
                continue
            self._current, self._current_key, self._row = docs, key, 0
            if self._skip_rows and key[1] == self._skip_item:
                self._row = min(self._skip_rows, len(docs))
            self._skip_item, self._skip_rows = None, 0

    def _docs(self, columns, item, epoch, t0):
        if self._source is not None:
            # the pull joins the row-group's lifeline: same trace id as
            # the source reader's worker stages, the source as the shard
            ctx = tracing.ctx_for(item, epoch, shard=self._source)
            if ctx is not None:
                tracing.record_complete('mixture_pull', t0, time.time() - t0, ctx,
                                        track='mixture-src-%d' % self._source)
        column = columns.get(self._token_field)
        if column is None:
            raise KeyError(
                'Mixture token_field %r missing from batch columns %s' %
                (self._token_field, sorted(columns)))
        return _doc_rows(column)

    # -- state -------------------------------------------------------------

    def state_dict(self):
        record = {e: set(items) for e, items in self._delivered.items()}
        partial = None
        if self._current is not None:
            epoch, item = self._current_key
            if self._row >= len(self._current):
                # every row handed out, batch just not advanced past yet:
                # that IS full consumption (the lazy delivered-mark would
                # otherwise re-deliver the whole batch on resume)
                record.setdefault(epoch, set()).add(item)
            else:
                partial = {'epoch': epoch, 'item': item, 'row': self._row}
        state = self._reader.resume_state_from(record)
        return {'reader': state, 'partial': partial}

    def load_state_dict(self, state):
        reader_state = state['reader']
        self._reader.load_state_dict(reader_state)
        record = self._reader.consumption_record_for_resume(reader_state)
        self._delivered = {e: set(items) for e, items in record.items()}
        self._reseq.restart(int(reader_state['epoch']))
        self._current = None
        self._current_key = None
        self._row = 0
        partial = state.get('partial')
        self._skip_item, self._skip_rows = None, 0
        if partial is not None and int(partial['epoch']) == self._reseq.epoch:
            # The partially-consumed batch is re-delivered first (it is
            # the earliest unconsumed item in ventilation order); skip
            # the rows that were already handed out.
            self._skip_item = partial['item']
            self._skip_rows = int(partial['row'])

    def reset(self):
        self._reader.reset()
        self._reseq.restart(0)
        self._delivered = {}
        self._current = None
        self._current_key = None
        self._row = 0
        self._skip_item, self._skip_rows = None, 0

    def stop(self):
        self._reader.stop()

    def join(self):
        self._reader.join()


def build_source_readers(spec, num_epochs=1, reader_pool_type='thread',
                         workers_count=None, shuffle_row_groups=True,
                         **common_kwargs):
    """One reader per :class:`MixtureSource`, mixture-aware.

    Each reader gets a per-source seed derived from the spec seed (so
    two sources over the same files do not march in lock-step) and the
    source's exact interleave share as ``mixture_interleave=``, which
    scales the source's readahead depth. Sources on a standing decode daemon
    (``reader_pool_type='service'``) are ROADMAP item 9.
    """
    from petastorm_tpu_torch.reader import make_batch_reader
    if reader_pool_type == 'service':
        raise unported("mixture sources on a decode daemon (reader_pool_type='service')", 9)
    shares = InterleaveSchedule(spec.weights, seed=spec.seed).fractions
    readers = []
    try:
        for idx, source in enumerate(spec.sources):
            kwargs = dict(common_kwargs)
            kwargs.update(source.reader_kwargs)
            kwargs.setdefault('seed', (spec.seed + idx) % (2 ** 32))
            kwargs.setdefault('shuffle_row_groups', shuffle_row_groups)
            kwargs.setdefault('num_epochs', num_epochs)
            kwargs.setdefault('workers_count', workers_count)
            kwargs.setdefault('mixture_interleave', {
                'source': idx,
                'sources': len(spec.sources),
                'share': shares[idx],
                'seed': spec.seed,
            })
            kwargs.setdefault('reader_pool_type', reader_pool_type)
            if source.reader_factory is not None:
                readers.append(source.reader_factory(**kwargs))
            else:
                readers.append(make_batch_reader(source.url, **kwargs))
    except Exception:
        for reader in readers:
            reader.stop()
            reader.join()
        raise
    return readers


class MixtureStream:
    """Iterator of packed rows (or raw documents) over a weighted mixture.

    With ``spec.seq_len`` set, every item is a dict of three aligned
    ``(seq_len,)`` arrays — ``tokens``, ``loss_mask``, ``segment_ids``
    (see :mod:`petastorm_tpu_torch.mixture.packing`). With ``seq_len=None``,
    items are ``{'tokens': <1-D array>, 'source': <int>}`` raw
    documents. Either way the GLOBAL stream is a pure function of the
    spec, and this consumer delivers the ordinals of its shard.

    The stream ends when the first source exhausts (every remaining
    open bin flushes, padded) — the deterministic analogue of a mixture
    epoch. ``num_epochs=None`` sources never exhaust.
    """

    def __init__(self, spec, num_epochs=1, cur_shard=None, shard_count=None,
                 reader_pool_type='thread', workers_count=None,
                 shuffle_row_groups=True, readers=None, **reader_kwargs):
        if not isinstance(spec, MixtureSpec):
            raise TypeError('spec must be a MixtureSpec, got %r' % (spec,))
        if (cur_shard is None) != (shard_count is None):
            raise ValueError('cur_shard and shard_count must be given '
                             'together')
        self._spec = spec
        self._cur_shard = int(cur_shard) if cur_shard is not None else 0
        self._shard_count = int(shard_count) if shard_count is not None else 1
        if not 0 <= self._cur_shard < self._shard_count:
            raise ValueError('cur_shard %r out of range for shard_count %r'
                             % (cur_shard, shard_count))
        self._schedule = InterleaveSchedule(spec.weights, seed=spec.seed)
        if readers is None:
            readers = build_source_readers(
                spec, num_epochs=num_epochs,
                reader_pool_type=reader_pool_type,
                workers_count=workers_count,
                shuffle_row_groups=shuffle_row_groups, **reader_kwargs)
        elif len(readers) != len(spec.sources):
            raise ValueError('readers has %d entries for %d sources'
                             % (len(readers), len(spec.sources)))
        self._sources = [_OrderedDocSource(r, spec.token_field, source=idx)
                         for idx, r in enumerate(readers)]
        self._packer = None
        if spec.seq_len is not None:
            self._packer = SequencePacker(spec.seq_len,
                                          open_bins=spec.open_bins,
                                          pad_id=spec.pad_id)
        self._pending = deque()
        self._next_ordinal = 0
        self._delivered_local = 0
        self._skip_until = 0
        self._finished = False
        self._source_docs = [0] * len(self._sources)

    # -- iteration ---------------------------------------------------------

    @property
    def spec(self):
        return self._spec

    @property
    def shard_count(self):
        return self._shard_count

    @property
    def cur_shard(self):
        return self._cur_shard

    @property
    def pack_stats(self):
        return self._packer.stats if self._packer is not None else None

    @property
    def source_doc_counts(self):
        """Documents drawn per source so far (realized mix)."""
        return list(self._source_docs)

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            if self._pending:
                ordinal, row = self._pending.popleft()
                if ordinal < self._skip_until:
                    continue  # delivered before an elastic re-shard
                if ordinal % self._shard_count != self._cur_shard:
                    continue  # another consumer's row
                self._delivered_local += 1
                return row
            if self._finished:
                raise StopIteration
            self._produce()

    def _produce(self):
        """Draw one document, pack it, queue any completed rows."""
        src = self._schedule.peek(1)[0]
        try:
            doc = next(self._sources[src])
        except StopIteration:
            # The peeked draw was never delivered: do NOT charge the
            # schedule (the WeightedSamplingReader _draws lesson), so a
            # checkpoint taken at mixture end replays exactly.
            if self._packer is not None:
                for row in self._packer.flush():
                    self._enqueue(row)
            self._finished = True
            return
        self._schedule.next()
        self._source_docs[src] += 1
        if not metrics_disabled():
            get_registry().counter(
                MIXTURE_DOCS, source=self._spec.sources[src].name).inc()
        if self._packer is None:
            self._enqueue({'tokens': np.asarray(doc), 'source': src})
        else:
            for row in self._packer.feed(doc):
                self._enqueue(row)

    def _enqueue(self, row):
        self._pending.append((self._next_ordinal, row))
        self._next_ordinal += 1

    # -- checkpoint / elastic resume ---------------------------------------

    def state_dict(self):
        """Consistent GLOBAL snapshot at this consumer's cursor.

        JSON-safe. Restorable onto any shard layout: the snapshot
        regenerates every global ordinal from its earliest pending row
        onward, so a different consumer count simply re-deals the
        ordinals (see :func:`merge_mixture_states`).
        """
        pending = []
        for ordinal, row in self._pending:
            pending.append({
                'ordinal': ordinal,
                'row': {key: np.asarray(value).ravel().tolist()
                        if isinstance(value, np.ndarray) else int(value)
                        for key, value in row.items()},
            })
        return {
            'version': _STATE_VERSION,
            'mixture': self._spec.fingerprint(),
            'interleave': self._schedule.state_dict(),
            'packer': (self._packer.state_dict()
                       if self._packer is not None else None),
            'pending': pending,
            'next_ordinal': self._next_ordinal,
            'delivered_local': self._delivered_local,
            'finished': self._finished,
            'source_docs': list(self._source_docs),
            'sources': [source.state_dict() for source in self._sources],
            'shard_count': self._shard_count,
            'cur_shard': self._cur_shard,
        }

    def load_state_dict(self, state):
        if int(state.get('version', 0)) != _STATE_VERSION:
            raise ValueError('Unsupported mixture state version %r'
                             % (state.get('version'),))
        if state.get('mixture') != self._spec.fingerprint():
            raise ValueError(
                'Mixture state fingerprint %r does not match this spec '
                '(%r): the checkpoint was taken under different sources, '
                'weights, seed or packing geometry'
                % (state.get('mixture'), self._spec.fingerprint()))
        self._schedule.load_state_dict(state['interleave'])
        if self._packer is not None:
            self._packer.load_state_dict(state['packer'])
        for source, src_state in zip(self._sources, state['sources']):
            source.load_state_dict(src_state)
        self._pending = deque()
        for entry in state['pending']:
            row = {}
            for key, value in entry['row'].items():
                if key == 'source':
                    row[key] = int(value)
                else:
                    dtype = np.int32 if key != 'tokens' else (
                        self._packer._dtype if self._packer is not None
                        else np.int64)
                    row[key] = np.asarray(value, dtype=dtype)
            self._pending.append((int(entry['ordinal']), row))
        self._next_ordinal = int(state['next_ordinal'])
        self._finished = bool(state['finished'])
        self._source_docs = [int(n) for n in state['source_docs']]
        # resume_ordinal is stamped by merge_mixture_states: everything
        # below it was already delivered (by some rank, under the old
        # layout). A per-shard state replays exactly, so default 0.
        self._skip_until = int(state.get('resume_ordinal', 0))
        if 'resume_ordinal' in state:
            # Seed the delivery count with the pre-resume ordinals that
            # BELONG to this shard under the new layout — a later merge
            # (a second reshard) then recomputes the same global cursor
            # instead of rewinding below it.
            skip, m, r = self._skip_until, self._shard_count, self._cur_shard
            self._delivered_local = skip // m + (1 if skip % m > r else 0)
        else:
            self._delivered_local = int(state.get('delivered_local', 0))

    def reset(self):
        """Restart the mixture sweep (valid once every source drained)."""
        for source in self._sources:
            source.reset()
        self._schedule.reset()
        if self._packer is not None:
            self._packer = SequencePacker(self._spec.seq_len,
                                          open_bins=self._spec.open_bins,
                                          pad_id=self._spec.pad_id)
        self._pending = deque()
        self._next_ordinal = 0
        self._delivered_local = 0
        self._skip_until = 0
        self._finished = False
        self._source_docs = [0] * len(self._sources)

    # -- lifecycle ---------------------------------------------------------

    def stop(self):
        for source in self._sources:
            source.stop()

    def join(self):
        for source in self._sources:
            source.join()

    @property
    def diagnostics(self):
        diag = {
            'mixture_sources': len(self._sources),
            'mixture_next_ordinal': self._next_ordinal,
            'mixture_delivered_local': self._delivered_local,
            'mixture_source_docs': list(self._source_docs),
        }
        if self._packer is not None:
            diag['pack_stats'] = self._packer.stats
        return diag


def merge_mixture_states(states):
    """Fold per-rank mixture states into one elastically-restorable state.

    Every rank's state is a full-stream snapshot, so the merge only has
    to pick the earliest one (its replay covers every later cursor) and
    compute the resume ordinal: rank ``r`` having delivered ``n_r``
    rows has delivered exactly the ordinals ``r, r+M, ...,
    r+(n_r-1)*M``, so the earliest ordinal NOT delivered by anyone is
    ``min_r(r + n_r * M)``. The restored stream fast-forwards to that
    ordinal and re-deals the rest under the new layout — bit-identical
    when the ``n_r`` are equal (checkpoints taken at a train-step
    boundary), at-least-once otherwise (the faster ranks' extra rows
    are re-delivered, never lost).
    """
    states = list(states)
    if not states:
        raise ValueError('No mixture states to merge')
    fingerprints = {s.get('mixture') for s in states}
    if len(fingerprints) != 1:
        raise ValueError('Cannot merge states of different mixtures: %s'
                         % sorted(fingerprints))
    shard_counts = {int(s['shard_count']) for s in states}
    if len(shard_counts) != 1:
        raise ValueError('Cannot merge states with mixed shard_count: %s'
                         % sorted(shard_counts))
    shard_count = shard_counts.pop()
    shards = sorted(int(s['cur_shard']) for s in states)
    if shards != list(range(shard_count)):
        raise ValueError('Need one state per shard 0..%d, got shards %s'
                         % (shard_count - 1, shards))
    delivered = {int(s['cur_shard']): int(s.get('delivered_local', 0))
                 for s in states}
    if len(set(delivered.values())) != 1:
        logger.warning(
            'Merging mixture states with unequal per-rank delivery counts '
            '%s: resume is at-least-once (rows beyond the minimum are '
            're-delivered)', [delivered[r] for r in sorted(delivered)])
    resume_ordinal = min(r + n * shard_count for r, n in delivered.items())
    # The earliest snapshot (smallest production cursor) can regenerate
    # every ordinal >= its first pending row, which is always <= the
    # aligned resume ordinal.
    def cursor(s):
        pending = s.get('pending') or []
        first = min((int(p['ordinal']) for p in pending),
                    default=int(s['next_ordinal']))
        return first
    base = min(states, key=cursor)
    if cursor(base) > resume_ordinal:
        raise ValueError(
            'No merged state can regenerate ordinal %d (earliest snapshot '
            'starts at %d) — states were not taken from one consistent run'
            % (resume_ordinal, cursor(base)))
    merged = dict(base)
    merged['resume_ordinal'] = resume_ordinal
    merged.pop('delivered_local', None)
    merged.pop('shard_count', None)
    merged.pop('cur_shard', None)
    return merged
