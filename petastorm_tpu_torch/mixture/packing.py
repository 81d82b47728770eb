"""Token-budget sequence packing: variable-length docs -> fixed rows
(counterpart of ``petastorm_tpu/mixture/packing.py``).

LM pretraining consumes fixed ``(seq_len,)`` rows; Parquet delivers
variable-length token documents. :class:`SequencePacker` bridges them
with greedy first-fit over a *bounded* set of open bins:

* a document is placed whole into the first open bin with room
  (first-fit keeps placement deterministic and O(open_bins));
* when no open bin has room and the open set is below its bound, a new
  bin opens;
* when the open set is at its bound, the document is *split*: a prefix
  fills the oldest open bin exactly (emitting it with zero padding) and
  the tail carries over into a fresh bin — so a bounded open set never
  forces padding mid-stream, it only trades padding for splits;
* ``flush()`` pads and emits whatever is still open at end of stream.

Each emitted row carries three aligned ``(seq_len,)`` arrays:

``tokens``
    the packed token ids, padded with ``pad_id``;
``loss_mask``
    1 for real tokens, 0 for padding — the training loss multiplier;
``segment_ids``
    1-based per-row document segment numbering (0 for padding), the
    input to block-diagonal attention masking so packed documents do
    not attend across boundaries.

Emission order is deterministic: bins emit the moment they fill, in
fill order, and ``flush()`` emits the remaining open bins oldest-first.
Every row therefore has a well-defined global ordinal — the unit at
which the mixture re-shards across consumer counts.

Packing work is accounted under the canonical ``pack`` stage and the
``petastorm_tpu_pack_*`` counters; :attr:`SequencePacker.stats`
summarizes fill ratio, docs/row, and split counts (what
``examples/lm_pretrain.pretrain_mixture`` reports).

Packer state (open-bin contents plus counters) is JSON-safe and small —
it is the "packer carry" leg of the mixture checkpoint.
"""

import numpy as np

from petastorm_tpu_torch.telemetry import get_registry, knobs, metrics_disabled, span

PACK_ROWS = 'petastorm_tpu_pack_rows_total'
PACK_TOKENS = 'petastorm_tpu_pack_tokens_total'
PACK_PADDING_TOKENS = 'petastorm_tpu_pack_padding_tokens_total'
PACK_SPLIT_DOCS = 'petastorm_tpu_pack_split_docs_total'

_STATE_VERSION = 1

#: Default bound on the open-bin set (overridable per instance and via
#: the PETASTORM_TPU_MIXTURE_OPEN_BINS knob).
DEFAULT_OPEN_BINS = 4


class _Bin:
    """One open row under construction: a list of document segments."""

    __slots__ = ('segments',)

    def __init__(self, segments=None):
        self.segments = segments if segments is not None else []

    def used(self):
        return sum(len(s) for s in self.segments)


class SequencePacker:
    """Pack variable-length token documents into fixed ``seq_len`` rows.

    Feed documents with :meth:`feed` (returns zero or more completed
    rows), then :meth:`flush` at end of stream. ``state_dict`` /
    ``load_state_dict`` round-trip the open-bin carry exactly.
    """

    def __init__(self, seq_len, open_bins=None, pad_id=0, dtype=np.int32):
        if int(seq_len) <= 0:
            raise ValueError('seq_len must be positive, got %r' % (seq_len,))
        if open_bins is None:
            open_bins = knobs.get_int(
                'PETASTORM_TPU_MIXTURE_OPEN_BINS', DEFAULT_OPEN_BINS, floor=1)
        if int(open_bins) < 1:
            raise ValueError('open_bins must be >= 1, got %r' % (open_bins,))
        self._seq_len = int(seq_len)
        self._open_bins = int(open_bins)
        self._pad_id = int(pad_id)
        self._dtype = np.dtype(dtype)
        self._bins = []
        # Counters (lifetime of the packer; round-tripped by state_dict).
        self._docs = 0
        self._split_docs = 0
        self._rows = 0
        self._tokens = 0
        self._padding = 0

    # -- packing -----------------------------------------------------------

    @property
    def seq_len(self):
        return self._seq_len

    def feed(self, doc):
        """Pack one document; return the list of rows completed by it."""
        tokens = [int(t) for t in np.asarray(doc).ravel().tolist()]
        if not tokens:
            return []
        with span('pack'):
            return self._feed(tokens)

    def _feed(self, tokens):
        self._docs += 1
        self._tokens += len(tokens)
        emitted = []
        pieces = 0
        while tokens:
            placed = False
            for idx, b in enumerate(self._bins):
                free = self._seq_len - b.used()
                if free >= len(tokens):
                    b.segments.append(tokens)
                    tokens = []
                    if free == len(b.segments[-1]):
                        emitted.append(self._emit(idx))
                    placed = True
                    break
            if placed:
                break
            if len(self._bins) < self._open_bins:
                b = _Bin()
                self._bins.append(b)
                take = min(self._seq_len, len(tokens))
                b.segments.append(tokens[:take])
                tokens = tokens[take:]
                if take == self._seq_len:
                    emitted.append(self._emit(len(self._bins) - 1))
            else:
                # Open set at its bound: fill the oldest bin exactly and
                # carry the tail — padding-free, at the price of a split.
                b = self._bins[0]
                take = self._seq_len - b.used()
                b.segments.append(tokens[:take])
                tokens = tokens[take:]
                emitted.append(self._emit(0))
            pieces += 1
        if pieces > 1:
            self._split_docs += 1
            if not metrics_disabled():
                get_registry().counter(PACK_SPLIT_DOCS).inc()
        return emitted

    def flush(self):
        """Emit (padded) every remaining open bin, oldest first."""
        with span('pack'):
            rows = []
            while self._bins:
                rows.append(self._emit(0, pad=True))
            return rows

    def _emit(self, idx, pad=False):
        b = self._bins.pop(idx)
        tokens = np.full(self._seq_len, self._pad_id, dtype=self._dtype)
        loss_mask = np.zeros(self._seq_len, dtype=np.int32)
        segment_ids = np.zeros(self._seq_len, dtype=np.int32)
        cursor = 0
        for seg_no, seg in enumerate(b.segments, start=1):
            tokens[cursor:cursor + len(seg)] = seg
            loss_mask[cursor:cursor + len(seg)] = 1
            segment_ids[cursor:cursor + len(seg)] = seg_no
            cursor += len(seg)
        padding = self._seq_len - cursor
        if padding and not pad:
            raise AssertionError('non-flush emit of a partially full bin')
        self._rows += 1
        self._padding += padding
        if not metrics_disabled():
            registry = get_registry()
            registry.counter(PACK_ROWS).inc()
            registry.counter(PACK_TOKENS).inc(cursor)
            if padding:
                registry.counter(PACK_PADDING_TOKENS).inc(padding)
        return {
            'tokens': tokens,
            'loss_mask': loss_mask,
            'segment_ids': segment_ids,
        }

    # -- telemetry ---------------------------------------------------------

    @property
    def stats(self):
        """Pack telemetry: rows/docs/tokens, fill ratio, docs per row."""
        emitted_tokens = self._rows * self._seq_len
        real = emitted_tokens - self._padding
        return {
            'rows': self._rows,
            'docs': self._docs,
            'split_docs': self._split_docs,
            'tokens': self._tokens,
            'padding_tokens': self._padding,
            'fill_ratio': (real / emitted_tokens) if emitted_tokens else 0.0,
            'docs_per_row': (self._docs / self._rows) if self._rows else 0.0,
            'carried_tokens': sum(b.used() for b in self._bins),
            'open_bins': len(self._bins),
        }

    # -- state -------------------------------------------------------------

    def state_dict(self):
        return {
            'version': _STATE_VERSION,
            'seq_len': self._seq_len,
            'pad_id': self._pad_id,
            'bins': [[list(seg) for seg in b.segments] for b in self._bins],
            'counters': {
                'docs': self._docs,
                'split_docs': self._split_docs,
                'rows': self._rows,
                'tokens': self._tokens,
                'padding': self._padding,
            },
        }

    def load_state_dict(self, state):
        if int(state.get('version', 0)) != _STATE_VERSION:
            raise ValueError(
                'Unsupported packer state version %r' % (state.get('version'),))
        if int(state['seq_len']) != self._seq_len:
            raise ValueError(
                'Packer state seq_len %r != configured %r' %
                (state['seq_len'], self._seq_len))
        self._bins = [
            _Bin([[int(t) for t in seg] for seg in segments])
            for segments in state['bins']]
        counters = state.get('counters', {})
        self._docs = int(counters.get('docs', 0))
        self._split_docs = int(counters.get('split_docs', 0))
        self._rows = int(counters.get('rows', 0))
        self._tokens = int(counters.get('tokens', 0))
        self._padding = int(counters.get('padding', 0))
