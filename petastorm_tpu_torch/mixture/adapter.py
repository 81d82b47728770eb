"""MixtureBatchReader: the reader-shaped face of a MixtureStream
(counterpart of ``petastorm_tpu/mixture/adapter.py``).

``make_torch_loader(mixture=...)`` needs the mixture to look like a
batched reader: ``batched_output``, ``next_batch_info`` provenance, the
``resume_state_from`` / ``consumption_record_for_resume`` resume
protocol, ``reset/stop/join/diagnostics/schema``. This adapter provides
exactly that surface over a :class:`~petastorm_tpu_torch.mixture.engine.
MixtureStream` of packed rows.

Provenance here is *pull ordinals*, not row-group items: each
``next_batch_info`` call fixes ``rows_per_pull`` packed rows into one
batch and tags it with a monotonically increasing pull id (epoch is
always 0; the mixture's own epoch arithmetic lives in its sources).
Before producing pull ``k`` the adapter snapshots the stream's
``state_dict``; ``resume_state_from(delivered)`` then answers the
loader's delivery-accurate checkpoint question ("rewind to the earliest
pull the consumer has NOT fully received") by returning that pull's
pre-snapshot. Snapshots are bounded (``snapshot_window`` pulls): the
loader's buffering is bounded by prefetch and shuffle capacity, so a
window of a few hundred pulls covers it, with a loud error past it.

Resume is exact when the loader delivers pulls in order (no row
shuffling); a shuffling loader interleaves rows of different pulls, so
its delivered set can have gaps and resume degrades to the package-wide
at-least-once contract. The state is the JAX adapter's, so a loader
state saved by ``make_jax_loader(mixture=)`` resumes here and back.
"""

import numpy as np

from petastorm_tpu_torch.mixture.engine import MixtureStream

#: How many per-pull stream snapshots resume_state_from can rewind to.
DEFAULT_SNAPSHOT_WINDOW = 512


class _MixtureSchema:
    """Minimal schema surface: named fields, no codecs."""

    def __init__(self, names):
        self.fields = {name: None for name in names}

    def make_namedtuple(self, **kwargs):
        raise TypeError('Mixture batches are plain dicts, not namedtuples')


class MixtureBatchReader:
    """Batched-reader adapter over a :class:`MixtureStream`."""

    batched_output = True
    ngram = None

    def __init__(self, stream, rows_per_pull=64,
                 snapshot_window=DEFAULT_SNAPSHOT_WINDOW):
        if not isinstance(stream, MixtureStream):
            raise TypeError('stream must be a MixtureStream, got %r'
                            % (stream,))
        if stream.spec.seq_len is None:
            raise ValueError(
                'make_torch_loader(mixture=...) needs packed rows: give the '
                'MixtureSpec a seq_len (raw ragged documents cannot batch)')
        self._stream = stream
        self._rows = max(1, int(rows_per_pull))
        self._window = max(1, int(snapshot_window))
        self._schema = _MixtureSchema(('tokens', 'loss_mask', 'segment_ids'))
        self._snapshots = {}
        self._next_pull = 0
        self.last_row_consumed = False
        self._stopped = False

    # -- reader surface ----------------------------------------------------

    @property
    def schema(self):
        return self._schema

    @property
    def stream(self):
        return self._stream

    @property
    def cur_shard(self):
        return self._stream.cur_shard

    @property
    def shard_count(self):
        return self._stream.shard_count

    @property
    def num_epochs(self):
        return 1

    @property
    def diagnostics(self):
        return dict(self._stream.diagnostics)

    def __iter__(self):
        return self

    def __next__(self):
        columns, _, _ = self.next_batch_info()
        return columns

    def next_batch_info(self):
        if self._stopped:
            raise RuntimeError('Trying to read from a stopped mixture reader')
        snapshot = self._stream.state_dict()
        rows = []
        try:
            while len(rows) < self._rows:
                rows.append(next(self._stream))
        except StopIteration:
            if not rows:
                self.last_row_consumed = True
                raise StopIteration from None
        pull = self._next_pull
        self._next_pull += 1
        self._snapshots[pull] = snapshot
        while len(self._snapshots) > self._window:
            del self._snapshots[min(self._snapshots)]
        columns = {
            field: np.stack([row[field] for row in rows])
            for field in self._schema.fields}
        return columns, pull, 0

    # -- resume protocol ---------------------------------------------------

    def state_dict(self):
        state = dict(self._stream.state_dict())
        state['pull_base'] = self._next_pull
        return state

    def resume_state_from(self, delivered):
        """Stream state rewound to the earliest UNdelivered pull."""
        done = set()
        for items in delivered.values():
            done.update(int(i) for i in items)
        cursor = 0
        while cursor in done:
            cursor += 1
        if cursor >= self._next_pull:
            # everything produced so far was delivered: the current
            # stream position IS the resume point
            state = dict(self._stream.state_dict())
        else:
            snapshot = self._snapshots.get(cursor)
            if snapshot is None:
                raise RuntimeError(
                    'Mixture pull snapshot %d evicted (window=%d): the '
                    'consumer buffered more pulls than snapshot_window — '
                    'raise MixtureBatchReader(snapshot_window=...)'
                    % (cursor, self._window))
            state = dict(snapshot)
        state['pull_base'] = cursor
        return state

    def load_state_dict(self, state):
        state = dict(state)
        base = int(state.pop('pull_base', 0))
        self._stream.load_state_dict(state)
        self._snapshots = {}
        self._next_pull = base
        self.last_row_consumed = False

    def consumption_record_for_resume(self, state):
        return {0: set(range(int(state.get('pull_base', 0))))}

    # -- lifecycle ---------------------------------------------------------

    def reset(self):
        if not self.last_row_consumed:
            raise NotImplementedError(
                'Resetting a mixture reader mid-iteration is not supported; '
                'consume all rows first')
        self._stream.reset()
        self._snapshots = {}
        self._next_pull = 0
        self.last_row_consumed = False

    def stop(self):
        self._stopped = True
        self._stream.stop()

    def join(self):
        self._stream.join()
