"""Probabilistic multiplexer over several readers (counterpart of
``petastorm_tpu/weighted_sampling_reader.py``).

Each ``next()`` draws one underlying reader with the given probability
and returns its next item. Readers must agree on output schema and mode;
exhaustion of ANY reader ends the mix (so relative mixing ratios hold
throughout). The port mixes its batched readers: the row reader is ROADMAP
item 7.

``deterministic=True`` swaps the RNG draw for the mixture engine's
arithmetic interleave (:class:`petastorm_tpu_torch.mixture.InterleaveSchedule`):
the same surface and the same weights, but the source at position ``p``
becomes a pure function of ``(seed, weights, p)``, replayable by any
rank, with a hard realized-ratio deviation bound instead of an
in-expectation one. Callers who need the full packed-row mixture should
use :mod:`petastorm_tpu_torch.mixture` directly.

The draws and the state are the JAX reader's: the same seed draws the
same sequence, and a state saved by either package restores in the other.
"""

import numpy as np

from petastorm_tpu_torch.mixture import InterleaveSchedule


class WeightedSamplingReader:
    """:param readers: list of opened readers (same schema, same
        batched/ngram mode).
    :param probabilities: relative weights, one per reader (normalized
        internally).
    :param seed: RNG seed for reproducible mixing.
    :param deterministic: mix by the arithmetic interleave schedule
        instead of RNG draws (``seed`` then defaults to 0 — there is no
        nondeterministic flavor of an arithmetic schedule).
    """

    def __init__(self, readers, probabilities, seed=None,
                 deterministic=False):
        if len(readers) != len(probabilities):
            raise ValueError('readers and probabilities must have equal '
                             'lengths (%d != %d)'
                             % (len(readers), len(probabilities)))
        if not readers:
            raise ValueError('At least one reader is required')
        if any(p < 0 for p in probabilities) or sum(probabilities) <= 0:
            raise ValueError('probabilities must be non-negative with a '
                             'positive sum')
        first = readers[0]
        for other in readers[1:]:
            if set(other.schema.fields) != set(first.schema.fields):
                raise ValueError(
                    'All readers must share the same output schema; %s != %s'
                    % (sorted(other.schema.fields), sorted(first.schema.fields)))
            if other.batched_output != first.batched_output:
                raise ValueError('All readers must have the same '
                                 'batched_output mode')
            if (other.ngram is None) != (first.ngram is None) or (
                    first.ngram is not None and other.ngram != first.ngram):
                raise ValueError('All readers must use the same NGram spec '
                                 '(or none)')
        self._readers = readers
        self._cum = np.cumsum(np.asarray(probabilities, dtype=np.float64))
        self._cum /= self._cum[-1]
        self._seed = seed
        self._rng = np.random.RandomState(seed)
        self._draws = 0  # mux cursor: DELIVERED draws only
        self._schedule = None
        if deterministic:
            self._schedule = InterleaveSchedule(
                list(probabilities), seed=0 if seed is None else seed)

    # The mix exposes the shared reader surface.
    @property
    def schema(self):
        return self._readers[0].schema

    @property
    def batched_output(self):
        return self._readers[0].batched_output

    @property
    def ngram(self):
        return self._readers[0].ngram

    @property
    def last_row_consumed(self):
        """True once any underlying reader ran dry (which ends the mix)."""
        return any(getattr(r, 'last_row_consumed', False)
                   for r in self._readers)

    def __iter__(self):
        return self

    def __next__(self):
        # _draws must count only DELIVERED draws: charging before the
        # source's next() means a StopIteration (any source drying ends
        # the mix) leaves an undelivered draw counted, and a checkpoint
        # taken at mix end replays a choice sequence shifted by one on
        # restore. The generator state rewinds on the failure path so
        # BOTH restore flavors (rng_state and legacy seed+draws replay)
        # reflect delivered draws only.
        if self._schedule is not None:
            choice = self._schedule.peek(1)[0]
            item = next(self._readers[choice])
            self._schedule.next()
            self._draws += 1
            return item
        pre = self._rng.get_state()
        choice = int(np.searchsorted(self._cum, self._rng.random_sample(),
                                     side='right'))
        try:
            item = next(self._readers[min(choice, len(self._readers) - 1)])
        except StopIteration:
            self._rng.set_state(pre)
            raise
        self._draws += 1
        return item

    def next(self):
        return self.__next__()

    def state_dict(self):
        """Joint data position of the mix: every source reader's
        row-group-granular state plus the mux RNG cursor, so a restored
        mix continues the SAME choice sequence. Sources
        restore with their own at-least-once semantics; the choice
        sequence continues exactly for ANY mix — ``rng_state`` carries
        the generator state itself, so even ``seed=None`` mixes restore
        onto their actual stream (pre-``rng_state`` checkpoints replay
        ``seed``+``draws`` instead, which needs an explicit seed)."""
        # the Mersenne-Twister state itself (JSON-shaped) makes restore
        # O(1); 'draws' stays as a diagnostic and as the replay cursor
        # for checkpoints written before rng_state existed
        kind, keys, pos, has_gauss, cached = self._rng.get_state()
        state = {'version': 1, 'seed': self._seed, 'draws': self._draws,
                 'rng_state': [kind, [int(k) for k in keys], int(pos),
                               int(has_gauss), float(cached)],
                 'readers': [r.state_dict() for r in self._readers]}
        if self._schedule is not None:
            state['interleave'] = self._schedule.state_dict()
        return state

    def load_state_dict(self, state):
        """Reposition every source and the mux cursor (call before
        iteration starts, like the readers' own ``load_state_dict``)."""
        if len(state['readers']) != len(self._readers):
            raise ValueError(
                'checkpoint has %d reader states, this mix has %d readers'
                % (len(state['readers']), len(self._readers)))
        for reader, sub_state in zip(self._readers, state['readers']):
            reader.load_state_dict(sub_state)
        # Adopt the CHECKPOINT's seed (not the constructor's): a later
        # state_dict of this restored mix must record the stream it is
        # actually on, or a second-generation restore would replay a
        # different choice sequence than the real run took.
        self._seed = state.get('seed', self._seed)
        if self._schedule is not None:
            if 'interleave' in state:
                self._schedule.load_state_dict(state['interleave'])
            else:
                # RNG-mode checkpoint into a deterministic mix: the
                # arithmetic order is a pure function of position, so
                # the delivered-draw count IS the full cursor
                self._schedule.reset()
                for _ in range(int(state['draws'])):
                    self._schedule.next()
            self._draws = state['draws']
            return
        self._rng = np.random.RandomState(self._seed)
        if 'rng_state' in state:
            # O(1) restore: adopt the saved Mersenne-Twister state
            # directly — replaying billions of draws would stall resume
            # for minutes on a long-lived infinite mix
            kind, keys, pos, has_gauss, cached = state['rng_state']
            self._rng.set_state((kind, np.asarray(keys, dtype=np.uint32),
                                 int(pos), int(has_gauss), float(cached)))
        else:
            # pre-rng_state checkpoints: replay the mux RNG to the saved
            # cursor in bounded chunks — one random_sample(draws) call
            # would materialize an 8*draws-byte throwaway array
            remaining = state['draws']
            while remaining > 0:
                chunk = min(remaining, 1_000_000)
                self._rng.random_sample(chunk)
                remaining -= chunk
        self._draws = state['draws']

    def reset(self):
        """Restart the mix for another pass (the consumer contract
        :class:`~petastorm_tpu_torch.device.loader.TorchLoader` re-iteration relies on — it
        calls ``reader.reset()`` when a fully consumed loader is iterated
        again).

        A probabilistic mix ends when ANY source runs dry
        (:attr:`last_row_consumed`), which necessarily leaves the other
        sources mid-stream. Reset therefore restarts the DRY sources and
        lets the mid-stream ones continue from where they were — sound
        for a mix, whose per-pass row coverage is probabilistic by
        construction (there is no epoch alignment to restore)."""
        for r in self._readers:
            if getattr(r, 'last_row_consumed', False):
                r.reset()

    def stop(self):
        for r in self._readers:
            r.stop()

    def join(self):
        for r in self._readers:
            r.join()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()
        self.join()
