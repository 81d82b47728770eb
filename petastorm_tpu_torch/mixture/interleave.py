"""Deterministic weighted interleave: the arithmetic heart of the mixture
(counterpart of ``petastorm_tpu/mixture/interleave.py``).

The mixture engine must answer one question for any stream position
``p``: *which source supplies document p?* — and the answer must be a
pure function of ``(seed, weights, p)``. An RNG draw (what
:class:`~petastorm_tpu_torch.weighted_sampling_reader.WeightedSamplingReader`
does) cannot give that: the readahead mirror would have to replay the
generator, any consumer reshard would have to ship generator state, and
two ranks could never agree on position ``p`` without agreeing on every
position before it.

:class:`InterleaveSchedule` instead runs a *smooth weighted round-robin*
(the credit-counter schedule used by nginx/LVS, equivalent to walking
the Stern-Brocot mediant tree for two sources): every source carries an
integer credit; each step adds the source's weight numerator to its
credit, emits the source with the largest credit, and charges the
emitted source the common denominator. All arithmetic is exact integer
arithmetic over a common denominator (weights pass through
:class:`fractions.Fraction`), so there is no float drift, the state is
JSON-exact, and the realized mix obeys a hard deviation bound: after
``p`` emissions source ``i`` has been chosen ``p * f_i ± O(1)`` times
(``f_i`` the normalized weight) — not merely in expectation, always.

The ``seed`` perturbs the schedule without touching the guarantee: it
derives a tie-break priority permutation and the initial credit
offsets, so different seeds produce different (but individually
deterministic) interleavings of the same weights.

State is ``{'position', 'credits'}`` — O(sources) and O(1) to resume:
``from_state`` continues the emission sequence exactly where the
snapshot left it, which is what lets a mixture checkpoint re-shard at
interleave-position granularity.
"""

from fractions import Fraction

import numpy as np

_STATE_VERSION = 1


def _normalize_weights(weights):
    """Per-source integer weight numerators over a common denominator.

    Returns ``(numerators, total)`` with ``numerators[i] / total`` equal
    to the exact normalized weight of source ``i``.
    """
    if not weights:
        raise ValueError('Interleave needs at least one source weight')
    fracs = []
    for w in weights:
        f = Fraction(str(w)) if isinstance(w, float) else Fraction(w)
        if f <= 0:
            raise ValueError('Source weights must be positive, got %r' % (w,))
        # Bound the integers: float weights like 0.30000000000000004 would
        # otherwise blow the common denominator into hundreds of digits.
        fracs.append(f.limit_denominator(1 << 20))
    total = sum(fracs)
    fracs = [f / total for f in fracs]
    denom = 1
    for f in fracs:
        denom = denom * f.denominator // _gcd(denom, f.denominator)
    nums = [int(f * denom) for f in fracs]
    return nums, sum(nums)


def _gcd(a, b):
    while b:
        a, b = b, a % b
    return a


class InterleaveSchedule:
    """Constant-memory deterministic source order for a weighted mixture.

    ``schedule.next()`` advances one position and returns the source
    index; ``schedule.peek(k)`` previews the next ``k`` source indices
    without advancing (what the readahead plan consumes);
    ``InterleaveSchedule.order(weights, seed, start, k)`` is the pure
    classmethod form — source order for positions ``start..start+k`` with
    no instance state at all.
    """

    def __init__(self, weights, seed=0):
        self._weights = list(weights)
        self._seed = int(seed)
        self._nums, self._total = _normalize_weights(self._weights)
        n = len(self._nums)
        rng = np.random.RandomState(self._seed % (2 ** 32))
        # Lower tie_rank wins credit ties; a seed-derived permutation so
        # equal-weight sources do not always break toward index order.
        self._tie_rank = [int(r) for r in np.argsort(rng.permutation(n))]
        # Initial credit offsets stagger the first emissions per seed.
        # Each offset is strictly below the source's own refill so no
        # source starts more than one emission ahead of its entitlement.
        self._init_credits = [
            int(rng.randint(0, max(1, num))) for num in self._nums]
        self._credits = list(self._init_credits)
        self._position = 0

    # -- core arithmetic ---------------------------------------------------

    def _step(self, credits):
        """Advance ``credits`` in place one emission; return the source."""
        for i, num in enumerate(self._nums):
            credits[i] += num
        best = 0
        for i in range(1, len(credits)):
            if (credits[i], -self._tie_rank[i]) > (
                    credits[best], -self._tie_rank[best]):
                best = i
        credits[best] -= self._total
        return best

    # -- public surface ----------------------------------------------------

    @property
    def num_sources(self):
        return len(self._nums)

    @property
    def position(self):
        """Number of emissions so far == the next stream position."""
        return self._position

    @property
    def fractions(self):
        """Exact normalized weights as floats (for telemetry/bench)."""
        return [num / self._total for num in self._nums]

    def next(self):
        """Source index for the current position; advances by one."""
        src = self._step(self._credits)
        self._position += 1
        return src

    def peek(self, k):
        """Source indices for the next ``k`` positions, without advancing."""
        credits = list(self._credits)
        return [self._step(credits) for _ in range(int(k))]

    def source_at(self, position):
        """Source index at absolute ``position`` — pure in (seed, weights,
        position). Replays from position 0, so it is O(position): use
        :meth:`peek`/:meth:`next` for streaming access and keep this for
        spot checks and oracle tests."""
        position = int(position)
        if position < 0:
            raise ValueError('position must be >= 0')
        credits = list(self._init_credits)
        src = None
        for _ in range(position + 1):
            src = self._step(credits)
        return src

    def reset(self):
        """Rewind to position 0 (same seed, same order)."""
        self._credits = list(self._init_credits)
        self._position = 0

    # -- state -------------------------------------------------------------

    def state_dict(self):
        return {
            'version': _STATE_VERSION,
            'position': self._position,
            'credits': list(self._credits),
        }

    def load_state_dict(self, state):
        if int(state.get('version', 0)) != _STATE_VERSION:
            raise ValueError(
                'Unsupported interleave state version %r' %
                (state.get('version'),))
        credits = [int(c) for c in state['credits']]
        if len(credits) != len(self._nums):
            raise ValueError(
                'Interleave state carries %d sources, schedule has %d' %
                (len(credits), len(self._nums)))
        self._credits = credits
        self._position = int(state['position'])

    @classmethod
    def from_state(cls, weights, seed, state):
        schedule = cls(weights, seed=seed)
        schedule.load_state_dict(state)
        return schedule

    @classmethod
    def order(cls, weights, seed, start, k):
        """Pure source order for positions ``start .. start + k - 1``."""
        schedule = cls(weights, seed=seed)
        credits = list(schedule._init_credits)
        for _ in range(int(start)):
            schedule._step(credits)
        return [schedule._step(credits) for _ in range(int(k))]


def realized_deviation(order, weights):
    """Max over prefixes and sources of ``|count_i(p) - p * f_i|`` — the
    smoothness figure the bench reports for interleave-vs-RNG divergence."""
    nums, total = _normalize_weights(weights)
    fractions = [num / total for num in nums]
    counts = [0] * len(nums)
    worst = 0.0
    for p, src in enumerate(order, start=1):
        counts[src] += 1
        for i, f in enumerate(fractions):
            worst = max(worst, abs(counts[i] - p * f))
    return worst
