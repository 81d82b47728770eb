"""The staging autotuner: a closed control loop over the live rollup
windows (counterpart of ``petastorm_tpu/jax/autotune.py``).

A :class:`StagingAutotuner` rides its loader's staging thread, with no
thread of its own: :meth:`StagingAutotuner.maybe_tick` is one monotonic
compare until a window is due. Each ``PETASTORM_TPU_STAGING_AUTOTUNE_
WINDOW_SEC`` it closes a :class:`~petastorm_tpu_torch.telemetry.timeseries.
WindowedRollup` window and acts on three consecutive windows that agree:

* **H2D starvation** (the ``h2d_ready`` share at or above
  ``PETASTORM_TPU_OBS_SATURATED_SHARE``) deepens the slot ring by one
  (``StagingEngine.set_num_slots``, up to
  ``PETASTORM_TPU_STAGING_AUTOTUNE_MAX_SLOTS``) and the prefetch queue by
  one (up to ``PETASTORM_TPU_STAGING_AUTOTUNE_MAX_PREFETCH``);
* **consumer-bound** sheds one decoder thread (down to 1, through
  ``codecs.set_image_decoder_threads_override``, never ``os.environ``) and
  lowers the ventilator's in-flight extra toward its starting value;
* **producer-bound** restores decoder threads toward the knob's width and
  raises the in-flight extra (``Reader.set_ventilate_extra``, up to 16);
* **io wait** at or above the saturation share per worker while
  producer-bound deepens the readahead depth by one (up to
  ``PETASTORM_TPU_READAHEAD_MAX_DEPTH``), and a buffer pool at 85% or
  more of its budget sheds it back toward the knob.

Every decision lands three ways: an ``autotune_decision`` trace instant on
the ``autotuner`` track, the
``petastorm_tpu_staging_autotune_decisions_total{action=...}`` counter, and
a bounded ring read by ``pipeline_report()['staging_autotune']`` and the
loader's ``autotune_report()``. ``PETASTORM_TPU_STAGING_AUTOTUNE=0`` turns
the loop off. The tuner moves buffering depth and thread counts, never a
batch's values.

The decoder-thread and readahead-depth overrides are one slot each per
process: the first tuner to move one owns it, others leave it alone, and
:meth:`StagingAutotuner.close` (the loader's stop) drops what its tuner
holds, so a learned setting dies with its loader. Where the port differs
from the reference, on purpose: one lock guards both owner slots and the
overrides they stand for, and a tuner applies a window's actions under it
only while open, so two loaders' tuners cannot both claim a slot, and a
tick still running on a staging thread that the loader's stop gave up
joining cannot set an override after :meth:`StagingAutotuner.close`
dropped it.
"""

import collections
import logging
import threading
import time

from petastorm_tpu_torch import codecs, readahead
from petastorm_tpu_torch.telemetry import (
    get_registry, knobs, metrics_disabled, register_refresh, span, tracing,
)
from petastorm_tpu_torch.telemetry.stall import CONSUMER_BOUND, PRODUCER_BOUND
from petastorm_tpu_torch.telemetry.timeseries import (
    WindowedRollup, h2d_ready_share, io_wait_share,
)

logger = logging.getLogger(__name__)

AUTOTUNE_DECISIONS = 'petastorm_tpu_staging_autotune_decisions_total'

#: decisions kept in the in-process ring
_DECISION_RING_CAPACITY = 100

_decisions_lock = threading.Lock()
_decisions = collections.deque(maxlen=_DECISION_RING_CAPACITY)
_decision_seq = 0

#: guards the two owner slots and the overrides they stand for: a tuner
#: claims, moves and drops them under it (re-entrant: a restore releases)
_owner_lock = threading.RLock()
#: the tuner holding the process's decoder-thread override
_override_owner = None
#: the tuner holding the process's readahead-depth override
_readahead_owner = None

#: pool occupancy share at which the readahead depth sheds
_READAHEAD_POOL_PRESSURE = 0.85

#: ceiling on the tuned ventilator in-flight extra
_MAX_INFLIGHT_EXTRA = 16

# cached enablement knob (telemetry.refresh re-reads it)
_enabled = None


def autotune_enabled():
    """True unless ``PETASTORM_TPU_STAGING_AUTOTUNE`` disables the loop."""
    global _enabled
    if _enabled is None:
        _enabled = not knobs.is_disabled('PETASTORM_TPU_STAGING_AUTOTUNE')
    return _enabled


def autotune_window_sec():
    return knobs.get_float('PETASTORM_TPU_STAGING_AUTOTUNE_WINDOW_SEC', 1.0, floor=0.05)


def autotune_max_slots():
    return knobs.get_int('PETASTORM_TPU_STAGING_AUTOTUNE_MAX_SLOTS', 8, floor=2)


def autotune_max_prefetch():
    return knobs.get_int('PETASTORM_TPU_STAGING_AUTOTUNE_MAX_PREFETCH', 8, floor=1)


def refresh_autotune():
    """Re-read the cached enablement knob (part of
    :func:`petastorm_tpu_torch.telemetry.refresh`); the bounds are read at
    each tuner's construction."""
    global _enabled
    _enabled = None


register_refresh(refresh_autotune)


def record_decision(action, **detail):
    """One adjustment: into the ring, the counter and a trace instant on
    the ``autotuner`` track (a no-op untraced)."""
    global _decision_seq
    entry = {'action': action, 'ts': time.time()}
    entry.update(detail)
    with _decisions_lock:
        _decision_seq += 1
        seq = _decision_seq
        _decisions.append(entry)
    if not metrics_disabled():
        get_registry().counter(AUTOTUNE_DECISIONS, action=action).inc()
    tracing.record_instant('autotune_decision', tracing.mint(seq), 'autotuner',
                           action=action, **detail)
    logger.info('staging autotune: %s (%s)', action, detail)
    return entry


def recent_decisions(last_n=20):
    """The most recent decisions of this process, oldest first."""
    with _decisions_lock:
        out = list(_decisions)
    return out[-last_n:]


def decision_counts():
    """``{action: n}`` over the ring (this process only)."""
    counts = {}
    with _decisions_lock:
        for entry in _decisions:
            counts[entry['action']] = counts.get(entry['action'], 0) + 1
    return counts


def override_owners():
    """``(decoder-thread owner, readahead-depth owner)``: the tuners holding
    the process's two overrides, or None each."""
    with _owner_lock:
        return _override_owner, _readahead_owner


def _reset_for_tests():
    global _override_owner, _readahead_owner
    with _decisions_lock:
        _decisions.clear()
    with _owner_lock:
        if _override_owner is not None:
            codecs.set_image_decoder_threads_override(None)
        if _readahead_owner is not None:
            readahead.set_depth_override(None)
        _override_owner = None
        _readahead_owner = None


class StagingAutotuner:
    """One loader's control loop, on its staging thread. Only that thread
    calls :meth:`maybe_tick`, so the ring growth, the prefetch bound and
    the overrides move from the thread that owns them. The tuner outlives
    passes (:meth:`apply_learned` gives each pass's new engine the learned
    depth) and drops its overrides at :meth:`close`."""

    #: consecutive windows a condition must hold before a knob moves
    _CONSECUTIVE = 3

    def __init__(self, loader, window_s=None):
        self._loader = loader
        self.window_s = window_s or autotune_window_sec()
        self._rollup = WindowedRollup(max_windows=32)
        self._next_sample = time.monotonic() + self.window_s
        self._saturated_share = knobs.get_float('PETASTORM_TPU_OBS_SATURATED_SHARE', 0.5,
                                                floor=0.05)
        self._max_slots = autotune_max_slots()
        self._max_prefetch = autotune_max_prefetch()
        # the restore ceiling is the knob's own width, never another
        # tuner's live override
        self._baseline_threads = codecs.image_decoder_threads_from_knob()
        self._thread_override = None
        # ring depth carried across passes (each pass has a new engine)
        self._learned_slots = None
        self._h2d_streak = 0
        self._consumer_streak = 0
        self._producer_streak = 0
        self._readahead_max_depth = readahead.readahead_max_depth()
        self._readahead_override = None
        self._io_streak = 0
        self._pool_streak = 0
        # the ventilator's in-flight extra at the first adjustment
        self._inflight_baseline = None
        #: adjustments made by this tuner
        self.decisions = 0
        self._closed = False

    # -- loader integration ---------------------------------------------------

    def apply_learned(self, stager):
        """Give a new pass's engine the learned ring depth."""
        if self._learned_slots is not None:
            stager.set_num_slots(self._learned_slots)

    def maybe_tick(self, now=None):
        """One monotonic compare until the next window is due, then a
        :meth:`tick`."""
        now = time.monotonic() if now is None else now
        if self._closed or now < self._next_sample:
            return None
        self._next_sample = now + self.window_s
        with span('autotune'):
            return self.tick(now)

    def tick(self, now=None):
        """Close one window against the registry and act on it: the actions
        taken, or None while the first window primes."""
        window = self._rollup.sample(get_registry().snapshot(), now=now)
        if window is None:
            return None
        return self.observe(window)

    # -- the policy -----------------------------------------------------------

    def observe(self, window):
        """Feed one closed window; returns the decisions it caused."""
        actions = []
        ready_share = h2d_ready_share(window)
        starved = ready_share >= self._saturated_share
        self._h2d_streak = self._h2d_streak + 1 if starved else 0
        verdict = window.get('verdict')
        self._consumer_streak = self._consumer_streak + 1 if verdict == CONSUMER_BOUND else 0
        self._producer_streak = self._producer_streak + 1 if verdict == PRODUCER_BOUND else 0
        # io wait argues for depth only while the consumer starves; the
        # share sums over workers, so the threshold scales by their count
        io_share = io_wait_share(window)
        io_starved = (io_share >= self._saturated_share * self._io_share_scale()
                      and verdict == PRODUCER_BOUND)
        self._io_streak = self._io_streak + 1 if io_starved else 0
        used, budget = readahead.pool_status()
        pressured = budget > 0 and used / budget >= _READAHEAD_POOL_PRESSURE
        self._pool_streak = self._pool_streak + 1 if pressured else 0
        with _owner_lock:
            if self._closed:
                return actions
            actions = self._act(ready_share, io_share, used, budget)
        self.decisions += len(actions)
        return actions

    def _act(self, ready_share, io_share, used, budget):
        """The window's actions on the streaks (under the owner lock)."""
        actions = []
        if self._h2d_streak >= self._CONSECUTIVE:
            self._h2d_streak = 0
            actions += self._deepen(ready_share)
        if self._pool_streak >= self._CONSECUTIVE:
            self._pool_streak = 0
            self._io_streak = 0
            actions += self._shed_readahead(used, budget)
        elif self._io_streak >= self._CONSECUTIVE:
            self._io_streak = 0
            actions += self._deepen_readahead(io_share)
        if self._consumer_streak >= self._CONSECUTIVE:
            self._consumer_streak = 0
            actions += self._shed_decode_threads()
            actions += self._lower_inflight()
        elif self._producer_streak >= self._CONSECUTIVE:
            self._producer_streak = 0
            actions += self._restore_decode_threads()
            actions += self._raise_inflight()
        return actions

    def _deepen(self, ready_share):
        """H2D starvation: one more ring slot and one more prefetch entry,
        each within its bound."""
        actions = []
        stager = self._loader._stager
        if stager is not None and stager.num_slots < self._max_slots:
            before = stager.num_slots
            after = stager.set_num_slots(before + 1)
            self._learned_slots = after
            actions.append(record_decision('deepen_slots', slots_from=before, slots_to=after,
                                           h2d_ready_share=round(ready_share, 4)))
        prefetch = self._loader._prefetch
        if prefetch < self._max_prefetch:
            after = self._loader._set_prefetch(prefetch + 1)
            actions.append(record_decision('deepen_prefetch', prefetch_from=prefetch,
                                           prefetch_to=after,
                                           h2d_ready_share=round(ready_share, 4)))
        return actions

    # -- readahead depth ------------------------------------------------------

    def _io_share_scale(self):
        """The reader pool's worker count (floor 1)."""
        reader = self._tunable_reader()
        pool = getattr(reader, '_pool', None) if reader is not None else None
        workers = getattr(pool, 'workers_count', None)
        return max(1, workers) if isinstance(workers, int) else 1

    def _owns_readahead(self):
        global _readahead_owner
        with _owner_lock:
            if _readahead_owner is None:
                _readahead_owner = self
            return _readahead_owner is self

    def _deepen_readahead(self, io_share):
        """Sustained io wait while the consumer starves: fetch one
        row-group further ahead, where a live manager can see it."""
        if readahead.live_manager_count() == 0 or not self._owns_readahead():
            return []
        current = readahead.current_depth()
        if current >= self._readahead_max_depth:
            return []
        self._readahead_override = current + 1
        readahead.set_depth_override(self._readahead_override)
        return [record_decision('deepen_readahead', depth_from=current,
                                depth_to=self._readahead_override,
                                io_wait_share=round(io_share, 4))]

    def _shed_readahead(self, used, budget):
        """Sustained pool pressure: back the depth off one step, never
        below the knob's own depth."""
        if readahead.live_manager_count() == 0 or not self._owns_readahead():
            return []
        current = readahead.current_depth()
        if current <= readahead.readahead_depth():
            return []
        self._readahead_override = current - 1
        readahead.set_depth_override(self._readahead_override)
        return [record_decision('shed_readahead', depth_from=current,
                                depth_to=self._readahead_override,
                                pool_share=round(used / budget, 4) if budget else None)]

    def _release_readahead(self):
        global _readahead_owner
        with _owner_lock:
            if self._readahead_override is not None:
                readahead.set_depth_override(None)
                self._readahead_override = None
            if _readahead_owner is self:
                _readahead_owner = None

    # -- ventilator in-flight bound -------------------------------------------

    def _tunable_reader(self):
        reader = getattr(self._loader, 'reader', None)
        if reader is None or not hasattr(reader, 'set_ventilate_extra'):
            return None
        return reader

    def _raise_inflight(self):
        """Producer-bound: keep one more row-group in flight."""
        reader = self._tunable_reader()
        if reader is None:
            return []
        current = reader.ventilate_extra
        if self._inflight_baseline is None:
            self._inflight_baseline = current
        if current >= _MAX_INFLIGHT_EXTRA:
            return []
        after = reader.set_ventilate_extra(current + 1)
        return [record_decision('raise_inflight', inflight_from=current, inflight_to=after)]

    def _lower_inflight(self):
        """Consumer-bound: one row-group fewer in flight, never below the
        starting value."""
        reader = self._tunable_reader()
        if reader is None or self._inflight_baseline is None:
            return []
        current = reader.ventilate_extra
        if current <= self._inflight_baseline:
            return []
        after = reader.set_ventilate_extra(current - 1)
        return [record_decision('lower_inflight', inflight_from=current, inflight_to=after)]

    # -- decoder threads ------------------------------------------------------

    def _owns_override(self):
        global _override_owner
        with _owner_lock:
            if _override_owner is None:
                _override_owner = self
            return _override_owner is self

    def _shed_decode_threads(self):
        """Consumer-bound: hand one decoder thread back, down to 1."""
        if not self._owns_override():
            return []
        current = codecs.image_decoder_threads()
        if current <= 1:
            return []
        self._thread_override = current - 1
        codecs.set_image_decoder_threads_override(self._thread_override)
        return [record_decision('shed_decode_threads', threads_from=current,
                                threads_to=self._thread_override)]

    def _restore_decode_threads(self):
        """Producer-bound: give a shed decoder thread back, toward the
        knob's width."""
        current = codecs.image_decoder_threads()
        if self._thread_override is None or current >= self._baseline_threads:
            return []
        self._thread_override = current + 1
        if self._thread_override >= self._baseline_threads:
            self._release_override()  # fully restored: the knob rules again
            restored_to = self._baseline_threads
        else:
            codecs.set_image_decoder_threads_override(self._thread_override)
            restored_to = self._thread_override
        return [record_decision('restore_decode_threads', threads_from=current,
                                threads_to=restored_to)]

    def _release_override(self):
        global _override_owner
        with _owner_lock:
            codecs.set_image_decoder_threads_override(None)
            self._thread_override = None
            if _override_owner is self:
                _override_owner = None

    # -- lifecycle and reporting ----------------------------------------------

    def close(self):
        """The loader stops: drop the overrides this tuner holds (only
        those) and tick no more. The decisions stay in the ring and the
        counter."""
        global _override_owner
        with _owner_lock:
            self._closed = True
            if self._thread_override is not None:
                self._release_override()
            elif _override_owner is self:
                _override_owner = None
            self._release_readahead()

    def summary(self):
        """The report's view: depths, bounds and the recent decisions."""
        stager = self._loader._stager
        reader = self._tunable_reader()
        return {
            'window_s': self.window_s,
            'slots': stager.num_slots if stager is not None else None,
            'max_slots': self._max_slots,
            'prefetch': self._loader._prefetch,
            'max_prefetch': self._max_prefetch,
            'decoder_threads': codecs.image_decoder_threads(),
            'readahead_depth': readahead.current_depth(),
            'readahead_max_depth': self._readahead_max_depth,
            'ventilate_extra': reader.ventilate_extra if reader is not None else None,
            'decisions': self.decisions,
            'recent': recent_decisions(10),
        }
