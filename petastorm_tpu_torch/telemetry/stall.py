"""Stall attribution: who waits on whom, per sampling window
(counterpart of ``petastorm_tpu/telemetry/stall.py``).

Two wait clocks cover every stall of the pipeline:

* **consumer wait**: a consumer blocked pulling (the reader's pull, the
  loader's ``__next__``): the producer side is too slow, so the window
  is **producer-bound** (input-bound);
* **producer wait**: a producer blocked pushing against back-pressure (a
  pool worker on a full results queue, the loader's staging thread on a
  full prefetch queue): the consumer side is too slow, so the window is
  **consumer-bound** (compute-bound).

The attributor buckets both clocks into fixed wall-clock windows
(``PETASTORM_TPU_METRICS_WINDOW_S``, default 0.5 s) and classifies each
closed window.
"""

import collections
import threading
import time

from petastorm_tpu_torch.telemetry import knobs

PRODUCER_BOUND = 'producer-bound'
CONSUMER_BOUND = 'consumer-bound'
BALANCED = 'balanced'

#: a window classifies only when total wait exceeds this share of it;
#: quieter windows are balanced (nobody meaningfully stalled)
_MIN_WAIT_SHARE = 0.02
#: dominance threshold: one side must hold >2/3 of the total wait
_DOMINANCE = 2.0 / 3.0

_DEFAULT_WINDOW_S = 0.5


def default_window_s():
    value = knobs.get_float('PETASTORM_TPU_METRICS_WINDOW_S',
                            _DEFAULT_WINDOW_S)
    return value if value > 0 else _DEFAULT_WINDOW_S


def classify_window(producer_wait_s, consumer_wait_s, window_s):
    """Verdict for one window's wait totals (see module docstring for the
    direction of each clock)."""
    total = producer_wait_s + consumer_wait_s
    if total < _MIN_WAIT_SHARE * window_s:
        return BALANCED
    if consumer_wait_s > _DOMINANCE * total:
        return PRODUCER_BOUND
    if producer_wait_s > _DOMINANCE * total:
        return CONSUMER_BOUND
    return BALANCED


class StallAttributor:
    """Wait-clock accumulator over fixed sampling windows.

    Thread-safe; every pipeline thread notes into the same instance. A
    window closes when a note (or an explicit :meth:`windows` read) crosses
    its wall-clock boundary; closed windows keep ``(start, producer_wait_s,
    consumer_wait_s, verdict)`` in a bounded deque.
    """

    def __init__(self, window_s=None, max_windows=240):
        self._window_s = window_s or default_window_s()
        self._lock = threading.Lock()
        self._windows = collections.deque(maxlen=max_windows)
        self._win_start = None
        self._producer_wait = 0.0
        self._consumer_wait = 0.0
        self._total_producer = 0.0
        self._total_consumer = 0.0

    @property
    def window_s(self):
        return self._window_s

    def note_producer_wait(self, seconds):
        self._note(seconds, producer=True)

    def note_consumer_wait(self, seconds):
        self._note(seconds, producer=False)

    def _note(self, seconds, producer):
        if seconds <= 0.0:
            return
        now = time.monotonic()
        with self._lock:
            self._roll(now)
            if producer:
                self._producer_wait += seconds
                self._total_producer += seconds
            else:
                self._consumer_wait += seconds
                self._total_consumer += seconds

    def _roll(self, now):
        if self._win_start is None:
            self._win_start = now
            return
        while now - self._win_start >= self._window_s:
            self._windows.append({
                'start': self._win_start,
                'producer_wait_s': self._producer_wait,
                'consumer_wait_s': self._consumer_wait,
                'verdict': classify_window(self._producer_wait,
                                           self._consumer_wait,
                                           self._window_s),
            })
            self._win_start += self._window_s
            self._producer_wait = 0.0
            self._consumer_wait = 0.0
            # long idle gap (paused training, eval phase): every window
            # past the deque's capacity is an all-zero 'balanced' that
            # would be appended only to be evicted — fast-forward instead
            # of spinning O(gap/window) iterations under the lock
            behind = int((now - self._win_start) / self._window_s)
            maxlen = self._windows.maxlen or behind
            if behind > maxlen:
                self._win_start += (behind - maxlen) * self._window_s

    def windows(self, include_current=True):
        """Closed windows (oldest first), optionally with the in-progress
        window appended (classified on its partial totals)."""
        now = time.monotonic()
        with self._lock:
            self._roll(now)
            out = list(self._windows)
            if include_current and self._win_start is not None and (
                    self._producer_wait or self._consumer_wait):
                out.append({
                    'start': self._win_start,
                    'producer_wait_s': self._producer_wait,
                    'consumer_wait_s': self._consumer_wait,
                    'verdict': classify_window(self._producer_wait,
                                               self._consumer_wait,
                                               self._window_s),
                })
        return out

    def totals(self):
        """Lifetime ``(producer_wait_s, consumer_wait_s)``."""
        with self._lock:
            return self._total_producer, self._total_consumer

    def verdict(self, last_n=None):
        """Aggregate verdict over the last ``last_n`` windows (all when
        None): classification of the summed wait clocks, which is robust to
        a single noisy window."""
        windows = self.windows()
        if last_n is not None:
            windows = windows[-last_n:]
        if not windows:
            return BALANCED
        producer = sum(w['producer_wait_s'] for w in windows)
        consumer = sum(w['consumer_wait_s'] for w in windows)
        return classify_window(producer, consumer,
                               self._window_s * len(windows))

    def reset(self):
        """Drop all windows and totals (new measurement pass)."""
        with self._lock:
            self._windows.clear()
            self._win_start = None
            self._producer_wait = self._consumer_wait = 0.0
            self._total_producer = self._total_consumer = 0.0


_global_lock = threading.Lock()
_global_attributor = None


def get_attributor():
    """The process-wide attributor the pools, reader and loader note into."""
    global _global_attributor
    if _global_attributor is None:
        with _global_lock:
            if _global_attributor is None:
                _global_attributor = StallAttributor()
    return _global_attributor


def reset_attributor():
    """Swap in a fresh process-wide attributor (test isolation only)."""
    global _global_attributor
    with _global_lock:
        _global_attributor = StallAttributor()
