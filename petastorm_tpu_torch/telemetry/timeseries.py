"""Windowed rollups and anomaly detection over the registry (counterpart
of ``petastorm_tpu/telemetry/timeseries.py``): the live half of the
port's telemetry.

* :class:`WindowedRollup`: a bounded ring of fixed-width windows over
  registry snapshots. Each closed window holds per-counter rates,
  per-histogram p50/p95/p99 from the buckets' count increments, the
  gauges, the window's producer and consumer wait and the stall verdict
  they classify to.
* :class:`ObsCollector`: one daemon sampler thread
  (``petastorm-tpu-torch-obs-sampler``) that closes a window every
  ``PETASTORM_TPU_OBS_WINDOW_SEC`` and feeds it to the detector, the SLO
  policy and the flight log. It exists only while the plane is armed
  (``PETASTORM_TPU_OBS_PORT`` set and metrics on).
* :class:`AnomalyDetector`: turns the window stream into the events of
  :data:`~petastorm_tpu_torch.telemetry.names.ANOMALY_KINDS`
  (``throughput_collapse``, ``stall_flap``, ``queue_saturated``,
  ``heartbeat_gap``, ``h2d_starvation``). Events land in a bounded ring,
  the ``petastorm_tpu_anomaly_events_total{kind=…}`` counter,
  ``pipeline_report()['anomalies']``, the JSONL snapshots and the flight
  log.

:class:`HeartbeatSummarizer` is the thread-free per-heartbeat rollup a
decode-service worker server sends
(:mod:`petastorm_tpu_torch.service.worker_server`).
"""

import collections
import logging
import os
import threading
import time

from petastorm_tpu_torch.telemetry import knobs
from petastorm_tpu_torch.telemetry.names import ANOMALY_KINDS
from petastorm_tpu_torch.telemetry.registry import get_registry, metric_key
from petastorm_tpu_torch.telemetry.spans import STAGE_CALLS, STAGE_SECONDS, metrics_disabled
from petastorm_tpu_torch.telemetry.stall import CONSUMER_BOUND, PRODUCER_BOUND, classify_window

logger = logging.getLogger(__name__)

#: anomaly events by kind
ANOMALY_EVENTS = 'petastorm_tpu_anomaly_events_total'
#: rollup windows closed by this process's sampler (its liveness)
OBS_WINDOWS = 'petastorm_tpu_obs_windows_total'

_DEFAULT_WINDOW_SEC = 1.0
_DEFAULT_WINDOWS = 120

# the two wait-clock counters (the package root defines the same
# literals; importing it here would be circular)
_PRODUCER_WAIT = 'petastorm_tpu_stall_producer_wait_seconds_total'
_CONSUMER_WAIT = 'petastorm_tpu_stall_consumer_wait_seconds_total'
# service fleet-health series (the dispatcher sets them)
_SERVICE_ALIVE = 'petastorm_tpu_service_workers_alive'
_SERVICE_REGISTERED = 'petastorm_tpu_service_workers_registered'
_SERVICE_REVENTILATED = 'petastorm_tpu_service_reventilated_total'

#: events kept in the in-process ring (oldest dropped)
_EVENT_RING_CAPACITY = 200

#: throughput proxy, in priority order: result pulls (one per batch that
#: reaches the consumer), then worker-side decode and io calls
_THROUGHPUT_KEYS = (
    metric_key(STAGE_CALLS, {'stage': 'queue_wait'}),
    metric_key(STAGE_CALLS, {'stage': 'decode'}),
    metric_key(STAGE_CALLS, {'stage': 'io'}),
)


def window_sec():
    return knobs.get_float('PETASTORM_TPU_OBS_WINDOW_SEC', _DEFAULT_WINDOW_SEC, floor=0.05)


def max_windows():
    return knobs.get_int('PETASTORM_TPU_OBS_WINDOWS', _DEFAULT_WINDOWS, floor=2)


def obs_enabled():
    """The plane's arming condition: ``PETASTORM_TPU_OBS_PORT`` has a
    value and metrics are on."""
    return not metrics_disabled() and knobs.get_str('PETASTORM_TPU_OBS_PORT') != ''


_H2D_READY_KEY = metric_key(STAGE_SECONDS, {'stage': 'h2d_ready'})
_IO_SECONDS_KEY = metric_key(STAGE_SECONDS, {'stage': 'io'})


def h2d_ready_share(window):
    """Seconds a second that one closed window spent blocked in the slot
    ring's ``h2d_ready`` gate (the H2D-starvation signal)."""
    return window['rates'].get(_H2D_READY_KEY, 0.0)


def io_wait_share(window):
    """Seconds a second that one closed window spent inside the ``io``
    stage (summed over workers, so it can exceed 1.0)."""
    return window['rates'].get(_IO_SECONDS_KEY, 0.0)


# -- windowed rollup ----------------------------------------------------------


def _quantiles(buckets, count_deltas):
    """p50/p95/p99 upper bounds from one window's per-bucket count
    increments: the bound of the bucket the cumulative count crosses in,
    the +Inf bucket clamped to the largest finite bound."""
    total = sum(count_deltas)
    if total <= 0:
        return None
    out = {}
    for label, q in (('p50', 0.5), ('p95', 0.95), ('p99', 0.99)):
        target = q * total
        cumulative = 0
        for i, count in enumerate(count_deltas):
            cumulative += count
            if cumulative >= target:
                out[label] = buckets[min(i, len(buckets) - 1)]
                break
    return out


class WindowedRollup:
    """Bounded ring of fixed-width windows over registry snapshots.

    Each :meth:`sample` of a full ``registry.snapshot()`` after the first
    closes the window since the previous one. The sampler thread writes,
    scrape handlers read.
    """

    def __init__(self, max_windows=_DEFAULT_WINDOWS):
        self._lock = threading.Lock()
        self._windows = collections.deque(maxlen=max_windows)
        self._prev = None
        self._prev_t = None
        self._prev_wall = None
        self._closed_total = 0

    def sample(self, snapshot, now=None, wall=None):
        """Close one window against the previous sample; the first call
        primes the baseline and returns None."""
        now = time.monotonic() if now is None else now
        wall = time.time() if wall is None else wall
        with self._lock:
            prev, prev_t, prev_wall = self._prev, self._prev_t, self._prev_wall
            self._prev, self._prev_t, self._prev_wall = snapshot, now, wall
            if prev is None:
                return None
            dur = now - prev_t
            if dur <= 0:
                return None
            window = self._close(prev, snapshot, prev_wall, dur)
            self._windows.append(window)
            self._closed_total += 1
            return window

    @staticmethod
    def _close(prev, snap, start_wall, dur):
        prev_counters = prev.get('counters', {})
        counters = snap.get('counters', {})
        rates = {}
        for key, value in counters.items():
            delta = value - prev_counters.get(key, 0.0)
            if delta > 0:
                rates[key] = round(delta / dur, 6)
        quantiles = {}
        prev_hists = prev.get('histograms', {})
        for key, state in snap.get('histograms', {}).items():
            base = prev_hists.get(key)
            if base is None:
                deltas = state['counts']
            elif len(base['counts']) == len(state['counts']):
                deltas = [a - b for a, b in zip(state['counts'], base['counts'])]
            else:
                continue  # bucket layouts differ: skip rather than corrupt
            q = _quantiles(state['buckets'], deltas)
            if q is not None:
                quantiles[key] = q
        producer_wait = max(0.0, counters.get(_PRODUCER_WAIT, 0.0)
                            - prev_counters.get(_PRODUCER_WAIT, 0.0))
        consumer_wait = max(0.0, counters.get(_CONSUMER_WAIT, 0.0)
                            - prev_counters.get(_CONSUMER_WAIT, 0.0))
        throughput = next((rates[key] for key in _THROUGHPUT_KEYS if key in rates), None)
        return {
            'start': start_wall,
            'dur_s': round(dur, 4),
            'rates': rates,
            'quantiles': quantiles,
            'gauges': dict(snap.get('gauges', {})),
            'producer_wait_s': round(producer_wait, 6),
            'consumer_wait_s': round(consumer_wait, 6),
            'verdict': classify_window(producer_wait, consumer_wait, dur),
            'throughput': throughput,
        }

    def windows(self, last_n=None):
        with self._lock:
            out = list(self._windows)
        return out[-last_n:] if last_n is not None else out

    @property
    def closed_total(self):
        return self._closed_total


# -- anomaly events -----------------------------------------------------------


_events_lock = threading.Lock()
_events = collections.deque(maxlen=_EVENT_RING_CAPACITY)


def record_anomaly(kind, detail=None, window_start=None):
    """Record one structured anomaly event in the ring, the
    ``petastorm_tpu_anomaly_events_total{kind=…}`` counter and, when
    armed, the flight log. ``kind`` must be a key of
    :data:`~petastorm_tpu_torch.telemetry.names.ANOMALY_KINDS`; the event
    carries its runbook heading."""
    if kind not in ANOMALY_KINDS:
        raise ValueError('Unknown anomaly kind %r; register it in '
                         'petastorm_tpu_torch/telemetry/names.py ANOMALY_KINDS' % (kind,))
    event = {
        'kind': kind,
        'ts': time.time(),
        'window_start': window_start,
        'detail': dict(detail or {}),
        'runbook': 'docs/troubleshoot.md — "%s"' % ANOMALY_KINDS[kind],
    }
    with _events_lock:
        _events.append(event)
    if not metrics_disabled():
        get_registry().counter(ANOMALY_EVENTS, kind=kind).inc()
    logger.warning('Pipeline anomaly %s: %s (see %s)', kind, event['detail'], event['runbook'])
    from petastorm_tpu_torch.telemetry import obslog
    if obslog.log_dir() is not None:
        # every anomaly source funnels through here, so the log sees them
        # all; the line's 'kind' is the record type and the anomaly's own
        # kind moves to 'anomaly'
        rec = dict(event)
        rec['anomaly'] = rec.pop('kind', None)
        obslog.append('anomaly', rec)
    return event


def recent_anomalies(last_n=20):
    """The most recent anomaly events, oldest first."""
    with _events_lock:
        out = list(_events)
    return out[-last_n:]


def anomaly_counts():
    """``{kind: n}`` of the events in the ring."""
    counts = {}
    with _events_lock:
        for event in _events:
            counts[event['kind']] = counts.get(event['kind'], 0) + 1
    return counts


class AnomalyDetector:
    """Window-stream consumer emitting the canonical anomaly events.

    * ``throughput_collapse``: the throughput proxy fell below
      ``PETASTORM_TPU_OBS_COLLAPSE_FRAC`` of its trailing mean for 2
      windows in a row while the consumer still waited (so a finished
      stream never reads as a collapse).
    * ``stall_flap``: the window verdict flipped between producer- and
      consumer-bound ``PETASTORM_TPU_OBS_FLAP_FLIPS`` times within the
      recent horizon.
    * ``queue_saturated``: producer wait held at least
      ``PETASTORM_TPU_OBS_SATURATED_SHARE`` of 3 windows in a row: the
      consumer is the wall.
    * ``heartbeat_gap``: service workers fell out of the liveness window,
      or items were re-ventilated this window.
    * ``h2d_starvation``: the slot ring spent at least the saturation
      share of 3 windows in a row blocked in ``h2d_ready``.

    Each fires once when its condition establishes and re-arms only after
    it clears.
    """

    _FLAP_HORIZON = 8
    _TRAILING = 6
    _CONSECUTIVE = 3
    _COLLAPSE_CONSECUTIVE = 2
    #: a collapse needs a trailing mean at least this high (per second)
    _MIN_THROUGHPUT = 1.0
    #: share of the window the consumer must still wait for a drop to
    #: count as a collapse
    _COLLAPSE_WAIT_SHARE = 0.05
    #: calm (balanced or idle) windows in a row after which the flap
    #: horizon resets, so the next flap fires as a fresh edge
    _CALM_RESET = 4

    def __init__(self, emit=None):
        self._emit = emit or record_anomaly
        self.reload_thresholds()
        self._throughputs = collections.deque(maxlen=self._TRAILING)
        self._verdicts = collections.deque(maxlen=self._FLAP_HORIZON)
        self._sat_streak = 0
        self._h2d_streak = 0
        self._collapse_streak = 0
        self._calm_streak = 0
        self._active = set()

    def reload_thresholds(self):
        """Re-read the threshold knobs in place; the streaks survive, so a
        refresh mid-condition does not fire an active anomaly again."""
        self._collapse_frac = knobs.get_float('PETASTORM_TPU_OBS_COLLAPSE_FRAC', 0.3, floor=0.01)
        self._saturated_share = knobs.get_float('PETASTORM_TPU_OBS_SATURATED_SHARE', 0.5,
                                                floor=0.05)
        self._flap_flips = knobs.get_int('PETASTORM_TPU_OBS_FLAP_FLIPS', 3, floor=2)

    def observe(self, window):
        """Feed one closed window; emits and returns the newly
        established events."""
        events = []
        dur = max(window.get('dur_s') or 0.0, 1e-9)
        events += self._check_saturation(window, dur)
        events += self._check_h2d(window)
        events += self._check_collapse(window, dur)
        events += self._check_flap(window)
        events += self._check_heartbeat(window)
        return events

    def _fire(self, kind, window, active, detail):
        """Emit only on the inactive → active edge."""
        if not active:
            self._active.discard(kind)
            return []
        if kind in self._active:
            return []
        self._active.add(kind)
        return [self._emit(kind, detail=detail, window_start=window.get('start'))]

    def _check_saturation(self, window, dur):
        share = window.get('producer_wait_s', 0.0) / dur
        self._sat_streak = self._sat_streak + 1 if share >= self._saturated_share else 0
        return self._fire('queue_saturated', window, self._sat_streak >= self._CONSECUTIVE,
                          {'producer_wait_share': round(share, 4),
                           'threshold': self._saturated_share,
                           'windows': self._sat_streak})

    def _check_h2d(self, window):
        share = h2d_ready_share(window)
        self._h2d_streak = self._h2d_streak + 1 if share >= self._saturated_share else 0
        return self._fire('h2d_starvation', window, self._h2d_streak >= self._CONSECUTIVE,
                          {'h2d_ready_share': round(share, 4),
                           'threshold': self._saturated_share,
                           'windows': self._h2d_streak})

    def _check_collapse(self, window, dur):
        throughput = window.get('throughput')
        trailing = list(self._throughputs)
        collapsed = False
        mean = 0.0
        if len(trailing) >= 3:
            mean = sum(trailing) / len(trailing)
            wait_share = window.get('consumer_wait_s', 0.0) / dur
            collapsed = (mean >= self._MIN_THROUGHPUT
                         and (throughput or 0.0) < self._collapse_frac * mean
                         and wait_share >= self._COLLAPSE_WAIT_SHARE)
        self._collapse_streak = self._collapse_streak + 1 if collapsed else 0
        events = self._fire('throughput_collapse', window,
                            self._collapse_streak >= self._COLLAPSE_CONSECUTIVE,
                            {'throughput': round(throughput or 0.0, 3),
                             'trailing_mean': round(mean, 3),
                             'threshold_frac': self._collapse_frac})
        # collapsed windows stay out of the trailing mean, or a sustained
        # collapse drags the baseline down to itself and clears itself
        if throughput is not None and not collapsed:
            self._throughputs.append(throughput)
        return events

    def _check_flap(self, window):
        verdict = window.get('verdict')
        if verdict in (PRODUCER_BOUND, CONSUMER_BOUND):
            self._verdicts.append(verdict)
            self._calm_streak = 0
        else:
            self._calm_streak += 1
            if self._calm_streak >= self._CALM_RESET:
                self._verdicts.clear()
        verdicts = list(self._verdicts)
        flips = sum(1 for a, b in zip(verdicts, verdicts[1:]) if a != b)
        return self._fire('stall_flap', window, flips >= self._flap_flips,
                          {'flips': flips, 'horizon': len(verdicts),
                           'threshold': self._flap_flips})

    def _check_heartbeat(self, window):
        gauges = window.get('gauges', {})
        alive = gauges.get(_SERVICE_ALIVE)
        registered = gauges.get(_SERVICE_REGISTERED, 0)
        reventilated = window['rates'].get(_SERVICE_REVENTILATED, 0.0)
        gap = bool(reventilated) or (alive is not None and registered and alive < registered)
        return self._fire('heartbeat_gap', window, gap,
                          {'workers_alive': alive, 'workers_registered': registered,
                           'reventilated_per_s': round(reventilated, 3)})


# -- the sampler --------------------------------------------------------------


class ObsCollector:
    """One daemon sampler thread: snapshot → rollup window → detector,
    SLO policy and flight log."""

    #: one critical-path digest goes to the flight log every N ticks (the
    #: sweep over the recorder is the plane's costliest analysis)
    _CRITPATH_EVERY = 30

    def __init__(self, window_s=None, windows=None, detector=None):
        self.window_s = window_s or window_sec()
        self.rollup = WindowedRollup(windows or max_windows())
        self.detector = detector or AnomalyDetector()
        self._stop = threading.Event()
        self._thread = None
        self._ticks = 0

    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name='petastorm-tpu-torch-obs-sampler')
        self._thread.start()

    def _run(self):
        while not self._stop.wait(self.window_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - observability is advisory
                logger.debug('Rollup tick failed', exc_info=True)

    def tick(self):
        """One sampling step (the thread's body; tests call it directly).
        The registry is looked up anew each tick, so a test's registry
        swap is sampled and not the dead one."""
        from petastorm_tpu_torch.telemetry import obslog, slo
        window = self.rollup.sample(get_registry().snapshot())
        if window is None:
            return None
        if not metrics_disabled():
            get_registry().counter(OBS_WINDOWS).inc()
        self.detector.observe(window)
        verdict = slo.observe_window(window)
        self._ticks += 1
        if obslog.log_dir() is not None:
            # the anomalies reach the log through record_anomaly itself
            obslog.append('window', dict(window))
            if verdict is not None:
                obslog.append('slo', dict(verdict))
            if self._ticks % self._CRITPATH_EVERY == 0:
                from petastorm_tpu_torch.telemetry import critpath
                digest = critpath.analyze()
                if digest is not None:
                    digest.pop('stages', None)
                    obslog.append('critpath', digest)
        return window

    def reload_config(self):
        """Re-read the window length and the detector's thresholds; the
        detector and its streaks are kept."""
        self.window_s = window_sec()
        self.detector.reload_thresholds()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


_collector_lock = threading.Lock()
_collector = None


def ensure_collector():
    """Start the process-wide sampler if the plane is armed; the collector
    or None. The one path that starts a sampler, which is what keeps an
    unarmed process free of the plane's threads."""
    global _collector
    if not obs_enabled():
        return None
    if _collector is None:
        with _collector_lock:
            if _collector is None:
                collector = ObsCollector()
                collector.start()
                _collector = collector
    return _collector


def collector_running():
    return _collector is not None


def rollup_section(last_n=12):
    """The live rollup that ``/report`` serves: a headline (latest
    throughput and verdict, totals) and the last ``last_n`` windows; None
    when no collector runs."""
    collector = _collector
    if collector is None:
        return None
    windows = collector.rollup.windows()
    last = windows[-1] if windows else {}
    return {
        'window_s': collector.window_s,
        'headline': {
            'window_s': collector.window_s,
            'windows_sampled': collector.rollup.closed_total,
            'throughput_per_s': last.get('throughput'),
            'verdict': last.get('verdict'),
            'anomaly_counts': anomaly_counts(),
        },
        'windows': windows[-last_n:],
    }


def refresh_obs():
    """Re-read the plane's cached knobs (hooked into
    ``telemetry.refresh()``): the live collector reloads its window and
    thresholds, the SLO spec and the log directory are re-read. Arming
    and the port take effect at the next mount."""
    collector = _collector
    if collector is not None:
        collector.reload_config()
    from petastorm_tpu_torch.telemetry import obslog, slo
    slo.refresh_slo()
    obslog.refresh_obslog()


def _reset_for_tests():
    """Stop the sampler and empty the event ring (test isolation)."""
    global _collector
    with _collector_lock:
        collector, _collector = _collector, None
    if collector is not None:
        collector.stop()
    with _events_lock:
        _events.clear()


# -- worker heartbeat summaries -----------------------------------------------


class HeartbeatSummarizer:
    """Thread-free rollup for a service worker's heartbeat: pid, uptime,
    the per-second rates of the counters that moved since the previous
    call (the busiest :attr:`_MAX_RATES`) and the ring's anomaly
    counts."""

    _MAX_RATES = 24

    def __init__(self, worker_id=None):
        self._worker_id = worker_id
        self._t0 = time.monotonic()
        self._prev = None
        self._prev_t = None

    def summary(self, obs_port=None):
        out = {'pid': os.getpid(), 'uptime_s': round(time.monotonic() - self._t0, 1)}
        if self._worker_id is not None:
            out['worker_id'] = self._worker_id
        if obs_port:
            out['obs_port'] = obs_port
        if metrics_disabled():
            return out
        counters = get_registry().counters_with_prefix('')
        now = time.monotonic()
        prev, prev_t = self._prev, self._prev_t
        self._prev, self._prev_t = counters, now
        if prev is not None and now > prev_t:
            dur = now - prev_t
            rates = {}
            for key, value in counters.items():
                delta = value - prev.get(key, 0.0)
                if delta > 0:
                    rates[key] = round(delta / dur, 4)
            if len(rates) > self._MAX_RATES:
                keep = sorted(rates, key=lambda k: -rates[k])
                rates = {k: rates[k] for k in keep[:self._MAX_RATES]}
            out['rates'] = rates
        counts = anomaly_counts()
        if counts:
            out['anomalies'] = counts
        return out
