"""Worker supervisor: the standing service's self-healing actuator
(counterpart of ``petastorm_tpu/service/supervisor.py``).

* **Replacement**: a worker-server process that exits unexpectedly, or
  wedges (alive but heartbeat-lapsed), is replaced within one supervision
  tick, so a SIGKILL costs the fleet one heartbeat window, not a worker.
* **Recruitment**: sustained saturation (pending work while every live
  worker is loaded), judged over rollup windows of
  ``PETASTORM_TPU_SERVICE_SCALE_WINDOW_S`` (:class:`_ScaleRollup`), recruits
  one worker per episode up to ``PETASTORM_TPU_SERVICE_MAX_WORKERS``.
* **Release**: a sustained idle fleet releases workers down to
  ``PETASTORM_TPU_SERVICE_MIN_WORKERS`` in two phases, so no work is
  re-ventilated for a scaling decision: cordon (the dispatcher stops
  assigning to the worker), wait until idle, then SIGTERM (the server says
  BYE and exits).
* **Circuit breaker**: a seat whose worker dies
  ``PETASTORM_TPU_SERVICE_BREAKER_DEATHS`` times inside
  ``PETASTORM_TPU_SERVICE_BREAKER_WINDOW_S`` respawns on an exponential
  backoff and is announced once as a ``worker_flapping`` anomaly. Spawn
  failures (the ``service.spawn`` faultpoint, or a real error) feed the same
  breaker.

Every action is a trace instant on the ``supervisor`` track, an entry of
the bounded decision log served on ``/report``, and the
``petastorm_tpu_service_workers_spawned_total`` /
``..._released_total`` / ``..._breaker_open`` metrics.

The supervisor reads :meth:`Dispatcher.stats` and
:meth:`Dispatcher.alive_worker_pids` (duck-typed: tests drive it with a
stub) and owns only the processes it spawned. Its workers are the port's
worker servers, spawned through
:func:`~petastorm_tpu_torch.workers.exec_in_new_process.exec_in_new_process`
with ``CUDA_VISIBLE_DEVICES=''``: a supervised fleet never touches the card.
"""

import collections
import logging
import os
import signal
import threading
import time

from petastorm_tpu_torch import faults
from petastorm_tpu_torch.telemetry import count_swallowed, knobs, tracing
from petastorm_tpu_torch.telemetry.registry import get_registry
from petastorm_tpu_torch.telemetry.spans import metrics_disabled
from petastorm_tpu_torch.telemetry.timeseries import record_anomaly

logger = logging.getLogger(__name__)

SERVICE_SPAWNED = 'petastorm_tpu_service_workers_spawned_total'
SERVICE_RELEASED = 'petastorm_tpu_service_workers_released_total'
SERVICE_BREAKER_OPEN = 'petastorm_tpu_service_breaker_open'

#: consecutive saturated windows before one worker is recruited
_SCALE_UP_TICKS = 3
#: consecutive idle windows before one worker is released
_SCALE_DOWN_TICKS = 10
#: wall-clock grace for a spawned worker's FIRST registration (a fresh
#: interpreter pays import time before it can heartbeat at all)
_REGISTER_GRACE_S = 60.0
#: floor of the wedge threshold: a between-jobs worker re-REGISTERs on
#: a backoff capped at 2s, so a shorter threshold would kill healthy
#: idle workers waiting for the next job
_WEDGE_FLOOR_S = 3.0
#: exponential respawn backoff base/cap once a slot's breaker is open
_BREAKER_BACKOFF_BASE_S = 1.0
_BREAKER_BACKOFF_CAP_S = 60.0
#: decision-log ring served on /report
_DECISION_KEEP = 50


class _Slot:
    """One worker seat: the process currently holding it plus the seat's
    crash history (the breaker state lives with the SEAT, not the
    process — that is what makes a crash LOOP visible)."""

    __slots__ = ('index', 'proc', 'pid', 'spawned_at', 'seen_alive',
                 'deaths', 'backoff_level', 'open_until', 'flapping',
                 'releasing')

    def __init__(self, index):
        self.index = index
        self.proc = None
        self.pid = None
        self.spawned_at = None
        self.seen_alive = False
        self.deaths = collections.deque(maxlen=32)  # monotonic stamps
        self.backoff_level = 0
        self.open_until = 0.0
        self.flapping = False
        self.releasing = False

    def breaker_open(self, now):
        return now < self.open_until

    def descriptor(self, now):
        return {
            'slot': self.index,
            'pid': self.pid,
            'alive': self.proc is not None and self.proc.poll() is None,
            'uptime_s': (round(now - self.spawned_at, 1)
                         if self.spawned_at is not None else None),
            'recent_deaths': len(self.deaths),
            'breaker_open': self.breaker_open(now),
            'breaker_backoff_level': self.backoff_level,
            'breaker_reopens_in_s': (round(self.open_until - now, 1)
                                     if self.breaker_open(now) else 0),
            'releasing': self.releasing,
        }


class _ScaleRollup:
    """Windowed scaling verdicts — the autotuner's discipline applied to
    recruit/release (docs/service.md). Raw per-tick streaks made every
    transient spike a vote: one tick of backlog while a worker was
    between row-groups counted toward recruitment exactly like a tick of
    real saturation. Instead, ticks accumulate into a rollup window of
    ``PETASTORM_TPU_SERVICE_SCALE_WINDOW_S`` seconds and each CLOSED
    window casts one verdict from its MEANS — saturated, idle, or
    neither — so a decision needs sustained evidence, not a lucky
    sample. A window of 0 (the default) closes one window per tick:
    verdicts degenerate to the original per-tick readings and the
    scaling cadence is unchanged."""

    __slots__ = ('window_s', 'sat_windows', 'idle_windows',
                 '_samples', '_window_start')

    def __init__(self, window_s):
        self.window_s = window_s
        self.sat_windows = 0
        self.idle_windows = 0
        self._samples = []
        self._window_start = None

    def add(self, now, pending, assigned, alive):
        """Fold one tick's dispatcher sample. Returns the closed
        window's stats (the decision log's evidence) when this sample
        completed a window, else None."""
        if self._window_start is None:
            self._window_start = now
        self._samples.append((pending, assigned, alive))
        if now - self._window_start < self.window_s:
            return None
        n = len(self._samples)
        mean_pending = sum(s[0] for s in self._samples) / n
        mean_assigned = sum(s[1] for s in self._samples) / n
        mean_alive = sum(s[2] for s in self._samples) / n
        self._samples = []
        self._window_start = now
        # the same conditions the per-tick reading used, over the
        # window means: queued work while every live worker carries
        # load, vs. a fleet with nothing queued and nothing assigned
        saturated = mean_pending > 0 and (mean_alive == 0
                                          or mean_assigned >= mean_alive)
        idle = mean_pending == 0 and mean_assigned == 0
        self.sat_windows = self.sat_windows + 1 if saturated else 0
        self.idle_windows = self.idle_windows + 1 if idle else 0
        return {'ticks': n, 'mean_pending': round(mean_pending, 2),
                'mean_assigned': round(mean_assigned, 2),
                'mean_alive': round(mean_alive, 2),
                'saturated': saturated, 'idle': idle}


class WorkerSupervisor:
    """Process-spawning supervision loop for a daemon's worker fleet.

    :param dispatcher: the live
        :class:`~petastorm_tpu_torch.service.dispatcher.Dispatcher` (duck-typed:
        ``stats() / alive_worker_pids() / cordon_worker_by_pid() /
        worker_inflight_by_pid()``).
    :param endpoint: resolved ``tcp://`` endpoint spawned workers
        register with.
    :param initial_workers: fleet size at start (clamped into
        [min_workers, max_workers]).
    :param min_workers/max_workers: the release floor and recruitment
        ceiling (default knobs ``PETASTORM_TPU_SERVICE_MIN_WORKERS`` /
        ``..._MAX_WORKERS``).
    :param tick_s: supervision cadence; also the definition of "one
        heartbeat window" for replacement latency.
    :param spawn: test seam — replaces the real worker-process spawn;
        must return an object with ``poll()/terminate()/kill()/wait()``
        and ``pid``.
    """

    def __init__(self, dispatcher, endpoint, initial_workers=1,
                 min_workers=None, max_workers=None, tick_s=1.0,
                 heartbeat_interval_s=1.0, breaker_deaths=None,
                 breaker_window_s=None, spawn=None):
        self._dispatcher = dispatcher
        self._endpoint = endpoint
        self._heartbeat_interval_s = heartbeat_interval_s
        self._min_workers = (min_workers if min_workers is not None
                             else knobs.get_int(
                                 'PETASTORM_TPU_SERVICE_MIN_WORKERS', 1,
                                 floor=0))
        self._max_workers = (max_workers if max_workers is not None
                             else knobs.get_int(
                                 'PETASTORM_TPU_SERVICE_MAX_WORKERS', 8,
                                 floor=1))
        self._breaker_deaths = (breaker_deaths
                                if breaker_deaths is not None
                                else knobs.get_int(
                                    'PETASTORM_TPU_SERVICE_BREAKER'
                                    '_DEATHS', 3, floor=1))
        self._breaker_window_s = (breaker_window_s
                                  if breaker_window_s is not None
                                  else knobs.get_float(
                                      'PETASTORM_TPU_SERVICE_BREAKER'
                                      '_WINDOW_S', 30.0, floor=0.1))
        self.tick_s = tick_s
        self._spawn_fn = spawn
        self.target = max(self._min_workers,
                          min(initial_workers, self._max_workers))
        self._slots = []
        self._slot_seq = 0
        self._scale = _ScaleRollup(knobs.get_float(
            'PETASTORM_TPU_SERVICE_SCALE_WINDOW_S', 0.0, floor=0.0))
        self._wedge_streaks = {}            # pid -> lapsed-since timestamp
        self._decision_seq = 0
        self._decisions = collections.deque(maxlen=_DECISION_KEEP)
        self._spawned_total = 0
        self._released_total = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        with self._lock:
            while len(self._slots) < self.target:
                self._add_slot(time.monotonic())
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name='petastorm-tpu-torch-service-supervisor')
            self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        self._reap_all()

    def _run(self):
        while not self._stop.wait(self.tick_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - supervision must survive
                # a broken tick (stats race, proc teardown) loses one
                # supervision interval, never the supervisor
                count_swallowed('supervisor-tick')
                logger.debug('Supervision tick failed', exc_info=True)

    def _reap_all(self):
        deadline = time.monotonic() + 10.0
        for slot in self._slots:
            proc = slot.proc
            if proc is None or proc.poll() is not None:
                continue
            try:
                proc.terminate()
            except Exception:  # noqa: BLE001 - already gone
                count_swallowed('supervisor-reap')
        for slot in self._slots:
            proc = slot.proc
            if proc is None:
                continue
            try:
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except Exception:  # noqa: BLE001 - escalate once, then move on
                count_swallowed('supervisor-reap')
                try:
                    proc.kill()
                    proc.wait(timeout=5)
                except Exception:  # noqa: BLE001 - OS will reap
                    count_swallowed('supervisor-reap')
        self._slots = []

    # -- the supervision tick ------------------------------------------------

    def tick(self):
        """One supervision pass (the thread's body; callable directly
        from tests for deterministic stepping)."""
        now = time.monotonic()
        with self._lock:
            self._reap_and_respawn(now)
            self._replace_wedged(now)
            self._autoscale(now)
            self._advance_releases(now)
            self._update_gauges(now)

    def _reap_and_respawn(self, now):
        for slot in self._slots:
            proc = slot.proc
            if proc is not None and proc.poll() is None:
                # a worker that survived a full breaker window proves the
                # seat stable again: close the breaker, forget the streak
                if slot.deaths and slot.spawned_at is not None \
                        and now - slot.spawned_at > self._breaker_window_s:
                    slot.deaths.clear()
                    slot.backoff_level = 0
                    if slot.flapping:
                        slot.flapping = False
                        self._record('breaker_close', slot=slot.index,
                                     pid=slot.pid)
                continue
            if slot.releasing:
                # expected death: the two-phase release finishing — the
                # seat retires with its process
                self._retire_slot(slot)
                continue
            if proc is not None:
                self._note_death(slot, now,
                                 'exit code %s' % proc.poll())
                self._wedge_streaks.pop(slot.pid, None)
                slot.proc = None
                slot.pid = None
            keepable = sum(1 for s in self._slots if not s.releasing)
            if keepable > self.target:
                # fleet is above target (scale-down raced a death): let
                # the empty seat retire instead of respawning it.
                # Releasing seats are already leaving and must NOT count
                # toward the surplus — counting them would retire a
                # crashed seat alongside them and leave the fleet
                # permanently below target.
                self._retire_slot(slot)
                continue
            if slot.breaker_open(now):
                continue  # backoff not served yet
            self._spawn_into(slot, now)

    def _replace_wedged(self, now):
        """A spawned process that is alive but fell out of the
        dispatcher's liveness window (``heartbeat_gap``: wedged decode,
        hung runtime) is killed and its seat respawned — the
        observability loop's repair arm. Only workers that have been
        SEEN alive are eligible: a fresh interpreter takes seconds to
        boot and register, and killing it mid-boot would BE the crash
        loop (the registration-stuck case gets its own long grace)."""
        try:
            alive_pids = self._dispatcher.alive_worker_pids()
        except Exception:  # noqa: BLE001 - stats race during teardown
            count_swallowed('supervisor-stats')
            return
        for slot in self._slots:
            proc = slot.proc
            if proc is None or proc.poll() is not None or slot.releasing:
                continue
            if slot.pid in alive_pids:
                slot.seen_alive = True
                self._wedge_streaks.pop(slot.pid, None)
                continue
            if not slot.seen_alive:
                # never registered yet: interpreter boot / import time.
                # Tolerate up to the registration grace, then treat a
                # silent process as wedged after all.
                if slot.spawned_at is None \
                        or now - slot.spawned_at < _REGISTER_GRACE_S:
                    continue
            absent_since = self._wedge_streaks.setdefault(slot.pid, now)
            wedge_after = max(_WEDGE_FLOOR_S,
                              12 * self._heartbeat_interval_s)
            if now - absent_since < wedge_after:
                continue
            self._wedge_streaks.pop(slot.pid, None)
            logger.warning('Worker pid %s is running but heartbeat-lapsed '
                           'for %.1fs; killing for replacement',
                           slot.pid, now - absent_since)
            try:
                proc.kill()
            except Exception:  # noqa: BLE001 - it may have just exited
                count_swallowed('supervisor-kill')
            # the kill lands as an unexpected death next tick, feeding
            # the breaker exactly like any other crash

    def _autoscale(self, now):
        try:
            stats = self._dispatcher.stats()
        except Exception:  # noqa: BLE001 - stats race during teardown
            count_swallowed('supervisor-stats')
            return
        pending = stats.get('items_pending', 0)
        assigned = stats.get('items_assigned', 0)
        alive = stats.get('workers_alive', 0)
        # every tick feeds the rollup; only a CLOSED window casts a
        # saturated/idle verdict (window 0 = one window per tick, the
        # original cadence) — see _ScaleRollup
        window = self._scale.add(now, pending, assigned, alive)
        if window is None:
            return
        if self._scale.sat_windows >= _SCALE_UP_TICKS \
                and self.target < self._max_workers:
            self.target += 1
            self._scale.sat_windows = 0
            # decision-log only: _add_slot's spawn records the canonical
            # worker_spawn trace instant (one instant per actual spawn)
            self._record('scale_up_decision', target=self.target,
                         pending=pending, workers_alive=alive,
                         window=window)
            self._add_slot(now)
        elif self._scale.idle_windows >= _SCALE_DOWN_TICKS \
                and self.target > self._min_workers \
                and len(self._slots) > self._min_workers:
            self.target -= 1
            self._scale.idle_windows = 0
            self._begin_release(now)

    def _advance_releases(self, now):
        """Phase two of worker release: once the cordoned worker reports
        idle (or is already gone from the dispatcher), terminate it."""
        for slot in self._slots:
            if not slot.releasing or slot.proc is None:
                continue
            if slot.proc.poll() is not None:
                continue  # death path retires it next tick
            try:
                inflight = self._dispatcher.worker_inflight_by_pid(slot.pid)
            except Exception:  # noqa: BLE001 - stats race
                count_swallowed('supervisor-stats')
                continue
            if inflight:
                continue
            try:
                slot.proc.send_signal(signal.SIGTERM)
            except Exception:  # noqa: BLE001 - already exiting
                count_swallowed('supervisor-release')

    # -- actions -------------------------------------------------------------

    def _add_slot(self, now):
        slot = _Slot(self._slot_seq)
        self._slot_seq += 1
        self._slots.append(slot)
        self._spawn_into(slot, now)
        return slot

    def _spawn_into(self, slot, now):
        """(Re)spawn a worker-server process into ``slot``. A spawn
        failure — the ``service.spawn`` faultpoint or a real process-
        creation error — is a death of the seat: it feeds the breaker,
        so a host that cannot start workers backs off instead of
        hot-looping the spawn syscall."""
        try:
            if faults.ARMED:
                faults.fault_hit('service.spawn', key=slot.index)
            slot.proc = self._spawn_process(slot.index)
        except Exception as e:  # noqa: BLE001 - incl. FaultInjected
            self._note_death(slot, now, 'spawn failed: %s' % e)
            return
        slot.pid = slot.proc.pid
        slot.spawned_at = now
        slot.seen_alive = False
        self._spawned_total += 1
        if not metrics_disabled():
            get_registry().counter(SERVICE_SPAWNED).inc()
        self._record('worker_spawn', slot=slot.index, pid=slot.pid,
                     fleet=len(self._slots))
        logger.info('Spawned worker pid %s into slot %d (fleet %d, '
                    'target %d)', slot.pid, slot.index,
                    len(self._slots), self.target)

    def _spawn_process(self, worker_id):
        if self._spawn_fn is not None:
            return self._spawn_fn(worker_id)
        from petastorm_tpu_torch.service.worker_server import serve
        from petastorm_tpu_torch.workers.exec_in_new_process import (
            exec_in_new_process,
        )
        return exec_in_new_process(
            serve, self._endpoint, worker_id=worker_id,
            heartbeat_interval_s=self._heartbeat_interval_s,
            parent_pid=os.getpid(), once=False)

    def _note_death(self, slot, now, reason):
        """One unexpected death of ``slot``'s occupant: charge the
        breaker window; K deaths inside it open the breaker
        (exponentially backed-off respawn + ``worker_flapping``)."""
        slot.deaths.append(now)
        recent = sum(1 for t in slot.deaths
                     if now - t <= self._breaker_window_s)
        self._record('worker_death', slot=slot.index, reason=reason,
                     recent_deaths=recent)
        logger.warning('Worker slot %d died (%s): %d death(s) in the '
                       'last %.0fs', slot.index, reason, recent,
                       self._breaker_window_s)
        if recent < self._breaker_deaths:
            return
        backoff = min(_BREAKER_BACKOFF_CAP_S,
                      _BREAKER_BACKOFF_BASE_S * (2 ** slot.backoff_level))
        slot.backoff_level += 1
        slot.open_until = now + backoff
        if not slot.flapping:
            slot.flapping = True
            record_anomaly('worker_flapping', detail={
                'slot': slot.index, 'deaths': recent,
                'window_s': self._breaker_window_s,
                'backoff_s': round(backoff, 1), 'reason': reason})
            self._record('breaker_open', slot=slot.index,
                         deaths=recent, backoff_s=round(backoff, 1))
        else:
            # already announced: just extend the backoff (the ramp)
            self._record('breaker_backoff', event='breaker_open',
                         slot=slot.index, backoff_s=round(backoff, 1))

    def _begin_release(self, now):
        """Phase one of a scale-down: cordon the youngest non-releasing
        worker so the dispatcher stops feeding it; `_advance_releases`
        terminates it once idle."""
        candidates = [s for s in self._slots
                      if not s.releasing and s.proc is not None
                      and s.proc.poll() is None]
        if not candidates:
            return
        slot = max(candidates, key=lambda s: s.spawned_at or 0)
        slot.releasing = True
        try:
            self._dispatcher.cordon_worker_by_pid(slot.pid)
        except Exception:  # noqa: BLE001 - not registered yet: SIGTERM
            count_swallowed('supervisor-cordon')
        self._record('worker_release', slot=slot.index, pid=slot.pid,
                     target=self.target)
        logger.info('Releasing worker pid %s (slot %d): cordoned, will '
                    'terminate when idle (target %d)', slot.pid,
                    slot.index, self.target)

    def _retire_slot(self, slot):
        if slot.releasing:
            self._released_total += 1
            if not metrics_disabled():
                get_registry().counter(SERVICE_RELEASED).inc()
        try:
            idx = self._slots.index(slot)
        except ValueError:
            return
        self._slots[idx] = None
        self._slots = [s for s in self._slots if s is not None]

    # -- observability -------------------------------------------------------

    def _record(self, action, event=None, **detail):
        """One scaling/repair decision: bounded log (→ /report) + a
        canonical trace instant so Perfetto shows why the fleet
        changed. ``event`` overrides the trace-event name when the log
        action is more specific than the canonical vocabulary."""
        self._decision_seq += 1
        entry = {'action': action, 'ts': time.time()}
        entry.update(detail)
        self._decisions.append(entry)
        name = event or action
        if name in ('worker_spawn', 'worker_release', 'breaker_open',
                    'breaker_close'):
            tracing.record_instant(name, tracing.mint(self._decision_seq),
                                   'supervisor', **detail)

    def _update_gauges(self, now):
        if metrics_disabled():
            return
        open_breakers = sum(1 for s in self._slots if s.breaker_open(now))
        get_registry().gauge(SERVICE_BREAKER_OPEN).set(open_breakers)

    def status(self):
        """The supervisor's /health contribution. Deliberately lockless:
        tick() holds the lock across real process spawns (tens of ms
        each), and a /health scrape must not stall behind a respawn
        batch — list() snapshots the slot list at C level and the
        descriptor fields are single-value reads, so the worst case is
        one scrape seeing a mid-transition seat."""
        now = time.monotonic()
        slots = [s.descriptor(now) for s in list(self._slots)]
        return {
            'target': self.target,
            'min_workers': self._min_workers,
            'max_workers': self._max_workers,
            'breaker_deaths': self._breaker_deaths,
            'breaker_window_s': self._breaker_window_s,
            'scale_window_s': self._scale.window_s,
            'spawned_total': self._spawned_total,
            'released_total': self._released_total,
            'slots': slots,
        }

    def decisions(self):
        """The bounded scaling/repair decision log (/report)."""
        return list(self._decisions)
