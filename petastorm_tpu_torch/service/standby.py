"""Warm standby: dispatcher failover for the standing service (counterpart
of ``petastorm_tpu/service/standby.py``)::

    python -m petastorm_tpu_torch.service --standby --endpoint tcp://...:7777

A :class:`StandbyDaemon` watches the primary daemon on the endpoint it will
inherit. It is one more DEALER peer on the primary's ROUTER socket: it
pulls a registry snapshot now and then (``SSYNC`` → ``SSTATE``: job specs,
client keys, leases, credit and QoS parameters, the item-id watermark; see
``Dispatcher.standby_snapshot``) and keeps the latest good copy and a
replication-lag clock. When the primary goes silent past the lapse window,
the standby **promotes**: it builds a
:class:`~petastorm_tpu_torch.service.daemon.ServiceDaemon` seeded with the
snapshot and binds the endpoint the primary held.

* The promoted dispatcher mints a fresh incarnation token, so workers and
  :class:`~petastorm_tpu_torch.service.daemon.DaemonClientPool` clients
  re-register: clients re-bind to their seeded job by idempotency key and
  re-submit exactly the items their own accounting never saw markered.
* In-flight items are not replicated: they re-ventilate through that
  re-submission, and the seeded item-id watermark keeps the new
  incarnation's id space clear of stale frames.
* The bind retries through the dead primary's lingering port; while the
  primary is still alive the bind keeps failing until the promotion window
  closes and the standby goes back to watching, so a false lapse never
  yields two heads on one endpoint.

With replication severed (the ``zmq.replicate`` drop faultpoint, or a
primary that does not answer SSYNC) the snapshot stays empty and promotion
is **cold**: clients re-register from scratch through ``JOB_EXPIRED``,
slower to re-admit and still exact. The ``service.promote`` faultpoint fails
promotion attempts, which retry with backoff inside the window. The frames
are the reference's: a port standby mirrors and replaces a JAX primary, and
the other way round.
"""

import logging
import threading
import time

from petastorm_tpu_torch import faults
from petastorm_tpu_torch.service import protocol as proto
from petastorm_tpu_torch.telemetry import (
    count_swallowed, get_registry, knobs, metrics_disabled, tracing,
)
from petastorm_tpu_torch.telemetry.timeseries import record_anomaly

logger = logging.getLogger(__name__)

_NET_POLL_MS = 50
_PROMOTE_BACKOFF_S = 0.2

#: HA metric names (docs/telemetry.md): promotions this process
#: performed, and how stale the standby's replicated snapshot is
SERVICE_FAILOVERS = 'petastorm_tpu_service_failovers_total'
SERVICE_REPLICATION_LAG = 'petastorm_tpu_service_replication_lag_seconds'


class StandbyDaemon:
    """Warm standby for a :class:`ServiceDaemon` on ``endpoint``.

    :param endpoint: the PRIMARY's ``tcp://host:port`` — the address
        this standby mirrors and, on promotion, takes over. A concrete
        port is required (port 0 would promote somewhere the workers
        and clients never look).
    :param sync_interval_s: seconds between replication pulls (default:
        the ``PETASTORM_TPU_SERVICE_STANDBY_SYNC_S`` knob, 1s).
    :param lapse_s: primary silence after which promotion begins
        (default: the ``PETASTORM_TPU_SERVICE_STANDBY_LAPSE_S`` knob,
        5s).
    :param promote_timeout_s: per-promotion bind window; an expired
        window (the primary still holds the endpoint — false-positive
        lapse) returns the standby to watching.

    Remaining keyword arguments are forwarded to the promoted
    :class:`ServiceDaemon` (fleet sizing, supervision, lease policy).
    """

    def __init__(self, endpoint, sync_interval_s=None, lapse_s=None,
                 promote_timeout_s=30.0, **daemon_kwargs):
        if endpoint.endswith(':0'):
            raise ValueError('A standby needs the primary\'s concrete '
                             'endpoint, not a random port: %r' % endpoint)
        self.endpoint = endpoint
        self._sync_interval_s = (
            sync_interval_s if sync_interval_s is not None
            else knobs.get_float('PETASTORM_TPU_SERVICE_STANDBY_SYNC_S',
                                 1.0, floor=0.05))
        self._lapse_s = (
            lapse_s if lapse_s is not None
            else knobs.get_float('PETASTORM_TPU_SERVICE_STANDBY_LAPSE_S',
                                 5.0, floor=0.1))
        self._promote_timeout_s = promote_timeout_s
        self._daemon_kwargs = daemon_kwargs
        #: 'standby' → 'promoting' → 'primary' (the /health role field)
        self.role = 'standby'
        #: the promoted ServiceDaemon once role == 'primary'
        self.daemon = None
        self._snapshot = None
        self._snapshot_at = None
        self._last_good = None
        self._syncs_ok = 0
        self._promotions = 0
        self._stop_event = threading.Event()
        self._promoted = threading.Event()
        self._thread = None
        self._obs_mount = None
        self._error = None

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        if self._thread is not None:
            raise RuntimeError('StandbyDaemon already started')
        self._thread = threading.Thread(target=self._monitor, daemon=True,
                                        name='petastorm-tpu-torch-service-standby')
        self._thread.start()
        from petastorm_tpu_torch.telemetry import obs_server
        self._obs_mount = obs_server.mount('service-standby',
                                           health=self.health)
        logger.info('Standby watching %s (sync %.2fs, lapse %.2fs)',
                    self.endpoint, self._sync_interval_s, self._lapse_s)

    def wait_promoted(self, timeout):
        """Block until this standby became the primary (True) or the
        timeout passed (False)."""
        return self._promoted.wait(timeout)

    def health(self):
        """The standby's /health: HA role and replication freshness;
        once promoted, the full primary health document with the
        standby's failover history folded in."""
        now = time.monotonic()
        ha = {
            'role': self.role,
            'primary_endpoint': self.endpoint,
            'replication_lag_s': (round(now - self._last_good, 3)
                                  if self._last_good is not None else None),
            'snapshot_jobs': (len(self._snapshot.get('jobs', ()))
                              if self._snapshot else 0),
            'syncs_ok': self._syncs_ok,
            'promotions': self._promotions,
            'sync_interval_s': self._sync_interval_s,
            'lapse_s': self._lapse_s,
        }
        daemon = self.daemon
        if daemon is not None:
            doc = daemon.health()
            doc.update(ha)
            doc['role'] = self.role
            return doc
        return ha

    def stop(self):
        self._stop_event.set()
        if self._obs_mount is not None:
            self._obs_mount.close()
            self._obs_mount = None
        if self._thread is not None:
            self._thread.join(10.0)
            self._thread = None
        if self.daemon is not None:
            self.daemon.stop()

    def run_forever(self, install_signals=True, drain_poll_s=0.2):
        """CLI body: watch until promoted (or signalled), then serve as
        the primary until drained."""
        import signal
        if install_signals:
            handler = lambda signum, frame: self._stop_event.set()  # noqa: E731
            signal.signal(signal.SIGTERM, handler)
            signal.signal(signal.SIGINT, handler)
        self.start()
        try:
            while not self._stop_event.is_set():
                if self._error is not None:
                    raise self._error
                if self._promoted.wait(drain_poll_s):
                    # hand the main thread to the promoted daemon (its
                    # own drain-on-SIGTERM semantics take over)
                    self.daemon.run_forever(install_signals=install_signals,
                                            drain_poll_s=drain_poll_s)
                    return
        finally:
            self.stop()

    # -- the monitor thread --------------------------------------------------

    def _monitor(self):
        try:
            while not self._stop_event.is_set():
                verdict = self._sync_session()
                if verdict != 'promote':
                    return
                if self._promote():
                    return
                # promote window closed (endpoint still held — a
                # false-positive lapse): back to watching
                self.role = 'standby'
                logger.warning('Promotion window closed with %s still '
                               'bound; returning to standby', self.endpoint)
        except Exception as e:  # noqa: BLE001 - surfaced via run_forever
            logger.exception('Standby monitor died')
            self._error = e

    def _sync_session(self):
        """One replication session on a fresh DEALER socket: pull
        snapshots until the primary lapses ('promote') or we stop."""
        import zmq
        context = zmq.Context()
        sock = context.socket(zmq.DEALER)
        sock.setsockopt(zmq.LINGER, 0)
        sock.connect(self.endpoint)
        next_sync = 0.0
        # the lapse clock arms at session start: a primary that NEVER
        # answers (not yet started, or a pre-SSYNC build) is
        # indistinguishable from a dead one and promotion proceeds —
        # cold if no snapshot was ever replicated
        self._last_good = time.monotonic()
        try:
            while not self._stop_event.is_set():
                now = time.monotonic()
                if now - self._last_good > self._lapse_s:
                    return 'promote'
                if now >= next_sync:
                    sock.send_multipart([proto.MSG_STANDBY_SYNC])
                    next_sync = now + self._sync_interval_s
                if not metrics_disabled():
                    get_registry().gauge(SERVICE_REPLICATION_LAG).set(
                        now - self._last_good)
                if not sock.poll(_NET_POLL_MS):
                    continue
                while True:
                    try:
                        frames = sock.recv_multipart(zmq.NOBLOCK)
                    except zmq.Again:
                        break
                    if frames[0] != proto.MSG_STANDBY_STATE:
                        continue  # stale/foreign traffic
                    if faults.ARMED and faults.fault_hit(
                            'zmq.replicate', key=b'recv') == 'drop':
                        continue  # injected: snapshot lost in flight
                    state = proto.load_standby_state(
                        frames[2] if len(frames) > 2 else b'')
                    if state is not None:
                        self._snapshot = state
                        self._snapshot_at = time.monotonic()
                    self._last_good = time.monotonic()
                    self._syncs_ok += 1
            return 'stop'
        finally:
            sock.close(linger=0)
            context.term()

    def _promote(self):
        """Take over the endpoint: build a ServiceDaemon seeded with the
        replicated snapshot and bind where the primary was. Retries
        through the dead primary's lingering port (and through injected
        ``service.promote`` failures) until the window closes. True once
        serving as primary."""
        from petastorm_tpu_torch.service.daemon import ServiceDaemon
        self.role = 'promoting'
        snapshot = self._snapshot
        warm = bool(snapshot and snapshot.get('jobs'))
        lag_s = (round(time.monotonic() - self._last_good, 3)
                 if self._last_good is not None else None)
        record_anomaly('dispatcher_failover', detail={
            'endpoint': self.endpoint,
            'warm': warm,
            'snapshot_jobs': len(snapshot.get('jobs', ()))
            if snapshot else 0,
            'replication_lag_s': lag_s})
        tracing.record_instant('standby_promote',
                               tracing.mint(0), 'daemon',
                               endpoint=self.endpoint, warm=warm,
                               lag_s=lag_s)
        logger.warning('Primary at %s silent past %.2fs; promoting '
                       '(%s snapshot, %d job(s))', self.endpoint,
                       self._lapse_s, 'warm' if warm else 'cold',
                       len(snapshot.get('jobs', ())) if snapshot else 0)
        deadline = time.monotonic() + self._promote_timeout_s
        while not self._stop_event.is_set() \
                and time.monotonic() < deadline:
            daemon = None
            try:
                if faults.ARMED:
                    faults.fault_hit('service.promote', key=self.endpoint)
                daemon = ServiceDaemon(self.endpoint, seed_state=snapshot,
                                       **self._daemon_kwargs)
                daemon.start()
            except Exception:  # noqa: BLE001 - retried inside the window
                count_swallowed('standby-promote-attempt')
                logger.info('Promotion attempt on %s failed; retrying',
                            self.endpoint, exc_info=True)
                if daemon is not None:
                    try:
                        daemon.stop()
                    except Exception:  # noqa: BLE001 - best-effort
                        count_swallowed('standby-promote-cleanup')
                if self._stop_event.wait(_PROMOTE_BACKOFF_S):
                    return False
                continue
            self.daemon = daemon
            self._promotions += 1
            self.role = 'primary'
            if not metrics_disabled():
                get_registry().counter(SERVICE_FAILOVERS).inc()
            tracing.record_instant('endpoint_takeover',
                                   tracing.mint(0), 'daemon',
                                   endpoint=self.endpoint, warm=warm,
                                   jobs=daemon.dispatcher.active_jobs())
            logger.warning('Standby promoted: serving as primary at %s '
                           'with %d seeded job(s)', self.endpoint,
                           daemon.dispatcher.active_jobs())
            self._promoted.set()
            return True
        return False
