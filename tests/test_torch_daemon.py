"""The port's standing decode service against the JAX package's, case for
case with ``tests/test_daemon.py``: each case runs through both packages'
``ServiceDaemon``, ``DaemonClientPool`` and ``WorkerSupervisor`` one after
the other and compares multisets, counters and decisions; the mixed pairs
run a port client on a JAX daemon and a JAX client on a port daemon.

Timing is the reference's (``HB``/``TICK`` 0.15 s, generous outer
deadlines); every ``get_results`` carries a timeout and every daemon,
client and process is stopped in ``finally``."""

import collections
import os
import signal
import threading
import time

import pytest

from tests.torch_service_common import (
    HB, PACKAGES, TICK, arm, await_condition, both, reap, spawn_cli_worker, spawn_daemon_cli,
)
from tests.torch_telemetry_common import telemetry_guard  # noqa: F401 - autouse

pytestmark = pytest.mark.service


def _drain(pkg, pool, per_result_timeout_s=60):
    out = []
    while True:
        try:
            out.append(pool.get_results(timeout=per_result_timeout_s))
        except pkg.EmptyResultError:
            return out


def _make_daemon(pkg, workers=2, **kwargs):
    kwargs.setdefault('heartbeat_interval_s', HB)
    kwargs.setdefault('supervisor_tick_s', TICK)
    daemon = pkg.ServiceDaemon('tcp://127.0.0.1:0', initial_workers=workers, **kwargs)
    daemon.start()
    return daemon


def _client(pkg, endpoint, **kwargs):
    kwargs.setdefault('heartbeat_interval_s', HB)
    return pkg.DaemonClientPool(endpoint, **kwargs)


def _stop(*pools):
    for pool in pools:
        pool.stop()
        pool.join()


def _anomalies(pkg, kind):
    return [e for e in pkg.telemetry.recent_anomalies() if e['kind'] == kind]


# -- the multi-job registry ----------------------------------------------------------


def test_two_jobs_share_one_fleet_exact_delivery():
    def run(pkg):
        daemon = _make_daemon(pkg, workers=2)
        a = _client(pkg, daemon.endpoint, name='job-a')
        b = _client(pkg, daemon.endpoint, name='job-b')
        try:
            a.start(pkg.stubs.SleepyIdentityWorker)
            b.start(pkg.stubs.SleepyIdentityWorker)
            for i in range(30):
                a.ventilate(i, sleep_s=0.005)
            for i in range(100, 130):
                b.ventilate(i, sleep_s=0.005)
            await_condition(lambda: all(j['workers'] >= 1
                                        for j in daemon.dispatcher.health()['jobs']),
                            message='fleet partitioned across jobs')
            got = (sorted(_drain(pkg, a)), sorted(_drain(pkg, b)))
            stats = daemon.dispatcher.stats()
            return got, stats['jobs_active'], stats['jobs_seen'], sorted(
                j['name'] for j in daemon.dispatcher.health()['jobs'])
        finally:
            _stop(a, b)
            await_condition(lambda: daemon.dispatcher.active_jobs() == 0,
                            message='jobs reclaimed after goodbye')
            daemon.stop()

    out = both(run)
    assert out['torch'] == out['jax'] == ((list(range(30)), list(range(100, 130))), 2, 2,
                                          ['job-a', 'job-b'])


@pytest.fixture(scope='module')
def scalar_url(tmp_path_factory):
    from tests.test_common import create_test_scalar_dataset
    url = 'file://' + str(tmp_path_factory.mktemp('daemon') / 'dataset')
    create_test_scalar_dataset(url, num_rows=50, num_files=5)
    return url


def _read_ids(pkg, url, pool_type):
    ids = collections.Counter()
    with pkg.reader.make_batch_reader(url, reader_pool_type=pool_type, num_epochs=1,
                                      shuffle_row_groups=False) as reader:
        for batch in reader:
            ids.update(int(x) for x in batch.id)
    return ids


def test_reader_reads_through_standing_daemon(scalar_url, monkeypatch):
    """``make_batch_reader(url, reader_pool_type='service')`` with
    ``PETASTORM_TPU_SERVICE_DAEMON`` set: the thread pool's multiset, twice
    off one standing daemon, in both packages."""
    expected = _read_ids(PACKAGES['jax'], scalar_url, 'thread')
    assert sum(expected.values()) == 50

    def run(pkg):
        daemon = _make_daemon(pkg, workers=2)
        try:
            monkeypatch.setenv('PETASTORM_TPU_SERVICE_DAEMON', daemon.endpoint)
            got = [_read_ids(pkg, scalar_url, 'service') for _ in range(2)]
            return got, daemon.dispatcher.stats()['jobs_seen']
        finally:
            monkeypatch.delenv('PETASTORM_TPU_SERVICE_DAEMON', raising=False)
            daemon.stop()

    assert both(run) == {name: ([expected, expected], 2) for name in PACKAGES}


# -- chaos drill (a): a worker SIGKILL, replaced by the supervisor -------------------------


def _kill_a_busy_worker(daemon, deadline_s=30):
    """SIGKILL the first supervised worker the dispatcher shows holding an
    item (a worker picked blindly may hold none on a loaded host, and then
    nothing is re-ventilated); returns its pid."""
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        for slot in daemon.supervisor.status()['slots']:
            if slot['pid'] and daemon.dispatcher.worker_inflight_by_pid(slot['pid']):
                os.kill(slot['pid'], signal.SIGKILL)
                return slot['pid']
        time.sleep(0.001)
    raise AssertionError('no supervised worker held an item within %ss' % deadline_s)


def test_worker_sigkill_replaced_within_heartbeat_window():
    def run(pkg):
        daemon = _make_daemon(pkg, workers=2)
        pool = _client(pkg, daemon.endpoint, name='kill-drill')
        try:
            pool.start(pkg.stubs.SleepyIdentityWorker)
            for i in range(40):
                pool.ventilate(i, sleep_s=0.05)
            results = [pool.get_results(timeout=60) for _ in range(5)]
            _kill_a_busy_worker(daemon)
            results.extend(_drain(pkg, pool))
            status = daemon.supervisor.status()
            stats = daemon.dispatcher.stats()
            await_condition(lambda: daemon.dispatcher.stats()['workers_alive'] >= 2,
                            message='replacement worker registered')
            actions = {d['action'] for d in daemon.supervisor.decisions()}
            return (sorted(results), status['spawned_total'] >= 3,
                    stats['items_reventilated'] >= 1,
                    {'worker_death', 'worker_spawn'} <= actions)
        finally:
            _stop(pool)
            daemon.stop()

    assert both(run) == {name: (list(range(40)), True, True, True) for name in PACKAGES}


# -- chaos drill (b): a crash-looping seat trips the breaker ------------------------------


def test_breaker_trips_after_exactly_k_deaths_sparing_cotenants(monkeypatch):
    def run(pkg):
        daemon = _make_daemon(pkg, workers=2)
        pool = _client(pkg, daemon.endpoint, name='cotenant')
        try:
            pool.start(pkg.stubs.SleepyIdentityWorker)
            for i in range(60):
                pool.ventilate(i, sleep_s=0.02)
            results = [pool.get_results(timeout=60) for _ in range(3)]
            victim = daemon.supervisor.status()['slots'][1]
            arm(monkeypatch, 'service.spawn:error:1:match=%d' % victim['slot'])
            os.kill(victim['pid'], signal.SIGKILL)
            await_condition(lambda: any(s['breaker_open']
                                        for s in daemon.supervisor.status()['slots']),
                            message='breaker to open')
            flapping = _anomalies(pkg, 'worker_flapping')
            arm(monkeypatch, None)
            results.extend(_drain(pkg, pool))
            await_condition(lambda: daemon.dispatcher.stats()['workers_alive'] >= 2,
                            message='breaker-closed respawn to restore the fleet')
            return (sorted(results), pool.poisoned_items, len(flapping),
                    flapping[0]['detail']['deaths'])
        finally:
            arm(monkeypatch, None)
            _stop(pool)
            daemon.stop()

    assert both(run) == {name: (list(range(60)), [], 1, 3) for name in PACKAGES}


# -- chaos drill (c): a silent client's lease reclaims its job -----------------------------


class _RawJobClient:
    """A protocol-level client with no liveness machinery: registers a job,
    submits items, then can go silent (the lease-lapse and BUSY probe)."""

    def __init__(self, pkg, endpoint):
        import zmq
        self.pkg = pkg
        self._context = zmq.Context()
        self.sock = self._context.socket(zmq.DEALER)
        self.sock.setsockopt(zmq.LINGER, 0)
        self.sock.connect(endpoint)
        self.job_id = None

    def register(self, lease_s=None, timeout_s=15):
        proto = self.pkg.protocol
        spec = proto.dump_job_spec(self.pkg.stubs.SleepyIdentityWorker, None,
                                   self.pkg.service_pool.PickleSerializer())
        params = {'name': 'raw', 'credit': 100}
        if lease_s is not None:
            params['lease_s'] = lease_s
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            self.sock.send_multipart([proto.MSG_REGISTER_JOB, spec,
                                      proto.dump_json_params(params)])
            if not self.sock.poll(500):
                continue
            frames = self.sock.recv_multipart()
            if frames[0] == proto.MSG_JOB_OK:
                self.job_id = int(frames[1])
                return 'ok'
            if frames[0] == proto.MSG_BUSY:
                return proto.load_json_params(frames[1])
        raise AssertionError('no REGISTER_JOB answer within %ss' % timeout_s)

    def submit(self, cid, *args, **kwargs):
        proto = self.pkg.protocol
        self.sock.send_multipart([proto.MSG_SUBMIT, b'%d' % self.job_id, b'%d' % cid,
                                  proto.dump_work_item(args, kwargs)])

    def close(self):
        self.sock.close(linger=0)
        self._context.term()


def test_lease_lapse_reclaims_job_without_touching_survivor():
    def run(pkg):
        daemon = _make_daemon(pkg, workers=2, lease_s=1.0)
        survivor = _client(pkg, daemon.endpoint, name='survivor')
        silent = _RawJobClient(pkg, daemon.endpoint)
        try:
            survivor.start(pkg.stubs.SleepyIdentityWorker)
            assert silent.register(lease_s=1.0) == 'ok'
            for cid in range(10):
                silent.submit(cid, cid, sleep_s=0.05)
            for i in range(40):
                survivor.ventilate(i, sleep_s=0.02)
            await_condition(lambda: daemon.dispatcher.active_jobs() == 2,
                            message='both jobs registered')
            silent.close()
            await_condition(lambda: daemon.dispatcher.active_jobs() == 1,
                            message='lease to reclaim the silent job')
            expired = _anomalies(pkg, 'job_lease_expired')
            got = sorted(_drain(pkg, survivor))
            await_condition(lambda: daemon.dispatcher.health()['jobs'][0]['workers'] >= 2,
                            message='orphaned workers rebound to the survivor')
            return (got, [e['detail']['name'] for e in expired],
                    daemon.dispatcher.stats()['jobs_expired'])
        finally:
            _stop(survivor)
            daemon.stop()

    assert both(run) == {name: (list(range(40)), ['raw'], 1) for name in PACKAGES}


# -- a daemon SIGKILL and restart: client re-submission, worker re-registration ------------


def _standing_restart_drill(daemon_pkg, client_pkg, worker_pkg):
    endpoint = 'tcp://127.0.0.1:%d' % client_pkg.protocol.free_tcp_port()
    daemon_proc = spawn_daemon_cli(daemon_pkg, endpoint)
    workers = [spawn_cli_worker(worker_pkg, endpoint, i, heartbeat_interval_s=HB,
                                extra_args=['--ack-timeout', '1.5']) for i in range(2)]
    pool = _client(client_pkg, endpoint, name='restart-drill', ack_timeout_s=1.5,
                   connect_timeout_s=60)
    try:
        pool.start(client_pkg.stubs.SleepyIdentityWorker)
        for i in range(30):
            pool.ventilate(i, sleep_s=0.05)
        results = [pool.get_results(timeout=60) for _ in range(5)]
        os.kill(daemon_proc.pid, signal.SIGKILL)
        daemon_proc.wait()
        daemon_proc = spawn_daemon_cli(daemon_pkg, endpoint)
        results.extend(_drain(client_pkg, pool))
        return (sorted(results), pool.diagnostics['reregistrations'] >= 1,
                all(w.poll() is None for w in workers))
    finally:
        _stop(pool)
        reap([daemon_proc] + workers)


def test_daemon_sigkill_restart_exact_delivery_with_standing_workers():
    out = both(lambda pkg: _standing_restart_drill(pkg, pkg, pkg))
    assert out == {name: (list(range(30)), True, True) for name in PACKAGES}


# -- drain and admission control ----------------------------------------------------


def test_drain_refuses_new_jobs_busy_and_finishes_registered_ones():
    def run(pkg):
        daemon = _make_daemon(pkg, workers=1)
        pool = _client(pkg, daemon.endpoint, name='draining-job')
        probe = _RawJobClient(pkg, daemon.endpoint)
        try:
            pool.start(pkg.stubs.SleepyIdentityWorker)
            for i in range(10):
                pool.ventilate(i, sleep_s=0.01)
            daemon.begin_drain()
            refusal = probe.register(timeout_s=10)
            got = sorted(_drain(pkg, pool))
            return refusal, got, daemon.health()['draining']
        finally:
            probe.close()
            _stop(pool)
            await_condition(lambda: daemon.drained, message='drain to empty')
            daemon.stop()

    out = both(run)
    assert out['torch'] == out['jax']
    refusal, got, draining = out['torch']
    assert refusal != 'ok' and refusal['reason'] == 'draining'
    assert got == list(range(10)) and draining is True


def test_admission_control_refuses_beyond_max_jobs():
    def run(pkg):
        daemon = _make_daemon(pkg, workers=1, max_jobs=1)
        first = _client(pkg, daemon.endpoint, name='admitted')
        probe = _RawJobClient(pkg, daemon.endpoint)
        try:
            first.start(pkg.stubs.IdentityWorker)
            return probe.register(timeout_s=10)
        finally:
            probe.close()
            _stop(first)
            daemon.stop()

    out = both(run)
    assert out['torch'] == out['jax']
    assert out['torch'] != 'ok' and out['torch']['reason'] == 'saturated'
    assert out['torch']['max_jobs'] == 1


# -- protocol compatibility -------------------------------------------------------------


def test_old_build_worker_serves_new_daemon():
    """A worker speaking only the first frame set (bare REGISTER, bare
    HEARTBEAT, DONE with an empty metrics frame) serves a daemon job."""
    import zmq

    def run(pkg):
        proto = pkg.protocol
        daemon = _make_daemon(pkg, workers=0, supervise=False)
        pool = _client(pkg, daemon.endpoint, name='old-worker-job')
        stop = threading.Event()
        served = []

        def old_worker():
            context = zmq.Context()
            sock = context.socket(zmq.DEALER)
            sock.setsockopt(zmq.LINGER, 0)
            sock.connect(daemon.endpoint)
            try:
                spec = None
                while spec is None and not stop.is_set():
                    sock.send_multipart([proto.MSG_REGISTER])
                    if sock.poll(200):
                        frames = sock.recv_multipart()
                        if frames[0] == proto.MSG_SPEC:
                            spec = frames[1]
                if spec is None:
                    return
                worker_class, worker_args, serializer = proto.load_job_spec(spec)
                buffer = []
                worker = worker_class(0, buffer.append, worker_args)
                worker.initialize()
                sock.send_multipart([proto.MSG_READY])
                last_hb = 0.0
                while not stop.is_set():
                    now = time.monotonic()
                    if now - last_hb > HB:
                        last_hb = now
                        sock.send_multipart([proto.MSG_HEARTBEAT])
                    if not sock.poll(50):
                        continue
                    frames = sock.recv_multipart()
                    if frames[0] == proto.MSG_WORK:
                        del buffer[:]
                        args, kwargs = proto.load_work_item(frames[2])
                        kwargs.pop('_trace_ctx', None)
                        worker.process(*args, **kwargs)
                        served.append(1)
                        sock.send_multipart([proto.MSG_DONE, frames[1], b'']
                                            + [serializer.serialize(v) for v in buffer])
                    elif frames[0] == proto.MSG_STOP:
                        break
            finally:
                sock.close(linger=0)
                context.term()

        thread = threading.Thread(target=old_worker, daemon=True)
        thread.start()
        try:
            pool.start(pkg.stubs.SleepyIdentityWorker)
            for i in range(12):
                pool.ventilate(i, sleep_s=0.005)
            return sorted(_drain(pkg, pool)), bool(served)
        finally:
            _stop(pool)
            stop.set()
            thread.join(timeout=10)
            daemon.stop()

    assert both(run) == {name: (list(range(12)), True) for name in PACKAGES}


def test_new_worker_serves_frameless_v1_dispatcher():
    """Today's worker server against a dispatcher speaking only the first
    frame set (no token on SPEC or HEARTBEAT_ACK, the pid frame ignored)."""
    import zmq

    def run(pkg):
        proto = pkg.protocol
        endpoint = 'tcp://127.0.0.1:%d' % proto.free_tcp_port()
        spec = proto.dump_job_spec(pkg.stubs.IdentityWorker, None,
                                   pkg.service_pool.PickleSerializer())
        results = {}
        done = threading.Event()

        def v1_dispatcher():
            context = zmq.Context()
            sock = context.socket(zmq.ROUTER)
            sock.bind(endpoint)
            pending = list(range(8))
            identity = None
            try:
                deadline = time.monotonic() + 60
                while len(results) < 8 and time.monotonic() < deadline:
                    if not sock.poll(50):
                        continue
                    frames = sock.recv_multipart()
                    identity, msg = frames[0], frames[1]
                    if msg == proto.MSG_REGISTER:
                        sock.send_multipart([identity, proto.MSG_SPEC, spec])
                    elif msg in (proto.MSG_READY, proto.MSG_HEARTBEAT):
                        if msg == proto.MSG_HEARTBEAT:
                            sock.send_multipart([identity, proto.MSG_HEARTBEAT_ACK])
                        while pending:
                            item = pending.pop(0)
                            sock.send_multipart([identity, proto.MSG_WORK,
                                                 proto.pack_item_id(item),
                                                 proto.dump_work_item((item,), {})])
                    elif msg == proto.MSG_DONE:
                        item = proto.unpack_item_id(frames[2])
                        payload = frames[3:]
                        if payload and (payload[0] == b''
                                        or proto.load_metrics_delta(payload[0])):
                            payload = payload[1:]
                        results[item] = payload
                for _ in range(3):
                    if identity is not None:
                        sock.send_multipart([identity, proto.MSG_STOP])
                    time.sleep(0.05)
            finally:
                done.set()
                sock.close(linger=0)
                context.term()

        thread = threading.Thread(target=v1_dispatcher, daemon=True)
        thread.start()
        worker = spawn_cli_worker(pkg, endpoint, heartbeat_interval_s=HB, extra_args=['--once'])
        try:
            assert done.wait(timeout=90), 'v1 dispatcher never finished'
            return sorted(results)
        finally:
            thread.join(timeout=10)
            reap([worker])

    assert both(run) == {name: list(range(8)) for name in PACKAGES}


def test_completion_from_non_owner_identity_is_dropped():
    """A stale DONE from an identity never assigned the item completes
    nothing; the owner's completion flows."""
    def run(pkg):
        dispatcher = pkg.dispatcher
        delivered = []
        d = dispatcher.Dispatcher('tcp://127.0.0.1:0', b'spec',
                                  lambda entry: delivered.append(entry) or True,
                                  threading.Event())
        now = time.monotonic()
        owner = dispatcher._WorkerState(b'OWNER', now)
        d._workers[b'OWNER'] = owner
        item = d.submit(b'payload')
        local = d._jobs[0]
        local.pending.clear()
        local.pending_ids.clear()
        d._inflight[item] = (b'OWNER', b'payload')
        owner.inflight.add(item)
        d._item_owners[item] = {b'OWNER'}
        d._complete(b'STALE-GHOST', item, ('result', [b'wrong-rows']), now)
        after_ghost = (list(delivered), item in d._inflight)
        d._complete(b'OWNER', item, ('result', [b'rows']), now)
        return after_ghost, delivered, item

    out = both(run)
    assert out['torch'] == out['jax']
    (ghost_delivered, still_inflight), delivered, item = out['torch']
    assert ghost_delivered == [] and still_inflight
    assert ('result', b'rows') in delivered and ('marker', item) in delivered


def test_lapsed_worker_rebinds_only_to_its_own_job():
    class _SockStub:
        def __init__(self):
            self.sent = []

        def send_multipart(self, frames, **kwargs):
            self.sent.append(frames)

    def run(pkg):
        proto = pkg.protocol
        d = pkg.dispatcher.Dispatcher('tcp://127.0.0.1:0', None, None, threading.Event(),
                                      standing=True)
        sock = _SockStub()
        d._sock = sock
        now = time.monotonic()
        d._handle_register_job(sock, b'client-a',
                               [b'', b'', b'spec-a', proto.dump_json_params({'key': 'a'})], now)
        d._handle_register_job(sock, b'client-b',
                               [b'', b'', b'spec-b', proto.dump_json_params({'key': 'b'})], now)
        d._handle(sock, [b'w1', proto.MSG_REGISTER])
        worker = d._workers[b'w1']
        bound_job = worker.job_id
        other = [j for j in d._jobs if j != bound_job][0]
        d._workers[b'w2'] = type(worker)(b'w2', now)
        d._workers[b'w2'].job_id = bound_job
        d._jobs[bound_job].workers.add(b'w2')
        d._deregister(b'w1', 'heartbeat lapsed (test)')
        d._handle(sock, [b'w1', proto.MSG_HEARTBEAT])
        rebound = (d._workers[b'w1'].job_id == bound_job, b'w1' in d._jobs[other].workers)
        d._remove_job(d._jobs[bound_job], 'test teardown')
        d._deregister(b'w1', 'heartbeat lapsed (test)')
        sock.sent.clear()
        d._handle(sock, [b'w1', proto.MSG_HEARTBEAT])
        stopped = any(frames[1] == proto.MSG_STOP for frames in sock.sent
                      if frames[0] == b'w1')
        return rebound, d._workers[b'w1'].job_id, d._workers[b'w1'].ready, stopped

    assert both(run) == {name: ((True, False), None, False, True) for name in PACKAGES}


# -- supervisor unit drills (stub processes) ------------------------------------------


class _StubProc:
    def __init__(self, pid):
        self.pid = pid
        self.exit_code = None
        self.signals = []

    def poll(self):
        return self.exit_code

    def send_signal(self, sig):
        self.signals.append(sig)

    def terminate(self):
        self.signals.append(signal.SIGTERM)
        self.exit_code = 0

    def kill(self):
        self.exit_code = -9

    def wait(self, timeout=None):
        return self.exit_code


class _StubDispatcher:
    def __init__(self):
        self.stats_value = {'items_pending': 0, 'items_assigned': 0, 'workers_alive': 0}
        self.alive = set()
        self.cordoned = []

    def stats(self):
        return dict(self.stats_value)

    def alive_worker_pids(self):
        return set(self.alive)

    def cordon_worker_by_pid(self, pid):
        self.cordoned.append(pid)
        return True

    def worker_inflight_by_pid(self, pid):
        return 0


def _stub_supervisor(pkg, **kwargs):
    dispatcher = _StubDispatcher()
    pids = iter(range(1000, 2000))
    procs = []

    def spawn(worker_id):
        proc = _StubProc(next(pids))
        procs.append(proc)
        return proc

    sup = pkg.WorkerSupervisor(dispatcher, 'tcp://stub', spawn=spawn, **kwargs)
    return sup, dispatcher, procs


def _decisions(sup):
    """The decision log without its wall-clock stamps."""
    return [{k: v for k, v in d.items() if k != 'ts'} for d in sup.decisions()]


def test_breaker_opens_after_exactly_k_deaths_and_backs_off():
    def run(pkg):
        sup, dispatcher, procs = _stub_supervisor(pkg, initial_workers=1, min_workers=1,
                                                  max_workers=1, breaker_deaths=3,
                                                  breaker_window_s=120.0)
        sup.start()
        try:
            spawned = [len(procs)]
            for _ in range(3):
                procs[-1].exit_code = 13
                sup.tick()
                spawned.append(len(procs))
            slot = sup.status()['slots'][0]
            opened = (slot['breaker_open'], slot['breaker_backoff_level'])
            flapping = [e['detail']['deaths'] for e in _anomalies(pkg, 'worker_flapping')]
            sup._slots[0].open_until = 0.0
            sup.tick()
            spawned.append(len(procs))
            sup._slots[0].spawned_at -= 121.0
            dispatcher.alive.add(procs[-1].pid)
            sup.tick()
            slot = sup.status()['slots'][0]
            return (spawned, opened, flapping, (slot['breaker_open'],
                                                slot['breaker_backoff_level']), _decisions(sup))
        finally:
            sup.stop()

    out = both(run)
    assert out['torch'] == out['jax']
    spawned, opened, flapping, closed, decisions = out['torch']
    assert spawned == [1, 2, 3, 3, 4] and opened == (True, 1) and flapping == [3]
    assert closed == (False, 0)
    actions = [d['action'] for d in decisions]
    assert 'breaker_open' in actions and 'breaker_close' in actions


def test_supervisor_scales_up_on_saturation_and_releases_on_idle():
    def run(pkg):
        sup, dispatcher, procs = _stub_supervisor(pkg, initial_workers=1, min_workers=1,
                                                  max_workers=2)
        sup.start()
        try:
            dispatcher.alive.update(p.pid for p in procs)
            dispatcher.stats_value = {'items_pending': 5, 'items_assigned': 1,
                                      'workers_alive': 1}
            for _ in range(3):
                sup.tick()
            recruited = (sup.target, len(procs))
            dispatcher.alive.update(p.pid for p in procs)
            for _ in range(5):
                sup.tick()
            ceiling = sup.target
            dispatcher.stats_value = {'items_pending': 0, 'items_assigned': 0,
                                      'workers_alive': 2}
            for _ in range(10):
                sup.tick()
            released_target = sup.target
            sup.tick()
            released = [p for p in procs if signal.SIGTERM in p.signals]
            released[0].exit_code = 0
            sup.tick()
            status = sup.status()
            return (recruited, ceiling, released_target, len(dispatcher.cordoned),
                    len(released), status['released_total'], len(status['slots']),
                    _decisions(sup))
        finally:
            sup.stop()

    out = both(run)
    assert out['torch'] == out['jax']
    assert out['torch'][:7] == ((2, 2), 2, 1, 1, 1, 1, 1)
    actions = [d['action'] for d in out['torch'][7]]
    assert 'scale_up_decision' in actions and 'worker_release' in actions


def test_spawn_faultpoint_is_registered_and_deterministic(monkeypatch):
    def run(pkg):
        arm(monkeypatch, 'service.spawn:error')
        sup, dispatcher, procs = _stub_supervisor(pkg, initial_workers=1, min_workers=1,
                                                  max_workers=1, breaker_deaths=2,
                                                  breaker_window_s=60.0)
        sup.start()
        try:
            before = len(procs)
            sup.tick()
            opened = sup.status()['slots'][0]['breaker_open']
            fired = pkg.faults.injection_stats()['service.spawn']['fired']
            arm(monkeypatch, None)
            sup._slots[0].open_until = 0.0
            sup.tick()
            return before, opened, fired, len(procs)
        finally:
            arm(monkeypatch, None)
            sup.stop()

    out = both(run)
    assert out['torch'] == out['jax']
    before, opened, fired, after = out['torch']
    assert before == 0 and opened is True and fired >= 2 and after == 1


# -- the mixed pairs: one package's client on the other's daemon --------------------------


@pytest.mark.parametrize('client,daemon', [('torch', 'jax'), ('jax', 'torch')],
                         ids=['port-client-jax-daemon', 'jax-client-port-daemon'])
def test_the_other_packages_daemon_serves_the_client(client, daemon):
    """A client of one package reads two jobs off the other package's
    supervised daemon, exact; then the daemon is SIGKILLed mid-job with
    standing workers and restarted, and the client's re-submission keeps
    the epoch exact."""
    client_pkg, daemon_pkg = PACKAGES[client], PACKAGES[daemon]
    served = _make_daemon(daemon_pkg, workers=2)
    try:
        for job in range(2):
            pool = _client(client_pkg, served.endpoint, name='mixed-%d' % job)
            try:
                pool.start(client_pkg.stubs.SleepyIdentityWorker)
                for i in range(20):
                    pool.ventilate(i, sleep_s=0.005)
                assert sorted(_drain(client_pkg, pool)) == list(range(20))
            finally:
                _stop(pool)
        assert served.dispatcher.stats()['jobs_seen'] == 2
    finally:
        served.stop()
    assert _standing_restart_drill(daemon_pkg, client_pkg, daemon_pkg) == \
        (list(range(30)), True, True)


@pytest.mark.parametrize('name', ['jax', 'torch'])
def test_cli_daemon_drains_on_sigterm_and_exits_clean(name):
    """The CLI daemon with its supervised fleet serves a job, then SIGTERM
    drains it (no job left) to exit code 0, its workers reaped."""
    import psutil
    pkg = PACKAGES[name]
    endpoint = 'tcp://127.0.0.1:%d' % pkg.protocol.free_tcp_port()
    proc = spawn_daemon_cli(pkg, endpoint, extra=['--workers', '2'], supervise=True)
    pool = _client(pkg, endpoint, name='cli-job', connect_timeout_s=60)
    try:
        pool.start(pkg.stubs.SleepyIdentityWorker)
        for i in range(10):
            pool.ventilate(i, sleep_s=0.005)
        assert sorted(_drain(pkg, pool)) == list(range(10))
        workers = [c.pid for c in psutil.Process(proc.pid).children(recursive=True)]
        assert len(workers) >= 2
    finally:
        _stop(pool)
    proc.send_signal(signal.SIGTERM)
    try:
        assert proc.wait(timeout=60) == 0
    finally:
        reap([proc])
    await_condition(lambda: not [p for p in workers if psutil.pid_exists(p)
                                 and psutil.Process(p).status() != psutil.STATUS_ZOMBIE],
                    message='supervised workers reaped')


def test_standing_service_takes_every_reference_argument():
    """``ServiceDaemon``, ``DaemonClientPool``, ``StandbyDaemon`` and
    ``WorkerSupervisor`` take the reference's arguments at its positions
    with its defaults, and the CLI takes the reference's flags."""
    import inspect

    def params(fn):
        return [(p.name, p.default) for p in inspect.signature(fn).parameters.values()]

    jax_pkg, torch_pkg = PACKAGES['jax'], PACKAGES['torch']
    for name in ('ServiceDaemon', 'DaemonClientPool', 'StandbyDaemon', 'WorkerSupervisor'):
        assert params(getattr(torch_pkg, name).__init__) == \
            params(getattr(jax_pkg, name).__init__), name
    for name in ('start', 'ventilate', 'get_results', 'stop', 'join'):
        assert params(getattr(torch_pkg.DaemonClientPool, name)) == \
            params(getattr(jax_pkg.DaemonClientPool, name)), name
    import subprocess
    import sys
    helps = {}
    for name, pkg in PACKAGES.items():
        text = subprocess.run([sys.executable, '-m', pkg.daemon_cli, '--help'],
                              capture_output=True, text=True, timeout=120,
                              env=dict(os.environ, JAX_PLATFORMS='cpu')).stdout
        helps[name] = sorted(w.rstrip(',') for w in text.split() if w.startswith('--'))
    assert helps['torch'] == helps['jax'] and '--standby' in helps['torch']
