"""The port's warm standby, per-job QoS and cache-aware placement against
the JAX package's, case for case with ``tests/test_failover.py``: the
primary daemon and its standing workers run as CLI subprocesses (a SIGKILL
is a real control-plane death) and the standby under test runs in this
process, so its anomalies, trace instants and fault injections land where
the assertions see them. The mixed pairs put a port standby behind a JAX
primary and a JAX standby behind a port primary."""

import collections
import os
import signal
import time

import pytest

from tests.torch_service_common import (
    HB, PACKAGES, arm, await_condition, both, reap, spawn_cli_worker, spawn_daemon_cli,
)
from tests.torch_telemetry_common import telemetry_guard  # noqa: F401 - autouse

pytestmark = pytest.mark.service

_SYNC = 0.2
_LAPSE = 1.2


def _drain(pkg, pool, per_result_timeout_s=60):
    out = []
    while True:
        try:
            out.append(pool.get_results(timeout=per_result_timeout_s))
        except pkg.EmptyResultError:
            return out


def _client(pkg, endpoint, **kwargs):
    kwargs.setdefault('heartbeat_interval_s', HB)
    return pkg.DaemonClientPool(endpoint, **kwargs)


def _stop(*pools):
    for pool in pools:
        pool.stop()
        pool.join()


def _workers(pkg, endpoint, count):
    return [spawn_cli_worker(pkg, endpoint, i, heartbeat_interval_s=HB,
                             extra_args=['--ack-timeout', '1.5']) for i in range(count)]


def _standby(pkg, endpoint, **kwargs):
    """An in-process standby, started only once the primary is known to be
    bound (a standby pointed at an unbound endpoint lapses during the
    primary's start-up and spends its promotion window losing the bind)."""
    kwargs.setdefault('sync_interval_s', _SYNC)
    kwargs.setdefault('lapse_s', _LAPSE)
    kwargs.setdefault('heartbeat_interval_s', HB)
    kwargs.setdefault('supervise', False)
    standby = pkg.StandbyDaemon(endpoint, **kwargs)
    standby.start()
    return standby


def _await_primary_up(pkg, endpoint, deadline_s=30):
    """Block until the daemon at ``endpoint`` answers a replication probe."""
    import zmq
    proto = pkg.protocol
    context = zmq.Context()
    sock = context.socket(zmq.DEALER)
    sock.setsockopt(zmq.LINGER, 0)
    sock.connect(endpoint)
    try:
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline:
            sock.send_multipart([proto.MSG_STANDBY_SYNC])
            if sock.poll(200):
                return
        raise AssertionError('primary at %s never answered' % endpoint)
    finally:
        sock.close(linger=0)
        context.term()


def _failover_events(pkg):
    return [e for e in pkg.telemetry.recent_anomalies() if e['kind'] == 'dispatcher_failover']


def _daemon(pkg, workers):
    daemon = pkg.ServiceDaemon('tcp://127.0.0.1:0', initial_workers=workers,
                               heartbeat_interval_s=HB, supervisor_tick_s=HB)
    daemon.start()
    return daemon


# -- warm-standby promotion ----------------------------------------------------------


def _warm_failover_drill(primary_pkg, standby_pkg, client_pkg):
    """SIGKILL a CLI primary of ``primary_pkg`` mid-epoch with two
    unequal-priority jobs of ``client_pkg``; ``standby_pkg``'s in-process
    standby promotes onto the endpoint and each job stays exact."""
    endpoint = 'tcp://127.0.0.1:%d' % client_pkg.protocol.free_tcp_port()
    primary = spawn_daemon_cli(primary_pkg, endpoint)
    workers = _workers(primary_pkg, endpoint, 3)
    hi = _client(client_pkg, endpoint, name='job-hi', priority=2, ack_timeout_s=1.5,
                 connect_timeout_s=60)
    lo = _client(client_pkg, endpoint, name='job-lo', ack_timeout_s=1.5, connect_timeout_s=60)
    standby = None
    try:
        hi.start(client_pkg.stubs.SleepyIdentityWorker)
        lo.start(client_pkg.stubs.SleepyIdentityWorker)
        standby = _standby(standby_pkg, endpoint)
        for i in range(30):
            hi.ventilate(i, sleep_s=0.05)
        for i in range(100, 130):
            lo.ventilate(i, sleep_s=0.05)
        got_hi = [hi.get_results(timeout=60) for _ in range(5)]
        got_lo = [lo.get_results(timeout=60) for _ in range(5)]
        await_condition(lambda: standby.health()['snapshot_jobs'] == 2,
                        message='warm replication of both jobs')
        t_kill = time.monotonic()
        os.kill(primary.pid, signal.SIGKILL)
        primary.wait()
        assert standby.wait_promoted(30), 'standby must take over'
        blackout_s = time.monotonic() - t_kill
        got_hi.extend(_drain(client_pkg, hi))
        got_lo.extend(_drain(client_pkg, lo))
        events = _failover_events(standby_pkg)
        health = standby.health()
        qos = {q['name']: q['priority'] for q in health['qos']}
        return {'rows': (sorted(got_hi), sorted(got_lo)), 'role': standby.role,
                'in_window': blackout_s < _LAPSE + 8.0,
                'events': [(e['detail']['warm'], e['detail']['snapshot_jobs']) for e in events],
                'health': (health['role'], health['promotions']), 'qos': qos,
                'reregistered': (hi.diagnostics['reregistrations'] >= 1,
                                 lo.diagnostics['reregistrations'] >= 1),
                'workers_alive': all(w.poll() is None for w in workers)}
    finally:
        _stop(hi, lo)
        if standby is not None:
            standby.stop()
        reap([primary] + workers)


_WARM = {'rows': (list(range(30)), list(range(100, 130))), 'role': 'primary',
         'in_window': True, 'events': [(True, 2)], 'health': ('primary', 1),
         'qos': {'job-hi': 2, 'job-lo': 0}, 'reregistered': (True, True),
         'workers_alive': True}


def test_warm_failover_sigkill_two_priority_jobs_exact():
    assert both(lambda pkg: _warm_failover_drill(pkg, pkg, pkg)) == \
        {name: _WARM for name in PACKAGES}


@pytest.mark.parametrize('primary,standby', [('jax', 'torch'), ('torch', 'jax')],
                         ids=['port-standby-jax-primary', 'jax-standby-port-primary'])
def test_the_other_packages_standby_mirrors_and_replaces_the_primary(primary, standby):
    """A standby of one package mirrors the other package's primary (the
    snapshot frames are byte-equal), promotes onto its endpoint after a
    SIGKILL, and the primary package's clients and workers carry on
    against it, exact."""
    assert _warm_failover_drill(PACKAGES[primary], PACKAGES[standby], PACKAGES[primary]) == \
        _WARM


@pytest.fixture(scope='module')
def scalar_url(tmp_path_factory):
    from tests.test_common import create_test_scalar_dataset
    url = 'file://' + str(tmp_path_factory.mktemp('failover') / 'dataset')
    create_test_scalar_dataset(url, num_rows=50, num_files=5)
    return url


def test_reader_completes_through_failover(scalar_url):
    def read_ids(pkg, pool, kill=None):
        ids = collections.Counter()
        killed = False
        with pkg.reader.make_batch_reader(scalar_url, reader_pool_type=pool, num_epochs=1,
                                          shuffle_row_groups=False) as reader:
            for batch in reader:
                ids.update(int(x) for x in batch.id)
                if kill is not None and not killed and kill.poll() is None:
                    killed = True
                    os.kill(kill.pid, signal.SIGKILL)
        return ids

    expected = read_ids(PACKAGES['jax'], 'thread')
    assert sum(expected.values()) == 50

    def run(pkg):
        endpoint = 'tcp://127.0.0.1:%d' % pkg.protocol.free_tcp_port()
        primary = spawn_daemon_cli(pkg, endpoint)
        workers = _workers(pkg, endpoint, 2)
        standby = None
        try:
            _await_primary_up(pkg, endpoint)
            standby = _standby(pkg, endpoint)
            pool = _client(pkg, endpoint, name='reader-ha', ack_timeout_s=1.5,
                           connect_timeout_s=60)
            got = read_ids(pkg, pool, kill=primary)
            return got, standby.wait_promoted(30), standby.role
        finally:
            if standby is not None:
                standby.stop()
            reap([primary] + workers)

    assert both(run) == {name: (expected, True, 'primary') for name in PACKAGES}


def test_standby_death_is_harmless():
    def run(pkg):
        daemon = _daemon(pkg, 2)
        standby_proc = spawn_daemon_cli(pkg, daemon.endpoint,
                                        extra=['--standby', '--standby-sync-interval',
                                               str(_SYNC), '--standby-lapse', '30'])
        pool = _client(pkg, daemon.endpoint, name='survivor')
        try:
            pool.start(pkg.stubs.SleepyIdentityWorker)
            for i in range(30):
                pool.ventilate(i, sleep_s=0.02)
            await_condition(lambda: daemon.dispatcher.health()['standby_syncs_served'] >= 2,
                            message='standby replication stream')
            os.kill(standby_proc.pid, signal.SIGKILL)
            standby_proc.wait()
            got = sorted(_drain(pkg, pool))
            health = daemon.health()
            return got, health['role'], health['poisoned'], _failover_events(pkg)
        finally:
            _stop(pool)
            reap([standby_proc])
            daemon.stop()

    assert both(run) == {name: (list(range(30)), 'primary', [], []) for name in PACKAGES}


def test_replication_drop_cold_promote_still_exact(monkeypatch):
    """``zmq.replicate:drop`` armed in this process only: the standby
    promotes cold and the client's re-registration keeps the epoch exact."""
    def run(pkg):
        endpoint = 'tcp://127.0.0.1:%d' % pkg.protocol.free_tcp_port()
        primary = spawn_daemon_cli(pkg, endpoint)
        workers = _workers(pkg, endpoint, 2)
        pool = _client(pkg, endpoint, name='cold-drill', ack_timeout_s=1.5,
                       connect_timeout_s=60)
        standby = None
        try:
            pool.start(pkg.stubs.SleepyIdentityWorker)
            for i in range(30):
                pool.ventilate(i, sleep_s=0.05)
            got = [pool.get_results(timeout=60) for _ in range(5)]
            arm(monkeypatch, 'zmq.replicate:drop')
            standby = _standby(pkg, endpoint, lapse_s=1.0)
            await_condition(lambda: pkg.faults.injection_stats().get(
                'zmq.replicate', {}).get('fired', 0) >= 1,
                message='replication frames to be dropped')
            snapshot_jobs = standby.health()['snapshot_jobs']
            os.kill(primary.pid, signal.SIGKILL)
            primary.wait()
            promoted = standby.wait_promoted(45)
            got.extend(_drain(pkg, pool))
            events = _failover_events(pkg)
            return (sorted(got), snapshot_jobs, promoted, standby.role,
                    events[-1]['detail']['warm'] if events else None,
                    pool.diagnostics['reregistrations'] >= 1)
        finally:
            arm(monkeypatch, None)
            _stop(pool)
            if standby is not None:
                standby.stop()
            reap([primary] + workers)

    assert both(run) == {name: (list(range(30)), 0, True, 'primary', False, True)
                         for name in PACKAGES}


def test_promote_faultpoint_retries_until_success(monkeypatch):
    def run(pkg):
        daemon = _daemon(pkg, 1)
        standby = _standby(pkg, daemon.endpoint, sync_interval_s=0.1, lapse_s=0.6)
        try:
            await_condition(lambda: standby.health()['syncs_ok'] >= 1,
                            message='replication before the takeover drill')
            arm(monkeypatch, 'service.promote:error:1:times=2')
            daemon.stop()
            promoted = standby.wait_promoted(30)
            fired = pkg.faults.injection_stats()['service.promote']['fired']
            health = standby.health()
            return promoted, fired, health['role'], health['promotions']
        finally:
            arm(monkeypatch, None)
            standby.stop()
            daemon.stop()

    assert both(run) == {name: (True, 2, 'primary', 1) for name in PACKAGES}


# -- per-job QoS ------------------------------------------------------------------------


def test_priority_preemption_drains_never_strands():
    def run(pkg):
        daemon = _daemon(pkg, 2)
        lo = _client(pkg, daemon.endpoint, name='batch-lo')
        hi = _client(pkg, daemon.endpoint, name='online-hi', priority=3)
        try:
            # both workers up before the low job starts: a fleet whose second
            # worker boots late lets the low job fill its credit first, and
            # the high job is then served by rebalancing, with no preemption
            await_condition(lambda: daemon.dispatcher.stats()['workers_alive'] == 2,
                            message='the supervised fleet up')
            lo.start(pkg.stubs.SleepyIdentityWorker)
            for i in range(100):
                lo.ventilate(i, sleep_s=0.05)
            await_condition(lambda: sum(j['workers'] for j in
                                        daemon.dispatcher.health()['jobs']) == 2,
                            message='fleet bound to the low-priority job')
            hi.start(pkg.stubs.SleepyIdentityWorker)
            for i in range(1000, 1010):
                hi.ventilate(i, sleep_s=0.01)
            await_condition(lambda: daemon.dispatcher.health()['preemptions'] >= 1,
                            message='a preemption decision')
            got = (sorted(_drain(pkg, hi)), sorted(_drain(pkg, lo)))
            stats = daemon.dispatcher.stats()
            return (got, stats['items_poisoned'], stats['items_retried'], hi.poisoned_items,
                    lo.poisoned_items, daemon.dispatcher.health()['preemptions'] >= 1)
        finally:
            _stop(hi, lo)
            daemon.stop()

    assert both(run) == {name: ((list(range(1000, 1010)), list(range(100))), 0, 0, [], [],
                                True) for name in PACKAGES}


def test_weighted_fair_share_three_to_one():
    def run(pkg):
        daemon = _daemon(pkg, 4)
        heavy = _client(pkg, daemon.endpoint, name='heavy', weight=3)
        light = _client(pkg, daemon.endpoint, name='light')
        try:
            heavy.start(pkg.stubs.SleepyIdentityWorker)
            light.start(pkg.stubs.SleepyIdentityWorker)
            for i in range(200):
                heavy.ventilate(i, sleep_s=0.03)
            for i in range(1000, 1100):
                light.ventilate(i, sleep_s=0.03)

            def shares():
                return {q['name']: q for q in daemon.dispatcher.health()['qos']}

            await_condition(lambda: shares()['heavy']['worker_share'] == 0.75
                            and shares()['light']['worker_share'] == 0.25,
                            message='the 3:1 weighted split')
            snap = shares()
            targets = (snap['heavy']['target_share'], snap['light']['target_share'])
            return targets, sorted(_drain(pkg, heavy)), sorted(_drain(pkg, light))
        finally:
            _stop(heavy, light)
            daemon.stop()

    assert both(run) == {name: ((0.75, 0.25), list(range(200)), list(range(1000, 1100)))
                         for name in PACKAGES}


# -- cache-aware placement -------------------------------------------------------------


def test_placement_binds_second_job_to_warm_host():
    def run(pkg):
        daemon = _daemon(pkg, 2)
        pools = []
        try:
            first = _client(pkg, daemon.endpoint, name='cold-pass')
            pools.append(first)
            first.start(pkg.stubs.IdentityWorker, worker_args={'placement_group': 'grp-warm'})
            for i in range(10):
                first.ventilate(i)
            cold = sorted(_drain(pkg, first))
            misses = daemon.dispatcher.health()['placement_misses'] >= 1
            pools.remove(first)
            _stop(first)
            await_condition(lambda: daemon.dispatcher.active_jobs() == 0,
                            message='first job reclaimed')
            second = _client(pkg, daemon.endpoint, name='warm-pass')
            pools.append(second)
            second.start(pkg.stubs.IdentityWorker, worker_args={'placement_group': 'grp-warm'})
            for i in range(100, 110):
                second.ventilate(i)
            warm = sorted(_drain(pkg, second))
            health = daemon.dispatcher.health()
            return (cold, misses, warm, health['placement_enabled'],
                    health['placement_hits'] >= 1)
        finally:
            _stop(*pools)
            daemon.stop()

    assert both(run) == {name: (list(range(10)), True, list(range(100, 110)), True, True)
                         for name in PACKAGES}
