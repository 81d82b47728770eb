"""The decode service's failure domains on the port against the JAX
package's, case for case with ``tests/test_chaos.py``'s service drills and
its soak: the retry budget and quarantine, ``poison_policy``, the
read-deadline wedge error, a dispatcher replaced without a goodbye, and
transient faults over a whole loader epoch. Each drill runs through both
packages with the same faults and compares what they count and raise.

Faults are armed through ``monkeypatch`` plus ``refresh_faults()`` in both
packages (``torch_service_common.arm``); spawned fleets inherit them."""

import collections
import re
import threading
import time

import numpy as np
import pytest

from petastorm_tpu.jax import make_jax_loader
from petastorm_tpu_torch.device.loader import make_torch_loader
from tests.torch_service_common import (
    FAST, PACKAGES, arm, both, drain, reap, spawn_cli_worker,
)
from tests.torch_telemetry_common import telemetry_guard  # noqa: F401 - autouse

pytestmark = pytest.mark.service


def _descriptor(health):
    (descriptor,) = health['poisoned']
    return {k: descriptor[k] for k in ('item_id', 'attempts', 'reason', 'error', 'job_id')}


def test_deterministic_error_quarantines_after_exact_budget():
    """An item that always errors is tried exactly ``max_retries`` times,
    then quarantined (diagnostics, /health, the anomaly ring and the
    report), while every other item arrives once: the same in both."""
    def run(pkg):
        pkg.telemetry.reset_for_tests()
        pool = pkg.ServicePool(spawn_local_workers=2, max_retries=2, retry_backoff_s=0.02,
                               poison_policy='skip', **FAST)
        pool.start(pkg.stubs.ExceptionOnFiveWorker)
        try:
            for i in range(10):
                pool.ventilate(i)
            results = sorted(drain(pkg, pool))
            diag = pool.diagnostics
            events = [e for e in pkg.telemetry.recent_anomalies()
                      if e['kind'] == 'row_group_poisoned']
            return {'results': results,
                    'poisoned': diag['items_poisoned'], 'retried': diag['items_retried'],
                    'health': _descriptor(pool._dispatcher.health()),
                    'pool_attempts': [d['attempts'] for d in pool.poisoned_items],
                    'events': [e['detail']['attempts'] for e in events],
                    'by_kind': pkg.telemetry.pipeline_report()['anomalies']['by_kind'].get(
                        'row_group_poisoned'),
                    'service_report': pkg.telemetry.pipeline_report()['service']['poisoned']}
        finally:
            pool.stop()
            pool.join()

    out = both(run)
    assert out['torch'] == out['jax']
    got = out['torch']
    assert got['results'] == [i for i in range(10) if i != 5]
    # budget 2 = one backoff retry, then quarantine on the second failure
    assert (got['poisoned'], got['retried']) == (1, 1)
    assert got['health']['attempts'] == 2 and 'value was 5' in got['health']['error']
    assert got['pool_attempts'] == got['events'] == [2]
    assert got['by_kind'] == got['service_report'] == 1


def test_worker_killing_item_quarantines_instead_of_crash_looping():
    """A row-group that kills every worker touching it: each death
    re-ventilates and charges the budget; after exactly ``max_retries``
    corpses it is quarantined and the survivors finish the epoch."""
    def run(pkg):
        pool = pkg.ServicePool(spawn_local_workers=4, max_retries=2, retry_backoff_s=0.02,
                               poison_policy='skip', **FAST)
        pool.start(pkg.stubs.ExitOnFiveWorker)
        try:
            for i in range(20):
                pool.ventilate(i)
            results = sorted(drain(pkg, pool))
            diag = pool.diagnostics
            descriptor = _descriptor(pool._dispatcher.health())
            return {'results': results, 'poisoned': diag['items_poisoned'],
                    'reventilated_at_least_2': diag['items_reventilated'] >= 2,
                    'attempts': descriptor['attempts'],
                    'lapsed': 'lapsed' in descriptor['reason'],
                    'error': descriptor['error'],
                    'dead': sum(1 for p in pool._local_procs if p.poll() is not None)}
        finally:
            pool.stop()
            pool.join()

    out = both(run)
    assert out['torch'] == out['jax'] == {
        'results': [i for i in range(20) if i != 5], 'poisoned': 1,
        'reventilated_at_least_2': True, 'attempts': 2, 'lapsed': True, 'error': None,
        'dead': 2}


def test_poison_policy_raise_surfaces_rowgroup_poisoned_error():
    def run(pkg):
        pool = pkg.ServicePool(spawn_local_workers=3, max_retries=2, retry_backoff_s=0.02,
                               **FAST)  # default: raise
        pool.start(pkg.stubs.ExitOnFiveWorker)
        try:
            for i in range(8):
                pool.ventilate(i)
            with pytest.raises(pkg.errors.RowGroupPoisonedError) as info:
                drain(pkg, pool)
            return (info.value.info['attempts'],
                    "poison_policy='skip'" in str(info.value),
                    sorted(info.value.info))
        finally:
            pool.stop()
            pool.join()

    out = both(run)
    assert out['torch'] == out['jax']
    assert out['torch'][:2] == (2, True)


def test_ghost_error_from_prior_owner_does_not_cancel_live_assignment():
    """A lapsed worker's late ERROR for an item already reassigned is
    ignored: no phantom attempt, the live assignment stands."""
    def run(pkg):
        d = pkg.dispatcher.Dispatcher('tcp://127.0.0.1:0', b'', lambda e: True,
                                      threading.Event(), max_retries=3, retry_backoff_s=0.01)
        item = d.submit(b'payload')
        now = time.monotonic()
        live = pkg.dispatcher._WorkerState(b'B', now)
        d._workers[b'B'] = live
        local_job = d._jobs[0]
        local_job.pending.clear()
        local_job.pending_ids.clear()
        d._inflight[item] = (b'B', b'payload')
        live.inflight.add(item)
        d._fail(b'A', item, ValueError('late ghost'), now)
        after_ghost = (d._inflight[item][0], item in d._attempts)
        # the real owner's failure still charges and requeues
        d._fail(b'B', item, ValueError('real'), now)
        return after_ghost, d._attempts[item], item in d._inflight, len(d._retry)

    out = both(run)
    assert out['torch'] == out['jax'] == ((b'B', False), 1, False, 1)


def test_poison_policy_rejected_for_pools_without_support():
    class ContractOnlyPool:
        start = ventilate = get_results = stop = join = lambda self: None
        workers_count = 1
        diagnostics = {}

    def run(pkg):
        messages = []
        for pool_type in (ContractOnlyPool(), 'thread', 'dummy'):
            with pytest.raises(ValueError, match='poison_policy') as info:
                pkg.reader._make_pool(pool_type, 1, 10, poison_policy='skip')
            messages.append(str(info.value).split(' %r' % pool_type)[0])
        with pytest.raises(ValueError, match="poison_policy must be 'raise' or 'skip'"):
            pkg.reader._make_pool('service', 1, 10, poison_policy='maybe')
        return messages

    out = both(run)
    assert out['torch'] == out['jax']


def test_lost_work_frame_raises_wedge_error_with_fleet_view(monkeypatch):
    """One WORK frame dropped on the wire: the item stays assigned to a
    live worker; the read deadline turns that into ServiceWedgedError
    carrying the fleet view, with the same keys in both packages."""
    def run(pkg):
        arm(monkeypatch, 'zmq.work:drop:1:times=1')
        pool = pkg.ServicePool(spawn_local_workers=1, read_deadline_s=2.0, **FAST)
        pool.start(pkg.stubs.SleepyIdentityWorker)
        try:
            for i in range(4):
                pool.ventilate(i, sleep_s=0.01)
            with pytest.raises(pkg.errors.ServiceWedgedError) as info:
                drain(pkg, pool)
            fleet = info.value.fleet
            assert fleet['workers'], 'fleet view missing'
            assert 'no progress' in str(info.value)
            assert fleet['items_assigned'] >= 1
            (worker,) = fleet['workers'].values()
            return sorted(fleet), sorted(worker)
        finally:
            pool.stop()
            pool.join()
            arm(monkeypatch, None)

    out = both(run)
    assert out['torch'] == out['jax']


def _start_pool_with_bind_retry(pkg, endpoint, deadline_s=15):
    """The previous dispatcher's ROUTER may linger on the port briefly;
    retry the bind like a restarting client would."""
    deadline = time.monotonic() + deadline_s
    while True:
        pool = pkg.ServicePool(endpoint=endpoint, expected_workers=1, **FAST)
        try:
            pool.start(pkg.stubs.SleepyIdentityWorker)
            return pool
        except RuntimeError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.3)


def test_worker_fleet_survives_dispatcher_crash_and_restart(monkeypatch):
    """A dispatcher that dies without its STOP goodbye (``zmq.stop:drop``),
    then a new pool on the same endpoint: the standing CLI worker sees the
    incarnation change in the ack token, re-registers and serves the new
    job, same pid."""
    def run(pkg):
        endpoint = 'tcp://127.0.0.1:%d' % pkg.protocol.free_tcp_port()
        proc = spawn_cli_worker(pkg, endpoint, faults=False)
        try:
            pool1 = _start_pool_with_bind_retry(pkg, endpoint)
            for i in range(6):
                pool1.ventilate(i, sleep_s=0.01)
            first = sorted(drain(pkg, pool1))
            arm(monkeypatch, 'zmq.stop:drop')
            pool1.stop()
            pool1.join()
            arm(monkeypatch, None)
            pool2 = _start_pool_with_bind_retry(pkg, endpoint)
            try:
                for i in range(10, 16):
                    pool2.ventilate(i, sleep_s=0.01)
                second = sorted(drain(pkg, pool2))
                return first, second, proc.poll() is None
            finally:
                pool2.stop()
                pool2.join()
        finally:
            reap([proc])

    out = both(run)
    assert out['torch'] == out['jax'] == (list(range(6)), list(range(10, 16)), True)


@pytest.fixture
def scalar_url(tmp_path):
    from tests.test_common import create_test_scalar_dataset
    url = 'file://' + str(tmp_path / 'dataset')
    create_test_scalar_dataset(url, num_rows=50, num_files=5)
    return url


def test_chaos_soak_loader_epoch_delivers_exact_rows(scalar_url, monkeypatch):
    """Transient faults at two sites over one loader epoch on the service:
    ``make_torch_loader`` and ``make_jax_loader`` each deliver exactly the
    dataset, retries absorb every fault, nothing is quarantined and the
    injections come back in the ERROR frames' deltas. ``times=1`` fires
    each clause once per worker process, whichever items it draws."""
    arm(monkeypatch, 'io.read:error:1:times=1,decode.rowgroup:error:1:times=1')

    def run(pkg, make):
        # budget 6 > the 4 one-shot faults even if one item ate them all
        pool = pkg.ServicePool(spawn_local_workers=2, retry_backoff_s=0.02, max_retries=6,
                               poison_policy='skip', **FAST)
        kw = dict(batch_size=10, fields=['^id$'], num_epochs=1, last_batch='short',
                  reader_pool_type=pool, shuffle_row_groups=False)
        if pkg.name == 'torch':
            kw['device'] = 'cpu'
        seen = collections.Counter()
        with make(scalar_url, **kw) as loader:
            for batch in loader:
                seen.update(int(x) for x in np.asarray(batch['id']))
        injected = pkg.telemetry.get_registry().counters_with_prefix(pkg.faults.FAULTS_INJECTED)
        return {'rows': sorted(seen.elements()), 'quarantined': pool.poisoned_items,
                'retried': pool.diagnostics['items_retried'] >= 1,
                'injected': sum(injected.values()) >= 1}

    out = {'jax': run(PACKAGES['jax'], make_jax_loader),
           'torch': run(PACKAGES['torch'], make_torch_loader)}
    assert out['torch'] == out['jax'] == {'rows': list(range(50)), 'quarantined': [],
                                          'retried': True, 'injected': True}


def test_spawned_fleet_start_up_death_is_reported():
    """A worker-server process that exits before registering fails
    ``start()`` with the same error in both packages."""
    def run(pkg):
        pool = pkg.ServicePool(spawn_local_workers=1, expected_workers=1, **FAST)
        pool._connect_timeout_s = 30
        real_spawn = pool._spawn_workers

        def spawn_then_kill():
            real_spawn()
            for proc in pool._local_procs:
                proc.kill()
                proc.wait()

        pool._spawn_workers = spawn_then_kill
        with pytest.raises(RuntimeError, match='exited during startup') as info:
            pool.start(pkg.stubs.SleepyIdentityWorker)
        return re.sub(r'\[[0-9, ]+\]', '[pids]', str(info.value))

    out = both(run)
    assert out['torch'] == out['jax']
