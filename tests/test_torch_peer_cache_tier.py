"""The fleet cache tier's holder side on the port against the JAX package's,
case for case with ``tests/test_peer_cache.py``'s server, client and fleet
cases: each runs through both packages' ``PeerCacheServer``,
``PeerCacheClient`` and worker-server fleets and compares frames, counters
and decode counts. The mixed pairs serve one package's fetcher from the
other package's holder, which also shows that an entry the JAX package
wrote passes the port's length and sha1 check and reads back in the port,
bytes equal.

Fleets are CLI worker servers over ``tcp://`` loopback with disjoint
``--cache-dir`` directories (one a simulated host); every ``get_results``
has a timeout and every fleet is reaped in ``finally``."""

import contextlib
import os
import signal

import numpy as np
import pytest

from tests.torch_service_common import FAST, PACKAGES, both, reap, spawn_cli_worker
from tests.torch_telemetry_common import telemetry_guard  # noqa: F401 - autouse

pytestmark = pytest.mark.service


def _cache(pkg, path, mem_mb=0):
    return pkg.materialized_cache.MaterializedRowGroupCache(str(path), 10 ** 9,
                                                            mem_limit_bytes=mem_mb * 2 ** 20)


def _fill_entry(pkg, cache, key, value, n=64):
    batch = cache.get(key, lambda: pkg.ColumnBatch({'v': np.full(n, value, dtype=np.int64)}, n))
    return cache._entry_path(key), batch


@contextlib.contextmanager
def _server(pkg, cache_dir):
    server = pkg.peer_cache.PeerCacheServer(str(cache_dir))
    try:
        yield server
    finally:
        server.close()


def _raw_fetch(pkg, endpoint, digest, timeout_s=5.0):
    import zmq
    proto = pkg.protocol
    context = zmq.Context()
    sock = context.socket(zmq.DEALER)
    try:
        sock.setsockopt(zmq.LINGER, 0)
        sock.connect(endpoint)
        sock.send_multipart([proto.MSG_PEER_FETCH, digest.encode()])
        assert sock.poll(int(timeout_s * 1000)), 'serve socket silent'
        return sock.recv_multipart()
    finally:
        sock.close(0)
        context.term()


def _counter(pkg, name, **labels):
    return pkg.telemetry.get_registry().counter_value(name, **labels)


# -- worker side: the serve socket ---------------------------------------------------


def test_serves_entry_bytes_chunked_and_verified(tmp_path, monkeypatch):
    def run(pkg):
        # tiny chunks force real multipart streaming of one entry
        monkeypatch.setattr(pkg.peer_cache, '_CHUNK_BYTES', 1024)
        cache = _cache(pkg, tmp_path / pkg.name / 'a')
        entry, _ = _fill_entry(pkg, cache, 'k', 7, n=4096)
        digest = pkg.peer_cache.entry_digest(entry)
        with _server(pkg, cache.path) as server:
            frames = _raw_fetch(pkg, server.endpoint, digest)
            meta = pkg.protocol.load_json_params(frames[2])
            blob = b''.join(frames[3:])
            with open(entry, 'rb') as f:
                on_disk = f.read()
            return (frames[0], frames[1] == digest.encode(), len(frames) > 4,
                    meta['size'] == len(blob) == len(on_disk), blob == on_disk, server.served,
                    server.health_snapshot()['entries'], digest, len(frames))

    out = both(run)
    assert out['torch'] == out['jax']
    assert out['torch'][:7] == (PACKAGES['torch'].protocol.MSG_PEER_ENTRY, True, True, True,
                                True, 1, 1)


def test_unknown_digest_answers_honest_miss(tmp_path):
    def run(pkg):
        with _server(pkg, tmp_path / pkg.name) as server:
            return _raw_fetch(pkg, server.endpoint, '0' * 40)

    out = both(run)
    assert out['torch'] == out['jax'] == [b'PMISS', b'0' * 40]


def test_register_advert_scans_directory_durably(tmp_path):
    """Entries a previous process left are advertised from the start-up
    scan."""
    def run(pkg):
        cache = _cache(pkg, tmp_path / pkg.name / 'a')
        _fill_entry(pkg, cache, 'k1', 1)
        _fill_entry(pkg, cache, 'k2', 2)
        with _server(pkg, cache.path) as server:
            full = server.full_advert()
            want = {pkg.peer_cache.entry_digest(cache._entry_path(k)) for k in ('k1', 'k2')}
            return (full['ep'] == server.endpoint, {row[0] for row in full['full']} == want,
                    sorted(row[0] for row in full['full']),
                    all(row[1] > 0 for row in full['full']))

    out = both(run)
    assert out['torch'] == out['jax']
    assert out['torch'][0] and out['torch'][1] and out['torch'][3]


def test_heartbeat_delta_carries_adds_and_removes(tmp_path):
    def run(pkg):
        cache = _cache(pkg, tmp_path / pkg.name / 'a')
        with _server(pkg, cache.path) as server:
            server.full_advert()
            quiet = server.advert_delta()
            entry, _ = _fill_entry(pkg, cache, 'k', 3)  # the publish listener's path
            digest = pkg.peer_cache.entry_digest(entry)
            delta = server.advert_delta()
            added = (delta['ep'] == server.endpoint, [row[0] for row in delta['add']] == [digest])
            os.remove(entry)
            server._last_scan = 0.0  # past the rescan rate limit
            removed = server.advert_delta()['rm'] == [digest]
            return quiet, added, removed, server.advert_delta(), digest

    out = both(run)
    assert out['torch'] == out['jax']
    assert out['torch'][:4] == (None, (True, True), True, None)


def test_evict_hint_declines_hot_entry_removes_cold(tmp_path):
    def run(pkg):
        cache = _cache(pkg, tmp_path / pkg.name / 'a')
        entry, _ = _fill_entry(pkg, cache, 'k', 1)
        digest = pkg.peer_cache.entry_digest(entry)
        with _server(pkg, cache.path) as server:
            server.full_advert()
            hot = (server.apply_evict_hints([digest]), os.path.exists(entry))
            os.utime(entry, (1.0, 1.0))  # ancient: the fleet's hint wins
            cold = (server.apply_evict_hints([digest]), os.path.exists(entry),
                    server.evicted_on_hint)
            return hot, cold, server.apply_evict_hints(['not-a-digest', digest])

    assert both(run) == {name: ((0, True), (1, False, 1), 0) for name in PACKAGES}


# -- worker side: the fetch path -------------------------------------------------------


def _client(pkg, mirror=None, self_endpoint=None):
    # a dispatcher endpoint nobody answers: DIRGET lookups time out
    client = pkg.peer_cache.PeerCacheClient(
        'tcp://127.0.0.1:%d' % pkg.protocol.free_tcp_port(), self_endpoint=self_endpoint)
    if mirror:
        client.update_directory(mirror)
    return client


def _fetch_across(holder, fetcher, tmp_path):
    """``holder``'s cache writes the entry and its server serves it;
    ``fetcher``'s client fetches it into ``fetcher``'s cache."""
    cache_a = _cache(holder, tmp_path / 'a')
    entry_a, _ = _fill_entry(holder, cache_a, 'k', 42)
    digest = holder.peer_cache.entry_digest(entry_a)
    cache_b = _cache(fetcher, tmp_path / 'b')
    entry_b = cache_b._entry_path('k')
    with _server(holder, cache_a.path) as server:
        client = _client(fetcher, {digest: [[server.endpoint, os.path.getsize(entry_a)]]})
        try:
            served = client.fetch('k', entry_b, cache_b)
        finally:
            client.close()
        holder_served = server.served
    assert served is not None
    columns, length = served
    with open(entry_a, 'rb') as fa, open(entry_b, 'rb') as fb:
        same_bytes = fa.read() == fb.read()
    # the published entry reads back through the fetcher's own cache
    again = cache_b.get('k', lambda: pytest.fail('the fetched entry must be a hit'))
    return {'length': length, 'values': np.asarray(columns['v']).tolist(),
            'same_bytes': same_bytes, 'entry_b': os.path.basename(entry_b),
            'reread': np.asarray(again.columns['v']).tolist(), 'holder_served': holder_served,
            'hits': _counter(fetcher, fetcher.peer_cache.PEER_CACHE_HITS),
            'stage_calls': _counter(fetcher, 'petastorm_tpu_stage_calls_total',
                                    stage='peer_fetch'),
            'client': (client.stats()['hits'], client.stats()['budget_used'])}


_FETCHED = {'length': 64, 'values': [42] * 64, 'same_bytes': True, 'reread': [42] * 64,
            'holder_served': 1, 'hits': 1, 'stage_calls': 1, 'client': (1, 0)}


def test_fetch_serves_wire_parity_entry(tmp_path, monkeypatch):
    monkeypatch.setenv('PETASTORM_TPU_PEER_CACHE_TIMEOUT_S', '5')
    out = both(lambda pkg: _fetch_across(pkg, pkg, tmp_path / pkg.name))
    assert out['torch'] == out['jax']
    assert {k: v for k, v in out['torch'].items() if k != 'entry_b'} == _FETCHED


@pytest.mark.parametrize('holder,fetcher', [('jax', 'torch'), ('torch', 'jax')],
                         ids=['port-fetcher-jax-holder', 'jax-fetcher-port-holder'])
def test_the_other_packages_holder_serves_the_fetcher(tmp_path, monkeypatch, holder, fetcher):
    """The entry one package wrote and serves reaches the other package's
    fetcher through the same frames: its length and sha1 check passes, the
    published copy is byte-equal and the fetcher's cache reads it back."""
    monkeypatch.setenv('PETASTORM_TPU_PEER_CACHE_TIMEOUT_S', '5')
    got = _fetch_across(PACKAGES[holder], PACKAGES[fetcher], tmp_path)
    # both packages name an entry by the same key digest
    assert got['entry_b'] == _fetch_across(PACKAGES[holder], PACKAGES[holder],
                                           tmp_path / 'same')['entry_b']
    assert {k: v for k, v in got.items() if k not in ('entry_b', 'hits', 'stage_calls')} == \
        {k: v for k, v in _FETCHED.items() if k not in ('hits', 'stage_calls')}


def test_every_failure_degrades_with_its_reason(tmp_path, monkeypatch):
    monkeypatch.setenv('PETASTORM_TPU_PEER_CACHE_TIMEOUT_S', '0.1')

    def run(pkg):
        proto = pkg.protocol
        misses = pkg.peer_cache.PEER_CACHE_MISSES
        cache = _cache(pkg, tmp_path / pkg.name / 'b')
        entry = cache._entry_path('k')
        digest = pkg.peer_cache.entry_digest(entry)
        out = []
        client = _client(pkg)
        try:
            out.append(client.fetch('k', entry, cache))
            dead = 'tcp://127.0.0.1:%d' % proto.free_tcp_port()
            client.update_directory({digest: [[dead, 128]]})
            out.append(client.fetch('k', entry, cache))
            out.append(client.stats()['mirror'])
        finally:
            client.close()
        with _server(pkg, tmp_path / pkg.name / 'empty') as server:
            client = _client(pkg, {digest: [[server.endpoint, 128]]})
            try:
                out.append(client.fetch('k', entry, cache))
            finally:
                client.close()
        client = _client(pkg)
        try:
            client.update_directory({digest: [['tcp://127.0.0.1:1', 3]]})
            monkeypatch.setattr(client, '_request', lambda endpoint, d: [
                proto.MSG_PEER_ENTRY, d.encode(),
                proto.dump_json_params({'size': 3, 'sha1': '0' * 40}), b'abc'])
            out.append(client.fetch('k', entry, cache))
            out.append(os.path.exists(entry))
        finally:
            client.close()
        out.append({r: _counter(pkg, misses, reason=r)
                    for r in ('no_holder', 'timeout', 'peer_miss', 'corrupt')})
        out.append(client.stats()['budget_used'])
        return out

    assert both(run) == {name: [None, None, 0, None, None, False,
                                {'no_holder': 1, 'timeout': 1, 'peer_miss': 1, 'corrupt': 1},
                                0] for name in PACKAGES}


def test_budget_exhaustion_declines_not_buffers(tmp_path, monkeypatch):
    monkeypatch.setenv('PETASTORM_TPU_PEER_CACHE_BUDGET_MB', '1')

    def run(pkg):
        cache = _cache(pkg, tmp_path / pkg.name / 'b')
        entry = cache._entry_path('k')
        digest = pkg.peer_cache.entry_digest(entry)
        client = _client(pkg, {digest: [['tcp://127.0.0.1:1', 2 << 20]]})
        try:
            return (client.fetch('k', entry, cache),
                    _counter(pkg, pkg.peer_cache.PEER_CACHE_MISSES, reason='budget'))
        finally:
            client.close()

    assert both(run) == {name: (None, 1) for name in PACKAGES}


def test_own_endpoint_is_never_fetched_from(tmp_path, monkeypatch):
    monkeypatch.setenv('PETASTORM_TPU_PEER_CACHE_TIMEOUT_S', '0.1')

    def run(pkg):
        cache = _cache(pkg, tmp_path / pkg.name / 'b')
        entry = cache._entry_path('k')
        digest = pkg.peer_cache.entry_digest(entry)
        me = 'tcp://127.0.0.1:9'
        client = _client(pkg, {digest: [[me, 128]]}, self_endpoint=me)
        try:
            return (client.fetch('k', entry, cache),
                    _counter(pkg, pkg.peer_cache.PEER_CACHE_MISSES, reason='no_holder'))
        finally:
            client.close()

    assert both(run) == {name: (None, 1) for name in PACKAGES}


def test_peer_fetch_report_section_and_format(tmp_path, monkeypatch):
    """The pipeline report grows a ``peer_cache`` section only once the
    tier did something."""
    monkeypatch.setenv('PETASTORM_TPU_PEER_CACHE_TIMEOUT_S', '1')

    def run(pkg):
        T = pkg.telemetry
        before = 'peer_cache' in T.pipeline_report()
        cache_a = _cache(pkg, tmp_path / pkg.name / 'a')
        entry_a, _ = _fill_entry(pkg, cache_a, 'k', 1)
        cache_b = _cache(pkg, tmp_path / pkg.name / 'b')
        with _server(pkg, cache_a.path) as server:
            client = pkg.peer_cache.PeerCacheClient(
                'tcp://127.0.0.1:%d' % pkg.protocol.free_tcp_port())
            client.update_directory({pkg.peer_cache.entry_digest(entry_a): [
                [server.endpoint, os.path.getsize(entry_a)]]})
            try:
                hit = client.fetch('k', cache_b._entry_path('k'), cache_b) is not None
                miss = client.fetch('missing', cache_b._entry_path('missing'), cache_b)
            finally:
                client.close()
        report = T.pipeline_report()
        line = [ln for ln in T.format_pipeline_report(report).splitlines()
                if ln.startswith('peer cache:')]
        return before, hit, miss, report['peer_cache'], line, os.path.getsize(entry_a)

    out = both(run)
    assert out['torch'] == out['jax']
    before, hit, miss, section, line, size = out['torch']
    assert not before and hit and miss is None
    assert section == {'hits': 1, 'misses': 1, 'hit_share': 0.5, 'bytes_fetched': size,
                       'degraded': {'no_holder': 1}, 'evict_hints': 0}
    assert len(line) == 1 and line[0].startswith('peer cache: 1 hit / 1 miss')


# -- the fleet drills ---------------------------------------------------------------------


def _fleet_worker(pkg):
    if pkg.name == 'jax':
        from tests.test_peer_cache import FleetDecodeWorker
        return FleetDecodeWorker
    return pkg.stubs.FleetDecodeWorker


@contextlib.contextmanager
def _fleet(pkg, endpoint, root, count=2, env_extra=None):
    """CLI worker servers of ``pkg`` with disjoint ``--cache-dir``
    directories, one a simulated host."""
    procs = [spawn_cli_worker(pkg, endpoint, i, heartbeat_interval_s=0.2,
                              extra_args=['--cache-dir', str(root / ('host%d' % i))],
                              env_extra=env_extra)
             for i in range(count)]
    try:
        yield procs
    finally:
        reap(procs)


def _run_epoch(pkg, endpoint, cache, n, sleep_s=0.0, kill_after_first=None):
    pool = pkg.ServicePool(endpoint=endpoint, expected_workers=2, **FAST)
    pool.start(_fleet_worker(pkg), worker_args={'cache': cache})
    try:
        for i in range(n):
            pool.ventilate(i, sleep_s=sleep_s)
        rows = [pool.get_results(timeout=60)]
        if kill_after_first is not None:
            os.kill(kill_after_first.pid, signal.SIGKILL)
        rows += [pool.get_results(timeout=60) for _ in range(n - 1)]
        return rows, dict(pool.diagnostics)
    finally:
        pool.stop()
        pool.join()


def _values(rows):
    return sorted(value for _item, _dec, value, _pid in rows)


def test_fleet_decodes_each_rowgroup_exactly_once(tmp_path):
    """Epoch 1 decodes each item once fleet-wide; epoch 2, a new job on the
    same fleet, serves every item without a decode (local hits on the
    decoding host, peer fetches across hosts)."""
    n = 24

    def run(pkg):
        root = tmp_path / pkg.name
        endpoint = 'tcp://127.0.0.1:%d' % pkg.protocol.free_tcp_port()
        cache = _cache(pkg, root / 'client')
        with _fleet(pkg, endpoint, root):
            cold, _ = _run_epoch(pkg, endpoint, cache, n)
            warm, diag = _run_epoch(pkg, endpoint, cache, n)
        return (_values(cold), sum(dec for _i, dec, _v, _p in cold),
                len({pid for _i, _d, _v, pid in cold}), _values(warm),
                [i for i, dec, _v, _p in warm if dec], diag['items_poisoned'])

    assert both(run) == {name: (list(range(n)), n, 2, list(range(n)), [], 0)
                         for name in PACKAGES}


def test_exact_parity_with_peer_cache_disabled_oracle(tmp_path, monkeypatch):
    """With ``PETASTORM_TPU_PEER_CACHE=0`` (the dispatcher and the fleet)
    the rows are the same and no fetch happens."""
    n = 16
    monkeypatch.setenv('PETASTORM_TPU_PEER_CACHE', '0')

    def run(pkg):
        root = tmp_path / pkg.name
        endpoint = 'tcp://127.0.0.1:%d' % pkg.protocol.free_tcp_port()
        cache = _cache(pkg, root / 'client')
        with _fleet(pkg, endpoint, root, env_extra={'PETASTORM_TPU_PEER_CACHE': '0'}):
            cold, _ = _run_epoch(pkg, endpoint, cache, n)
            warm, diag = _run_epoch(pkg, endpoint, cache, n)
        return (_values(cold), _values(warm), diag['items_poisoned'],
                _counter(pkg, pkg.peer_cache.PEER_CACHE_HITS))

    assert both(run) == {name: (list(range(n)), list(range(n)), 0, 0) for name in PACKAGES}


def test_peer_loss_mid_epoch_degrades_to_local_decode(tmp_path):
    """SIGKILL the worker holding half the fleet's entries mid warm epoch:
    its items re-ventilate, fetches from it time out into local decodes,
    and the epoch is exact with nothing quarantined."""
    n = 24

    def run(pkg):
        root = tmp_path / pkg.name
        endpoint = 'tcp://127.0.0.1:%d' % pkg.protocol.free_tcp_port()
        cache = _cache(pkg, root / 'client')
        env_extra = {'PETASTORM_TPU_PEER_CACHE_TIMEOUT_S': '0.3'}
        with _fleet(pkg, endpoint, root, env_extra=env_extra) as procs:
            cold, _ = _run_epoch(pkg, endpoint, cache, n)
            warm, diag = _run_epoch(pkg, endpoint, cache, n, sleep_s=0.05,
                                    kill_after_first=procs[1])
        return (_values(cold), _values(warm), diag['items_poisoned'],
                diag['items_reventilated'] >= 1, diag['workers_alive'])

    assert both(run) == {name: (list(range(n)), list(range(n)), 0, True, 1)
                         for name in PACKAGES}


def test_injected_serve_drop_degrades_every_fetch(tmp_path):
    n = 12

    def run(pkg):
        root = tmp_path / pkg.name
        endpoint = 'tcp://127.0.0.1:%d' % pkg.protocol.free_tcp_port()
        cache = _cache(pkg, root / 'client')
        env_extra = {'PETASTORM_TPU_FAULTS': 'zmq.peer_serve:drop:1',
                     'PETASTORM_TPU_PEER_CACHE_TIMEOUT_S': '0.3'}
        with _fleet(pkg, endpoint, root, env_extra=env_extra):
            cold, _ = _run_epoch(pkg, endpoint, cache, n)
            warm, diag = _run_epoch(pkg, endpoint, cache, n)
        return _values(cold), _values(warm), diag['items_poisoned']

    assert both(run) == {name: (list(range(n)), list(range(n)), 0) for name in PACKAGES}
