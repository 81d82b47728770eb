"""The decode service's wire and directory on the port against the JAX
package's: every frame ``dump_*`` gives the same bytes in both packages and
each loads the other's; both dispatchers answer a raw DEALER client's job
frames (REGISTER_JOB, SUBMIT, CLIENT_HB, JOB_GONE) and a raw worker's
frames with the same frames; ``FleetCacheDirectory`` case for case with
``tests/test_peer_cache.py``; the placement functions; the worker server's
decoded-cache reroot (``tests/test_materialized_cache.py::TestServiceReroot``,
under ``PETASTORM_TPU_PEER_CACHE=0``); and where the fleet cache tier's
holder side starts: the worker server's serve socket and its REGISTER
advert."""

import json
import os
import threading

import pytest
import zmq

from petastorm_tpu import materialized_cache as jax_materialized_cache
from petastorm_tpu.service import peer_cache as jax_peer_cache
from petastorm_tpu.service import placement as jax_placement
from petastorm_tpu_torch import materialized_cache as torch_materialized_cache
from petastorm_tpu_torch.service import peer_cache as torch_peer_cache
from petastorm_tpu_torch.service import placement as torch_placement
from tests.torch_service_common import FAST, PACKAGES, both, read_id_multiset
from tests.torch_telemetry_common import telemetry_guard, write_small_dataset  # noqa: F401

JAX_PROTO = PACKAGES['jax'].protocol
TORCH_PROTO = PACKAGES['torch'].protocol


# -- frames --------------------------------------------------------------------


class Unpicklable(Exception):
    """An exception whose pickling fails: the frame degrades to a
    RuntimeError naming it."""

    def __reduce__(self):
        raise TypeError('not picklable')


FRAME_CASES = {
    'item-id': ('pack_item_id', (1234,)),
    'job-spec': ('dump_job_spec', (dict, {'fields': ['id'], 'n': 3}, None)),
    'work-item': ('dump_work_item', ((7, 'rg-7'), {'shuffle': False, 'sleep_s': 0.5})),
    'exception': ('dump_exception', (ValueError('value was 5'),)),
    'unpicklable-exception': ('dump_exception', (Unpicklable('nope'),)),
    'obs-summary': ('dump_obs_summary', ({'pid': 41, 'uptime_s': 2.5, 'items_done': 9,
                                          'rates': {'petastorm_tpu_stage_calls_total': 1.5},
                                          'cache_fp': ['abc']},)),
    'poisoned-info': ('dump_poisoned_info', ({'item_id': 3, 'attempts': 2,
                                              'reason': 'worker error: ValueError: x',
                                              'error': None, 'max_retries': 2},)),
    'json-params': ('dump_json_params', ({'key': 'k' * 32, 'lease_s': 5.0, 'credit': 4},)),
    'empty-json-params': ('dump_json_params', (None,)),
    'standby-state': ('dump_standby_state', ({'next_item_id': 40, 'job_seq': 2, 'jobs': [],
                                              'fleet_cache_fps': ['f'],
                                              'peer_directory': []},)),
}

LOADERS = {'pack_item_id': 'unpack_item_id', 'dump_job_spec': 'load_job_spec',
           'dump_work_item': 'load_work_item', 'dump_exception': 'load_exception',
           'dump_obs_summary': 'load_obs_summary', 'dump_poisoned_info': 'load_poisoned_info',
           'dump_json_params': 'load_json_params', 'dump_standby_state': 'load_standby_state'}


def _comparable(value):
    if isinstance(value, BaseException):
        return type(value), value.args
    return value


@pytest.mark.parametrize('case', sorted(FRAME_CASES))
def test_frames_are_byte_equal_and_load_across_packages(case):
    dump, args = FRAME_CASES[case]
    frames = {name: getattr(pkg.protocol, dump)(*args) for name, pkg in PACKAGES.items()}
    assert frames['torch'] == frames['jax']
    load = LOADERS[dump]
    loaded = {(writer, reader): _comparable(getattr(PACKAGES[reader].protocol, load)(frame))
              for writer, frame in frames.items() for reader in PACKAGES}
    assert len(set(map(repr, loaded.values()))) == 1, loaded


def test_message_types_are_the_references():
    names = {n for n in dir(JAX_PROTO) if n.startswith('MSG_')}
    assert names == {n for n in dir(TORCH_PROTO) if n.startswith('MSG_')}
    for name in names:
        assert getattr(TORCH_PROTO, name) == getattr(JAX_PROTO, name), name


def test_metrics_delta_frames_are_byte_equal_and_cross_load():
    frames = {}
    for name, pkg in PACKAGES.items():
        pkg.telemetry.reset_for_tests()
        registry = pkg.telemetry.get_registry()
        registry.counter('petastorm_tpu_service_retries_total').inc(3)
        registry.gauge('petastorm_tpu_service_workers_alive').set(2)
        frames[name] = pkg.protocol.dump_metrics_delta()
        # nothing changed since: the empty frame
        assert pkg.protocol.dump_metrics_delta() == b''
    assert frames['torch'] == frames['jax']
    want = {'counters': {'petastorm_tpu_service_retries_total': 3.0},
            'gauges': {'petastorm_tpu_service_workers_alive': 2.0}, 'histograms': {}}
    for reader in PACKAGES.values():
        for frame in frames.values():
            assert reader.protocol.load_metrics_delta(frame) == want
        # a result frame is never taken for a delta
        assert reader.protocol.load_metrics_delta(reader.protocol.dump_json_params({})) is None


@pytest.mark.parametrize('frame', [b'', b'not json', b'[1, 2]'], ids=['empty', 'garbage', 'list'])
def test_advisory_frames_degrade_alike(frame):
    out = both(lambda pkg: (pkg.protocol.load_obs_summary(frame),
                            pkg.protocol.load_json_params(frame),
                            pkg.protocol.load_standby_state(frame)))
    assert out['torch'] == out['jax'] == (None, {}, None)


# -- dispatcher frames to raw peers ----------------------------------------------


def _recv(sock, timeout_s=10.0):
    assert sock.poll(int(timeout_s * 1000)), 'no reply within %.0fs' % timeout_s
    return sock.recv_multipart()


def _wire_session(pkg):
    """A standing dispatcher (``max_jobs=1``, one attempt an item) driven
    by two raw DEALER clients and a raw DEALER worker; returns every frame
    they received, tokens replaced by ``TOKEN`` and payloads decoded."""
    proto = pkg.protocol
    stop = threading.Event()
    dispatcher = pkg.dispatcher.Dispatcher('tcp://127.0.0.1:0', None, None, stop,
                                           heartbeat_interval_s=0.1, liveness_timeout_s=10.0,
                                           standing=True, max_jobs=1, max_retries=1)
    thread = threading.Thread(target=dispatcher.run, daemon=True)
    thread.start()
    context = zmq.Context()
    socks = []
    try:
        dispatcher.wait_bound(10)
        token = dispatcher.token

        def dealer(identity=None):
            sock = context.socket(zmq.DEALER)
            sock.setsockopt(zmq.LINGER, 0)
            if identity is not None:
                sock.setsockopt(zmq.IDENTITY, identity)
            sock.connect(dispatcher.endpoint)
            socks.append(sock)
            return sock

        def norm(frames):
            return [b'TOKEN' if f == token else bytes(f) for f in frames]

        client, rival, worker = dealer(), dealer(), dealer(b'worker-1')
        spec = proto.dump_job_spec(dict, {'job': 'a'}, None)
        log = []
        params = proto.dump_json_params({'key': 'a' * 32, 'credit': 4, 'name': 'job-a'})
        client.send_multipart([proto.MSG_REGISTER_JOB, spec, params])
        log.append(norm(_recv(client)))
        busy = proto.dump_json_params({'key': 'b' * 32})
        rival.send_multipart([proto.MSG_REGISTER_JOB, spec, busy])
        reply = _recv(rival)
        log.append([reply[0], proto.load_json_params(reply[1])])
        # the same key again (a lost JOB_OK): the same job, not a second
        client.send_multipart([proto.MSG_REGISTER_JOB, spec, params])
        log.append(norm(_recv(client)))
        job = log[0][1]
        for cid, value in ((7, 'seven'), (8, 'eight')):
            client.send_multipart([proto.MSG_SUBMIT, job, b'%d' % cid,
                                   proto.dump_work_item((value,), {})])
        worker.send_multipart([proto.MSG_REGISTER, b'4242'])
        reply = norm(_recv(worker))
        log.append(reply)
        assert reply[1] == spec
        worker.send_multipart([proto.MSG_READY])
        work = [_recv(worker) for _ in range(2)]
        log.append([[w[0], w[1], proto.load_work_item(w[2])] for w in work])
        (_, first, _), (_, second, _) = work
        worker.send_multipart([proto.MSG_DONE, first, b'', b'result-bytes-1', b'result-2'])
        worker.send_multipart([proto.MSG_ERROR, second, proto.dump_exception(ValueError('bad')),
                               b''])
        results = [_recv(client) for _ in range(5)]
        for frames in results:
            if frames[1] == b'poisoned':
                info = proto.load_poisoned_info(frames[3])
                frames = frames[:3] + [dict(info, error=repr(info['error']))]
            log.append(frames)
        client.send_multipart([proto.MSG_CLIENT_HB, job, b'2'])
        reply = norm(_recv(client))
        log.append([reply[0], reply[1], proto.load_json_params(reply[2])])
        worker.send_multipart([proto.MSG_HEARTBEAT, b'', token])
        log.append(norm(_recv(worker)))
        client.send_multipart([proto.MSG_JOB_GONE, job])
        # the job's worker goes back to registration
        log.append(norm(_recv(worker)))
        client.send_multipart([proto.MSG_CLIENT_HB, job, b'2'])
        log.append(_recv(client))
        client.send_multipart([proto.MSG_SUBMIT, b'99', b'1', b'payload'])
        log.append(_recv(client))
        health = dispatcher.health()
        log.append({k: health[k] for k in ('jobs_seen', 'jobs_active', 'items_completed',
                                           'items_poisoned', 'draining')})
        return log
    finally:
        stop.set()
        thread.join(10)
        for sock in socks:
            sock.close(linger=0)
        context.term()


def test_dispatchers_answer_client_and_worker_frames_alike():
    out = both(_wire_session)
    assert out['torch'] == out['jax']
    log = out['torch']
    assert log[0] == [b'JOBOK', b'1', b'TOKEN']
    assert log[1] == [b'BUSY', {'reason': 'saturated', 'jobs': 1, 'max_jobs': 1}]
    assert log[2] == log[0]
    assert log[3][0] == b'SPEC' and log[3][2] == b'TOKEN'
    assert [w[2] for w in log[4]] == [(('seven',), {}), (('eight',), {})]
    assert log[5:10] == [
        [b'RES', b'result', b'7', b'result-bytes-1'], [b'RES', b'result', b'7', b'result-2'],
        [b'RES', b'marker', b'7'],
        [b'RES', b'poisoned', b'8', {'item_id': 1, 'attempts': 1,
                                     'reason': 'worker error: ValueError: bad',
                                     'error': "ValueError('bad')", 'max_retries': 1}],
        [b'RES', b'marker', b'8']]
    assert log[10][:2] == [b'CHBACK', b'TOKEN']
    assert log[10][2]['pending'] == 0 and log[10][2]['unacked'] == 0
    assert log[11] == [b'HBACK', b'TOKEN']
    assert log[12] == [b'STOP']
    assert log[13] == [b'JOBEXP', b'1']
    assert log[14] == [b'JOBEXP', b'99']
    assert log[15] == {'jobs_seen': 1, 'jobs_active': 0, 'items_completed': 1,
                       'items_poisoned': 1, 'draining': False}


def test_dispatcher_snapshot_replicates_directory_to_standby():
    """A primary's standby snapshot seeds a promoted dispatcher whose
    directory answers stay warm (``tests/test_peer_cache.py``)."""
    def run(pkg):
        primary = pkg.dispatcher.Dispatcher('tcp://127.0.0.1:0', None, None, threading.Event())
        primary._peer_dir.note_advert(b'w1', {'ep': 'tcp://h1:1', 'full': [[_D1, 100, 50]]})
        state = primary.standby_snapshot()
        promoted = pkg.dispatcher.Dispatcher('tcp://127.0.0.1:0', None, None,
                                             threading.Event(), seed_state=state)
        return state, promoted._peer_dir.lookup([_D1])[_D1]

    out = both(run)
    assert out['torch'] == out['jax']
    state, lookup = out['torch']
    assert state['peer_directory'] == [[_D1, [['tcp://h1:1', 100, 50.0]]]]
    assert lookup == [['tcp://h1:1', 100]]


# -- the fleet directory, case for case with tests/test_peer_cache.py ------------


_D1 = 'a' * 40
_D2 = 'b' * 40
_D3 = 'c' * 40


def _fold_lookup_drop(directory_class):
    directory = directory_class()
    directory.note_advert(b'w1', {'ep': 'tcp://h1:1', 'full': [[_D1, 100, 50]]})
    directory.note_advert(b'w2', {'ep': 'tcp://h2:2', 'add': [[_D1, 100, 90], [_D2, 200, 10]]})
    out = [directory.lookup([_D1, _D2, _D3]), directory.held_count(b'w2')]
    directory.drop(b'w2')
    out += [directory.lookup([_D2]), directory.lookup([_D1]), directory.stats()]
    assert out[0] == {_D1: [['tcp://h2:2', 100], ['tcp://h1:1', 100]],
                      _D2: [['tcp://h2:2', 200]], _D3: []}
    assert out[1] == 2 and out[2] == {_D2: []} and out[3] == {_D1: [['tcp://h1:1', 100]]}
    assert out[4]['digests'] == 1
    return out


def _exclude_and_touch(directory_class):
    directory = directory_class()
    directory.note_advert(b'w1', {'ep': 'tcp://h1:1', 'full': [[_D1, 100, 50]]})
    directory.note_advert(b'w2', {'ep': 'tcp://h2:2', 'add': [[_D1, 100, 10]]})
    out = [directory.lookup([_D1], exclude_identity=b'w1')]
    directory.note_advert(b'w2', {'ep': 'tcp://h2:2', 't': [[_D1, 99]]})
    out.append(directory.lookup([_D1]))
    assert out[0] == {_D1: [['tcp://h2:2', 100]]}
    assert out[1][_D1][0] == ['tcp://h2:2', 100]
    return out


def _delta_since(directory_class):
    directory = directory_class()
    out = [directory.delta_since(0)]
    directory.note_advert(b'w1', {'ep': 'tcp://h1:1', 'full': [[_D1, 100, 50]]})
    version, delta = directory.delta_since(0)
    out += [(version, delta), directory.delta_since(version)]
    directory.note_advert(b'w2', {'ep': 'tcp://h2:2', 'add': [[_D2, 200, 60]]})
    out.append(directory.delta_since(version, exclude_identity=b'w2'))
    assert out[0] == (0, None)
    assert delta == {_D1: [['tcp://h1:1', 100]]}
    assert out[2] == (version, None)
    assert out[3][1] is None or _D2 not in out[3][1]
    return out


def _malformed(directory_class):
    directory = directory_class()
    directory.note_advert(b'w1', None)
    directory.note_advert(b'w1', {'full': [[_D1, 1, 1]]})  # no endpoint
    directory.note_advert(b'w1', {'ep': 'tcp://h:1', 'full': [['nope', 1, 1], [_D1, 'x', 'y']]})
    out = [directory.lookup([_D1]), directory.stats()]
    assert out[0] == {_D1: []} and out[1]['digests'] == 0
    return out


def _evict_hints(directory_class):
    directory = directory_class()
    now = 10_000.0
    # replicated and fleet-cold: hint every holder but the freshest
    directory.note_advert(b'w1', {'ep': 'tcp://h1:1', 'full': [[_D1, 100, now - 500]]})
    directory.note_advert(b'w2', {'ep': 'tcp://h2:2', 'add': [[_D1, 100, now - 900]]})
    # a single copy is never hinted, however cold
    directory.note_advert(b'w2', {'ep': 'tcp://h2:2', 'add': [[_D2, 100, now - 900]]})
    # replicated but fleet-hot: untouched
    directory.note_advert(b'w1', {'ep': 'tcp://h1:1', 'add': [[_D3, 100, now - 10]]})
    directory.note_advert(b'w2', {'ep': 'tcp://h2:2', 'add': [[_D3, 100, now - 900]]})
    directory.compute_evict_hints(now)
    out = [directory.take_hints(b'w1'), directory.take_hints(b'w2'), directory.take_hints(b'w2'),
           directory.stats()['hints_queued']]
    assert out == [None, [_D1], None, 1]
    return out


def _seed_and_expire(directory_class):
    primary = directory_class()
    primary.note_advert(b'w1', {'ep': 'tcp://h1:1', 'full': [[_D1, 100, 50]]})
    snapshot = primary.snapshot()
    promoted = directory_class()
    promoted.seed(snapshot, now_mono=1000.0)
    out = [snapshot, promoted.lookup([_D1]), promoted.stats()['seeded']]
    # the endpoint's first real advert supersedes its seed rows
    promoted.note_advert(b'w9', {'ep': 'tcp://h1:1', 'full': [[_D2, 200, 60]]})
    out += [promoted.lookup([_D1]), promoted.lookup([_D2]), promoted.stats()['seeded']]
    expiring = directory_class()
    expiring.seed(snapshot, now_mono=1000.0)
    expiring.expire_seeds(1030.0)  # before the TTL: kept
    out.append(expiring.lookup([_D1]))
    expiring.expire_seeds(1061.0)
    out.append(expiring.lookup([_D1]))
    assert out[1:] == [{_D1: [['tcp://h1:1', 100]]}, True, {_D1: []},
                       {_D2: [['tcp://h1:1', 200]]}, False, {_D1: [['tcp://h1:1', 100]]},
                       {_D1: []}]
    return out


DIRECTORY_CASES = {'fold-lookup-drop': _fold_lookup_drop,
                   'exclude-and-touch': _exclude_and_touch, 'delta-since': _delta_since,
                   'malformed': _malformed, 'evict-hints': _evict_hints,
                   'seed-and-expire': _seed_and_expire}


@pytest.mark.parametrize('case', sorted(DIRECTORY_CASES))
def test_fleet_cache_directory_is_the_references(case, monkeypatch):
    monkeypatch.setenv('PETASTORM_TPU_PEER_CACHE_COLD_S', '100')
    out = {pkg: DIRECTORY_CASES[case](module.FleetCacheDirectory)
           for pkg, module in (('jax', jax_peer_cache), ('torch', torch_peer_cache))}
    assert out['torch'] == out['jax']


def test_entry_digests_are_the_references(tmp_path):
    digest = 'd' * 40
    for module in (jax_peer_cache, torch_peer_cache):
        path = module.digest_entry_path(str(tmp_path), digest)
        assert path == os.path.join(str(tmp_path), 'dd', digest + '.arrow')
        assert module.entry_digest(path) == digest
        assert module.entry_digest(path + '.tmp') is None
        assert module.entry_digest(os.path.join(str(tmp_path), 'x' * 40 + '.arrow')) is None
    for name in ('PEER_CACHE_HITS', 'PEER_CACHE_MISSES', 'PEER_CACHE_BYTES',
                 'PEER_CACHE_EVICT_HINTS'):
        assert getattr(torch_peer_cache, name) == getattr(jax_peer_cache, name)


# -- placement ----------------------------------------------------------------------


def test_placement_functions_are_the_references(tmp_path):
    out = {}
    for pkg, module in (('jax', jax_placement), ('torch', torch_placement)):
        root = tmp_path / pkg
        cache_dir = str(root / 'cache')
        got = [module.placement_fingerprint({'placement_group': 'group-a'}),
               module.placement_fingerprint({'placement_group': 7, 'loaded_schema': object()}),
               module.placement_fingerprint(None), module.placement_fingerprint({}),
               module.advertised_fingerprints(cache_dir, extra=('x', None))]
        module.note_fingerprint(cache_dir, 'fp-b')
        module.note_fingerprint(cache_dir, 'fp-a')
        module.note_fingerprint(None, 'ignored')
        got.append(module.advertised_fingerprints(cache_dir, extra=('x',)))
        got.append(module.advertised_fingerprints(
            cache_dir, extra=['e%02d' % i for i in range(20)])[-1])
        # markers with no entry behind them are purged; one real entry keeps them
        got.append(module.purge_stale_markers(cache_dir))
        got.append(module.advertised_fingerprints(cache_dir))
        module.note_fingerprint(cache_dir, 'fp-c')
        os.makedirs(os.path.join(cache_dir, 'ab'))
        with open(os.path.join(cache_dir, 'ab', 'a' * 40 + '.arrow'), 'wb') as f:
            f.write(b'entry')
        got += [module.purge_stale_markers(cache_dir), module.advertised_fingerprints(cache_dir)]
        out[pkg] = got
    assert out['torch'] == out['jax'] == [
        'group-a', '7', None, None, ['x'], ['fp-a', 'fp-b', 'x'], 'e07', 2, [], 0, ['fp-c']]
    assert torch_placement.MAX_ADVERTISED == jax_placement.MAX_ADVERTISED


def test_schema_placement_fingerprint_is_the_decode_fingerprint(tmp_path):
    from petastorm_tpu_torch.etl.dataset_metadata import get_schema_from_dataset_url
    url = write_small_dataset('file://' + str(tmp_path / 'ds'), rows=20)
    schema = get_schema_from_dataset_url(url)
    assert torch_placement.placement_fingerprint({'loaded_schema': schema}) == \
        torch_materialized_cache.decode_fingerprint(schema, None, ngram=None)


# -- the worker server's reroot, and the refused peer tier ---------------------------


@pytest.mark.parametrize('knob', ['set', 'unset'])
def test_worker_server_reroots_the_decoded_cache_like_the_reference(tmp_path, monkeypatch, knob):
    monkeypatch.setenv('PETASTORM_TPU_PEER_CACHE', '0')
    host_dir = str(tmp_path / 'host')
    if knob == 'set':
        monkeypatch.setenv('PETASTORM_TPU_DECODED_CACHE_DIR', host_dir)
    else:
        monkeypatch.delenv('PETASTORM_TPU_DECODED_CACHE_DIR', raising=False)
    out = {}
    for pkg, cache_module in (('jax', jax_materialized_cache),
                              ('torch', torch_materialized_cache)):
        client_dir = str(tmp_path / pkg / 'client')
        cache = cache_module.MaterializedRowGroupCache(client_dir, 10 ** 8)
        PACKAGES[pkg].worker_server._reroot_decoded_cache({'cache': cache})
        PACKAGES[pkg].worker_server._reroot_decoded_cache('not a dict')
        out[pkg] = (cache.path == (host_dir if knob == 'set' else client_dir),
                    os.path.isdir(host_dir))
    assert out['torch'] == out['jax'] == (True, knob == 'set')


def _first_register(pkg, endpoint):
    """The first REGISTER frames a worker server of ``pkg`` sends to a ROUTER
    bound at ``endpoint`` (never answered, so the server's registration
    window closes and it exits), with whether its peer serve socket was up
    while it registered and whether it was down after the server exited."""
    context = zmq.Context()
    sock = context.socket(zmq.ROUTER)
    sock.setsockopt(zmq.LINGER, 0)
    sock.bind(endpoint)
    thread = threading.Thread(target=pkg.worker_server.serve, args=(endpoint,),
                              kwargs=dict(register_timeout_s=1.5), daemon=True)
    thread.start()
    try:
        assert sock.poll(30000), 'no REGISTER'
        frames = sock.recv_multipart()
        serving = pkg.peer_cache.server_snapshot()
    finally:
        thread.join(30)
        sock.close(0)
        context.term()
    assert not thread.is_alive()
    return frames[1:], serving, pkg.peer_cache.server_snapshot() is None


def test_the_fleet_cache_tier_starts_where_the_reference_starts_it(tmp_path, monkeypatch):
    """With a host-local decoded-cache directory and the tier on, each
    package's worker server starts its peer serve socket before it
    registers: the REGISTER carries the full advert of the entries the
    directory already holds (a positional fifth frame after an empty
    placement frame), and the socket closes when the server exits. With
    ``PETASTORM_TPU_PEER_CACHE=0`` nothing starts and no advert rides. A
    ``ServicePool`` builds and starts a job on a decoded cache in both
    packages."""
    import numpy as np
    monkeypatch.delenv('PETASTORM_TPU_PEER_CACHE', raising=False)
    out = {}
    for name, pkg in PACKAGES.items():
        host = str(tmp_path / name / 'host')
        monkeypatch.setenv('PETASTORM_TPU_DECODED_CACHE_DIR', host)
        cache = pkg.materialized_cache.MaterializedRowGroupCache(host, 10 ** 8)
        cache.get('k', lambda: pkg.ColumnBatch({'v': np.arange(8)}, 8))
        digest = pkg.peer_cache.entry_digest(cache._entry_path('k'))
        endpoint = 'tcp://127.0.0.1:%d' % pkg.protocol.free_tcp_port()
        frames, serving, closed = _first_register(pkg, endpoint)
        advert = pkg.protocol.load_json_params(frames[3])
        out[name] = (frames[0], len(frames), frames[2], [row[0] for row in advert['full']],
                     advert['ep'] == (serving or {}).get('endpoint'), closed, digest)
        monkeypatch.setenv('PETASTORM_TPU_PEER_CACHE', '0')
        frames, serving, closed = _first_register(pkg, endpoint)
        out[name] += (len(frames), serving)
        monkeypatch.delenv('PETASTORM_TPU_PEER_CACHE')
        monkeypatch.delenv('PETASTORM_TPU_DECODED_CACHE_DIR')
        pool = pkg.ServicePool(spawn_local_workers=1, **FAST)
        pool.start(pkg.stubs.IdentityWorker,
                   {'cache': pkg.materialized_cache.MaterializedRowGroupCache(
                       str(tmp_path / name / 'c'), 10 ** 8)})
        try:
            pool.ventilate(7)
            assert pool.get_results(timeout=60) == 7
        finally:
            pool.stop()
            pool.join()
    assert out['torch'][:6] == out['jax'][:6]
    assert out['torch'][7:] == out['jax'][7:]
    register, nframes, placement, digests, same_ep, closed, digest, oracle_frames, \
        oracle_serving = out['torch']
    assert register == JAX_PROTO.MSG_REGISTER and nframes == 4 and placement == b''
    assert digests == [digest] and same_ep and closed
    assert oracle_frames == 2 and oracle_serving is None


def test_decoded_cache_on_the_service_is_the_host_local_oracle(tmp_path, monkeypatch):
    """Under ``PETASTORM_TPU_PEER_CACHE=0`` a service read through the
    decoded cache gives the JAX service read's rows, cold and warm."""
    monkeypatch.setenv('PETASTORM_TPU_PEER_CACHE', '0')
    url = write_small_dataset('file://' + str(tmp_path / 'ds'), rows=60, rowgroup_size_rows=10)

    def run(pkg):
        kw = dict(cache_type='decoded', cache_location=str(tmp_path / ('cache-' + pkg.name)),
                  cache_size_limit=10 ** 8)
        return [read_id_multiset(pkg, url, pkg.ServicePool(spawn_local_workers=2, **FAST),
                                 **kw) for _ in range(2)]

    out = both(run)
    assert out['torch'] == out['jax']
    assert out['torch'][0] == out['torch'][1] and sorted(out['torch'][0]) == list(range(60))
    assert json.dumps(sorted(os.listdir(str(tmp_path / 'cache-torch'))))
