"""petastorm_tpu_torch.telemetry.tracing and its recorder against the JAX
package's, on the CPU.

The same traced reads (dummy pool, so the order is fixed) go through both
packages: the multisets of ``(event name, track kind, item, epoch)`` are
equal (run ids differ and are left out), and so are the ``queue_wait``
and ``mixture_pull`` events, the sampling decisions, the contexts, the
Chrome export of one event list and the slowest-items ranking. The
port's own cases: the loader's ``stager`` track, the thread pool's
tracks, the dump hooks and the producer-bound auto-dump, fed with times
through a fake clock rather than sleeps.
"""

import collections
import json
import os
import re
import signal
import threading
import types

import pytest

import petastorm_tpu.mixture as jax_mixture
import petastorm_tpu_torch.mixture as torch_mixture
from petastorm_tpu import reader as jax_reader
from petastorm_tpu import telemetry as jax_telemetry
from petastorm_tpu.telemetry import recorder as jax_recorder
from petastorm_tpu.telemetry import stall as jax_stall
from petastorm_tpu.telemetry import tracing as jax_tracing
from petastorm_tpu_torch import reader as torch_reader
from petastorm_tpu_torch import telemetry as torch_telemetry
from petastorm_tpu_torch.device.loader import make_torch_loader
from petastorm_tpu_torch.telemetry import recorder as torch_recorder
from petastorm_tpu_torch.telemetry import spans as torch_spans
from petastorm_tpu_torch.telemetry import stall as torch_stall
from petastorm_tpu_torch.telemetry import tracing as torch_tracing
from tests.torch_telemetry_common import (  # noqa: F401 - fixtures
    PORT_THREAD_PREFIX, armed_dump, telemetry_guard, traced, write_small_dataset,
)

PACKAGES = {
    'jax': (jax_telemetry, jax_tracing, jax_reader),
    'torch': (torch_telemetry, torch_tracing, torch_reader),
}


@pytest.fixture(scope='module')
def small_url(tmp_path_factory):
    return write_small_dataset('file://' + str(tmp_path_factory.mktemp('trace') / 'ds'))


def _track_kind(tid):
    return re.sub(r'-\d+$', '', str(tid))


def _event_key(e):
    return (e['name'], _track_kind(e['tid']), e['args']['item'], e['args'].get('epoch'))


def _traced_read(package, url, **kwargs):
    telemetry, _, reader = PACKAGES[package]
    with reader.make_batch_reader(url, reader_pool_type='dummy', **kwargs) as r:
        ids = [int(i) for batch in r for i in batch.id]
    return ids, telemetry.get_recorder().snapshot()


# -- contexts and sampling -----------------------------------------------------


def test_tracing_is_off_by_default_in_both():
    for telemetry, tracing, _ in PACKAGES.values():
        assert not tracing.trace_enabled()
        assert tracing.mint(0) is None and tracing.ctx_for(0) is None
        assert tracing.activate(None) is tracing._NOOP_ACTIVATION
        assert tracing.attempt(None, 'w') is tracing._NOOP_ACTIVATION
        with telemetry.span('decode'):
            pass
        assert len(telemetry.get_recorder()) == 0
    assert torch_spans._trace_hook is None


@pytest.mark.parametrize('item, epoch, shard', [(0, None, None), (5, 2, 1), (17, 0, 3)])
def test_contexts_are_the_references(traced, item, epoch, shard):
    want = jax_tracing.mint(item, epoch, shard)
    got = torch_tracing.mint(item, epoch, shard)
    assert got[1:] == want[1:]
    # the trace id is '<run id>-e<epoch>-i<item>'; only the run id differs
    assert got.trace_id.split('-', 1)[1] == want.trace_id.split('-', 1)[1]
    assert torch_tracing.ctx_for(item, epoch, shard) == got
    assert torch_tracing.ctx_for(None) is None


@pytest.mark.parametrize('spelling', ['1/3', '4', '1', '0', '-2', 'every-other', ''])
def test_sampling_is_the_references(traced, monkeypatch, spelling):
    monkeypatch.setenv('PETASTORM_TPU_TRACE_SAMPLE', spelling)
    jax_telemetry.refresh()
    torch_telemetry.refresh()
    assert torch_tracing.sample_stride() == jax_tracing.sample_stride()
    sampled = [i for i in range(13) if torch_tracing.mint(i) is not None]
    assert sampled == [i for i in range(13) if jax_tracing.mint(i) is not None]


def test_refresh_flips_trace_and_metrics_knobs_together(monkeypatch):
    assert not torch_tracing.trace_enabled() and not torch_telemetry.metrics_disabled()
    monkeypatch.setenv('PETASTORM_TPU_TRACE', 'on')
    monkeypatch.setenv('PETASTORM_TPU_TRACE_SAMPLE', '1/2')
    monkeypatch.setenv('PETASTORM_TPU_METRICS', 'off')
    # cached until refresh()
    assert not torch_tracing.trace_enabled() and not torch_telemetry.metrics_disabled()
    torch_telemetry.refresh()
    assert torch_tracing.trace_enabled() and torch_telemetry.metrics_disabled()
    assert torch_tracing.sample_stride() == 2
    monkeypatch.delenv('PETASTORM_TPU_TRACE')
    monkeypatch.delenv('PETASTORM_TPU_TRACE_SAMPLE')
    monkeypatch.delenv('PETASTORM_TPU_METRICS')
    torch_telemetry.refresh()
    assert not torch_tracing.trace_enabled() and not torch_telemetry.metrics_disabled()
    assert torch_tracing.sample_stride() == 1


# -- activation and events -----------------------------------------------------


def _attempt_events(package):
    telemetry, tracing, _ = PACKAGES[package]
    ctx = tracing.mint(1, epoch=0)
    assert tracing.current_context() is None
    with tracing.attempt(ctx, 'worker-9'):
        assert tracing.current_context() == ctx
        with telemetry.span('decode'):
            pass
        with tracing.activate(ctx, track='stager'):
            with telemetry.span('collate'):
                pass
    assert tracing.current_context() is None
    return telemetry.get_recorder().snapshot()


def test_attempt_and_activation_record_as_the_reference(traced):
    want, got = _attempt_events('jax'), _attempt_events('torch')
    assert [(e['name'], e['tid'], e['ph'], sorted(e['args'])) for e in got] == \
        [(e['name'], e['tid'], e['ph'], sorted(e['args'])) for e in want]
    by_name = {e['name']: e for e in got}
    assert by_name['decode']['tid'] == 'worker-9'
    assert by_name['collate']['tid'] == 'stager'
    assert by_name['attempt']['args']['worker'] == 'worker-9'
    assert len({e['args']['trace_id'] for e in got}) == 1


def test_instants_are_the_references(traced):
    events = {}
    for package in ('jax', 'torch'):
        telemetry, tracing, _ = PACKAGES[package]
        ctx = tracing.mint(3, epoch=1, shard=2)
        tracing.record_instant('done', ctx, 'ventilator', worker='w', skipped=None)
        tracing.record_instant('done', None, 'ventilator')
        events[package] = telemetry.get_recorder().snapshot()
    assert len(events['torch']) == 1
    got, want = events['torch'][0], events['jax'][0]
    assert sorted(got) == sorted(want) and got['ph'] == want['ph'] == 'i'
    assert {k: v for k, v in got['args'].items() if k != 'trace_id'} == \
        {'item': 3, 'epoch': 1, 'shard': 2, 'worker': 'w'} == \
        {k: v for k, v in want['args'].items() if k != 'trace_id'}


def test_untraced_blocks_record_nothing(traced):
    with torch_tracing.activate(None):
        with torch_telemetry.span('decode'):
            pass
    with torch_telemetry.span('io'):
        pass
    assert len(torch_telemetry.get_recorder()) == 0


def test_recorder_ring_is_bounded():
    rec = torch_recorder.FlightRecorder(capacity=5)
    for i in range(12):
        rec.add({'name': 'e%d' % i, 'ph': 'X'})
    events = rec.snapshot()
    assert [e['name'] for e in events] == ['e%d' % i for i in range(7, 12)]
    assert len(rec) == 5


def _fixed_events():
    """Events with two pids, three tracks, an instant and a missing tid."""
    args = {'trace_id': 'r-e0-i0', 'item': 0, 'epoch': 0}
    return [
        {'name': 'ventilate', 'ph': 'X', 'ts': 10.0, 'dur': 1.0, 'pid': 7, 'tid': 'ventilator',
         'args': args},
        {'name': 'io', 'ph': 'X', 'ts': 12.0, 'dur': 5.0, 'pid': 7, 'tid': 'thread-0',
         'args': args},
        {'name': 'attempt', 'ph': 'X', 'ts': 11.0, 'dur': 9.0, 'pid': 7, 'tid': 'thread-0',
         'args': dict(args, worker='thread-0')},
        {'name': 'attempt', 'ph': 'X', 'ts': 30.0, 'dur': 4.0, 'pid': 7, 'tid': 'thread-1',
         'args': {'trace_id': 'r-e0-i1', 'item': 1, 'epoch': 0}},
        {'name': 'done', 'ph': 'i', 's': 'p', 'ts': 25.0, 'pid': 8, 'tid': 'ventilator',
         'args': args},
        {'name': 'queue_wait', 'ph': 'X', 'ts': 21.0, 'dur': 2.0, 'pid': 7, 'args': args},
    ]


def test_chrome_export_is_the_references(tmp_path):
    paths = {}
    for name, module in (('jax', jax_recorder), ('torch', torch_recorder)):
        paths[name] = str(tmp_path / ('%s.json' % name))
        assert module.export_chrome_trace(paths[name], _fixed_events()) == 6
    docs = {name: json.load(open(path)) for name, path in paths.items()}
    assert docs['torch'] == docs['jax']
    meta = [e for e in docs['torch']['traceEvents'] if e['ph'] == 'M']
    assert {(m['pid'], m['args']['name']) for m in meta} == {
        (7, 'ventilator'), (7, 'thread-0'), (7, 'thread-1'), (8, 'ventilator'), (7, 'main')}


@pytest.mark.parametrize('n', [1, 2, 5])
def test_slowest_items_are_the_references(n):
    assert torch_recorder.slowest_items(_fixed_events(), n) == \
        jax_recorder.slowest_items(_fixed_events(), n)
    no_attempts = [e for e in _fixed_events() if e['name'] != 'attempt']
    assert torch_recorder.slowest_items(no_attempts, n) == \
        jax_recorder.slowest_items(no_attempts, n)


# -- traced reads through both packages ---------------------------------------


@pytest.mark.parametrize('kwargs', [
    {},
    {'num_epochs': 2, 'seed': 3},
    {'shuffle_row_groups': False, 'shuffle_row_drop_partitions': 2},
    {'cur_shard': 1, 'shard_count': 3},
], ids=['one-epoch', 'two-epochs', 'drop-partitions', 'shard'])
@pytest.mark.parametrize('sample', ['1', '1/3'])
def test_traced_read_events_are_the_references(traced, monkeypatch, small_url, kwargs, sample):
    monkeypatch.setenv('PETASTORM_TPU_TRACE_SAMPLE', sample)
    jax_telemetry.refresh()
    torch_telemetry.refresh()
    want_ids, want = _traced_read('jax', small_url, **kwargs)
    got_ids, got = _traced_read('torch', small_url, **kwargs)
    assert got_ids == want_ids
    assert collections.Counter(map(_event_key, got)) == collections.Counter(map(_event_key, want))
    # every event of an item carries the trace id the ventilator minted
    for events in (got, want):
        minted = {(e['args']['item'], e['args'].get('epoch')): e['args']['trace_id']
                  for e in events if e['name'] == 'ventilate'}
        assert {e['args']['trace_id'] for e in events} == set(minted.values())
        assert all(e['args']['trace_id'] == minted[e['args']['item'], e['args'].get('epoch')]
                   for e in events)
    stride = int(sample.split('/')[-1])
    assert {e['args']['item'] % stride for e in got} == {0}


def test_queue_wait_events_are_the_references(traced, small_url):
    _, want = _traced_read('jax', small_url, num_epochs=2)
    _, got = _traced_read('torch', small_url, num_epochs=2)

    def waits(events):
        return sorted((e['tid'], e['args']['item'], e['args']['epoch'], e['args'].get('shard'))
                      for e in events if e['name'] == 'queue_wait')

    assert waits(got) == waits(want)
    # one per row-group pulled, on the consumer track
    assert len(waits(got)) == 24 and {w[0] for w in waits(got)} == {'consumer'}
    assert all(e['ph'] == 'X' and e['dur'] >= 0 for e in got if e['name'] == 'queue_wait')


@pytest.fixture(scope='module')
def corpora(tmp_path_factory):
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq
    root = tmp_path_factory.mktemp('trace_mixture')
    urls = {}
    for name, seed in (('a', 1), ('b', 2)):
        rng = np.random.RandomState(seed)
        (root / name).mkdir()
        tokens = [rng.randint(1, 1000, size=rng.randint(1, 50)).tolist() for _ in range(20)]
        pq.write_table(pa.table({'tokens': tokens}), str(root / name / 'part-0.parquet'),
                       row_group_size=5)
        urls[name] = 'file://' + str(root / name)
    return urls


def _mixture_pulls(package, urls):
    mixture = jax_mixture if package == 'jax' else torch_mixture
    telemetry = PACKAGES[package][0]
    spec = mixture.MixtureSpec([mixture.MixtureSource(n, w, url=urls[n])
                                for n, w in (('a', 3), ('b', 1))], seed=11, seq_len=64)
    stream = mixture.MixtureStream(spec, reader_pool_type='dummy')
    try:
        rows = list(stream)
    finally:
        stream.stop()
        stream.join()
    pulls = sorted((e['tid'], e['args']['item'], e['args']['epoch'], e['args']['shard'])
                   for e in telemetry.get_recorder().snapshot() if e['name'] == 'mixture_pull')
    return len(rows), pulls


def test_mixture_pull_events_are_the_references(traced, corpora):
    want_rows, want = _mixture_pulls('jax', corpora)
    got_rows, got = _mixture_pulls('torch', corpora)
    assert got_rows == want_rows
    assert got == want
    # each source's pulls on its own track, the source as the shard
    assert sorted({(tid, shard) for tid, _, _, shard in got}) == [
        ('mixture-src-0', 0), ('mixture-src-1', 1)]


def test_torch_loader_stages_on_the_stager_track(traced, small_url):
    with make_torch_loader(small_url, batch_size=16, reader_pool_type='dummy',
                           num_epochs=1, device='cpu') as loader:
        batches = list(loader)
    assert len(batches) == 7
    events = torch_telemetry.get_recorder().snapshot()
    stager = [e for e in events if e['tid'] == 'stager']
    assert {'collate', 'stage_fill'} <= {e['name'] for e in stager}
    ventilated = {e['args']['trace_id'] for e in events if e['name'] == 'ventilate'}
    assert {e['args']['trace_id'] for e in stager} <= ventilated
    assert {_track_kind(e['tid']) for e in events} == {
        'ventilator', 'dummy', 'consumer', 'stager'}


def test_thread_pool_tracks(traced, small_url):
    with torch_reader.make_batch_reader(small_url, reader_pool_type='thread',
                                        workers_count=3) as reader:
        names = {t.name for t in threading.enumerate() if t.name.startswith(PORT_THREAD_PREFIX)}
        ids = sorted(int(i) for batch in reader for i in batch.id)
    assert ids == list(range(120))
    assert {'petastorm-tpu-torch-worker-%d' % i for i in range(3)} <= names
    events = torch_telemetry.get_recorder().snapshot()
    by_item = collections.defaultdict(list)
    for e in events:
        by_item[e['args']['item']].append(e)
    assert sorted(by_item) == list(range(12))
    for item_events in by_item.values():
        tracks = {e['name']: e['tid'] for e in item_events}
        assert sorted(tracks) == ['attempt', 'decode', 'io', 'queue_wait', 'ventilate']
        assert tracks['ventilate'] == 'ventilator' and tracks['queue_wait'] == 'consumer'
        assert tracks['io'] == tracks['decode'] == tracks['attempt']
        assert re.fullmatch(r'thread-[0-2]', tracks['attempt'])


# -- dumps ---------------------------------------------------------------------


def test_dump_hooks_arm_with_a_dump_path(traced, monkeypatch, armed_dump, tmp_path, small_url):
    path = str(tmp_path / 'sig.json')
    assert signal.getsignal(signal.SIGUSR1) is not torch_tracing._dump_if_any
    monkeypatch.setenv('PETASTORM_TPU_TRACE_DUMP', path)
    torch_telemetry.refresh()
    assert torch_tracing._atexit_installed
    if threading.current_thread() is threading.main_thread():
        assert signal.getsignal(signal.SIGUSR1) is torch_tracing._dump_if_any
    _traced_read('torch', small_url)
    torch_tracing._dump_if_any(signal.SIGUSR1, None)
    with open(path) as f:
        doc = json.load(f)
    assert sum(1 for e in doc['traceEvents'] if e['ph'] != 'M') == \
        len(torch_telemetry.get_recorder())


def test_no_dump_hooks_without_a_dump_path(traced):
    assert not torch_tracing._atexit_installed and not torch_tracing._signal_installed
    assert torch_tracing.maybe_autodump() is False


class _FakeClock:
    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


def _autodump(package, monkeypatch):
    telemetry, tracing, _ = PACKAGES[package]
    stall = jax_stall if package == 'jax' else torch_stall
    clock = _FakeClock()
    fake_time = types.SimpleNamespace(monotonic=clock.monotonic, time=lambda: clock.now)
    monkeypatch.setattr(stall, 'time', fake_time)
    monkeypatch.setattr(tracing, 'time', fake_time)
    telemetry.refresh()
    telemetry.reset_attributor()      # the 0.05 s window
    with tracing.attempt(tracing.mint(0), 'w'):
        pass
    attributor = telemetry.get_attributor()

    def note_until(end):
        # consumer waits in every 0.05 s window: producer-bound windows
        # close one after another
        while clock.now < end:
            attributor.note_consumer_wait(0.01)
            clock.now += 0.01

    # one window closed: too few; past the one-second scan throttle, many:
    # the dump fires, and only once
    note_until(1000.06)
    fired = [tracing.maybe_autodump()]
    note_until(1001.2)
    fired += [tracing.maybe_autodump(), tracing.maybe_autodump()]
    return fired


@pytest.mark.parametrize('package', ['jax', 'torch'])
def test_autodump_after_consecutive_producer_bound_windows(traced, monkeypatch, armed_dump,
                                                           tmp_path, package):
    path = str(tmp_path / ('%s-auto.json' % package))
    monkeypatch.setenv('PETASTORM_TPU_TRACE_DUMP', path)
    monkeypatch.setenv('PETASTORM_TPU_TRACE_AUTODUMP_WINDOWS', '2')
    monkeypatch.setenv('PETASTORM_TPU_METRICS_WINDOW_S', '0.05')
    fired = _autodump(package, monkeypatch)
    assert fired == [False, True, False], fired
    with open(path) as f:
        assert any(e['name'] == 'attempt' for e in json.load(f)['traceEvents'])


def test_autodump_fires_at_the_references_step(traced, monkeypatch, armed_dump, tmp_path):
    monkeypatch.setenv('PETASTORM_TPU_TRACE_AUTODUMP_WINDOWS', '2')
    monkeypatch.setenv('PETASTORM_TPU_METRICS_WINDOW_S', '0.05')
    fired = {}
    for package in ('jax', 'torch'):
        monkeypatch.setenv('PETASTORM_TPU_TRACE_DUMP', str(tmp_path / package))
        fired[package] = _autodump(package, monkeypatch)
    assert fired['torch'] == fired['jax']
    assert os.path.exists(str(tmp_path / 'torch'))


def test_autodump_stays_off_for_balanced_windows(traced, monkeypatch, armed_dump, tmp_path):
    monkeypatch.setenv('PETASTORM_TPU_TRACE_DUMP', str(tmp_path / 'never.json'))
    monkeypatch.setenv('PETASTORM_TPU_TRACE_AUTODUMP_WINDOWS', '2')
    monkeypatch.setenv('PETASTORM_TPU_METRICS_WINDOW_S', '0.05')
    clock = _FakeClock()
    fake_time = types.SimpleNamespace(monotonic=clock.monotonic, time=lambda: clock.now)
    monkeypatch.setattr(torch_stall, 'time', fake_time)
    monkeypatch.setattr(torch_tracing, 'time', fake_time)
    torch_telemetry.refresh()
    torch_telemetry.reset_attributor()
    attributor = torch_telemetry.get_attributor()
    for _ in range(6):
        attributor.note_consumer_wait(0.01)
        attributor.note_producer_wait(0.01)
        clock.now += 1.2
        assert torch_tracing.maybe_autodump() is False
    assert not os.path.exists(str(tmp_path / 'never.json'))


def test_reader_dump_trace_writes_the_references_keys(traced, small_url, tmp_path):
    files = {}
    for package in ('jax', 'torch'):
        _, _, reader = PACKAGES[package]
        with reader.make_batch_reader(small_url, reader_pool_type='dummy') as r:
            list(r)
            files[package] = str(tmp_path / package)
            assert r.dump_trace(files[package]) == len(PACKAGES[package][0].get_recorder())
    docs = {p: json.load(open(f)) for p, f in files.items()}
    assert sorted(docs['torch']) == sorted(docs['jax']) == ['displayTimeUnit', 'traceEvents']
    for kind in ('M', 'X'):
        want = {tuple(sorted(e)) for e in docs['jax']['traceEvents'] if e['ph'] == kind}
        got = {tuple(sorted(e)) for e in docs['torch']['traceEvents'] if e['ph'] == kind}
        assert got == want
