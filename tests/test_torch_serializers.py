"""The port's serializers and cross-process telemetry deltas against the
JAX package's, on the CPU.

Values are made with numpy from a seed. Held exactly (no tolerance):
``PickleSerializer`` frames equal the reference's for the same value, and
each side reads the other's; the
received arrays are views over the frames, read-only under the sanitizer;
``collect_delta`` gives the reference's dicts for the same operations,
and ``merge_delta`` the same snapshot; ``load_delta_frame`` accepts and
rejects the same frames; ``dump_delta_frame`` carries and drains the
recorder's events; ``merge_worker_delta`` replays the wait clocks into
the stall attributor and the events into the recorder, as the
reference's does.
"""

import dill
import numpy as np
import pyarrow as pa
import pytest

from petastorm_tpu import serializers as jax_serializers
from petastorm_tpu import telemetry as jax_telemetry
from petastorm_tpu.telemetry import registry as jax_registry
from petastorm_tpu_torch import sanitizer
from petastorm_tpu_torch import serializers as torch_serializers
from petastorm_tpu_torch import telemetry as torch_telemetry
from petastorm_tpu_torch.telemetry import registry as torch_registry
from tests.torch_telemetry_common import telemetry_guard  # noqa: F401 - autouse

PACKAGES = {'jax': (jax_serializers, jax_telemetry, jax_registry),
            'torch': (torch_serializers, torch_telemetry, torch_registry)}


def _value(seed=0):
    rng = np.random.RandomState(seed)
    return {'image': rng.randint(0, 255, (4, 8, 8, 3), dtype=np.uint8),
            'x': rng.rand(4, 3).astype(np.float32),
            'id': np.arange(4, dtype=np.int64),
            'names': ['a', 'b', 'c', 'd'], 'epoch': 2}


def _assert_value_equal(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        if isinstance(a[key], np.ndarray):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
        else:
            assert a[key] == b[key]


def _frames_values():
    """name -> (value, out-of-band frames): each a payload the pool ships."""
    rng = np.random.RandomState(4)
    return {
        'column-batch': (_value(), 3),
        'row-dicts': ([{'id': np.int64(i), 'image': rng.randint(0, 255, (8, 8, 3), np.uint8)}
                       for i in range(3)], 3),
        'arrow-table': (pa.table({'id': np.arange(6, dtype=np.int64),
                                  'x': rng.rand(6).astype(np.float32)}), None),
        'transposed': ({'x': rng.rand(3, 5).astype(np.float32).T}, 1),
        'empty': ({'image': np.zeros((0, 8, 8, 3), np.uint8), 'id': np.zeros(0, np.int64)}, 2),
    }


def _assert_payload_equal(a, b):
    if isinstance(a, pa.Table):
        assert a.equals(b)
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_value_equal(x, y)
    else:
        _assert_value_equal(a, b)


@pytest.mark.parametrize('name', sorted(_frames_values()))
def test_pickle_frames_are_the_references(name):
    value, out_of_band = _frames_values()[name]
    want = [bytes(f) for f in jax_serializers.PickleSerializer().serialize_frames(value)]
    got = [bytes(f) for f in torch_serializers.PickleSerializer().serialize_frames(value)]
    # the stream, then one out-of-band frame for each buffer
    assert got == want
    if out_of_band is not None:
        assert len(got) == 1 + out_of_band
    for reader in (jax_serializers, torch_serializers):
        _assert_payload_equal(value, reader.PickleSerializer().deserialize_frames(got))


def test_pickle_receive_is_zero_copy_and_writeable_views():
    value = _value(1)
    frames = [bytearray(f) for f in torch_serializers.PickleSerializer().serialize_frames(value)]
    out = torch_serializers.PickleSerializer().deserialize_frames(
        [memoryview(f) for f in frames])
    _assert_value_equal(out, value)
    # the image is a view over its frame: a write to the frame shows
    frames[1][0] ^= 0xFF
    assert out['image'].reshape(-1)[0] == value['image'].reshape(-1)[0] ^ 0xFF


def test_pickle_receive_is_read_only_under_the_sanitizer(monkeypatch):
    monkeypatch.setenv('PETASTORM_TPU_SANITIZE', '1')
    for package in PACKAGES.values():
        package[1].refresh()
    sanitizer.refresh_sanitizer()
    frames = [bytearray(f) for f in torch_serializers.PickleSerializer().serialize_frames(
        _value(2))]
    out = torch_serializers.PickleSerializer().deserialize_frames(
        [memoryview(f) for f in frames])
    for name in ('image', 'x', 'id'):
        assert not out[name].flags.writeable, name
    with pytest.raises(ValueError):
        out['image'][0, 0, 0, 0] = 1


# -- deltas ----------------------------------------------------------------------


def _operate(registry, step):
    """The same operations on either package's registry."""
    registry.counter('rows_total').inc(3 + step)
    registry.counter('stage_seconds_total', stage='decode').inc(0.25 * (step + 1))
    registry.gauge('depth').set(7 - step)
    hist = registry.histogram('latency_seconds', buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0)[:step + 2]:
        hist.observe(v)
    if step == 1:
        registry.counter('late_total', site='x').inc()


def test_collect_delta_dicts_are_the_references():
    regs = {name: p[2].MetricsRegistry() for name, p in PACKAGES.items()}
    for step in range(3):
        deltas = {}
        for name, reg in regs.items():
            _operate(reg, step)
            deltas[name] = reg.collect_delta()
        assert deltas['torch'] == deltas['jax'], step
        assert deltas['torch']['counters'] and deltas['torch']['histograms']
    # nothing changed since the last flush
    assert {name: reg.collect_delta() for name, reg in regs.items()} == \
        {'jax': None, 'torch': None}
    # the gauge ships only when its value moved
    for reg in regs.values():
        reg.gauge('depth').set(99)
    assert regs['torch'].collect_delta() == regs['jax'].collect_delta() == \
        {'counters': {}, 'gauges': {'depth': 99.0}, 'histograms': {}}


def test_merge_delta_snapshots_are_the_references():
    source = torch_registry.MetricsRegistry()
    deltas = []
    for step in range(3):
        _operate(source, step)
        deltas.append(source.collect_delta())
    deltas.append({'counters': {}, 'gauges': {},
                   'histograms': {'latency_seconds': {'buckets': [1.0], 'counts': [1, 0],
                                                      'sum': 0.5, 'count': 1}}})
    snapshots = {}
    for name, p in PACKAGES.items():
        reg = p[2].MetricsRegistry()
        for delta in deltas:
            reg.merge_delta(delta)
        reg.merge_delta(None)
        snapshots[name] = reg.snapshot()
    assert snapshots['torch'] == snapshots['jax']
    # the merged sums are the source's (the mismatched layout dropped)
    assert snapshots['torch'] == source.snapshot()


def _frames():
    good = {'counters': {'a': 1.0}, 'gauges': {}, 'histograms': {}}
    return {
        'empty': b'',
        'garbage': b'\x00not a pickle',
        'list': dill.dumps([1, 2]),
        'missing-key': dill.dumps({'counters': {'a': 1.0}, 'gauges': {}}),
        'extra-key': dill.dumps(dict(good, other={})),
        'field-not-dict': dill.dumps({'counters': [1], 'gauges': {}, 'histograms': {}}),
        'events-not-list': dill.dumps(dict(good, trace_events={})),
        'all-empty': dill.dumps({'counters': {}, 'gauges': {}, 'histograms': {}}),
        'result-dict': dill.dumps({'id': np.arange(3)}),
        'good': dill.dumps(good),
        'good-events': dill.dumps(dict(good, trace_events=[{'name': 'attempt'}])),
        'events-only': dill.dumps({'counters': {}, 'gauges': {}, 'histograms': {},
                                   'trace_events': [{'name': 'decode'}]}),
    }


@pytest.mark.parametrize('name', sorted(_frames()))
def test_load_delta_frame_accepts_and_rejects_the_references_frames(name):
    frame = _frames()[name]
    want = jax_registry.load_delta_frame(frame)
    got = torch_registry.load_delta_frame(frame)
    assert got == want
    assert (got is not None) == name.startswith(('good', 'events-only'))


def test_dump_delta_frame_carries_and_drains_the_recorder():
    frames = {}
    for name, (_, telemetry, registry) in PACKAGES.items():
        assert registry.dump_delta_frame() == b''
        telemetry.get_registry().counter('rows_total').inc(5)
        telemetry.get_recorder().add_many([{'name': 'attempt', 'ph': 'X', 'ts': 1.0,
                                            'dur': 2.0, 'pid': 1, 'tid': 'process-0'}])
        frames[name] = registry.dump_delta_frame()
        assert len(telemetry.get_recorder()) == 0
        assert registry.dump_delta_frame() == b''
    loaded = {name: torch_registry.load_delta_frame(frame) for name, frame in frames.items()}
    assert loaded['torch'] == loaded['jax']
    assert loaded['torch']['counters'] == {'rows_total': 5.0}
    assert [e['name'] for e in loaded['torch']['trace_events']] == ['attempt']


def test_merge_worker_delta_replays_waits_events_and_metrics():
    producer = torch_telemetry.STALL_PRODUCER_WAIT
    consumer = torch_telemetry.STALL_CONSUMER_WAIT
    assert (producer, consumer) == (jax_telemetry.STALL_PRODUCER_WAIT,
                                    jax_telemetry.STALL_CONSUMER_WAIT)
    delta = {'counters': {producer: 0.75, consumer: 0.25, 'rows_total': 4.0},
             'gauges': {'depth': 3.0}, 'histograms': {},
             'trace_events': [{'name': 'decode', 'ph': 'X', 'ts': 5.0, 'dur': 1.0,
                               'pid': 9, 'tid': 'process-1'}, 'not an event']}
    for _, telemetry, registry in PACKAGES.values():
        registry.merge_worker_delta(delta)
        registry.merge_worker_delta(None)
        registry.merge_worker_delta({'counters': 'unmergeable'})   # never raises
    jax_snap, torch_snap = (p[1].get_registry().snapshot() for p in PACKAGES.values())
    assert torch_snap == jax_snap
    assert torch_snap['counters']['rows_total'] == 4.0
    assert torch_telemetry.get_attributor().totals() == jax_telemetry.get_attributor().totals()
    assert torch_telemetry.get_attributor().totals() == (0.75, 0.25)
    assert [e['name'] for e in torch_telemetry.get_recorder().snapshot()] == ['decode']


def test_recorder_add_many_and_drain():
    recorder = torch_telemetry.FlightRecorder(capacity=3)
    recorder.add_many({'name': str(i)} for i in range(5))
    assert [e['name'] for e in recorder.drain()] == ['2', '3', '4']
    assert len(recorder) == 0 and recorder.drain() == []
