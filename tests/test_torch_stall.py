"""petastorm_tpu_torch.telemetry.stall against the JAX package's, on the
CPU: ``classify_window`` over one grid of waits and window lengths, and
``StallAttributor``'s windows, totals and verdicts over the same notes at
the same times (a fake clock in both modules, no sleeps)."""

import itertools
import types

import pytest

from petastorm_tpu import telemetry as jax_telemetry
from petastorm_tpu.telemetry import stall as jax_stall
from petastorm_tpu_torch import telemetry as torch_telemetry
from petastorm_tpu_torch.telemetry import stall as torch_stall
from tests.torch_telemetry_common import telemetry_guard  # noqa: F401 - autouse

WAITS = (0.0, 0.001, 0.004, 0.01, 0.03, 0.1, 0.25, 0.5)


@pytest.mark.parametrize('window_s', [0.05, 0.5, 2.0])
def test_classify_window_is_the_references(window_s):
    for producer, consumer in itertools.product(WAITS, WAITS):
        assert torch_stall.classify_window(producer, consumer, window_s) == \
            jax_stall.classify_window(producer, consumer, window_s), (producer, consumer)


def test_verdict_names_are_the_references():
    assert (torch_stall.PRODUCER_BOUND, torch_stall.CONSUMER_BOUND, torch_stall.BALANCED) == \
        (jax_stall.PRODUCER_BOUND, jax_stall.CONSUMER_BOUND, jax_stall.BALANCED)


class _Clock:
    def __init__(self):
        self.now = 500.0

    def monotonic(self):
        return self.now


def _play(stall, monkeypatch, notes, window_s=0.5, max_windows=240):
    """``notes``: ``(dt, side, seconds)``, the clock advancing by ``dt``
    before each note; returns every read of the attributor."""
    clock = _Clock()
    monkeypatch.setattr(stall, 'time', types.SimpleNamespace(monotonic=clock.monotonic))
    attributor = stall.StallAttributor(window_s=window_s, max_windows=max_windows)
    for dt, side, seconds in notes:
        clock.now += dt
        if side == 'producer':
            attributor.note_producer_wait(seconds)
        else:
            attributor.note_consumer_wait(seconds)
    reads = {'closed': attributor.windows(include_current=False),
             'with_current': attributor.windows(),
             'totals': attributor.totals(),
             'verdict': attributor.verdict(),
             'verdict_last_2': attributor.verdict(last_n=2),
             'window_s': attributor.window_s}
    clock.now += 3 * window_s
    reads['later'] = attributor.windows()
    attributor.reset()
    reads['after_reset'] = (attributor.windows(), attributor.totals(), attributor.verdict())
    return reads


SCHEDULES = {
    'producer-bound': [(0.1, 'consumer', 0.08)] * 20,
    'consumer-bound': [(0.1, 'producer', 0.05), (0.05, 'consumer', 0.001)] * 15,
    'balanced': [(0.1, 'producer', 0.03), (0.1, 'consumer', 0.03)] * 10,
    'quiet': [(0.2, 'consumer', 0.0005)] * 10,
    'flapping': ([(0.1, 'consumer', 0.09)] * 6 + [(0.1, 'producer', 0.09)] * 6) * 3,
    'idle-gap': [(0.1, 'consumer', 0.05)] * 5 + [(400.0, 'producer', 0.2)]
                + [(0.1, 'producer', 0.05)] * 5,
    'zero-and-negative': [(0.1, 'consumer', 0.0), (0.1, 'producer', -1.0),
                          (0.3, 'consumer', 0.2)],
}


@pytest.mark.parametrize('name', sorted(SCHEDULES))
def test_attributor_is_the_references(monkeypatch, name):
    want = _play(jax_stall, monkeypatch, SCHEDULES[name])
    got = _play(torch_stall, monkeypatch, SCHEDULES[name])
    assert got == want
    assert got['after_reset'] == ([], (0.0, 0.0), torch_stall.BALANCED)


def test_attributor_bounds_its_windows_as_the_reference(monkeypatch):
    notes = [(0.05, 'consumer', 0.02)] * 200
    want = _play(jax_stall, monkeypatch, notes, window_s=0.1, max_windows=7)
    got = _play(torch_stall, monkeypatch, notes, window_s=0.1, max_windows=7)
    assert got == want
    assert len(got['closed']) == 7


@pytest.mark.parametrize('spelling, window_s', [
    (None, 0.5), ('0.25', 0.25), ('2', 2.0), ('0', 0.5), ('-1', 0.5), ('junk', 0.5)])
def test_window_knob_is_the_references(monkeypatch, spelling, window_s):
    if spelling is not None:
        monkeypatch.setenv('PETASTORM_TPU_METRICS_WINDOW_S', spelling)
    assert torch_stall.default_window_s() == jax_stall.default_window_s() == window_s
    assert torch_stall.StallAttributor().window_s == window_s


@pytest.mark.parametrize('metrics', ['on', 'off'])
def test_wait_notes_feed_counters_and_attributor(monkeypatch, metrics):
    if metrics == 'off':
        monkeypatch.setenv('PETASTORM_TPU_METRICS', '0')
    for telemetry in (jax_telemetry, torch_telemetry):
        telemetry.refresh()
        telemetry.note_producer_wait(0.2)
        telemetry.note_consumer_wait(0.05)
        telemetry.note_consumer_wait(0.0)
        registry = telemetry.get_registry()
        totals = (registry.counter_value(telemetry.STALL_PRODUCER_WAIT),
                  registry.counter_value(telemetry.STALL_CONSUMER_WAIT))
        want = (0.2, 0.05) if metrics == 'on' else (0.0, 0.0)
        assert totals == want
        assert telemetry.get_attributor().totals() == want


def test_process_attributor_is_shared_until_reset():
    attributor = torch_telemetry.get_attributor()
    assert torch_telemetry.get_attributor() is attributor
    torch_telemetry.note_consumer_wait(0.3)
    assert attributor.totals() == (0.0, 0.3)
    torch_telemetry.reset_attributor()
    assert torch_telemetry.get_attributor() is not attributor
    assert torch_telemetry.get_attributor().totals() == (0.0, 0.0)
