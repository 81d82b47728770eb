"""The port's plane guard charges a test only for what that test left.

A JAX-package test that ran earlier in the same process can leave a
staging tuner and its decoder-thread override behind; the first port test
after it must not fail for that. These cases drive the guard's body
(``guarded_planes``) by hand with fake leftovers of both packages."""

import threading

import pytest

from petastorm_tpu import codecs as jax_codecs
from petastorm_tpu_torch import codecs as torch_codecs
from petastorm_tpu_torch import readahead as torch_readahead
from tests import torch_telemetry_common as common
from tests.torch_telemetry_common import plane_guard  # noqa: F401 - autouse


def _plant_jax_decoder_override():
    jax_codecs.set_image_decoder_threads_override(3)


def _plant_port_decoder_override():
    torch_codecs.set_image_decoder_threads_override(3)


def _plant_port_depth_override():
    torch_readahead._depth_override = 7


PLANTS = {
    'jax decoder-thread override': _plant_jax_decoder_override,
    'port decoder-thread override': _plant_port_decoder_override,
    'port readahead depth override': _plant_port_depth_override,
}


def _guarded(plant_before=None, plant_inside=None, wait_s=0.2):
    """Run one guarded 'test' whose body plants ``plant_inside``, after
    ``plant_before`` was left by an earlier one; returns what the guard
    found inherited."""
    if plant_before is not None:
        plant_before()
    guard = common.guarded_planes(wait_s=wait_s)
    inherited = next(guard)
    if plant_inside is not None:
        plant_inside()
    assert next(guard, 'done') == 'done'
    return inherited


@pytest.mark.parametrize('leftover', sorted(PLANTS))
def test_a_leftover_planted_before_the_test_is_not_charged_to_it(leftover):
    inherited = _guarded(plant_before=PLANTS[leftover])
    assert leftover in inherited, inherited
    assert not common.plane_leftovers()


@pytest.mark.parametrize('leftover', sorted(PLANTS))
def test_a_leftover_planted_inside_the_test_still_fails_it(leftover):
    with pytest.raises(AssertionError, match='left behind') as info:
        _guarded(plant_inside=PLANTS[leftover])
    assert leftover in str(info.value)
    # the failing guard still reset both planes
    assert not common.plane_leftovers()


def test_a_leftover_released_within_the_wait_is_not_charged():
    """A loader's staging thread drops its override shortly after
    ``stop()``: the teardown waits for it instead of failing the test."""
    release = threading.Timer(0.3, torch_codecs.set_image_decoder_threads_override, (None,))

    def plant_then_release_late():
        _plant_port_decoder_override()
        release.start()

    try:
        _guarded(plant_inside=plant_then_release_late, wait_s=5.0)
    finally:
        release.join(5.0)
    assert not release.is_alive()
