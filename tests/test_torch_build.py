"""The port's native build (``petastorm_tpu_torch/ops/build.py``) with fake
compilers: a compiler that outlives ``BUILD_TIMEOUT_S`` is killed with its
children and the build raises naming the source; a failing compiler
raises with its output; a working one publishes the library under its
hashed name; and a later build finds it and starts nothing."""

import os
import stat
import time

import pytest

from petastorm_tpu_torch.ops import build
from tests.torch_telemetry_common import plane_guard  # noqa: F401 - autouse


def _fake_compiler(tmp_path, body):
    path = tmp_path / 'fake-cc'
    path.write_text('#!/bin/sh\n' + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    """Point the build at a scratch directory and at one source, compiled
    by the fake compiler the test writes."""
    source = tmp_path / 'thing.c'
    source.write_text('int thing;\n')
    compilers = {}
    monkeypatch.setattr(build, 'BUILD_DIR', str(tmp_path / 'out'))
    monkeypatch.setattr(build, '_recipe', lambda name: (str(source), (), (),
                                                        lambda: compilers['cc']))
    monkeypatch.setattr(build, 'build_log', {})

    def use(body):
        compilers['cc'] = _fake_compiler(tmp_path, body)
        return str(source)
    return use


def _leftovers(tmp_path):
    return sorted(f for f in os.listdir(tmp_path / 'out') if f != '.build.lock')


def test_a_hung_compiler_is_killed_and_the_build_raises(fake_build, tmp_path, monkeypatch):
    # a child that holds the output pipe too, as nvcc's cicc and ptxas do
    marker = tmp_path / 'child-ran-on'
    source = fake_build('sleep 30 &\nsleep 30\ntouch %s\n' % marker)
    monkeypatch.setattr(build, 'BUILD_TIMEOUT_S', 0.5)
    start = time.monotonic()
    with pytest.raises(RuntimeError, match='ran past 0.5 s') as err:
        build.build(['thing'])
    assert source in str(err.value)
    assert time.monotonic() - start < 10
    assert _leftovers(tmp_path) == []
    time.sleep(0.2)
    assert not marker.exists()


def test_a_failing_compiler_raises_with_its_output(fake_build, tmp_path):
    fake_build('echo "thing.c:1: error: no"\nexit 3\n')
    with pytest.raises(RuntimeError, match=r'thing \(rc 3\):\nthing.c:1: error: no'):
        build.build(['thing'])
    assert _leftovers(tmp_path) == []


def test_a_working_compiler_publishes_the_library_once(fake_build, tmp_path):
    # the fake compiler writes its -o argument, as cc and nvcc do
    fake_build('while [ "$1" != "-o" ]; do shift; done\necho built > "$2"\n')
    build.build(['thing'])
    out = build.library_path('thing')
    assert _leftovers(tmp_path) == [os.path.basename(out)]
    assert build.build_log['thing']['seconds'] < build.BUILD_TIMEOUT_S
    fake_build('exit 1\n')            # a second build must not run it
    build.build(['thing'])
    assert _leftovers(tmp_path) == [os.path.basename(out)]


def test_the_timeout_leaves_room_for_the_slowest_source():
    # flash_attention.cu takes about 20 s of nvcc on the H100's host
    assert build.BUILD_TIMEOUT_S >= 10 * 20
