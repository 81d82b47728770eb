"""``chip_smoke.py``'s per-phase stack dump, on the CPU.

Every phase of ``main`` (and every spawned rank) runs under
``faulthandler.dump_traceback_later(PHASE_STACK_DUMP_S, repeat=True,
exit=False)``, cancelled when it returns or raises, so a phase that stops
leaves every thread's stack on stderr. It only reports: the phase's
result and exceptions pass through unchanged.
"""

import ast
import os
import subprocess
import sys

import pytest

from tests.torch_telemetry_common import plane_guard  # noqa: F401 - autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def smoke(monkeypatch):
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke
    return chip_smoke


def test_phase_arms_the_dump_and_cancels_it(smoke, monkeypatch):
    calls = []
    monkeypatch.setattr(smoke.faulthandler, 'dump_traceback_later',
                        lambda *a, **k: calls.append(('arm', a, k)))
    monkeypatch.setattr(smoke.faulthandler, 'cancel_dump_traceback_later',
                        lambda: calls.append(('cancel',)))

    def phase(x, y=0):
        calls.append(('run', x, y))
        return x + y

    assert smoke._phase(phase, 1, y=2) == 3
    assert calls == [('arm', (smoke.PHASE_STACK_DUMP_S,), {'repeat': True, 'exit': False}),
                     ('run', 1, 2), ('cancel',)]
    assert smoke.PHASE_STACK_DUMP_S == 300
    calls.clear()

    def failing():
        raise RuntimeError('phase failed')

    with pytest.raises(RuntimeError, match='phase failed'):
        smoke._phase(failing)
    assert [c[0] for c in calls] == ['arm', 'cancel']


def test_a_phase_past_the_limit_dumps_every_threads_stack():
    """A real timer, shortened: a phase that sleeps past it leaves the
    stacks on stderr and still returns normally."""
    code = ('import sys, threading, time; sys.path.insert(0, %r); import chip_smoke; '
            'chip_smoke.PHASE_STACK_DUMP_S = 0.2; '
            'threading.Thread(target=time.sleep, args=(2,), name="side", daemon=True).start(); '
            'print(chip_smoke._phase(lambda: time.sleep(0.7) or "done"))' % ROOT)
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, CUDA_VISIBLE_DEVICES=''))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'done'
    assert 'Timeout (0:00:00.200000)!' in out.stderr
    assert out.stderr.count('most recent call first') >= 2     # both threads
    assert '<lambda>' in out.stderr


def _calls_in(node, prefix):
    return [n for n in ast.walk(node) if isinstance(n, ast.Call)
            and isinstance(n.func, ast.Name) and n.func.id.startswith(prefix)]


def test_every_phase_of_main_runs_under_the_dump():
    """``main`` calls no ``phase_*``/``write_*`` function itself: each is
    handed to ``_phase``; the spawned ranks arm the dump too."""
    with open(os.path.join(ROOT, 'chip_smoke.py')) as f:
        tree = ast.parse(f.read())
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    main = funcs['main']
    for prefix in ('phase_', 'write_'):
        assert _calls_in(main, prefix) == [], prefix
    handed = [c.args[0].id for c in _calls_in(main, '_phase')]
    assert len(handed) > 40 and all(name.startswith(('phase_', 'write_', 'generate_'))
                                    for name in handed)
    for rank in ('_parallel_rank', '_dp_rank'):
        assert [c for c in _calls_in(funcs[rank], '_stack_dump_armed')], rank
