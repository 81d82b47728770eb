"""``chip_smoke.py``'s per-phase stack dump, its rank pool and the
stand-ins ``remote_store_vit_path`` reads through, on the CPU.

Every phase of ``main`` (and every task of a spawned rank) runs under
``faulthandler.dump_traceback_later(PHASE_STACK_DUMP_S, repeat=True,
exit=False)``, cancelled when it returns or raises, so a phase that stops
leaves every thread's stack on stderr. It only reports: the phase's
result and exceptions pass through unchanged. The rank phases' pool of
spawned ranks runs each task in a new gloo group and stops every rank.
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
    assert _calls_in(funcs['_parallel_rank'], '_stack_dump_armed')


def test_rank_pool_runs_each_task_in_a_new_group(smoke):
    """One spawn serves every task: each joins a new gloo group (a device
    mesh over it included) on the pool's first ``world`` ranks, the
    results come back in rank order, and ``stop`` leaves no rank."""
    from tests.torch_stub_workers import group_probe
    pool = smoke._RankPool(3)
    try:
        assert pool.startup_s > 0
        pids = pool.pids
        for task, world in ((0, 2), (1, 3), (2, 2)):
            results = pool.run(group_probe, (task,), world)
            assert [r['rank'] for r in results] == list(range(world))
            assert [r['pid'] for r in results] == pids[:world]
            assert all(r['task'] == task and r['world'] == world
                       and r['sum'] == world * (world + 1) // 2 for r in results), results
    finally:
        pool.stop()
    assert [p.exitcode for p in pool._procs] == [0, 0, 0]


def test_rank_pool_fails_a_task_whose_rank_dies(smoke):
    """A rank that dies fails its task by name, and the pool stops."""
    from tests.torch_stub_workers import rank_exit
    pool = smoke._RankPool(2)
    try:
        with pytest.raises(AssertionError, match='rank_exit: a rank failed'):
            pool.run(rank_exit, (3,), 2)
    finally:
        pool.stop()
    assert [p.exitcode for p in pool._procs] == [0, 3]


# -- remote_store_vit_path: the bucket and the namenodes it stands up ----------------


def test_remote_store_phase_follows_process_vit_path():
    """The phase runs right after ``process_vit_path`` through ``_phase``,
    and its launches (ViT-Base from the bucket, the flagship over HDFS)
    join the ``kernels`` line's per-path counts."""
    with open(os.path.join(ROOT, 'chip_smoke.py')) as f:
        tree = ast.parse(f.read())
    main = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}['main']
    handed = [c.args[0].id for c in _calls_in(main, '_phase')]
    at = handed.index('phase_process_vit_path')
    assert handed[at + 1] == 'phase_remote_store_vit_path'
    keys = {t.slice.value for n in ast.walk(main) if isinstance(n, ast.Assign)
            for t in n.targets if isinstance(t, ast.Subscript)
            and isinstance(t.value, ast.Name) and t.value.id == 'paths'}
    assert {'remote_store_vit_path', 'remote_store_hdfs_lm'} <= keys


def test_remote_store_phase_launch_counts(smoke):
    """ViT-Base's 12 layers over ``REMOTE_VIT_STEPS`` (10) steps: 10
    normalize launches and 120 of each flash kernel; the flagship's 10
    layers over ``HDFS_LM_STEPS`` (5): 50 of each flash kernel a read."""
    from petastorm_tpu_torch.examples.imagenet import VIT_BASE_KW
    from petastorm_tpu_torch.examples.lm_pretrain import FLAGSHIP_LM_KW
    assert smoke.REMOTE_VIT_STEPS == 10
    assert VIT_BASE_KW['n_layers'] * smoke.REMOTE_VIT_STEPS == 120
    assert FLAGSHIP_LM_KW['n_layers'] * smoke.HDFS_LM_STEPS == 50
    assert set(smoke.FLASH_KERNELS) == {'flash_fwd', 'flash_bwd_dkv', 'flash_bwd_dq'}


def test_remote_store_refuses_and_records(smoke):
    """The phase's bucket: only bucket paths, no localizing call (each
    refusal recorded), every instance's options, read opens, nonzero
    seeks and bytes counted, each read open a handle of its own."""
    import fsspec
    store = smoke._remote_store_class()
    with smoke._gs_bound_to(store):
        fs = fsspec.filesystem('gs', token='t')
        with fs.open('gs://bucket/a/x', 'wb') as f:
            f.write(b'0123456789')
        first, second = fs.open('gs://bucket/a/x'), fs.open('/bucket/a/x')
        first.seek(4)
        assert first.read(3) == b'456' and second.read(2) == b'01'
        # the written bytes are taken once, and again only after a rewrite
        kept = store.frozen['/bucket/a/x'][1]
        fs.open('gs://bucket/a/x').close()
        assert store.frozen['/bucket/a/x'][1] is kept
        with fs.open('gs://bucket/a/x', 'wb') as f:
            f.write(b'0123456789')
        fs.open('gs://bucket/a/x').close()
        assert store.frozen['/bucket/a/x'][1] is not kept
        with pytest.raises(AssertionError, match='non-bucket'):
            fs.ls('gs://elsewhere/x')
        with pytest.raises(AssertionError, match='localizing'):
            fs.get('gs://bucket/a/x', '/tmp/x')
    assert store.options == [{'token': 't'}]
    assert store.opens == {'/bucket/a/x': 4}
    assert store.seeks == {'/bucket/a/x': 1} and store.bytes_read == [5]
    assert [kind for kind, _ in store.refused] == ['path', 'localizing']
    from fsspec.registry import _registry
    assert _registry.get('gs') is not store   # unbound again


def test_namenodes_die_for_good_and_resolve_from_the_site_xmls(smoke, tmp_path,
                                                                monkeypatch):
    """``nn-a`` serves its opens, then raises ``OSError`` and refuses new
    connections; ``nn-b`` serves. The written ``$HADOOP_HOME`` names both
    for the port's resolver, and its proxy fails over once, logged."""
    import logging

    from petastorm_tpu_torch import hdfs
    connect, record = smoke._namenodes(2)
    (tmp_path / 'f').write_bytes(b'x')
    a = connect('nn-a', 8020, None)
    for _ in range(2):
        with a.open(str(tmp_path / 'f'), 'rb') as f:
            assert f.read() == b'x'
    with pytest.raises(OSError, match='nn-a lost'):
        a.open(str(tmp_path / 'f'), 'rb')
    with pytest.raises(ConnectionError):
        connect('nn-a', 8020, None)
    assert record['opens'] == {'nn-a': 2} and record['died_in'] is not None

    for var in ('HADOOP_PREFIX', 'HADOOP_INSTALL'):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv('HADOOP_HOME', smoke._hadoop_home(str(tmp_path / 'hadoop')))
    resolver = hdfs.HdfsNamenodeResolver()
    assert resolver.resolve_default_hdfs_service() == (smoke.HDFS_NAMESERVICE,
                                                       list(smoke.HDFS_NAMENODES))
    connect, record = smoke._namenodes(1)
    monkeypatch.setattr(hdfs.HdfsConnector, '_connect_one', staticmethod(connect))
    messages = []

    class Keep(logging.Handler):
        def emit(self, log_record):
            messages.append(log_record.getMessage())

    handler = Keep()
    logging.getLogger(hdfs.__name__).addHandler(handler)
    try:
        from petastorm_tpu_torch.fs import get_filesystem_and_path_or_paths
        fs, path = get_filesystem_and_path_or_paths(
            'hdfs://%s%s' % (smoke.HDFS_NAMESERVICE, tmp_path / 'f'))
        for _ in range(3):
            with fs.open(path, 'rb') as f:
                assert f.read() == b'x'
    finally:
        logging.getLogger(hdfs.__name__).removeHandler(handler)
    assert record['opens'] == {'nn-a': 1, 'nn-b': 2}
    assert [m for m in messages if m.startswith('HDFS failover')] == [
        'HDFS failover: now connected to namenode nn-b:8020']
    assert fs._namenodes[fs._active] == 'nn-b:8020'
