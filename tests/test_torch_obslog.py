"""petastorm_tpu_torch's on-disk flight log and its replay tool against
the JAX package's, on the CPU.

The two-slot ring rotates at its cap exactly as the reference's does and
torn lines are skipped. A log written by the port reads through the
reference's ``read_log`` and the other way round. The port's
``fold_summary`` equals ``tools/obs_replay.py``'s on the same records
(the reference tool is loaded by its path), both renderings name the
breach, and ``python -m petastorm_tpu_torch.tools.obs_replay`` prints the
same summary with ``--json``. Every file lives under ``tmp_path``.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from petastorm_tpu.telemetry import obslog as jax_obslog
from petastorm_tpu_torch.telemetry import obslog as torch_obslog
from petastorm_tpu_torch.tools import obs_replay as torch_replay
from tests.torch_telemetry_common import telemetry_guard  # noqa: F401 - autouse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBSLOG = {'jax': jax_obslog, 'torch': torch_obslog}


def _reference_replay():
    """``tools/obs_replay.py``, loaded from its path."""
    spec = importlib.util.spec_from_file_location(
        'reference_obs_replay', os.path.join(REPO, 'tools', 'obs_replay.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _records(seed, n=40):
    """A run's worth of log records made from ``seed``: windows, SLO
    verdicts that start breaching, clear and breach again, anomalies
    and two critical-path digests."""
    rng = np.random.RandomState(seed)
    out = []
    t = 1000.0
    breaching = False
    for i in range(n):
        out.append(('window', {'start': t, 'dur_s': 0.25, 'throughput': float(rng.rand() * 50),
                               'verdict': ['balanced', 'consumer-bound'][i % 2],
                               'producer_wait_s': float(rng.rand()),
                               'consumer_wait_s': float(rng.rand()), 'rates': {},
                               'ts': t + 0.25}))
        now_breaching = 8 <= i < 20 or i >= 30
        out.append(('slo', {'ts': t, 'targets': [
            {'target': 'queue_wait_p99', 'op': '<=', 'threshold': 5e-05,
             'value': float(rng.choice([1e-5, 1e-3])), 'bad': bool(i % 3),
             'short_burn': float(i % 11), 'long_burn': float(i % 7) / 2,
             'budget_remaining': max(0.0, 1.0 - i / 20), 'breaching': now_breaching},
            {'target': 'rows_per_sec', 'op': '>=', 'threshold': 1.0, 'value': 9.0,
             'bad': False, 'short_burn': 0.0, 'long_burn': 0.0, 'budget_remaining': 1.0,
             'breaching': False}]}))
        if now_breaching and not breaching:
            out.append(('anomaly', {'anomaly': 'slo_breach', 'ts': t + 0.1,
                                    'detail': {'target': 'queue_wait_p99'},
                                    'window_start': t, 'runbook': 'docs/troubleshoot.md'}))
        breaching = now_breaching
        if i in (5, 25):
            out.append(('anomaly', {'anomaly': 'queue_saturated', 'ts': t + 0.2,
                                    'detail': {'producer_wait_share': 0.9},
                                    'window_start': t, 'runbook': 'docs/troubleshoot.md'}))
        if i in (15, 35):
            out.append(('critpath', {'ts': t, 'bottleneck': 'decode', 'events': 100 + i,
                                     'span_s': 2.5,
                                     'what_if': [{'scenario': 'decode 2x faster',
                                                  'epoch_delta_pct': -12.5, 'saving_s': 0.3}]}))
        t += 0.25
    return out


def _write(name, directory, records, cap=None):
    writer = OBSLOG[name].ObsLogWriter(str(directory), cap=cap)
    for kind, record in records:
        assert writer.append(kind, record)
    return writer


@pytest.mark.parametrize('cap', [300, 2000, 64 * 1024 * 1024])
def test_two_slot_ring_rotates_as_the_reference(tmp_path, cap):
    records = [('window', {'seq': seq, 'ts': float(seq)}) for seq in range(60)]
    writers = {name: _write(name, tmp_path / name, records, cap=cap) for name in OBSLOG}
    for suffix in ('', '.1'):
        paths = {name: w.path + suffix for name, w in writers.items()}
        assert os.path.exists(paths['torch']) == os.path.exists(paths['jax'])
        if os.path.exists(paths['torch']):
            with open(paths['torch'], 'rb') as a, open(paths['jax'], 'rb') as b:
                assert a.read() == b.read()
    seqs = [r['seq'] for r in torch_obslog.read_log(str(tmp_path / 'torch'))]
    assert seqs == sorted(seqs) and seqs[-1] == 59
    if cap == 300:
        total = sum(os.path.getsize(writers['torch'].path + s) for s in ('', '.1'))
        assert total < 3 * cap and len(seqs) < 60
    else:
        assert seqs == list(range(60))


def test_read_log_skips_torn_lines(tmp_path):
    path = os.path.join(str(tmp_path), 'obslog.jsonl')
    with open(path + '.1', 'w') as f:
        f.write(json.dumps({'kind': 'window', 'seq': -1}) + '\n')
    with open(path, 'w') as f:
        f.write(json.dumps({'kind': 'window', 'seq': 0}) + '\n\n')
        f.write('{"kind": "window", "seq": 1')  # a crash mid-write
    for obslog in OBSLOG.values():
        assert [r['seq'] for r in obslog.read_log(str(tmp_path))] == [-1, 0]
    assert torch_obslog.read_log(str(tmp_path / 'missing')) == []


def test_append_follows_the_knob(tmp_path, monkeypatch):
    for name, obslog in OBSLOG.items():
        assert obslog.append('window', {'a': 1}) is False
        directory = str(tmp_path / name)
        monkeypatch.setenv('PETASTORM_TPU_OBS_LOG_DIR', directory)
        obslog.refresh_obslog()
        assert obslog.log_dir() == directory
        assert obslog.append('window', {'a': 1}) is True
        assert obslog.get_writer() is obslog.get_writer()
        (record,) = obslog.read_log(directory)
        assert record['kind'] == 'window' and record['a'] == 1 and record['ts'] > 0
        monkeypatch.delenv('PETASTORM_TPU_OBS_LOG_DIR')
        obslog.refresh_obslog()
    monkeypatch.setenv('PETASTORM_TPU_OBS_LOG_MB', '3')
    assert torch_obslog.cap_bytes() == jax_obslog.cap_bytes() == 3 * 1024 * 1024


def test_unwritable_directory_degrades_without_raising(tmp_path):
    blocker = tmp_path / 'file'
    blocker.write_text('x')
    writer = torch_obslog.ObsLogWriter(str(blocker / 'sub'))
    assert writer.append('window', {'a': 1}) is False
    assert writer.append('window', {'a': 2}) is False


@pytest.mark.parametrize('writer,reader', [('torch', 'jax'), ('jax', 'torch')])
def test_logs_cross_packages(tmp_path, writer, reader):
    records = _records(0)
    _write(writer, tmp_path, records)
    got = OBSLOG[reader].read_log(str(tmp_path))
    assert got == OBSLOG[writer].read_log(str(tmp_path))
    assert [r['kind'] for r in got] == [kind for kind, _ in records]
    assert got == [json.loads(json.dumps(dict(rec, kind=kind), sort_keys=True))
                   for kind, rec in records]


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_fold_summary_is_the_references(tmp_path, seed):
    _write('torch', tmp_path, _records(seed))
    records = torch_obslog.read_log(str(tmp_path))
    reference = _reference_replay()
    got = torch_replay.fold_summary(records)
    assert got == reference.fold_summary(records)
    assert torch_replay.split_records(records) == reference.split_records(records)
    assert torch_replay.fold_slo(records[:0]) == []
    folded = next(t for t in got['slo'] if t['target'] == 'queue_wait_p99')
    assert folded['breaching_at_end'] and folded['breaches'][-1][1] is None
    assert len(folded['breaches']) == 2 and folded['breaches'][0][1] is not None
    assert got['anomaly_kinds'] == {'slo_breach': 2, 'queue_saturated': 2}
    assert got['critical_path']['events'] == 135


@pytest.mark.parametrize('last', [None, 5])
def test_renderings_name_the_breach_as_the_reference(tmp_path, last):
    _write('torch', tmp_path, _records(1))
    records = torch_obslog.read_log(str(tmp_path))
    reference = _reference_replay()
    renderings = {}
    for name, tool in (('torch', torch_replay), ('jax', reference)):
        lines = []
        summary = tool.fold_summary(records)
        tool.render_timeline(tool.split_records(records), last=last, out=lines.append)
        tool.render_burn_report(summary['slo'], out=lines.append)
        tool.render_critpath(summary['critical_path'], out=lines.append)
        renderings[name] = lines
    assert renderings['torch'] == renderings['jax']
    lines = renderings['torch']
    assert any('!! slo_breach' in line for line in lines)
    assert any('BREACHING at end of log' in line for line in lines)
    assert any('bottleneck decode' in line for line in lines)


def test_empty_renderings_are_the_references():
    reference = _reference_replay()
    for tool in (torch_replay, reference):
        lines = []
        tool.render_timeline(tool.split_records([]), out=lines.append)
        tool.render_burn_report([], out=lines.append)
        tool.render_critpath(None, out=lines.append)
        assert len(lines) == 3
    got, want = [], []
    torch_replay.render_burn_report([], out=got.append)
    reference.render_burn_report([], out=want.append)
    assert got == want


def test_cli_prints_the_summary(tmp_path, capsys):
    _write('torch', tmp_path, _records(2))
    assert torch_replay.main([str(tmp_path), '--json']) == 0
    summary = json.loads(capsys.readouterr().out)
    records = torch_obslog.read_log(str(tmp_path))
    assert summary == json.loads(json.dumps(torch_replay.fold_summary(records), default=str))
    assert torch_replay.main([str(tmp_path), '--last', '3']) == 0
    text = capsys.readouterr().out
    assert 'last 3 shown' in text and 'slo burn report:' in text
    assert torch_replay.main([str(tmp_path / 'empty')]) == 1


def test_module_entry_point_runs(tmp_path):
    _write('jax', tmp_path, _records(0))
    env = {k: v for k, v in os.environ.items() if not k.startswith('PETASTORM_TPU_')}
    env['PYTHONPATH'] = REPO
    out = subprocess.run([sys.executable, '-m', 'petastorm_tpu_torch.tools.obs_replay',
                          str(tmp_path), '--json'], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=120, check=True).stdout
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary['windows'] == 40 and summary['anomaly_kinds']['slo_breach'] == 2
