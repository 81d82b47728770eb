"""pipecheck on the port (``petastorm_tpu_torch/analysis``) held against the
JAX package's analyzer.

The gate: the port's analyzer finds nothing in ``petastorm_tpu_torch``.
Parity: on every fixture of ``tests/data/analysis/`` both analyzers give
the same ``(file, line, rule)`` multiset, and on the reference tree the
six rules that read no registry find nothing under either. Then the
twins of ``tests/test_analysis.py``'s snippet, suppression and CLI
cases, the port's own call-graph resolution across its modules, the
light-import contract, and the contract sets against the reference's.
"""

import collections
import json
import os
import re
import subprocess
import sys

import pytest

from petastorm_tpu.analysis import analyze_paths as jax_analyze_paths
from petastorm_tpu.analysis import contracts as jax_contracts
from petastorm_tpu_torch.analysis import (
    ALL_RULES, RULE_DESCRIPTIONS, analyze_paths, analyze_source, contracts,
)
from petastorm_tpu_torch.analysis.callgraph import CallGraph, module_name
from petastorm_tpu_torch.analysis.core import iter_python_files
from petastorm_tpu_torch.analysis.findings import SourceModule
from petastorm_tpu_torch.analysis.pass_env_knobs import check_docs_coverage
from petastorm_tpu_torch.telemetry import names
from tests.torch_telemetry_common import plane_guard  # noqa: F401 - autouse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, 'petastorm_tpu_torch')
REFERENCE = os.path.join(REPO, 'petastorm_tpu')
FIXTURES = os.path.join(REPO, 'tests', 'data', 'analysis')
PORT_DOCS = os.path.join(PORT, 'docs', 'env_knobs.md')
REPO_DOCS = os.path.join(REPO, 'docs', 'env_knobs.md')

#: the rules whose verdicts read no registry of names, knobs or sites
REGISTRY_FREE_RULES = ('blocking-under-lock', 'lock-order', 'thread-lifecycle',
                       'pickle-payload', 'buffer-escape', 'buffer-write')

#: what the port's registry adds to the reference's
PORT_ONLY_METRICS = {'petastorm_tpu_native_build_failures_total',
                     'petastorm_tpu_native_decoded_cells_total'}
PORT_ONLY_BORROW_ATTRS = {'slot.tensors', 'slot.views'}


def _fixtures():
    return sorted(name for name in os.listdir(FIXTURES)
                  if name.endswith('.py') or os.path.isdir(os.path.join(FIXTURES, name)))


def _keys(findings):
    return collections.Counter((f.path, f.line, f.rule) for f in findings)


def _fixture_findings(name, rule=None):
    findings = analyze_paths([os.path.join(FIXTURES, name)], root=REPO, check_docs=False)
    return [f for f in findings if rule is None or f.rule == rule]


# -- the gate -----------------------------------------------------------------


def test_port_is_finding_free():
    findings = analyze_paths([PORT], root=REPO)
    assert findings == [], 'pipecheck findings on the port:\n%s' % '\n'.join(map(str, findings))


def test_gate_scans_the_real_tree():
    files = list(iter_python_files([PORT]))
    assert len(files) > 50, len(files)
    for module in (('device', 'staging.py'), ('ops', 'build.py'), ('sanitizer.py',),
                   ('workers', 'thread_pool.py'), ('telemetry', 'obs_server.py')):
        assert os.path.join(PORT, *module) in files


def test_every_rule_has_a_description():
    assert set(ALL_RULES) == set(RULE_DESCRIPTIONS)
    assert len(ALL_RULES) == 9


# -- parity with the reference analyzer ---------------------------------------


def test_fixture_list_is_whole():
    assert len(_fixtures()) == 10, _fixtures()


@pytest.mark.parametrize('name', _fixtures())
def test_fixture_findings_match_the_reference(name):
    path = os.path.join(FIXTURES, name)
    want = jax_analyze_paths([path], root=REPO, check_docs=False)
    got = analyze_paths([path], root=REPO, check_docs=False)
    assert _keys(got) == _keys(want), (got, want)
    if name != 'suppressed.py':
        assert got, 'the fixture proves nothing: no finding'


@pytest.mark.parametrize('rule', REGISTRY_FREE_RULES)
def test_reference_tree_is_clean_under_both_analyzers(rule):
    assert jax_analyze_paths([REFERENCE], root=REPO, select=[rule]) == []
    assert analyze_paths([REFERENCE], root=REPO, select=[rule]) == []


# -- rule self-tests (twins of tests/test_analysis.py) -------------------------


def test_env_knob_rule_fires():
    findings = _fixture_findings('bad_env_knob.py', 'env-knob')
    assert [f.line for f in findings] == [8, 11, 14, 17, 20], findings
    assert 'unregistered knob' in findings[-1].message
    assert 'petastorm_tpu_torch.telemetry.knobs' in findings[0].message


def test_buffer_rules_fire():
    escapes = _fixture_findings('bad_buffer_escape.py', 'buffer-escape')
    assert [f.line for f in escapes] == [11, 15, 20, 25, 36, 41], escapes
    assert 'give_back()' in escapes[-1].message
    writes = _fixture_findings('bad_buffer_escape.py', 'buffer-write')
    assert [f.line for f in writes] == [30, 31, 32], writes


def test_owns_annotation_silences_buffer_findings():
    assert analyze_source(
        "import numpy as np\n"
        "def f(buf):\n"
        "    view = np.frombuffer(buf, dtype=np.uint8)\n"
        "    return view  # pipesan: owns\n") == []


def test_fresh_temporary_views_are_owned_by_construction():
    assert analyze_source(
        "import numpy as np\n"
        "def f(payload):\n"
        "    return np.frombuffer(bytes(payload), dtype=np.uint8)\n") == []


def test_comprehensions_respect_laundering_and_unpack_is_elementwise():
    assert analyze_source(
        "import numpy as np\n"
        "def f(frames):\n"
        "    views = [np.frombuffer(b) for b in frames]\n"
        "    return [v.copy() for v in views]\n"
        "def g(frames):\n"
        "    views = [np.frombuffer(b) for b in frames]\n"
        "    return [len(v) for v in views]\n"
        "def h(buf):\n"
        "    view = np.frombuffer(buf, dtype=np.uint8)\n"
        "    size, owned = view.nbytes, view.copy()\n"
        "    return owned\n"
        "def k(buf):\n"
        "    view = np.frombuffer(buf, dtype=np.uint8)\n"
        "    return view.shape[0] * view.itemsize\n") == []
    tainted = analyze_source(
        "import numpy as np\n"
        "def f(frames):\n"
        "    return [np.frombuffer(b) for b in frames]\n")
    assert [f.rule for f in tainted] == ['buffer-escape']


def test_recv_frames_list_mutation_is_not_a_buffer_write():
    assert analyze_source(
        "def f(sock, header):\n"
        "    frames = sock.recv_multipart(copy=False)\n"
        "    frames[0] = header\n"
        "    frames += [b'trailer']\n"
        "    return len(frames)\n") == []


def test_owning_methods_launder_taint():
    assert analyze_source(
        "import numpy as np\n"
        "def f(buf):\n"
        "    view = np.frombuffer(buf, dtype=np.uint8)\n"
        "    return view.copy()\n"
        "def g(buf):\n"
        "    view = np.frombuffer(buf, dtype=np.uint8)\n"
        "    return view.sum()\n") == []


@pytest.mark.parametrize('attr', sorted(PORT_ONLY_BORROW_ATTRS))
def test_pinned_slot_memory_is_a_borrow_source(attr):
    """The port's slot attributes are borrowed: a view of them stored on an
    object escapes, a write through one is flagged, a copy is clean."""
    findings = analyze_source(
        "class Engine:\n"
        "    def keep(self, slot):\n"
        "        self.kept = %s['x'][:4]\n"
        "    def scribble(self, slot):\n"
        "        view = %s['x']\n"
        "        view[0] = 1\n"
        "    def owned(self, slot):\n"
        "        self.copied = %s['x'].copy()\n" % (attr, attr, attr))
    assert [(f.line, f.rule) for f in findings] == [(3, 'buffer-escape'), (6, 'buffer-write')]


def test_whole_program_lock_order_rule_fires():
    findings = _fixture_findings('bad_lock_order_global', 'lock-order')
    assert len(findings) == 1, findings
    assert 'whole-program' in findings[0].message
    assert '_A_LOCK' in findings[0].message and '_FLUSH_LOCK' in findings[0].message


def test_whole_program_lock_order_resolves_imported_locks(tmp_path):
    (tmp_path / 'liba.py').write_text(
        "import threading\n"
        "from libb import FLUSH_LOCK\n"
        "A_LOCK = threading.Lock()\n"
        "def one():\n"
        "    with A_LOCK:\n"
        "        with FLUSH_LOCK:\n"
        "            pass\n")
    (tmp_path / 'libb.py').write_text(
        "import threading\n"
        "from liba import A_LOCK\n"
        "FLUSH_LOCK = threading.Lock()\n"
        "def two():\n"
        "    with FLUSH_LOCK:\n"
        "        with A_LOCK:\n"
        "            pass\n")
    locks = [f for f in analyze_paths([str(tmp_path)], check_docs=False)
             if f.rule == 'lock-order']
    assert len(locks) == 1, locks
    assert 'A_LOCK' in locks[0].message and 'FLUSH_LOCK' in locks[0].message


def _write_port_modules(root, package):
    """Two modules of ``package`` whose locks nest in opposite orders,
    each taking the other's lock through a package-qualified import."""
    pkg = root / package / 'engine'
    pkg.mkdir(parents=True)
    (root / package / '__init__.py').write_text('')
    (pkg / '__init__.py').write_text('')
    (pkg / 'staging.py').write_text(
        "import threading\n"
        "from %s.engine.ring import RING_LOCK, drain\n"
        "STAGE_LOCK = threading.Lock()\n"
        "def fill():\n"
        "    with STAGE_LOCK:\n"
        "        drain()\n" % package)
    (pkg / 'ring.py').write_text(
        "import threading\n"
        "from %s.engine import staging\n"
        "RING_LOCK = threading.Lock()\n"
        "def drain():\n"
        "    with RING_LOCK:\n"
        "        pass\n"
        "def recycle():\n"
        "    with RING_LOCK:\n"
        "        with staging.STAGE_LOCK:\n"
        "            pass\n" % package)
    return str(root / package)


def test_whole_program_lock_order_resolves_port_imports(tmp_path):
    """Across two port modules: a package-qualified import of a lock and a
    function resolves, so the inversion is found — and the same code under
    a package that only shares the port's prefix stays unresolved."""
    port = _write_port_modules(tmp_path, 'petastorm_tpu_torch')
    locks = [f for f in analyze_paths([port], root=str(tmp_path), check_docs=False)
             if f.rule == 'lock-order']
    assert len(locks) == 1, locks
    assert 'petastorm_tpu_torch.engine.ring.RING_LOCK' in locks[0].message
    assert 'petastorm_tpu_torch.engine.staging.STAGE_LOCK' in locks[0].message
    other = _write_port_modules(tmp_path, 'petastorm_tpu_torchx')
    assert [f for f in analyze_paths([other], root=str(tmp_path), check_docs=False)
            if f.rule == 'lock-order'] == []


@pytest.mark.parametrize('path,name', [
    ('petastorm_tpu_torch/device/staging.py', 'petastorm_tpu_torch.device.staging'),
    ('/x/petastorm_tpu_torch/analysis/__init__.py', 'petastorm_tpu_torch.analysis'),
    ('petastorm_tpu/jax/staging.py', 'staging'),
    ('petastorm_tpu_torchx/ops/build.py', 'build'),
    ('tests/data/analysis/bad_lock_order.py', 'bad_lock_order'),
])
def test_module_names_root_at_whole_path_parts(path, name):
    assert module_name(path) == name


def test_reference_imports_stay_external():
    """``petastorm_tpu.x`` is not ``petastorm_tpu_torch.x``: a dotted import
    of the reference never resolves to a port module."""
    graph = CallGraph([SourceModule('petastorm_tpu_torch/device/staging.py', source='x = 1\n')])
    assert graph._project_module('petastorm_tpu_torch.device.staging') \
        == 'petastorm_tpu_torch.device.staging'
    assert graph._project_module('petastorm_tpu.device.staging') is None
    assert graph._project_module('petastorm_tpu_torch.device') is None


def test_whole_program_pass_defers_same_module_inversions():
    findings = analyze_source(
        "import threading\n"
        "a_lock = threading.Lock()\n"
        "b_lock = threading.Lock()\n"
        "def helper():\n"
        "    with b_lock:\n"
        "        pass\n"
        "def f1():\n"
        "    with a_lock:\n"
        "        helper()\n"
        "def f2():\n"
        "    with a_lock:\n"
        "        with b_lock:\n"
        "            pass\n"
        "def f3():\n"
        "    with b_lock:\n"
        "        with a_lock:\n"
        "            pass\n", select=['lock-order'])
    assert len(findings) == 1, findings


def test_suppression_is_rule_specific():
    findings = analyze_source(
        "import queue\nimport threading\n_lock = threading.Lock()\n"
        "q = queue.Queue()\n"
        "def f():\n"
        "    with _lock:\n"
        "        q.get()  # pipecheck: disable=lock-order\n")
    assert [f.rule for f in findings] == ['blocking-under-lock']


def test_subprocess_under_a_file_lock_is_flagged_unless_waived():
    """The pattern of ``ops/build.py``: a compiler started under the
    build's ``flock`` is a blocking call under a lock; the waiver on that
    line (with its reason) is what keeps the port's tree clean."""
    source = ("import subprocess\n"
              "def build(path):\n"
              "    with open(path, 'w') as lock:\n"
              "        proc = subprocess.Popen(['cc'])%s\n"
              "        proc.communicate(timeout=1)\n")
    flagged = analyze_source(source % '')
    assert [(f.line, f.rule) for f in flagged] == [(4, 'blocking-under-lock')]
    assert analyze_source(source % '  # pipecheck: disable=blocking-under-lock') == []


def test_analyze_source_on_clean_snippet():
    assert analyze_source('x = 1\n') == []


def test_select_narrows_rules():
    source = ("import os\nimport threading\n"
              "_RAW = os.environ.get('PETASTORM_TPU_STAGING')\n"
              "t = threading.Thread(target=print)\nt.start()\n")
    assert [f.rule for f in analyze_source(source, select=['env-knob'])] == ['env-knob']
    assert {f.rule for f in analyze_source(source)} == {'env-knob', 'thread-lifecycle'}


def test_findings_are_structured():
    findings = _fixture_findings('bad_lock_order.py')
    record = findings[0].as_dict()
    assert set(record) == {'path', 'line', 'rule', 'message'}
    assert str(findings[0]).startswith(record['path'])


def test_missing_path_raises_not_clean():
    with pytest.raises(FileNotFoundError):
        analyze_paths(['no_such_dir_xyz'])


def test_empty_scan_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match='no Python files'):
        analyze_paths([str(tmp_path)])


# -- the knob table -----------------------------------------------------------


def _doc_rows(path):
    rows = {}
    with open(path) as f:
        for line in f:
            match = re.match(r'^\| `(PETASTORM_TPU_[A-Z0-9_]+)`', line)
            if match:
                rows[match.group(1)] = line.rstrip('\n')
    return rows


def test_port_knob_table_rows_are_the_repos():
    port, repo = _doc_rows(PORT_DOCS), _doc_rows(REPO_DOCS)
    assert set(port) == set(names.KNOWN_KNOBS)
    for knob, row in port.items():
        assert row == repo[knob], knob


def test_port_knob_table_covers_the_registry():
    assert check_docs_coverage(PORT_DOCS) == []
    # the standing service's knobs were the last of the repo's table the port
    # lacked: it now registers them all, so the repo's table passes too
    assert check_docs_coverage(REPO_DOCS) == []


def test_analyzing_the_package_finds_the_ports_table():
    from petastorm_tpu_torch.analysis.core import _find_docs
    assert _find_docs(os.path.join(PORT, '__init__.py')) == PORT_DOCS
    assert _find_docs(os.path.join(PORT, 'device', 'staging.py')) == PORT_DOCS


# -- CLI ----------------------------------------------------------------------


def _run_cli(args):
    return subprocess.run([sys.executable, '-m', 'petastorm_tpu_torch.analysis'] + args,
                          cwd=REPO, capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize('args,expected_rc', [
    ([], 0),
    (['petastorm_tpu_torch'], 0),
    (['tests/data/analysis/bad_lock_order.py', '--no-docs-check'], 1),
    (['--list-rules'], 0),
    (['petastorm_tpu_torch', '--select', 'no-such-rule'], 2),
    (['no_such_dir_xyz'], 2),
])
def test_cli_exit_codes(args, expected_rc):
    proc = _run_cli(args)
    assert proc.returncode == expected_rc, (proc.stdout, proc.stderr)


def test_cli_baseline_filters_known_findings(tmp_path):
    fixture = 'tests/data/analysis/bad_buffer_escape.py'
    dump = _run_cli([fixture, '--json', '--no-docs-check'])
    assert dump.returncode == 1
    baseline = tmp_path / 'baseline.jsonl'
    baseline.write_text(dump.stdout)
    clean = _run_cli([fixture, '--baseline', str(baseline), '--fail-on-new',
                      '--no-docs-check'])
    assert clean.returncode == 0, (clean.stdout, clean.stderr)
    assert 'suppressed' in clean.stderr


def test_cli_baseline_still_fails_on_new_findings(tmp_path):
    dump = _run_cli(['tests/data/analysis/bad_lock_order.py', '--json', '--no-docs-check'])
    baseline = tmp_path / 'baseline.jsonl'
    baseline.write_text(dump.stdout)
    mixed = _run_cli(['tests/data/analysis/bad_lock_order.py',
                      'tests/data/analysis/bad_buffer_escape.py',
                      '--baseline', str(baseline), '--no-docs-check'])
    assert mixed.returncode == 1
    assert 'bad_lock_order.py' not in mixed.stdout
    assert 'bad_buffer_escape.py' in mixed.stdout


def test_cli_fail_on_new_requires_a_baseline():
    proc = _run_cli(['petastorm_tpu_torch', '--fail-on-new'])
    assert proc.returncode == 2
    assert '--baseline' in proc.stderr


def test_cli_unusable_baseline_is_an_error(tmp_path):
    bogus = tmp_path / 'bogus.jsonl'
    bogus.write_text('not json\n')
    proc = _run_cli(['tests/data/analysis/bad_lock_order.py', '--baseline', str(bogus),
                     '--no-docs-check'])
    assert proc.returncode == 2
    assert 'unusable baseline' in proc.stderr


def test_cli_json_output():
    proc = _run_cli(['tests/data/analysis/bad_lock_order.py', '--json', '--no-docs-check'])
    assert proc.returncode == 1
    records = [json.loads(line) for line in proc.stdout.splitlines()]
    assert records and records[0]['rule'] == 'lock-order'


# -- imports ------------------------------------------------------------------


def test_contracts_import_is_light():
    """The port's telemetry (the knob registry, the names) loads none of
    the analyzer, and importing the analyzer package loads only its
    contracts until a pass is asked for."""
    proc = subprocess.run(
        [sys.executable, '-c',
         'import sys; import petastorm_tpu_torch.telemetry.knobs; '
         'import petastorm_tpu_torch.analysis; '
         'bad = [m for m in sys.modules if "analysis.core" in m or '
         '"analysis.pass_" in m or "analysis.findings" in m]; '
         'assert not bad, bad; print("light")'],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert 'light' in proc.stdout


def test_analyzer_runs_without_torch():
    proc = subprocess.run(
        [sys.executable, '-c',
         'import sys; from petastorm_tpu_torch.analysis.__main__ import main; '
         'rc = main(["petastorm_tpu_torch"]); '
         'bad = [m for m in sys.modules if m.split(".")[0] in '
         '("torch", "jax", "petastorm_tpu")]; '
         'assert rc == 0 and not bad, (rc, bad); print("no torch")'],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert 'no torch' in proc.stdout


# -- one registry, equal to the reference's but for the named additions -------


def test_contracts_are_the_registry_objects():
    for name in ('STAGES', 'EVENT_NAMES', 'METRIC_NAMES', 'KNOWN_KNOBS', 'FAULTPOINTS',
                 'BORROW_CALLS', 'BORROW_CALL_KWARGS', 'BORROW_ATTRS', 'OWNS_ANNOTATION_RE',
                 'KNOB_PREFIX'):
        assert getattr(contracts, name) is getattr(names, name), name
    from petastorm_tpu_torch.telemetry import knobs
    assert knobs.KNOWN_KNOBS is contracts.KNOWN_KNOBS


def test_contract_sets_equal_the_references():
    assert names.METRIC_NAMES - jax_contracts.METRIC_NAMES == PORT_ONLY_METRICS
    assert jax_contracts.METRIC_NAMES <= names.METRIC_NAMES
    assert names.BORROW_ATTRS - jax_contracts.BORROW_ATTRS == PORT_ONLY_BORROW_ATTRS
    assert jax_contracts.BORROW_ATTRS <= names.BORROW_ATTRS
    assert names.FAULTPOINTS == jax_contracts.FAULTPOINTS
    assert names.BORROW_CALLS == jax_contracts.BORROW_CALLS
    assert names.BORROW_CALL_KWARGS == jax_contracts.BORROW_CALL_KWARGS
    assert names.OWNS_ANNOTATION_RE == jax_contracts.OWNS_ANNOTATION_RE
    assert names.KNOB_PREFIX == jax_contracts.KNOB_PREFIX
    # the port registers what it records, all of it the reference's
    assert set(names.STAGES) <= set(jax_contracts.STAGES)
    assert names.EVENT_NAMES <= jax_contracts.EVENT_NAMES
    assert names.KNOWN_KNOBS <= jax_contracts.KNOWN_KNOBS
    assert 'PETASTORM_TPU_SANITIZE' in names.KNOWN_KNOBS


def test_the_native_counters_are_the_modules_names():
    from petastorm_tpu_torch import native
    assert {native.BUILD_FAILURES, native.DECODED_CELLS} == PORT_ONLY_METRICS
