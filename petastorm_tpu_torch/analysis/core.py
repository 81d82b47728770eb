"""pipecheck runner: load sources, run every pass, collect findings.

Library API (``tests/test_analysis.py`` and the CLI both sit on it):

* :func:`analyze_paths` — files/directories → sorted Finding list.
* :func:`analyze_source` — one in-memory snippet (fixture tests).
* :data:`ALL_RULES` / :data:`PASSES` — the registry.

The project-level half of the ``env-knob`` rule (docs coverage) runs
once per :func:`analyze_paths` call when a ``docs/env_knobs.md`` is
discoverable above the first analyzed path.
"""

import os

from petastorm_tpu_torch.analysis import (
    callgraph, pass_buffers, pass_env_knobs, pass_locks, pass_names,
    pass_payloads, pass_threads,
)
from petastorm_tpu_torch.analysis.findings import SourceModule

#: the composable passes, in report order. A pass exposes ``run(module)``
#: (per-module), ``run_project(modules)`` (whole-program, over every
#: parsed module at once — the pipesan buffer-ownership pass and the
#: whole-program half of lock-order), or both.
PASSES = (pass_env_knobs, pass_names, pass_locks, pass_threads,
          pass_payloads, pass_buffers)

#: every rule id a pass can emit (suppression tokens)
ALL_RULES = tuple(rule for p in PASSES for rule in p.RULES)

#: rule id -> one-line description (the CLI's --list-rules table)
RULE_DESCRIPTIONS = {
    'env-knob':
        'PETASTORM_TPU_* reads go through telemetry.knobs; knobs are '
        'registered in telemetry/names.py KNOWN_KNOBS and documented in '
        'docs/env_knobs.md',
    'canonical-name':
        'span()/trace-event/metric name literals are members of the '
        'canonical sets in telemetry/names.py',
    'faultpoint':
        'every fault_hit() call site names a fault-injection site '
        'registered in telemetry/names.py FAULTPOINTS',
    'blocking-under-lock':
        'no indefinitely-blocking call (queue get/put sans timeout, ZMQ '
        'sans NOBLOCK, join()/wait() sans timeout, block_until_ready, '
        'subprocess, sleep) while lexically holding a lock',
    'lock-order':
        'two locks never nest in opposite orders within one module',
    'thread-lifecycle':
        'every threading.Thread is daemon=True or join()ed from a '
        'teardown path',
    'pickle-payload':
        'no lambdas / locally-defined functions or classes handed to '
        'process-boundary calls (ventilate, dill/pickle dumps, '
        'exec_in_new_process, send_pyobj)',
    'buffer-escape':
        'a borrowed zero-copy view (np.frombuffer, recv_multipart('
        'copy=False) frames, read_entry columns, staging slot views, '
        'astype(copy=False)) must not escape its owning scope — object/'
        'module state, queues, closures, returns — without a '
        "'# pipesan: owns' transfer annotation",
    'buffer-write':
        'no in-place write through a borrowed zero-copy view '
        '(view[...] =, +=, np.copyto(dst=view)): it corrupts the shared '
        'backing memory (mmap, wire buffer, arena slot)',
}


def iter_python_files(paths):
    """Every ``.py`` file under the given files/directories, sorted,
    deduplicated; ``__pycache__`` skipped."""
    seen = set()
    for path in paths:
        if os.path.isdir(path):
            for dirpath, dirnames, filenames in os.walk(path):
                dirnames[:] = [d for d in sorted(dirnames)
                               if d != '__pycache__']
                for filename in sorted(filenames):
                    if filename.endswith('.py'):
                        full = os.path.join(dirpath, filename)
                        if full not in seen:
                            seen.add(full)
                            yield full
        elif path.endswith('.py'):
            if path not in seen:
                seen.add(path)
                yield path


def _find_docs(start):
    """Walk up from ``start`` towards the filesystem root looking for
    ``docs/env_knobs.md`` (the port's table sits in the package directory,
    so a scan of ``petastorm_tpu_torch`` finds it first); None when not found
    (analyzing an installed copy: the per-file rules still run)."""
    current = os.path.abspath(start if os.path.isdir(start)
                              else os.path.dirname(start))
    for _ in range(10):
        candidate = os.path.join(current, 'docs', 'env_knobs.md')
        if os.path.isfile(candidate):
            return candidate
        parent = os.path.dirname(current)
        if parent == current:
            break
        current = parent
    return None


def run_passes(module, select=None):
    """All (selected) per-module passes over one :class:`SourceModule`."""
    findings = []
    for p in PASSES:
        if select is not None and not (set(p.RULES) & select):
            continue
        run = getattr(p, 'run', None)
        if run is None:
            continue  # project-level-only pass (pass_buffers)
        found = run(module)
        if select is not None:
            found = [f for f in found if f.rule in select]
        findings.extend(found)
    return findings


def run_project_passes(modules, select=None):
    """Whole-program passes over every parsed module at once. The passes
    share one memoized call graph; it is dropped when the run ends so a
    long-lived process does not pin the parse state."""
    findings = []
    try:
        for p in PASSES:
            project_rules = getattr(p, 'PROJECT_RULES', p.RULES)
            if select is not None and not (set(project_rules) & select):
                continue
            run_project = getattr(p, 'run_project', None)
            if run_project is None:
                continue
            found = run_project(modules)
            if select is not None:
                found = [f for f in found if f.rule in select]
            findings.extend(found)
    finally:
        callgraph.clear_graph_cache()
    return findings


def analyze_source(source, path='<string>', select=None):
    """Analyze one in-memory snippet (fixture tests drive rules here).
    Whole-program passes run over the single module."""
    select = set(select) if select else None
    module = SourceModule(path, source=source)
    findings = run_passes(module, select) \
        + run_project_passes([module], select)
    return sorted(findings, key=lambda f: f.sort_key())


def analyze_paths(paths, select=None, root=None, check_docs=True):
    """Analyze files/directories; returns sorted findings.

    ``root`` anchors the relative paths in findings (default: cwd).
    ``check_docs`` adds the project-level knob-docs coverage check when a
    ``docs/env_knobs.md`` is discoverable.
    """
    select = set(select) if select else None
    root = root or os.getcwd()
    # A gate that silently scans nothing is worse than no gate: a wrong
    # cwd or a renamed package must fail loudly, not exit 0.
    for path in paths:
        if not os.path.exists(path):
            raise FileNotFoundError('analysis path does not exist: %r'
                                    % (path,))
    findings = []
    modules = []
    any_path = None
    for path in iter_python_files(paths):
        any_path = any_path or path
        try:
            rel = os.path.relpath(path, root)
        except ValueError:  # different drive (windows)
            rel = path
        module = SourceModule(path, relpath=rel)
        modules.append(module)
        findings.extend(run_passes(module, select))
    if any_path is None:
        raise FileNotFoundError('no Python files found under: %s'
                                % ', '.join(map(repr, paths)))
    findings.extend(run_project_passes(modules, select))
    if check_docs and any_path is not None \
            and (select is None or 'env-knob' in select):
        docs = _find_docs(any_path)
        if docs is not None:
            try:
                rel = os.path.relpath(docs, root)
            except ValueError:
                rel = docs
            findings.extend(pass_env_knobs.check_docs_coverage(docs, rel))
    return sorted(findings, key=lambda f: f.sort_key())
