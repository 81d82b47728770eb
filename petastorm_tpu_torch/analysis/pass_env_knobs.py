"""``env-knob`` pass: every ``PETASTORM_TPU_*`` read goes through the
central knob registry (:mod:`petastorm_tpu_torch.telemetry.knobs`) and names a
registered, documented knob.

Three checks:

* a raw ``os.environ`` read (``get``/``getenv``/``[...]``/``in``/
  ``setdefault``/``pop``) of the knob namespace anywhere outside the
  registry module is a finding — call-site parsing drifts into
  half-compatible truthiness parses without one shared spelling tuple;
  this pass makes the registry structurally load-bearing;
* any knob literal handed to the registry API must be a member of
  :data:`~petastorm_tpu_torch.analysis.contracts.KNOWN_KNOBS`;
* every registered knob must carry a row in docs/env_knobs.md (the
  port's is ``petastorm_tpu_torch/docs/env_knobs.md``;
  :func:`check_docs_coverage`, run once per analysis, not per file).

Writes (``os.environ['PETASTORM_TPU_X'] = v``) are reads' responsibility
to notice via ``telemetry.refresh()``; they are still steered through
``knobs.set_env`` so the name is validated, but a bare env-var *store*
outside the registry is only flagged when it uses ``setdefault`` (which
also reads).
"""

import ast
import os
import re

from petastorm_tpu_torch.analysis.contracts import KNOB_PREFIX, KNOWN_KNOBS
from petastorm_tpu_torch.analysis.findings import Finding, literal_str

RULE = 'env-knob'
RULES = (RULE,)

#: the one module allowed to touch ``os.environ`` for the knob namespace
REGISTRY_SUFFIX = os.path.join('telemetry', 'knobs.py')

_KNOB_API = frozenset(['raw', 'get_str', 'get_int', 'get_float',
                       'is_disabled', 'is_enabled', 'set_env'])

_DOC_NAME_RE = re.compile(r'PETASTORM_TPU_[A-Z0-9_]+')


def _is_environ(expr):
    """True for ``os.environ`` (or a bare ``environ`` from-import)."""
    if isinstance(expr, ast.Attribute) and expr.attr == 'environ' \
            and isinstance(expr.value, ast.Name) and expr.value.id == 'os':
        return True
    return isinstance(expr, ast.Name) and expr.id == 'environ'


def _is_knob(name):
    return name is not None and name.startswith(KNOB_PREFIX)


def _is_registry(module):
    return module.path.replace('\\', os.sep).endswith(REGISTRY_SUFFIX)


def run(module):
    findings = []
    in_registry = _is_registry(module)

    def flag(node, message):
        finding = module.finding(RULE, node, message)
        if finding is not None:
            findings.append(finding)

    for node in ast.walk(module.tree):
        if isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Attribute):
                # os.environ.get / .setdefault / .pop
                if func.attr in ('get', 'setdefault', 'pop') \
                        and _is_environ(func.value) and node.args:
                    key = literal_str(node.args[0])
                    if _is_knob(key) and not in_registry:
                        flag(node, 'raw os.environ read of %s: go through '
                                   'petastorm_tpu_torch.telemetry.knobs (the one '
                                   'owner of knob parsing)' % key)
                # os.getenv('PETASTORM_TPU_X')
                elif func.attr == 'getenv' \
                        and isinstance(func.value, ast.Name) \
                        and func.value.id == 'os' and node.args:
                    key = literal_str(node.args[0])
                    if _is_knob(key) and not in_registry:
                        flag(node, 'raw os.getenv read of %s: go through '
                                   'petastorm_tpu_torch.telemetry.knobs' % key)
                # knobs.get_str('PETASTORM_TPU_X') — registered name?
                if func.attr in _KNOB_API and node.args:
                    key = literal_str(node.args[0])
                    if _is_knob(key) and key not in KNOWN_KNOBS:
                        flag(node, 'unregistered knob %s: add it to '
                                   'telemetry/names.py KNOWN_KNOBS and '
                                   'docs/env_knobs.md' % key)
            elif isinstance(func, ast.Name) and func.id in _KNOB_API \
                    and node.args:
                key = literal_str(node.args[0])
                if _is_knob(key) and key not in KNOWN_KNOBS:
                    flag(node, 'unregistered knob %s: add it to '
                               'telemetry/names.py KNOWN_KNOBS and '
                               'docs/env_knobs.md' % key)
        elif isinstance(node, ast.Subscript) \
                and isinstance(node.ctx, ast.Load) \
                and _is_environ(node.value):
            key = literal_str(node.slice)
            if _is_knob(key) and not in_registry:
                flag(node, 'raw os.environ[%r] read: go through '
                           'petastorm_tpu_torch.telemetry.knobs' % key)
        elif isinstance(node, ast.Compare) and node.comparators \
                and any(_is_environ(c) for c in node.comparators):
            key = literal_str(node.left)
            if _is_knob(key) and not in_registry:
                flag(node, '%r in os.environ membership read: go through '
                           'petastorm_tpu_torch.telemetry.knobs' % key)
    return findings


def check_docs_coverage(docs_path, relpath=None):
    """Project-level half of the rule: every registered knob has a row in
    docs/env_knobs.md, and the docs name no unregistered knobs (stale
    rows read as operational surface that does not exist)."""
    findings = []
    try:
        with open(docs_path) as f:
            documented = set(_DOC_NAME_RE.findall(f.read()))
    except OSError:
        return [Finding(relpath or docs_path, 1, RULE,
                        'docs/env_knobs.md missing or unreadable: every '
                        'registered knob needs a documented row')]
    where = relpath or docs_path
    for name in sorted(KNOWN_KNOBS - documented):
        findings.append(Finding(where, 1, RULE,
                                'registered knob %s has no row in '
                                'docs/env_knobs.md' % name))
    for name in sorted(documented - KNOWN_KNOBS):
        findings.append(Finding(where, 1, RULE,
                                'docs/env_knobs.md documents %s but it is '
                                'not in KNOWN_KNOBS (stale row or missing '
                                'registration)' % name))
    return findings
