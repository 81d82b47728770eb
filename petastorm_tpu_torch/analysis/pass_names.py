"""``canonical-name`` / ``faultpoint`` passes: recorded stage/event/
metric names — and fault-injection site names — are members of the
canonical sets in :mod:`petastorm_tpu_torch.analysis.contracts`.

A typo'd stage would silently fall out of ``pipeline_report``'s grouping;
a typo'd metric name would export an invisible series no dashboard knows;
an off-contract trace-event name would land on no known timeline track;
an unregistered ``fault_hit()`` site would be a chaos clause no spec can
ever arm (and no docs table describes). The pass resolves first
arguments that are string literals or module-level string constants
(``registry.counter(SERVICE_REVENTILATED)`` resolves through the
constant); dynamic names are runtime's problem and are skipped.
"""

import ast

from petastorm_tpu_torch.analysis.contracts import (
    EVENT_NAMES, FAULTPOINTS, METRIC_NAMES, STAGES,
)
from petastorm_tpu_torch.analysis.findings import (
    call_name, module_constants, resolve_str,
)

RULE = 'canonical-name'
RULE_FAULTPOINT = 'faultpoint'
RULES = (RULE, RULE_FAULTPOINT)

#: calls recording a stage span or trace event; first arg ∈ STAGES ∪
#: EVENT_NAMES (spans share names with the trace timeline's tracks)
_RECORDING_CALLS = frozenset(['span', 'record_complete', 'record_instant'])

#: registry metric constructors/readers; first arg ∈ METRIC_NAMES
_METRIC_CALLS = frozenset(['counter', 'gauge', 'histogram',
                           'counter_value', 'gauge_value'])

_STAGE_OR_EVENT = frozenset(STAGES) | EVENT_NAMES


def run(module):
    findings = []
    consts = module_constants(module.tree)
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        name = call_name(node)
        if name in _RECORDING_CALLS:
            value = resolve_str(node.args[0], consts)
            if value is not None and value not in _STAGE_OR_EVENT:
                finding = module.finding(
                    RULE, node,
                    '%s(%r): not a canonical stage/event name (contracts.'
                    'STAGES / contracts.EVENT_NAMES)' % (name, value))
                if finding is not None:
                    findings.append(finding)
        elif name in _METRIC_CALLS and isinstance(node.func, ast.Attribute):
            value = resolve_str(node.args[0], consts)
            if value is not None and value not in METRIC_NAMES:
                finding = module.finding(
                    RULE, node,
                    '%s(%r): not a canonical metric name (contracts.'
                    'METRIC_NAMES; register new series in '
                    'telemetry/names.py)' % (name, value))
                if finding is not None:
                    findings.append(finding)
        elif name == 'fault_hit':
            value = resolve_str(node.args[0], consts)
            if value is not None and value not in FAULTPOINTS:
                finding = module.finding(
                    RULE_FAULTPOINT, node,
                    'fault_hit(%r): not a registered faultpoint '
                    '(contracts.FAULTPOINTS; register new sites in '
                    'telemetry/names.py)' % (value,))
                if finding is not None:
                    findings.append(finding)
    return findings
