"""CLI: ``python -m petastorm_tpu_torch.analysis [paths...]`` (default
path: ``petastorm_tpu_torch``).

Exit status 0 when no findings, 1 when findings, 2 on usage errors —
the CI gate shape. ``--json`` emits one finding per
line for tooling; ``--select`` narrows to specific rules;
``--list-rules`` prints the rule reference.

``--baseline FILE`` (a ``--json`` dump of an earlier run) filters
findings already present in the baseline — matched by ``(path, rule,
message)``, deliberately ignoring line numbers so unrelated edits don't
resurrect accepted debt — letting a new rule land **strict on new code**
before its backlog hits zero. ``--fail-on-new`` names the resulting
contract explicitly (it is the default exit-code behavior once a
baseline filters: only NEW findings fail the gate).
"""

import argparse
import json
import sys

from petastorm_tpu_torch.analysis.core import (
    ALL_RULES, RULE_DESCRIPTIONS, analyze_paths,
)


def build_parser():
    parser = argparse.ArgumentParser(
        prog='python -m petastorm_tpu_torch.analysis',
        description='pipecheck: AST-level contract & concurrency analyzer')
    parser.add_argument('paths', nargs='*', default=['petastorm_tpu_torch'],
                        help='files or directories to analyze '
                             '(default: petastorm_tpu_torch)')
    parser.add_argument('--select', default=None, metavar='RULE[,RULE...]',
                        help='run only these rules (see --list-rules)')
    parser.add_argument('--json', action='store_true',
                        help='one JSON finding per line instead of text')
    parser.add_argument('--baseline', default=None, metavar='FILE',
                        help='known-findings file (a --json dump of an '
                             'earlier run); matching findings are '
                             'filtered so only new ones fail the gate')
    parser.add_argument('--fail-on-new', action='store_true',
                        help='with --baseline: fail only on findings not '
                             'in the baseline (this is already the '
                             'behavior once --baseline is given; the '
                             'flag documents intent in CI command lines)')
    parser.add_argument('--no-docs-check', action='store_true',
                        help='skip the project-level knob-docs coverage '
                             'check')
    parser.add_argument('--list-rules', action='store_true',
                        help='print the rule reference and exit')
    return parser


def _baseline_keys(path):
    """Multiset of ``(path, rule, message)`` keys from a baseline file
    (one JSON finding per line, as ``--json`` emits; blank lines ok)."""
    keys = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            record = json.loads(line)
            key = (record['path'], record['rule'], record['message'])
            keys[key] = keys.get(key, 0) + 1
    return keys


def apply_baseline(findings, keys):
    """Findings minus the baseline multiset; returns (new, matched)."""
    remaining = dict(keys)
    new = []
    matched = 0
    for finding in findings:
        key = (finding.path, finding.rule, finding.message)
        if remaining.get(key):
            remaining[key] -= 1
            matched += 1
        else:
            new.append(finding)
    return new, matched


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for rule in ALL_RULES:
            print('%-20s %s' % (rule, RULE_DESCRIPTIONS.get(rule, '')))
        return 0
    select = None
    if args.select:
        select = {r.strip() for r in args.select.split(',') if r.strip()}
        unknown = select - set(ALL_RULES)
        if unknown:
            print('unknown rule(s): %s (try --list-rules)'
                  % ', '.join(sorted(unknown)), file=sys.stderr)
            return 2
    if args.fail_on_new and not args.baseline:
        print('--fail-on-new requires --baseline FILE', file=sys.stderr)
        return 2
    try:
        findings = analyze_paths(args.paths, select=select,
                                 check_docs=not args.no_docs_check)
    except FileNotFoundError as e:
        # a gate that scanned nothing must not read as a clean pass
        print('error: %s' % e, file=sys.stderr)
        return 2
    if args.baseline:
        try:
            keys = _baseline_keys(args.baseline)
        except (OSError, ValueError, KeyError, TypeError) as e:
            # an unreadable baseline must not silently waive every finding
            print('error: unusable baseline %s: %s' % (args.baseline, e),
                  file=sys.stderr)
            return 2
        findings, matched = apply_baseline(findings, keys)
        if matched:
            print('%d baseline finding(s) suppressed' % matched,
                  file=sys.stderr)
    for finding in findings:
        if args.json:
            print(json.dumps(finding.as_dict(), sort_keys=True))
        else:
            print(finding)
    if findings:
        print('%d finding(s)' % len(findings), file=sys.stderr)
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
