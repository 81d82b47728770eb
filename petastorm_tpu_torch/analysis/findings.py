"""Finding records, parsed source modules, and suppression comments.

The pieces every pass shares: a :class:`Finding` is one structured
``(path, line, rule, message)`` result; a :class:`SourceModule` is one
parsed file (source text, AST, and its ``# pipecheck: disable=...``
comment map). Stdlib only.
"""

import ast
import io
import re
import tokenize

from petastorm_tpu_torch.analysis.contracts import OWNS_ANNOTATION_RE

#: suppression comment syntax: ``# pipecheck: disable=rule[,rule...]``
#: on any line the finding's node spans (``all`` silences every rule).
_SUPPRESS_RE = re.compile(r'pipecheck:\s*disable=([A-Za-z0-9_,\- ]+)')

#: ownership-transfer annotation: ``# pipesan: owns`` (telemetry/names.py is
#: the one owner of the token spelling) — silences buffer-ownership findings
#: on the lines it covers while recording an explicit, greppable transfer
_OWNS_RE = re.compile(OWNS_ANNOTATION_RE)


class Finding:
    """One structured analyzer result."""

    __slots__ = ('path', 'line', 'rule', 'message')

    def __init__(self, path, line, rule, message):
        self.path = path
        self.line = line
        self.rule = rule
        self.message = message

    def __str__(self):
        return '%s:%d: [%s] %s' % (self.path, self.line, self.rule,
                                   self.message)

    def __repr__(self):
        return 'Finding(%r, %r, %r, %r)' % (self.path, self.line,
                                            self.rule, self.message)

    def as_dict(self):
        return {'path': self.path, 'line': self.line, 'rule': self.rule,
                'message': self.message}

    def sort_key(self):
        return (self.path, self.line, self.rule, self.message)


def _scan_comments(source):
    """``[(lineno, text)]`` of every comment token — ONE tokenizer pass
    per module, shared by the suppression and owns-annotation scans."""
    out = []
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type == tokenize.COMMENT:
                out.append((tok.start[0], tok.string))
    except tokenize.TokenError:
        pass
    return out


def _suppressions_from(comments):
    """``{line: set(rule_ids)}`` of every ``pipecheck: disable=`` comment
    (comments only — a disable token inside a string literal is inert)."""
    out = {}
    for line, text in comments:
        match = _SUPPRESS_RE.search(text)
        if match is None:
            continue
        rules = {r.strip() for r in match.group(1).split(',') if r.strip()}
        out.setdefault(line, set()).update(rules)
    return out


def _owns_from(comments):
    """Line numbers carrying a ``# pipesan: owns`` ownership-transfer
    annotation."""
    return {line for line, text in comments if _OWNS_RE.search(text)}


def parse_suppressions(source):
    """Suppression map from raw source (one-off callers; SourceModule
    shares a single :func:`_scan_comments` pass for both scans)."""
    return _suppressions_from(_scan_comments(source))


def parse_owns(source):
    """Owns-annotation lines from raw source (one-off callers)."""
    return _owns_from(_scan_comments(source))


class SourceModule:
    """One parsed Python file handed to every pass."""

    def __init__(self, path, source=None, relpath=None):
        if source is None:
            with tokenize.open(path) as f:  # honors coding declarations
                source = f.read()
        self.path = path
        self.relpath = relpath or path
        self.source = source
        self.tree = ast.parse(source, filename=path)
        comments = _scan_comments(source)
        self.suppressions = _suppressions_from(comments)
        self.owns_lines = _owns_from(comments)

    def suppressed(self, rule, node_or_line):
        """True when a ``disable=`` comment for ``rule`` (or ``all``) sits
        on any line the node spans."""
        if isinstance(node_or_line, int):
            lines = (node_or_line,)
        else:
            start = getattr(node_or_line, 'lineno', 0)
            end = getattr(node_or_line, 'end_lineno', start) or start
            lines = range(start, end + 1)
        for line in lines:
            rules = self.suppressions.get(line)
            if rules and (rule in rules or 'all' in rules):
                return True
        return False

    def owned(self, node_or_line):
        """True when a ``# pipesan: owns`` annotation sits on any line the
        node spans — or on the line directly above it (the justified
        annotation-block style) — the buffer-ownership passes treat the
        transfer as explicit and emit no finding."""
        if isinstance(node_or_line, int):
            lines = (node_or_line - 1, node_or_line)
        else:
            start = getattr(node_or_line, 'lineno', 0)
            end = getattr(node_or_line, 'end_lineno', start) or start
            lines = range(start - 1, end + 1)
        return any(line in self.owns_lines for line in lines)

    def finding(self, rule, node_or_line, message):
        """A :class:`Finding` anchored at the node, or None when a
        suppression comment covers it."""
        if self.suppressed(rule, node_or_line):
            return None
        line = (node_or_line if isinstance(node_or_line, int)
                else getattr(node_or_line, 'lineno', 0))
        return Finding(self.relpath, line, rule, message)


def call_name(node):
    """Terminal callable name of a Call node ('get' for ``q.get(...)``,
    'span' for ``span(...)``); None for exotic callees."""
    func = node.func
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def dotted_text(expr):
    """Source-ish dotted name of a Name/Attribute chain ('self._lock');
    None for anything else (calls, subscripts)."""
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        base = dotted_text(expr.value)
        return None if base is None else '%s.%s' % (base, expr.attr)
    return None


def literal_str(node):
    """The str value of a Constant node, else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def module_constants(tree):
    """``{NAME: 'literal'}`` for module-level string-constant assigns —
    how passes resolve ``registry.counter(SERVICE_REVENTILATED)`` back to
    the literal the constant holds."""
    consts = {}
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            value = literal_str(stmt.value)
            if value is not None:
                consts[stmt.targets[0].id] = value
        elif isinstance(stmt, ast.AnnAssign) \
                and isinstance(stmt.target, ast.Name):
            value = literal_str(stmt.value) if stmt.value else None
            if value is not None:
                consts[stmt.target.id] = value
    return consts


def resolve_str(node, consts):
    """Literal string of ``node``: a Constant directly, or a module-level
    constant Name; None when not statically resolvable."""
    value = literal_str(node)
    if value is not None:
        return value
    if isinstance(node, ast.Name):
        return consts.get(node.id)
    return None
