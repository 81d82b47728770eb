"""``pickle-payload`` pass: objects crossing a process boundary must be
picklable by reference.

Work items ventilated into the process/service pools, job specs, and
objects framed for ZMQ all round-trip through dill/pickle. Lambdas,
functions defined inside another function, and locally-defined classes
pickle by value or not at all — dill *sometimes* serializes them, but
the result silently captures the enclosing closure (stale state shipped
to every worker) or fails only on the worker side, where the traceback
points at the pool internals rather than the call site. The contract:
anything handed to a ventilation/serialization boundary is module-level.

Flagged boundary calls: ``ventilate(...)``, ``dill.dumps``/
``pickle.dumps``/``cloudpickle.dumps``, ``dump_job_spec``,
``dump_work_item``, ``exec_in_new_process``, ``send_pyobj``. Flagged
arguments: lambda expressions, and names bound to a ``def``/``class``
nested inside an enclosing function (one level of tuple/list/dict
literal is unpacked; deeper structures are runtime's problem).
"""

import ast

from petastorm_tpu_torch.analysis.findings import call_name

RULE = 'pickle-payload'
RULES = (RULE,)

_BOUNDARY_NAMES = frozenset(['ventilate', 'dump_job_spec', 'dump_work_item',
                             'exec_in_new_process', 'send_pyobj'])
_PICKLER_MODULES = frozenset(['dill', 'pickle', 'cloudpickle'])


def _is_boundary(call):
    name = call_name(call)
    if name in _BOUNDARY_NAMES:
        return True
    if name == 'dumps' and isinstance(call.func, ast.Attribute) \
            and isinstance(call.func.value, ast.Name) \
            and call.func.value.id in _PICKLER_MODULES:
        return True
    return False


def _payload_exprs(call):
    """Argument expressions to inspect, unpacking one literal level."""
    exprs = list(call.args) + [kw.value for kw in call.keywords]
    out = []
    for expr in exprs:
        if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            out.extend(expr.elts)
        elif isinstance(expr, ast.Dict):
            out.extend(v for v in expr.values if v is not None)
        else:
            out.append(expr)
    return out


class _Scope:
    __slots__ = ('node', 'local_defs')

    def __init__(self, node):
        self.node = node
        self.local_defs = {}  # name -> 'function' | 'class'


class _Visitor(ast.NodeVisitor):
    def __init__(self, module):
        self.module = module
        self.findings = []
        self.scopes = []  # open FUNCTION scopes only

    def _flag(self, node, message):
        finding = self.module.finding(RULE, node, message)
        if finding is not None:
            self.findings.append(finding)

    def _register(self, name, kind):
        if self.scopes:
            self.scopes[-1].local_defs[name] = kind

    def _local_kind(self, name):
        for scope in reversed(self.scopes):
            kind = scope.local_defs.get(name)
            if kind is not None:
                return kind
        return None

    def visit_FunctionDef(self, node):
        self._register(node.name, 'function')
        self.scopes.append(_Scope(node))
        self.generic_visit(node)
        self.scopes.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):
        self._register(node.name, 'class')
        self.generic_visit(node)

    def visit_Call(self, node):
        if _is_boundary(node):
            boundary = call_name(node)
            for expr in _payload_exprs(node):
                if isinstance(expr, ast.Lambda):
                    self._flag(expr, 'lambda handed to %s(): not '
                                     'pickle-safe across a process '
                                     'boundary' % boundary)
                elif isinstance(expr, ast.Name):
                    kind = self._local_kind(expr.id)
                    if kind is not None:
                        self._flag(expr, 'locally-defined %s %r handed to '
                                         '%s(): not pickle-safe across a '
                                         'process boundary (move it to '
                                         'module level)'
                                         % (kind, expr.id, boundary))
        self.generic_visit(node)


def run(module):
    visitor = _Visitor(module)
    visitor.visit(module.tree)
    return visitor.findings
