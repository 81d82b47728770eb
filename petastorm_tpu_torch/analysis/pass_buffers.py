"""``buffer-escape`` / ``buffer-write`` pass: whole-program ownership
analysis of the zero-copy pipeline's borrowed buffer views.

The zero-copy paths hand out BORROWED memory: the pinned ring slots'
host tensors and numpy views (``slot.tensors``/``slot.views``), recycled
once the slot's CUDA event completes, an arrow column's encoded cell
views (``column.cells``), ``astype(..., copy=False)`` aliases of a
decoder's buffer — and, in the reference's remaining planes, ZMQ receive
frames and decoded-cache mmap columns. One escaped view or
stray in-place write is *silent batch corruption* — the bit-exact
reproducibility failure mode, invisible until a loss curve diverges.

The pass taints values born from the borrow sources registered in
:mod:`~petastorm_tpu_torch.analysis.contracts` (``BORROW_CALLS`` /
``BORROW_CALL_KWARGS`` / ``BORROW_ATTRS`` — the single source of truth
the runtime sanitizer guards dynamically) and walks each function
flow-sensitively, in statement order, flagging a tainted value that:

* is stored into object/class/module state (``self.x = view``,
  ``obj.attr = view``, a ``global``-declared name) — rule
  ``buffer-escape``;
* is put on a queue (``q.put(view)``) or appended onto object state —
  ``buffer-escape``;
* is captured by a nested ``def``/``lambda`` (the closure outlives the
  owner's frame) — ``buffer-escape``;
* is returned (past the owner's documented lifetime) — ``buffer-escape``;
* is written through (``view[...] = x``, ``view += x``,
  ``np.copyto(dst=view)``) — rule ``buffer-write``.

An explicit ``# pipesan: owns`` annotation on the line records the
transfer as intentional and silences the finding; on a ``return`` it
asserts the CALLER owns the result (the view's base chain carries the
memory), so taint does not propagate — a function whose callers genuinely
*borrow* belongs in ``BORROW_CALLS`` instead. Two precision exemptions
keep honest code clean: ``frombuffer`` over a *call expression* and
``astype(copy=False)`` on a *call expression* receiver build views over
fresh anonymous temporaries whose only reference becomes the array's
``.base`` — owned by construction. A registered borrow source returning
its borrowed views (``read_entry`` handing out mmap columns) is its
documented contract, not a finding.

Whole-program: a project function whose return value is tainted (and not
``owns``-annotated) becomes a borrow source for its (conservatively
resolved) callers, via the shared
:mod:`~petastorm_tpu_torch.analysis.callgraph`, iterated to fixpoint. Analysis
is function-scoped and flow-sensitive but path-insensitive: branch bodies
are walked in source order and reassignment from an untainted value kills
taint — the right precision for this codebase's straight-line decode
paths. Taint distinguishes a direct *view* from a *container* that
absorbed one: writing a new key into a dict of borrowed columns is fine;
writing through the view itself is not.
"""

import ast

from petastorm_tpu_torch.analysis.callgraph import (
    _MAX_FIXPOINT_ROUNDS, build_graph,
)
from petastorm_tpu_torch.analysis.contracts import (
    BORROW_ATTRS, BORROW_CALL_KWARGS, BORROW_CALLS,
)
from petastorm_tpu_torch.analysis.findings import call_name, dotted_text

ESCAPE_RULE = 'buffer-escape'
WRITE_RULE = 'buffer-write'
RULES = (ESCAPE_RULE, WRITE_RULE)

#: calls that move their argument onto a channel another scope drains
_QUEUE_CALLS = frozenset(['put', 'put_nowait'])

#: container mutators: a tainted argument taints a local receiver, and
#: escapes through an attribute receiver (object state)
_CONTAINER_CALLS = frozenset(['append', 'extend', 'add', 'appendleft'])

#: ndarray methods whose RESULT owns its memory even on a borrowed
#: receiver — deep copies, materializations, and reductions. A call to
#: one of these launders taint correctly (``view.copy()`` is the
#: canonical fix for an escape finding); plain ``astype`` copies by
#: default (the aliasing ``copy=False`` spelling is caught earlier as a
#: registered borrow kwarg).
_OWNING_METHODS = frozenset([
    'copy', 'tobytes', 'tolist', 'item', 'astype', 'dump', 'dumps',
    'sum', 'mean', 'std', 'var', 'prod', 'min', 'max', 'all', 'any',
    'argmin', 'argmax', 'nonzero', 'round', 'cumsum', 'cumprod',
])

_FIX_HINT = ("copy it (e.g. np.array(view)) or annotate an intentional "
             "transfer with '# pipesan: owns'")

#: ndarray attributes that are scalar metadata, not aliasing views —
#: ``view.nbytes`` / ``view.shape[0]`` cannot leak the buffer
_SCALAR_ATTRS = frozenset([
    'nbytes', 'shape', 'size', 'ndim', 'dtype', 'itemsize', 'strides',
    'flags',
])


def _kw_equals(call, kw, value):
    for k in call.keywords:
        if k.arg == kw and isinstance(k.value, ast.Constant) \
                and k.value.value is value:
            return True
    return False


class _FnScanner:
    """Flow-sensitive taint walk over one function body."""

    def __init__(self, info, graph, borrowed_fns):
        self.info = info
        self.module = info.module
        self.graph = graph
        self.borrowed_fns = borrowed_fns
        self.findings = []
        self.returns_borrowed = False
        self.tainted = {}            # local name -> source description
        self.globals_declared = set()

    # -- reporting -----------------------------------------------------------

    def _flag(self, rule, node, message):
        if self.module.owned(node):
            return
        finding = self.module.finding(rule, node, message)
        if finding is not None:
            self.findings.append(finding)

    # -- borrow sources ------------------------------------------------------

    def _borrow_call(self, call):
        """Source description when the call births a borrowed view."""
        name = call_name(call)
        if name in BORROW_CALLS:
            if name == 'frombuffer' and call.args \
                    and isinstance(call.args[0], ast.Call):
                return None  # fresh anonymous temporary: owned via .base
            return '%s()' % name
        if name in BORROW_CALL_KWARGS:
            kw, value = BORROW_CALL_KWARGS[name]
            if _kw_equals(call, kw, value):
                if name == 'astype' \
                        and isinstance(call.func, ast.Attribute) \
                        and isinstance(call.func.value, ast.Call):
                    return None  # fresh temporary receiver: owned
                return '%s(%s=%r)' % (name, kw, value)
        target = self.graph.resolve(self.info.modname,
                                    self.info.class_name, call)
        if target is not None and target in self.borrowed_fns:
            return '%s()' % target
        return None

    def _taint_source(self, expr):
        """``(source description, kind)`` when the expression's value may
        be a borrowed view (kind ``'view'``) or a container holding one
        (kind ``'container'``), else None."""
        if expr is None:
            return None
        if isinstance(expr, ast.Call):
            source = self._borrow_call(expr)
            if source is not None:
                # recv_multipart returns a caller-owned LIST of frames:
                # mutating the list is fine, the frames inside are the
                # borrowed views (container taint — indexing yields one)
                kind = ('container' if source.startswith('recv_multipart')
                        else 'view')
                return (source, kind)
            # view-producing method chain on a tainted receiver
            # (view.reshape(...), view[...].ravel()) — except the owning
            # methods (copies/reductions), whose results are fresh; a
            # call on an untainted callee launders taint by design
            if isinstance(expr.func, ast.Attribute):
                if expr.func.attr in _OWNING_METHODS:
                    return None
                return self._taint_source(expr.func.value)
            return None
        if isinstance(expr, ast.Name):
            return self.tainted.get(expr.id)
        if isinstance(expr, ast.Attribute):
            dotted = dotted_text(expr)
            if dotted in BORROW_ATTRS:
                # slot.buffers is a dict of slot arrays — a container
                return (dotted, 'container')
            if expr.attr in _SCALAR_ATTRS:
                return None  # scalar metadata cannot alias the buffer
            return self._taint_source(expr.value)
        if isinstance(expr, ast.Subscript):
            taint = self._taint_source(expr.value)
            if taint is None:
                return None
            # indexing a tainted container/view yields the borrowed view
            return (taint[0], 'view')
        if isinstance(expr, ast.Starred):
            return self._taint_source(expr.value)
        if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            for elt in expr.elts:
                taint = self._taint_source(elt)
                if taint is not None:
                    return (taint[0], 'container')
            return None
        if isinstance(expr, ast.Dict):
            for value in expr.values:
                taint = self._taint_source(value)
                if taint is not None:
                    return (taint[0], 'container')
            return None
        if isinstance(expr, ast.IfExp):
            return self._taint_source(expr.body) \
                or self._taint_source(expr.orelse)
        if isinstance(expr, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return self._comprehension_source(expr, expr.elt)
        if isinstance(expr, ast.DictComp):
            return self._comprehension_source(expr, expr.value)
        if isinstance(expr, ast.NamedExpr):
            return self._taint_source(expr.value)
        return None

    def _comprehension_source(self, comp, elt):
        """A comprehension yielding borrowed views taints the container it
        builds (``[np.frombuffer(b) for b in frames]``). The element
        expression is evaluated with the comprehension variables bound to
        their iterated taint, so laundering still works —
        ``[v.copy() for v in views]`` and ``[len(v) for v in views]``
        build containers that OWN their elements."""
        saved = self.tainted
        self.tainted = dict(saved)
        try:
            for gen in comp.generators:
                taint = self._taint_source(gen.iter)
                if taint is not None:
                    for node in ast.walk(gen.target):
                        if isinstance(node, ast.Name):
                            self.tainted[node.id] = (taint[0], 'view')
            taint = self._taint_source(elt)
            return (taint[0], 'container') if taint is not None else None
        finally:
            self.tainted = saved

    # -- statement walk ------------------------------------------------------

    def scan(self):
        self._scan_body(self.info.node.body)

    def _scan_body(self, body):
        for stmt in body:
            self._scan_stmt(stmt)

    def _scan_stmt(self, stmt):
        if isinstance(stmt, ast.Global):
            self.globals_declared.update(stmt.names)
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            self._check_closure(stmt)
            return
        if isinstance(stmt, ast.ClassDef):
            return
        if isinstance(stmt, ast.Return):
            self._check_closures_in(stmt.value)
            taint = self._taint_source(stmt.value)
            if taint is not None:
                if self.info.node.name in BORROW_CALLS:
                    return  # a registered borrow source returning its
                    # borrowed views IS its documented contract
                if self.module.owned(stmt):
                    return  # caller owns the result: no propagation
                self.returns_borrowed = True
                self._flag(ESCAPE_RULE, stmt,
                           'borrowed buffer view (from %s) returned past '
                           'its owning scope; %s' % (taint[0], _FIX_HINT))
            return
        if isinstance(stmt, ast.Assign):
            self._check_closures_in(stmt.value)
            targets = stmt.targets
            if (len(targets) == 1
                    and isinstance(targets[0], (ast.Tuple, ast.List))
                    and isinstance(stmt.value, (ast.Tuple, ast.List))
                    and len(targets[0].elts) == len(stmt.value.elts)
                    and not any(isinstance(e, ast.Starred)
                                for e in targets[0].elts)):
                # literal unpack matches elementwise: `size, owned =
                # view.nbytes, view.copy()` must not smear the tuple's
                # aggregated taint onto the untainted elements
                for t, v in zip(targets[0].elts, stmt.value.elts):
                    self._assign_target(t, self._taint_source(v), stmt)
                return
            taint = self._taint_source(stmt.value)
            for target in targets:
                self._assign_target(target, taint, stmt)
            return
        if isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._check_closures_in(stmt.value)
                self._assign_target(stmt.target,
                                    self._taint_source(stmt.value), stmt)
            return
        if isinstance(stmt, ast.AugAssign):
            self._aug_assign(stmt)
            return
        if isinstance(stmt, ast.Expr):
            self._check_closures_in(stmt.value)
            if isinstance(stmt.value, ast.Call):
                self._expr_call(stmt.value)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                taint = self._taint_source(item.context_expr)
                if item.optional_vars is not None:
                    self._assign_target(item.optional_vars, taint, stmt)
            self._scan_body(stmt.body)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._assign_target(stmt.target,
                                self._taint_source(stmt.iter), stmt)
            self._scan_body(stmt.body)
            self._scan_body(stmt.orelse)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            self._scan_body(stmt.body)
            self._scan_body(stmt.orelse)
            return
        if isinstance(stmt, ast.Try):
            self._scan_body(stmt.body)
            for handler in stmt.handlers:
                self._scan_body(handler.body)
            self._scan_body(stmt.orelse)
            self._scan_body(stmt.finalbody)
            return
        if isinstance(stmt, ast.Delete):
            for target in stmt.targets:
                if isinstance(target, ast.Name):
                    self.tainted.pop(target.id, None)
            return

    def _assign_target(self, target, taint, stmt):
        if isinstance(target, ast.Name):
            if taint is None:
                self.tainted.pop(target.id, None)  # reassignment kills
                return
            if target.id in self.globals_declared:
                self._flag(ESCAPE_RULE, stmt,
                           'borrowed buffer view (from %s) stored into '
                           'module state (global %s) — escapes its owning '
                           'scope; %s' % (taint[0], target.id, _FIX_HINT))
                return
            self.tainted[target.id] = taint
            return
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._assign_target(elt, taint, stmt)
            return
        if isinstance(target, ast.Starred):
            self._assign_target(target.value, taint, stmt)
            return
        if isinstance(target, ast.Attribute):
            if taint is not None:
                self._flag(ESCAPE_RULE, stmt,
                           'borrowed buffer view (from %s) stored into '
                           'object/class state (%s) — escapes its owning '
                           'scope; %s'
                           % (taint[0], dotted_text(target) or 'attribute',
                              _FIX_HINT))
            return
        if isinstance(target, ast.Subscript):
            base = self._taint_source(target.value)
            if base is not None and base[1] == 'view':
                # writing INTO a tainted dict/list of views is a normal
                # container store; writing through the view itself is the
                # silent-corruption hazard
                self._flag(WRITE_RULE, stmt,
                           'write through a borrowed buffer view (from '
                           '%s): in-place mutation corrupts the shared '
                           'backing memory; %s' % (base[0], _FIX_HINT))
                return
            if taint is None:
                return
            if base is None and isinstance(target.value, ast.Name):
                # a local container absorbing a borrowed view carries it
                self.tainted[target.value.id] = (taint[0], 'container')
            elif base is None and isinstance(target.value, ast.Attribute):
                self._flag(ESCAPE_RULE, stmt,
                           'borrowed buffer view (from %s) stored into '
                           'object state (%s[...]) — escapes its owning '
                           'scope; %s'
                           % (taint[0],
                              dotted_text(target.value) or 'attr',
                              _FIX_HINT))

    def _aug_assign(self, stmt):
        target = stmt.target
        source = None
        if isinstance(target, ast.Name):
            taint = self.tainted.get(target.id)
            if taint is not None and taint[1] == 'view':
                source = taint[0]
        elif isinstance(target, ast.Subscript):
            # d[k] += x and view[i] += x both mutate the element in place
            taint = self._taint_source(target.value)
            if taint is not None:
                source = taint[0]
        elif isinstance(target, ast.Attribute):
            dotted = dotted_text(target)
            if dotted in BORROW_ATTRS:
                source = dotted
        if source is not None:
            self._flag(WRITE_RULE, stmt,
                       'augmented write through a borrowed buffer view '
                       '(from %s): in-place mutation corrupts the shared '
                       'backing memory; %s' % (source, _FIX_HINT))

    def _expr_call(self, call):
        name = call_name(call)
        if name in _QUEUE_CALLS:
            for arg in call.args:
                taint = self._taint_source(arg)
                if taint is not None:
                    self._flag(ESCAPE_RULE, call,
                               'borrowed buffer view (from %s) put on a '
                               'queue — the consumer outlives the owning '
                               'scope; %s' % (taint[0], _FIX_HINT))
                    return
            return
        if name == 'copyto':
            dst = call.args[0] if call.args else None
            for k in call.keywords:
                if k.arg == 'dst':
                    dst = k.value
            taint = self._taint_source(dst)
            if taint is not None and taint[1] == 'view':
                self._flag(WRITE_RULE, call,
                           'np.copyto into a borrowed buffer view (from '
                           '%s): in-place mutation corrupts the shared '
                           'backing memory; %s' % (taint[0], _FIX_HINT))
            return
        if name in _CONTAINER_CALLS \
                and isinstance(call.func, ast.Attribute):
            for arg in call.args:
                taint = self._taint_source(arg)
                if taint is None:
                    continue
                receiver = call.func.value
                if isinstance(receiver, ast.Name):
                    self.tainted[receiver.id] = (taint[0], 'container')
                elif isinstance(receiver, ast.Attribute):
                    self._flag(ESCAPE_RULE, call,
                               'borrowed buffer view (from %s) appended '
                               'onto object state (%s) — escapes its '
                               'owning scope; %s'
                               % (taint[0],
                                  dotted_text(receiver) or 'attribute',
                                  _FIX_HINT))
                return

    # -- closures ------------------------------------------------------------

    def _check_closures_in(self, expr):
        if expr is None:
            return
        for node in ast.walk(expr):
            if isinstance(node, (ast.Lambda, ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                self._check_closure(node)

    def _check_closure(self, fn_node):
        captured = sorted(_free_names(fn_node) & set(self.tainted))
        for name in captured:
            self._flag(ESCAPE_RULE, fn_node,
                       'borrowed buffer view %r (from %s) captured by a '
                       'closure — the closure outlives the owning scope; '
                       '%s' % (name, self.tainted[name][0], _FIX_HINT))


def _free_names(fn_node):
    """Names a nested function reads from the enclosing scope."""
    args = fn_node.args
    bound = {a.arg for a in (args.posonlyargs + args.args
                             + args.kwonlyargs)}
    if args.vararg:
        bound.add(args.vararg.arg)
    if args.kwarg:
        bound.add(args.kwarg.arg)
    body = fn_node.body if isinstance(fn_node.body, list) else [fn_node.body]
    loaded, stored = set(), set()
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Name):
                if isinstance(node.ctx, ast.Load):
                    loaded.add(node.id)
                else:
                    stored.add(node.id)
    return loaded - bound - stored


def run_project(modules):
    """Whole-program driver: fixpoint the set of borrow-returning project
    functions over the call graph. The converged (no-change) round's
    findings ARE the result — the borrowed set was stable throughout it,
    so a separate emit pass would just recompute them."""
    graph = build_graph(modules)
    borrowed = set()
    findings = []
    for _ in range(_MAX_FIXPOINT_ROUNDS):
        changed = False
        findings = []
        for info in graph.functions.values():
            scanner = _FnScanner(info, graph, borrowed)
            scanner.scan()
            findings.extend(scanner.findings)
            if scanner.returns_borrowed and info.qname not in borrowed:
                borrowed.add(info.qname)
                changed = True
        if not changed:
            break
    return findings
