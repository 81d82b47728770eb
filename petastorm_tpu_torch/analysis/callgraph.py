"""Lightweight project-wide call/assignment graph for whole-program passes.

pipecheck's original passes are per-module by design; the pipesan passes
(``buffer-escape``/``buffer-write`` in :mod:`pass_buffers`, the
whole-program half of ``lock-order`` in :mod:`pass_locks`) need to see
across files: *does this function's return value alias a borrowed
buffer?*, *which locks does this call chain eventually acquire?*. This
module builds the one shared structure both answer from:

* a **function table** — every module-level function and every method of
  every class, keyed by a stable qualified name
  (``module.func`` / ``module.Class.method``);
* per function, the **calls** it makes (with the lock set lexically held
  at each call site), the **locks** it acquires, and its **return
  expressions**;
* a conservative **call resolver**: ``self.method()`` resolves within the
  class, bare names resolve through the module's project-internal
  ``from``-imports then to same-module functions, ``alias.func()``
  resolves through ``import``-aliases. Anything else (attribute calls on
  unknown objects, dynamic dispatch) stays unresolved — whole-program
  conclusions are drawn only from edges that are certainly real, which is
  what keeps the passes baseline-zero-able on a live tree.

Lock identity is globalized so cross-module nesting compares equal:
``self._lock`` inside ``class C`` of module ``m`` becomes ``m.C._lock``;
a module-level ``_IO_LOCK`` becomes ``m._IO_LOCK``. Stdlib-only, like
everything under :mod:`petastorm_tpu_torch.analysis`.
"""

import ast
import os

from petastorm_tpu_torch.analysis.pass_locks import _lock_name as _local_lock_name

#: project package prefix: imports outside it are external and unresolved
_PACKAGE = 'petastorm_tpu_torch'

#: interprocedural fixpoints are bounded; real call chains converge in 2-3
_MAX_FIXPOINT_ROUNDS = 10


def module_name(path):
    """Stable dotted module name for a file path: rooted at the package
    directory when the file lives under one (``petastorm_tpu_torch.device.staging``),
    else the bare stem (fixture files, snippets)."""
    parts = os.path.normpath(path).replace('\\', '/').split('/')
    stem = parts[-1][:-3] if parts[-1].endswith('.py') else parts[-1]
    if _PACKAGE in parts:
        rooted = parts[parts.index(_PACKAGE):-1] + [stem]
        name = '.'.join(rooted)
        return name[:-len('.__init__')] if name.endswith('.__init__') \
            else name
    return stem


class FunctionInfo:
    """One function/method in the graph."""

    __slots__ = ('qname', 'module', 'modname', 'class_name', 'node',
                 'calls', 'acquires', 'lexical_pairs', 'returns')

    def __init__(self, qname, module, modname, class_name, node):
        self.qname = qname
        self.module = module            # the owning SourceModule
        self.modname = modname
        self.class_name = class_name    # None for module-level functions
        self.node = node
        #: [(call_node, line, tuple(held global lock names))]
        self.calls = []
        #: [(global lock name, line)]
        self.acquires = []
        #: [(outer, inner, line)] — lock nestings lexical to this function
        self.lexical_pairs = []
        #: [ast.Return nodes]
        self.returns = []


class CallGraph:
    """Function table + import maps + the conservative call resolver."""

    def __init__(self, modules):
        #: qname -> FunctionInfo
        self.functions = {}
        #: modname -> {local name: qname} (module-level functions)
        self._module_funcs = {}
        #: modname -> {class: {method: qname}}
        self._class_methods = {}
        #: modname -> {local alias: (source modname, source func or None)}
        self._imports = {}
        # same-stem files from different scanned directories must not
        # merge into (and overwrite) one function table — the first
        # keeps the resolvable name, later ones get a path-qualified key
        # imports cannot reach (conservative: unresolved, never wrong)
        self._modules = {}
        named = []
        for m in modules:
            name = module_name(m.path)
            if name in self._modules:
                name = '%s<%s>' % (name, m.path)
            self._modules[name] = m
            named.append((name, m))
        for name, m in named:
            self._index_module(m, name)
        for info in self.functions.values():
            _FunctionScanner(self, info).scan()

    # -- indexing ------------------------------------------------------------

    def _index_module(self, module, modname):
        funcs = self._module_funcs.setdefault(modname, {})
        methods = self._class_methods.setdefault(modname, {})
        imports = self._imports.setdefault(modname, {})
        for stmt in module.tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qname = '%s.%s' % (modname, stmt.name)
                funcs[stmt.name] = qname
                self.functions[qname] = FunctionInfo(
                    qname, module, modname, None, stmt)
            elif isinstance(stmt, ast.ClassDef):
                table = methods.setdefault(stmt.name, {})
                for item in stmt.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        qname = '%s.%s.%s' % (modname, stmt.name, item.name)
                        table[item.name] = qname
                        self.functions[qname] = FunctionInfo(
                            qname, module, modname, stmt.name, item)
            elif isinstance(stmt, ast.ImportFrom) and stmt.module:
                source = self._project_module(stmt.module)
                if source is not None:
                    for alias in stmt.names:
                        imports[alias.asname or alias.name] = (source,
                                                               alias.name)
            elif isinstance(stmt, ast.Import):
                for alias in stmt.names:
                    source = self._project_module(alias.name)
                    if source is not None:
                        local = alias.asname or alias.name.split('.')[-1]
                        imports[local] = (source, None)

    def _project_module(self, dotted):
        """The analyzed-modules key a ``from X import`` names, or None for
        external modules. Fixture snippets import siblings by bare stem."""
        if dotted in self._modules:
            return dotted
        tail = dotted.split('.')[-1]
        if tail in self._modules and '.' not in dotted:
            return tail
        return None

    # -- resolution ----------------------------------------------------------

    def resolve(self, modname, class_name, call):
        """Qualified name of the project function a Call certainly targets,
        else None. Conservative on purpose: unresolved edges are dropped,
        never guessed."""
        func = call.func
        if isinstance(func, ast.Name):
            imported = self._imports.get(modname, {}).get(func.id)
            if imported is not None:
                source, name = imported
                if name is not None:
                    return self._module_funcs.get(source, {}).get(name)
                return None
            return self._module_funcs.get(modname, {}).get(func.id)
        if isinstance(func, ast.Attribute) and isinstance(func.value,
                                                          ast.Name):
            base = func.value.id
            if base in ('self', 'cls') and class_name is not None:
                return self._class_methods.get(modname, {}) \
                    .get(class_name, {}).get(func.attr)
            imported = self._imports.get(modname, {}).get(base)
            if imported is not None and imported[1] is None:
                return self._module_funcs.get(imported[0], {}).get(func.attr)
        return None

    # -- lock-reachability fixpoint ------------------------------------------

    def eventually_acquires(self):
        """``{qname: frozenset(global lock names)}`` — locks a call into
        the function can end up holding, transitively through resolved
        project-internal edges."""
        state = {q: {name for name, _ in f.acquires}
                 for q, f in self.functions.items()}
        for _ in range(_MAX_FIXPOINT_ROUNDS):
            changed = False
            for qname, info in self.functions.items():
                for call, _, _ in info.calls:
                    target = self.resolve(info.modname, info.class_name,
                                          call)
                    if target is not None and target != qname:
                        extra = state.get(target, ()) - state[qname]
                        if extra:
                            state[qname].update(extra)
                            changed = True
            if not changed:
                break
        return {q: frozenset(s) for q, s in state.items()}


class _FunctionScanner:
    """Populates one FunctionInfo: calls with held-lock context, acquires,
    lexical lock pairs, return statements. Mirrors the statement-walking
    discipline of :mod:`pass_locks` (nested ``def``/``lambda`` bodies run
    later, not here — their calls are not attributed to this function)."""

    def __init__(self, graph, info):
        self.graph = graph
        self.info = info

    def scan(self):
        self.scan_body(self.info.node.body, ())

    def _globalize(self, dotted):
        if dotted.startswith('self.') or dotted.startswith('cls.'):
            if self.info.class_name is None:
                return '%s.%s' % (self.info.modname,
                                  dotted.split('.', 1)[1])
            return '%s.%s.%s' % (self.info.modname, self.info.class_name,
                                 dotted.split('.', 1)[1])
        # an IMPORTED lock must globalize to its DEFINING module, or the
        # two sides of a cross-module nesting would never compare equal
        # (``from mod_b import _FLUSH_LOCK`` used under mod_a's lock)
        imports = self.graph._imports.get(self.info.modname, {})
        head, _, rest = dotted.partition('.')
        imported = imports.get(head)
        if imported is not None:
            source, name = imported
            if name is None:
                # import X as head; head.rest
                return '%s.%s' % (source, rest) if rest else source
            return '%s.%s%s' % (source, name, '.' + rest if rest else '')
        return '%s.%s' % (self.info.modname, dotted)

    def _lock_name(self, expr):
        # the ONE lock-recognition predicate, shared with the per-module
        # scan so the two halves of lock-order agree on what a lock is
        name = _local_lock_name(expr)
        if name is None:
            return None
        return self._globalize(name)

    def _note(self, held, lock, line):
        self.info.acquires.append((lock, line))
        for outer in held:
            if outer != lock:
                self.info.lexical_pairs.append((outer, lock, line))

    def scan_body(self, body, held):
        held = list(held)
        for stmt in body:
            if self._acquire_release(stmt, held):
                continue
            self.scan_stmt(stmt, tuple(held))

    def _acquire_release(self, stmt, held):
        if not isinstance(stmt, ast.Expr) \
                or not isinstance(stmt.value, ast.Call) \
                or not isinstance(stmt.value.func, ast.Attribute):
            return False
        call = stmt.value
        lock = self._lock_name(call.func.value)
        if lock is None:
            return False
        if call.func.attr == 'acquire':
            self._note(held, lock, stmt.lineno)
            held.append(lock)
            return True
        if call.func.attr == 'release':
            if lock in held:
                held.remove(lock)
            return True
        return False

    def scan_stmt(self, stmt, held):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # deferred execution: not this function's calls
        if isinstance(stmt, ast.Return):
            self.info.returns.append(stmt)
            self._collect_calls(stmt.value, held)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            entered = list(held)
            for item in stmt.items:
                self._collect_calls(item.context_expr, held)
                lock = self._lock_name(item.context_expr)
                if lock is None and item.optional_vars is not None:
                    lock = self._lock_name(item.optional_vars)
                if lock is not None:
                    self._note(entered, lock, stmt.lineno)
                    entered.append(lock)
            self.scan_body(stmt.body, tuple(entered))
            return
        if isinstance(stmt, ast.Try):
            self.scan_body(stmt.body, held)
            for handler in stmt.handlers:
                self.scan_body(handler.body, held)
            self.scan_body(stmt.orelse, held)
            self.scan_body(stmt.finalbody, held)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            self._collect_calls(stmt.test, held)
            self.scan_body(stmt.body, held)
            self.scan_body(stmt.orelse, held)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._collect_calls(stmt.iter, held)
            self.scan_body(stmt.body, held)
            self.scan_body(stmt.orelse, held)
            return
        self._collect_calls(stmt, held)

    def _collect_calls(self, node, held):
        if node is None:
            return
        for child in ast.walk(node):
            if isinstance(child, (ast.Lambda, ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                continue  # deferred bodies; ast.walk still descends, so
                # calls inside lambdas are over-collected — acceptable for
                # reachability (a deferred call can still run under the
                # lock when invoked synchronously, e.g. sorted(key=...))
            if isinstance(child, ast.Call):
                self.info.calls.append((child, child.lineno, tuple(held)))


# last (module identity set, graph): pass_buffers and pass_locks both
# call build_graph over the SAME modules list within one analysis run,
# and indexing + scanning every function body twice would double the
# whole-program cost. The cached graph holds strong refs to its modules,
# so the ids in the key cannot be recycled while the entry is alive;
# core.run_project_passes clears the cache when the run ends so a
# long-lived process does not pin the last repo's parse state.
_last_graph = None


def build_graph(modules):
    """The :class:`CallGraph` over a list of parsed SourceModules
    (memoized for consecutive calls over the same modules)."""
    global _last_graph
    key = tuple(id(m) for m in modules)
    if _last_graph is not None and _last_graph[0] == key:
        return _last_graph[1]
    graph = CallGraph(modules)
    _last_graph = (key, graph)
    return graph


def clear_graph_cache():
    """Drop the memoized graph (end of an analysis run)."""
    global _last_graph
    _last_graph = None
