"""``thread-lifecycle`` pass: every created thread is reclaimable.

A ``threading.Thread(...)`` must either be daemonized (``daemon=True``
at construction, or ``X.daemon = True`` before ``start()`` in the same
function) or be ``.join()``ed from a teardown path: a non-daemon,
never-joined thread keeps the interpreter alive after ``main`` returns —
the classic "job finished but the process won't exit" hang — while a
joined thread documents who waits for it and when.

"Joined from a teardown path" is checked structurally: a thread bound to
``self.X`` needs a ``*.join(...)`` call inside a method of the same
class whose name suggests teardown (``stop``/``close``/``shutdown``/
``join``/``__exit__``/``__del__``/``abort``/``teardown``); a thread
bound to a local variable needs ``X.join(...)`` later in the same
function.
"""

import ast

from petastorm_tpu_torch.analysis.findings import dotted_text

RULE = 'thread-lifecycle'
RULES = (RULE,)

_TEARDOWN_TOKENS = ('stop', 'close', 'shutdown', 'join', 'exit', 'del',
                    'abort', 'teardown')


def _is_thread_ctor(call):
    func = call.func
    if isinstance(func, ast.Name) and func.id == 'Thread':
        return True
    return (isinstance(func, ast.Attribute) and func.attr == 'Thread'
            and isinstance(func.value, ast.Name)
            and func.value.id == 'threading')


def _daemon_true(call):
    for kw in call.keywords:
        if kw.arg == 'daemon' and isinstance(kw.value, ast.Constant) \
                and kw.value.value is True:
            return True
    return False


def _is_teardown_method(name):
    lowered = name.lower()
    return any(token in lowered for token in _TEARDOWN_TOKENS)


def _join_targets(tree):
    """Dotted names ``X`` for every ``X.join(...)`` call; the bare
    terminal too ('self._thread' -> also '_thread') so locals
    snapshotting the attribute under the lock
    (``thread = self._thread; thread.join()``) still count."""
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute) \
                and node.func.attr == 'join':
            target = dotted_text(node.func.value)
            if target is not None:
                names.add(target)
                names.add(target.rsplit('.', 1)[-1])
    return names


def _class_joins(class_node):
    """Join-call target names inside teardown-named methods of a class."""
    names = set()
    for stmt in class_node.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and _is_teardown_method(stmt.name):
            names |= _join_targets(stmt)
    return names


def _daemon_assigned(func_node, target):
    """True when ``<target>.daemon = True`` appears in the function."""
    if target is None:
        return False
    for node in ast.walk(func_node):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            if isinstance(tgt, ast.Attribute) and tgt.attr == 'daemon' \
                    and dotted_text(tgt.value) in (target,
                                                   target.rsplit('.', 1)[-1]) \
                    and isinstance(node.value, ast.Constant) \
                    and node.value.value is True:
                return True
    return False


def _binding_target(parents, call):
    """Dotted name the Thread(...) result is bound to ('self._thread',
    'worker_thread'), walking up through the statement that contains the
    call; None when unbound."""
    node = call
    while node in parents:
        parent = parents[node]
        if isinstance(parent, ast.Assign) and parent.value is node \
                and len(parent.targets) == 1:
            return dotted_text(parent.targets[0])
        if isinstance(parent, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef, ast.Module)):
            return None
        node = parent
    return None


def run(module):
    findings = []
    parents = {}
    for node in ast.walk(module.tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node

    def enclosing(node, kinds):
        while node in parents:
            node = parents[node]
            if isinstance(node, kinds):
                return node
        return None

    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call) or not _is_thread_ctor(node):
            continue
        if _daemon_true(node):
            continue
        target = _binding_target(parents, node)
        func_node = enclosing(node, (ast.FunctionDef, ast.AsyncFunctionDef))
        class_node = enclosing(node, (ast.ClassDef,))
        if func_node is not None and _daemon_assigned(func_node, target):
            continue
        joined = set()
        if class_node is not None:
            joined |= _class_joins(class_node)
        if func_node is not None:
            joined |= _join_targets(func_node)
        terminal = target.rsplit('.', 1)[-1] if target else None
        if target is not None and (target in joined or terminal in joined):
            continue
        finding = module.finding(
            RULE, node,
            'Thread without daemon=True and never join()ed from a '
            'stop()/close()/__exit__ path%s' % (
                '' if target is None
                else ' (bound to %s)' % target))
        if finding is not None:
            findings.append(finding)
    return findings
