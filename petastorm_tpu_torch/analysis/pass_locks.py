"""``blocking-under-lock`` + ``lock-order`` pass: the deadlock-hazard
detector for the dispatcher/staging/recorder code.

Rule ``blocking-under-lock``: a call that can block indefinitely —
``queue.get()``/``put(...)`` without a timeout, ZMQ ``recv``/``send``
without ``NOBLOCK``/``DONTWAIT``, ``Thread.join()``/``wait()`` without a
timeout, ``block_until_ready``, ``subprocess.*``, ``time.sleep`` — must
not execute while a lock is lexically held (a ``with <lock>:`` body, or
between ``<lock>.acquire()`` and ``<lock>.release()``). A blocked holder
stalls every other thread contending for that lock; when the blocked
resource is drained by one of those threads, that is a deadlock (the
tf.data service paper's dispatcher post-mortems are exactly this shape).

Rule ``lock-order``: when two locks are ever nested in both orders
within one module (A then B somewhere, B then A elsewhere), the module
has a lock-inversion hazard — two threads taking the opposite paths
deadlock. Lock identity is the dotted source text (``self._lock``),
which is the right granularity for the single-class modules this
package keeps its locks in.

The per-module half is lexical by design; :func:`run_project` promotes
the same rule to **whole-program**: using the shared
:mod:`~petastorm_tpu_torch.analysis.callgraph`, a call made while a lock is
held inherits every lock the (conservatively resolved) callee can
eventually acquire — so ``with A: helper()`` where ``helper`` (in any
module) takes ``B`` records the nesting ``A → B``, and an opposite-order
chain anywhere in the project is an inversion finding even though no
single module ever shows both orders. Lock names are globalized
(``module.Class._lock``) so cross-module nestings compare equal; pairs
the lexical per-module scan already reports are not re-reported.

Nested ``def``/``lambda`` bodies under a ``with`` are skipped in the
lexical scan — they execute later, not under the lock.
"""

import ast

from petastorm_tpu_torch.analysis.findings import call_name, dotted_text

BLOCK_RULE = 'blocking-under-lock'
ORDER_RULE = 'lock-order'
RULES = (BLOCK_RULE, ORDER_RULE)
#: the subset run_project can emit — ``--select blocking-under-lock``
#: must not pay for call-graph construction it cannot benefit from
PROJECT_RULES = (ORDER_RULE,)

#: ZMQ socket operations that block without an explicit NOBLOCK/DONTWAIT
_ZMQ_OPS = frozenset(['recv', 'recv_multipart', 'recv_pyobj', 'recv_string',
                      'recv_json', 'send', 'send_multipart', 'send_pyobj',
                      'send_string', 'send_json'])

_SUBPROCESS_OPS = frozenset(['run', 'call', 'check_call', 'check_output',
                             'Popen'])


def _lock_name(expr):
    """Dotted name when the expression looks like a lock ('lock'/'mutex'
    in its terminal segment, e.g. ``self._lock``, ``_JPEG_FANCY_LOCK``);
    else None. Conditions (`self._cv`) are deliberately not locks here:
    their ``wait()`` releases the underlying lock by contract."""
    name = dotted_text(expr)
    if name is None:
        return None
    terminal = name.rsplit('.', 1)[-1].lower()
    if 'lock' in terminal or 'mutex' in terminal:
        return name
    return None


def _has_kw(call, kw):
    return any(k.arg == kw for k in call.keywords)


def _kw_is_false(call, kw):
    for k in call.keywords:
        if k.arg == kw and isinstance(k.value, ast.Constant) \
                and k.value.value is False:
            return True
    return False


def _mentions_noblock(call):
    for node in ast.walk(call):
        if isinstance(node, ast.Attribute) \
                and node.attr in ('NOBLOCK', 'DONTWAIT'):
            return True
        if isinstance(node, ast.Name) and node.id in ('NOBLOCK', 'DONTWAIT'):
            return True
    return False


def _blocking_reason(call):
    """Why this call can block indefinitely, or None."""
    func = call.func
    name = call_name(call)
    if isinstance(func, ast.Attribute):
        if name == 'get' and not call.args and not _has_kw(call, 'timeout') \
                and not _kw_is_false(call, 'block'):
            return 'queue get() with no timeout'
        if name == 'put' and not _has_kw(call, 'timeout') \
                and not _kw_is_false(call, 'block'):
            return 'queue put() with no timeout'
        if name in _ZMQ_OPS and not _mentions_noblock(call):
            return 'ZMQ %s() without NOBLOCK/DONTWAIT' % name
        if name in ('join', 'wait') and not call.args \
                and not _has_kw(call, 'timeout'):
            return '%s() with no timeout' % name
        if isinstance(func.value, ast.Name) and func.value.id == 'subprocess' \
                and name in _SUBPROCESS_OPS:
            return 'subprocess.%s()' % name
        if name == 'sleep' and isinstance(func.value, ast.Name) \
                and func.value.id == 'time':
            return 'time.sleep()'
    elif isinstance(func, ast.Name) and name == 'sleep':
        return 'sleep()'
    if name == 'block_until_ready':
        return 'block_until_ready()'
    return None


class _Scanner:
    """Statement walker tracking the lexically-held lock stack."""

    def __init__(self, module):
        self.module = module
        self.findings = []
        # (outer_name, inner_name) -> first line the nesting was seen at
        self.order_pairs = {}

    # -- reporting -----------------------------------------------------------

    def _flag(self, rule, node, message):
        finding = self.module.finding(rule, node, message)
        if finding is not None:
            self.findings.append(finding)

    def _note_nesting(self, held, new_name, node):
        for outer in held:
            pair = (outer, new_name)
            self.order_pairs.setdefault(pair, node.lineno)
            inverse = self.order_pairs.get((new_name, outer))
            if inverse is not None and outer != new_name:
                self._flag(ORDER_RULE, node,
                           'locks %s and %s are nested in both orders in '
                           'this module (opposite order at line %d): '
                           'lock-inversion deadlock hazard'
                           % (outer, new_name, inverse))

    # -- traversal -----------------------------------------------------------

    def scan_body(self, body, held):
        """Walk one statement list; ``held`` is the tuple of lock names
        lexically held on entry. acquire()/release() statements extend or
        shrink the held set for their remaining siblings."""
        held = list(held)
        for stmt in body:
            acquired = self._acquire_release(stmt, held)
            if acquired is not None:
                continue  # the acquire/release call itself is not a block
            self.scan_stmt(stmt, tuple(held))

    def _acquire_release(self, stmt, held):
        """Handle a bare ``<lock>.acquire()`` / ``.release()`` statement;
        returns the lock name when the statement was one, else None."""
        if not isinstance(stmt, ast.Expr) or not isinstance(stmt.value,
                                                            ast.Call):
            return None
        call = stmt.value
        if not isinstance(call.func, ast.Attribute):
            return None
        lock = _lock_name(call.func.value)
        if lock is None:
            return None
        if call.func.attr == 'acquire':
            self._note_nesting(held, lock, stmt)
            held.append(lock)
            return lock
        if call.func.attr == 'release':
            if lock in held:
                held.remove(lock)
            return lock
        return None

    def scan_stmt(self, stmt, held):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a def's body runs when called, not where it is defined:
            # fresh scan with no held locks
            self.scan_body(stmt.body, ())
            return
        if isinstance(stmt, ast.ClassDef):
            self.scan_body(stmt.body, ())
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            entered = list(held)
            for item in stmt.items:
                self._check_expr(item.context_expr, held)
                lock = _lock_name(item.context_expr)
                if lock is None and item.optional_vars is not None:
                    # `with open(path) as lock_file:` — an fcntl-style
                    # file lock announced by its as-name
                    lock = _lock_name(item.optional_vars)
                if lock is not None:
                    self._note_nesting(entered, lock, stmt)
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
            self._check_expr(stmt.test, held)
            self.scan_body(stmt.body, held)
            self.scan_body(stmt.orelse, held)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._check_expr(stmt.iter, held)
            self.scan_body(stmt.body, held)
            self.scan_body(stmt.orelse, held)
            return
        # simple statement: check every call inside it
        self._check_expr(stmt, held)

    def _check_expr(self, node, held):
        """Flag blocking calls in an expression/simple statement; nested
        function/lambda bodies are skipped (deferred execution)."""
        if not held or node is None:
            return
        for child in ast.walk(node):
            if isinstance(child, (ast.Lambda, ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                continue  # ast.walk is non-recursive per node; see below
            if isinstance(child, ast.Call):
                reason = self._reason_outside_lambda(node, child)
                if reason is not None:
                    self._flag(BLOCK_RULE, child,
                               '%s while holding %s' % (reason,
                                                        ', '.join(held)))

    def _reason_outside_lambda(self, root, call):
        """Blocking reason for ``call`` unless it sits inside a deferred
        body (lambda) under ``root``."""
        reason = _blocking_reason(call)
        if reason is None:
            return None
        for node in ast.walk(root):
            if isinstance(node, ast.Lambda):
                for inner in ast.walk(node.body):
                    if inner is call:
                        return None
        return reason


def run(module):
    scanner = _Scanner(module)
    scanner.scan_body(module.tree.body, ())
    return scanner.findings


def run_project(modules):
    """Whole-program ``lock-order``: inversion pairs only visible through
    the call graph (cross-function / cross-module). Same-module pairs the
    lexical :func:`run` scan reports are excluded here."""
    from petastorm_tpu_torch.analysis.callgraph import build_graph
    graph = build_graph(modules)
    eventually = graph.eventually_acquires()
    # (outer, inner) -> (SourceModule, line, kind); first witness wins
    pairs = {}
    # per-module lexical pair sets: an inversion whose BOTH orders are
    # lexical within one module is the per-module run() scan's report,
    # regardless of which witness kind got recorded into `pairs` first
    lexical_by_module = {}
    for info in graph.functions.values():
        for outer, inner, line in info.lexical_pairs:
            pairs.setdefault((outer, inner), (info.module, line, 'lexical'))
            lexical_by_module.setdefault(id(info.module), set()).add(
                (outer, inner))
        for call, line, held in info.calls:
            if not held:
                continue
            target = graph.resolve(info.modname, info.class_name, call)
            if target is None:
                continue
            for inner in eventually.get(target, ()):
                for outer in held:
                    if outer != inner:
                        pairs.setdefault((outer, inner),
                                         (info.module, line, 'call'))
    findings = []
    reported = set()
    for (outer, inner), witness in sorted(pairs.items()):
        inverse = pairs.get((inner, outer))
        if inverse is None:
            continue
        key = frozenset((outer, inner))
        if key in reported:
            continue
        reported.add(key)
        if any((outer, inner) in s and (inner, outer) in s
               for s in lexical_by_module.values()):
            continue  # the per-module lexical scan owns this report
        module, line, kind = witness
        imodule, iline, ikind = inverse
        if kind != 'call' and ikind == 'call':
            # anchor at the witness only the call graph could see
            module, line, kind = imodule, iline, ikind
            imodule = witness[0]
            outer, inner = inner, outer
        # the inverse witness is named by PATH only: baselines match on
        # (path, rule, message) ignoring line numbers, and embedding the
        # witness's line here would resurrect baselined findings whenever
        # an unrelated edit shifts it
        how = ('through this call chain' if kind == 'call'
               else 'in this nesting')
        finding = module.finding(
            ORDER_RULE, line,
            'whole-program lock order: %s is taken before %s %s, but the '
            'opposite order holds in %s — lock-inversion deadlock hazard'
            % (outer, inner, how, imodule.relpath))
        if finding is not None:
            findings.append(finding)
    return findings
