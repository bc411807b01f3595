"""RL003 — lock discipline, guarded-by style (the JAX package's rule,
unchanged, over the port's annotations: ``server/daemon.py``,
``server/fairness.py``, ``service/api.py`` and ``obs/*``).

The service/server tier shares mutable state between HTTP handler
threads, the flush daemon, and callers of ``flush_now()``. The house
pattern is coarse: one ``threading.RLock`` per object, every touch of
shared state inside ``with self._lock``. This checker makes the pattern
declarative and machine-enforced:

  * Declare guards either with a class-level mapping::

        _GUARDED_BY = {"_pending": "_lock", "stats": "_lock"}

    or inline, on the attribute's ``__init__`` assignment::

        self.stats = DaemonStats()  # guarded-by: _lock

  * Every ``self.<attr>`` access (read or write) of a declared attribute
    must then happen lexically inside ``with self._lock:`` — or inside a
    method annotated ``# holds: _lock`` on its ``def`` line, which
    asserts every caller already holds the lock.

  * ``threading.Condition(self._lock)`` aliases are understood:
    ``with self._done_cv:`` counts as holding ``_lock``.

  * ``__init__`` is exempt (the object is not yet shared), and nested
    functions restart with an empty held-set (a closure outlives the
    ``with`` block it was created in).

This is lexical, not a race detector: it cannot see aliasing through
locals (``s = self.stats``) or cross-object locking. It exists to catch
the easy, common mistake — the unlocked ``self.stats.x += 1`` hot-path
increment — mechanically, in CI, before a code review has to.
"""
from __future__ import annotations

import ast
from typing import Dict, FrozenSet, List, Optional, Tuple

from repro_torch.analysis.astutil import FUNC_NODES, call_name, is_self_attr
from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.analysis.suppress import Comments, scan_comments


def _parse_guard_map(cls: ast.ClassDef) -> Dict[str, str]:
    """Class-level ``_GUARDED_BY = {"attr": "_lock", ...}`` declarations."""
    out: Dict[str, str] = {}
    for stmt in cls.body:
        if (isinstance(stmt, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "_GUARDED_BY"
                        for t in stmt.targets)
                and isinstance(stmt.value, ast.Dict)):
            for k, v in zip(stmt.value.keys, stmt.value.values):
                if (isinstance(k, ast.Constant) and isinstance(k.value, str)
                        and isinstance(v, ast.Constant)
                        and isinstance(v.value, str)):
                    out[k.value] = v.value
    return out


def _init_of(cls: ast.ClassDef) -> Optional[ast.FunctionDef]:
    for stmt in cls.body:
        if isinstance(stmt, FUNC_NODES) and stmt.name == "__init__":
            return stmt
    return None


def _comment_guards(init: ast.FunctionDef,
                    comments: Comments) -> Dict[str, str]:
    """``self.x = ...  # guarded-by: _lock`` assignments in __init__."""
    out: Dict[str, str] = {}
    for stmt in ast.walk(init):
        if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            continue
        locks = comments.guarded_by.get(stmt.lineno)
        if not locks:
            continue
        targets = (stmt.targets if isinstance(stmt, ast.Assign)
                   else [stmt.target])
        for tgt in targets:
            if is_self_attr(tgt):
                out[tgt.attr] = locks[0]
    return out


def _condition_aliases(init: ast.FunctionDef) -> Dict[str, str]:
    """``self._done_cv = threading.Condition(self._lock)`` → cv aliases
    the lock: holding the Condition IS holding the lock."""
    out: Dict[str, str] = {}
    for stmt in ast.walk(init):
        if not isinstance(stmt, ast.Assign):
            continue
        val = stmt.value
        if (isinstance(val, ast.Call)
                and call_name(val) in ("threading.Condition", "Condition")
                and val.args and is_self_attr(val.args[0])):
            lock = val.args[0].attr
            for tgt in stmt.targets:
                if is_self_attr(tgt):
                    out[tgt.attr] = lock
    return out


def _held_locks(expr: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    """Canonical lock name acquired by a ``with`` context expr, if any."""
    if is_self_attr(expr):
        return aliases.get(expr.attr, expr.attr)
    return None


def _holds_annotation(fn: ast.AST, comments: Comments) -> Tuple[str, ...]:
    """Locks asserted held on entry (``# holds: _lock`` on the def line
    or anywhere in a multi-line signature)."""
    first_body = fn.body[0].lineno if fn.body else fn.lineno
    locks: List[str] = []
    for line in range(fn.lineno, first_body + 1):
        locks.extend(comments.holds.get(line, ()))
    return tuple(locks)


def _walk(node: ast.AST, held: FrozenSet[str], guards: Dict[str, str],
          aliases: Dict[str, str], method: str, path: str,
          out: List[Diagnostic]) -> None:
    if isinstance(node, (ast.With, ast.AsyncWith)):
        acquired = set(held)
        for item in node.items:
            lock = _held_locks(item.context_expr, aliases)
            if lock is not None:
                acquired.add(lock)
        for stmt in node.body:
            _walk(stmt, frozenset(acquired), guards, aliases, method, path,
                  out)
        return
    if isinstance(node, FUNC_NODES + (ast.Lambda,)):
        # a nested function may run after the with-block exits
        body = node.body if isinstance(node.body, list) else [node.body]
        for stmt in body:
            _walk(stmt, frozenset(), guards, aliases, method, path, out)
        return
    if is_self_attr(node):
        attr = node.attr
        lock = guards.get(attr)
        if lock is not None and lock not in held:
            out.append(Diagnostic(
                path, node.lineno, "RL003",
                f"`self.{attr}` is guarded by `{lock}` but accessed in "
                f"{method!r} without holding it — wrap in `with "
                f"self.{lock}:` or annotate the method `# holds: {lock}`"))
    for child in ast.iter_child_nodes(node):
        _walk(child, held, guards, aliases, method, path, out)


def check(path: str, tree: ast.AST, source: str) -> List[Diagnostic]:
    comments = scan_comments(source)
    out: List[Diagnostic] = []
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        guards = _parse_guard_map(cls)
        init = _init_of(cls)
        aliases: Dict[str, str] = {}
        if init is not None:
            guards.update(_comment_guards(init, comments))
            aliases = _condition_aliases(init)
        if not guards:
            continue
        for fn in cls.body:
            if not isinstance(fn, FUNC_NODES) or fn.name == "__init__":
                continue
            held = frozenset(aliases.get(name, name)
                             for name in _holds_annotation(fn, comments))
            for stmt in fn.body:
                _walk(stmt, held, guards, aliases, fn.name, path, out)
    return out
