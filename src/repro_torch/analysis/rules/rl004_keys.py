"""RL004 — key-completeness for the sweep grouping / runner cache.

The bug class this exists for is the ``buf_len`` incident: a new
static was added to ``_Resolved`` but not to the group key, so two specs
differing only in ``buf_len`` were batched into ONE group runner and
the second silently ran with the first's buffer bound. The same hazard
exists one layer down in ``service/cache.py``: a ``get_group_runner``
parameter that never reaches ``runner_key`` lets two different programs
alias one cache slot.

The checker is structural, anchored on the shapes that actually exist in
``repro_torch/core/sweep.py`` and ``repro_torch/service/cache.py`` (the
JAX package's, by the same names):

  1. Every field of the ``_Resolved`` NamedTuple must either appear as an
     ``r.<field>`` element of the group-key tuple built via
     ``groups.setdefault((...), ...)`` in ``plan_sweep``, or be packed
     into the per-row runtime arrays in ``_dispatch_group``
     (``resolved[c].<field>`` / ``specs[c].<field>``). A field that is
     neither keyed nor row-data can silently alias groups — exactly the
     buf_len failure. Fields that are genuinely derived/accounting-only
     are suppressed AT THE FIELD DECLARATION with a reason.

  2. Every parameter of ``get_group_runner`` must be forwarded into its
     ``runner_key(...)`` call, and every parameter of ``runner_key`` must
     be read somewhere in its body (an accepted-but-ignored key parameter
     is the cache-aliasing bug waiting to happen).

It activates by CONTENT, not path: any scanned file defining both
``class _Resolved`` and ``plan_sweep`` gets check 1 (so fixture trees in
tests exercise it); the cache file is found among the scanned set by it
defining both ``runner_key`` and ``get_group_runner``, falling back to
the on-disk sibling ``../service/cache.py`` of the sweep file when the
lint run was scoped to core/ only.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Optional, Sequence, Set

from repro_torch.analysis.astutil import FUNC_NODES, param_names
from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.analysis.files import SourceFile, load_file


def _find_class(tree: ast.AST, name: str) -> Optional[ast.ClassDef]:
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == name:
            return node
    return None


def _find_func(tree: ast.AST, name: str):
    for node in ast.walk(tree):
        if isinstance(node, FUNC_NODES) and node.name == name:
            return node
    return None


def _resolved_fields(cls: ast.ClassDef) -> List[ast.AnnAssign]:
    return [stmt for stmt in cls.body
            if isinstance(stmt, ast.AnnAssign)
            and isinstance(stmt.target, ast.Name)]


def _group_key_attrs(plan: ast.AST) -> Set[str]:
    """Attribute names used in the tuple handed to groups.setdefault()."""
    attrs: Set[str] = set()
    for node in ast.walk(plan):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "setdefault" and node.args
                and isinstance(node.args[0], ast.Tuple)):
            for el in node.args[0].elts:
                if isinstance(el, ast.Attribute):
                    attrs.add(el.attr)
    return attrs


def _packed_attrs(dispatch: ast.AST) -> Set[str]:
    """Fields read off subscripted rows (resolved[c].tau, specs[c].seed) —
    the per-row runtime arrays."""
    attrs: Set[str] = set()
    for node in ast.walk(dispatch):
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Subscript)):
            attrs.add(node.attr)
    return attrs


def _names_read(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}


def _check_sweep(sf: SourceFile, out: List[Diagnostic]) -> None:
    cls = _find_class(sf.tree, "_Resolved")
    plan = _find_func(sf.tree, "plan_sweep")
    if cls is None or plan is None:
        return
    keyed = _group_key_attrs(plan)
    if not keyed:
        out.append(Diagnostic(
            sf.path, plan.lineno, "RL004",
            "plan_sweep builds no groups.setdefault((...)) key tuple — "
            "the group-key anchor RL004 checks against is gone; restore "
            "it or update the checker"))
        return
    dispatch = _find_func(sf.tree, "_dispatch_group")
    packed = _packed_attrs(dispatch) if dispatch is not None else set()
    for field in _resolved_fields(cls):
        name = field.target.id
        if name not in keyed and name not in packed:
            out.append(Diagnostic(
                sf.path, field.lineno, "RL004",
                f"_Resolved.{name} reaches neither the plan_sweep group "
                "key nor _dispatch_group's per-row runtime arrays — specs "
                f"differing only in {name!r} would alias one group "
                "runner (the buf_len bug); key it, pack it, or "
                "suppress here with the derivation argument"))


def _check_cache(sf: SourceFile, out: List[Diagnostic]) -> None:
    key_fn = _find_func(sf.tree, "runner_key")
    getter = _find_func(sf.tree, "get_group_runner")
    if key_fn is None or getter is None:
        return
    # runner_key: every accepted parameter must be read in the body
    read = set()
    for stmt in key_fn.body:
        read |= _names_read(stmt)
    for name in param_names(key_fn):
        if name not in read:
            out.append(Diagnostic(
                sf.path, key_fn.lineno, "RL004",
                f"runner_key accepts {name!r} but never reads it — the "
                "parameter does not reach the cache key, so programs "
                f"differing in {name!r} alias one runner"))
    # get_group_runner: every parameter forwarded into runner_key(...)
    call = None
    for node in ast.walk(getter):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "runner_key"):
            call = node
            break
    if call is None:
        out.append(Diagnostic(
            sf.path, getter.lineno, "RL004",
            "get_group_runner never calls runner_key — the runner lookup "
            "is not keyed"))
        return
    forwarded: Set[str] = set()
    for arg in call.args:
        forwarded |= _names_read(arg)
    for kw in call.keywords:
        forwarded |= _names_read(kw.value)
    for name in param_names(getter):
        if name not in forwarded:
            out.append(Diagnostic(
                sf.path, call.lineno, "RL004",
                f"get_group_runner parameter {name!r} is not forwarded "
                "into runner_key(...) — two calls differing only in "
                f"{name!r} would fetch the same cached runner"))


def _is_sweep_file(sf: SourceFile) -> bool:
    return (_find_class(sf.tree, "_Resolved") is not None
            and _find_func(sf.tree, "plan_sweep") is not None)


def _is_cache_file(sf: SourceFile) -> bool:
    return (_find_func(sf.tree, "runner_key") is not None
            and _find_func(sf.tree, "get_group_runner") is not None)


def check_project(files: Sequence[SourceFile]) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    cache_seen = False
    sweep_file: Optional[SourceFile] = None
    for sf in files:
        if _is_sweep_file(sf):
            sweep_file = sf
            _check_sweep(sf, out)
        if _is_cache_file(sf):
            cache_seen = True
            _check_cache(sf, out)
    if not cache_seen and sweep_file is not None:
        # lint run scoped to core/ — pull the sibling cache module from disk
        sibling = (Path(sweep_file.path).resolve().parent.parent
                   / "service" / "cache.py")
        if sibling.is_file():
            sf = load_file(sibling)
            if sf is not None and _is_cache_file(sf):
                _check_cache(sf, out)
    return out
