"""Small AST helpers shared by the checkers (stdlib-only: the linter runs
on an interpreter with nothing installed, so nothing under
repro_torch.analysis imports torch or numpy)."""
from __future__ import annotations

import ast
from typing import List, Optional, Tuple, Union

FunctionNode = Union[ast.FunctionDef, ast.AsyncFunctionDef]
FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


def dotted_name(node: ast.AST) -> Optional[str]:
    """'torch.sum' / 'torch.nn.functional.linear' for a Name/Attribute
    chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(node: ast.Call) -> Optional[str]:
    return dotted_name(node.func)


def keyword(node: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in node.keywords:
        if kw.arg == name:
            return kw.value
    return None


def positional_params(fn: FunctionNode) -> Tuple[str, ...]:
    """Positional(-or-keyword) parameter names: in an epoch core these are
    the tensors (kw-only params after ``*`` are the static config)."""
    args = fn.args
    return tuple(a.arg for a in args.posonlyargs + args.args
                 if a.arg not in ("self", "cls"))


def param_names(fn: FunctionNode) -> Tuple[str, ...]:
    args = fn.args
    names = [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]
    if args.vararg:
        names.append(args.vararg.arg)
    if args.kwarg:
        names.append(args.kwarg.arg)
    return tuple(names)


def is_self_attr(node: ast.AST, attr: Optional[str] = None) -> bool:
    """True for ``self.<attr>`` (any attr when ``attr`` is None)."""
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and (attr is None or node.attr == attr))
