"""RL001 — batch-stable math in the port's stable scopes, mechanically.

The sweep engine runs C rows of a group in one batch and promises each
row the result it has run alone (`repro_torch.core.objective`, the note
above `_log1pexp`). A torch reduce over a named trailing dim, rounded from
float64, keeps that promise. A product that goes through cuBLAS does not:
cuBLAS picks its kernel, its split of the inner dimension and so its
reduction order by the operands' shapes, so a row of a [C, p] product may
round differently from the same row as a [1, p] product. A full reduction
with no dim reduces the batch axis too, so the rows no longer stand alone.

This checker enforces the contract inside the functions that carry it,
by the JAX package's names: any function named ``loss_fixed_order``,
ending in ``_stable`` or starting with ``_stable``, plus functions nested
inside them. Within that scope it flags

  * reduces that name no dim: ``torch.sum(x)``, ``np.sum(x)``,
    ``torch.sum(x, dim=None)`` and the method forms ``x.sum()``,
    ``x.mean()``, … (sum, mean, nansum, nanmean, std, var, prod,
    logsumexp). A dim counts when given as ``dim=`` (torch), ``axis=``
    (numpy) or positionally (``torch.sum(x, -1)``, ``x.sum(-1)``);
  * products whose order the library picks: ``@`` and ``matmul``, ``mm``,
    ``bmm``, ``mv``, ``dot``, ``vdot``, ``inner``, ``einsum``,
    ``tensordot``, ``trace``, ``norm`` (and ``torch.linalg.*norm``),
    ``addmm``, ``baddbmm``, as functions of ``torch``, ``torch.special``,
    ``torch.linalg``, ``torch.nn.functional``/``F`` or ``np``/``numpy``
    and as tensor methods, and ``F.linear`` — rewrite as a
    broadcast-multiply and a reduce over ``dim=-1`` (`_margins_stable`).

Python's builtin ``sum`` is a fixed-order left fold and is not flagged;
a function of another module with one argument (``math.prod(xs)``) reads
as a reduce with a positional dim and is not flagged either.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from repro_torch.analysis.astutil import FUNC_NODES, call_name, keyword
from repro_torch.analysis.diagnostics import Diagnostic

# reducers that keep rows apart ONLY with an explicit dim
_NEEDS_DIM = {"sum", "mean", "nansum", "nanmean", "std", "var", "prod",
              "logsumexp"}
# products whose reduction order the library picks by shape
_FORBIDDEN = {"matmul", "mm", "bmm", "mv", "dot", "vdot", "inner", "einsum",
              "tensordot", "trace", "norm", "addmm", "baddbmm"}
# module roots the functions are looked up on
_TENSOR_ROOTS = ("torch", "torch.special", "torch.linalg",
                 "torch.nn.functional", "F", "np", "numpy")


def _root_of(name: str) -> Optional[str]:
    """The module root of a dotted call name, or None for a method call."""
    root = name.rpartition(".")[0]
    return root if root in _TENSOR_ROOTS else None


def _in_scope(name: str) -> bool:
    return (name == "loss_fixed_order" or name.endswith("_stable")
            or name.startswith("_stable"))


def _names_a_dim(node: ast.Call, first_dim_arg: int) -> bool:
    for kw in ("dim", "axis"):
        value = keyword(node, kw)
        if value is not None:
            return not (isinstance(value, ast.Constant)
                        and value.value is None)
    return len(node.args) > first_dim_arg


def _order_unstable(attr: str, root: Optional[str]) -> bool:
    return (attr in _FORBIDDEN
            or (root == "torch.linalg" and attr.endswith("norm"))
            or (attr == "linear" and root in ("F", "torch.nn.functional")))


def _check_scope(path: str, fn: ast.AST, scope: str,
                 out: List[Diagnostic]) -> None:
    for node in ast.walk(fn):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
            out.append(Diagnostic(
                path, node.lineno, "RL001",
                f"`@` matmul inside batch-stable scope {scope!r} — cuBLAS "
                "picks its reduction order by shape, so a batched row may "
                "differ from the row alone; use a broadcast-multiply and a "
                "dim=-1 reduce (see _margins_stable)"))
            continue
        if not isinstance(node, ast.Call) or not isinstance(node.func,
                                                            ast.Attribute):
            continue
        name = call_name(node) or f"<expr>.{node.func.attr}"
        root = _root_of(name)
        attr = node.func.attr
        if _order_unstable(attr, root):
            out.append(Diagnostic(
                path, node.lineno, "RL001",
                f"order-unstable `{name}` inside batch-stable scope "
                f"{scope!r} — cuBLAS picks its reduction order by shape; "
                "use a broadcast-multiply and a dim=-1 reduce"))
        elif attr in _NEEDS_DIM and not _names_a_dim(
                node, 0 if root is None else 1):
            out.append(Diagnostic(
                path, node.lineno, "RL001",
                f"dim-less `{name}` inside batch-stable scope {scope!r} "
                "reduces every dim, the batch's too — name a trailing "
                "`dim=` (`axis=` for numpy)"))


def check(path: str, tree: ast.AST, source: str) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    # once inside a stable-named function, the whole subtree (nested defs
    # included) carries the contract
    for node in ast.walk(tree):
        if isinstance(node, FUNC_NODES) and _in_scope(node.name):
            _check_scope(path, node, node.name, out)
    return out
