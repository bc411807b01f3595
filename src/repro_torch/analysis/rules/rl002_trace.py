"""RL002 — host-sync safety of the epoch cores, and hashable cache keys.

Two failure modes the runner-cache architecture forbids:

  1. **Python ``if``/``while`` on a tensor parameter.** In the epoch
     cores the house convention is positional params = tensors (the
     iterates, keys, step sizes of C rows), kw-only params (after ``*``)
     = static config. A Python conditional on a positional param reads a
     tensor's value on the host: on a CUDA tensor that is a hidden
     device-to-host sync in the middle of the epoch, and under
     `torch.func.vmap` it is an error. Scope: functions named
     ``*_epoch_core`` / ``*_epochs_core``. Shape/dtype probes
     (``x.shape``, ``x.ndim``, ``x.dtype``, ``x.size``, ``len(x)``,
     ``isinstance(x, …)``) read no value and are exempt.

  2. **Unhashable static keys.** ``static_key`` / ``runner_static_key`` /
     ``runner_key`` feed dict-key material for the runner cache; a list /
     dict / set / bare ``sorted(...)`` in the return value raises
     TypeError only on the cache path, far from the author. Wrapping in
     ``tuple(...)`` or ``frozenset(...)`` is the sanctioned fix and is
     recognized.

The JAX package's rule has a third part, array closures in lambdas
handed to ``jax.jit`` / ``pl.pallas_call``, and scopes every
``@jax.jit`` function. Both are left out here: the port has no jit and
no tracing cache, so a captured tensor has no cache entry to key or pin.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from repro_torch.analysis.astutil import (
    FUNC_NODES,
    call_name,
    positional_params,
)
from repro_torch.analysis.diagnostics import Diagnostic

_CORE_SUFFIXES = ("_epoch_core", "_epochs_core")
_SHAPE_ATTRS = {"shape", "ndim", "dtype", "size"}
_STATIC_PROBES = {"len", "isinstance"}
_KEY_FUNCS = {"static_key", "runner_static_key", "runner_key"}
_UNHASHABLE_CALLS = {"list", "dict", "set", "sorted"}
_UNHASHABLE_NODES = (ast.List, ast.Dict, ast.Set, ast.ListComp,
                     ast.DictComp, ast.SetComp, ast.GeneratorExp)


def _tensor_refs(node: ast.AST, tensors: set) -> List[ast.Name]:
    """Tensor-name loads in a conditional's test, pruning static probes
    (.shape/.ndim/.dtype/.size, len(), isinstance())."""
    if isinstance(node, ast.Attribute) and node.attr in _SHAPE_ATTRS:
        return []
    if isinstance(node, ast.Call):
        name = call_name(node)
        if name in _STATIC_PROBES:
            return []
    refs: List[ast.Name] = []
    if (isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load)
            and node.id in tensors):
        refs.append(node)
    for child in ast.iter_child_nodes(node):
        refs.extend(_tensor_refs(child, tensors))
    return refs


def _find_unhashable(node: ast.AST) -> Optional[ast.AST]:
    if isinstance(node, ast.Call):
        name = call_name(node)
        if name in ("tuple", "frozenset") and len(node.args) == 1:
            return None  # explicit conversion to a hashable container
        if name in _UNHASHABLE_CALLS:
            return node
    if isinstance(node, _UNHASHABLE_NODES):
        return node
    for child in ast.iter_child_nodes(node):
        hit = _find_unhashable(child)
        if hit is not None:
            return hit
    return None


def check(path: str, tree: ast.AST, source: str) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    for node in ast.walk(tree):
        if not isinstance(node, FUNC_NODES):
            continue
        # 1. python control flow on tensor params in the epoch cores
        if node.name.endswith(_CORE_SUFFIXES):
            tensors = set(positional_params(node))
            for sub in ast.walk(node):
                if tensors and isinstance(sub, (ast.If, ast.While)):
                    for ref in _tensor_refs(sub.test, tensors):
                        out.append(Diagnostic(
                            path, sub.lineno, "RL002",
                            f"Python `{type(sub).__name__.lower()}` on "
                            f"tensor param {ref.id!r} in epoch core "
                            f"{node.name!r} — positional params are "
                            "tensors (statics go after `*`); a branch on "
                            "one syncs the card and fails under vmap; use "
                            "torch.where or make it kw-only"))
                        break

        # 2. unhashable values returned from cache-key functions
        if node.name in _KEY_FUNCS:
            for sub in ast.walk(node):
                if isinstance(sub, ast.Return) and sub.value is not None:
                    hit = _find_unhashable(sub.value)
                    if hit is not None:
                        out.append(Diagnostic(
                            path, sub.lineno, "RL002",
                            f"{node.name}() returns an unhashable "
                            "container — cache keys must be hashable; "
                            "wrap in tuple(...)/frozenset(...)"))
    return out
