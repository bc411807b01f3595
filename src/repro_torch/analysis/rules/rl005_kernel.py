"""RL005 — the port's kernel modules are pure.

``src/repro_torch/kernels/*/kernel.py`` holds the ctypes launchers of the
CUDA kernels: each takes tensors its wrapper (``ops.py``) has checked,
packs their pointers and calls the entry of a library that
``kernels/_build.py`` built. They run once per launch, on the engine's
per-update path. Anything effectful there is either a debugging leftover
that prints per launch, or makes the launch depend on ambient process
state that neither the wrapper nor the runner cache's key can see
(environment sniffing: mode decisions live in `repro_torch.kernels.
dispatch` and the wrappers, which follow the tensor's device).

Flagged anywhere in a ``kernels/**/kernel.py`` file (the JAX package's
rule, by its names):

  * ``print(...)`` / ``breakpoint()``;
  * environment sniffing: ``os.environ``, ``os.getenv``,
    ``os.environ.get``;
  * file I/O: ``open(...)``.

And anywhere under ``kernels/`` but ``kernels/_build.py``, which alone
builds and loads the CUDA sources (nvcc into ``build/repro_torch/``,
rebuilt when a source's hash changes): building or loading code,
``subprocess.*``, ``ctypes.CDLL``, ``ctypes.cdll.LoadLibrary`` and
``torch.utils.cpp_extension.*``. A kernel module asks ``_build.library``
for its library, so every build goes through the one hash check.
"""
from __future__ import annotations

import ast
from pathlib import PurePath
from typing import List

from repro_torch.analysis.astutil import call_name, dotted_name
from repro_torch.analysis.diagnostics import Diagnostic

_BANNED_CALLS = {
    "print": "stray print runs on every launch",
    "breakpoint": "debugger hook in a kernel module",
    "open": "file I/O in a kernel module",
    "os.getenv": "env sniffing — mode decisions live in kernels/dispatch "
                 "and the wrappers, where the cache key sees them",
}
# os.environ covers os.environ.get/[...] via the attribute check
_BANNED_NAMES = {
    "os.environ": "env sniffing — mode decisions live in kernels/dispatch "
                  "and the wrappers, where the cache key sees them",
}
_BUILD_WHY = ("building or loading code outside kernels/_build.py — ask "
              "_build.library for the library, so every build goes through "
              "its hash check")
_BUILD_CALLS = {"ctypes.CDLL", "ctypes.cdll.LoadLibrary"}
_BUILD_PREFIXES = ("subprocess.", "torch.utils.cpp_extension.")


def _kernel_module(path: str) -> bool:
    p = PurePath(path)
    return p.name == "kernel.py" and "kernels" in p.parts


def _build_scope(path: str) -> bool:
    p = PurePath(path)
    return "kernels" in p.parts and p.name != "_build.py"


def _is_build(name: str) -> bool:
    return name in _BUILD_CALLS or name.startswith(_BUILD_PREFIXES)


def check(path: str, tree: ast.AST, source: str) -> List[Diagnostic]:
    kernel, build = _kernel_module(path), _build_scope(path)
    if not build:
        return []
    out: List[Diagnostic] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            name = call_name(node) or ""
            why = _BANNED_CALLS.get(name) if kernel else None
            if why is None and _is_build(name):
                why = _BUILD_WHY
            if why is not None:
                out.append(Diagnostic(
                    path, node.lineno, "RL005",
                    f"impure `{name}(...)` in a kernel module — {why}"))
        elif isinstance(node, ast.Attribute) and kernel:
            name = dotted_name(node)
            why = _BANNED_NAMES.get(name or "")
            if why is not None:
                out.append(Diagnostic(
                    path, node.lineno, "RL005",
                    f"impure `{name}` in a kernel module — {why}"))
    return out
