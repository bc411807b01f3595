"""Diagnostic records and the rule registry of the port's repro-lint.

Every checker reports `Diagnostic`s under a STABLE rule code (RL001…).
The codes keep the JAX package's linter's numbers and meanings, so one
suppression comment (`# repro-lint: ignore[RL004] reason`) serves both
linters and the docs (docs/INVARIANTS.md) key on the same identifier.
Codes are never reused; retired rules keep their number.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

# code -> one-line summary (the CLI's --explain output)
RULES: Dict[str, str] = {
    "RL000": "suppression hygiene: every `# repro-lint: ignore[...]` needs a "
             "reason and must actually suppress something",
    "RL001": "batch-stability: *_stable / loss_fixed_order scopes may only "
             "use elementwise torch ops and reduces that name their dim= "
             "(no matmul, mm, bmm, einsum, norm, F.linear: cuBLAS picks its "
             "reduction order by shape)",
    "RL002": "host-sync safety: *_epoch_core bodies must not branch in "
             "Python on a tensor parameter, and static/runner keys must be "
             "hashable",
    "RL003": "lock-discipline: attributes declared guarded-by a lock may "
             "only be touched while holding it",
    "RL004": "key-completeness: every static that shapes a group's runner "
             "must reach the group/runner cache keys",
    "RL005": "kernel purity: ctypes kernel modules are effect-free (no "
             "print/env/file I/O); building and loading code lives in "
             "kernels/_build.py",
    "RL006": "obs-boundary: no timing/tracing/metrics calls (repro_torch.obs, "
             "torch.cuda.Event/synchronize/nvtx, torch.profiler) inside "
             "*_core scopes or kernel modules — observability brackets "
             "launches, it never runs inside them",
}


@dataclasses.dataclass(frozen=True, order=True)
class Diagnostic:
    """One finding: ``path:line: code message`` (sortable in file order)."""
    path: str
    line: int
    code: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.code} {self.message}"
