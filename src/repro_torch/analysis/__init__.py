"""repro-lint for the port: AST-enforced house invariants of repro_torch.

``python -m repro_torch.analysis [paths]`` (default ``src/repro_torch``)
— the JAX package's checker (`python -m repro.analysis`), with its rule
codes, comment grammar and CLI, written for the port's torch idiom:

  RL001  batch-stable torch math in *_stable / loss_fixed_order scopes
  RL002  no Python branch on a tensor in *_epoch_core; hashable keys
  RL003  guarded-by lock discipline in the service/server/obs tier
  RL004  group/runner cache-key completeness (the buf_len bug class)
  RL005  ctypes kernel-module purity; builds only in kernels/_build.py
  RL006  obs boundary: no timing/tracing inside *_core or kernel modules
  RL000  suppression hygiene (reasons mandatory, stale ignores reported)

Per-line escapes: ``# repro-lint: ignore[RL004] <why it is fine>``; the
JAX linter reads the same comments and lints this tree too, so a finding
of one linter alone is fixed in the code, never suppressed. The package
is stdlib-only: importing it imports neither torch nor anything of JAX.
"""
from repro_torch.analysis.diagnostics import RULES, Diagnostic
from repro_torch.analysis.engine import LintResult, lint_paths, lint_source

__all__ = ["RULES", "Diagnostic", "LintResult", "lint_paths",
           "lint_source"]
