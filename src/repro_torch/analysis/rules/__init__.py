"""The port's repro-lint checkers, one module per rule code."""
from repro_torch.analysis.rules import (  # noqa: F401
    rl001_stability,
    rl002_trace,
    rl003_locks,
    rl004_keys,
    rl005_kernel,
    rl006_obs,
)

FILE_CHECKERS = (
    rl001_stability.check,
    rl002_trace.check,
    rl003_locks.check,
    rl005_kernel.check,
    rl006_obs.check,
)

PROJECT_CHECKERS = (
    rl004_keys.check_project,
)
