"""Small logging and timing helpers (no external deps), the port of the JAX
package's ``utils/misc.py`` as far as the training slice uses it."""
from __future__ import annotations

import sys
import time


def log(msg: str) -> None:
    print(f"[repro_torch] {msg}", file=sys.stderr, flush=True)


class Timer:
    """Wall-clock timer context manager."""

    def __init__(self, name: str = ""):
        self.name = name
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False
