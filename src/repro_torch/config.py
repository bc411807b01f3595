"""Configuration the port's engines read: its own copy of the JAX package's
`SVRGConfig` (the port imports nothing of that package), without the fields
of the SPMD variant (`core/distributed.py`), which is not ported yet."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class SVRGConfig:
    """AsySVRG knobs (paper Algorithm 1).

    scheme:
      "consistent"    locked read+write (paper §4.1)
      "inconsistent"  lock-free read, locked write (paper §4.2, Eq. 10)
      "unlock"        fully lock-free (paper §5.2, AsySVRG-unlock)
    """
    scheme: str = "inconsistent"
    step_size: float = 0.1
    num_threads: int = 8          # p in the paper (simulated workers)
    tau: int = 0                  # bounded delay; 0 -> sequential SVRG
    inner_steps: int = 0          # M per thread; 0 -> 2n/p (paper §5.1)
    option: int = 2               # w_{t+1}: 1 = last iterate, 2 = average
