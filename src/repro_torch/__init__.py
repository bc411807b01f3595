"""PyTorch + CUDA port of the AsySVRG reproduction (`repro`), for an NVIDIA
H100. It mirrors the JAX package's module layout, imports nothing of it,
and runs on the card unless the caller passes ``device="cpu"``."""
from repro_torch.core import (
    AsyRunResult,
    LogisticRegression,
    Objective,
    SweepSpec,
    make_grid,
    plan_sweep,
    run_asysvrg,
    run_hogwild,
    run_svrg,
    run_sweep,
)

__all__ = ["AsyRunResult", "LogisticRegression", "Objective", "SweepSpec",
           "make_grid", "plan_sweep", "run_asysvrg", "run_hogwild",
           "run_svrg", "run_sweep"]
