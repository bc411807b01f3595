"""PyTorch + CUDA port of the AsySVRG reproduction (`repro`), for an NVIDIA
H100. It mirrors the JAX package's module layout, imports nothing of it,
and runs on the card unless the caller passes ``device="cpu"``.

The package's names resolve on first use (PEP 562): importing
``repro_torch`` alone imports no torch, so the stdlib-only linter
``repro_torch.analysis`` runs on a bare interpreter.
"""
import importlib

__all__ = ["AsyRunResult", "LogisticRegression", "Objective", "SweepSpec",
           "make_grid", "plan_sweep", "run_asysvrg", "run_hogwild",
           "run_svrg", "run_sweep"]


def __getattr__(name):
    if name in __all__:
        value = getattr(importlib.import_module("repro_torch.core"), name)
    else:
        try:
            value = importlib.import_module(f"repro_torch.{name}")
        except ModuleNotFoundError as e:
            if e.name != f"repro_torch.{name}":
                raise
            raise AttributeError(
                f"module 'repro_torch' has no attribute {name!r}") from None
    globals()[name] = value
    return value
