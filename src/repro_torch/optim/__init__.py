"""Optimizers over param trees and learning-rate schedules, the port of the
JAX package's ``optim/``."""
from repro_torch.optim.optimizers import (
    Optimizer,
    clip_by_global_norm,
    make_optimizer,
)
from repro_torch.optim.schedules import make_schedule

__all__ = ["Optimizer", "make_optimizer", "clip_by_global_norm",
           "make_schedule"]
