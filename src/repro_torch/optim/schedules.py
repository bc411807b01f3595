"""Learning-rate schedules (functions of the step counter), the port of the
JAX package's ``optim/schedules.py``.

The step may be a 0-d int32 device tensor (the train state's) or a Python
int; the rate comes back as a 0-d float32 tensor on the step's device,
computed there: the schedule never reads the step back to the host.
"""
from __future__ import annotations

import math

import torch

from repro_torch.config import TrainConfig


def make_schedule(cfg: TrainConfig):
    base = cfg.learning_rate
    warm = max(1, cfg.warmup_steps)
    total = max(cfg.steps, warm + 1)

    def schedule(step):
        step = torch.as_tensor(step).to(torch.float32)
        warmup = base * torch.clamp(step / warm, max=1.0)
        if cfg.schedule == "constant":
            return warmup
        frac = torch.clamp((step - warm) / max(1, total - warm), 0.0, 1.0)
        if cfg.schedule == "linear":
            decay = base * (1.0 - frac)
        else:  # cosine
            decay = base * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warm, warmup, decay)

    return schedule
