"""The ParamDef system of the JAX package's ``sharding/rules.py``: models
declare parameters as shape + logical axis names + initializer, and
`init_from_defs` draws them.

Only `ParamDef` and `init_from_defs` are ported. The logical-axis to mesh
mapping waits for the sharding slice, and the JAX package's ``constrain``
calls are identities on one card, so the port's models drop them.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.utils.tree import tree_map


class ParamDef(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]      # logical axis name per dim (None = replicated)
    init: str = "normal"                 # normal | zeros | ones | scaled | embed
    scale: float = 1.0
    dtype: str = "float32"

    def __repr__(self):  # compact for debugging
        return f"ParamDef({self.shape}, {self.axes}, {self.init})"


def is_param_def(x) -> bool:
    return isinstance(x, ParamDef)


def _init_one(gen: torch.Generator, d: ParamDef) -> torch.Tensor:
    dt = getattr(torch, d.dtype)
    device = gen.device
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dt, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dt, device=device)
    # scaled in place, then cast: the bits of ``(normal * scale).to(dt)``
    # with one float32 buffer of the leaf's size fewer (deepseek-moe-16b's
    # expert leaves are 19.9 GB each in float32)
    normal = torch.randn(d.shape, generator=gen, device=device)
    if d.init == "normal":
        # fan_in is shape[0], which is the layer count L for stacked layer
        # weights: the JAX package's rule, kept as it is
        fan_in = d.shape[0] if d.shape else 1
        return normal.mul_(d.scale / math.sqrt(max(1, fan_in))).to(dt)
    if d.init in ("embed", "scaled"):
        return normal.mul_(d.scale).to(dt)
    raise ValueError(f"unknown init {d.init}")


def init_from_defs(gen: torch.Generator, defs):
    """Draw every ParamDef of a nested dict, in the JAX package's tree order,
    from ``gen`` on its device (a seeded ``torch.Generator``; the numbers
    differ from ``jax.random``'s, the rules do not)."""
    return tree_map(lambda d: _init_one(gen, d), defs, is_leaf=is_param_def)
