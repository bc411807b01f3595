"""Architecture registry of the port: ``--arch <id>`` resolution and reduced
smoke configs, as in the JAX package's ``configs/registry.py``.

The port registers the four dense architectures its model factory builds,
each module a field-for-field copy of the JAX package's. ``reduced_config``
shrinks one to a CPU-testable size of the same family without changing the
code path exercised.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.config import ModelConfig

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def _ensure_loaded():
    from repro_torch.configs import (  # noqa: F401
        chatglm3_6b, command_r_plus_104b, gemma3_4b, stablelm_12b,
    )


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> List[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def reduced_config(name: str) -> ModelConfig:
    """Same-family miniature for CPU tests (the JAX package's reduction for
    the dense family)."""
    cfg = get_config(name)
    kw = dict(
        num_layers=min(cfg.num_layers, 4),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(4, max(1, cfg.num_kv_heads)),
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        dtype="float32",
        param_dtype="float32",
        remat="none",
    )
    if cfg.attn_pattern == "local_global":
        kw.update(local_window=8, global_every=min(3, cfg.global_every))
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **kw)
