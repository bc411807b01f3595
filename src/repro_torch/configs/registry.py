"""Architecture registry of the port: ``--arch <id>`` resolution and reduced
smoke configs, as in the JAX package's ``configs/registry.py``.

The port registers every architecture of the JAX package (the four dense
ones, the two mixture-of-experts ones, the encoder-decoder
whisper-large-v3, the vision-language llama-3.2-vision-11b, the hybrid
recurrentgemma-2b, the SSM falcon-mamba-7b, and the paper's logistic
regression), each module a field-for-field copy of the JAX package's.
``reduced_config`` shrinks one to a CPU-testable size of the same family
without changing the code path exercised.
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
        chatglm3_6b, command_r_plus_104b, deepseek_moe_16b, falcon_mamba_7b,
        gemma3_4b, llama32_vision_11b, paper_logreg, qwen3_moe_235b,
        recurrentgemma_2b, stablelm_12b, whisper_large_v3,
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
    """Same-family miniature for CPU tests (the JAX package's reduction)."""
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
    if cfg.family == "moe":
        kw.update(num_experts=8, experts_per_token=min(2, cfg.experts_per_token),
                  moe_d_ff=64,
                  num_shared_experts=cfg.num_shared_experts and 1,
                  first_dense_layers=min(1, cfg.first_dense_layers),
                  d_ff=0)
    if cfg.family == "encdec":
        kw.update(encoder_layers=2, encoder_seq=16, encoder_feature_dim=24)
    if cfg.family == "vlm":
        kw.update(num_layers=5, cross_attn_every=5, num_image_tokens=8,
                  image_embed_dim=48)
    if cfg.family == "hybrid":
        kw.update(num_layers=5, lru_width=128, num_heads=4, local_window=8)
    if cfg.family == "ssm":
        kw.update(num_layers=4, ssm_state=4, expand=2, dt_rank=8,
                  num_heads=1, num_kv_heads=1, head_dim=1, d_ff=0)
    if cfg.attn_pattern == "local_global":
        kw.update(local_window=8, global_every=min(3, cfg.global_every))
    if cfg.family == "logreg":
        kw = dict(num_features=64)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **kw)
