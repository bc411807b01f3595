"""qwen3-moe-235b-a22b [moe] — 128 experts, top-8.
[hf:Qwen/Qwen3-30B-A3B (family); hf]

94L, d_model=4096, 64 heads (kv=4), head_dim=128, per-expert d_ff=1536,
vocab=151936, 128 routed experts top-8, no shared experts, QK-norm.
~235B total / ~22B active — the roofline MODEL_FLOPS uses N_active.
"""
from repro_torch.config import ModelConfig
from repro_torch.configs.registry import register

CONFIG = register(ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=0,                    # all layers MoE
    vocab_size=151936,
    num_experts=128,
    experts_per_token=8,
    moe_d_ff=1536,
    qk_norm=True,
    norm="rmsnorm",
    activation="silu",
    glu=True,
))
