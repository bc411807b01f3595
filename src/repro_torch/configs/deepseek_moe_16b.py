"""deepseek-moe-16b [moe] — fine-grained: 2 shared + 64 routed, top-6.
[arXiv:2401.06066; hf]

28L, d_model=2048, 16 MHA heads (kv=16), per-expert d_ff=1408,
vocab=102400, first layer dense (d_ff defaults to
moe_d_ff*(top_k + shared) = 1408*8 = 11264 ≈ the published 10944).
"""
from repro_torch.config import ModelConfig
from repro_torch.configs.registry import register

CONFIG = register(ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,           # MHA
    head_dim=128,
    d_ff=0,                    # dense layer size derived (see module doc)
    vocab_size=102400,
    num_experts=64,
    experts_per_token=6,
    num_shared_experts=2,
    moe_d_ff=1408,
    first_dense_layers=1,
    norm="rmsnorm",
    activation="silu",
    glu=True,
))
