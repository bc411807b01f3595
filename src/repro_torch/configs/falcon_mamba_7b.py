"""falcon-mamba-7b [ssm] — attention-free Mamba-1.
[arXiv:2410.05355; unverified]

64L, d_model=4096 (d_inner=8192), ssm_state=16, conv=4, dt_rank=256,
vocab=65024. O(1) decode state.
"""
from repro_torch.config import ModelConfig
from repro_torch.configs.registry import register

CONFIG = register(ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=1,               # unused (attention-free)
    num_kv_heads=1,
    head_dim=1,
    d_ff=0,
    vocab_size=65024,
    ssm_state=16,
    d_conv=4,
    expand=2,
    dt_rank=256,
    rope_style="none",
    norm="rmsnorm",
))
