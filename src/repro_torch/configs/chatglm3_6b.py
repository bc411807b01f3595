"""chatglm3-6b [dense] — RoPE 2d (partial rotary), GQA kv=2, qkv bias.
[arXiv:2406.12793; hf]

28L, d_model=4096, 32 heads (kv=2), d_ff=13696, vocab=65024.
ChatGLM applies rotary to half the head dims ("2d RoPE") and uses bias on
the QKV projection only; SwiGLU MLP; RMSNorm.
"""
from repro_torch.config import ModelConfig
from repro_torch.configs.registry import register

CONFIG = register(ModelConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    rope_style="partial",
    rope_fraction=0.5,
    use_qkv_bias=True,
    norm="rmsnorm",
    activation="silu",
    glu=True,
))
