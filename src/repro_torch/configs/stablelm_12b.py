"""stablelm-12b [dense] — GQA kv=8.
[hf:stabilityai/stablelm-2-1_6b (family); unverified]

40L, d_model=5120, 32 heads (kv=8), d_ff=13824, vocab=100352.
StableLM-2 family: partial rotary (25%), LayerNorm without biases on
projections; we keep rmsnorm=False→layernorm and partial RoPE.
"""
from repro_torch.config import ModelConfig
from repro_torch.configs.registry import register

CONFIG = register(ModelConfig(
    name="stablelm-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab_size=100352,
    rope_style="partial",
    rope_fraction=0.25,
    norm="layernorm",
    activation="silu",
    glu=True,
))
