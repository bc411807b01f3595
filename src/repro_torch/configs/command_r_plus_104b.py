"""command-r-plus-104b [dense] — GQA kv=8, no biases.
[hf:CohereForAI/c4ai-command-r-v01 (family); unverified]

64L, d_model=12288, 96 heads (kv=8), d_ff=33792, vocab=256000.
Cohere family: tied embeddings, layernorm, no biases anywhere.
The largest dense arch in the pool — the FSDP x TP 2D weight sharding
exists to fit this one (plus SVRG snapshot state) in 16 GB/chip.
"""
from repro_torch.config import ModelConfig
from repro_torch.configs.registry import register

CONFIG = register(ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab_size=256000,
    rope_theta=75_000_000.0,
    norm="layernorm",
    activation="silu",
    glu=True,
    tie_embeddings=True,
))
