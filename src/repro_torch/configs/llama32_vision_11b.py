"""llama-3.2-vision-11b [vlm] — cross-attn image layers every 5th layer.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

40L total = 32 self + 8 cross-attention layers (hf indices 3,8,...,38),
d_model=4096, 32 heads (kv=8), d_ff=14336, vocab=128256. Vision tower is a
STUB: the batch supplies precomputed patch embeddings [B, 1601, 1280]; a
learned projector maps them to d_model. Cross layers are tanh-gated (gates
init 0).
"""
from repro_torch.config import ModelConfig
from repro_torch.configs.registry import register

CONFIG = register(ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500_000.0,
    cross_attn_every=5,
    num_image_tokens=1601,
    image_embed_dim=1280,
    norm="rmsnorm",
    activation="silu",
    glu=True,
))
