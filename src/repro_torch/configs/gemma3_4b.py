"""gemma3-4b [dense] — 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt (family); unverified]

34L, d_model=2560, 8 heads (kv=4), head_dim=256, d_ff=10240, vocab=262144.
Every 6th layer is global (pattern = 5 local : 1 global), local window 1024.
QK-norm on; logits softcap; tied embeddings (gemma family).

long_500k cell: SKIPPED — the global layers are full attention (quadratic);
recorded in DESIGN.md §5 / EXPERIMENTS.md.
Deviation: a single rope_theta is used (gemma3 uses 1M global / 10k local).
"""
from repro_torch.config import ModelConfig
from repro_torch.configs.registry import register

CONFIG = register(ModelConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    rope_theta=1_000_000.0,
    attn_pattern="local_global",
    local_window=1024,
    global_every=6,
    qk_norm=True,
    tie_embeddings=True,
    norm="rmsnorm",
    activation="gelu",
    glu=True,
))
