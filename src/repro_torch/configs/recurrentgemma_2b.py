"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, pattern 2 rec : 1 attn.
[arXiv:2402.19427; hf]

26L (8 x (rec,rec,attn) + 2 rec), d_model=2560, 10 MQA heads (kv=1),
head_dim=256, d_ff=7680 (GeGLU), vocab=256000, lru_width=2560,
local window 2048. Constant-memory serving: a ring-buffer attention cache
of one window + O(1) recurrent state.
"""
from repro_torch.config import ModelConfig
from repro_torch.configs.registry import register

CONFIG = register(ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,            # MQA
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    lru_width=2560,
    attn_pattern="local",
    local_window=2048,
    tie_embeddings=True,
    norm="rmsnorm",
    activation="gelu",
    glu=True,
))
