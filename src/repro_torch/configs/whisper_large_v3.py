"""whisper-large-v3 [audio] — enc-dec, conv frontend STUB.
[arXiv:2212.04356; unverified]

32 encoder + 32 decoder layers, d_model=1280, 20 MHA heads (kv=20),
d_ff=5120, vocab=51866. Frontend (mel + 2x conv) is a stub: the batch
provides precomputed frame embeddings [B, 1500, 1280].

Deviations recorded: sinusoidal decoder positions instead of whisper's
448-entry learned table (needed for the 32k decode dry-run cells);
bias kept on q/k/v (whisper omits the k bias).
"""
from repro_torch.config import ModelConfig
from repro_torch.configs.registry import register

CONFIG = register(ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    num_layers=32,            # decoder layers
    encoder_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,          # MHA
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    encoder_seq=1500,
    encoder_feature_dim=1280,
    rope_style="none",
    norm="layernorm",
    activation="gelu",
    glu=False,
    use_bias=True,
    use_qkv_bias=True,
    tie_embeddings=True,
))
