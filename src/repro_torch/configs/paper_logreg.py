"""The paper's own workload: L2-regularized logistic regression (paper §5).

Feature dim matches the hashed rcv1 synthesis (repro_torch.data.libsvm);
the factory builds its bundle (loss, inputs) but no serve or training path:
the paper's path is repro_torch.core.
"""
from repro_torch.config import ModelConfig
from repro_torch.configs.registry import register

CONFIG = register(ModelConfig(
    name="paper-logreg",
    family="logreg",
    num_layers=0,
    d_model=0,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=0,
    num_features=2048,
    l2_reg=1e-4,
))
