"""Configuration the port reads: its own copies of the JAX package's
`ModelConfig`, `SVRGConfig`, `TrainConfig`, `ServeConfig` and
`HardwareSpec`, field for field with the same defaults (the port imports
nothing of that package), the H100's `HardwareSpec`, which the port's
roofline model uses by default, and the dry-run's input-shape grid
(`ShapeConfig`, `SHAPE_GRID`) and meshes (`MeshConfig`) with the JAX
package's values."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description, field for field the JAX package's. Families:

    - ``dense``   decoder-only transformer (GQA, RoPE, optional local/global)
    - ``moe``     dense + mixture-of-experts FFN (shared + routed experts)
    - ``encdec``  encoder-decoder (whisper-style; frontend stubbed)
    - ``vlm``     dense + interleaved cross-attention layers (image stub)
    - ``hybrid``  RG-LRU recurrent blocks + local attention (recurrentgemma)
    - ``ssm``     attention-free Mamba1 selective-SSM stack
    - ``logreg``  the paper's own workload (L2-regularized logistic regression)

    The port's model factory builds all but ``encdec`` and ``vlm`` so
    far.
    """

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention options ---
    rope_theta: float = 10000.0
    rope_style: str = "neox"          # "neox" | "partial" (chatglm 2d) | "none"
    rope_fraction: float = 1.0        # fraction of head_dim rotated
    attn_pattern: str = "global"      # "global" | "local_global" | "local"
    local_window: int = 4096
    global_every: int = 6             # gemma3: 1 global per 6 (5 local : 1 global)
    use_qkv_bias: bool = False
    use_bias: bool = False
    norm: str = "rmsnorm"             # "rmsnorm" | "layernorm"
    activation: str = "silu"          # "silu" | "gelu" | "geglu" | "relu"
    glu: bool = True                  # gated MLP (SwiGLU-style)
    tie_embeddings: bool = False
    logits_softcap: float = 0.0
    qk_norm: bool = False

    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                 # per-expert hidden size
    first_dense_layers: int = 0       # deepseek: layer 0 stays dense
    router_aux_loss: float = 0.001

    # --- encoder-decoder ---
    encoder_layers: int = 0
    encoder_seq: int = 0              # whisper: 1500 frames after conv stub
    encoder_feature_dim: int = 0      # stub input feature dim (mel bins x conv)

    # --- VLM cross-attention ---
    cross_attn_every: int = 0         # insert cross-attn layer every N layers
    num_image_tokens: int = 0
    image_embed_dim: int = 0

    # --- hybrid / SSM ---
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rec","rec","attn") repeated
    lru_width: int = 0                    # RG-LRU width (recurrentgemma)
    ssm_state: int = 0                    # mamba state dim N
    d_conv: int = 4
    expand: int = 2                       # mamba d_inner = expand*d_model
    dt_rank: int = 0                      # mamba dt rank (0 -> ceil(d_model/16))

    # --- logreg (paper workload) ---
    num_features: int = 0
    l2_reg: float = 1e-4

    # --- numerics / compilation ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "full"               # "none" | "full"
    scan_layers: bool = True

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def d_inner(self) -> int:
        """Mamba inner width."""
        return self.expand * self.d_model

    @property
    def dt_rank_actual(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def q_per_kv(self) -> int:
        return max(1, self.num_heads // max(1, self.num_kv_heads))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# Input shapes (the dry-run's grid)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524288, 1)

SHAPE_GRID: Dict[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


# ---------------------------------------------------------------------------
# Mesh
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def multi_pod(self) -> bool:
        return "pod" in self.axes


SINGLE_POD = MeshConfig((16, 16), ("data", "model"))
MULTI_POD = MeshConfig((2, 16, 16), ("pod", "data", "model"))
HOST_MESH = MeshConfig((1, 1), ("data", "model"))   # one device


@dataclass(frozen=True)
class SVRGConfig:
    """AsySVRG knobs (paper Algorithm 1 + the JAX package's SPMD adaptation).

    scheme:
      "consistent"    locked read+write (paper §4.1)
      "inconsistent"  lock-free read, locked write (paper §4.2, Eq. 10)
      "unlock"        fully lock-free (paper §5.2, AsySVRG-unlock)
    """
    scheme: str = "inconsistent"
    step_size: float = 0.1
    num_threads: int = 8          # p in the paper (simulated workers)
    tau: int = 0                  # bounded delay; 0 -> sequential SVRG
    inner_steps: int = 0          # M per thread; 0 -> 2n/p (paper §5.1)
    option: int = 2               # w_{t+1}: 1 = last iterate, 2 = average
    # SPMD distributed variant
    local_steps: int = 1          # H: reconcile every H inner steps (tau analogue)
    snapshot_every: int = 100     # refresh (w_snap, g_snap) every N steps
    snapshot_batches: int = 8     # reference batches accumulated per snapshot
    compression: str = "none"     # "none" | "topk" | "randk" | "int8"
    compression_k: float = 0.01   # fraction of coordinates kept
    error_feedback: bool = True


@dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    optimizer: str = "svrg"           # "svrg" | "sgd" | "momentum" | "adamw"
    microbatches: int = 1             # gradient-accumulation splits of the
                                      # global batch (activation peak ~ 1/mb)
    learning_rate: float = 3e-4
    warmup_steps: int = 10
    schedule: str = "cosine"          # "constant" | "cosine" | "linear"
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    seed: int = 0
    svrg: SVRGConfig = field(default_factory=SVRGConfig)
    # fault tolerance
    checkpoint_dir: str = ""
    checkpoint_every: int = 50
    keep_checkpoints: int = 3
    log_every: int = 10


@dataclass(frozen=True)
class ServeConfig:
    max_decode_steps: int = 32
    temperature: float = 0.0
    kv_cache_dtype: str = "bfloat16"


# ---------------------------------------------------------------------------
# Hardware constants for the roofline model (`repro_torch.launch.roofline`)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HardwareSpec:
    name: str = "tpu_v5e"
    peak_flops_bf16: float = 197e12       # FLOP/s per chip
    hbm_bandwidth: float = 819e9          # B/s per chip
    ici_bandwidth: float = 50e9           # B/s per link (~ per axis direction)
    hbm_bytes: float = 16e9               # capacity per chip


TPU_V5E = HardwareSpec()

# NVIDIA H100 SXM5, from NVIDIA's H100 Tensor Core GPU datasheet (SXM5
# column, dense rates without sparsity, at the 700 W limit): 3.35 TB/s of
# HBM3, 989 TFLOP/s dense bf16 on the tensor cores, 80 GB, NVLink 900 GB/s.
H100_SXM = HardwareSpec(name="h100_sxm", peak_flops_bf16=989e12,
                        hbm_bandwidth=3.35e12, ici_bandwidth=900e9,
                        hbm_bytes=80e9)
