"""Attention-free SSM family (falcon-mamba-7b, Mamba-1 architecture), the
port of the JAX package's ``models/mamba.py``.

Per layer: in_proj → (x, z); x → causal depthwise conv(4) → SiLU → selective
SSM → ⊙ SiLU(z) → out_proj. The selective scan is computed CHUNKED: within
a chunk of at most CHUNK positions the associative scan
(`rglru.scan`) gives the prefix states and the chunk's transition
products, and the state is carried across chunks in order, as the JAX
package's ``lax.scan`` does, so the float32 [B, chunk, d_inner, N]
tensors are the largest transients.

Decode is the same block at S = 1 on a [B, d_inner, N] state: O(1) in the
sequence length, position-free. There is no attention and no kernel of
the repo on this path.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.models import layers as nn
from repro_torch.models import transformer as tf
from repro_torch.models.rglru import _causal_conv, chunked, scan, softplus
from repro_torch.sharding.context import (chunk_last, constrain,
                                         propagate_back, rows_matmul, settle,
                                         write)
from repro_torch.sharding.rules import ParamDef

CHUNK = 256
SCAN_AXES = ("batch", None, "mlp")   # a scan chunk's logical axes [B, C, Di]
# channel sharding over the `model` mesh axis through the "mlp" rule
RESIDUAL_AXES = ("batch", None, "mlp")


def param_defs(cfg: ModelConfig) -> Dict:
    dt = cfg.param_dtype
    L, D, V = cfg.num_layers, cfg.d_model, cfg.vocab_size
    Di, N, R = cfg.d_inner, cfg.ssm_state, cfg.dt_rank_actual
    blocks = {
        "norm": tf._norm_defs((L, D), cfg, dt),
        "in_proj": ParamDef((L, D, 2 * Di), ("layers", "embed", "mlp"), dtype=dt),
        "conv_w": ParamDef((L, 4, Di), ("layers", "conv", "mlp"), "scaled", scale=0.2, dtype=dt),
        "conv_b": ParamDef((L, Di), ("layers", "mlp"), "zeros", dtype=dt),
        "x_proj": ParamDef((L, Di, R + 2 * N), ("layers", "mlp", None), dtype=dt),
        "dt_proj": ParamDef((L, R, Di), ("layers", None, "mlp"), "scaled", scale=0.1, dtype=dt),
        "dt_bias": ParamDef((L, Di), ("layers", "mlp"), "ones", dtype=dt),
        "A_log": ParamDef((L, Di, N), ("layers", "mlp", "state"), "ones", dtype=dt),
        "D_skip": ParamDef((L, Di), ("layers", "mlp"), "ones", dtype=dt),
        "out_proj": ParamDef((L, Di, D), ("layers", "mlp", "embed"), dtype=dt),
    }
    p = {
        "tok_embed": ParamDef((V, D), ("vocab", None), "embed", scale=0.02, dtype=dt),
        "blocks": blocks,
        "final_norm": tf._norm_defs((D,), cfg, dt),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = ParamDef((V, D), ("vocab", None), "embed", scale=0.02, dtype=dt)
    return p


# ---------------------------------------------------------------------------
# Selective scan
# ---------------------------------------------------------------------------

def _ssm_params(x, lp: Dict, cfg: ModelConfig):
    """x [B,S,Di] (post-conv) -> (dA [B,S,Di,N], dBx [B,S,Di,N], C [B,S,N]).
    dt and the product dt·x in x's dtype, then float32, as the JAX
    package's."""
    N, R = cfg.ssm_state, cfg.dt_rank_actual
    # the contraction runs over the channels, sharded over `model` under a
    # mesh: its pending sum is reduced here, before dt, B and C share it
    proj = settle(x.matmul(lp["x_proj"]))
    dtr, Bc, Cc = torch.split(proj, [R, N, N], dim=-1)
    dt = softplus(dtr.matmul(lp["dt_proj"]) + lp["dt_bias"])
    A = -torch.exp(lp["A_log"].to(torch.float32))               # [Di,N]
    dA = torch.exp(dt.to(torch.float32)[..., None] * A)         # [B,S,Di,N]
    dBx = (dt * x).to(torch.float32)[..., None] \
        * Bc.to(torch.float32)[:, :, None, :]
    return dA, dBx, Cc


def selective_scan(x, lp: Dict, cfg: ModelConfig, h0=None):
    """Chunked selective scan. x [B,S,Di] -> (y [B,S,Di] in x's dtype,
    h_last [B,Di,N] float32).

    The SSM parameters (dA, dBx, C) are computed per chunk inside the
    chunk's body, so no [B, S, Di, N] tensor is ever made (4.3 GB per
    layer in float32 at falcon-mamba's width, batch 4, 2048 tokens).
    Channels shard over `model` under a mesh (constrained here)."""
    B, S, Di = x.shape
    if h0 is None:
        h0 = torch.zeros((B, Di, cfg.ssm_state), dtype=torch.float32,
                         device=x.device)

    def chunk_body(h_prev, x_c):
        x_c = constrain(x_c, SCAN_AXES)
        dA, dBx, C = _ssm_params(x_c, lp, cfg)
        P, Ss = scan(dA, dBx)
        hs = Ss + P * h_prev[:, None, :, :]        # states at every position
        y = torch.einsum("bsdn,bsn->bsd", hs, C.to(torch.float32))
        # the last state copied: a view would keep the chunk's hs alive
        return hs[:, -1, :, :].clone(), y.to(x_c.dtype)

    h_last, y = chunked(chunk_body, h0, (x,), S, CHUNK)
    return y, h_last


def _mamba_block(cfg: ModelConfig, lp: Dict, h, conv_state=None,
                 ssm_state=None):
    """Returns (h_out, (new_conv_state, new_ssm_state))."""
    x = nn.apply_norm(cfg, h, lp["norm"])
    xb, z = chunk_last(rows_matmul(x, lp["in_proj"]), 2)
    # the scan's input and the gate on the channels' sharding, the layout of
    # the scan's chunks (`selective_scan`): XLA carries that layout back to
    # them, `DTensor` does not, and without it every chunk (and its gradient)
    # gathers the whole [B, S, Di] over `model`
    z = propagate_back(z, SCAN_AXES)
    xb, new_conv = _causal_conv(xb, lp["conv_w"], lp["conv_b"], conv_state)
    xb = propagate_back(F.silu(xb), SCAN_AXES)
    y, h_last = selective_scan(xb, lp, cfg, h0=ssm_state)
    y = y + lp["D_skip"] * xb
    y = y * F.silu(z)
    return h + rows_matmul(y, lp["out_proj"]), (new_conv, h_last)


def _layer_block(cfg: ModelConfig, lp: Dict, h):
    """`_mamba_block` with the residual placed on the mesh on both sides."""
    h = constrain(h, RESIDUAL_AXES)
    out, st = _mamba_block(cfg, lp, h)
    # constrain the OUTPUT too: the backward pass keeps each layer's
    # output, which an unconstrained one would keep replicated on D
    return constrain(out, RESIDUAL_AXES), st


def _train_block(cfg: ModelConfig, lp: Dict, h):
    return _layer_block(cfg, lp, h)[0]


def hidden_states(cfg: ModelConfig, params, tokens, collect_state=False):
    """Final-norm hidden states [B, S, D]; with ``collect_state`` also each
    layer's (conv, ssm) states, stacked. In training each layer runs under
    activation checkpointing when ``cfg.remat == "full"``."""
    h = tf.embed_tokens(cfg, params, tokens)
    convs, ssms = [], []
    for lp in tf._unstack(params["blocks"], cfg.num_layers):
        if collect_state:
            h, (conv, ssm) = _layer_block(cfg, lp, h)
            convs.append(conv)
            ssms.append(ssm)
        elif cfg.remat == "full":
            h = checkpoint(_train_block, cfg, lp, h, use_reentrant=False)
        else:
            h = _train_block(cfg, lp, h)
    h = nn.apply_norm(cfg, h, params["final_norm"])
    if collect_state:
        return h, (torch.stack(convs), torch.stack(ssms))
    return h


def loss_fn(cfg: ModelConfig, params, batch):
    h = hidden_states(cfg, params, batch["tokens"])
    return nn.lm_loss(h, tf.unembed(cfg, params), batch["targets"],
                      batch["mask"])


# ---------------------------------------------------------------------------
# Serving — O(1) state decode
# ---------------------------------------------------------------------------

def cache_defs(cfg: ModelConfig, batch: int, seq_len: int) -> Dict:
    L, Di, N = cfg.num_layers, cfg.d_inner, cfg.ssm_state
    return {
        "conv": ParamDef((L, batch, 3, Di), ("layers", "batch", None, "mlp"), "zeros", dtype=cfg.dtype),
        "ssm": ParamDef((L, batch, Di, N), ("layers", "batch", "mlp", "state"), "zeros", dtype="float32"),
    }


def prefill(cfg: ModelConfig, params, tokens, cache_len: int):
    """Process a full prompt; returns (last-token logits [B,V] float32,
    cache {"conv" [L,B,3,Di] in cfg.dtype, "ssm" [L,B,Di,N] float32})."""
    h, (convs, ssms) = hidden_states(cfg, params, tokens, collect_state=True)
    logits = h[:, -1, :].matmul(tf.unembed(cfg, params).T)
    return logits.to(torch.float32), {
        "conv": convs.to(getattr(torch, cfg.dtype)),
        "ssm": ssms.to(torch.float32),
    }


def decode_step(cfg: ModelConfig, params, cache: Dict, tokens, pos: int):
    """One decode step (position-free). tokens [B] int. Each layer's states
    are read from ``cache`` and replaced there in place. Returns (logits
    [B,V] float32, cache)."""
    del pos
    h = tf.embed_tokens(cfg, params, tokens[:, None])
    for i in range(cfg.num_layers):
        h, (conv, ssm) = _mamba_block(
            cfg, tf._layer(params["blocks"], i), h,
            conv_state=cache["conv"][i], ssm_state=cache["ssm"][i])
        write(cache["conv"], (i,), conv.to(cache["conv"].dtype))
        write(cache["ssm"], (i,), ssm)
    h = nn.apply_norm(cfg, h, params["final_norm"])
    logits = h[:, 0, :].matmul(tf.unembed(cfg, params).T)
    return logits.to(torch.float32), cache
