"""Dense decoder-only transformer (GQA + RoPE), the port of the JAX
package's ``models/transformer.py``.

Covers chatglm3-6b, stablelm-12b, gemma3-4b (5:1 local:global) and
command-r-plus-104b through `ModelConfig` knobs. Entry points:

  * ``hidden_states`` / ``loss_fn`` — the training forward and its loss
  * ``prefill``      — a full prompt: last-position logits + KV cache
  * ``decode_step``  — one token against the cache, updated in place

Params are the JAX package's nested dict with the same keys and layout, the
layer weights stacked ``[L, ...]``; the JAX scan over layers is a Python
loop over that leading dimension. KV caches are ``[L, B, K, S, h]``.

`block_apply` is the block body of training and prefill; its ``attend``
argument is the one thing that differs. Prefill attends through the
flash-attention kernel (`gqa_flash`, K4), which has no backward (nor has
the JAX package's), so the training forward attends through the plain,
differentiable `layers.attention`, as the JAX package's training block does.
Decode attends through `layers.attention` too, in its own layer loop.

Under a mesh (the dry-run) the residual stream, the layer weights and the
embedding table are constrained at the JAX package's sites
(`sharding.context`); on plain tensors those calls return their input.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.kernels.flash_attention.ops import gqa_flash
from repro_torch.models import layers as nn
from repro_torch.sharding.context import (constrain, constrain_tree,
                                         embed_lookup, grad_placed, placed,
                                         settle, write, zeros)
from repro_torch.sharding.rules import ParamDef, layer_axes_strs
from repro_torch.utils.tree import tree_leaves, tree_unflatten_like

# residual-stream constraint for attention families: sequence parallelism
RESIDUAL_AXES = ("batch", "seq_shard", None)


def block_axes(cfg: ModelConfig) -> dict:
    """Axis-string tree for one layer's params (constrain_tree input)."""
    return layer_axes_strs(block_param_defs(cfg, 1, cfg.param_dtype))


# ---------------------------------------------------------------------------
# Param defs
# ---------------------------------------------------------------------------

def _norm_defs(shape, cfg: ModelConfig, dtype):
    axes = ("layers", None) if len(shape) == 2 else (None,)
    if cfg.norm == "layernorm":
        return {
            "scale": ParamDef(shape, axes, "ones", dtype=dtype),
            "bias": ParamDef(shape, axes, "zeros", dtype=dtype),
        }
    # rmsnorm uses (1 + scale), so zeros == identity
    return {"scale": ParamDef(shape, axes, "zeros", dtype=dtype)}


def block_param_defs(cfg: ModelConfig, num_layers: int, dtype: str) -> Dict:
    """Stacked per-layer params for one homogeneous attention+MLP stack."""
    L, D = num_layers, cfg.d_model
    N, K, h, F = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    p = {
        "attn_norm": _norm_defs((L, D), cfg, dtype),
        "mlp_norm": _norm_defs((L, D), cfg, dtype),
        "attn": {
            "wq": ParamDef((L, D, N, h), ("layers", "embed", "heads", "head_dim"), dtype=dtype),
            "wk": ParamDef((L, D, K, h), ("layers", "embed", "kv_heads", "head_dim"), dtype=dtype),
            "wv": ParamDef((L, D, K, h), ("layers", "embed", "kv_heads", "head_dim"), dtype=dtype),
            "wo": ParamDef((L, N, h, D), ("layers", "heads", "head_dim", "embed"), dtype=dtype),
        },
        "mlp": {
            "w_up": ParamDef((L, D, F), ("layers", "embed", "mlp"), dtype=dtype),
            "w_down": ParamDef((L, F, D), ("layers", "mlp", "embed"), dtype=dtype),
        },
    }
    if cfg.glu:
        p["mlp"]["w_gate"] = ParamDef((L, D, F), ("layers", "embed", "mlp"), dtype=dtype)
    if cfg.use_qkv_bias:
        p["attn"]["bq"] = ParamDef((L, N, h), ("layers", "heads", "head_dim"), "zeros", dtype=dtype)
        p["attn"]["bk"] = ParamDef((L, K, h), ("layers", "kv_heads", "head_dim"), "zeros", dtype=dtype)
        p["attn"]["bv"] = ParamDef((L, K, h), ("layers", "kv_heads", "head_dim"), "zeros", dtype=dtype)
    if cfg.use_bias:
        p["attn"]["bo"] = ParamDef((L, D), ("layers", "embed"), "zeros", dtype=dtype)
        p["mlp"]["b_up"] = ParamDef((L, F), ("layers", "mlp"), "zeros", dtype=dtype)
        p["mlp"]["b_down"] = ParamDef((L, D), ("layers", "embed"), "zeros", dtype=dtype)
    if cfg.qk_norm:
        p["attn"]["q_norm"] = ParamDef((L, h), ("layers", None), "zeros", dtype=dtype)
        p["attn"]["k_norm"] = ParamDef((L, h), ("layers", None), "zeros", dtype=dtype)
    return p


def param_defs(cfg: ModelConfig) -> Dict:
    dt = cfg.param_dtype
    D, V = cfg.d_model, cfg.vocab_size
    p = {
        "tok_embed": ParamDef((V, D), ("vocab", None), "embed", scale=0.02, dtype=dt),
        "blocks": block_param_defs(cfg, cfg.num_layers, dt),
        "final_norm": _norm_defs((D,), cfg, dt),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = ParamDef((V, D), ("vocab", None), "embed", scale=0.02, dtype=dt)
    return p


def _layer_flags(cfg: ModelConfig) -> np.ndarray:
    """Per-layer local-attention window (0 = global)."""
    L = cfg.num_layers
    if cfg.attn_pattern == "global":
        return np.zeros(L, np.int32)
    if cfg.attn_pattern == "local":
        return np.full(L, cfg.local_window, np.int32)
    # local_global: one global layer every `global_every` (gemma3: 5 local : 1)
    w = np.full(L, cfg.local_window, np.int32)
    w[cfg.global_every - 1::cfg.global_every] = 0
    return w


def _layer(blocks: Dict, i: int) -> Dict:
    """Layer ``i``'s params: a view of the stacked ``[L, ...]`` leaves."""
    if isinstance(blocks, dict):
        return {key: _layer(value, i) for key, value in blocks.items()}
    return blocks[i]


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _qk_normalize(cfg, p, q, k):
    if cfg.qk_norm:
        q = nn.rmsnorm(q, p["q_norm"])
        k = nn.rmsnorm(k, p["k_norm"])
    return q, k


def flash_attend(q, k, v, pos, window: int):
    """Prefill attention through the flash-attention kernel. The positions
    are ``arange(S)`` in every row, with no padding and no softcap, so
    `gqa_flash` computes exactly what the JAX package's plain attention
    computes there."""
    return gqa_flash(q, k, v, causal=True, window=window)


def plain_attend(q, k, v, pos, window: int):
    """Training attention: the plain `layers.attention`, as the JAX
    package's ``block_apply`` calls it."""
    return nn.attention(q, k, v, pos, pos, causal=True, window=window,
                        chunk_q=2048)


def attention_sublayer(cfg: ModelConfig, lp: Dict, h, pos, window: int,
                       attend=flash_attend):
    """A block's attention half: norm, q/k/v, RoPE, ``attend(q, k, v, pos,
    window)``, the output projection and the residual. Returns (h_out,
    (k, v)), the K/V for the cache. The MoE block shares it."""
    x = nn.apply_norm(cfg, h, lp["attn_norm"])
    q, k, v = nn.gqa_project(x, lp["attn"], cfg, cfg.use_qkv_bias)
    q, k = _qk_normalize(cfg, lp["attn"], q, k)
    q = nn.apply_rope(q, pos, cfg)
    k = nn.apply_rope(k, pos, cfg)
    out = attend(q, k, v, pos, window)
    return h + nn.attn_output(out, lp["attn"], cfg.use_bias), (k, v)


def block_apply(cfg: ModelConfig, lp: Dict, h, pos, window: int,
                attend=flash_attend):
    """One transformer block; ``window`` 0 means global. ``attend(q, k, v,
    pos, window)`` is the attention: `flash_attend` at prefill (the
    default), `plain_attend` in training. Returns (h_out, (k, v)), the K/V
    for the cache. (Decode does not call this: as in the JAX package, its
    layer writes the new token's K/V into the cache before attending over
    it.)
    """
    h, kv = attention_sublayer(cfg, lp, h, pos, window, attend)
    x = nn.apply_norm(cfg, h, lp["mlp_norm"])
    return h + nn.mlp(x, lp["mlp"], cfg), kv


def embed_tokens(cfg: ModelConfig, params, tokens):
    table = constrain(params["tok_embed"], ("vocab", None))
    e = settle(embed_lookup(tokens, table)).to(getattr(torch, cfg.dtype))
    if cfg.family in ("dense", "moe", "vlm") and cfg.norm == "rmsnorm":
        # gemma-style scale, rounded to the activation dtype first as in JAX
        e = e * torch.tensor(float(cfg.d_model) ** 0.5, dtype=torch.float32
                             ).to(e.dtype)
    return e


def unembed(cfg: ModelConfig, params):
    return params["tok_embed"] if cfg.tie_embeddings else params["lm_head"]


# ---------------------------------------------------------------------------
# Training forward / loss
# ---------------------------------------------------------------------------

def _unstack(blocks: Dict, num_layers: int):
    """Per-layer param dicts from the stacked ``[L, ...]`` leaves, by one
    ``unbind`` per leaf: its backward stacks the layers' gradients once,
    where indexing layer by layer would add a full-size gradient per
    layer. Under a mesh each layer's gradient is placed as its slice of
    the leaf as soon as that layer's backward is done (`grad_placed`)."""
    leaves = [x.unbind(0) for x in tree_leaves(blocks)]
    return [tree_unflatten_like(blocks, [grad_placed(leaf[i])
                                         for leaf in leaves])
            for i in range(num_layers)]


def _train_block(cfg: ModelConfig, lp: Dict, h, pos, window: int):
    h = constrain(h, RESIDUAL_AXES)
    out = block_apply(cfg, constrain_tree(lp, block_axes(cfg)), h, pos,
                      window, attend=plain_attend)[0]
    # output constrained too: the backward pass keeps each block's input,
    # and an unconstrained one would be kept replicated
    return constrain(out, RESIDUAL_AXES)


def hidden_states(cfg: ModelConfig, params, tokens, positions=None):
    """Final-norm hidden states [B, S, D] of ``tokens`` [B, S]. Each block
    runs under activation checkpointing when ``cfg.remat == "full"`` (the
    JAX package's rematerialised scan): the backward pass keeps each
    block's input and recomputes the rest, one block at a time."""
    B, S = tokens.shape
    pos = positions if positions is not None else _positions(
        B, S, tokens.device)
    h = embed_tokens(cfg, params, tokens)
    layers = _unstack(params["blocks"], cfg.num_layers)
    for lp, window in zip(layers, _layer_flags(cfg).tolist()):
        if cfg.remat == "full":
            h = checkpoint(_train_block, cfg, lp, h, pos, window,
                           use_reentrant=False)
        else:
            h = _train_block(cfg, lp, h, pos, window)
    return nn.apply_norm(cfg, h, params["final_norm"])


def loss_fn(cfg: ModelConfig, params, batch):
    h = hidden_states(cfg, params, batch["tokens"])
    return nn.lm_loss(h, unembed(cfg, params), batch["targets"],
                      batch["mask"], softcap=cfg.logits_softcap)


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

def cache_defs(cfg: ModelConfig, batch: int, seq_len: int) -> Dict:
    L, K, h = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    kv_dt = cfg.dtype
    ax = ("layers", "batch", "cache_kv", "seq_shard", "head_dim")
    return {
        "k": ParamDef((L, batch, K, seq_len, h), ax, "zeros", dtype=kv_dt),
        "v": ParamDef((L, batch, K, seq_len, h), ax, "zeros", dtype=kv_dt),
    }


def _positions(B: int, S: int, device, start: int = 0):
    """[B, S] positions start.., placed on the batch axes under a mesh."""
    return placed(torch.arange(start, start + S, dtype=torch.int32,
                               device=device)[None, :].expand(B, S),
                  ("batch", None))


def prefill(cfg: ModelConfig, params, tokens, cache_len: int):
    """Process a full prompt; returns (last-token logits [B,V] float32, cache
    dict of ``[L, B, K, cache_len, h]``, zero past the prompt)."""
    B, S = tokens.shape
    pos = _positions(B, S, tokens.device)
    h = embed_tokens(cfg, params, tokens)
    dt = getattr(torch, cfg.dtype)
    shape = (cfg.num_layers, B, cfg.num_kv_heads, cache_len, cfg.head_dim)
    axes = cache_defs(cfg, B, cache_len)["k"].axes
    cache = {name: zeros(shape, dt, h.device, axes) for name in ("k", "v")}
    axes = block_axes(cfg)
    for i, window in enumerate(_layer_flags(cfg).tolist()):
        h = constrain(h, RESIDUAL_AXES)
        h, (k, v) = block_apply(
            cfg, constrain_tree(_layer(params["blocks"], i), axes), h, pos,
            window)
        write(cache["k"], (i, slice(None), slice(None), slice(0, S)),
              k.transpose(1, 2))
        write(cache["v"], (i, slice(None), slice(None), slice(0, S)),
              v.transpose(1, 2))
    h = nn.apply_norm(cfg, h, params["final_norm"])
    logits = h[:, -1, :].matmul(unembed(cfg, params).T)
    return logits.to(torch.float32), cache


def decode_attention(cfg: ModelConfig, lp: Dict, h, cache: Dict, i: int,
                     pos: int, pos_q, pos_k, window: int):
    """Layer ``i``'s attention half at decode: the new token's K/V written
    into ``cache`` in place at ``pos``, then attention over the cache in
    plain torch. Returns h after the residual. The MoE decode shares it."""
    x = nn.apply_norm(cfg, h, lp["attn_norm"])
    q, k, v = nn.gqa_project(x, lp["attn"], cfg, cfg.use_qkv_bias)
    q, k = _qk_normalize(cfg, lp["attn"], q, k)
    q = nn.apply_rope(q, pos_q, cfg)
    k = nn.apply_rope(k, pos_q, cfg)
    at = (i, slice(None), slice(None), pos)
    write(cache["k"], at, k[:, 0].to(cache["k"].dtype))
    write(cache["v"], at, v[:, 0].to(cache["v"].dtype))
    ck, cv = cache["k"][i], cache["v"][i]               # [B,K,S,h] views
    out = nn.attention(q, ck.transpose(1, 2), cv.transpose(1, 2), pos_q,
                       pos_k, causal=True, window=window, chunk_q=2048,
                       softcap=0.0)
    return h + nn.attn_output(out, lp["attn"], cfg.use_bias)


def decode_step(cfg: ModelConfig, params, cache: Dict, tokens, pos: int):
    """One decode step. tokens [B] int; ``pos`` the shared position of the
    new token. Returns (logits [B,V] float32, cache).

    The JAX package carries the cache through its layer scan and updates it
    with dynamic-update-slices (in place under donation); here each layer
    writes the new token's K/V into ``cache`` in place, by index, and the
    same dict is returned.
    """
    B = tokens.shape[0]
    pos = int(pos)
    S = cache["k"].shape[3]
    pos_q = _positions(B, 1, tokens.device, pos)
    pos_k = _positions(B, S, tokens.device)
    h = embed_tokens(cfg, params, tokens[:, None])
    for i, window in enumerate(_layer_flags(cfg).tolist()):
        lp = _layer(params["blocks"], i)
        h = decode_attention(cfg, lp, h, cache, i, pos, pos_q, pos_k, window)
        x = nn.apply_norm(cfg, h, lp["mlp_norm"])
        h = h + nn.mlp(x, lp["mlp"], cfg)
    h = nn.apply_norm(cfg, h, params["final_norm"])
    logits = h[:, 0, :].matmul(unembed(cfg, params).T)
    return logits.to(torch.float32), cache
