"""Vision-language family (llama-3.2-vision-11b backbone), the port of the
JAX package's ``models/vlm.py``.

40 layers = 8 repeating groups of [self, self, self, CROSS, self], the hf
cross-attention indices {3, 8, ..., 38}. The vision tower is a stub, as in
the JAX package: the batch supplies precomputed patch embeddings ``[B,
num_image_tokens, image_embed_dim]`` and a learned projector maps them
into d_model. Cross-attention layers carry their own MLP and tanh-gated
residuals (gate init 0: the image path starts switched off), q and k
RMS-normed per head.

The self layers are the dense block (`transformer.block_apply`: GQA with
RoPE). Prefill attends through the flash-attention kernel (`gqa_flash`,
K4): causally in the self layers, non-causally over every image token
(``Sk = num_image_tokens``, a key length of its own) in the cross layers.
Training attends through the plain, differentiable `layers.attention`
(the kernel has no backward); decode attends there too, over the caches.

Params are the JAX package's nested dict: ``self_blocks`` stacked over the
G·4 self layers in group order, ``cross_blocks`` over the G cross layers.
Caches: ``k``, ``v`` ``[G·4, B, K, cache_len, h]`` (self layer g·4 + i at
index g·4 + i) and ``xk``, ``xv`` ``[G, B, K, T, h]``, the cross layers' K/V
of the image tokens, computed once at prefill.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.kernels.flash_attention.ops import gqa_flash
from repro_torch.models import layers as nn
from repro_torch.models import transformer as tf
from repro_torch.sharding.context import constrain, write, zeros
from repro_torch.sharding.rules import ParamDef

GROUP = 5          # 4 self + 1 cross per group
CROSS_POS = 3      # cross layer index within each group


def _num_groups(cfg: ModelConfig) -> int:
    assert cfg.num_layers % GROUP == 0
    return cfg.num_layers // GROUP


def param_defs(cfg: ModelConfig) -> Dict:
    dt = cfg.param_dtype
    D, V = cfg.d_model, cfg.vocab_size
    G = _num_groups(cfg)
    n_self = G * (GROUP - 1)

    # self blocks stacked [G*(GROUP-1)], in group order
    self_blocks = tf.block_param_defs(cfg, n_self, dt)

    # cross blocks stacked [G]
    Lx, N, K, h, F = G, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    cross = {
        "xattn_norm": tf._norm_defs((Lx, D), cfg, dt),
        "xattn": {
            "wq": ParamDef((Lx, D, N, h), ("layers", "embed", "heads", "head_dim"), dtype=dt),
            "wk": ParamDef((Lx, D, K, h), ("layers", "embed", "kv_heads", "head_dim"), dtype=dt),
            "wv": ParamDef((Lx, D, K, h), ("layers", "embed", "kv_heads", "head_dim"), dtype=dt),
            "wo": ParamDef((Lx, N, h, D), ("layers", "heads", "head_dim", "embed"), dtype=dt),
            "q_norm": ParamDef((Lx, h), ("layers", None), "zeros", dtype=dt),
            "k_norm": ParamDef((Lx, h), ("layers", None), "zeros", dtype=dt),
        },
        "mlp_norm": tf._norm_defs((Lx, D), cfg, dt),
        "mlp": {
            "w_gate": ParamDef((Lx, D, F), ("layers", "embed", "mlp"), dtype=dt),
            "w_up": ParamDef((Lx, D, F), ("layers", "embed", "mlp"), dtype=dt),
            "w_down": ParamDef((Lx, F, D), ("layers", "mlp", "embed"), dtype=dt),
        },
        "gate_attn": ParamDef((Lx,), ("layers",), "zeros", dtype=dt),
        "gate_mlp": ParamDef((Lx,), ("layers",), "zeros", dtype=dt),
    }
    return {
        "tok_embed": ParamDef((V, D), ("vocab", None), "embed", scale=0.02, dtype=dt),
        "img_proj": ParamDef((cfg.image_embed_dim, D), ("embed_no_fsdp", None), dtype=dt),
        "self_blocks": self_blocks,
        "cross_blocks": cross,
        "final_norm": tf._norm_defs((D,), cfg, dt),
        "lm_head": ParamDef((V, D), ("vocab", None), "embed", scale=0.02, dtype=dt),
    }


def _project_image(cfg: ModelConfig, params, image_embeds):
    dt = getattr(torch, cfg.dtype)
    return torch.einsum("bte,ed->btd", image_embeds.to(dt),
                        params["img_proj"].to(dt))


def flash_cross(q, k, v, pos, img_pos):
    """The cross-attention through the flash-attention kernel: every image
    token is a key, so the kernel takes all of them, non-causally."""
    return gqa_flash(q, k, v, causal=False, window=0)


def plain_cross(q, k, v, pos, img_pos):
    """The plain `layers.attention`, as the JAX package calls it."""
    return nn.attention(q, k, v, pos, img_pos, causal=False, window=0,
                        chunk_q=2048)


def _cross_block(cfg: ModelConfig, xp: Dict, h, img, img_pos, pos, xkv=None,
                 attend=flash_cross):
    """One cross-attention layer (its own MLP, tanh-gated residuals): the
    image's K/V projected from ``img`` or, at decode, taken from ``xkv``.
    Returns (h_out, (k, v))."""
    x = nn.apply_norm(cfg, h, xp["xattn_norm"])
    q = nn.rmsnorm(nn.project(x, xp["xattn"]["wq"]), xp["xattn"]["q_norm"])
    if xkv is None:
        k = nn.rmsnorm(nn.project(img, xp["xattn"]["wk"]),
                       xp["xattn"]["k_norm"])
        v = nn.project(img, xp["xattn"]["wv"])
    else:
        k, v = xkv
    out = attend(q, k, v, pos, img_pos)
    h = h + torch.tanh(xp["gate_attn"]) * nn.attn_output(out, xp["xattn"], False)
    x = nn.apply_norm(cfg, h, xp["mlp_norm"])
    return h + torch.tanh(xp["gate_mlp"]) * nn.mlp(x, xp["mlp"], cfg), (k, v)


def _group(cfg: ModelConfig, self_lps, xp, h, img, img_pos, pos, prefill):
    """One group [self, self, self, cross, self]: (h_out, the K/V of its
    five layers in that order). At prefill the attention goes through the
    kernel, in training through the plain attention."""
    kvs = []
    h = constrain(h, tf.RESIDUAL_AXES)
    for i, lp in enumerate(self_lps):
        if i == CROSS_POS:
            h, xkv = _cross_block(cfg, xp, h, img, img_pos, pos,
                                  attend=flash_cross if prefill else plain_cross)
            kvs.append(xkv)
        h, kv = tf.block_apply(
            cfg, lp, h, pos, 0,
            attend=tf.flash_attend if prefill else tf.plain_attend)
        kvs.append(kv)
    return constrain(h, tf.RESIDUAL_AXES), kvs


def _train_group(cfg, self_lps, xp, h, img, img_pos, pos):
    return _group(cfg, self_lps, xp, h, img, img_pos, pos, False)[0]


def _inputs(cfg: ModelConfig, params, tokens, image_embeds):
    """(positions, the projected image, its positions, the embedded
    tokens)."""
    B, S = tokens.shape
    pos = tf._positions(B, S, tokens.device)
    img = _project_image(cfg, params, image_embeds)
    img_pos = tf._positions(B, img.shape[1], tokens.device)
    return pos, img, img_pos, tf.embed_tokens(cfg, params, tokens)


def hidden_states(cfg: ModelConfig, params, tokens, image_embeds):
    """Training forward: final-norm hidden states [B, S, D], each group
    under activation checkpointing when ``cfg.remat == "full"`` (the JAX
    package's rematerialised scan body)."""
    G = _num_groups(cfg)
    pos, img, img_pos, h = _inputs(cfg, params, tokens, image_embeds)
    selfs = tf._unstack(params["self_blocks"], G * (GROUP - 1))
    crosses = tf._unstack(params["cross_blocks"], G)
    for g in range(G):
        lps = selfs[g * (GROUP - 1):(g + 1) * (GROUP - 1)]
        if cfg.remat == "full":
            h = checkpoint(_train_group, cfg, lps, crosses[g], h, img,
                           img_pos, pos, use_reentrant=False)
        else:
            h = _train_group(cfg, lps, crosses[g], h, img, img_pos, pos)
    return nn.apply_norm(cfg, h, params["final_norm"])


def loss_fn(cfg: ModelConfig, params, batch):
    h = hidden_states(cfg, params, batch["tokens"], batch["image_embeds"])
    return nn.lm_loss(h, params["lm_head"], batch["targets"], batch["mask"])


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def cache_defs(cfg: ModelConfig, batch: int, seq_len: int) -> Dict:
    G = _num_groups(cfg)
    K, h = cfg.num_kv_heads, cfg.head_dim
    T = cfg.num_image_tokens
    ax = ("layers", "batch", "cache_kv", "seq_shard", "head_dim")
    return {
        "k": ParamDef((G * (GROUP - 1), batch, K, seq_len, h), ax, "zeros", dtype=cfg.dtype),
        "v": ParamDef((G * (GROUP - 1), batch, K, seq_len, h), ax, "zeros", dtype=cfg.dtype),
        "xk": ParamDef((G, batch, K, T, h), ("layers", "batch", "cache_kv", "seq", "head_dim"), "zeros", dtype=cfg.dtype),
        "xv": ParamDef((G, batch, K, T, h), ("layers", "batch", "cache_kv", "seq", "head_dim"), "zeros", dtype=cfg.dtype),
    }


def prefill(cfg: ModelConfig, params, tokens, image_embeds, cache_len: int):
    """Process a full prompt beside its image; returns (last-token logits
    [B, V] float32, caches: ``k``, ``v`` zero past the prompt, ``xk``,
    ``xv`` the cross layers' K/V of the image tokens)."""
    G = _num_groups(cfg)
    B, S = tokens.shape
    pos, img, img_pos, h = _inputs(cfg, params, tokens, image_embeds)
    dt = getattr(torch, cfg.dtype)
    K, hd = cfg.num_kv_heads, cfg.head_dim
    defs = cache_defs(cfg, B, cache_len)
    cache = {name: zeros(d.shape, dt, h.device, d.axes)
             for name, d in defs.items()}
    for g in range(G):
        first = g * (GROUP - 1)
        lps = [tf._layer(params["self_blocks"], first + i)
               for i in range(GROUP - 1)]
        h, kvs = _group(cfg, lps, tf._layer(params["cross_blocks"], g), h,
                        img, img_pos, pos, True)
        xk, xv = kvs.pop(CROSS_POS)
        write(cache["xk"], (g,), xk.transpose(1, 2))
        write(cache["xv"], (g,), xv.transpose(1, 2))
        for i, (k, v) in enumerate(kvs):
            at = (first + i, slice(None), slice(None), slice(0, S))
            write(cache["k"], at, k.transpose(1, 2))
            write(cache["v"], at, v.transpose(1, 2))
    h = nn.apply_norm(cfg, h, params["final_norm"])
    logits = h[:, -1, :].matmul(params["lm_head"].T)
    return logits.to(torch.float32), cache


def decode_step(cfg: ModelConfig, params, cache: Dict, tokens, pos: int):
    """One decode step; tokens [B] int, ``pos`` the new token's position.
    Returns (logits [B, V] float32, cache), the self layers' caches updated
    in place (`transformer.decode_attention`)."""
    G = _num_groups(cfg)
    B = tokens.shape[0]
    pos = int(pos)
    S, T = cache["k"].shape[3], cache["xk"].shape[3]
    pos_q = tf._positions(B, 1, tokens.device, pos)
    pos_k = tf._positions(B, S, tokens.device)
    img_pos = tf._positions(B, T, tokens.device)
    h = tf.embed_tokens(cfg, params, tokens[:, None])
    for g in range(G):
        for i in range(GROUP - 1):
            if i == CROSS_POS:
                xkv = (cache["xk"][g].transpose(1, 2),
                       cache["xv"][g].transpose(1, 2))
                h, _ = _cross_block(cfg, tf._layer(params["cross_blocks"], g),
                                    h, None, img_pos, pos_q, xkv=xkv,
                                    attend=plain_cross)
            j = g * (GROUP - 1) + i
            lp = tf._layer(params["self_blocks"], j)
            h = tf.decode_attention(cfg, lp, h, cache, j, pos, pos_q, pos_k, 0)
            x = nn.apply_norm(cfg, h, lp["mlp_norm"])
            h = h + nn.mlp(x, lp["mlp"], cfg)
    h = nn.apply_norm(cfg, h, params["final_norm"])
    logits = h[:, 0, :].matmul(params["lm_head"].T)
    return logits.to(torch.float32), cache
