"""Mixture-of-experts family (qwen3-moe-235b-a22b, deepseek-moe-16b), the
port of the JAX package's ``models/moe.py``.

Token-choice top-k routing with GShard-style capacity dispatch: routing
groups of ``Sg`` tokens (seq blocks of at most GROUP_SIZE), each expert
taking at most ``C`` tokens of a group, the dispatch and combine as dense
one-hot tensors and the experts as batched matrix products over them (the
JAX package's einsums, outside any kernel there as here). Shared experts
(deepseek) run densely on every token; ``first_dense_layers`` keeps the
leading layer(s) dense, their hidden size moe_d_ff·(top_k + shared) unless
``d_ff`` is set.

Routing priority is (rank, position): rank-r assignments claim capacity
before rank-r+1, tokens in group order. Dropped tokens (over capacity) get
no expert contribution (the residual carries them). The top k are taken in
`jax.lax.top_k`'s order: descending, the lower expert index first among
equal probabilities (`top_k`), since the rank decides who claims capacity
first.

Attention is the dense block's (`transformer.attention_sublayer`): through
the flash-attention kernel at prefill, the plain differentiable
`layers.attention` in training (the kernel has no backward), and in plain
torch over the cache at decode (`transformer.decode_attention`). The KV
cache is the dense layout, ``[L, B, K, S, h]``, dense layers first.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.models import layers as nn
from repro_torch.models import transformer as tf
from repro_torch.sharding.context import (constrain, local_einsum, write,
                                         zeros)
from repro_torch.sharding.rules import ParamDef

CAPACITY_FACTOR = 1.25
GROUP_SIZE = 256          # tokens per routing group (seq blocks; see moe_ffn)


def _moe_mlp_defs(cfg: ModelConfig, L: int, dtype: str) -> Dict:
    D, E, F_ = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {
        "router": ParamDef((L, D, E), ("layers", "embed_no_fsdp", "expert"), dtype=dtype),
        "w_gate": ParamDef((L, E, D, F_), ("layers", "expert", "embed", "expert_mlp"), dtype=dtype),
        "w_up": ParamDef((L, E, D, F_), ("layers", "expert", "embed", "expert_mlp"), dtype=dtype),
        "w_down": ParamDef((L, E, F_, D), ("layers", "expert", "expert_mlp", "embed"), dtype=dtype),
    }
    if cfg.num_shared_experts > 0:
        Fs = cfg.moe_d_ff * cfg.num_shared_experts
        p["shared"] = {
            "w_gate": ParamDef((L, D, Fs), ("layers", "embed", "mlp"), dtype=dtype),
            "w_up": ParamDef((L, D, Fs), ("layers", "embed", "mlp"), dtype=dtype),
            "w_down": ParamDef((L, Fs, D), ("layers", "mlp", "embed"), dtype=dtype),
        }
    return p


def dense_config(cfg: ModelConfig) -> ModelConfig:
    """The config of the leading dense layers: ``d_ff`` if set, else
    moe_d_ff·(top_k + shared), the activated width of a MoE layer."""
    dense_ff = cfg.d_ff if cfg.d_ff > 0 else cfg.moe_d_ff * (
        cfg.experts_per_token + cfg.num_shared_experts)
    return cfg.with_overrides(d_ff=dense_ff)


def param_defs(cfg: ModelConfig) -> Dict:
    dt = cfg.param_dtype
    D, V = cfg.d_model, cfg.vocab_size
    n0 = cfg.first_dense_layers
    Lm = cfg.num_layers - n0
    p = {
        "tok_embed": ParamDef((V, D), ("vocab", None), "embed", scale=0.02, dtype=dt),
        "moe_blocks": {
            **{k: v for k, v in tf.block_param_defs(cfg, Lm, dt).items() if k != "mlp"},
            "moe": _moe_mlp_defs(cfg, Lm, dt),
        },
        "final_norm": tf._norm_defs((D,), cfg, dt),
    }
    if n0 > 0:
        p["dense_blocks"] = tf.block_param_defs(dense_config(cfg), n0, dt)
    if not cfg.tie_embeddings:
        p["lm_head"] = ParamDef((V, D), ("vocab", None), "embed", scale=0.02, dtype=dt)
    return p


# ---------------------------------------------------------------------------
# Routing + expert computation
# ---------------------------------------------------------------------------

def group_size(S: int) -> int:
    """Tokens per routing group: GROUP_SIZE halved until it divides S (so a
    decode step, S = 1, routes each token alone)."""
    Sg = min(GROUP_SIZE, S)
    while S % Sg != 0:
        Sg //= 2
    return Sg


def capacity(cfg: ModelConfig, Sg: int) -> int:
    """Slots per expert and group: ceil(Sg·k·1.25 / E), at least 1."""
    return max(1, int(math.ceil(Sg * cfg.experts_per_token * CAPACITY_FACTOR
                                / cfg.num_experts)))


def top_k(probs, k: int):
    """(values, indices) of the k largest along the last dim in
    `jax.lax.top_k`'s order: descending, the lower index first among equal
    values (a stable descending sort, cut to k; `torch.topk` promises no
    order among equals)."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


class Routing(NamedTuple):
    probs: torch.Tensor      # [B, n, Sg, E] float32 router softmax
    topi: torch.Tensor       # [B, n, Sg, k] chosen experts, rank order
    dispatch: torch.Tensor   # [B, n, Sg, E, C] one-hot slot of each kept choice
    combine: torch.Tensor    # [B, n, Sg, E, C] dispatch times the renormalised weight


def route(xg, router, cfg: ModelConfig) -> Routing:
    """Route ``xg`` [B, n, Sg, D] (tokens in groups) over ``router`` [D, E]:
    logits in the activation dtype, softmax in float32, the top k
    renormalised, then capacity claimed rank by rank, in group order within
    a rank, with float32 counts (exact integers). ``dispatch`` and
    ``combine`` are in ``xg``'s dtype."""
    B, n, Sg, _ = xg.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    C = capacity(cfg, Sg)
    logits = xg.matmul(router).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = top_k(probs, k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)

    # placed as the routing groups are (one shard of each under a mesh)
    counts = zeros((B, n, 1, E), torch.float32, xg.device,
                   ("batch", "seq_shard", None, None))
    dispatch, combine = (zeros((B, n, Sg, E, C), xg.dtype, xg.device,
                               ("batch", "seq_shard", None, None, None))
                         for _ in range(2))
    for r in range(k):
        m = F.one_hot(topi[..., r], E).to(torch.float32)      # [B,n,Sg,E]
        pos = torch.cumsum(m, dim=2) - m + counts              # queue position
        pos_tok = (pos * m).sum(-1)                            # [B,n,Sg]
        within = (pos_tok < C).to(torch.float32)
        m_kept = m * within[..., None]
        counts = counts + m_kept.sum(dim=2, keepdim=True)
        # a position past C has no slot (jax.nn.one_hot gives zeros there):
        # clamped, then zeroed by ``within``
        slot = F.one_hot(pos_tok.to(torch.int64).clamp(max=C - 1), C
                         ).to(torch.float32) * within[..., None]   # [B,n,Sg,C]
        contrib = (m_kept[..., :, None] * slot[..., None, :]).to(xg.dtype)
        dispatch = dispatch + contrib
        combine = combine + contrib * topv[..., r].to(xg.dtype)[..., None, None]
    return Routing(probs, topi, dispatch, combine)


def moe_ffn(x, p: Dict, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,D] -> (y [B,S,D], aux_loss float32 scalar): routing groups of
    `group_size` tokens kept as their own dim [B, n, Sg, ...] (never mixed
    across batch rows), the experts as batched products over the
    capacity-padded ``[E, B, n, C, D]`` dispatch. Under a mesh the expert
    tensors are constrained to (expert→model, batch→data)."""
    B, S, D = x.shape
    E = cfg.num_experts
    Sg = group_size(S)
    xg = x.reshape(B, S // Sg, Sg, D)
    r = route(xg, p["router"], cfg)
    moe_tok_axes = ("batch", "seq_shard", None, None, None)
    expert_axes = ("expert", "batch", None, None, None)
    dispatch = constrain(r.dispatch, moe_tok_axes)
    combine = constrain(r.combine, moe_tok_axes)
    # each rank's own tokens into their slots (`local_einsum`), then moved
    # to the experts' layout
    xin = local_einsum("bnsec,bnsd->ebncd", dispatch, xg)        # [E,B,n,C,D]
    xin = constrain(xin, expert_axes)
    hg = nn._act(cfg.activation,
                 local_einsum("ebncd,edf->ebncf", xin, p["w_gate"]))
    hu = local_einsum("ebncd,edf->ebncf", xin, p["w_up"])
    out_e = local_einsum("ebncf,efd->ebncd", hg * hu, p["w_down"])
    out_e = constrain(out_e, expert_axes)
    y = local_einsum("bnsec,ebncd->bnsd", combine, out_e).reshape(B, S, D)

    if cfg.num_shared_experts > 0:
        sp = p["shared"]
        gate = nn._act(cfg.activation, x.matmul(sp["w_gate"]))
        up = x.matmul(sp["w_up"])
        y = y + (gate * up).matmul(sp["w_down"])

    # load-balancing aux (Switch/GShard): E * Σ_e f_e · p̄_e, on rank 0
    sel_frac = F.one_hot(r.topi[..., 0], E).to(torch.float32).mean(dim=(0, 1, 2))
    mean_prob = r.probs.mean(dim=(0, 1, 2))
    aux = E * (sel_frac * mean_prob).sum()
    return y, aux


def _moe_block(cfg: ModelConfig, lp: Dict, h, pos, attend):
    """One MoE layer: the dense block's attention half (through ``attend``),
    then `moe_ffn`. Returns (h_out, aux, (k, v))."""
    h, kv = tf.attention_sublayer(cfg, lp, h, pos, 0, attend)
    x = nn.apply_norm(cfg, h, lp["mlp_norm"])
    y, aux = moe_ffn(x, lp["moe"], cfg)
    return h + y, aux, kv


# ---------------------------------------------------------------------------
# Training forward / loss
# ---------------------------------------------------------------------------

def _train_moe_block(cfg: ModelConfig, lp: Dict, h, pos):
    h = tf.constrain(h, tf.RESIDUAL_AXES)
    h, aux, _ = _moe_block(cfg, lp, h, pos, tf.plain_attend)
    return tf.constrain(h, tf.RESIDUAL_AXES), aux


def hidden_states(cfg: ModelConfig, params, tokens, positions=None):
    """(final-norm hidden states [B, S, D], the router aux summed over the
    MoE layers). The dense layers run as they are, each MoE layer under
    activation checkpointing when ``cfg.remat == "full"`` (the JAX
    package's rematerialised scan over the MoE stack)."""
    B, S = tokens.shape
    pos = positions if positions is not None else tf._positions(
        B, S, tokens.device)
    h = tf.embed_tokens(cfg, params, tokens)
    n0 = cfg.first_dense_layers
    if n0 > 0:
        dense_cfg = dense_config(cfg)
        for lp in tf._unstack(params["dense_blocks"], n0):
            h = tf.block_apply(dense_cfg, lp, h, pos, 0,
                               attend=tf.plain_attend)[0]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for lp in tf._unstack(params["moe_blocks"], cfg.num_layers - n0):
        if cfg.remat == "full":
            h, a = checkpoint(_train_moe_block, cfg, lp, h, pos,
                              use_reentrant=False)
        else:
            h, a = _train_moe_block(cfg, lp, h, pos)
        aux = aux + a
    return nn.apply_norm(cfg, h, params["final_norm"]), aux


def loss_fn(cfg: ModelConfig, params, batch):
    h, aux = hidden_states(cfg, params, batch["tokens"])
    ce = nn.lm_loss(h, tf.unembed(cfg, params), batch["targets"],
                    batch["mask"], softcap=cfg.logits_softcap)
    return ce + cfg.router_aux_loss * aux


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

cache_defs = tf.cache_defs     # same layout: [L, B, K, S, h]


def _serve_layers(cfg: ModelConfig, params):
    """(layer params as views of the stacked leaves, is a MoE layer) in
    cache order: the dense layers first."""
    n0 = cfg.first_dense_layers
    for i in range(n0):
        yield tf._layer(params["dense_blocks"], i), False
    for i in range(cfg.num_layers - n0):
        yield tf._layer(params["moe_blocks"], i), True


def prefill(cfg: ModelConfig, params, tokens, cache_len: int):
    """Process a full prompt; returns (last-token logits [B,V] float32, cache
    dict of ``[L, B, K, cache_len, h]`` in ``cfg.dtype``, zero past the
    prompt). Every layer attends through the flash-attention kernel."""
    B, S = tokens.shape
    pos = tf._positions(B, S, tokens.device)
    h = tf.embed_tokens(cfg, params, tokens)
    dense_cfg = dense_config(cfg)
    shape = (cfg.num_layers, B, cfg.num_kv_heads, cache_len, cfg.head_dim)
    axes = cache_defs(cfg, B, cache_len)["k"].axes
    cache = {name: zeros(shape, getattr(torch, cfg.dtype), h.device, axes)
             for name in ("k", "v")}
    for i, (lp, is_moe) in enumerate(_serve_layers(cfg, params)):
        if is_moe:
            h, _, (k, v) = _moe_block(cfg, lp, h, pos, tf.flash_attend)
        else:
            h, (k, v) = tf.block_apply(dense_cfg, lp, h, pos, 0)
        at = (i, slice(None), slice(None), slice(0, S))
        write(cache["k"], at, k.transpose(1, 2))
        write(cache["v"], at, v.transpose(1, 2))
    h = nn.apply_norm(cfg, h, params["final_norm"])
    logits = h[:, -1, :].matmul(tf.unembed(cfg, params).T)
    return logits.to(torch.float32), cache


def decode_step(cfg: ModelConfig, params, cache: Dict, tokens, pos: int):
    """One decode step. tokens [B] int; ``pos`` the shared position of the
    new token. Each layer writes the new token's K/V into ``cache`` in
    place and attends over it; the MoE layers route the token alone (S = 1:
    a group of one, capacity 1). Returns (logits [B,V] float32, cache)."""
    B = tokens.shape[0]
    pos = int(pos)
    S = cache["k"].shape[3]
    pos_q = tf._positions(B, 1, tokens.device, pos)
    pos_k = tf._positions(B, S, tokens.device)
    h = tf.embed_tokens(cfg, params, tokens[:, None])
    dense_cfg = dense_config(cfg)
    for i, (lp, is_moe) in enumerate(_serve_layers(cfg, params)):
        h = tf.decode_attention(cfg, lp, h, cache, i, pos, pos_q, pos_k, 0)
        x = nn.apply_norm(cfg, h, lp["mlp_norm"])
        if is_moe:
            h = h + moe_ffn(x, lp["moe"], cfg)[0]
        else:
            h = h + nn.mlp(x, lp["mlp"], dense_cfg)
    h = nn.apply_norm(cfg, h, params["final_norm"])
    logits = h[:, 0, :].matmul(tf.unembed(cfg, params).T)
    return logits.to(torch.float32), cache
