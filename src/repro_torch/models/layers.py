"""Shared layers of the dense transformer (plain functions on tensors over
explicit param dicts), the port of the JAX package's ``models/layers.py``.

The attention here is the plain GQA path, q heads grouped over kv heads,
with masks computed from position vectors; for ``Q > chunk_q`` the query
dimension is taken in chunks so the score block is ``[B, K, G, chunk, S]``.
The serve path's prefill goes through the flash-attention kernel instead
(`models.transformer.block_apply`); decode attends here.

Training attends here too, as the JAX package's training block does
(`models.transformer.hidden_states`): the flash-attention kernel has no
backward. ``lm_loss`` is the chunked cross-entropy of the training loss.

The JAX package's sharding calls sit at its sites
(`sharding.context`): under a mesh (the dry-run) they place the
activations as the JAX package's do; on plain tensors they return their
input, so a one-card run computes the same ops.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.sharding.context import (constrain, constrain_heads_or_seq,
                                         by_query_shard, follow_seq,
                                         gather_seq, local_len,
                                         logsumexp_last, merge, rows_matmul,
                                         split_heads, take_along_last,
                                         unflatten)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(torch.float32))).to(x.dtype)


def layernorm(x, scale, bias, eps: float = 1e-5):
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale + bias).to(x.dtype)


def apply_norm(cfg: ModelConfig, x, p: Dict):
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_table(positions, dim: int, theta: float):
    """positions [..., S] -> (sin, cos) [..., S, dim/2], float32."""
    half = dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32,
                            device=positions.device) / half
    # theta stays a Python scalar: rounded to float32 inside the kernel as
    # JAX rounds it, and no host-to-device copy (which would synchronise)
    freqs = 1.0 / torch.pow(theta, exponent)
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x, positions, cfg: ModelConfig):
    """x [B, S, N, H]; neox-style rotate-half on the first
    rope_fraction*head_dim dims (chatglm '2d rope' = fraction 0.5)."""
    if cfg.rope_style == "none":
        return x
    hd = x.shape[-1]
    rot = int(hd * cfg.rope_fraction)
    rot -= rot % 2
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    sin, cos = rope_table(positions, rot, cfg.rope_theta)   # [B, S, rot/2]
    sin = sin[:, :, None, :]
    cos = cos[:, :, None, :]
    x1, x2 = x_rot.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _mask_bias(pos_q, pos_k, causal: bool, window: int, dtype):
    """Additive mask [B, 1, 1, Q, S] from position vectors [B,Q], [B,S]
    (window 0 means global; a negative key position is padding)."""
    ok = (pos_k >= 0)[:, None, :]
    dist = pos_q[:, :, None] - pos_k[:, None, :]
    if causal:
        ok = ok & (dist >= 0)
    if window > 0:
        ok = ok & (dist < window)
    bias = torch.where(ok, 0.0, NEG_INF).to(dtype)
    return bias[:, None, None, :, :]


def _attend_block(q, k, v, bias, softcap: float = 0.0):
    """q [B,Q,K,G,h], k/v [B,S,K,h], bias [B,1,1,Q,S] -> [B,Q,K,G,h]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqkgh,bskh->bkgqs", q, k) * scale
    if softcap > 0:
        scores = torch.tanh(scores / softcap) * softcap
    scores = scores.to(torch.float32) + bias.to(torch.float32)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", probs, v)


def attention(q, k, v, pos_q, pos_k, *, causal: bool = True,
              window: int = 0, chunk_q: int = 2048, softcap: float = 0.0):
    """GQA attention. q [B,Q,N,h] with N = K*G heads; k/v [B,S,K,h].

    For Q > chunk_q the query dim is taken in blocks so the peak score
    buffer is [B,K,G,chunk,S] (the JAX package unrolls up to 4 chunks and
    scans beyond; here both are one loop).
    """
    B, Q, N, h = q.shape
    K = k.shape[2]
    G = N // K
    if Q > 1:
        # shard the f32 score tensors: by heads when divisible, else by seq
        q = constrain_heads_or_seq(q, "heads")
        k = constrain_heads_or_seq(k, "kv_heads")
        v = constrain_heads_or_seq(v, "kv_heads")
        # every query reads every key: sequence-sharded k, v are gathered
        k, v = gather_seq(k), gather_seq(v)
    qg = split_heads(q, K)
    # queries sharded over the mesh are chunked by rank: each rank's block
    # alone bounds its score buffer
    if local_len(qg, 1) <= chunk_q:
        bias = _mask_bias(follow_seq(pos_q, qg), pos_k, causal, window,
                          torch.float32)
        return merge(by_query_shard(_attend_block, qg, k, v, bias, softcap),
                     2)
    if Q % chunk_q:
        raise ValueError(f"attention: {Q} queries are not a multiple of "
                         f"chunk_q {chunk_q}")
    outs = []
    for i in range(0, Q, chunk_q):
        bias = _mask_bias(pos_q[:, i:i + chunk_q], pos_k, causal, window,
                          torch.float32)
        outs.append(_attend_block(qg[:, i:i + chunk_q], k, v, bias, softcap))
    return merge(torch.cat(outs, dim=1), 2)


def project(x, w, b=None):
    """x [B,S,D] @ w [D,n,h] (+ b [n,h]) -> [B,S,n,h], contiguous."""
    y = unflatten(rows_matmul(x, merge(w, 1)), 2, w.shape[1:])
    return y if b is None else y + b


def gqa_project(x, p: Dict, cfg: ModelConfig, use_bias: bool):
    """x [B,S,d] -> q [B,S,N,h], k/v [B,S,K,h], each contiguous."""
    return tuple(project(x, p[f"w{n}"], p[f"b{n}"] if use_bias else None)
                 for n in "qkv")


def attn_output(out, p: Dict, use_bias: bool):
    y = rows_matmul(merge(out, 2), merge(p["wo"], 0))
    if use_bias:
        y = y + p["bo"]
    return y


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def _act(name: str, x):
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default
    if name == "relu":
        return F.relu(x)
    raise ValueError(name)


def mlp(x, p: Dict, cfg: ModelConfig):
    if cfg.glu:
        h = _act(cfg.activation, rows_matmul(x, p["w_gate"])) \
            * rows_matmul(x, p["w_up"])
    else:
        h = rows_matmul(x, p["w_up"])
        if cfg.use_bias:
            h = h + p["b_up"]
        h = _act(cfg.activation, h)
    h = constrain(h, ("batch", None, "mlp"))
    y = rows_matmul(h, p["w_down"])
    if cfg.use_bias:
        y = y + p["b_down"]
    return y


# ---------------------------------------------------------------------------
# Chunked cross-entropy (never materializes full [B,S,V] logits in f32)
# ---------------------------------------------------------------------------

def _chunk_nll(h, embed, t, m, softcap: float):
    """Σ of the masked token NLL of one sequence chunk; logits float32.
    (`F.linear`'s backward gives the embedding's gradient contiguous, as
    the fused update's kernel reads it; an einsum's comes back
    transposed.)"""
    # constrain inside the chunk, so the embedding's gradient per chunk
    # keeps the vocab sharding (else it is a replicated f32 [V, D])
    emb = constrain(embed, ("vocab", None))
    logits = rows_matmul(h, emb, linear=True).to(torch.float32)
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    lse = logsumexp_last(logits)
    gold = take_along_last(logits, t)
    return ((lse - gold) * m).sum()


def lm_loss(hidden, embed, targets, mask, *, chunk: int = 512,
            softcap: float = 0.0):
    """Mean token cross-entropy. hidden [B,S,D], embed [V,D], targets [B,S]
    int, mask [B,S]. Logits are taken in sequence chunks of ``chunk`` (the
    whole sequence where ``chunk`` does not divide S, as in the JAX
    package), and each chunk's body runs under activation checkpointing,
    so the backward pass holds one chunk's ``[B, chunk, V]`` float32 logits
    at a time, not every chunk's."""
    B, S, D = hidden.shape
    chunk = min(chunk, S)
    if S % chunk != 0:
        chunk = S  # fallback: single block
    mask = mask.to(torch.float32)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, S, chunk):
        part = slice(i, i + chunk)
        m = mask[:, part]
        tot = tot + checkpoint(_chunk_nll, hidden[:, part], embed,
                               targets[:, part], m, softcap,
                               use_reentrant=False)
        cnt = cnt + m.sum()
    return tot / torch.clamp(cnt, min=1.0)
