"""Hybrid recurrent family (recurrentgemma-2b / Griffin), the port of the
JAX package's ``models/rglru.py``.

Layers in the repeating pattern (recurrent, recurrent, local attention):
``G`` full groups + ``T`` trailing recurrent layers (26 = 8·3 + 2). The
recurrent block is the RG-LRU: causal conv(4) → gated linear recurrence

    a_t = exp(−c·softplus(Λ)·r_t),  h_t = a_t⊙h_{t−1} + √(1−a_t²)⊙(i_t⊙x_t)

computed as a chunked associative scan (`scan`, the odd/even recursion of
`lax.associative_scan`) within each chunk of the sequence and carried
sequentially across chunks, as the JAX package's ``lax.scan`` does.

The attention layers are the dense block (`transformer.block_apply`, MQA
with the local window): through the flash-attention kernel at prefill
(``attend=transformer.flash_attend``), through the plain differentiable
attention in training (the kernel has no backward), and in plain torch
over a RING-BUFFER cache of ``min(local_window, cache_len)`` slots at
decode: constant memory in the sequence length.

Under a mesh (the dry-run) the residual stream and the recurrent
channels are placed at the JAX package's sites (`sharding.context`); on
plain tensors those calls return their input.
"""
from __future__ import annotations

import functools
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.models import layers as nn
from repro_torch.models import transformer as tf
from repro_torch.sharding.context import (constrain, local_einsum, merge,
                                         propagate_back, rows_matmul,
                                         split_heads, write)
from repro_torch.sharding.rules import ParamDef

RG_C = 8.0
# channel sharding over the `model` mesh axis through the "mlp" rule
RESIDUAL_AXES = ("batch", None, "mlp")
CHUNK = 512


def _pattern(cfg: ModelConfig):
    """Returns (num_groups, num_tail_rec). Pattern = (rec, rec, attn)*G + rec*T."""
    L = cfg.num_layers
    G = L // 3
    tail = L - 3 * G
    return G, tail


def _rec_defs(cfg: ModelConfig, L: int, dt: str) -> Dict:
    D, W = cfg.d_model, cfg.lru_width
    nb = max(1, cfg.num_heads)                  # block-diagonal gate blocks
    bs = W // nb
    return {
        "norm": tf._norm_defs((L, D), cfg, dt),
        "w_x": ParamDef((L, D, W), ("layers", "embed", "mlp"), dtype=dt),
        "w_y": ParamDef((L, D, W), ("layers", "embed", "mlp"), dtype=dt),
        "w_out": ParamDef((L, W, D), ("layers", "mlp", "embed"), dtype=dt),
        "conv_w": ParamDef((L, 4, W), ("layers", "conv", "mlp"), "scaled", scale=0.2, dtype=dt),
        "conv_b": ParamDef((L, W), ("layers", "mlp"), "zeros", dtype=dt),
        "gate_r_w": ParamDef((L, nb, bs, bs), ("layers", None, "mlp", None), dtype=dt),
        "gate_r_b": ParamDef((L, W), ("layers", "mlp"), "zeros", dtype=dt),
        "gate_i_w": ParamDef((L, nb, bs, bs), ("layers", None, "mlp", None), dtype=dt),
        "gate_i_b": ParamDef((L, W), ("layers", "mlp"), "zeros", dtype=dt),
        "lam": ParamDef((L, W), ("layers", "mlp"), "ones", dtype=dt),
    }


def _mlp_defs(cfg: ModelConfig, L: int, dt: str) -> Dict:
    D, F_ = cfg.d_model, cfg.d_ff
    return {
        "norm": tf._norm_defs((L, D), cfg, dt),
        "w_gate": ParamDef((L, D, F_), ("layers", "embed", "mlp"), dtype=dt),
        "w_up": ParamDef((L, D, F_), ("layers", "embed", "mlp"), dtype=dt),
        "w_down": ParamDef((L, F_, D), ("layers", "mlp", "embed"), dtype=dt),
    }


def param_defs(cfg: ModelConfig) -> Dict:
    dt = cfg.param_dtype
    D, V = cfg.d_model, cfg.vocab_size
    G, T = _pattern(cfg)
    p = {
        "tok_embed": ParamDef((V, D), ("vocab", None), "embed", scale=0.02, dtype=dt),
        "rec1": {**_rec_defs(cfg, G, dt), "mlp": _mlp_defs(cfg, G, dt)},
        "rec2": {**_rec_defs(cfg, G, dt), "mlp": _mlp_defs(cfg, G, dt)},
        "attn": tf.block_param_defs(cfg, G, dt),
        "final_norm": tf._norm_defs((D,), cfg, dt),
    }
    if T > 0:
        p["tail"] = {**_rec_defs(cfg, T, dt), "mlp": _mlp_defs(cfg, T, dt)}
    if not cfg.tie_embeddings:
        p["lm_head"] = ParamDef((V, D), ("vocab", None), "embed", scale=0.02, dtype=dt)
    return p


# ---------------------------------------------------------------------------
# The chunked linear recurrence (shared with models/mamba.py)
# ---------------------------------------------------------------------------

def softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0) (`F.softplus` returns x itself
    above a threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _combine(a1, b1, a2, b2):
    """The linear recurrence's operator: (a1, b1) then (a2, b2)."""
    return a1 * a2, a2 * b1 + b2


def _assemble(x, odd, even):
    """The scan of ``x`` along dim 1 from its pieces: x's first element,
    then ``odd`` at positions 1, 3, 5, ... and ``even`` at 2, 4, ...."""
    out = x.new_empty(x.shape)
    out[:, :1] = x[:, :1]
    out[:, 1::2] = odd
    out[:, 2::2] = even
    return out


def scan(a, b):
    """Inclusive scan of h_t = a_t·h_{t−1} + b_t along dim 1 from h = 0:
    (the products of a up to t, h_t), for any length. The odd/even
    recursion of `lax.associative_scan`, the same tree of combines: O(S)
    work, unlike a doubling scan's O(S log S); exact in real arithmetic,
    and never the closed form cumprod / cumsum(b / cumprod), whose
    products underflow float32 within a chunk at falcon-mamba's init."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd_a, odd_b = scan(*_combine(a[:, 0:-1:2], b[:, 0:-1:2],
                                  a[:, 1::2], b[:, 1::2]))
    head = slice(None, -1) if n % 2 == 0 else slice(None)
    ev_a, ev_b = _combine(odd_a[:, head], odd_b[:, head], a[:, 2::2],
                          b[:, 2::2])
    return _assemble(a, odd_a, ev_a), _assemble(b, odd_b, ev_b)


def chunk_len(S: int, chunk: int) -> int:
    """The JAX package's rule: ``min(chunk, S)``, halved until it divides
    S."""
    c = min(chunk, S)
    while S % c != 0:
        c //= 2
    return c


def chunked(body, h0, xs, S: int, chunk: int):
    """Run ``body(h, *x_c) -> (h, y_c)`` over the chunks of the sequence
    tensors ``xs`` (each [B, S, ...]) in order, carrying h as the JAX
    package's ``lax.scan`` does: (h_last, y [B, S, ...]). With more than
    one chunk, under grad, the body is rematerialised
    (``jax.checkpoint``): the backward keeps each chunk's inputs, not its
    scan's levels."""
    c = chunk_len(S, chunk)
    run = body
    if S // c > 1 and torch.is_grad_enabled():
        run = functools.partial(checkpoint, body, use_reentrant=False)
    h, ys = h0, []
    for i in range(0, S, c):
        h, y = run(h, *(x[:, i:i + c] for x in xs))
        ys.append(y)
    return h, torch.cat(ys, dim=1)


# ---------------------------------------------------------------------------
# RG-LRU block
# ---------------------------------------------------------------------------

def _block_diag(x, w):
    """x [B,S,W], w [nb,bs,bs] block-diagonal matmul. The blocks split as
    heads do (`split_heads`): under a mesh whose channel shards the blocks
    do not divide, the sharding moves onto the sequence, not gathered, and
    each rank multiplies its own rows (`local_einsum`)."""
    nb = w.shape[0]
    xb = split_heads(x, nb)
    return merge(local_einsum("bsnk,nkj->bsnj", xb, w), 2)


def _causal_conv(x, conv_w, conv_b, state=None):
    """Depthwise causal conv, width 4. x [B,S,W], conv_w [4,W].
    state [B,3,W] carries the previous 3 inputs (decode)."""
    if state is None:
        pad = x.new_zeros((x.shape[0], 3, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                 # [B, S+3, W]
    S = x.shape[1]
    out = sum(xp[:, j:j + S, :] * conv_w[3 - j] for j in range(4))
    # a copy, not a view: a prefill keeps every layer's state, and a view
    # would keep every layer's whole xp alive with it
    return out + conv_b, xp[:, -3:, :].clone()


def _rg_lru_block(x, gates_r, gates_i, lam, h0):
    """One chunk: x [B,C,W] f32 scan from h0 [B,W]; returns (y, h_last) in
    f32."""
    r = torch.sigmoid(gates_r.to(torch.float32))
    i = torch.sigmoid(gates_i.to(torch.float32))
    log_a = -RG_C * softplus(lam.to(torch.float32)) * r
    a = torch.exp(log_a)
    # √(1 − a²) as the JAX package computes it, by 1 − exp(2·log a): near
    # a = 1 that keeps few bits, so the last-bit rounding of ``exp``
    # (the card's and the CPU's differ) reaches the states
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * i * x.to(torch.float32)
    As, Bs = scan(a, gated)
    Bs = Bs + As * h0[:, None, :]
    return Bs, Bs[:, -1, :].clone()


def rg_lru(x, gates_r, gates_i, lam, h0=None):
    """x [B,S,W] -> (y [B,S,W] in x's dtype, h_last [B,W] float32).

    Chunked associative scan (cf. mamba.selective_scan): within a chunk of
    at most CHUNK steps the scan, across chunks the carried state, so the
    float32 transients are [B, chunk, W]. Each chunk's y is cast to x's
    dtype as it is made."""
    B, S, W = x.shape
    if h0 is None:
        h0 = torch.zeros((B, W), dtype=torch.float32, device=x.device)
    else:
        h0 = h0.to(torch.float32)

    def chunk_body(h_prev, x_c, gr_c, gi_c):
        x_c = constrain(x_c, ("batch", None, "mlp"))
        y, h_last = _rg_lru_block(x_c, gr_c, gi_c, lam, h_prev)
        return h_last, y.to(x.dtype)

    h_last, y = chunked(chunk_body, h0, (x, gates_r, gates_i), S, CHUNK)
    return y, h_last


def _rec_block(cfg: ModelConfig, lp: Dict, h, conv_state=None, h0=None):
    """Returns (h_out, (new_conv_state, new_h_state))."""
    x = nn.apply_norm(cfg, h, lp["norm"])
    xb = constrain(rows_matmul(x, lp["w_x"]), ("batch", None, "mlp"))
    yb = F.gelu(constrain(rows_matmul(x, lp["w_y"]), ("batch", None, "mlp")),
                approximate="tanh")
    xb, new_conv = _causal_conv(xb, lp["conv_w"], lp["conv_b"], conv_state)
    # the gates on the channels' sharding, the layout of the scan's chunks
    # (`rg_lru`): XLA carries it back to them, `DTensor` does not, and
    # without it the gates come out sharded over the sequence, which every
    # chunk then gathers whole
    gr = propagate_back(_block_diag(xb, lp["gate_r_w"]) + lp["gate_r_b"],
                        ("batch", None, "mlp"))
    gi = propagate_back(_block_diag(xb, lp["gate_i_w"]) + lp["gate_i_b"],
                        ("batch", None, "mlp"))
    rec, h_last = rg_lru(xb, gr, gi, lp["lam"], h0)
    h = h + rows_matmul(rec * yb, lp["w_out"])
    x = nn.apply_norm(cfg, h, lp["mlp"]["norm"])
    gate = F.gelu(rows_matmul(x, lp["mlp"]["w_gate"]), approximate="tanh")
    up = rows_matmul(x, lp["mlp"]["w_up"])
    h = h + rows_matmul(gate * up, lp["mlp"]["w_down"])
    return h, (new_conv, h_last)


def _group(cfg: ModelConfig, r1, r2, ap, h, pos, attend):
    """One (rec, rec, attn) group: (h_out, (state1, state2, (k, v)))."""
    h = constrain(h, RESIDUAL_AXES)
    h, s1 = _rec_block(cfg, r1, h)
    h, s2 = _rec_block(cfg, r2, h)
    h, kv = tf.block_apply(cfg, ap, h, pos, cfg.local_window, attend)
    return constrain(h, RESIDUAL_AXES), (s1, s2, kv)


def _group_h(cfg: ModelConfig, r1, r2, ap, h, pos, attend):
    return _group(cfg, r1, r2, ap, h, pos, attend)[0]


# ---------------------------------------------------------------------------
# Full forward
# ---------------------------------------------------------------------------

def hidden_states(cfg: ModelConfig, params, tokens, attend=tf.plain_attend,
                  collect_state=False):
    """Final-norm hidden states [B, S, D] of ``tokens`` [B, S], the
    attention layers attending through ``attend`` (training: the plain,
    differentiable attention; prefill: `transformer.flash_attend`). Each
    group runs under activation checkpointing when ``cfg.remat == "full"``
    (the JAX package's rematerialised scan over groups). With
    ``collect_state`` returns (h, group states, tail states): per group
    ((conv, h) of rec1, of rec2, (k, v)), per tail layer (conv, h)."""
    B, S = tokens.shape
    G, T = _pattern(cfg)
    pos = tf._positions(B, S, tokens.device)
    h = tf.embed_tokens(cfg, params, tokens)
    groups = zip(*(tf._unstack(params[name], G)
                   for name in ("rec1", "rec2", "attn")))
    states = []
    for r1, r2, ap in groups:
        if collect_state:
            h, st = _group(cfg, r1, r2, ap, h, pos, attend)
            states.append(st)
        elif cfg.remat == "full":
            h = checkpoint(_group_h, cfg, r1, r2, ap, h, pos, attend,
                           use_reentrant=False)
        else:
            h = _group_h(cfg, r1, r2, ap, h, pos, attend)
    tail_states = []
    for lp in (tf._unstack(params["tail"], T) if T else []):
        h, st = _rec_block(cfg, lp, h)
        tail_states.append(st)
    h = nn.apply_norm(cfg, h, params["final_norm"])
    if collect_state:
        return h, states, tail_states
    return h


def loss_fn(cfg: ModelConfig, params, batch):
    h = hidden_states(cfg, params, batch["tokens"])
    return nn.lm_loss(h, tf.unembed(cfg, params), batch["targets"],
                      batch["mask"], softcap=cfg.logits_softcap)


# ---------------------------------------------------------------------------
# Serving — ring-buffer attention cache + recurrent states
# ---------------------------------------------------------------------------

def cache_defs(cfg: ModelConfig, batch: int, seq_len: int) -> Dict:
    G, T = _pattern(cfg)
    W = cfg.lru_width
    K, hd = cfg.num_kv_heads, cfg.head_dim
    win = min(cfg.local_window, seq_len)
    return {
        "conv": ParamDef((2 * G + T, batch, 3, W), ("layers", "batch", None, "mlp"), "zeros", dtype=cfg.dtype),
        "rg_h": ParamDef((2 * G + T, batch, W), ("layers", "batch", "mlp"), "zeros", dtype="float32"),
        "k": ParamDef((G, batch, K, win, hd), ("layers", "batch", "cache_kv", "seq", "head_dim"), "zeros", dtype=cfg.dtype),
        "v": ParamDef((G, batch, K, win, hd), ("layers", "batch", "cache_kv", "seq", "head_dim"), "zeros", dtype=cfg.dtype),
    }


def ring_positions(pos: int, win: int, device) -> torch.Tensor:
    """The position ring slot j holds once position ``pos`` is written: the
    newest p <= pos with p ≡ j (mod win), i.e. pos − ((pos − j) mod win);
    negative for a slot not yet written."""
    j = torch.arange(win, dtype=torch.int64, device=device)
    return pos - torch.remainder(pos - j, win)


def prefill(cfg: ModelConfig, params, tokens, cache_len: int):
    """Process a full prompt through the flash-attention kernel; returns
    (last-token logits [B,V] float32, cache): the recurrent states
    interleaved [g0.rec1, g0.rec2, g1.rec1, ..., tail0, ...] and the ring
    [G, B, K, win, h], slot j holding position ``ring_positions(S − 1)[j]``
    (zeros where that is negative)."""
    B, S = tokens.shape
    win = min(cfg.local_window, cache_len)
    dt = getattr(torch, cfg.dtype)
    h, states, tail_states = hidden_states(cfg, params, tokens,
                                           attend=tf.flash_attend,
                                           collect_state=True)
    logits = h[:, -1, :].matmul(tf.unembed(cfg, params).T)

    rec = [s for st in states for s in st[:2]] + tail_states
    p_j = ring_positions(S - 1, win, tokens.device)
    idx = torch.clamp_min(p_j, 0)

    def ring(x):  # [B,S,K,h] -> [B,K,win,h]
        picked = torch.where((p_j >= 0)[None, :, None, None], x[:, idx], 0)
        return picked.transpose(1, 2).to(dt)

    return logits.to(torch.float32), {
        "conv": torch.stack([c for c, _ in rec]).to(dt),
        "rg_h": torch.stack([r for _, r in rec]).to(torch.float32),
        "k": torch.stack([ring(k) for _, _, (k, _) in states]),
        "v": torch.stack([ring(v) for _, _, (_, v) in states]),
    }


def _rec_step(cfg: ModelConfig, lp: Dict, h, cache: Dict, i: int):
    """Recurrent layer ``i`` at decode: its conv and RG-LRU states read
    from ``cache`` and replaced there in place."""
    h, (conv, rg) = _rec_block(cfg, lp, h, conv_state=cache["conv"][i],
                               h0=cache["rg_h"][i])
    write(cache["conv"], (i,), conv.to(cache["conv"].dtype))
    write(cache["rg_h"], (i,), rg)
    return h


def decode_step(cfg: ModelConfig, params, cache: Dict, tokens, pos: int):
    """One decode step. tokens [B] int; ``pos`` the shared position of the
    new token. Each attention layer writes the new K/V into ring slot
    ``pos mod win`` and attends over the ring, an empty slot masked by the
    key position 1 << 30; each recurrent layer steps its states. The cache
    is updated in place and returned. Returns (logits [B,V] float32,
    cache)."""
    B = tokens.shape[0]
    pos = int(pos)
    G, T = _pattern(cfg)
    win = cache["k"].shape[3]
    pos_q = tf._positions(B, 1, tokens.device, pos)
    pos_k = ring_positions(pos, win, tokens.device)
    pos_k = torch.where(pos_k >= 0, pos_k, 1 << 30).to(torch.int32)
    pos_k = pos_k[None, :].expand(B, win)
    h = tf.embed_tokens(cfg, params, tokens[:, None])
    for g in range(G):
        h = _rec_step(cfg, tf._layer(params["rec1"], g), h, cache, 2 * g)
        h = _rec_step(cfg, tf._layer(params["rec2"], g), h, cache, 2 * g + 1)
        ap = tf._layer(params["attn"], g)
        h = tf.decode_attention(cfg, ap, h, cache, g, pos % win, pos_q,
                                pos_k, cfg.local_window)
        x = nn.apply_norm(cfg, h, ap["mlp_norm"])
        h = h + nn.mlp(x, ap["mlp"], cfg)
    for t in range(T):
        h = _rec_step(cfg, tf._layer(params["tail"], t), h, cache, 2 * G + t)
    h = nn.apply_norm(cfg, h, params["final_norm"])
    logits = h[:, 0, :].matmul(tf.unembed(cfg, params).T)
    return logits.to(torch.float32), cache
