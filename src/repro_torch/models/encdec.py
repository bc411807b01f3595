"""Encoder-decoder family (whisper-large-v3 backbone), the port of the JAX
package's ``models/encdec.py``.

The audio frontend (mel + 2x conv) is a stub, as in the JAX package: the
batch supplies precomputed frame embeddings ``[B, encoder_seq,
encoder_feature_dim]`` and a learned input projection maps them to
d_model. Sinusoidal positions for both encoder and decoder (the JAX
package's recorded deviation from whisper's learned decoder table).
Whisper details kept: pre-LN layernorm, GELU (non-GLU) MLP, biases on, MHA,
tied embeddings, no RoPE.

The encoder's frames are padded to a multiple of 16 (1500 -> 1504,
`enc_seq_padded`); the padded frames carry position -2^30 and no query
attends to them. Two lengths mask them, as in the JAX package: the
encoder's own attention by the frames given (``enc_feats.shape[1]``), the
decoder's cross-attention by ``cfg.encoder_seq`` (`_enc_positions`).

Prefill attends through the flash-attention kernel (`gqa_flash`, K4) three
ways per layer: the encoder non-causally over its valid frames, the
decoder causally over the prompt, and the cross-attention non-causally
over the encoder's valid frames. The padded frames are the last rows of
the key buffer, so the kernel is handed the view of the valid rows
(``k[:, :n_keys]``), which is what the JAX package's mask computes: a key
whose weight is exactly 0 drops out of every sum. Training attends through
the plain, differentiable `layers.attention` (the kernel has no backward);
decode attends there too, over the caches.

Params are the JAX package's nested dict, layer weights stacked ``[L,
...]``; each JAX scan over layers is a Python loop. Caches: ``k``, ``v``
``[L, B, K, cache_len, h]`` and the cross-attention's ``xk``, ``xv`` ``[L,
B, K, S_pad, h]``, computed once at prefill.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch._guards import detect_fake_mode
from torch._subclasses.fake_tensor import unset_fake_temporarily
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.kernels.flash_attention.ops import gqa_flash
from repro_torch.models import layers as nn
from repro_torch.models import transformer as tf
from repro_torch.sharding.context import constrain, placed, write, zeros
from repro_torch.sharding.rules import ParamDef

NEG_POS = -(1 << 30)      # the position of a padded frame


def _sinusoid(positions, dim: int):
    """[B,S] -> [B,S,dim] float32 sinusoidal embeddings, computed on the CPU
    (``positions`` are copied there if they lie elsewhere), as the JAX
    package computes its table; callers move the table to their device.
    The card's float32 ``exp`` and ``sin`` round apart from the CPU's, and
    at the encoder's positions (to 1503) an ulp of a frequency moves an
    angle by ~1e-4 rad: a table computed on the card put the card's float32
    whisper logits 3e-3 to 5e-3 from the CPU's."""
    half = dim // 2
    step = torch.tensor(10000.0).log() / max(1, half - 1)
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32) * step)
    ang = positions.cpu().to(torch.float32)[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


_TABLE_BLOCK = 4096       # the resident table grows by this many positions
_TABLES: Dict[Tuple[int, torch.device], torch.Tensor] = {}


def _sinusoid_table(n: int, dim: int, device) -> torch.Tensor:
    """[n', dim] float32 table of positions 0 .. n'-1 (n' >= n, a multiple
    of `_TABLE_BLOCK`) resident on ``device``. One CPU table per ``dim``
    (`_sinusoid`) is computed when a longer one is first asked for, and
    each device holds a copy of it: every device adds the same bits, and a
    decode step indexes its device's copy instead of copying a table to
    the card for every token."""
    device = torch.device(device)
    with unset_fake_temporarily():     # a host constant, real in a dry-run
        cpu = _TABLES.get((dim, torch.device("cpu")))
        if cpu is None or cpu.shape[0] < n:
            rows = -(-max(n, 1) // _TABLE_BLOCK) * _TABLE_BLOCK
            cpu = _sinusoid(torch.arange(rows, dtype=torch.int32)[None],
                            dim)[0]
            for key in [k for k in _TABLES if k[0] == dim]:
                del _TABLES[key]
            _TABLES[(dim, torch.device("cpu"))] = cpu
    fake_mode = detect_fake_mode()
    if fake_mode is not None:
        # the dry-run: a fake copy on the device, kept by no one
        return fake_mode.from_tensor(cpu).to(device)
    table = _TABLES.get((dim, device))
    if table is None:
        table = _TABLES[(dim, device)] = cpu.to(device)
    return table


def _xattn_defs(cfg: ModelConfig, L: int, dtype: str) -> Dict:
    D, N, K, h = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": ParamDef((L, D, N, h), ("layers", "embed", "heads", "head_dim"), dtype=dtype),
        "wk": ParamDef((L, D, K, h), ("layers", "embed", "kv_heads", "head_dim"), dtype=dtype),
        "wv": ParamDef((L, D, K, h), ("layers", "embed", "kv_heads", "head_dim"), dtype=dtype),
        "wo": ParamDef((L, N, h, D), ("layers", "heads", "head_dim", "embed"), dtype=dtype),
    }
    if cfg.use_qkv_bias:
        p["bq"] = ParamDef((L, N, h), ("layers", "heads", "head_dim"), "zeros", dtype=dtype)
        p["bk"] = ParamDef((L, K, h), ("layers", "kv_heads", "head_dim"), "zeros", dtype=dtype)
        p["bv"] = ParamDef((L, K, h), ("layers", "kv_heads", "head_dim"), "zeros", dtype=dtype)
    if cfg.use_bias:
        p["bo"] = ParamDef((L, D), ("layers", "embed"), "zeros", dtype=dtype)
    return p


def param_defs(cfg: ModelConfig) -> Dict:
    dt = cfg.param_dtype
    D, V, F_ = cfg.d_model, cfg.vocab_size, cfg.encoder_feature_dim
    Le, Ld = cfg.encoder_layers, cfg.num_layers
    dec_blocks = tf.block_param_defs(cfg, Ld, dt)
    dec_blocks["xattn_norm"] = tf._norm_defs((Ld, D), cfg, dt)
    dec_blocks["xattn"] = _xattn_defs(cfg, Ld, dt)
    return {
        "tok_embed": ParamDef((V, D), ("vocab", None), "embed", scale=0.02, dtype=dt),
        "enc_in_proj": ParamDef((F_, D), ("embed_no_fsdp", None), dtype=dt),
        "enc_blocks": tf.block_param_defs(cfg, Le, dt),
        "enc_final_norm": tf._norm_defs((D,), cfg, dt),
        "dec_blocks": dec_blocks,
        "final_norm": tf._norm_defs((D,), cfg, dt),
    }


# ---------------------------------------------------------------------------
# Attention: the kernel at prefill, the plain attention in training
# ---------------------------------------------------------------------------

def flash_attend(q, k, v, pos_q, pos_k, *, causal: bool, n_keys: int):
    """Through the flash-attention kernel over the first ``n_keys`` keys:
    the keys past them are the padded ones, which the positions mask."""
    return gqa_flash(q, k[:, :n_keys], v[:, :n_keys], causal=causal, window=0)


def plain_attend(q, k, v, pos_q, pos_k, *, causal: bool, n_keys: int):
    """The plain `layers.attention`, masked by the positions, as the JAX
    package calls it."""
    return nn.attention(q, k, v, pos_q, pos_k, causal=causal, window=0,
                        chunk_q=2048)


def _positions(B: int, S: int, n_valid: int, device):
    """[B, S] int32: arange(S), with NEG_POS at and past ``n_valid``."""
    pos = torch.arange(S, dtype=torch.int32, device=device)
    pos = torch.where(pos < n_valid, pos, NEG_POS)
    return placed(pos[None, :].expand(B, S), ("batch", None))


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def enc_seq_padded(cfg: ModelConfig, pad_to: int = 16) -> int:
    """Encoder frames padded up to a multiple of ``pad_to`` (1500 -> 1504),
    the JAX package's TP-shardable length. Padded frames carry position
    -2^30 and are masked."""
    return -(-cfg.encoder_seq // pad_to) * pad_to


def _enc_block(cfg: ModelConfig, lp: Dict, h, pos, n_keys: int, attend):
    h = constrain(h, tf.RESIDUAL_AXES)
    x = nn.apply_norm(cfg, h, lp["attn_norm"])
    q, k, v = nn.gqa_project(x, lp["attn"], cfg, cfg.use_qkv_bias)
    out = attend(q, k, v, pos, pos, causal=False, n_keys=n_keys)
    h = h + nn.attn_output(out, lp["attn"], cfg.use_bias)
    x = nn.apply_norm(cfg, h, lp["mlp_norm"])
    return constrain(h + nn.mlp(x, lp["mlp"], cfg), tf.RESIDUAL_AXES)


def encode(cfg: ModelConfig, params, enc_feats, attend=flash_attend):
    """enc_feats [B, S_enc, F] (the stub frontend's output) -> [B, S_pad, D].
    ``attend`` is `flash_attend` at prefill (the default), `plain_attend`
    in training, where each block runs under activation checkpointing when
    ``cfg.remat == "full"``."""
    B, S, _ = enc_feats.shape
    Sp = enc_seq_padded(cfg)
    dt = getattr(torch, cfg.dtype)
    if Sp - S:
        enc_feats = F.pad(enc_feats, (0, 0, 0, Sp - S))
    pos = _positions(B, Sp, S, enc_feats.device)
    h = torch.einsum("bsf,fd->bsd", enc_feats.to(dt),
                     params["enc_in_proj"].to(dt))
    table = _sinusoid_table(S, cfg.d_model, h.device)
    h = h + table[pos.clamp(min=0).long()].to(h.dtype)
    for lp in tf._unstack(params["enc_blocks"], cfg.encoder_layers):
        if attend is plain_attend and cfg.remat == "full":
            h = checkpoint(_enc_block, cfg, lp, h, pos, S, attend,
                           use_reentrant=False)
        else:
            h = _enc_block(cfg, lp, h, pos, S, attend)
    return nn.apply_norm(cfg, h, params["enc_final_norm"])


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def _dec_block(cfg: ModelConfig, lp: Dict, h, pos, enc_out, enc_pos, attend):
    """One decoder layer: causal self-attention, cross-attention to the
    encoder's output, MLP. Returns (h_out, (k, v) of the self-attention,
    (ek, ev) of the cross-attention)."""
    h = constrain(h, tf.RESIDUAL_AXES)
    x = nn.apply_norm(cfg, h, lp["attn_norm"])
    q, k, v = nn.gqa_project(x, lp["attn"], cfg, cfg.use_qkv_bias)
    out = attend(q, k, v, pos, pos, causal=True, n_keys=k.shape[1])
    h = h + nn.attn_output(out, lp["attn"], cfg.use_bias)
    x = nn.apply_norm(cfg, h, lp["xattn_norm"])
    xa = lp["xattn"]
    bias = cfg.use_qkv_bias
    q = nn.project(x, xa["wq"], xa["bq"] if bias else None)
    ek = nn.project(enc_out, xa["wk"], xa["bk"] if bias else None)
    ev = nn.project(enc_out, xa["wv"], xa["bv"] if bias else None)
    out = attend(q, ek, ev, pos, enc_pos, causal=False,
                 n_keys=cfg.encoder_seq)
    h = h + nn.attn_output(out, xa, cfg.use_bias)
    x = nn.apply_norm(cfg, h, lp["mlp_norm"])
    h = constrain(h + nn.mlp(x, lp["mlp"], cfg), tf.RESIDUAL_AXES)
    return h, (k, v), (ek, ev)


def _train_dec_block(cfg, lp, h, pos, enc_out, enc_pos):
    return _dec_block(cfg, lp, h, pos, enc_out, enc_pos, plain_attend)[0]


def _enc_positions(cfg: ModelConfig, B: int, Sp: int, device):
    """The cross-attention's key positions: the padded frames past
    ``cfg.encoder_seq`` at -2^30."""
    return _positions(B, Sp, cfg.encoder_seq, device)


def _embed(cfg: ModelConfig, params, tokens, start: int = 0):
    """Token embeddings plus the sinusoid of positions ``start`` onwards."""
    S = tokens.shape[1]
    h = params["tok_embed"][tokens].to(getattr(torch, cfg.dtype))
    table = _sinusoid_table(start + S, cfg.d_model, h.device)
    return h + table[start:start + S].to(h.dtype)


def _decoder_hidden(cfg: ModelConfig, params, tokens, enc_out):
    """Training forward of the decoder: final-norm hidden states [B, S, D]."""
    B, S = tokens.shape
    pos = tf._positions(B, S, tokens.device)
    enc_pos = _enc_positions(cfg, B, enc_out.shape[1], tokens.device)
    h = _embed(cfg, params, tokens)
    for lp in tf._unstack(params["dec_blocks"], cfg.num_layers):
        if cfg.remat == "full":
            h = checkpoint(_train_dec_block, cfg, lp, h, pos, enc_out,
                           enc_pos, use_reentrant=False)
        else:
            h = _train_dec_block(cfg, lp, h, pos, enc_out, enc_pos)
    return nn.apply_norm(cfg, h, params["final_norm"])


def loss_fn(cfg: ModelConfig, params, batch):
    enc_out = encode(cfg, params, batch["enc_feats"], attend=plain_attend)
    h = _decoder_hidden(cfg, params, batch["tokens"], enc_out)
    return nn.lm_loss(h, params["tok_embed"], batch["targets"], batch["mask"])


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def cache_defs(cfg: ModelConfig, batch: int, seq_len: int) -> Dict:
    L, K, h = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    Se = enc_seq_padded(cfg)
    ax = ("layers", "batch", "cache_kv", "seq_shard", "head_dim")
    return {
        "k": ParamDef((L, batch, K, seq_len, h), ax, "zeros", dtype=cfg.dtype),
        "v": ParamDef((L, batch, K, seq_len, h), ax, "zeros", dtype=cfg.dtype),
        "xk": ParamDef((L, batch, K, Se, h), ax, "zeros", dtype=cfg.dtype),
        "xv": ParamDef((L, batch, K, Se, h), ax, "zeros", dtype=cfg.dtype),
    }


def prefill(cfg: ModelConfig, params, enc_feats, tokens, cache_len: int):
    """Encode the audio and run the decoder over the prompt; returns
    (last-token logits [B, V] float32, caches: ``k``, ``v`` zero past the
    prompt, ``xk``, ``xv`` the cross-attention's K/V of every encoder
    frame, the padded ones included)."""
    enc_out = encode(cfg, params, enc_feats)
    B, S = tokens.shape
    Se = enc_out.shape[1]
    pos = tf._positions(B, S, tokens.device)
    enc_pos = _enc_positions(cfg, B, Se, tokens.device)
    h = _embed(cfg, params, tokens)
    dt = getattr(torch, cfg.dtype)
    L, K, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    cache = {name: zeros(d.shape, dt, h.device, d.axes)
             for name, d in cache_defs(cfg, B, cache_len).items()}
    for i in range(L):
        h, (k, v), (ek, ev) = _dec_block(
            cfg, tf._layer(params["dec_blocks"], i), h, pos, enc_out, enc_pos,
            flash_attend)
        at = (i, slice(None), slice(None), slice(0, S))
        write(cache["k"], at, k.transpose(1, 2))
        write(cache["v"], at, v.transpose(1, 2))
        write(cache["xk"], (i,), ek.transpose(1, 2))
        write(cache["xv"], (i,), ev.transpose(1, 2))
    h = nn.apply_norm(cfg, h, params["final_norm"])
    logits = h[:, -1, :].matmul(params["tok_embed"].T)
    return logits.to(torch.float32), cache


def decode_step(cfg: ModelConfig, params, cache: Dict, tokens, pos: int):
    """One decode step; tokens [B] int, ``pos`` the new token's position.
    Returns (logits [B, V] float32, cache), the self-attention caches
    updated in place (`transformer.decode_attention`: no RoPE here)."""
    B = tokens.shape[0]
    pos = int(pos)
    S, Se = cache["k"].shape[3], cache["xk"].shape[3]
    pos_q = tf._positions(B, 1, tokens.device, pos)
    pos_k = tf._positions(B, S, tokens.device)
    enc_pos = _enc_positions(cfg, B, Se, tokens.device)
    h = _embed(cfg, params, tokens[:, None], pos)
    for i in range(cfg.num_layers):
        lp = tf._layer(params["dec_blocks"], i)
        h = tf.decode_attention(cfg, lp, h, cache, i, pos, pos_q, pos_k, 0)
        x = nn.apply_norm(cfg, h, lp["xattn_norm"])
        xa = lp["xattn"]
        q = nn.project(x, xa["wq"], xa["bq"] if cfg.use_qkv_bias else None)
        out = nn.attention(q, cache["xk"][i].transpose(1, 2),
                           cache["xv"][i].transpose(1, 2), pos_q, enc_pos,
                           causal=False, window=0)
        h = h + nn.attn_output(out, xa, cfg.use_bias)
        x = nn.apply_norm(cfg, h, lp["mlp_norm"])
        h = h + nn.mlp(x, lp["mlp"], cfg)
    h = nn.apply_norm(cfg, h, params["final_norm"])
    logits = h[:, 0, :].matmul(params["tok_embed"].T)
    return logits.to(torch.float32), cache
