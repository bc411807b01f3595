#!/usr/bin/env python3
"""Where whisper-large-v3's float32 prefill on the card parts from the CPU's.

    python3 tools/bisect_encdec.py            # from the repository root, on the card

It draws the whisper case of `chip_smoke.py`'s `serve_encdec_vlm_card_vs_cpu`
phase (full width, 2 encoder + 2 decoder layers drawn as the full model's
first layers, every zero-initialised leaf drawn, seed 11, batch 2, prompt
64, the frame embeddings drawn from the seed) and runs one prefill stage
by stage three ways: on the card in float32, on the CPU in float32 and on
the CPU in float64 (params cast; the sinusoid table, the attention's
scores and the layernorms in float64 too, where the model keeps them in
float32: the function itself). For each stage
— the sinusoid table, the encoder's input, each encoder layer's residual,
the encoder's output, each decoder layer's cross K/V and residual, the
logits — it prints the largest gap card-float64, CPU-float64 and card-CPU,
each over the stage's largest float64 magnitude. The stage where the
card's gap to float64 first rises above the CPU's is the stage at fault.

The card runs twice: with the table as `models/encdec._sinusoid` builds it
(on the CPU, moved to the card) and with the table computed on the card
(`device_sinusoid`, the formula on the positions' device). Then the other
two candidates on the same inputs: K4's CUDA-core route at the encoder's
shape (1504 queries over the 1500 valid frames, N = K = 20, h 64, float32;
encoder layer 0's q, k, v) against `attention_ref` on the card, on the CPU
and in float64; and the float32 layernorm with its bias, card against CPU.
One JSON line per part.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

SEED, BATCH, PROMPT = 11, 2, 64


def attend64(q, k, v, pos_q, pos_k, *, causal: bool, n_keys: int):
    """`encdec.flash_attend`'s attention in float64 throughout (q [B,S,N,h],
    k/v over their first ``n_keys`` rows, MHA)."""
    q, k, v = (a.transpose(1, 2) for a in (q, k[:, :n_keys], v[:, :n_keys]))
    scores = torch.einsum("bnqh,bnkh->bnqk", q, k) / q.shape[-1] ** 0.5
    if causal:
        Sq, Sk = scores.shape[-2:]
        ok = torch.ones(Sq, Sk, dtype=torch.bool).tril()
        scores = scores.masked_fill(~ok, float("-inf"))
    return torch.einsum("bnqk,bnkh->bnqh", scores.softmax(-1), v).transpose(1, 2)


def layernorm64(x, scale, bias, eps: float = 1e-5):
    """`layers.layernorm` in float64 throughout."""
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def device_sinusoid(positions, dim: int):
    """The table computed on the positions' device: the formula of
    `encdec._sinusoid` with every op where ``positions`` lie."""
    half = dim // 2
    step = torch.tensor(10000.0, device=positions.device).log() / max(1, half - 1)
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=positions.device) * step)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def float64_sinusoid(positions, dim: int):
    """The table in float64 throughout: the function itself."""
    half = dim // 2
    step = torch.tensor(10000.0, dtype=torch.float64).log() / max(1, half - 1)
    freqs = torch.exp(-torch.arange(half, dtype=torch.float64) * step)
    ang = positions.cpu().to(torch.float64)[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def stages(cfg, params, feats, tokens, sinusoid, attend=None):
    """One prefill of ``cfg`` stage by stage ({name: tensor on the CPU}),
    the table from ``sinusoid`` (any device; moved to the run's), the
    attention through ``attend`` (default `encdec.flash_attend`)."""
    from repro_torch.models import encdec
    from repro_torch.models import layers as nn
    from repro_torch.models import transformer as tf

    attend = attend or encdec.flash_attend

    out = {}
    dev = feats.device
    dt = getattr(torch, cfg.dtype)
    B, S, _ = feats.shape
    Sp = encdec.enc_seq_padded(cfg)
    feats = F.pad(feats, (0, 0, 0, Sp - S))
    pos = encdec._positions(B, Sp, S, dev)
    table = sinusoid(pos.clamp(min=0), cfg.d_model).to(dev)
    out["sinusoid_encoder"] = table
    h = torch.einsum("bsf,fd->bsd", feats.to(dt), params["enc_in_proj"].to(dt))
    h = h + table.to(h.dtype)
    out["encoder_input"] = h
    for i, lp in enumerate(tf._unstack(params["enc_blocks"],
                                       cfg.encoder_layers)):
        h = encdec._enc_block(cfg, lp, h, pos, S, attend)
        out[f"encoder_layer_{i}"] = h
    enc_out = nn.apply_norm(cfg, h, params["enc_final_norm"])
    out["encoder_output"] = enc_out
    Sd = tokens.shape[1]
    dpos = tf._positions(B, Sd, dev)
    enc_pos = encdec._enc_positions(cfg, B, Sp, dev)
    h = params["tok_embed"][tokens].to(dt)
    h = h + sinusoid(dpos, cfg.d_model).to(dev, h.dtype)
    out["decoder_input"] = h
    for i in range(cfg.num_layers):
        h, _, (ek, ev) = encdec._dec_block(
            cfg, tf._layer(params["dec_blocks"], i), h, dpos, enc_out,
            enc_pos, attend)
        out[f"cross_kv_{i}"] = torch.stack([ek, ev])
        out[f"decoder_layer_{i}"] = h
    h = nn.apply_norm(cfg, h, params["final_norm"])
    out["logits"] = h[:, -1, :].matmul(params["tok_embed"].T).to(torch.float32)
    return {k: v.cpu() for k, v in out.items()}


def gap(a, b, ref):
    return float((a.double() - b.double()).abs().max()
                 / max(1e-30, float(ref.abs().max())))


def compare(card, cpu, f64):
    return {name: dict(card_vs_f64=gap(card[name], f64[name], f64[name]),
                       cpu_vs_f64=gap(cpu[name], f64[name], f64[name]),
                       card_vs_cpu=gap(card[name], cpu[name], f64[name]),
                       max_abs_card_vs_cpu=float((card[name].double()
                                                  - cpu[name].double())
                                                 .abs().max()))
            for name in f64}


def main() -> int:
    if not torch.cuda.is_available():
        print("bisect_encdec: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import gqa_flash
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import encdec
    from repro_torch.models import layers as nn
    from repro_torch.models import transformer as tf
    from repro_torch.models.factory import build_model
    from repro_torch.sharding.rules import init_from_defs, tree_map

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    (arch, overrides, _), = [c for c in cs.ENCDEC_VLM_CUT
                             if c[0] == cs.ENCDEC_ARCH]
    full = get_config(arch)
    cfg = full.with_overrides(dtype="float32", **overrides)
    model = build_model(cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_from_defs(gen, model.param_defs)
    cs.scale_to_full_depth(params, model.param_defs,
                           build_model(full, "cuda").param_defs)
    cs.draw_zero_leaves(params, model.param_defs, gen)
    tokens = prng.randint(prng.PRNGKey(SEED), (BATCH, PROMPT), 0,
                          cfg.vocab_size)
    feats = cs.modality_draws(cfg, BATCH, SEED)["enc_feats"]

    with torch.no_grad():
        card = stages(cfg, params, feats, tokens.cuda(), encdec._sinusoid)
        card_dev = stages(cfg, params, feats, tokens.cuda(), device_sinusoid)
        p_cpu = tree_map(lambda t: t.cpu(), params)
        cpu = stages(cfg, p_cpu, feats.cpu(), tokens.cpu(), encdec._sinusoid)
        cfg64 = cfg.with_overrides(dtype="float64", param_dtype="float64")
        plain_layernorm, nn.layernorm = nn.layernorm, layernorm64
        try:
            f64 = stages(cfg64, tree_map(torch.Tensor.double, p_cpu),
                         feats.cpu().double(), tokens.cpu(),
                         float64_sinusoid, attend64)
        finally:
            nn.layernorm = plain_layernorm
    print(json.dumps(dict(part="stages", arch=cfg.name,
                          encoder_layers=cfg.encoder_layers,
                          layers=cfg.num_layers, batch=BATCH, prompt=PROMPT,
                          seed=SEED, card_table_on_cpu=compare(card, cpu, f64),
                          card_table_on_card=compare(card_dev, cpu, f64))),
          flush=True)

    # K4's CUDA-core route at the encoder's shape, on encoder layer 0's own
    # q, k, v (the card run's encoder input, the CPU-built table)
    with torch.no_grad():
        lp = tf._layer(params["enc_blocks"], 0)
        x = nn.apply_norm(cfg, card["encoder_input"].cuda(), lp["attn_norm"])
        q, k, v = nn.gqa_project(x, lp["attn"], cfg, cfg.use_qkv_bias)
        n_keys = cfg.encoder_seq
        k4 = gqa_flash(q, k[:, :n_keys], v[:, :n_keys], causal=False)
        t = lambda a: a.transpose(1, 2)                       # noqa: E731
        ref_card = t(attention_ref(t(q), t(k[:, :n_keys]), t(v[:, :n_keys]),
                                   causal=False))
        qc, kc, vc = (a.cpu() for a in (q, k[:, :n_keys], v[:, :n_keys]))
        ref_cpu = t(attention_ref(t(qc), t(kc), t(vc), causal=False))
        ref64 = attend64(qc.double(), kc.double(), vc.double(), None, None,
                         causal=False, n_keys=n_keys)
        k4, ref_card = k4.cpu(), ref_card.cpu()
        scores = torch.einsum("bqnh,bknh->bnqk", qc, kc) / cfg.head_dim ** 0.5
        # the layernorm with its bias on the same input, card and CPU
        h0 = card["encoder_layer_0"]
        ln_card = nn.apply_norm(cfg, h0.cuda(), lp["mlp_norm"]).cpu()
        ln_cpu = nn.apply_norm(cfg, h0, {k: v.cpu()
                                         for k, v in lp["mlp_norm"].items()})
        ln64 = layernorm64(h0.double(), lp["mlp_norm"]["scale"].cpu().double(),
                           lp["mlp_norm"]["bias"].cpu().double())
    print(json.dumps(dict(
        part="kernel_and_norm", shape=dict(B=BATCH, Sq=q.shape[1], Sk=n_keys,
                                           N=cfg.num_heads, K=cfg.num_kv_heads,
                                           h=cfg.head_dim, dtype="float32"),
        route=gqa_flash.launches_by_route, max_score=float(scores.abs().max()),
        k4_vs_ref_card=gap(k4, ref_card, ref64),
        k4_vs_ref_cpu=gap(k4, ref_cpu, ref64),
        k4_vs_f64=gap(k4, ref64, ref64), ref_card_vs_f64=gap(ref_card, ref64,
                                                             ref64),
        ref_cpu_vs_f64=gap(ref_cpu, ref64, ref64),
        layernorm=dict(card_vs_cpu=gap(ln_card, ln_cpu, ln64),
                       card_vs_f64=gap(ln_card, ln64, ln64),
                       cpu_vs_f64=gap(ln_cpu, ln64, ln64)))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
