"""Serving CLI: prefill a batch of synthetic prompts, decode N tokens.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b \\
      --batch 4 --prompt-len 2048 --new-tokens 16          # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b \\
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b \\
      --batch 4 --prompt-len 2048 --new-tokens 16          # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \\
      --batch 4 --prompt-len 4096 --new-tokens 16          # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \\
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-large-v3 \\
      --batch 4 --prompt-len 448 --new-tokens 16           # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch llama-3.2-vision-11b --reduced --device cpu

The prompts are ``prng.randint(PRNGKey(seed), (batch, prompt_len), 0, V)``,
the JAX package's prompts bit for bit; the weights are drawn by
`init_from_defs` from a ``torch.Generator`` seeded with ``seed`` on the
device, in the activation dtype: serving casts the float32 masters to it
once, and a draw in that dtype is the cast float32 draw bit for bit (the
normal is drawn and scaled in float32 either way), in half the memory,
which is what lets deepseek-moe-16b (65.5 GB in float32, 32.8 GB in bf16)
fit one 80 GB card. The encoder-decoder and vision families get the JAX
CLI's modality stubs beside the prompts (`modality_inputs`: float32 ones of
the frame or patch embeddings). Prints the tokens per second beside the
device's name. An arch without a serve path (``paper-logreg``) is
refused.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch import prng
from repro_torch.configs import get_config, list_configs, reduced_config
from repro_torch.models.factory import _modality_extra, build_model
from repro_torch.serve.loop import generate
from repro_torch.sharding.rules import init_from_defs


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def serve_config(arch: str, reduced: bool = False):
    """``arch``'s config (reduced if asked), its weights drawn in the
    activation dtype, as serving holds them."""
    cfg = reduced_config(arch) if reduced else get_config(arch)
    return cfg.with_overrides(param_dtype=cfg.dtype)


def modality_inputs(cfg, batch: int, device) -> dict:
    """The modality stubs of the JAX CLIs on ``device``: float32 ones of
    ``[batch, encoder_seq, encoder_feature_dim]`` (``enc_feats``, encdec)
    or ``[batch, num_image_tokens, image_embed_dim]`` (``image_embeds``,
    vlm); none for the other families."""
    return {name: torch.ones((batch, *shape), dtype=torch.float32,
                             device=device)
            for name, shape in _modality_extra(cfg).items()}


def run(arch: str, *, reduced: bool = False, batch: int = 4,
        prompt_len: int = 32, new_tokens: int = 16, temperature: float = 0.0,
        seed: int = 0, device=None, inputs=None) -> dict:
    """Build the model, draw its weights (in the activation dtype) and
    prompts from ``seed``, and generate. ``inputs`` are the modality stubs
    of the batch, ``{name: tensor}`` (default: `modality_inputs`). Returns
    the generated tokens (on the CPU), the wall time of `generate` and its
    tokens per second, and what was built: the config, device, bundle,
    params, prompts and the whole batch."""
    cfg = serve_config(arch, reduced)
    bundle = build_model(cfg, device)
    if bundle.prefill_fn is None:
        raise SystemExit(f"{cfg.name} has no serve path")
    gen = torch.Generator(device=bundle.device).manual_seed(seed)
    params = init_from_defs(gen, bundle.param_defs)
    tokens = prng.randint(prng.PRNGKey(seed, bundle.device),
                          (batch, prompt_len), 0, cfg.vocab_size)
    if inputs is None:
        inputs = modality_inputs(cfg, batch, bundle.device)
    prompts = {"tokens": tokens, **inputs}
    cache_len = prompt_len + new_tokens
    if bundle.device.type == "cuda":
        torch.cuda.synchronize(bundle.device)
    t0 = time.perf_counter()
    out = generate(bundle, params, prompts, new_tokens, cache_len,
                   temperature=temperature, seed=seed)
    out = out.cpu()                    # waits for the device
    seconds = time.perf_counter() - t0
    return {"cfg": cfg, "device": bundle.device, "bundle": bundle,
            "params": params, "prompts": tokens, "batch": prompts,
            "tokens": out, "seconds": seconds,
            "tokens_per_s": batch * new_tokens / seconds}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_configs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    res = run(args.arch, reduced=args.reduced, batch=args.batch,
              prompt_len=args.prompt_len, new_tokens=args.new_tokens,
              temperature=args.temperature, seed=args.seed,
              device=args.device)
    print(f"[repro_torch] generated {tuple(res['tokens'].shape)} tokens in "
          f"{res['seconds']:.2f}s ({res['tokens_per_s']:.1f} tok/s) on "
          f"{device_name(res['device'])}", file=sys.stderr, flush=True)
    print(res["tokens"][:, :12].numpy())


if __name__ == "__main__":
    main()
