"""Training CLI, the port of the JAX package's ``launch/train.py``.

Examples:
  # AsySVRG on a reduced gemma3 on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-4b \\
      --reduced --device cpu --steps 100 --optimizer svrg --lr 0.05

  # on the card (the default device):
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-4b \\
      --reduced --steps 100 --optimizer sgd --checkpoint-dir build/ckpt

  # the hybrid and SSM families take the same flags:
  PYTHONPATH=src python -m repro_torch.launch.train --arch falcon-mamba-7b \\
      --reduced --device cpu --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch recurrentgemma-2b --reduced --steps 20

  # the encoder-decoder and vision families too, with the modality stubs
  # (float32 ones of the frame or patch embeddings) in every batch:
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch whisper-large-v3 --reduced --device cpu --steps 3

The flags are the JAX package's plus ``--device``. The data is
`SyntheticLMDataset` from ``--seed``; the params are drawn on the device
from a generator seeded with ``--seed``. Prints the steps per second and
tokens per second of the steps this call runs (set-up, snapshots and
checkpoints included) beside the device's name.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.config import SVRGConfig, TrainConfig
from repro_torch.configs import get_config, list_configs, reduced_config
from repro_torch.data.synthetic_lm import SyntheticLMDataset
from repro_torch.launch.serve import device_name, modality_inputs
from repro_torch.models.factory import build_model
from repro_torch.train.loop import train
from repro_torch.utils.misc import log


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_configs())
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--optimizer", default="svrg",
                    choices=["svrg", "sgd", "momentum", "adamw"])
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--snapshot-every", type=int, default=25)
    ap.add_argument("--snapshot-batches", type=int, default=4)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if cfg.family == "logreg":
        raise SystemExit(
            f"{cfg.name} has no training path here: its loss reads X and y, "
            "and this CLI feeds token batches; the paper's path trains it "
            "(repro_torch.run_asysvrg, run_sweep)")
    bundle = build_model(cfg, args.device)
    tcfg = TrainConfig(
        steps=args.steps, optimizer=args.optimizer, learning_rate=args.lr,
        seed=args.seed, checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        svrg=SVRGConfig(snapshot_every=args.snapshot_every,
                        snapshot_batches=args.snapshot_batches),
    )
    ds = SyntheticLMDataset(cfg.vocab_size, args.seq, args.batch,
                            seed=args.seed)
    extra = modality_inputs(cfg, args.batch, bundle.device)

    def batch_at(step: int):
        return {**ds.batch_at(step), **extra}

    log(f"training {cfg.name} ({cfg.family}) with {args.optimizer}, "
        f"{args.steps} steps on {device_name(bundle.device)}")
    done = Checkpointer(args.checkpoint_dir).list_steps()
    steps = args.steps - (done[-1] if done else 0)   # a resumed run's share
    t0 = time.perf_counter()
    train(bundle, tcfg, batch_at)
    if bundle.device.type == "cuda":
        torch.cuda.synchronize(bundle.device)
    seconds = time.perf_counter() - t0
    log(f"{steps / seconds:.3f} steps/s, "
        f"{steps * args.batch * args.seq / seconds:.1f} tokens/s on "
        f"{device_name(bundle.device)}")


if __name__ == "__main__":
    main()
