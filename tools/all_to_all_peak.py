#!/usr/bin/env python3
"""The dry-run's count of an all-to-all against four cards' own.

    python3 tools/all_to_all_peak.py                 # 4 cards, NCCL
    PYTHONPATH=src python3 tools/all_to_all_peak.py --backend gloo
    PYTHONPATH=src python3 tools/all_to_all_peak.py --estimate

Each case moves a `DTensor`'s shard from one tensor dim to another over 4
ranks (``x.redistribute``, which ``DTensor`` runs as one all-to-all:
``_dtensor.shard_dim_alltoall``), on a (4,) or a (2, 2) mesh. Two sides:

- the card's: 4 processes, one card each, NCCL; per rank the bytes the
  caching allocator peaks at above what it held before the move
  (``max_memory_allocated``, from ``reset_peak_memory_stats``) and what it
  holds after it (the new shard), in each of REPS runs after one that
  builds the communicator; the new shard is checked against the tensor's
  own split;
- the dry-run's (``--estimate``, a process of its own): the same move on
  fake tensors over a fake world of 4 ranks under
  `repro_torch.launch.dryrun.Recorder`, its rounded live bytes above the
  input at the peak and after, and the all-to-all bytes it counts.

Prints one JSON line per case and exits 1 unless both sides agree to the
byte on every rank. With ``--backend gloo`` (no card; 4 CPU processes)
only the new shards are checked: gloo has no all-to-all and no allocator
statistics.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
RANKS = 4
REPS = 3            # measured moves per case, after one that is not
SETTLE_S = 1.0      # wait before each, past NCCL's watchdog's 100 ms tick

# name -> (mesh shape, mesh dim names, global shape, dtype, from, to); a
# placement is a tensor dim (Shard) or None (Replicate), one per mesh dim
CASES = {
    "rows_to_cols": ((4,), ("model",), (512, 1024), "float32", (0,), (1,)),
    "cols_to_rows": ((4,), ("model",), (512, 1024), "float32", (1,), (0,)),
    "channels_to_seq": ((2, 2), ("data", "model"), (8, 1024, 768),
                        "bfloat16", (0, 2), (0, 1)),
    "seq_to_channels": ((2, 2), ("data", "model"), (8, 1024, 768),
                        "bfloat16", (0, 1), (0, 2)),
    "rows_to_channels": ((4,), ("model",), (64, 32, 256), "float32", (0,),
                         (2,)),
    "seq_to_channels_one_row": ((4,), ("model",), (1, 512, 1024), "float32",
                                (1,), (2,)),
}


def _placements(dims):
    from torch.distributed.tensor import Replicate, Shard

    return [Replicate() if d is None else Shard(d) for d in dims]


def _mesh(device: str, case):
    from torch.distributed.device_mesh import DeviceMesh

    shape, names = case[0], case[1]
    return DeviceMesh(device, torch.arange(RANKS).reshape(shape),
                      mesh_dim_names=names)


def _local_shape(case):
    shape, _, full, _, src, _ = case
    local = list(full)
    for n, d in zip(shape, src):
        if d is not None:
            local[d] //= n
    return tuple(local)


def estimate() -> dict:
    """{case: {"peak", "held", "all_to_all", "all_gather"}}: the dry-run's
    rounded live bytes above the input at the move's peak and after it,
    and the collective bytes it counts, on a fake world of 4 ranks."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import dryrun

    dryrun.fake_world(RANKS)
    out = {}
    for name, case in CASES.items():
        mesh = _mesh(dryrun.fake_device(), case)
        full, dtype = case[2], getattr(torch, case[3])
        fake_mode = FakeTensorMode()
        with fake_mode:
            x = DTensor.from_local(
                torch.empty(_local_shape(case), dtype=dtype,
                            device=dryrun.fake_device()),
                mesh, _placements(case[4]), run_check=False,
                shape=torch.Size(full), stride=_contiguous(full))
        rec = dryrun.Recorder()
        rec.track(x)
        base = rec.live_rounded
        with dryrun.recording(rec, mesh, fake_mode):
            y = x.redistribute(mesh, _placements(case[5]))
        out[name] = {"peak": rec.peak_rounded - base,
                     "held": rec.live_rounded - base,
                     "all_to_all": rec.collectives["all-to-all"],
                     "all_gather": rec.collectives["all-gather"],
                     "shard": list(y.to_local().shape)}
    return out


def _contiguous(shape):
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _rank(rank: int, port: int, backend: str, queue) -> None:
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    cuda = backend == "nccl"
    if cuda:
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=RANKS)
    device = "cuda" if cuda else "cpu"
    out = {}
    try:
        for name, case in CASES.items():
            mesh = _mesh(device, case)
            full = torch.arange(torch.Size(case[2]).numel(), device=device)
            full = full.reshape(case[2]).to(getattr(torch, case[3]))
            x = distribute_tensor(full, mesh, _placements(case[4]))
            want = distribute_tensor(full, mesh, _placements(case[5]))
            del full
            dst = _placements(case[5])
            x.redistribute(mesh, dst)          # builds the communicator
            rec = {"peak": [], "held": []}
            for _ in range(REPS):
                if cuda:
                    # NCCL's watchdog frees what it kept of the last move
                    torch.cuda.synchronize()
                    time.sleep(SETTLE_S)
                    base = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                y = x.redistribute(mesh, dst)
                if cuda:
                    torch.cuda.synchronize()
                    rec["peak"].append(torch.cuda.max_memory_allocated()
                                       - base)
                    rec["held"].append(torch.cuda.memory_allocated() - base)
                rec["shard"] = list(y.to_local().shape)
                rec["equal"] = bool(torch.equal(y.to_local(),
                                                want.to_local()))
                del y
            out[name] = rec
            del x, want
        queue.put((rank, out))
    finally:
        dist.destroy_process_group()


def measure(backend: str) -> dict:
    """{rank: {case: {"peak", "held", "shard", "equal"}}} from 4 processes
    (``nccl``: one card each; ``gloo``: the CPU, no byte counts)."""
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, port, backend, queue))
             for r in range(RANKS)]
    for p in procs:
        p.start()
    try:
        got = dict(queue.get(timeout=600) for _ in procs)
    finally:
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.kill()
    if any(p.exitcode for p in procs):
        raise RuntimeError(f"a rank failed: {[p.exitcode for p in procs]}")
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", choices=["nccl", "gloo"], default="nccl")
    ap.add_argument("--estimate", action="store_true",
                    help="print the dry-run's counts alone (fake world)")
    args = ap.parse_args(argv)
    if args.estimate:
        print("ESTIMATE", json.dumps(estimate()))
        return 0
    if args.backend == "nccl" and torch.cuda.device_count() < RANKS:
        print(f"needs {RANKS} cards, found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, __file__, "--estimate"], env=env,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise RuntimeError(proc.stderr[-3000:])
    line = [x for x in proc.stdout.splitlines() if x.startswith("ESTIMATE ")]
    est = json.loads(line[0][len("ESTIMATE "):])
    got = measure(args.backend)
    ok = True
    for name in CASES:
        ranks = [got[r][name] for r in range(RANKS)]
        rec = {"case": name, "estimate": est[name], "ranks": ranks}
        agree = all(r["equal"] and r["shard"] == est[name]["shard"]
                    for r in ranks)
        if args.backend == "nccl":
            agree = agree and all(
                r["peak"] == [est[name]["peak"]] * REPS
                and r["held"] == [est[name]["held"]] * REPS for r in ranks)
        rec["agree"] = agree
        ok = ok and agree
        print(json.dumps(rec))
    if torch.cuda.is_available():
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    print(json.dumps({"ok": ok, "backend": args.backend,
                      "torch": torch.__version__}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
