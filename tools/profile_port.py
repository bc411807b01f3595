#!/usr/bin/env python3
"""Where the port's AsySVRG inner loop spends its time on the card.

    python3 tools/profile_port.py

At the rcv1 width (n = 20242, p = 2048; data from
`repro_torch.data.libsvm.make_synthetic_libsvm("rcv1")`), for a single run
(1 row) and a sweep group (4 rows, one per scheme plus serial SVRG), it runs
2048 inner updates of `repro_torch.core.asysvrg._epoch_core`:

  * once without the profiler, timed on the host clock around a
    synchronised run: wall seconds per inner update;
  * once under ``torch.profiler`` (CPU + CUDA activities): the device-busy
    share of the window (summed kernel time over wall time), the device
    kernels by total time, and the host ops by self time.

Prints one JSON line per configuration, and the card's name and power limit
first. Needs a CUDA device; fails without one.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
STEPS = 2048


def _epoch(obj, rows):
    from repro_torch import prng
    from repro_torch.core.asysvrg import SCHEME_IDS, _epoch_core

    schemes = ["inconsistent", "consistent", "unlock", "consistent"][:rows]
    taus = [7, 7, 7, 0][:rows]
    delays = [1 if t else 0 for t in taus]
    keys = prng.split(prng.PRNGKey(0, "cuda"), rows)
    w = torch.zeros((rows, obj.p), device="cuda")
    eta = torch.full((rows,), 2.0, device="cuda")
    return lambda total: _epoch_core(
        obj, obj.data_args(), w, keys, eta, taus,
        [SCHEME_IDS[s] for s in schemes], delays, total=total, buf_len=8,
        option=2, drop_prob=0.02)


def _device_time_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile(obj, rows: int, steps: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    run = _epoch(obj, rows)
    run(64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    with torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=_device_time_us, reverse=True)
    busy_us = sum(_device_time_us(e) for e in kernels)
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    return {
        "rows": rows, "steps": steps, "n": obj.n, "p": obj.p,
        "wall_s_per_step": wall / steps,
        "profiled_wall_s_per_step": prof_wall / steps,
        "device_busy_share": busy_us * 1e-6 / prof_wall,
        "device_kernels": [
            {"name": e.key[:80], "count": e.count,
             "total_us": _device_time_us(e),
             "us_per_launch": _device_time_us(e) / max(1, e.count)}
            for e in kernels[:10]],
        "host_ops": [
            {"name": e.key[:60], "count": e.count,
             "self_us": e.self_cpu_time_total,
             "self_us_per_step": e.self_cpu_time_total / steps}
            for e in host[:12]],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import LogisticRegression
    from repro_torch.data.libsvm import make_synthetic_libsvm

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    ds = make_synthetic_libsvm("rcv1", scale=1.0)
    obj = LogisticRegression(ds.X, ds.y, ds.l2_reg)
    for rows in (1, 4):
        print(json.dumps(profile(obj, rows, STEPS)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
