#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (`src/repro_torch`) on one NVIDIA H100.

    python3 chip_smoke.py          # from the repository root, on a machine with the card

It builds the port's CUDA kernels from `src/repro_torch/csrc/` with nvcc
(sm_90a), holds each kernel against its plain torch version on the card at
the main path's shapes, drives the main path at the full width of the rcv1
configuration (n = 20242, p = 2048) through the entry points a user calls
(`run_asysvrg`, `run_sweep`), checks from the launch counters that every
inner update went through `svrg_update` and every snapshot gradient through
`logreg_grad`, and holds the card's epoch against the port's CPU path.

Each phase prints one JSON line; any failed check raises and the script
exits non-zero. The second-to-last line is the kernel report, the last line
`{"ok": true, "device": {...}}`. With no CUDA device, or without the rest of
the repository beside it, the script fails before printing any result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and float32 outside the
# tensor cores, the unit both kernels run on.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
RCV1_EPOCHS = 2
STEP_SIZE = 2.0        # benchmarks/table2_schemes.py's step
THREADS = 8            # p = 8 simulated threads, tau = p - 1 = 7


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def bound_ms(nbytes: float, flops: float):
    """(least time in ms, what bounds it) for moving ``nbytes`` through HBM
    and doing ``flops`` float32 operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def median_ms(fn, reps: int = 11, inner: int = 20) -> float:
    """Median over ``reps`` CUDA-event windows of ``inner`` back-to-back
    calls, per call, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return float(np.median(times))


def phase_device():
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    ptxas = {}
    for name in _build.SOURCES:
        log = _build.target(name)[1].with_suffix(".log")
        text = log.read_text() if log.exists() else ""
        ptxas[name] = [ln.strip() for ln in text.splitlines()
                       if "registers" in ln or "spill" in ln]
    emit(phase="device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, build_s=build_s, ptxas=ptxas)


def phase_kernels(ds):
    """Each kernel against its plain version at the main path's shapes."""
    from repro_torch.kernels.logreg_grad.ops import logreg_grad
    from repro_torch.kernels.logreg_grad.ref import logreg_grad_ref
    from repro_torch.kernels.svrg_update.ops import svrg_update
    from repro_torch.kernels.svrg_update.ref import svrg_update_ref

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    d = ds.p
    report = {}
    for C in (1, 4):
        for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2e-2)):
            u, g, g0, gf = (torch.randn((C, d), generator=gen, device="cuda")
                            .to(dtype) for _ in range(4))
            lr = 0.1 * torch.rand(C, generator=gen, device="cuda")
            out = svrg_update(u, g, g0, gf, lr)
            ref = svrg_update_ref(u, g, g0, gf, lr)
            err = float((out.float() - ref.float()).abs().max())
            bits_equal = bool(torch.equal(out, ref))
            size = torch.finfo(dtype).bits // 8
            bnd, by = bound_ms(5 * C * d * size + 4 * C, 4 * C * d)
            rec = dict(kernel="svrg_update", rows=C, d=d,
                       dtype=str(dtype).replace("torch.", ""), tol=tol,
                       max_abs_err=err, bits_equal=bits_equal,
                       ms=median_ms(lambda: svrg_update(u, g, g0, gf, lr),
                                    inner=200),
                       plain_ms=median_ms(
                           lambda: svrg_update_ref(u, g, g0, gf, lr), inner=200),
                       bound_ms=bnd, bound_by=by)
            emit(phase="kernels_vs_plain", **rec)
            if not err <= tol:
                raise AssertionError(f"svrg_update disagrees: {rec}")
            if C == 1 and dtype == torch.float32:
                report["svrg_update"] = rec

    X, y = ds.as_torch("cuda")
    n, p = X.shape
    l2 = ds.l2_reg
    singles = {}
    for C in (1, 4):
        W = 0.1 * torch.randn((C, p), generator=gen, device="cuda")
        G = logreg_grad(X, y, W, l2)
        R = logreg_grad_ref(X, y, W, l2)
        err = float((G - R).abs().max())
        close = bool(torch.allclose(G, R, rtol=1e-5, atol=1e-6))
        row0 = logreg_grad(X, y, W[:1].contiguous(), l2)
        batch_independent = bool(torch.equal(G[:1], row0))
        bnd, by = bound_ms(4 * (n * p + n + 2 * C * p),
                           C * (4 * n * p + 6 * n + 2 * p))
        rec = dict(kernel="logreg_grad", rows=C, n=n, p=p, rtol=1e-5, atol=1e-6,
                   max_abs_err=err, allclose=close,
                   batch_independent=batch_independent,
                   ms=median_ms(lambda: logreg_grad(X, y, W, l2), inner=10),
                   plain_ms=median_ms(lambda: logreg_grad_ref(X, y, W, l2),
                                      reps=5, inner=3),
                   matmul_yardstick_ms=median_ms(lambda: X.T @ (X @ W.T),
                                                 inner=10),
                   bound_ms=bnd, bound_by=by)
        emit(phase="kernels_vs_plain", **rec)
        if not close or not batch_independent:
            raise AssertionError(f"logreg_grad disagrees: {rec}")
        singles[C] = rec
    report["logreg_grad"] = singles[1]
    emit(phase="kernels_vs_plain_done", kernel_names=sorted(report),
         seconds=time.perf_counter() - t0)
    return report


def reset_counts():
    from repro_torch.kernels.logreg_grad.ops import logreg_grad
    from repro_torch.kernels.svrg_update.ops import svrg_update
    svrg_update.launches = 0
    logreg_grad.launches = 0


def read_counts():
    from repro_torch.kernels.logreg_grad.ops import logreg_grad
    from repro_torch.kernels.svrg_update.ops import svrg_update
    return {"svrg_update": svrg_update.launches,
            "logreg_grad": logreg_grad.launches}


def check_history(name, hist):
    hist = np.asarray(hist, np.float64)
    if not np.all(np.isfinite(hist)) or not np.all(np.diff(hist) < 0):
        raise AssertionError(f"{name}: history not finite and decreasing: "
                             f"{hist.tolist()}")


def phase_main_path(obj):
    """run_asysvrg at full width: every update through svrg_update, every
    snapshot through logreg_grad."""
    from repro_torch import run_asysvrg
    from repro_torch.config import SVRGConfig
    from repro_torch.core.asysvrg import _resolve_steps

    cfg = SVRGConfig(scheme="inconsistent", step_size=STEP_SIZE,
                     num_threads=THREADS)
    _, _, total, tau = _resolve_steps(obj, cfg)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = run_asysvrg(obj, RCV1_EPOCHS, cfg, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    emit(phase="main_path", entry="run_asysvrg", n=obj.n, p=obj.p,
         scheme=cfg.scheme, tau=tau, inner_updates=total, epochs=RCV1_EPOCHS,
         history=list(res.history), wall_s=wall,
         wall_s_per_epoch=wall / RCV1_EPOCHS, launches=counts)
    check_history("run_asysvrg", res.history)
    if counts != {"svrg_update": RCV1_EPOCHS * total,
                  "logreg_grad": RCV1_EPOCHS}:
        raise AssertionError(f"launch counts {counts} != "
                             f"{RCV1_EPOCHS} x ({total} updates, 1 snapshot)")
    if tuple(res.w.shape) != (obj.p,) or not bool(torch.isfinite(res.w).all()):
        raise AssertionError("run_asysvrg: final iterate not finite [p]")
    return cfg, counts


def phase_card_vs_cpu(ds, obj, cfg):
    """One epoch on the card against the same epoch on the port's CPU path
    (the plain versions), which the CPU tests tie to the JAX package."""
    from repro_torch import LogisticRegression, run_asysvrg

    cpu = LogisticRegression(ds.X, ds.y, ds.l2_reg, device="cpu")
    t0 = time.perf_counter()
    r_cpu = run_asysvrg(cpu, 1, cfg, seed=0)
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    r_gpu = run_asysvrg(obj, 1, cfg, seed=0)
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    dw = float((r_gpu.w.cpu() - r_cpu.w).abs().max())
    h_cpu, h_gpu = np.asarray(r_cpu.history), np.asarray(r_gpu.history)
    gap = float(np.max(np.abs(h_gpu - h_cpu) / np.abs(h_cpu)))
    rec = dict(phase="card_vs_cpu", epochs=1, max_abs_dw=dw,
               history_rel_gap=gap, rtol_loss=1e-4, atol_w=1e-5,
               history_cpu=h_cpu.tolist(), history_gpu=h_gpu.tolist(),
               cpu_s=cpu_s, gpu_s=gpu_s)
    emit(**rec)
    if not (gap <= 1e-4 and dw <= 1e-5):
        raise AssertionError(f"card and CPU path disagree: {rec}")


def phase_sweep(obj):
    """run_sweep at full width: the three schemes + serial SVRG (one
    4-row group) and Hogwild! (a second group); then one row alone."""
    from repro_torch.core.sweep import SweepSpec, plan_sweep, run_sweep

    total = THREADS * ((2 * obj.n) // THREADS)
    specs = [SweepSpec(seed=0, scheme=s, step_size=STEP_SIZE,
                       num_threads=THREADS)
             for s in ("consistent", "inconsistent", "unlock")]
    specs += [SweepSpec(algo="svrg", step_size=STEP_SIZE, num_threads=THREADS,
                        inner_steps=total),
              SweepSpec(algo="hogwild", scheme="unlock", step_size=STEP_SIZE,
                        num_threads=THREADS, tau=-1)]
    groups = [len(m) for m in plan_sweep(obj, RCV1_EPOCHS, specs).groups.values()]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = run_sweep(obj, RCV1_EPOCHS, specs)
    wall = time.perf_counter() - t0
    counts = read_counts()
    for c, spec in enumerate(specs):
        check_history(f"run_sweep row {c} ({spec.algo}/{spec.scheme})",
                      res.histories[c])
    if counts["logreg_grad"] != RCV1_EPOCHS or \
            counts["svrg_update"] != RCV1_EPOCHS * total:
        raise AssertionError(f"sweep launch counts {counts}")
    alone = run_sweep(obj, RCV1_EPOCHS, [specs[2]])
    dw = float(np.abs(alone.final_w[0] - res.final_w[2]).max())
    dh = float(np.abs(alone.histories[0] - res.histories[2]).max())
    bits = bool(np.array_equal(alone.final_w[0], res.final_w[2])
                and np.array_equal(alone.histories[0], res.histories[2]))
    rec = dict(phase="run_sweep", rows=len(specs), groups=groups,
               epochs=RCV1_EPOCHS, wall_s=wall,
               wall_s_per_epoch=wall / RCV1_EPOCHS, launches=counts,
               histories=res.histories.tolist(),
               alone_vs_group=dict(row=2, max_abs_dw=dw, max_abs_dhist=dh,
                                   bits_equal=bits))
    emit(**rec)
    if not np.allclose(alone.final_w[0], res.final_w[2], rtol=1e-5, atol=1e-6):
        raise AssertionError(f"row alone vs in its group: {rec['alone_vs_group']}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs only on "
              "the card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import LogisticRegression
    from repro_torch.data.libsvm import make_synthetic_libsvm

    t_all = time.perf_counter()
    t0 = time.perf_counter()
    phase_device()
    emit(phase="device_done", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    ds = make_synthetic_libsvm("rcv1", scale=1.0)
    obj = LogisticRegression(ds.X, ds.y, ds.l2_reg)
    emit(phase="data", name=ds.name, n=ds.n, p=ds.p,
         seconds=time.perf_counter() - t0)

    report = phase_kernels(ds)

    t0 = time.perf_counter()
    cfg, counts = phase_main_path(obj)
    emit(phase="main_path_done", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    phase_card_vs_cpu(ds, obj, cfg)
    emit(phase="card_vs_cpu_done", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    phase_sweep(obj)
    emit(phase="run_sweep_done", seconds=time.perf_counter() - t0)

    replaces = {"svrg_update": "src/repro/kernels/svrg_update/kernel.py:23",
                "logreg_grad": "src/repro/kernels/logreg_grad/kernel.py:31"}
    kernels = []
    for name in ("svrg_update", "logreg_grad"):
        rec = report[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces[name], "launches": counts[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None})
    emit(phase="total", seconds=time.perf_counter() - t_all)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
