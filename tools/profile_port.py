#!/usr/bin/env python3
"""Where the port's AsySVRG inner loop and its serve path spend their time
on the card.

    python3 tools/profile_port.py              # everything below
    python3 tools/profile_port.py batched      # the batched engine and K1's host path
    python3 tools/profile_port.py serve        # the serve path only
    python3 tools/profile_port.py serve_moe    # the deepseek-moe-16b serve path
    python3 tools/profile_port.py serve_hybrid # recurrentgemma-2b, prompt 4096
    python3 tools/profile_port.py serve_ssm    # the falcon-mamba-7b serve path
    python3 tools/profile_port.py serve_encdec # whisper-large-v3, prompt 448
    python3 tools/profile_port.py serve_vlm    # llama-3.2-vision-11b, prompt 2048
    python3 tools/profile_port.py serve_timed ARCH  # prefill and decode, no profiler
    python3 tools/profile_port.py sweep_epoch  # the fused engine and K3 only
    python3 tools/profile_port.py train        # one SVRG train step only
    python3 tools/profile_port.py objectives   # NonconvexLogistic batched, the MLP's sweeps,
                                               # the MLP's fused epoch split

At the rcv1 width (n = 20242, p = 2048; data from
`repro_torch.data.libsvm.make_synthetic_libsvm("rcv1")`):

  * the batched engine: for a single run (1 row) and a sweep group (4 rows,
    one per scheme plus serial SVRG), 2048 inner updates of
    `repro_torch.core.asysvrg._epoch_core`, once without the profiler
    (host clock around a synchronised run: wall seconds per inner update)
    and once under ``torch.profiler`` (CPU + CUDA activities: the
    device-busy share of the window, device launches and host
    ``cudaLaunchKernel`` µs per update, the device kernels by total time, the
    host ops by self time);
  * K1's host path: µs per call of `svrg_update` (1 row of d = 2048,
    float32) and of its pieces, each over 10^4 calls with no synchronise in
    between: the device dispatch, ``torch.as_tensor`` of the step size,
    ``torch.empty_like``, PyTorch's current-stream lookup (public and raw),
    the launcher (`kernel.launch`: stream, pointers, the ctypes call, the
    enqueue) and the whole call; the engine's step before the epilogue
    (the update, the ring store, the running sum: three calls) and, where
    the wrapper takes them, the same step as one call. Then K1 and K2 on
    the card (CUDA events, median of 11 windows): `svrg_update` per call,
    1 row, bare and as the engine calls it, and `logreg_grad` at 1 and 4
    rows beside the two-matmul yardstick X.T @ (X @ W.T). This mode runs
    against an older checkout too (`git archive` of the parent under
    ``build/``), for turns of parent and change on one card;
  * the fused engine: one epoch of `run_sweep` with
    ``engine_mode="fused"`` over the 5 rows `chip_smoke.py` runs (4-row
    AsySVRG/SVRG group + 1 Hogwild! row), the same two ways;
  * the `sweep_epoch` kernel alone (CUDA events, median of 3 launches of
    4096 inner updates): `chip_smoke.py`'s three cases (the 4-row rcv1
    AsySVRG group, the Hogwild! row, the 3-row news20 group), per scheme
    and engine on one row, by group width (1 to 528 rows), at the news20
    width (d = 4096) and with the ring in device memory (τ = 40), each at
    the placement chosen by size; then `chip_smoke.py`'s three cases and
    the 264-row group at every placement that fits (the queue depth S is
    `kStages` in `csrc/sweep_epoch.cu`: edit it and run again to compare
    depths). Each launch
    ends with the rows' loss, two more kernels over all SMs that read X
    once for all rows; a launch of one update times that loss pass;
  * the serve path at gemma3-4b's full width (batch 4, prompt 2048, bf16):
    one prefill and 4 decode steps, each without and under the profiler;
    then 5 prefills in a row on a fresh session, each timed by the host
    clock around a synchronised call and by CUDA events, with the device
    allocations (`cudaMalloc`s of PyTorch's caching allocator) it made; the
    device kernels are also summed by kind (as in the `train` mode). The
    `serve_moe` mode does the same at deepseek-moe-16b's full width and
    depth (28 layers, 64 experts), `serve_hybrid` at recurrentgemma-2b's
    (26 layers, prompt 4096), `serve_ssm` at falcon-mamba-7b's (64
    layers), `serve_encdec` at whisper-large-v3's (32 + 32 layers, prompt
    448) and `serve_vlm` at llama-3.2-vision-11b's (40 layers); none is
    part of the default run. The weights are drawn in bf16, as
    `launch.serve.run` draws them; whisper's frame and the vision model's
    patch embeddings standard normal from seed 0.

The `train` mode (not part of the default run): gemma3-4b at full width
and 12 layers, batch 2, sequence 2048 (chip_smoke.py's training phase), one
snapshot over 2 batches, then one unfused and one fused SVRG step, each
timed without and under the profiler from the same state; the device
kernels are also summed by kind (matrix products, K1, elementwise,
reductions and softmax, copies and fills, the rest).

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


def _profiled(fn):
    """(wall s without the profiler, wall s under it, key_averages) of one
    synchronised call of ``fn``, after a warm-up call."""
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    return wall, prof_wall, prof.key_averages()


def profile(obj, rows: int, steps: int) -> dict:
    from torch.autograd import DeviceType

    run = _epoch(obj, rows)
    wall, prof_wall, events = _profiled(lambda: run(steps))
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=_device_time_us, reverse=True)
    busy_us = sum(_device_time_us(e) for e in kernels)
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    launch_us = sum(e.self_cpu_time_total for e in host
                    if e.key == "cudaLaunchKernel")
    return {
        "rows": rows, "steps": steps, "n": obj.n, "p": obj.p,
        "wall_s_per_step": wall / steps,
        "wall_us_per_step": 1e6 * wall / steps,
        "profiled_wall_s_per_step": prof_wall / steps,
        "device_busy_share": busy_us * 1e-6 / prof_wall,
        "launches_per_step": sum(e.count for e in kernels) / steps,
        "cuda_launch_host_us_per_step": launch_us / steps,
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


def _host_us(fn, calls: int = 10_000) -> float:
    """Host µs per call of ``fn`` over ``calls`` calls with no synchronise
    in between (after 100 warm-up calls); the device is drained after."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / calls


def k1_host_path(d: int = 2048, ring_len: int = 8) -> dict:
    """µs per call of svrg_update's host path and of its pieces (1 row,
    float32): see the module's docstring."""
    import inspect

    from repro_torch.kernels import dispatch
    from repro_torch.kernels.svrg_update import kernel
    from repro_torch.kernels.svrg_update.ops import svrg_update

    dev = torch.device("cuda")
    u, g, g0, gf = (torch.randn((1, d), device=dev) for _ in range(4))
    lr = torch.full((1,), 0.1, device=dev)
    out = torch.empty_like(u)
    ring = torch.zeros((1, ring_len, d), device=dev)
    slot = torch.zeros(1, dtype=torch.int64, device=dev)
    rows = torch.arange(1, device=dev)
    acc = torch.zeros_like(u)

    def three_calls():
        v = svrg_update(u, g, g0, gf, lr)
        ring[rows, slot] = v
        acc.add_(v)

    pieces = {
        "dispatch_route": lambda: dispatch.route(u, g, g0, gf),
        "as_tensor_lr": lambda: torch.as_tensor(lr, dtype=torch.float32,
                                                device=u.device),
        "empty_like": lambda: torch.empty_like(u),
        "current_stream": lambda: torch.cuda.current_stream(u.device).cuda_stream,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(0),
        "launcher": lambda: kernel.launch(u, g, g0, gf, lr, out, 0.0),
        "call": lambda: svrg_update(u, g, g0, gf, lr),
        "engine_step_three_calls": three_calls,
    }
    if "ring" in inspect.signature(svrg_update).parameters:
        pieces["engine_step_one_call"] = lambda: svrg_update(
            u, g, g0, gf, lr, ring=ring, slot=slot, acc=acc)
    return {"k1_host_path": "us_per_call", "rows": 1, "d": d,
            "calls": 10_000, **{k: _host_us(fn) for k, fn in pieces.items()}}


def _event_ms(fn, inner: int, reps: int = 11) -> float:
    """Median over ``reps`` CUDA-event windows of ``inner`` calls, per call."""
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
    return sorted(times)[len(times) // 2]


def batched_kernel_times(ds, ring_len: int = 8):
    """K1 per call (1 row, bare and as the engine calls it) and K2 at 1 and
    4 rows, at the rcv1 width, by CUDA events."""
    import inspect

    from repro_torch.kernels.logreg_grad.ops import logreg_grad
    from repro_torch.kernels.svrg_update.ops import svrg_update

    gen = torch.Generator(device="cuda").manual_seed(0)
    d = ds.p
    u, g, g0, gf = (torch.randn((1, d), generator=gen, device="cuda")
                    for _ in range(4))
    lr = torch.full((1,), 0.1, device="cuda")
    rec = {"kernel": "svrg_update", "rows": 1, "d": d,
           "ms": _event_ms(lambda: svrg_update(u, g, g0, gf, lr), inner=200)}
    if "ring" in inspect.signature(svrg_update).parameters:
        ring = torch.zeros((1, ring_len, d), device="cuda")
        slot = torch.zeros(1, dtype=torch.int64, device="cuda")
        acc = torch.zeros_like(u)
        rec["epilogue_ms"] = _event_ms(lambda: svrg_update(
            u, g, g0, gf, lr, ring=ring, slot=slot, acc=acc), inner=200)
    print(json.dumps(rec), flush=True)
    X, y = ds.as_torch("cuda")
    for C in (1, 4):
        W = 0.1 * torch.randn((C, d), generator=gen, device="cuda")
        print(json.dumps({
            "kernel": "logreg_grad", "rows": C, "n": ds.n, "p": d,
            "ms": _event_ms(lambda: logreg_grad(X, y, W, ds.l2_reg), inner=10),
            "yardstick_ms": _event_ms(lambda: X.T @ (X @ W.T), inner=10)}),
            flush=True)


def profile_fused(obj) -> dict:
    """One fused run_sweep epoch over chip_smoke.py's 5 rows."""
    from torch.autograd import DeviceType

    from repro_torch.core.sweep import SweepSpec, run_sweep

    total = 8 * ((2 * obj.n) // 8)
    specs = [SweepSpec(scheme=s, step_size=2.0, engine_mode="fused")
             for s in ("consistent", "inconsistent", "unlock")]
    specs += [SweepSpec(algo="svrg", step_size=2.0, inner_steps=total,
                        engine_mode="fused"),
              SweepSpec(algo="hogwild", scheme="unlock", step_size=2.0,
                        tau=-1, engine_mode="fused")]
    wall, prof_wall, events = _profiled(lambda: run_sweep(obj, 1, specs))
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=_device_time_us, reverse=True)
    busy_us = sum(_device_time_us(e) for e in kernels)
    return {
        "engine": "fused", "rows": len(specs), "epochs": 1, "n": obj.n,
        "p": obj.p, "wall_s": wall, "profiled_wall_s": prof_wall,
        "device_busy_share": busy_us * 1e-6 / prof_wall,
        "device_kernels": [
            {"name": e.key[:80], "count": e.count,
             "total_us": _device_time_us(e)} for e in kernels[:8]],
    }


def profile_sweep_epoch(ds, news20, steps: int = 4096):
    """The sweep_epoch kernel alone: µs per inner update by case, through
    `sweep_epoch` (the placement chosen by size); then some of the same
    cases at each placement that fits."""
    from repro_torch import prng
    from repro_torch.kernels.sweep_epoch import kernel, ops
    from repro_torch.kernels.sweep_epoch.ops import sweep_epoch

    gen = torch.Generator(device="cuda").manual_seed(0)
    data = {"rcv1": (*ds.as_torch("cuda"), ds.l2_reg),
            "news20": (*news20.as_torch("cuda"), news20.l2_reg)}
    # (case, data, engine, taus, scheme ids, delay ids, drop_prob); the
    # first three are chip_smoke.py's: its 4-row rcv1 group, its Hogwild!
    # row, its news20 group
    cases = [("rcv1_asysvrg_4rows", "rcv1", "asysvrg", [7, 7, 7, 0],
              [0, 1, 2, 0], [1, 1, 1, 0], 0.02),
             ("rcv1_hogwild_unlock", "rcv1", "hogwild", [7], [2], [1], 0.02),
             ("news20_asysvrg_3rows", "news20", "asysvrg", [9, 9, 9],
              [0, 1, 2], [1, 1, 2], 0.02),
             ("consistent", "rcv1", "asysvrg", [7], [0], [1], 0.0),
             ("consistent_tau0", "rcv1", "asysvrg", [0], [0], [0], 0.0),
             ("inconsistent", "rcv1", "asysvrg", [7], [1], [1], 0.0),
             ("unlock", "rcv1", "asysvrg", [7], [2], [1], 0.0),
             ("unlock_drop", "rcv1", "asysvrg", [7], [2], [1], 0.02),
             ("news20_inconsistent", "news20", "asysvrg", [9], [1], [1], 0.0),
             ("global_ring_unlock_tau40", "rcv1", "asysvrg", [40], [2], [2],
              0.0)]
    cases += [(f"inconsistent_{C}_rows", "rcv1", "asysvrg", [7] * C, [1] * C,
               [1] * C, 0.0) for C in (4, 32, 132, 264, 528)]

    def inputs(which, engine, taus, sids, dids, drop):
        X, y, l2 = data[which]
        C, d = len(taus), X.shape[1]
        w = 0.1 * torch.randn((C, d), generator=gen, device="cuda")
        mu = 1e-3 * torch.randn((C, d), generator=gen, device="cuda")
        args = (X, y, l2, w, mu if engine == "asysvrg" else None,
                prng.keys_from_seeds(range(C), "cuda"),
                torch.full((C,), 2.0, device="cuda"), taus, sids, dids)
        kw = dict(engine=engine, total=steps, buf_len=max(8, max(taus) + 1),
                  option=2, drop_prob=drop)
        return args, kw

    for name, which, engine, taus, sids, dids, drop in cases:
        args, kw = inputs(which, engine, taus, sids, dids, drop)
        before = dict(sweep_epoch.placements)
        ms = _event_ms(lambda: sweep_epoch(*args, **kw), inner=1, reps=3)
        placement = [k for k, v in sweep_epoch.placements.items()
                     if v != before[k]]
        print(json.dumps({"kernel": "sweep_epoch", "case": name, "data": which,
                          "d": args[0].shape[1], "engine": engine,
                          "rows": len(taus), "tau": taus[0], "updates": steps,
                          "placement": placement, "ms": ms,
                          "us_per_update": 1e3 * ms / steps}), flush=True)
    limit = kernel.max_shared_bytes(torch.device("cuda"))
    design = cases[:3] + [c for c in cases if c[0] == "inconsistent_264_rows"]
    for name, which, engine, taus, sids, dids, drop in design:
        args, kw = inputs(which, engine, taus, sids, dids, drop)
        d, buf_len = args[0].shape[1], kw["buf_len"]
        for placement in ops.PLACEMENTS:
            nbytes = ops.shared_bytes(d, buf_len, engine, placement)
            if nbytes > limit:
                continue
            ms = _event_ms(lambda: sweep_epoch(*args, **kw,
                                               placement=placement),
                           inner=1, reps=3)
            print(json.dumps({
                "kernel": "sweep_epoch", "case": name,
                "placement": placement, "stages": ops.STAGES,
                "shared_bytes": nbytes, "updates": steps, "ms": ms,
                "us_per_update": 1e3 * ms / steps}), flush=True)
    # one update: the launch is then its loss pass, one read of X for all rows
    for which, C in (("rcv1", 1), ("rcv1", 4), ("news20", 1)):
        X, y, l2 = data[which]
        d = X.shape[1]
        w = 0.1 * torch.randn((C, d), generator=gen, device="cuda")
        mu = 1e-3 * torch.randn((C, d), generator=gen, device="cuda")
        ms = _event_ms(lambda: sweep_epoch(
            X, y, l2, w, mu, prng.keys_from_seeds(range(C), "cuda"),
            torch.full((C,), 2.0, device="cuda"), [7] * C, [1] * C, [1] * C,
            engine="asysvrg", total=1, buf_len=8, option=2, drop_prob=0.0),
            inner=1, reps=3)
        print(json.dumps({"kernel": "sweep_epoch", "case": "loss_pass",
                          "data": which, "n": X.shape[0], "d": d, "rows": C,
                          "updates": 1, "ms": ms,
                          "x_gb_per_s": X.numel() * 4 / ms / 1e6}),
              flush=True)


def profile_objectives(ds) -> None:
    """The beyond-paper objectives on the batched engine: `NonconvexLogistic`
    (λ 1e-3, α 10) through `profile`'s 1- and 4-row epochs (the clipped
    penalty's gradient in every sample gradient); then the MLP
    (`mlp_lm_objective(64)` at benchmarks/nonconvex_frontier.py's widths,
    3 rows, M̃ 256): the wall of its first run in the process (its float64
    kernels load), then `_profiled` over one epoch: wall, device-busy
    share, launches and host ``cudaLaunchKernel`` µs per update, the host
    ops by self time; then the MLP's fused sweep split by
    `profile_mlp_fused`."""
    from torch.autograd import DeviceType

    from repro_torch.core.objectives import NonconvexLogistic, mlp_lm_objective
    from repro_torch.core.sweep import SweepSpec, run_sweep

    ncv = NonconvexLogistic(ds.X, ds.y, lam=1e-3, alpha=10.0)
    for rows in (1, 4):
        print(json.dumps({"objective": "NonconvexLogistic",
                          **profile(ncv, rows, STEPS)}), flush=True)
    mlp = mlp_lm_objective(64, vocab_size=16, seq_len=4, d_model=8,
                           d_hidden=16)
    specs = [SweepSpec(scheme="inconsistent", step_size=st, tau=2,
                       num_threads=4, inner_steps=mlp.n, seed=i)
             for i, st in enumerate((0.05, 0.1, 0.2))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_sweep(mlp, 1, specs)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    wall, prof_wall, events = _profiled(lambda: run_sweep(mlp, 1, specs))
    steps = 4 * mlp.n
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    print(json.dumps({
        "objective": "MLPObjective", "n": mlp.n, "flat_dim": mlp.flat_dim,
        "rows": len(specs), "updates": steps, "first_run_s": first,
        "wall_s_per_epoch": wall, "profiled_wall_s": prof_wall,
        "device_busy_share": sum(_device_time_us(e) for e in kernels)
        * 1e-6 / prof_wall,
        "launches_per_update": sum(e.count for e in kernels) / steps,
        "cuda_launch_host_us_per_update": sum(
            e.self_cpu_time_total for e in host
            if e.key == "cudaLaunchKernel") / steps,
        "host_ops": [{"name": e.key[:60], "count": e.count,
                      "self_us_per_update": e.self_cpu_time_total / steps}
                     for e in host[:12]]}), flush=True)
    profile_mlp_fused()


def profile_mlp_fused() -> None:
    """The MLP's fused sweep (chip_smoke.py's 3 inconsistent rows, τ 2, M̃
    4n, 2 epochs, ``engine_mode="fused"``) at benchmarks/nonconvex_frontier
    .py's widths and at the objective's defaults, one synchronised run
    under the profiler after a warm-up run: each epoch split into μ
    (`mlp_full_grad`'s kernel), the epoch launch (`sweep_epoch_mlp`'s) and
    the run's starting loss (`mlp_loss`'s), by device time, and the host's
    `run_sweep` around them (the run's wall less every device kernel's
    time, so it holds the gaps the host leaves the card)."""
    from torch.autograd import DeviceType

    from repro_torch.core.objectives import mlp_lm_objective
    from repro_torch.core.sweep import SweepSpec, run_sweep

    epochs = 2
    parts = (("mu", "full_kernel<true"), ("epoch", "epoch_kernel"),
             ("loss0", "full_kernel<false"))
    for name, widths in (
            ("frontier", dict(vocab_size=16, seq_len=4, d_model=8,
                              d_hidden=16)),
            ("defaults", dict(vocab_size=32, seq_len=8, d_model=16,
                              d_hidden=32))):
        mlp = mlp_lm_objective(64, **widths)
        specs = [SweepSpec(scheme="inconsistent", step_size=st, tau=2,
                           num_threads=4, inner_steps=mlp.n, seed=i,
                           engine_mode="fused")
                 for i, st in enumerate((0.05, 0.1, 0.2))]
        wall, prof_wall, events = _profiled(
            lambda: run_sweep(mlp, epochs, specs))
        kernels = [e for e in events if e.device_type == DeviceType.CUDA]
        split = {part: sum(_device_time_us(e) for e in kernels
                           if key in e.key) * 1e-3 for part, key in parts}
        device_ms = sum(_device_time_us(e) for e in kernels) * 1e-3
        print(json.dumps({
            "objective": "MLPObjective", "engine_mode": "fused",
            "widths": name, "n": mlp.n, "flat_dim": mlp.flat_dim,
            "rows": len(specs), "epochs": epochs, "updates": 4 * mlp.n,
            "wall_ms_per_epoch": 1e3 * wall / epochs,
            "profiled_wall_ms_per_epoch": 1e3 * prof_wall / epochs,
            "mu_ms_per_epoch": split["mu"] / epochs,
            "epoch_launch_ms_per_epoch": split["epoch"] / epochs,
            "loss0_ms_per_run": split["loss0"],
            "other_device_ms_per_epoch": (device_ms - sum(split.values()))
            / epochs,
            "host_ms_per_epoch": (1e3 * prof_wall - device_ms) / epochs,
            "device_busy_share": device_ms * 1e-3 / prof_wall,
            "launches": {part: sum(e.count for e in kernels if key in e.key)
                         for part, key in parts}}), flush=True)


def _summary(events, wall: float, steps: int) -> dict:
    """Device-busy share, top device kernels and top host ops of a profiled
    window of ``wall`` seconds holding ``steps`` steps."""
    from torch.autograd import DeviceType

    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=_device_time_us, reverse=True)
    busy_us = sum(_device_time_us(e) for e in kernels)
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    return {
        "device_busy_share": busy_us * 1e-6 / wall,
        "device_ms_per_step": busy_us * 1e-3 / steps,
        "device_kernels": [
            {"name": e.key[:80], "count": e.count,
             "ms_per_step": _device_time_us(e) * 1e-3 / steps}
            for e in kernels[:12]],
        "host_ops": [
            {"name": e.key[:60], "count": e.count,
             "self_ms_per_step": e.self_cpu_time_total * 1e-3 / steps}
            for e in host[:15]],
    }


def profile_serve(arch: str = "gemma3-4b", decode_steps: int = 4,
                  prompt: int = 2048) -> None:
    """``arch`` at full width (chip_smoke.py's serve phases: batch 4,
    ``prompt`` tokens, bf16): one prefill, then ``decode_steps`` decode
    steps, each window timed without and under the profiler."""
    from repro_torch import prng
    from repro_torch.launch.serve import serve_config
    from repro_torch.models.factory import _modality_extra, build_model
    from repro_torch.serve.loop import ServeSession
    from repro_torch.sharding.rules import init_from_defs

    cfg = serve_config(arch)
    bundle = build_model(cfg, "cuda")
    params = init_from_defs(torch.Generator(device="cuda").manual_seed(0),
                            bundle.param_defs)
    batch = {"tokens": prng.randint(prng.PRNGKey(0, "cuda"), (4, prompt), 0,
                                    cfg.vocab_size)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, shape in _modality_extra(cfg).items():
        batch[name] = torch.randn((4, *shape), generator=gen, device="cuda")
    sess = ServeSession(bundle, params, prompt + 4 * decode_steps)
    wall, prof_wall, events = _profiled(lambda: sess.prefill(batch))
    print(json.dumps({"serve": "prefill", "arch": cfg.name, "batch": 4,
                      "prompt": prompt, "wall_s": wall,
                      "profiled_wall_s": prof_wall,
                      "device_ms_by_kind": _kinds(events, 1),
                      **_summary(events, prof_wall, 1)}), flush=True)
    tok = torch.zeros(4, dtype=torch.int64, device="cuda")

    def decode():
        for _ in range(decode_steps):
            sess.decode(tok)

    wall, prof_wall, events = _profiled(decode)
    print(json.dumps({"serve": "decode", "arch": cfg.name, "batch": 4,
                      "cache_len": sess.cache_len, "steps": decode_steps,
                      "wall_ms_per_step": 1e3 * wall / decode_steps,
                      "profiled_wall_ms_per_step": 1e3 * prof_wall / decode_steps,
                      "device_ms_by_kind": _kinds(events, decode_steps),
                      **_summary(events, prof_wall, decode_steps)}), flush=True)

    sess = ServeSession(bundle, params, prompt)
    for i in range(5):
        allocs = torch.cuda.memory_stats().get("num_device_alloc", 0)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        sess.prefill(batch)
        stop.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(json.dumps({
            "serve": "prefill_repeat", "call": i, "wall_s": wall,
            "event_s": start.elapsed_time(stop) / 1e3,
            "device_allocs": torch.cuda.memory_stats().get(
                "num_device_alloc", 0) - allocs}), flush=True)


def time_serve(arch: str, new_tokens: int = 32, reps: int = 3) -> None:
    """``arch`` at full width (batch 4, bf16, prompt 448 for whisper and
    2048 otherwise, as `chip_smoke.py`'s serve phases), no profiler: one
    `launch.serve.run` to build and warm it, then ``reps`` times a fresh
    session's prefill (synchronised) and ``new_tokens`` greedy decode steps
    synchronised once at the end, as `chip_smoke.py` times them. One JSON
    line per rep: prefill seconds, decode ms per token, decode tokens/s.
    Runs against an older checkout too (copy this file into it)."""
    from repro_torch.launch.serve import run
    from repro_torch.serve.loop import ServeSession

    prompt = 448 if arch == "whisper-large-v3" else 2048
    res = run(arch, batch=4, prompt_len=prompt, new_tokens=4, device="cuda")
    bundle, params, batch = res["bundle"], res["params"], res["batch"]
    for rep in range(reps):
        sess = ServeSession(bundle, params, prompt + new_tokens + 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = sess.prefill(batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        t0 = time.perf_counter()
        for _ in range(new_tokens):
            tok = torch.argmax(sess.decode(tok), dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        print(json.dumps({"serve_timed": arch, "rep": rep, "batch": 4,
                          "prompt": prompt, "new_tokens": new_tokens,
                          "prefill_s": prefill_s,
                          "decode_ms_per_token": 1e3 * decode_s / new_tokens,
                          "decode_tokens_per_s": 4 * new_tokens / decode_s}),
              flush=True)


def _kinds(events, steps: int) -> dict:
    """Device ms per step summed by kernel kind (by name)."""
    from torch.autograd import DeviceType

    kinds = {"matmul": ("gemm", "xmma", "cutlass", "cublas", "nvjet"),
             "svrg_update": ("svrg_update",),
             "flash_attention": ("flash",),
             "sort_scan": ("sort", "scan"),
             "softmax_reduce": ("softmax", "reduce", "logsumexp", "norm"),
             "copy_fill": ("copy", "fill", "cat", "index", "gather",
                           "scatter", "stack"),
             "elementwise": ("elementwise", "vectorized", "unrolled")}
    out = dict.fromkeys([*kinds, "other"], 0.0)
    for e in events:
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.key.lower()
        kind = next((k for k, keys in kinds.items()
                     if any(key in name for key in keys)), "other")
        out[kind] += _device_time_us(e) * 1e-3 / steps
    return out


def profile_train() -> None:
    from repro_torch.config import SVRGConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic_lm import SyntheticLMDataset
    from repro_torch.models.factory import build_model
    from repro_torch.train.loop import device_batch
    from repro_torch.train.state import (init_train_state, make_snapshot_fns,
                                         make_train_step)

    cfg = get_config("gemma3-4b").with_overrides(num_layers=12)
    bundle = build_model(cfg, "cuda")
    tcfg = TrainConfig(steps=5, optimizer="svrg", learning_rate=3e-3,
                       warmup_steps=1, svrg=SVRGConfig(snapshot_batches=2))
    ds = SyntheticLMDataset(cfg.vocab_size, 2048, 2, seed=0)
    state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                             bundle, tcfg)
    begin, accum, fin = make_snapshot_fns(bundle, tcfg)
    state = begin(state)
    for j in range(2):
        state = accum(state, device_batch(ds.batch_at(j), "cuda"))
    state = fin(state)
    batch = device_batch(ds.batch_at(2), "cuda")
    for fused in (False, True):
        step = make_train_step(bundle, tcfg, use_fused_update=fused)
        torch.cuda.reset_peak_memory_stats()
        wall, prof_wall, events = _profiled(lambda: step(state, batch))
        print(json.dumps({"train": "fused" if fused else "unfused",
                          "arch": cfg.name, "layers": cfg.num_layers,
                          "batch": 2, "seq": 2048, "wall_s": wall,
                          "profiled_wall_s": prof_wall,
                          "peak_memory_gb":
                              torch.cuda.max_memory_allocated() / 1e9,
                          "device_ms_by_kind": _kinds(events, 1),
                          **_summary(events, prof_wall, 1)}), flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import LogisticRegression
    from repro_torch.data.libsvm import make_synthetic_libsvm

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    if argv == ["serve"]:
        profile_serve()
        return 0
    if argv == ["serve_moe"]:
        profile_serve("deepseek-moe-16b")
        return 0
    if argv == ["serve_hybrid"]:
        profile_serve("recurrentgemma-2b", prompt=4096)
        return 0
    if argv == ["serve_ssm"]:
        profile_serve("falcon-mamba-7b")
        return 0
    if argv == ["serve_encdec"]:
        profile_serve("whisper-large-v3", prompt=448)
        return 0
    if argv == ["serve_vlm"]:
        profile_serve("llama-3.2-vision-11b")
        return 0
    if len(argv) == 2 and argv[0] == "serve_timed":
        time_serve(argv[1])
        return 0
    if argv == ["train"]:
        profile_train()
        return 0
    ds = make_synthetic_libsvm("rcv1", scale=1.0)
    obj = LogisticRegression(ds.X, ds.y, ds.l2_reg)
    if argv == ["batched"]:
        for rows in (1, 4):
            print(json.dumps(profile(obj, rows, STEPS)), flush=True)
        print(json.dumps(k1_host_path()), flush=True)
        batched_kernel_times(ds)
        return 0
    if argv == ["objectives"]:
        profile_objectives(ds)
        return 0
    if argv == ["sweep_epoch"]:
        print(json.dumps(profile_fused(obj)), flush=True)
        profile_sweep_epoch(ds, make_synthetic_libsvm("news20", scale=1.0))
        return 0
    for rows in (1, 4):
        print(json.dumps(profile(obj, rows, STEPS)), flush=True)
    print(json.dumps(k1_host_path()), flush=True)
    print(json.dumps(profile_fused(obj)), flush=True)
    profile_sweep_epoch(ds, make_synthetic_libsvm("news20", scale=1.0))
    profile_serve()
    return 0


if __name__ == "__main__":
    sys.exit(main())
