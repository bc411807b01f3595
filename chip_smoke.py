#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (`src/repro_torch`) on one NVIDIA H100.

    python3 chip_smoke.py          # from the repository root, on a machine with the card

It builds the port's CUDA kernels from `src/repro_torch/csrc/` with nvcc
(sm_90a), all at once, and holds each kernel against its plain torch
version on the card at the main path's shapes: `svrg_update` (bit for bit,
bare and with the ring store and running sum of the engine's step in its
epilogue), `logreg_grad` (rcv1 width with 1, 3, 4, 5 and 9 weight rows,
news20 width with 4; timed beside the two-matmul yardstick) and
`sweep_epoch` (rcv1 and news20 widths, each case at every placement of
the ring and the staged rows that fits, bit-equal at the main path's shape;
its in-kernel generator bit for bit against `repro_torch.prng`), and
`flash_attention` at gemma3-4b's prefill shapes (windows 0 and 1024, bf16
on the tensor-core kernel and float32 on the CUDA-core one, a ragged
length, GQA 16:1), deepseek-moe-16b's (MHA, h = 128, global),
recurrentgemma-2b's, whisper-large-v3's and llama-3.2-vision-11b's, timed
beside its plain version, the CUDA-core kernel on the same bf16 inputs and
`scaled_dot_product_attention`; the tensor-core
library's SASS must hold `HGMMA` and `UTMALDG`, the sweep library's the bulk
copy, the L2 prefetch and the mbarrier wait, the gradient library's the bulk
copy and the mbarrier wait, the last two with no register spills. It
then drives each path through the entry
points a user calls, with the launch counters set to 0 just before and read
just after; the paper's paths at the full width of the rcv1 configuration
(n = 20242, p = 2048):

  * `run_asysvrg`: every inner update through one `svrg_update` launch
    (the update, its ring slot and the running sum), every snapshot
    gradient through `logreg_grad`; one card epoch against the CPU path;
  * `run_sweep` (batched): the same kernels, 5 rows in 2 groups;
  * `run_sweep` with ``engine_mode="fused"``: one `sweep_epoch` launch per
    group and epoch, `logreg_grad` for the AsySVRG group's snapshots, no
    `svrg_update`; held against the batched sweep, and a row alone against
    the row in its group;
  * phase `obs`: both sweeps again with the tracer and the ledger on
    (`repro_torch.obs`): results against the runs with them off, one
    ``execute`` span and one ledger entry per group (the analytic
    operations and bytes, ``attained_frac`` against the H100, a wall time
    not shorter than a CUDA-event pair around the same runner call), the
    fused grid's wall with obs off and on in turns; two fused rows with
    ``telemetry=True``, their realized delays (replayed on the CPU)
    against the delays the sweep kernel draws on the card;
  * phase `service`: two tenants submit three requests to a
    `SweepService` (2 fused rows at full rcv1, 2 batched rows at a tenth
    of its rows, 1 fused row whose step diverges) and one flush coalesces
    them: `logreg_grad` and `sweep_epoch` launched groups x epochs times,
    each result against a standalone `run_sweep` (fused bits equal), the
    diverging row flagged by the watchdog (``record``); a second flush of
    the same shapes under ``cancel_row`` freezes it, constructs no runner
    and builds no kernel; `run_job` cut after one group and resumed
    equals the job in one call;
  * phase `objectives_mlp_fused` (after phase `objectives`): the MLP
    language model's own sweep kernel, `sweep_epoch_mlp`: its backward
    (`sample_grad`) against `MLPObjective.flat_sample_grad` for relu, gelu
    and silu at the objective's default widths (rtol 1e-6, atol 1e-7), one
    epoch launch (3 AsySVRG rows, the unlock row dropping 10%, and a
    Hogwild! row) against its plain version at those widths at both
    placements, at S 20 (positions cycling over 8 warps) and at V 256, D
    64, H 256 (d 98624, the vectors in device memory), rtol 1e-5, atol
    1e-6, the share of equal bits recorded, each launch timed beside its
    bound; then `run_sweep(engine_mode="fused")` of the MLP at the
    frontier widths and at the defaults, 2 epochs, against the batched
    engine (rtol 1e-5, atol 1e-6), `sweep_epoch_mlp` launched groups x
    epochs times for the epochs, once per epoch for μ and once for the
    starting loss, K1-K3 never; s per epoch of each, the epoch launch
    timed beside its plain version and its float64 bound (one launch a
    window, then 3 back to back, then one with the rows' settings copied
    from the host; and with consistent and unlock rows, whose draws
    differ), the full gradient's entry against its plain version, and at
    d 98624 the unstaged full-gradient, loss and sample-gradient blocks
    against theirs;
  * phase `sharding` (after phases `objectives` and `server`), its ranks
    spawned processes under a 120 s deadline each: a 2-rank `gloo` world,
    both ranks on this card (two processes time-sharing it, not a
    multi-GPU figure), runs the fused grid at full rcv1 and the batched
    grid at a tenth of its rows through `run_sweep(mesh=make_sweep_mesh())`
    (each twice, the second run warm; equal bits / rtol 1e-5 against the
    unsharded runs, each rank's K1/K2/K3 launches its shard's groups x
    epochs), a sharded `SweepService` flush from a cleared runner cache
    (runners constructed) and a warm one (no runner constructed, no
    kernel built), and `bounded_staleness_epoch` with each compression on the
    card against the CPU; a 1-rank `nccl` world takes the unsharded path
    (equal bits) and reduces through NCCL;

and the serve path at the full width of gemma3-4b (34 layers, d_model 2560,
vocab 262144; random weights from a seed, bf16 activations):

  * `launch.serve.run` (`build_model` -> `generate`): batch 4, prompt 2048,
    16 new tokens; one `flash_attention` launch per prefill layer, all on
    the tensor-core route, none in decode; prefill seconds, decode ms per
    token and tokens/s;
  * the same path at 2 layers (one window, one global) in bf16, batch 1:
    the prefill logits with attention through the tensor-core kernel
    against the same prefill with the plain attention (and both against
    attention computed in float32 from the same bf16 q, k, v);
  * the same path at 2 layers in float32 (the CUDA-core route), batch 1,
    on the card and on the CPU from the same weights: prefill and decode
    logits and greedy tokens;

and the training path at gemma3-4b's full width, depth cut to 12 layers
(SVRG's six float32 param-sized trees fit in 80 GB; batch 2, sequence
2048):

  * `train.loop.train` (the CLI's function) with SVRG for 5 steps, a
    snapshot every 4 over 2 batches, unfused: each loss finite, no kernel
    launched (training attends in plain torch; K4 has no backward);
    seconds per step, tokens/s, peak memory;
  * 2 steps through `make_train_step(..., use_fused_update=True)` against
    the unfused step from the same state: params allclose, metrics equal,
    `svrg_update` launched once per param leaf; K1's time over the whole
    tree beside its bound and the unfused step's torch ops, and K1 alone
    at `tok_embed`'s shape, bit-equal to its plain version;
  * a 2-layer float32 model (the reduced config) trained 3 SVRG steps on
    the card and on the CPU from the same state: losses and params;

and the mixture-of-experts family at deepseek-moe-16b's full width (64
experts, top 6, 2 shared, MHA at h = 128; the earlier phases' tensors
released first):

  * `launch.serve.run` at all 28 layers, which draws the weights in bf16
    (float32 masters would not fit beside their bf16 copy), batch 4, prompt
    2048, 16 new tokens: 28 `flash_attention` launches per prefill, all on
    the tensor-core route, none in decode; prefill seconds, decode ms per
    token, tokens/s, peak memory (the weights' draw included);
  * 2 layers (the dense one, one MoE layer) in bf16, batch 1, prompt 2048:
    the prefill logits through the tensor-core kernel against the plain
    attention in float32 (the bf16 plain attention's gap recorded beside:
    its bf16 scores fail at deepseek's score scale); then in float32,
    batch 2, prompt 512 (two routing groups a row), 4 new
    tokens, on the card and on the CPU from the same weights: logits and
    greedy tokens, and each MoE layer's chosen experts, a difference
    allowed only at a near-tie of the router's probabilities (the logits
    then compared over the rows whose routes agree, at least one);
  * 2 layers, float32 params, bf16 activations, rematerialised, batch 2,
    sequence 2048: 2 fused SVRG steps against 2 unfused ones from the same
    state, one K1 launch per leaf (the expert leaves included), no K4;

and the recurrent families at full width (random weights, bf16
activations; K4's case at recurrentgemma-2b's prefill shape, B 4, S 4096,
MQA N 10 over K 1, h 256, window 2048, among the kernel checks above):

  * `launch.serve.run` for recurrentgemma-2b (26 layers: 8 groups of two
    RG-LRU layers and one local-attention layer, 2 trailing RG-LRU
    layers) at batch 4, prompt 4096 (twice the window: the ring cache
    wraps), 16 new tokens: 8 `flash_attention` launches per prefill, all
    on the tensor-core route, none in decode; and for falcon-mamba-7b (64
    layers, d_inner 8192, N 16) at batch 4, prompt 2048: no launch of any
    kernel of the repo (the selective scan runs in torch ops); prefill
    seconds, decode ms per token, tokens/s, peak memory;
  * recurrentgemma-2b at 3 layers (one group) in bf16, batch 1, prompt
    4096: the prefill through the tensor-core kernel against the plain
    attention in float32, in the logits and in the attention layer's
    output (the bf16 plain attention's gaps beside);
  * recurrentgemma-2b at 3 layers and falcon-mamba-7b at 2 in float32,
    batch 2, prompt 640 (5 chunks in every scan), 4 new tokens, on the
    card and on the CPU from the same weights: logits, greedy tokens and
    every cache leaf (atol 5e-3, rtol 1e-3: their float32 is itself
    ~1e-3 from the function at full width), each device's distance to a
    float64 run recorded beside;
  * recurrentgemma-2b at 5 layers and falcon-mamba-7b at 2, float32
    params, bf16 activations, rematerialised, batch 2, sequence 2048: 2
    fused SVRG steps against 2 unfused ones, one K1 launch per leaf, no
    K4.

and the encoder-decoder and vision families at full width (random
weights, bf16 activations; K4's cases at their prefill shapes among the
kernel checks above, with a key length of its own where the attention is
an encoder's over its valid frames or a cross-attention):

  * `launch.serve.run` for whisper-large-v3 (32 encoder layers over 1500
    frames padded to 1504, 32 decoder layers) at batch 4, prompt 448, 16
    new tokens, its frame embeddings drawn from a seed: 96
    `flash_attention` launches per prefill (the encoder's, the decoder's
    self-attention and the cross-attention, 32 each), all on the
    tensor-core route, none in decode; and for llama-3.2-vision-11b (8
    groups of [self, self, self, cross, self]) at prompt 2048 beside 1601
    drawn patch embeddings: 40 launches per prefill; prefill seconds,
    decode ms per token, tokens/s, peak memory;
  * whisper-large-v3 at 2 encoder + 2 decoder layers and
    llama-3.2-vision-11b at 5 in bf16, batch 1, every zero-initialised
    leaf drawn (the tanh gates non-zero): the prefill through the
    tensor-core kernel against the plain attention in float32, in the
    logits and in the first attention layer's output;
  * the same depths in float32, batch 2, prompts 64 and 128, 4 new
    tokens, on the card and on the CPU from the same weights: logits,
    greedy tokens and every cache leaf (the padded frames' rows
    included), each device's distance to a float64 run recorded beside;
  * whisper-large-v3 at full depth and llama-3.2-vision-11b at 5 layers,
    float32 params, bf16 activations, rematerialised, batch 2, sequence
    2048: 2 fused SVRG steps against 2 unfused ones, one K1 launch per
    leaf, no K4;

and, right after the kernels' build, phase `analysis`: the port's linter
(`python -m repro_torch.analysis src/repro_torch`, in a process of its
own on this machine, which has no JAX) exits 0 with no finding under any
rule (RL000-RL006);

and the dry-run (`repro_torch.launch.dryrun`, phase `dryrun`):

  * gemma3-4b traced on fake tensors at the one-device mesh at the
    `train` phase's shape (12 layers, batch 2, sequence 2048, unfused SVRG,
    one microbatch), the `serve` phase's prefill (34 layers, batch 4,
    prompt 2048, bf16) and one decode token from that cache, no kernel
    launched; then each run once on the card from
    `reset_peak_memory_stats` with random weights from a seed: the
    estimate within 10% of `max_memory_allocated`, the real prefill 34
    `flash_attention` launches;
  * gemma3-4b's train_4k cell over a fake world of 256 ranks, the (16, 16)
    mesh, full size, and falcon-mamba-7b's cut to 2 layers over both fake
    meshes, each in a process of its own (no card visible to them), side
    by side after every timed phase: each must come back `ok`.

`sweep_epoch` is held against its plain version at the main path's shape
(the 4-row rcv1 group, 40480 inner updates); its other cases (Hogwild!,
news20, the ring in device memory) at 4096 inner updates, since the plain
version steps in Python, one update at a time (~3 minutes for the full one).
Its time per update is recorded for the 4-row rcv1 group, the Hogwild! row
and the news20 group.

Each phase prints one JSON line; any failed check raises and the script
exits non-zero. The second-to-last line is the kernel report, the last line
`{"ok": true, "device": {...}}`. With no CUDA device, or without the rest of
the repository beside it, the script fails before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, float32 outside the
# tensor cores, bf16 on them.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12   # dense bf16 on the tensor cores
RCV1_EPOCHS = 2
STEP_SIZE = 2.0        # benchmarks/table2_schemes.py's step
THREADS = 8            # p = 8 simulated threads, tau = p - 1 = 7
DROP_PROB = 0.02       # run_sweep's default unlock drop probability
PLAIN_UPDATES = 4096   # sweep_epoch's side cases against its plain version


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def bound_ms(nbytes: float, flops: float, flop_per_s: float = FP32_FLOP_PER_S):
    """(least time in ms, what bounds it) for moving ``nbytes`` through HBM
    and doing ``flops`` operations at ``flop_per_s`` (float32 by default)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / flop_per_s
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
    # the tensor-core attention kernel's SASS: wgmma and TMA loads; the
    # sweep kernel's: bulk copies of rows, their L2 prefetches and mbarrier
    # waits
    counts = sass_counts("flash_attention_wgmma", ("HGMMA", "UTMALDG"))
    k3_counts = sass_counts("sweep_epoch", K3_SASS)
    k2_counts = sass_counts("logreg_grad", K2_SASS)
    emit(phase="device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, build_s=build_s, ptxas=ptxas,
         flash_attention_wgmma_sass=counts, sweep_epoch_sass=k3_counts,
         logreg_grad_sass=k2_counts)
    if not all(counts.values()):
        raise AssertionError(f"flash_attention_wgmma SASS lacks wgmma or TMA: "
                             f"{counts}")
    if not all(k3_counts.values()):
        raise AssertionError(f"sweep_epoch SASS lacks bulk copies, L2 "
                             f"prefetches or mbarrier waits: {k3_counts}")
    if not all(k2_counts.values()):
        raise AssertionError(f"logreg_grad SASS lacks bulk copies or mbarrier "
                             f"waits: {k2_counts}")
    for name in ("sweep_epoch", "logreg_grad"):
        spills = [ln for ln in ptxas[name]
                  if "spill" in ln and "0 bytes spill stores, 0 bytes spill "
                  "loads" not in ln]
        if spills:
            raise AssertionError(f"{name} spills registers: {spills}")


def phase_analysis():
    """The port's linter, `python -m repro_torch.analysis`, over the port's
    tree in a process of its own (this machine has no JAX): it must exit 0
    with no finding under every rule. Emits the files it read, the rules
    and its wall time."""
    import os
    import shutil
    import tempfile

    root = ROOT / "build"
    root.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_lint-", dir=root))
    try:
        out = tmp / "lint.json"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", "src/repro_torch",
             "--json-out", str(out)],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
            capture_output=True, text=True, timeout=300)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"repro_torch.analysis exited "
                                 f"{proc.returncode}: {proc.stdout}"
                                 f"{proc.stderr}")
        payload = json.loads(out.read_text())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit(phase="analysis", files=payload["files"],
         diagnostics=len(payload["diagnostics"]),
         rules=sorted(payload["rules"]),
         suppressions=payload["suppressions"], seconds=seconds)
    if payload["diagnostics"] or payload["files"] < 100:
        raise AssertionError(f"repro_torch.analysis: {payload}")


# SASS of the sweep kernel's pipeline: the bulk copy of a row into shared
# memory, the bulk prefetch into L2, the mbarrier's try-wait; of the
# gradient's: the bulk copy of a stripe and the mbarrier's try-wait
K3_SASS = ("UBLKCP", "UBLKPF", "SYNCS.PHASECHK")
K2_SASS = ("UBLKCP", "SYNCS.PHASECHK")


def sass_counts(name, opcodes):
    """How often each opcode occurs in one kernel library's SASS."""
    from repro_torch.kernels import _build

    sass = subprocess.run(
        [str(Path(_build.nvcc()).parent / "cuobjdump"), "-sass",
         str(_build.target(name)[1])],
        capture_output=True, text=True, check=True, timeout=120).stdout
    return {op: sass.count(op) for op in opcodes}


def phase_kernels(ds):
    """Each kernel against its plain version at the main path's shapes."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    report = {"svrg_update": svrg_update_vs_plain(ds, gen)}
    report["logreg_grad"] = logreg_grad_vs_plain(ds, gen)
    report["sweep_epoch"] = sweep_epoch_vs_plain(ds, gen)
    check_draws(ds)
    report["flash_attention"] = flash_attention_vs_plain(gen)
    emit(phase="kernels_vs_plain_done", kernel_names=sorted(report),
         seconds=time.perf_counter() - t0)
    return report


RING_LEN = THREADS    # the engine's ring at tau = THREADS - 1


def svrg_update_vs_plain(ds, gen):
    """svrg_update against its plain version, bit for bit, at the main
    path's shapes (1 and 4 rows of d = p; float32 and bf16): the bare update
    and the main path's call, which also stores the result into its ring
    slot and adds it to the running sum (`_epoch_core`, option 2). Both are
    timed beside the plain version; the main path's call at 1 row float32
    is the kernel's record."""
    from repro_torch.kernels.svrg_update.ops import svrg_update
    from repro_torch.kernels.svrg_update.ref import svrg_update_ref

    d = ds.p
    record = None
    for C in (1, 4):
        for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2e-2)):
            u, g, g0, gf = (torch.randn((C, d), generator=gen, device="cuda")
                            .to(dtype) for _ in range(4))
            lr = 0.1 * torch.rand(C, generator=gen, device="cuda")
            slot = torch.randint(0, RING_LEN, (C,), generator=gen,
                                 device="cuda")
            ring0 = torch.randn((C, RING_LEN, d), generator=gen,
                                device="cuda").to(dtype)
            acc0 = torch.randn((C, d), generator=gen, device="cuda").to(dtype)
            outs = {}
            for name, fn in (("kernel", svrg_update), ("plain", svrg_update_ref)):
                ring, acc = ring0.clone(), acc0.clone()
                outs[name] = (fn(u, g, g0, gf, lr), ring, acc,
                              fn(u, g, g0, gf, lr, ring=ring, slot=slot, acc=acc))
            err = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(outs["kernel"], outs["plain"]))
            bits_equal = all(bool(torch.equal(a, b))
                             for a, b in zip(outs["kernel"], outs["plain"]))
            ring, acc = ring0.clone(), acc0.clone()
            size = torch.finfo(dtype).bits // 8
            # the main path's call: u, g, g0, gf and acc read, out, the ring
            # row and acc written (+ lr and slot); 5 flops an element
            bnd, by = bound_ms(8 * C * d * size + 12 * C, 5 * C * d)
            bare_bnd, _ = bound_ms(5 * C * d * size + 4 * C, 4 * C * d)
            rec = dict(kernel="svrg_update", rows=C, d=d,
                       dtype=str(dtype).replace("torch.", ""), tol=tol,
                       ring_len=RING_LEN, max_abs_err=err, bits_equal=bits_equal,
                       ms=median_ms(lambda: svrg_update(
                           u, g, g0, gf, lr, ring=ring, slot=slot, acc=acc),
                           inner=200),
                       plain_ms=median_ms(lambda: svrg_update_ref(
                           u, g, g0, gf, lr, ring=ring, slot=slot, acc=acc),
                           inner=200),
                       bound_ms=bnd, bound_by=by,
                       bare_ms=median_ms(lambda: svrg_update(u, g, g0, gf, lr),
                                         inner=200),
                       bare_plain_ms=median_ms(
                           lambda: svrg_update_ref(u, g, g0, gf, lr), inner=200),
                       bare_bound_ms=bare_bnd, library_ms=None)
            emit(phase="kernels_vs_plain", **rec)
            if not (err <= tol and bits_equal):
                raise AssertionError(f"svrg_update disagrees: {rec}")
            if C == 1 and dtype == torch.float32:
                record = rec
    return record


def logreg_grad_vs_plain(ds, gen):
    """logreg_grad against its plain version (rtol 1e-5, atol 1e-6), each
    row bit-equal to the row alone: at rcv1 with 1 and 4 rows, timed beside
    the plain version and the two-matmul yardstick X.T @ (X @ W.T) (no
    single PyTorch call computes it; the port never calls it); then across
    the chunk edge (3, 5 and 9 rows) and at news20 width (4 rows, timed).
    The 1-row rcv1 case is the kernel's record."""
    from repro_torch.data.libsvm import make_synthetic_libsvm
    from repro_torch.kernels.logreg_grad.ops import logreg_grad
    from repro_torch.kernels.logreg_grad.ref import logreg_grad_ref

    news20 = make_synthetic_libsvm("news20", scale=1.0)
    cases = [("rcv1", ds, C, C in (1, 4)) for C in (1, 4, 3, 5, 9)]
    cases.append(("news20", news20, 4, True))
    record = None
    for name, data, C, timed in cases:
        X, y = data.as_torch("cuda")
        n, p = X.shape
        l2 = data.l2_reg
        W = 0.1 * torch.randn((C, p), generator=gen, device="cuda")
        G = logreg_grad(X, y, W, l2)
        R = logreg_grad_ref(X, y, W, l2)
        err = float((G - R).abs().max())
        close = bool(torch.allclose(G, R, rtol=1e-5, atol=1e-6))
        batch_independent = all(
            bool(torch.equal(G[c:c + 1], logreg_grad(X, y, W[c:c + 1]
                                                     .contiguous(), l2)))
            for c in range(C))
        # bytes: X, y and W read once, G written once; operations: a margin
        # and a gradient product per element and weight row, the sigmoid
        bnd, by = bound_ms(4 * (n * p + n + 2 * C * p),
                           C * (4 * n * p + 6 * n + 2 * p))
        rec = dict(kernel="logreg_grad", data=name, rows=C, n=n, p=p,
                   rtol=1e-5, atol=1e-6, max_abs_err=err, allclose=close,
                   batch_independent=batch_independent, bound_ms=bnd,
                   bound_by=by, library_ms=None)
        if timed:
            rec.update(
                ms=median_ms(lambda: logreg_grad(X, y, W, l2), inner=10),
                plain_ms=median_ms(lambda: logreg_grad_ref(X, y, W, l2),
                                   reps=5, inner=3),
                yardstick_ms=median_ms(lambda: X.T @ (X @ W.T), inner=10))
            rec["share_of_bound"] = bnd / rec["ms"]
        emit(phase="kernels_vs_plain", **rec)
        if not close or not batch_independent:
            raise AssertionError(f"logreg_grad disagrees: {rec}")
        if name == "rcv1" and C == 1:
            record = rec
    return record


def sweep_epoch_vs_plain(ds, gen):
    """sweep_epoch against its plain version on random w and mu with the real
    data, iterate and loss: at the main path's shape (the 4-row rcv1 AsySVRG
    group, the full epoch), which is also timed; then a 1-row Hogwild! group
    at rcv1, three news20 rows (no row stage fits beside a shared ring) and
    one rcv1 row with tau = 40 (the ring in device memory) at PLAIN_UPDATES
    steps. Each case runs once at the placement chosen by size and once at
    every other placement that fits (named through `sweep_epoch`'s
    ``placement``), each against the same plain result. The Hogwild! and news20 cases are
    timed too, per update."""
    from repro_torch import prng
    from repro_torch.data.libsvm import make_synthetic_libsvm
    from repro_torch.kernels.sweep_epoch import kernel, ops
    from repro_torch.kernels.sweep_epoch.ops import sweep_epoch
    from repro_torch.kernels.sweep_epoch.ref import sweep_epoch_ref

    news20 = make_synthetic_libsvm("news20", scale=1.0)
    X, y = ds.as_torch("cuda")
    n, d = X.shape
    full = THREADS * ((2 * n) // THREADS)
    limit = kernel.max_shared_bytes(torch.device("cuda"))
    # (name, data, engine, tau, scheme ids, delay ids, buf_len, expected
    # placement, inner updates)
    cases = [("rcv1_asysvrg_4rows", (X, y, ds.l2_reg), "asysvrg",
              [7, 7, 7, 0], [0, 1, 2, 0], [1, 1, 1, 0], 8, "shared", full),
             ("rcv1_hogwild_unlock", (X, y, ds.l2_reg), "hogwild",
              [7], [2], [1], 8, "shared", PLAIN_UPDATES),
             ("news20_asysvrg_3rows", (*news20.as_torch("cuda"), news20.l2_reg),
              "asysvrg", [9, 9, 9], [0, 1, 2], [1, 1, 2], 10, "global",
              PLAIN_UPDATES),
             ("rcv1_unlock_tau40", (X, y, ds.l2_reg), "asysvrg",
              [40], [2], [2], 41, "global", PLAIN_UPDATES)]
    timed = None
    for (name, (Xc, yc, l2), engine, tau, scheme, delay, buf_len, where,
         total) in cases:
        C, dc = len(tau), Xc.shape[1]
        w = 0.1 * torch.randn((C, dc), generator=gen, device="cuda")
        mu = 1e-3 * torch.randn((C, dc), generator=gen, device="cuda")
        keys = prng.keys_from_seeds(range(1000, 1000 + C), "cuda")
        step = torch.full((C,), STEP_SIZE, device="cuda")
        args = (Xc, yc, l2, w, mu if engine == "asysvrg" else None, keys,
                step, tau, scheme, delay)
        kw = dict(engine=engine, total=total, buf_len=buf_len, option=2,
                  drop_prob=DROP_PROB)
        before = dict(sweep_epoch.placements)
        out, loss = sweep_epoch(*args, **kw)
        torch.cuda.synchronize()
        used = [k for k, v in sweep_epoch.placements.items() if v != before[k]]
        if used != [where]:
            raise AssertionError(f"sweep_epoch {name}: placement {used}, "
                                 f"expected {where}")
        t0 = time.perf_counter()
        ref, ref_loss = sweep_epoch_ref(*args, **kw)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        results = {where: (out, loss)}
        for placement in ops.PLACEMENTS:
            if (placement not in results and ops.shared_bytes(
                    dc, buf_len, engine, placement) <= limit):
                results[placement] = sweep_epoch(*args, **kw,
                                                 placement=placement)
        torch.cuda.synchronize()
        placements = {}
        for placement, (o, lo) in results.items():
            placements[placement] = dict(
                max_abs_err=float((o - ref).abs().max()),
                loss_abs_err=float((lo - ref_loss).abs().max()),
                loss_rel_err=float(((lo - ref_loss).abs()
                                    / ref_loss.abs()).max()),
                bits_equal=bool(torch.equal(o, ref)),
                loss_bits_equal=bool(torch.equal(lo, ref_loss)),
                finite=bool(torch.isfinite(o).all()
                            and torch.isfinite(lo).all()))
        main = placements.pop(where)
        rec = dict(kernel="sweep_epoch", case=name, rows=C, n=Xc.shape[0],
                   d=dc, engine=engine, tau=tau, updates=total,
                   placement=where, stages=ops.STAGES, tol=1e-5,
                   loss_rtol=1e-6, loss=loss.tolist(), **main,
                   other_placements=placements, plain_s=plain_s)
        if name != "rcv1_asysvrg_4rows":
            ms = median_ms(lambda: sweep_epoch(*args, **kw), reps=5, inner=1)
            rec.update(ms=ms, us_per_update=1e3 * ms / total)
        emit(phase="kernels_vs_plain", **rec)
        if not all(v["max_abs_err"] <= 1e-5 and v["loss_rel_err"] <= 1e-6
                   and v["finite"] for v in (main, *placements.values())):
            raise AssertionError(f"sweep_epoch disagrees: {rec}")
        if name == "rcv1_asysvrg_4rows":
            if not (main["bits_equal"] and main["loss_bits_equal"]):
                raise AssertionError(f"sweep_epoch not bit-equal at the main "
                                     f"path's shape: {rec}")
            timed = (args, kw, C, max(main["max_abs_err"],
                                      main["loss_abs_err"]), plain_s)

    # time at the main path's shape, on the inputs just checked
    args, kw, C, err, plain_s = timed
    ms = median_ms(lambda: sweep_epoch(*args, **kw), reps=5, inner=1)
    # bytes: X, y, w and mu read once, the iterates and losses written once;
    # operations: ~15 d per row and update (two margins, two sample
    # gradients, the update and the average) and ~2 n d per row for the
    # loss, all at the float32 rate (the float64 sums would take longer);
    # the integer hashing of the draws not counted
    total = kw["total"]
    bnd, by = bound_ms(4 * (n * d + n + 3 * C * d + C),
                       C * (15 * total * d + 2 * n * d))
    rec = dict(kernel="sweep_epoch", case="rcv1_asysvrg_4rows_timed", rows=C,
               updates=total, placement="shared", stages=ops.STAGES, ms=ms,
               us_per_update=1e3 * ms / total, plain_ms=1e3 * plain_s,
               plain_ms_from="one run of the plain version at this shape",
               bound_ms=bnd, bound_by=by, library_ms=None, max_abs_err=err)
    emit(phase="kernels_vs_plain", **rec)
    return rec


def check_draws(ds):
    """The kernel's in-kernel threefry draws, bit for bit against prng.py."""
    from repro_torch import prng
    from repro_torch.kernels.sweep_epoch.ops import kernel_draws
    from repro_torch.kernels.sweep_epoch.ref import draws

    key = prng.PRNGKey(7, "cuda")
    checked = []
    for tau, delay_id in ((0, 0), (7, 1), (7, 2), (40, 2)):
        got = kernel_draws(key, ds.n, ds.p, tau, delay_id, 64)
        want = draws(key, ds.n, ds.p, tau, delay_id, 64)
        equal = [bool(torch.equal(g, w)) for g, w in zip(got, want)]
        checked.append(dict(tau=tau, delay_id=delay_id,
                            idx_age_read_drop_equal=equal))
        if not all(equal):
            raise AssertionError(f"sweep_epoch draws differ from prng: {checked}")
    emit(phase="sweep_epoch_draws", steps=64, n=ds.n, d=ds.p, checked=checked)


# gemma3-4b's prefill at the serve phase's shape: 29 window-1024 layers and
# 5 global ones (models/transformer.py's _layer_flags)
SERVE_ARCH = "gemma3-4b"
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 2048, 16
LAYER_MIX = {1024: 29, 0: 5}
# deepseek-moe-16b's prefill at the same batch and prompt: 28 global MHA
# layers (N = K = 16, h = 128), the tensor-core kernel's h = 128 instance
MOE_ARCH, MOE_LAYERS = "deepseek-moe-16b", 28
MOE_K4_CASE = "moe_global_bf16"
# recurrentgemma-2b's prefill at batch 4 and a prompt of twice its window:
# 8 local-attention layers, MQA (N 10 over K 1, h = 256), window 2048
HYBRID_ARCH, HYBRID_PROMPT, HYBRID_ATTN_LAYERS = "recurrentgemma-2b", 4096, 8
HYBRID_K4_CASE = "hybrid_mqa_window_bf16"
SSM_ARCH = "falcon-mamba-7b"
# whisper-large-v3's prefill at batch 4, prompt 448 (its decoder context):
# per decoder layer K4 runs the encoder's attention (1504 padded frames
# over the 1500 valid, non-causal), the decoder's causal self-attention
# (448) and the cross-attention (448 over 1500); MHA N = K = 20, h = 64.
# llama-3.2-vision-11b's at prompt 2048: 32 causal self layers (GQA 32:8,
# h = 128) and 8 cross layers over its 1601 image tokens
ENCDEC_ARCH, ENCDEC_PROMPT, ENCDEC_LAYERS = "whisper-large-v3", 448, 32
ENCDEC_FRAMES, ENCDEC_FRAMES_PADDED = 1500, 1504
VLM_ARCH, VLM_SELF_LAYERS, VLM_CROSS_LAYERS = "llama-3.2-vision-11b", 32, 8
VLM_IMAGE_TOKENS = 1601
# K4's cases on these paths: {case: (family, the part of a prefill it is)}
ENCDEC_VLM_K4_CASES = {"encdec_encoder_bf16": ("encdec", "encoder"),
                       "encdec_cross_bf16": ("encdec", "cross"),
                       "encdec_self_bf16": ("encdec", "self"),
                       "vlm_self_bf16": ("vlm", "self"),
                       "vlm_cross_bf16": ("vlm", "cross")}


def attention_pairs(S: int, window: int, causal: bool = True,
                    Sk: int = 0) -> int:
    """Unmasked (query, key) pairs of one head under the causal mask and
    ``window`` (0 = global); not causal, every pair of S queries and ``Sk``
    keys."""
    if not causal:
        return S * Sk
    rows = np.arange(S, dtype=np.int64) + 1
    return int(np.minimum(rows, window).sum() if window else rows.sum())


# bf16 flash_attention against the plain attention computed in float32
# from the same bf16 q, k, v: each element within BF16_ATOL + BF16_RTOL ·
# |ref| and each row (one query position of one head, h values) within
# BF16_ROW_REL in relative norm. The output's bf16 rounding alone is up to
# 2^-9 relative per element; the probabilities' bf16 rounding before the
# product with v adds the rest. The limits stand about 1.5x above the
# largest gaps the kernel shows on the H100 (this script's `atol_needed`
# and `max_row_rel_err`, which match `scaled_dot_product_attention`'s on
# the same inputs). Late rows of a long causal prefill are small (~0.04 at
# S = 2048), so the row norm is what sees a fault confined to them.
BF16_ATOL, BF16_RTOL, BF16_ROW_REL = 4e-3, 1e-2, 5e-3
F32_TOL = 2e-5         # float32 on the CUDA-core route: summation order


def attention_gaps(out, ref):
    """(max |out - ref| - BF16_RTOL·|ref|, the largest row's ||out - ref||
    / ||ref||) of ``out`` against the float32 ``ref``, rows along the last
    dim."""
    ref = ref.float()
    diff = (out.float() - ref).abs()
    elem = float((diff - BF16_RTOL * ref.abs()).max())
    row = float((diff.norm(dim=-1) / ref.norm(dim=-1)).max())
    return elem, row


def _f32_attention(q, k, v, ok):
    """Attention in float32 of q [B, Sq, N, h] over k, v [B, Sk, K, h]
    where ``ok`` [Sq, Sk], rounded to q's dtype."""
    G = q.shape[2] // k.shape[2]
    qt = q.float().transpose(1, 2)
    kt, vt = (t.float().transpose(1, 2).repeat_interleave(G, dim=1)
              for t in (k, v))
    scores = (qt @ kt.transpose(-1, -2)) / float(np.sqrt(q.shape[-1]))
    probs = torch.softmax(scores.masked_fill(~ok, float("-inf")), dim=-1)
    del scores
    return (probs @ vt).transpose(1, 2).to(q.dtype)


def planted_faults(q, k, v, out, window, causal=True, k_pad=None,
                   v_pad=None):
    """Faults the limit must reject, made from this case's inputs: each
    query block's last KV tile dropped on the rows of the second half
    (the attention there computed in float32 without those keys, rounded
    to q's dtype), and the kernel's output 2% too large; where k and v
    are the first Sk rows of longer buffers ``k_pad``, ``v_pad`` (a key
    length of its own), the attention over the buffers' every row, the
    padded keys counted: {name: faulty output}."""
    Sq, h = q.shape[1], q.shape[-1]
    Sk = k.shape[1]
    bk = 32 if h >= 192 else 64   # the tensor-core kernel's keys per tile
    i = torch.arange(Sq, device=q.device)[:, None]
    j = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= i >= j
        last = (i // 64) * 64 + 64 - bk
    else:
        last = (Sk - 1) // bk * bk
    if window:
        ok &= (i - j) < window
    faults = {"last_kv_tile_dropped_past_half": _f32_attention(
                  q, k, v, ok & ~((i >= Sq // 2) & (j >= last))),
              "output_2pct_too_large": (out.float() * 1.02).to(out.dtype)}
    if k_pad is not None:
        faults["padded_keys_counted"] = _f32_attention(
            q, k_pad, v_pad, torch.ones((Sq, k_pad.shape[1]),
                                        dtype=torch.bool, device=q.device))
    return faults


def flash_attention_vs_plain(gen):
    """flash_attention against its plain version on the same CUDA tensors:
    at the serve path's shapes (B 4, S 2048, N 8, K 4, h 256; windows 1024
    and 0) in bf16 on the tensor-core route (against the plain attention
    in float32 on the same bf16 inputs, within the BF16_* limits; the
    planted faults of `planted_faults` must fail them) and float32 on the
    CUDA-core route (F32_TOL), a ragged S = 2000, GQA 16:1 at h = 128, and
    deepseek-moe-16b's prefill shape (B 4, S 2048, N = K = 16, h 128,
    global; bf16), recurrentgemma-2b's (B 4, S 4096, MQA N 10 over K 1,
    h 256, window 2048; bf16), whisper-large-v3's three (B 4, MHA N = K =
    20, h 64: the encoder's 1504 queries over the first 1500 rows of a
    1504-row key buffer, the cross-attention's 448 over the same, both
    non-causal, the decoder's causal 448; bf16, and the cross-attention in
    float32) and llama-3.2-vision-11b's two (B 4, GQA 32:8, h 128: causal
    2048, and 2048 queries over 1601 image tokens, non-causal, read as the
    first rows of a buffer padded to 1616). A case with a key length of
    its own must also reject the attention with the buffer's padded keys
    counted. The bf16 main cases, deepseek's, recurrentgemma's, whisper's
    and the vision model's are timed beside the plain version, the
    CUDA-core kernel on the same bf16 inputs (the kernel before the
    tensor-core one) and `scaled_dot_product_attention` (the yardstick,
    with the band as a mask for a window, non-causal for a key length of
    its own; the port never calls it). Returns the kernel's record, per
    launch averaged over one gemma3-4b prefill's 34 layers, with
    deepseek's case under ``moe`` (28 launches a prefill),
    recurrentgemma's under ``hybrid`` (8), whisper's under ``encdec`` (96)
    and the vision model's under ``vlm`` (40)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.flash_attention.ops import gqa_flash
    from repro_torch.kernels.flash_attention.ref import attention_ref

    def plain(q, k, v, window, causal=True):
        G = q.shape[2] // k.shape[2]
        kt, vt = (t.transpose(1, 2).repeat_interleave(G, dim=1) for t in (k, v))
        return attention_ref(q.transpose(1, 2), kt, vt, causal=causal,
                             window=window).transpose(1, 2)

    bf16, f32 = torch.bfloat16, torch.float32

    def case(name, B, S, N, K, h, window, dtype, timed, Sk=None, pad=None):
        """S queries over Sk keys (default S, causal; else non-causal), the
        first Sk rows of a key buffer of ``pad`` rows (default Sk)."""
        return dict(name=name, B=B, Sq=S, Sk=Sk or S, Sp=pad or Sk or S, N=N,
                    K=K, h=h, window=window, causal=Sk is None, dtype=dtype,
                    timed=timed)

    E, Ep = ENCDEC_FRAMES, ENCDEC_FRAMES_PADDED
    T = VLM_IMAGE_TOKENS
    cases = [case("serve_window_bf16", 4, 2048, 8, 4, 256, 1024, bf16, True),
             case("serve_global_bf16", 4, 2048, 8, 4, 256, 0, bf16, True),
             case("serve_window_f32", 4, 2048, 8, 4, 256, 1024, f32, False),
             case("serve_global_f32", 4, 2048, 8, 4, 256, 0, f32, False),
             case("ragged_S2000_window_bf16", 4, 2000, 8, 4, 256, 1024, bf16,
                  False),
             case("gqa_16to1_h128_bf16", 4, 2048, 16, 1, 128, 0, bf16, False),
             case(MOE_K4_CASE, 4, 2048, 16, 16, 128, 0, bf16, True),
             case(HYBRID_K4_CASE, 4, HYBRID_PROMPT, 10, 1, 256, 2048, bf16,
                  True),
             case("encdec_encoder_bf16", 4, Ep, 20, 20, 64, 0, bf16, True,
                  Sk=E, pad=Ep),
             case("encdec_cross_bf16", 4, ENCDEC_PROMPT, 20, 20, 64, 0, bf16,
                  True, Sk=E, pad=Ep),
             case("encdec_self_bf16", 4, ENCDEC_PROMPT, 20, 20, 64, 0, bf16,
                  True),
             case("encdec_cross_f32", 4, ENCDEC_PROMPT, 20, 20, 64, 0, f32,
                  False, Sk=E, pad=Ep),
             case("vlm_self_bf16", 4, 2048, 32, 8, 128, 0, bf16, True),
             case("vlm_cross_bf16", 4, 2048, 32, 8, 128, 0, bf16, True, Sk=T,
                  pad=-(-T // 16) * 16)]
    timed = {}
    for c in cases:
        name, B, Sq, Sk, Sp = c["name"], c["B"], c["Sq"], c["Sk"], c["Sp"]
        N, K, h, window = c["N"], c["K"], c["h"], c["window"]
        causal, dtype = c["causal"], c["dtype"]
        q = torch.randn((B, Sq, N, h), generator=gen, device="cuda").to(dtype)
        k_pad, v_pad = (torch.randn((B, Sp, K, h), generator=gen,
                                    device="cuda").to(dtype)
                        for _ in range(2))
        k, v = k_pad[:, :Sk], v_pad[:, :Sk]
        before = dict(gqa_flash.launches_by_route)
        out = gqa_flash(q, k, v, causal=causal, window=window)
        ref = plain(q.float(), k.float(), v.float(), window, causal)
        torch.cuda.synchronize()
        (route,) = [r for r, n in gqa_flash.launches_by_route.items()
                    if n != before[r]]
        diff = (out.float() - ref).abs()
        padded = (k_pad, v_pad) if Sp > Sk else (None, None)
        faults = {}
        if dtype == bf16:
            elem, row = attention_gaps(out, ref)
            ok = elem <= BF16_ATOL and row <= BF16_ROW_REL
            limit = dict(against="plain attention in float32", atol=BF16_ATOL,
                         rtol=BF16_RTOL, row_rel=BF16_ROW_REL,
                         atol_needed=elem, max_row_rel_err=row)
            bf16_ref = plain(q, k, v, window, causal).float()
            for fault, bad in planted_faults(q, k, v, out, window, causal,
                                             *padded).items():
                bad_elem, bad_row = attention_gaps(bad, ref)
                bad_diff = (bad.float() - bf16_ref).abs()
                faults[fault] = dict(
                    atol_needed=bad_elem, max_row_rel_err=bad_row,
                    rejected=not (bad_elem <= BF16_ATOL
                                  and bad_row <= BF16_ROW_REL),
                    passes_flat_3e_2=bool(
                        (bad_diff <= 3e-2 + 3e-2 * bf16_ref.abs()).all()))
                del bad, bad_diff
            del bf16_ref
        else:
            ok = bool((diff <= F32_TOL + F32_TOL * ref.abs()).all())
            limit = dict(against="plain attention", atol=F32_TOL,
                         rtol=F32_TOL)
            if Sk != Sq:
                for fault, bad in planted_faults(q, k, v, out, window, causal,
                                                 *padded).items():
                    bad_diff = (bad - ref).abs()
                    faults[fault] = dict(
                        max_abs_err=float(bad_diff.max()),
                        rejected=not bool((bad_diff <= F32_TOL + F32_TOL
                                           * ref.abs()).all()))
                    del bad, bad_diff
        if faults:
            limit["planted_faults"] = faults
        size = q.element_size()
        pairs = B * N * attention_pairs(Sq, window, causal, Sk)
        bnd, by = bound_ms(size * (2 * B * Sq * N * h + 2 * B * Sk * K * h),
                           4 * h * pairs,
                           BF16_FLOP_PER_S if dtype == bf16 else FP32_FLOP_PER_S)
        rec = dict(kernel="flash_attention", case=name, B=B, S=Sq, Sk=Sk,
                   key_buffer_rows=Sp, N=N, K=K, h=h, window=window,
                   causal=causal, dtype=str(dtype).replace("torch.", ""),
                   kernel_route=route, **limit,
                   max_abs_err=float(diff.max()),
                   within_tol=ok, finite=bool(torch.isfinite(out).all()),
                   pairs=pairs, bound_ms=bnd, bound_by=by)
        if c["timed"]:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            pos = torch.arange(Sq, device="cuda")
            band = ((pos[:, None] >= pos[None, :])
                    & (pos[:, None] - pos[None, :] < window))

            def library():
                if window:
                    return F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=band, enable_gqa=True)
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True)

            simt_out = torch.empty_like(q)

            def simt():
                rc = kernel.launch(q, k, v, simt_out, causal=causal,
                                   window=window, route="simt")
                if rc != 0:
                    raise RuntimeError(f"simt flash_attention: CUDA error {rc}")

            ms = median_ms(lambda: gqa_flash(q, k, v, causal=causal,
                                             window=window),
                           reps=11, inner=10)
            rec.update(
                ms=ms, tflop_per_s=4 * h * pairs / ms / 1e9,
                share_of_bound=bnd / ms,
                plain_ms=median_ms(lambda: plain(q, k, v, window, causal),
                                   reps=5, inner=5),
                simt_ms=median_ms(simt, reps=3, inner=3),
                simt_max_abs_err=float((simt_out.float() - ref.float())
                                       .abs().max()),
                library_ms=median_ms(library, reps=11, inner=10),
                library_max_abs_err=float((library().transpose(1, 2).float()
                                           - ref.float()).abs().max()))
            rec["ms_over_library_ms"] = ms / rec["library_ms"]
            timed[name] = rec
        emit(phase="kernels_vs_plain", **rec)
        want = "wgmma" if dtype == bf16 else "simt"
        if not (ok and rec["finite"] and route == want):
            raise AssertionError(f"flash_attention disagrees: {rec}")
        if not all(f["rejected"] for f in faults.values()):
            raise AssertionError(f"flash_attention's limit lets a planted "
                                 f"fault pass: {rec}")
        if (dtype == bf16 or Sk != Sq) and len(faults) != 2 + (Sp > Sk):
            raise AssertionError(f"flash_attention: planted faults missing: "
                                 f"{rec}")
    moe_rec = timed.pop(MOE_K4_CASE)
    hybrid_rec = timed.pop(HYBRID_K4_CASE)
    parts = {family: {} for family in ("encdec", "vlm")}
    for name, (family, part) in ENCDEC_VLM_K4_CASES.items():
        parts[family][part] = timed.pop(name)
    by_window = {t["window"]: t for t in timed.values()}
    layers = sum(LAYER_MIX.values())
    mix = {key: sum(n * by_window[w][key] for w, n in LAYER_MIX.items())
           / layers
           for key in ("ms", "plain_ms", "simt_ms", "library_ms", "bound_ms")}
    (bound_by,) = {t["bound_by"] for t in timed.values()}
    keys = ("ms", "plain_ms", "simt_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err", "share_of_bound", "ms_over_library_ms")
    rec = dict(kernel="flash_attention", case="serve_prefill_mix",
               kernel_route="wgmma",
               per="launch, averaged over one prefill's layers",
               layers=LAYER_MIX, **mix, bound_by=bound_by,
               max_abs_err=max(t["max_abs_err"] for t in timed.values()),
               per_prefill_ms=mix["ms"] * layers,
               per_prefill_simt_ms=mix["simt_ms"] * layers,
               per_prefill_library_ms=mix["library_ms"] * layers,
               per_prefill_bound_ms=mix["bound_ms"] * layers,
               moe={key: moe_rec[key] for key in keys})
    rec["moe"].update(
        layers=MOE_LAYERS, per_prefill_ms=moe_rec["ms"] * MOE_LAYERS,
        per_prefill_library_ms=moe_rec["library_ms"] * MOE_LAYERS,
        per_prefill_bound_ms=moe_rec["bound_ms"] * MOE_LAYERS)
    rec["hybrid"] = {key: hybrid_rec[key] for key in keys}
    rec["hybrid"].update(
        layers=HYBRID_ATTN_LAYERS,
        per_prefill_ms=hybrid_rec["ms"] * HYBRID_ATTN_LAYERS,
        per_prefill_library_ms=hybrid_rec["library_ms"] * HYBRID_ATTN_LAYERS,
        per_prefill_bound_ms=hybrid_rec["bound_ms"] * HYBRID_ATTN_LAYERS)
    # launches per prefill of each part: whisper's three per decoder layer
    # (32 encoder layers, 32 decoder layers), the vision model's self and
    # cross layers
    counts = {"encdec": dict.fromkeys(("encoder", "cross", "self"),
                                      ENCDEC_LAYERS),
              "vlm": {"self": VLM_SELF_LAYERS, "cross": VLM_CROSS_LAYERS}}
    for family, by_part in parts.items():
        rec[family] = {part: {key: r[key] for key in keys}
                       for part, r in by_part.items()}
        for key in ("ms", "library_ms", "bound_ms", "plain_ms"):
            rec[family][f"per_prefill_{key}"] = sum(
                counts[family][part] * r[key] for part, r in by_part.items())
        rec[family]["launches_per_prefill"] = sum(counts[family].values())
    emit(phase="kernels_vs_plain", **rec)
    return rec


def reset_counts():
    from repro_torch.kernels.flash_attention.ops import gqa_flash
    from repro_torch.kernels.logreg_grad.ops import logreg_grad
    from repro_torch.kernels.svrg_update.ops import svrg_update
    from repro_torch.kernels.sweep_epoch.ops import sweep_epoch
    svrg_update.launches = 0
    logreg_grad.launches = 0
    sweep_epoch.launches = 0
    sweep_epoch.placements = dict.fromkeys(sweep_epoch.placements, 0)
    gqa_flash.launches = 0
    gqa_flash.launches_by_route = dict.fromkeys(gqa_flash.launches_by_route, 0)
    reset_mlp_counts()


def read_counts():
    from repro_torch.kernels.flash_attention.ops import gqa_flash
    from repro_torch.kernels.logreg_grad.ops import logreg_grad
    from repro_torch.kernels.svrg_update.ops import svrg_update
    from repro_torch.kernels.sweep_epoch.ops import sweep_epoch
    return {"svrg_update": svrg_update.launches,
            "logreg_grad": logreg_grad.launches,
            "sweep_epoch": sweep_epoch.launches,
            "flash_attention": gqa_flash.launches}


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
                  "logreg_grad": RCV1_EPOCHS, "sweep_epoch": 0,
                  "flash_attention": 0}:
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


def sweep_specs(obj, engine_mode):
    """The three schemes + serial SVRG (one 4-row group) and Hogwild! (a
    second group)."""
    from repro_torch.core.sweep import SweepSpec

    total = THREADS * ((2 * obj.n) // THREADS)
    specs = [SweepSpec(seed=0, scheme=s, step_size=STEP_SIZE,
                       num_threads=THREADS, engine_mode=engine_mode)
             for s in ("consistent", "inconsistent", "unlock")]
    specs += [SweepSpec(algo="svrg", step_size=STEP_SIZE, num_threads=THREADS,
                        inner_steps=total, engine_mode=engine_mode),
              SweepSpec(algo="hogwild", scheme="unlock", step_size=STEP_SIZE,
                        num_threads=THREADS, tau=-1, engine_mode=engine_mode)]
    return specs, total


def phase_sweep(obj):
    """run_sweep at full width, batched: 5 rows in 2 groups; then one row
    alone."""
    from repro_torch.core.sweep import plan_sweep, run_sweep

    specs, total = sweep_specs(obj, "vmap")
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
    if counts != {"logreg_grad": RCV1_EPOCHS,
                  "svrg_update": RCV1_EPOCHS * total, "sweep_epoch": 0,
                  "flash_attention": 0}:
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
    return res, wall / RCV1_EPOCHS


def phase_sweep_fused(obj, batched, batched_s_per_epoch):
    """run_sweep at full width with engine_mode="fused": one sweep_epoch
    launch per group and epoch, logreg_grad for the AsySVRG group's
    snapshots, no svrg_update. Held against the batched sweep (the
    card-vs-CPU limits: summation order only) and a row alone against the
    row in its group (w bit-equal)."""
    from repro_torch.core.sweep import plan_sweep, run_sweep
    from repro_torch.kernels.sweep_epoch.ops import sweep_epoch

    specs, _ = sweep_specs(obj, "fused")
    plan = plan_sweep(obj, RCV1_EPOCHS, specs)
    groups = [len(m) for m in plan.groups.values()]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = run_sweep(obj, RCV1_EPOCHS, specs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    placements = dict(sweep_epoch.placements)
    for c, spec in enumerate(specs):
        check_history(f"fused run_sweep row {c} ({spec.algo}/{spec.scheme})",
                      res.histories[c])
    want = {"sweep_epoch": len(groups) * RCV1_EPOCHS,
            "logreg_grad": RCV1_EPOCHS, "svrg_update": 0,
            "flash_attention": 0}
    loss_gap = float(np.max(np.abs(res.histories - batched.histories)
                            / np.abs(batched.histories)))
    dw = float(np.abs(res.final_w - batched.final_w).max())
    alone = run_sweep(obj, RCV1_EPOCHS, [specs[2]])
    a_dw = float(np.abs(alone.final_w[0] - res.final_w[2]).max())
    a_dh = float(np.max(np.abs(alone.histories[0] - res.histories[2])
                        / np.abs(res.histories[2])))
    rec = dict(phase="run_sweep_fused", rows=len(specs), groups=groups,
               epochs=RCV1_EPOCHS, wall_s=wall,
               wall_s_per_epoch=wall / RCV1_EPOCHS,
               batched_wall_s_per_epoch=batched_s_per_epoch,
               launches=counts, placements=placements,
               histories=res.histories.tolist(),
               vs_batched=dict(history_rel_gap=loss_gap, max_abs_dw=dw,
                               rtol_loss=1e-4, atol_w=1e-5),
               alone_vs_group=dict(row=2, max_abs_dw=a_dw,
                                   history_rel_gap=a_dh,
                                   w_bits_equal=bool(np.array_equal(
                                       alone.final_w[0], res.final_w[2])),
                                   history_bits_equal=bool(np.array_equal(
                                       alone.histories[0], res.histories[2]))))
    emit(**rec)
    if counts != want:
        raise AssertionError(f"fused sweep launch counts {counts} != {want}")
    if not (loss_gap <= 1e-4 and dw <= 1e-5):
        raise AssertionError(f"fused and batched sweeps disagree: "
                             f"{rec['vs_batched']}")
    if not (rec["alone_vs_group"]["w_bits_equal"] and a_dh <= 1e-7):
        raise AssertionError(f"fused row alone vs in its group: "
                             f"{rec['alone_vs_group']}")
    return counts, res, wall / RCV1_EPOCHS


@contextmanager
def device_timed_runners():
    """Every group runner fetched inside the block wrapped in a CUDA-event
    pair recorded just before and just after its call: yields the list of
    (start, stop) pairs in call order. The stop event runs on the card
    after the call's last launch, so the pair's elapsed time is the
    device's work from the call's start to its end."""
    from repro_torch.service import cache

    fetch, pairs = cache.get_group_runner, []

    def timed_fetch(*args, **kwargs):
        runner = fetch(*args, **kwargs)

        def call(*call_args):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = runner(*call_args)
            stop.record()
            pairs.append((start, stop))
            return out
        return call

    cache.get_group_runner = timed_fetch
    try:
        yield pairs
    finally:
        cache.get_group_runner = fetch


def phase_obs(obj, batched, batched_s_per_epoch, fused, fused_s_per_epoch):
    """The 5-row rcv1 grid (`sweep_specs`), fused and batched, with the
    tracer and the ledger on, inside one traced root span per mode:
    histories against the obs-off runs of phases `run_sweep_fused` (equal
    bits) and `run_sweep` (the alone-vs-group limits); the fused grid's
    wall with obs off and on in turns (off, on, on, off: the first "on" is
    the run checked here); one ``execute`` span per group tagged
    ``engine_mode`` and ``backend="cuda"``; one ledger entry per group with
    the analytic operations and bytes, ``attained_frac`` against the H100
    and a ``wall_s`` not shorter than the CUDA-event pair around the same
    runner call (a clock that stopped at the launches' enqueue would be
    far shorter on the fused groups). Then 2 fused rows with uniform
    delays and telemetry on: each row's realized delays, replayed on the
    CPU by `obs.telemetry`, against the delays the sweep kernel draws
    on the card from the same epoch keys (`kernel_draws`), integer for
    integer; and the same rows swept again with telemetry off: final
    iterates equal bit for bit, and the update norm against the norm of
    that run's update, computed on the card."""
    import dataclasses

    from repro_torch import prng
    from repro_torch.core.sweep import SweepSpec, plan_sweep, run_sweep
    from repro_torch.kernels.sweep_epoch.ops import kernel_draws
    from repro_torch.obs import ledger, telemetry
    from repro_torch.obs.trace import disable_tracing, enable_tracing

    def timed(specs, on):
        """Seconds of a sweep of ``specs`` with the tracer and the ledger
        ``on`` (a traced root span around it) or off, synchronised."""
        if on:
            enable_tracing()
            ledger.enable_ledger()
        else:
            disable_tracing()
            ledger.disable_ledger()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with tr.span(tr.new_trace(), "sweep"):
            run_sweep(obj, RCV1_EPOCHS, specs)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    tr = enable_tracing()
    out = {}
    try:
        for mode, off, off_s in (("fused", fused, fused_s_per_epoch),
                                 ("vmap", batched, batched_s_per_epoch)):
            specs, _ = sweep_specs(obj, mode)
            groups = list(plan_sweep(obj, RCV1_EPOCHS, specs).groups)
            turns = [timed(specs, False)] if mode == "fused" else []
            enable_tracing()
            led = ledger.enable_ledger()
            led.clear()
            tid = tr.new_trace()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with device_timed_runners() as pairs, tr.span(tid, "sweep"):
                res = run_sweep(obj, RCV1_EPOCHS, specs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            device_ms = [a.elapsed_time(b) for a, b in pairs]
            spans = [sp for sp in tr.get(tid)["spans"]
                     if sp["name"] == "execute"]
            entries = led.snapshot()
            if mode == "fused":
                turns += [wall, timed(specs, True), timed(specs, False)]
                equal = bool(np.array_equal(res.histories, off.histories)
                             and np.array_equal(res.final_w, off.final_w))
                agree = equal
            else:
                equal = None
                agree = bool(np.allclose(res.histories, off.histories,
                                         rtol=1e-5, atol=1e-6)
                             and np.allclose(res.final_w, off.final_w,
                                             rtol=1e-5, atol=1e-6))
            rec = dict(
                mode=mode, groups=len(groups), wall_s_obs_on=wall,
                wall_s_per_epoch_obs_on=wall / RCV1_EPOCHS,
                wall_s_per_epoch_obs_off=off_s,
                wall_s_off_on_on_off=turns,
                histories_bits_equal_to_obs_off=equal,
                histories_within_tol_of_obs_off=agree,
                execute_spans=[dict(tags=sp["tags"], ms=sp["duration_ms"])
                               for sp in spans],
                ledger=[dict(label=e_label, wall_s=e["wall_s_total"],
                             device_ms=ms, flops=e["flops"], bytes=e["bytes"],
                             flops_source=e["flops_source"],
                             roofline_s=e["roofline_s"],
                             attained_frac=e["attained_frac"],
                             dispatches=e["dispatches"])
                        for (e_label, e), ms in zip(entries.items(),
                                                    device_ms)])
            out[mode] = rec
            if not agree:
                raise AssertionError(f"obs {mode}: results with the tracer "
                                     f"and the ledger on differ: {rec}")
            if len(spans) != len(groups) or any(
                    sp["tags"].get("engine_mode") != mode
                    or sp["tags"].get("backend") != "cuda" for sp in spans):
                raise AssertionError(f"obs {mode}: execute spans {spans}")
            if len(entries) != len(groups) or len(device_ms) != len(groups) \
                    or any(e["flops_source"] != "analytic" or e["flops"] <= 0
                           or e["bytes"] <= 0 or e["attained_frac"] <= 0
                           or e["dispatches"] != 1
                           for e in entries.values()):
                raise AssertionError(f"obs {mode}: ledger {rec['ledger']}")
            short = [r for r in rec["ledger"]
                     if 1e3 * r["wall_s"] < r["device_ms"]]
            if short:
                raise AssertionError(f"obs {mode}: ledger wall_s shorter than "
                                     f"the device's work: {short}")
    finally:
        disable_tracing(clear=True)
        ledger.disable_ledger(clear=True)

    # telemetry: realized delays replayed on the CPU against the kernel's
    specs = [SweepSpec(seed=seed, scheme=scheme, step_size=STEP_SIZE,
                       num_threads=THREADS, delay_kind="uniform",
                       engine_mode="fused", telemetry=True)
             for seed, scheme in ((3, "inconsistent"), (4, "unlock"))]
    res = run_sweep(obj, RCV1_EPOCHS, specs)
    plain = run_sweep(obj, RCV1_EPOCHS,
                      [dataclasses.replace(s, telemetry=False) for s in specs])
    tel = res.telemetry
    w0 = obj.init_flat().double()
    checks = []
    for c, spec in enumerate(res.specs):
        total, tau = int(res.total_updates[c]) // RCV1_EPOCHS, spec.tau
        key = prng.PRNGKey(spec.seed, "cuda")[None]
        drawn = []
        for _ in range(RCV1_EPOCHS):
            halves = prng.split(key, 2)
            key, sub = halves[:, 0], halves[:, 1]
            _, age, _, _ = kernel_draws(sub[0], obj.n, obj.p, tau, 2, total)
            drawn.append((torch.arange(total, device="cuda") - age).cpu())
        drawn = torch.stack(drawn).numpy()
        replay = telemetry.realized_delays(spec.seed, 2, tau, total,
                                           RCV1_EPOCHS)
        norm = float(torch.linalg.vector_norm(
            torch.as_tensor(plain.final_w[c], device="cuda").double() - w0))
        checks.append(dict(
            row=c, tau=tau, delays_equal=bool(np.array_equal(drawn, replay)),
            staleness_mean=float(tel.staleness_mean[c]),
            staleness_mean_kernel=float(drawn.mean()),
            staleness_var=float(tel.staleness_var[c]),
            staleness_var_kernel=float(drawn.astype(np.float64).var()),
            staleness_max=int(tel.staleness_max[c]),
            staleness_max_kernel=int(drawn.max()),
            final_w_equal_telemetry_off=bool(np.array_equal(
                res.final_w[c], plain.final_w[c])),
            update_norm=float(tel.update_norm[c]),
            update_norm_telemetry_off_card=norm))
    out["telemetry"] = checks
    emit(phase="obs", **out)
    for ch in checks:
        if not (ch["delays_equal"] and ch["final_w_equal_telemetry_off"]
                and ch["staleness_mean"] == ch["staleness_mean_kernel"]
                and ch["staleness_var"] == ch["staleness_var_kernel"]
                and ch["staleness_max"] == ch["staleness_max_kernel"]
                and abs(ch["update_norm"]
                        - ch["update_norm_telemetry_off_card"])
                <= 1e-6 * max(1.0, ch["update_norm_telemetry_off_card"])):
            raise AssertionError(f"obs: telemetry against the card: {ch}")
    return out


# the service phase's batched rows: rcv1 at a tenth of its rows (n = 2024,
# the full width p = 2048), so an epoch of 4048 updates takes about a second
SERVICE_SMALL_SCALE = 0.1
DIVERGING_STEP = 1e4   # NaNs or explodes the rcv1 loss at epoch 1


def service_requests():
    """The three requests of phase `service`: (tenant, specs)."""
    from repro_torch.core.sweep import SweepSpec

    fused = [SweepSpec(seed=seed, scheme=scheme, step_size=STEP_SIZE,
                       num_threads=THREADS, engine_mode="fused")
             for seed, scheme in ((5, "consistent"), (6, "unlock"))]
    small = [SweepSpec(seed=seed, scheme=scheme, step_size=STEP_SIZE,
                       num_threads=THREADS, engine_mode="vmap",
                       objective="rcv1-small")
             for seed, scheme in ((7, "inconsistent"), (8, "unlock"))]
    diverging = [SweepSpec(seed=9, scheme="inconsistent",
                           step_size=DIVERGING_STEP, num_threads=THREADS,
                           engine_mode="fused")]
    return (("tenant-a", fused), ("tenant-b", small), ("tenant-b", diverging))


def service_flush(obj, policy):
    """One `SweepService` with the watchdog's ``policy``: the three
    requests of `service_requests` submitted, one flush, with the launch
    counts, the cache's counters and `_build.builds()` read around it.
    Returns (results by request, record)."""
    from repro_torch.kernels import _build
    from repro_torch.obs.watchdog import Watchdog
    from repro_torch.service import SweepService, cache_stats

    svc = SweepService(obj, epochs=RCV1_EPOCHS,
                       watchdog=Watchdog(policy=policy))
    rids = [svc.submit(specs, tenant=tenant)
            for tenant, specs in service_requests()]
    torch.cuda.synchronize()
    base, built = cache_stats(), _build.builds()
    reset_counts()
    t0 = time.perf_counter()
    done = svc.flush()
    wall = time.perf_counter() - t0
    counts = read_counts()
    delta = cache_stats().since(base)
    stats = svc.stats()
    results = [svc.result(r) for r in rids]
    rec = dict(policy=policy, flush_s=wall, completed=done, launches=counts,
               groups=stats.groups_dispatched,
               groups_merged=stats.groups_merged,
               rows_coalesced=stats.rows_coalesced,
               rows_diverged=stats.rows_diverged,
               runners_constructed=delta.misses, cache_hits=delta.hits,
               compiles=delta.compiles,
               kernels_built=_build.builds() - built,
               tenants=svc.tenant_rows())
    return results, rec


def phase_service(obj):
    """The sweep service at rcv1 width: two tenants submit three requests
    (`service_requests`: 2 fused rows on the full rcv1 objective, 2
    batched rows on rcv1 at `SERVICE_SMALL_SCALE` under a registered name,
    1 fused row whose step of `DIVERGING_STEP` diverges), and one flush
    coalesces them into 2 groups (the diverging row shares the first
    tenant's fused group): K3 and K2 launched groups x epochs times (K2
    once per group and epoch, K3 once per fused group and epoch), each
    request's demuxed result against a standalone `run_sweep` of its
    specs (fused bits equal; batched rtol 1e-5, atol 1e-6), the diverging
    row flagged under ``record`` with its outputs kept. A second flush of
    the same shapes under ``cancel_row``: no runner constructed, no kernel
    built, the diverging row frozen at its last trusted epoch, the other
    rows equal to the first flush's. Then `run_job` over a 3-row fused job
    in 2 groups with ``max_groups=1``, resumed from its checkpoint, against
    the same job in one call: equal bits."""
    import shutil
    import tempfile

    from repro_torch import LogisticRegression
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core.objective import (register_objective,
                                            unregister_objective)
    from repro_torch.core.sweep import SweepSpec, run_sweep
    from repro_torch.data.libsvm import make_synthetic_libsvm
    from repro_torch.service import SweepService

    ds = make_synthetic_libsvm("rcv1", scale=SERVICE_SMALL_SCALE)
    small = register_objective("rcv1-small",
                               LogisticRegression(ds.X, ds.y, ds.l2_reg))
    requests = service_requests()
    try:
        first, rec1 = service_flush(obj, "record")
        second, rec2 = service_flush(obj, "cancel_row")
        alone = [run_sweep(None if specs[0].objective else obj, RCV1_EPOCHS,
                           specs) for _, specs in requests]
    finally:
        unregister_objective("rcv1-small")
    fused_equal = bool(np.array_equal(first[0].histories, alone[0].histories)
                       and np.array_equal(first[0].final_w, alone[0].final_w))
    batched_close = bool(
        np.allclose(first[1].histories, alone[1].histories, rtol=1e-5,
                    atol=1e-6)
        and np.allclose(first[1].final_w, alone[1].final_w, rtol=1e-5,
                        atol=1e-6))
    with np.errstate(invalid="ignore"):
        record_kept = bool(
            np.array_equal(first[2].histories, alone[2].histories,
                           equal_nan=True)
            and np.array_equal(first[2].final_w, alone[2].final_w,
                               equal_nan=True))
    flagged = first[2].diverged_rows
    frozen = second[2]
    k = int(frozen.epochs_per_row[0])
    frozen_ok = bool(
        frozen.diverged_rows is not None and frozen.diverged_rows[0] == k
        and k < RCV1_EPOCHS
        and np.all(frozen.histories[0, k:] == frozen.histories[0, k])
        and np.all(np.isfinite(frozen.histories[0]))
        and (k > 0 or np.array_equal(frozen.final_w[0],
                                     obj.init_flat().cpu().numpy())))
    survivors = bool(all(
        np.array_equal(a.histories, b.histories)
        and np.array_equal(a.final_w, b.final_w)
        for a, b in zip(first[:1], second[:1]))
        and np.allclose(first[1].histories, second[1].histories, rtol=1e-5,
                        atol=1e-6))

    # run_job: a 3-row fused job in 2 groups (AsySVRG, Hogwild!), cut after
    # its first group and resumed, against the job in one call
    job = requests[0][1] + [SweepSpec(algo="hogwild", scheme="unlock",
                                      step_size=STEP_SIZE, num_threads=THREADS,
                                      tau=-1, engine_mode="fused")]
    root = ROOT / "build"
    root.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_jobs-", dir=root))
    try:
        svc = SweepService(obj, epochs=RCV1_EPOCHS)
        cut = svc.run_job(job, checkpointer=Checkpointer(str(tmp / "cut")),
                          max_groups=1)
        resumed, done = svc.run_job(
            job, checkpointer=Checkpointer(str(tmp / "cut")))
        whole, whole_done = svc.run_job(
            job, checkpointer=Checkpointer(str(tmp / "whole")))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    job_equal = bool(cut == (None, False) and done and whole_done
                     and np.array_equal(resumed.histories, whole.histories)
                     and np.array_equal(resumed.final_w, whole.final_w))
    groups, fused_groups = rec1["groups"], 1
    want = {"logreg_grad": groups * RCV1_EPOCHS,
            "sweep_epoch": fused_groups * RCV1_EPOCHS}
    rec = dict(
        phase="service", epochs=RCV1_EPOCHS, n_full=obj.n, n_small=ds.n,
        p=obj.p, requests=[dict(tenant=t, rows=len(s),
                                engine_mode=s[0].engine_mode,
                                objective=s[0].objective or "rcv1")
                           for t, s in requests],
        first_flush=rec1, second_flush=rec2,
        fused_bits_equal_alone=fused_equal,
        batched_within_tol_alone=batched_close,
        batched_max_abs_dhist=float(np.abs(first[1].histories
                                           - alone[1].histories).max()),
        diverged_rows_record=None if flagged is None else flagged.tolist(),
        diverging_history_record=first[2].histories[0].tolist(),
        record_outputs_kept=record_kept,
        diverged_rows_cancel=None if frozen.diverged_rows is None
        else frozen.diverged_rows.tolist(),
        frozen_epochs=k, frozen_history=frozen.histories[0].tolist(),
        frozen_ok=frozen_ok, survivors_equal_first_flush=survivors,
        run_job_resumed_equals_one_call=job_equal)
    emit(**rec)
    if {k_: rec1["launches"][k_] for k_ in want} != want \
            or rec1["launches"]["svrg_update"] < 1:
        raise AssertionError(f"service: launches {rec1['launches']} != "
                             f"{want} (and K1 for the batched group)")
    if not (fused_equal and batched_close and record_kept):
        raise AssertionError(f"service: demuxed results differ from "
                             f"standalone run_sweep: {rec}")
    if flagged is None or flagged.tolist() != [k] or not frozen_ok \
            or not survivors:
        raise AssertionError(f"service: watchdog: {rec}")
    if rec2["runners_constructed"] or rec2["compiles"] \
            or rec2["kernels_built"]:
        raise AssertionError(f"service: the warm flush constructed or built: "
                             f"{rec2}")
    if not job_equal:
        raise AssertionError(f"service: run_job resumed != one call: {rec}")
    return rec


# phase `objectives`: the clipped penalty of examples/nonconvex_sweep.py and
# the MLP at benchmarks/nonconvex_frontier.py's size
NCV_LAM, NCV_ALPHA = 1e-3, 10.0
NCV_PLAIN_UPDATES = 2048      # K3's clipped cases against the plain version
NCV_CPU_INNER = 512           # card vs CPU: M̃ = THREADS x 512 = 4096
MLP_N, MLP_WIDTHS = 64, dict(vocab_size=16, seq_len=4, d_model=8, d_hidden=16)
MLP_STEPS = (0.05, 0.1, 0.2)


def logreg_grad_clipped_vs_plain(X, y, gen):
    """K2 with the clipped penalty against its plain version at rcv1 with 1
    and 4 rows (rtol 1e-5, atol 1e-6; each row bit-equal alone), timed
    beside the plain version. Bound: the L2 case's bytes, ~7 operations per
    coordinate for the penalty's gradient where L2 takes 2."""
    from repro_torch.kernels.logreg_grad.ops import logreg_grad
    from repro_torch.kernels.logreg_grad.ref import logreg_grad_ref

    reg = (NCV_LAM, NCV_ALPHA)
    n, p = X.shape
    out = {}
    for C in (1, 4):
        W = 0.3 * torch.randn((C, p), generator=gen, device="cuda")
        G, R = logreg_grad(X, y, W, reg), logreg_grad_ref(X, y, W, reg)
        alone = all(bool(torch.equal(G[c:c + 1], logreg_grad(
            X, y, W[c:c + 1].contiguous(), reg))) for c in range(C))
        bnd, by = bound_ms(4 * (n * p + n + 2 * C * p),
                           C * (4 * n * p + 6 * n + 7 * p))
        rec = dict(kernel="logreg_grad", case=f"clipped_rcv1_{C}rows", rows=C,
                   n=n, p=p, lam=NCV_LAM, alpha=NCV_ALPHA, rtol=1e-5,
                   atol=1e-6, max_abs_err=float((G - R).abs().max()),
                   allclose=bool(torch.allclose(G, R, rtol=1e-5, atol=1e-6)),
                   batch_independent=alone,
                   ms=median_ms(lambda: logreg_grad(X, y, W, reg), inner=10),
                   plain_ms=median_ms(lambda: logreg_grad_ref(X, y, W, reg),
                                      reps=5, inner=3),
                   bound_ms=bnd, bound_by=by, library_ms=None)
        emit(phase="objectives_kernels", **rec)
        if not (rec["allclose"] and alone):
            raise AssertionError(f"logreg_grad (clipped) disagrees: {rec}")
        out[C] = rec
    return out[1]


def sweep_epoch_clipped_vs_plain(X, y, gen):
    """K3 with the clipped penalty against its plain version, iterate and
    loss in equal bits: the 4-row rcv1 AsySVRG group (the three readers and
    serial SVRG) and one Hogwild! unlock row, `NCV_PLAIN_UPDATES` updates
    each (the plain version steps in Python); then the 4-row group timed at
    the main path's M̃ = 40480 beside its bound."""
    from repro_torch import prng
    from repro_torch.kernels.sweep_epoch.ops import sweep_epoch
    from repro_torch.kernels.sweep_epoch.ref import sweep_epoch_ref

    reg = (NCV_LAM, NCV_ALPHA)
    n, d = X.shape
    full = THREADS * ((2 * n) // THREADS)
    cases = [("clipped_rcv1_asysvrg_4rows", "asysvrg", [7, 7, 7, 0],
              [0, 1, 2, 0], [1, 1, 1, 0]),
             ("clipped_rcv1_hogwild_unlock", "hogwild", [7], [2], [1])]
    timed = None
    plain_s = {}
    for name, engine, tau, scheme, delay in cases:
        C = len(tau)
        w = 0.1 * torch.randn((C, d), generator=gen, device="cuda")
        mu = 1e-3 * torch.randn((C, d), generator=gen, device="cuda")
        keys = prng.keys_from_seeds(range(2000, 2000 + C), "cuda")
        step = torch.full((C,), STEP_SIZE, device="cuda")
        args = (X, y, reg, w, mu if engine == "asysvrg" else None, keys, step,
                tau, scheme, delay)
        kw = dict(engine=engine, total=NCV_PLAIN_UPDATES, buf_len=RING_LEN,
                  option=2, drop_prob=DROP_PROB)
        out, loss = sweep_epoch(*args, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref, ref_loss = sweep_epoch_ref(*args, **kw)
        torch.cuda.synchronize()
        plain_s[name] = time.perf_counter() - t0
        rec = dict(kernel="sweep_epoch", case=name, rows=C, n=n, d=d,
                   engine=engine, updates=NCV_PLAIN_UPDATES,
                   max_abs_err=float((out - ref).abs().max()),
                   loss_abs_err=float((loss - ref_loss).abs().max()),
                   bits_equal=bool(torch.equal(out, ref)),
                   loss_bits_equal=bool(torch.equal(loss, ref_loss)),
                   finite=bool(torch.isfinite(out).all()),
                   plain_s=plain_s[name],
                   plain_ms_per_update=1e3 * plain_s[name] / NCV_PLAIN_UPDATES)
        emit(phase="objectives_kernels", **rec)
        if not (rec["bits_equal"] and rec["loss_bits_equal"] and rec["finite"]):
            raise AssertionError(f"sweep_epoch (clipped) not bit-equal to its "
                                 f"plain version: {rec}")
        if engine == "asysvrg":
            timed = (args, dict(kw, total=full), C, rec)
    args, kw, C, checked = timed
    ms = median_ms(lambda: sweep_epoch(*args, **kw), reps=5, inner=1)
    # the L2 case's bytes and operations, plus ~5 operations per coordinate
    # for each of the two gradients' penalty and ~4 d for the loss's
    bnd, by = bound_ms(4 * (n * d + n + 3 * C * d + C),
                       C * (25 * full * d + 2 * n * d + 4 * d))
    rec = dict(kernel="sweep_epoch", case="clipped_rcv1_asysvrg_4rows_timed",
               rows=C, updates=full, ms=ms, us_per_update=1e3 * ms / full,
               plain_ms_per_update=checked["plain_ms_per_update"],
               plain_ms_from=f"the plain version at {NCV_PLAIN_UPDATES} "
                             "updates, per update",
               bound_ms=bnd, bound_by=by, library_ms=None,
               max_abs_err=checked["max_abs_err"])
    emit(phase="objectives_kernels", **rec)
    return rec


def ncv_specs(n, engine_mode, inner_steps=0):
    """The objectives phase's 5 rows over ``n`` samples: the three readers
    and serial SVRG (one AsySVRG group of M̃ = THREADS x ``inner_steps``,
    by default 2n) and a Hogwild! unlock row (M̃ = n rounded down to a
    multiple of THREADS)."""
    from repro_torch.core.sweep import SweepSpec

    total = THREADS * (inner_steps or (2 * n) // THREADS)
    specs = [SweepSpec(seed=seed, scheme=s, step_size=STEP_SIZE,
                       num_threads=THREADS, inner_steps=inner_steps,
                       engine_mode=engine_mode)
             for seed, s in enumerate(("consistent", "inconsistent",
                                       "unlock"))]
    specs += [SweepSpec(algo="svrg", step_size=STEP_SIZE,
                        num_threads=THREADS, inner_steps=total,
                        engine_mode=engine_mode),
              SweepSpec(algo="hogwild", scheme="unlock", step_size=STEP_SIZE,
                        num_threads=THREADS, tau=-1,
                        engine_mode=engine_mode)]
    return specs


def timed_sweep(obj, epochs, specs):
    """run_sweep with the launch counts set to 0 just before and read just
    after: (result, wall s, counts)."""
    from repro_torch.core.sweep import run_sweep

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = run_sweep(obj, epochs, specs)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, read_counts()


def check_finite_descent(name, hist):
    hist = np.asarray(hist, np.float64)
    if not (np.all(np.isfinite(hist)) and hist[-1] < hist[0]):
        raise AssertionError(f"{name}: history not finite and descending: "
                             f"{hist.tolist()}")


def phase_objectives(ds):
    """The beyond-paper objectives on the card. `NonconvexLogistic` at full
    rcv1 (λ 1e-3, α 10): K2 and K3 with the clipped penalty against their
    plain versions; the 5-row sweep (`ncv_specs`), 2 epochs, batched (K1
    per update, K2 per snapshot) and fused (K2 and K3), fused rows within
    rtol 1e-5, atol 1e-6 of the batched rows; the batched rows at M̃ =
    4096 on the card against the CPU path (the `card_vs_cpu` limits: history
    rtol 1e-4, w atol 1e-5). Then
    `mlp_lm_objective(n=64)` at the frontier benchmark's widths, 3 rows and
    2 epochs on the batched engine (K1 only), card against CPU (rtol 1e-5,
    atol 1e-6: both compute in float64 and round once), `final_params`
    giving the JAX tree's keys and shapes. Returns the record, the
    nonconvex objective for phase `server`, and the kernel records."""
    from repro_torch.core.objectives import NonconvexLogistic, mlp_lm_objective
    from repro_torch.core.sweep import run_sweep

    gen = torch.Generator(device="cuda").manual_seed(22)
    X, y = ds.as_torch("cuda")
    k2 = logreg_grad_clipped_vs_plain(X, y, gen)
    k3 = sweep_epoch_clipped_vs_plain(X, y, gen)

    ncv = NonconvexLogistic(ds.X, ds.y, lam=NCV_LAM, alpha=NCV_ALPHA)
    batched, b_wall, b_counts = timed_sweep(ncv, RCV1_EPOCHS,
                                            ncv_specs(ncv.n, "vmap"))
    fused, f_wall, f_counts = timed_sweep(ncv, RCV1_EPOCHS,
                                          ncv_specs(ncv.n, "fused"))
    total = THREADS * ((2 * ncv.n) // THREADS)
    # the AsySVRG and SVRG rows descend; Hogwild!'s constant step need not
    for res, mode in ((batched, "batched"), (fused, "fused")):
        for c, spec in enumerate(res.specs):
            name = f"nonconvex {mode} row {c} ({spec.algo}/{spec.scheme})"
            if spec.algo == "hogwild":
                if not np.all(np.isfinite(res.histories[c])):
                    raise AssertionError(f"{name}: history not finite")
            else:
                check_finite_descent(name, res.histories[c])
    want_b = {"svrg_update": RCV1_EPOCHS * total, "logreg_grad": RCV1_EPOCHS,
              "sweep_epoch": 0, "flash_attention": 0}
    want_f = {"svrg_update": 0, "logreg_grad": RCV1_EPOCHS,
              "sweep_epoch": 2 * RCV1_EPOCHS, "flash_attention": 0}
    fused_close = bool(
        np.allclose(fused.histories, batched.histories, rtol=1e-5, atol=1e-6)
        and np.allclose(fused.final_w, batched.final_w, rtol=1e-5, atol=1e-6))

    # card against the CPU path: the AsySVRG group, batched, at M̃ = 4096
    # (the Hogwild! row's M̃ is n whatever the inner steps: left out)
    cpu = NonconvexLogistic(ds.X, ds.y, lam=NCV_LAM, alpha=NCV_ALPHA,
                            device="cpu")
    short = ncv_specs(ncv.n, "vmap", inner_steps=NCV_CPU_INNER)[:4]
    t0 = time.perf_counter()
    r_cpu = run_sweep(cpu, 1, short)
    cpu_s = time.perf_counter() - t0
    r_gpu = run_sweep(ncv, 1, short)
    cvc_gap = float(np.max(np.abs(r_gpu.histories - r_cpu.histories)
                           / np.abs(r_cpu.histories)))
    cvc_dw = float(np.abs(r_gpu.final_w - r_cpu.final_w).max())

    # the MLP on the batched engine
    mlp = mlp_lm_objective(MLP_N, **MLP_WIDTHS)
    mlp_cpu = mlp_lm_objective(MLP_N, device="cpu", **MLP_WIDTHS)
    m_specs = mlp_specs(mlp.n, "vmap")
    # the first float64 run on the card loads its kernels (~15 s once);
    # timed apart, the timed run below is warm
    t0 = time.perf_counter()
    run_sweep(mlp, 1, m_specs[:1])
    torch.cuda.synchronize()
    mlp_first_s = time.perf_counter() - t0
    m_res, m_wall, m_counts = timed_sweep(mlp, RCV1_EPOCHS, m_specs)
    t0 = time.perf_counter()
    m_cpu = run_sweep(mlp_cpu, RCV1_EPOCHS, m_specs)
    mlp_cpu_s = time.perf_counter() - t0
    for c in range(len(m_specs)):
        check_finite_descent(f"mlp row {c}", m_res.histories[c])
    V, D, H = (MLP_WIDTHS[k] for k in ("vocab_size", "d_model", "d_hidden"))
    tree_shapes = {"b1": (H,), "embed": (V, D), "norm": (D,), "w1": (D, H),
                   "w2": (H, V)}
    params = m_res.final_params(0)
    mlp_tree_ok = {k: tuple(v.shape) for k, v in params.items()} == tree_shapes
    mlp_close = bool(
        np.allclose(m_res.histories, m_cpu.histories, rtol=1e-5, atol=1e-6)
        and np.allclose(m_res.final_w, m_cpu.final_w, rtol=1e-5, atol=1e-6))
    mlp_total = 4 * mlp.n
    want_m = {"svrg_update": RCV1_EPOCHS * mlp_total, "logreg_grad": 0,
              "sweep_epoch": 0, "flash_attention": 0}

    rec = dict(
        phase="objectives", n=ncv.n, p=ncv.p, lam=NCV_LAM, alpha=NCV_ALPHA,
        rows=len(batched.specs), epochs=RCV1_EPOCHS, inner_updates=total,
        batched_wall_s=b_wall, batched_wall_s_per_epoch=b_wall / RCV1_EPOCHS,
        batched_launches=b_counts, fused_wall_s=f_wall,
        fused_wall_s_per_epoch=f_wall / RCV1_EPOCHS, fused_launches=f_counts,
        fused_vs_batched=dict(
            rtol=1e-5, atol=1e-6, within=fused_close,
            max_abs_dhist=float(np.abs(fused.histories
                                       - batched.histories).max()),
            max_abs_dw=float(np.abs(fused.final_w - batched.final_w).max())),
        histories_fused=fused.histories.tolist(),
        card_vs_cpu=dict(inner_updates=THREADS * NCV_CPU_INNER, epochs=1,
                         history_rel_gap=cvc_gap, max_abs_dw=cvc_dw,
                         rtol_loss=1e-4, atol_w=1e-5, cpu_s=cpu_s),
        mlp=dict(n=mlp.n, flat_dim=mlp.flat_dim, rows=len(m_specs),
                 inner_updates=mlp_total, first_run_s=mlp_first_s,
                 wall_s=m_wall,
                 wall_s_per_epoch=m_wall / RCV1_EPOCHS, launches=m_counts,
                 histories=m_res.histories.tolist(), cpu_s=mlp_cpu_s,
                 card_vs_cpu_max_abs_dhist=float(np.abs(
                     m_res.histories - m_cpu.histories).max()),
                 card_vs_cpu_max_abs_dw=float(np.abs(
                     m_res.final_w - m_cpu.final_w).max()),
                 card_vs_cpu_within=mlp_close, final_params_tree=mlp_tree_ok))
    emit(**rec)
    if b_counts != want_b or f_counts != want_f:
        raise AssertionError(f"objectives: nonconvex launch counts batched "
                             f"{b_counts} != {want_b} or fused {f_counts} != "
                             f"{want_f}")
    if not fused_close:
        raise AssertionError(f"objectives: fused rows outside rtol 1e-5, atol "
                             f"1e-6 of the batched rows: "
                             f"{rec['fused_vs_batched']}")
    if not (cvc_gap <= 1e-4 and cvc_dw <= 1e-5):
        raise AssertionError(f"objectives: card and CPU disagree: "
                             f"{rec['card_vs_cpu']}")
    if m_counts != want_m or not mlp_close or not mlp_tree_ok:
        raise AssertionError(f"objectives: the MLP: {rec['mlp']}")
    return rec, ncv, k2, k3


# phase `objectives_mlp_fused`: the MLP's own sweep kernel (sweep_epoch_mlp)
FP64_FLOP_PER_S = 67e12        # H100 SXM float64 on the tensor cores (DMMA)
MLP_DEFAULTS = dict(vocab_size=32, seq_len=8, d_model=16, d_hidden=32)
MLP_WIDE = dict(vocab_size=256, seq_len=8, d_model=64, d_hidden=256)
MLP_ACTIVATIONS = ("relu", "gelu", "silu")
MLP_DROP = 0.1                 # the unlock row's drop probability
MLP_PLAIN_UPDATES = (256, 32, 64)  # the epoch checks' M̃: defaults, wide, S 20
MLP_S20 = dict(MLP_DEFAULTS, seq_len=20)   # positions cycle over 8 warps


def mlp_flops(S, V, D, H, grad=True):
    """float64 operations of one sample's pass: the forward (the products,
    the norm, the activation, the log-sum-exp; the embedding is a gather)
    and with ``grad`` the backward: the input gradients, then the weights'
    (2 S per coordinate of w1 and w2, 2 S per norm coordinate, S per b1
    coordinate, and S D for the scatter of the embedding's S rows)."""
    fwd = 2 * S * (D * H + H * V) + 6 * S * D + 10 * S * H + 4 * S * V
    bwd = 2 * S * (V * H + H * D) + 10 * S * D + 2 * S * H + 3 * S * V
    wgrad = 2 * S * (D * H + H * V) + 3 * S * D + S * H
    return fwd + (bwd + wgrad if grad else 0)


def mlp_epoch_bound(S, V, D, H, d, n, C, total, svrg):
    """(bound ms, what bounds it) of one epoch launch for C rows: each input
    read once (tokens, targets, w, mu) and each output written once, against
    the float64 work (one or two gradients per update, the loss's n
    forwards) plus ~6 float32 operations per coordinate of each update,
    counted at the float64 rate by the ratio of the two peaks."""
    nbytes = 4 * (2 * n * S + (2 if svrg else 1) * C * d + C * d + 2 * C)
    f64 = C * (total * (2 if svrg else 1) * mlp_flops(S, V, D, H)
               + n * mlp_flops(S, V, D, H, grad=False))
    f32 = C * total * 6 * d
    return bound_ms(nbytes, f64 + f32 * FP64_FLOP_PER_S / FP32_FLOP_PER_S,
                    FP64_FLOP_PER_S)


def mlp_gaps(got, want):
    """Largest absolute gap, share of equal bits, and allclose at rtol 1e-5,
    atol 1e-6."""
    return (float((got - want).abs().max()),
            float((got == want).float().mean()),
            bool(torch.allclose(got, want, rtol=1e-5, atol=1e-6)))


def mlp_sample_grad_vs_objective(gen):
    """The kernel's backward (`sample_grad`) against `MLPObjective.
    flat_sample_grad` on the card at the objective's default widths, for
    each activation: 2 rows near the init, 4 samples each, rtol 1e-6, atol
    1e-7 (both float64 inside, rounded once)."""
    from repro_torch.core.objectives import mlp_lm_objective
    from repro_torch.kernels.sweep_epoch_mlp import sample_grad

    out = {}
    for act in MLP_ACTIVATIONS:
        obj = mlp_lm_objective(64, activation=act, **MLP_DEFAULTS)
        data = obj.data_args()
        w0 = obj.init_flat()
        W = w0 + 0.3 * torch.randn((2, obj.flat_dim), generator=gen,
                                   device="cuda")
        gaps, equal, close = [], [], True
        for c in range(2):
            for i in (0, 17, 40, 63):
                g = sample_grad(*data, i, W[c].contiguous(), obj.kernel_widths)
                want = obj.flat_sample_grad(data, torch.tensor(i), W[c])
                gaps.append(float((g - want).abs().max()))
                equal.append(float((g == want).float().mean()))
                close &= bool(torch.allclose(g, want, rtol=1e-6, atol=1e-7))
        out[act] = dict(max_abs_err=max(gaps), equal_bits=float(np.mean(equal)),
                        within=close, flat_dim=obj.flat_dim)
    emit(phase="objectives_mlp_fused_sample_grad", rtol=1e-6, atol=1e-7, **out)
    bad = {a: r for a, r in out.items() if not r["within"]}
    if bad:
        raise AssertionError(f"sweep_epoch_mlp sample_grad disagrees with "
                             f"flat_sample_grad: {bad}")
    return out


def mlp_epoch_vs_plain(gen):
    """One epoch launch against its plain version on the card from the same
    inputs: 3 AsySVRG rows (consistent, inconsistent, unlock with drop_prob
    `MLP_DROP`, τ 2) and one Hogwild! unlock row; at the default widths at
    both placements, at V 256, D 64, H 256 (d 98624), where the vectors go
    to the device buffer, and at S 20. Iterates and losses within rtol
    1e-5, atol 1e-6; the largest gap and the share of equal bits recorded;
    each launch timed (median of 3) beside its float64 bound."""
    from repro_torch import prng
    from repro_torch.core.objectives import mlp_lm_objective
    from repro_torch.kernels.sweep_epoch_mlp import ops as mlp_ops
    from repro_torch.kernels.sweep_epoch_mlp.ops import sweep_epoch_mlp
    from repro_torch.kernels.sweep_epoch_mlp.ref import sweep_epoch_mlp_ref

    cases = []
    for widths, total, placements in (
            (MLP_DEFAULTS, MLP_PLAIN_UPDATES[0], (mlp_ops.SHARED,
                                                  mlp_ops.GLOBAL)),
            (MLP_WIDE, MLP_PLAIN_UPDATES[1], (None,)),
            (MLP_S20, MLP_PLAIN_UPDATES[2], (None,))):
        obj = mlp_lm_objective(64, **widths)
        data = obj.data_args()
        for engine, tau, scheme, delay in (
                ("asysvrg", [2, 2, 2], [0, 1, 2], [1, 1, 2]),
                ("hogwild", [2], [2], [2])):
            C = len(tau)
            w = (obj.init_flat() + 0.05 * torch.randn(
                (C, obj.flat_dim), generator=gen, device="cuda")).contiguous()
            mu = 1e-3 * torch.randn((C, obj.flat_dim), generator=gen,
                                    device="cuda")
            keys = prng.keys_from_seeds(range(700, 700 + C), "cuda")
            step = torch.full((C,), 0.1, device="cuda")
            args = (*data, w, mu if engine == "asysvrg" else None, keys, step,
                    tau, scheme, delay)
            kw = dict(widths=obj.kernel_widths, engine=engine, total=total,
                      buf_len=3, option=2, drop_prob=MLP_DROP)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref, ref_loss = sweep_epoch_mlp_ref(*args, **kw)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            S, V, D, H = (obj.seq_len, obj.vocab_size, obj.d_model,
                          obj.d_hidden)
            bnd, _ = mlp_epoch_bound(S, V, D, H, obj.flat_dim, obj.n, C,
                                     total, engine == "asysvrg")
            for placement in placements:
                before = dict(sweep_epoch_mlp.placements)
                out, loss = sweep_epoch_mlp(*args, placement=placement, **kw)
                torch.cuda.synchronize()
                where = [k for k, v in sweep_epoch_mlp.placements.items()
                         if v != before[k]]
                gap, eq, close = mlp_gaps(out, ref)
                lgap, leq, lclose = mlp_gaps(loss, ref_loss)
                ms = median_ms(lambda: sweep_epoch_mlp(
                    *args, placement=placement, **kw), reps=3, inner=2)
                rec = dict(case=f"{engine}_S{S}_d{obj.flat_dim}_{where[0]}",
                           rows=C, S=S, d=obj.flat_dim, updates=total,
                           placement=where[0], max_abs_err=gap,
                           equal_bits=eq, loss_abs_err=lgap,
                           loss_equal_bits=leq, within=close and lclose,
                           finite=bool(torch.isfinite(out).all()),
                           plain_s=plain_s, ms=ms,
                           us_per_update=1e3 * ms / total, bound_ms=bnd)
                emit(phase="objectives_mlp_fused_epoch", **rec)
                cases.append(rec)
    bad = [r for r in cases if not (r["within"] and r["finite"])]
    wide = [r for r in cases if r["d"] == 98624]
    if (bad or not wide
            or any(r["placement"] != mlp_ops.GLOBAL for r in wide)):
        raise AssertionError(f"sweep_epoch_mlp disagrees with its plain "
                             f"version or took the wrong placement: "
                             f"{bad or wide}")
    return cases


def mlp_wide_entries_vs_plain(gen):
    """At V 256, D 64, H 256 (d 98624) the full-gradient, loss and
    sample-gradient blocks read the row where it lies, unstaged
    (`ops.full_layout`): μ and the loss of 3 rows over n 64 against
    `full_grad_ref` at rtol 1e-5, atol 1e-6, and 2 samples' gradients
    against `sample_grad_ref` at rtol 1e-6, atol 1e-7."""
    from repro_torch.core.objectives import mlp_lm_objective
    from repro_torch.kernels.sweep_epoch_mlp import ops as mlp_ops
    from repro_torch.kernels.sweep_epoch_mlp.ops import (mlp_full_grad,
                                                         mlp_loss,
                                                         sample_grad)
    from repro_torch.kernels.sweep_epoch_mlp.ref import (full_grad_ref,
                                                         sample_grad_ref)

    obj = mlp_lm_objective(64, **MLP_WIDE)
    data = obj.data_args()
    staged = mlp_ops.full_layout(obj.seq_len,
                                 mlp_ops.MLPWidths(*obj.kernel_widths), obj.n,
                                 mlp_ops._limit(torch.device("cuda")))[1]
    W = (obj.init_flat() + 0.05 * torch.randn(
        (3, obj.flat_dim), generator=gen, device="cuda")).contiguous()
    mu, f = mlp_full_grad(*data, W, obj.kernel_widths)
    mu_ref, f_ref = full_grad_ref(*data, W, obj.kernel_widths)
    mu_gap, mu_eq, mu_close = mlp_gaps(mu, mu_ref)
    f_gap, f_eq, f_close = mlp_gaps(mlp_loss(*data, W, obj.kernel_widths),
                                    f_ref)
    g_gaps, g_equal, g_close = [], [], True
    for i in (0, 40):
        g = sample_grad(*data, i, W[0], obj.kernel_widths)
        want = sample_grad_ref(*data, torch.tensor([i], device="cuda"),
                               W[:1], obj.kernel_widths)[0]
        g_gaps.append(float((g - want).abs().max()))
        g_equal.append(float((g == want).float().mean()))
        g_close &= bool(torch.allclose(g, want, rtol=1e-6, atol=1e-7))
    rec = dict(d=obj.flat_dim, staged=staged, max_abs_err=mu_gap,
               equal_bits=mu_eq, loss_abs_err=f_gap, loss_equal_bits=f_eq,
               within=mu_close and f_close,
               sample_grad_max_abs_err=max(g_gaps),
               sample_grad_equal_bits=float(np.mean(g_equal)),
               sample_grad_within=g_close)
    emit(phase="objectives_mlp_fused_wide_entries", **rec)
    if staged or not (rec["within"] and g_close):
        raise AssertionError(f"sweep_epoch_mlp's unstaged entries disagree "
                             f"with their plain versions or were staged: "
                             f"{rec}")
    return rec


def mlp_specs(n, engine_mode):
    """The MLP phases' 3 rows: inconsistent reads, τ 2, 4 threads, M̃ 4n,
    one step size each."""
    from repro_torch.core.sweep import SweepSpec

    return [SweepSpec(scheme="inconsistent", step_size=st, tau=2,
                      num_threads=4, inner_steps=n, seed=i,
                      engine_mode=engine_mode)
            for i, st in enumerate(MLP_STEPS)]


def reset_mlp_counts():
    """`sweep_epoch_mlp`'s counts to 0 (part of `reset_counts`; read apart,
    by `read_mlp_counts`)."""
    from repro_torch.kernels.sweep_epoch_mlp.ops import sweep_epoch_mlp
    sweep_epoch_mlp.launches = 0
    sweep_epoch_mlp.launches_by_entry = dict.fromkeys(
        sweep_epoch_mlp.launches_by_entry, 0)
    sweep_epoch_mlp.placements = dict.fromkeys(sweep_epoch_mlp.placements, 0)


def read_mlp_counts():
    from repro_torch.kernels.sweep_epoch_mlp.ops import sweep_epoch_mlp
    return dict(sweep_epoch_mlp.launches_by_entry,
                sweep_epoch_mlp=sweep_epoch_mlp.launches)


def mlp_fused_vs_batched(name, widths):
    """`run_sweep` of the MLP (`mlp_specs`, 2 epochs) batched and fused at
    ``widths``: fused rows within rtol 1e-5, atol 1e-6 of the batched rows;
    the fused run launches `sweep_epoch_mlp` groups x epochs times for the
    epochs, once per epoch for μ and once for the starting loss, and no
    K1, K2 or K3; s per epoch of each; then the fused group's epoch launch
    alone, timed beside its plain version and its bound, and held against
    the plain version's iterates and losses at rtol 1e-5, atol 1e-6."""
    from repro_torch import prng
    from repro_torch.core.objectives import mlp_lm_objective
    from repro_torch.kernels.sweep_epoch_mlp import ops as mlp_ops
    from repro_torch.kernels.sweep_epoch_mlp.ops import (mlp_full_grad,
                                                         mlp_loss,
                                                         sweep_epoch_mlp)
    from repro_torch.kernels.sweep_epoch_mlp.ref import (full_grad_ref,
                                                         sweep_epoch_mlp_ref)

    obj = mlp_lm_objective(MLP_N, **widths)
    batched, b_wall, b_counts = timed_sweep(obj, RCV1_EPOCHS,
                                            mlp_specs(obj.n, "vmap"))
    fused, f_wall, f_counts = timed_sweep(obj, RCV1_EPOCHS,
                                          mlp_specs(obj.n, "fused"))
    m_counts = read_mlp_counts()
    groups = 1
    want_m = {"epoch": groups * RCV1_EPOCHS, "full_grad": RCV1_EPOCHS,
              "loss": groups}
    want_m["sweep_epoch_mlp"] = sum(want_m.values())
    want_f = {"svrg_update": 0, "logreg_grad": 0, "sweep_epoch": 0,
              "flash_attention": 0}
    for c in range(len(fused.specs)):
        check_finite_descent(f"mlp fused {name} row {c}", fused.histories[c])
    gap_h = float(np.abs(fused.histories - batched.histories).max())
    gap_w = float(np.abs(fused.final_w - batched.final_w).max())
    close = bool(np.allclose(fused.histories, batched.histories, rtol=1e-5,
                             atol=1e-6)
                 and np.allclose(fused.final_w, batched.final_w, rtol=1e-5,
                                 atol=1e-6))

    # the group's epoch launch alone, at the run's shape
    data = obj.data_args()
    C, total = len(MLP_STEPS), 4 * obj.n
    w = torch.as_tensor(batched.final_w, device="cuda").contiguous()
    mu = mlp_full_grad(*data, w, obj.kernel_widths)[0]
    args = (*data, w, mu, prng.keys_from_seeds(range(C), "cuda"),
            torch.tensor(MLP_STEPS, dtype=torch.float32, device="cuda"),
            [2] * C, [1] * C, [1] * C)
    kw = dict(widths=obj.kernel_widths, engine="asysvrg", total=total,
              buf_len=3, option=2, drop_prob=0.02)
    # one launch a window, the wrapper's host time before the launch
    # included (the kernels line's `ms`); then 3 back to back a window,
    # where that host time overlaps the previous launch; then one a window
    # with the rows' settings copied from the host at each call
    ms = median_ms(lambda: sweep_epoch_mlp(*args, **kw), reps=5, inner=1)
    back_to_back_ms = median_ms(lambda: sweep_epoch_mlp(*args, **kw),
                                reps=5, inner=3)

    def uncached():
        mlp_ops._row_ints.cache_clear()
        return sweep_epoch_mlp(*args, **kw)
    uncached_ms = median_ms(uncached, reps=5, inner=1)
    # the same launch with other readers: consistent rows draw no
    # per-coordinate words, unlock rows with drops two hashes a coordinate
    by_reader = {"inconsistent": ms}
    for reader, scheme, drop in (("consistent", 0, 0.0),
                                 ("unlock_drop", 2, MLP_DROP)):
        r_args = args[:-2] + ([scheme] * C, [1] * C)
        by_reader[reader] = median_ms(lambda: sweep_epoch_mlp(
            *r_args, **dict(kw, drop_prob=drop)), reps=5, inner=1)
    full_ms = median_ms(lambda: mlp_full_grad(*data, w, obj.kernel_widths),
                        reps=5, inner=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref, ref_loss = sweep_epoch_mlp_ref(*args, **kw)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    out, loss = sweep_epoch_mlp(*args, **kw)
    e_gap, e_eq, e_close = mlp_gaps(out, ref)
    l_gap, l_eq, l_close = mlp_gaps(loss, ref_loss)
    vs_plain = dict(rtol=1e-5, atol=1e-6, within=e_close and l_close,
                    max_abs_err=e_gap, equal_bits=e_eq, loss_abs_err=l_gap,
                    loss_equal_bits=l_eq)
    # the full gradient's entry against its plain version at w
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mu_ref, f_ref = full_grad_ref(*data, w, obj.kernel_widths)
    torch.cuda.synchronize()
    full_plain_ms = 1e3 * (time.perf_counter() - t0)
    mu_gap, mu_eq, mu_close = mlp_gaps(mu, mu_ref)
    f_gap, f_eq, f_close = mlp_gaps(
        mlp_loss(*data, w, obj.kernel_widths), f_ref)
    full_vs_plain = dict(rtol=1e-5, atol=1e-6, within=mu_close and f_close,
                         max_abs_err=mu_gap, equal_bits=mu_eq,
                         loss_abs_err=f_gap, loss_equal_bits=f_eq)
    S, V, D, H = (obj.seq_len, obj.vocab_size, obj.d_model, obj.d_hidden)
    bnd, by = mlp_epoch_bound(S, V, D, H, obj.flat_dim, obj.n, C, total, True)
    rec = dict(phase="objectives_mlp_fused", widths=name, n=obj.n,
               flat_dim=obj.flat_dim, rows=C, epochs=RCV1_EPOCHS,
               inner_updates=total,
               batched_s_per_epoch=b_wall / RCV1_EPOCHS,
               fused_s_per_epoch=f_wall / RCV1_EPOCHS,
               batched_launches=b_counts, fused_launches=f_counts,
               fused_mlp_launches=m_counts, want_mlp_launches=want_m,
               fused_vs_batched=dict(rtol=1e-5, atol=1e-6, within=close,
                                     max_abs_dhist=gap_h, max_abs_dw=gap_w),
               epoch_ms=ms, epoch_us_per_update=1e3 * ms / total,
               epoch_back_to_back_ms=back_to_back_ms,
               epoch_uncached_ms=uncached_ms, epoch_ms_by_reader=by_reader,
               full_grad_ms=full_ms, epoch_plain_ms=plain_ms,
               epoch_bound_ms=bnd, epoch_bound_by=by, library_ms=None,
               epoch_vs_plain=vs_plain, full_grad_plain_ms=full_plain_ms,
               full_grad_vs_plain=full_vs_plain)
    emit(**rec)
    if m_counts != want_m or f_counts != want_f:
        raise AssertionError(f"objectives_mlp_fused ({name}): launches "
                             f"{m_counts} != {want_m} or {f_counts} != "
                             f"{want_f}")
    if not close:
        raise AssertionError(f"objectives_mlp_fused ({name}): fused rows "
                             f"outside rtol 1e-5, atol 1e-6 of the batched "
                             f"rows: {rec['fused_vs_batched']}")
    if not vs_plain["within"]:
        raise AssertionError(f"objectives_mlp_fused ({name}): the epoch "
                             f"launch disagrees with its plain version: "
                             f"{vs_plain}")
    if not full_vs_plain["within"]:
        raise AssertionError(f"objectives_mlp_fused ({name}): the full "
                             f"gradient disagrees with its plain version: "
                             f"{full_vs_plain}")
    return rec


def phase_objectives_mlp_fused():
    """The MLP objective's own kernel (`sweep_epoch_mlp`) on the card: its
    backward against the objective's for each activation, one epoch launch
    against its plain version at three widths (the defaults at both
    placements) and at S 20, the unstaged full-gradient, loss and
    sample-gradient blocks at d 98624 against theirs, and
    `run_sweep(engine_mode="fused")` against the batched engine at the
    frontier widths and the objective's defaults. Returns the kernel's
    record for the kernels line."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(25)
    grads = mlp_sample_grad_vs_objective(gen)
    epochs = mlp_epoch_vs_plain(gen)
    wide_entries = mlp_wide_entries_vs_plain(gen)
    frontier = mlp_fused_vs_batched("frontier", MLP_WIDTHS)
    defaults = mlp_fused_vs_batched("defaults", MLP_DEFAULTS)
    checked = (epochs + [wide_entries, frontier["epoch_vs_plain"],
                         defaults["epoch_vs_plain"]])
    wide = [r for r in epochs if r["d"] == 98624 and r["rows"] == 3][0]
    rec = dict(
        max_abs_err=max(max(r["max_abs_err"], r["loss_abs_err"])
                        for r in checked),
        equal_bits=float(np.mean([r["equal_bits"] for r in checked])),
        ms=frontier["epoch_ms"], plain_ms=frontier["epoch_plain_ms"],
        back_to_back_ms=frontier["epoch_back_to_back_ms"],
        defaults_back_to_back_ms=defaults["epoch_back_to_back_ms"],
        uncached_ms=frontier["epoch_uncached_ms"],
        defaults_uncached_ms=defaults["epoch_uncached_ms"],
        bound_ms=frontier["epoch_bound_ms"],
        bound_by=frontier["epoch_bound_by"], library_ms=None,
        launches=frontier["fused_mlp_launches"]["sweep_epoch_mlp"],
        defaults_ms=defaults["epoch_ms"],
        defaults_plain_ms=defaults["epoch_plain_ms"],
        defaults_bound_ms=defaults["epoch_bound_ms"],
        defaults_launches=defaults["fused_mlp_launches"]["sweep_epoch_mlp"],
        full_grad_ms=frontier["full_grad_ms"],
        defaults_full_grad_ms=defaults["full_grad_ms"],
        full_grad_plain_ms=frontier["full_grad_plain_ms"],
        defaults_full_grad_plain_ms=defaults["full_grad_plain_ms"],
        epoch_ms_by_reader=frontier["epoch_ms_by_reader"],
        defaults_epoch_ms_by_reader=defaults["epoch_ms_by_reader"],
        wide_ms=wide["ms"], wide_updates=wide["updates"],
        wide_bound_ms=wide["bound_ms"], wide_plain_ms=1e3 * wide["plain_s"],
        fused_s_per_epoch=frontier["fused_s_per_epoch"],
        batched_s_per_epoch=frontier["batched_s_per_epoch"],
        defaults_fused_s_per_epoch=defaults["fused_s_per_epoch"],
        defaults_batched_s_per_epoch=defaults["batched_s_per_epoch"],
        sample_grad_max_abs_err=max(
            [r["max_abs_err"] for r in grads.values()]
            + [wide_entries["sample_grad_max_abs_err"]]),
        sample_grad_equal_bits={a: r["equal_bits"] for a, r in grads.items()},
        seconds=time.perf_counter() - t0)
    emit(phase="objectives_mlp_fused_done_record", **rec)
    return rec


SERVER_DELAY_MS = 200.0   # the deadline of the server phase's first flush


def server_specs():
    """(tenant, specs) of the server phase's size-triggered flush: 2 fused
    L2 rows on full rcv1 (tenant-a); 1 fused + 1 batched row of the
    registered `NonconvexLogistic` (tenant-b; the batched row's M̃ 4096)
    and 1 fused L2 row (tenant-b), which shares tenant-a's group."""
    from repro_torch.core.sweep import SweepSpec

    logreg = [SweepSpec(seed=seed, scheme=s, step_size=STEP_SIZE,
                        num_threads=THREADS, engine_mode="fused")
              for seed, s in ((11, "consistent"), (12, "unlock"))]
    ncv = [SweepSpec(seed=13, scheme="inconsistent", step_size=STEP_SIZE,
                     num_threads=THREADS, engine_mode="fused",
                     objective="rcv1-nonconvex"),
           SweepSpec(seed=14, scheme="unlock", step_size=STEP_SIZE,
                     num_threads=THREADS, inner_steps=NCV_CPU_INNER,
                     engine_mode="vmap", objective="rcv1-nonconvex")]
    extra = [SweepSpec(seed=18, scheme="inconsistent", step_size=STEP_SIZE,
                       num_threads=THREADS, engine_mode="fused")]
    return (("tenant-a", logreg), ("tenant-b", ncv), ("tenant-b", extra))


def phase_server(obj, ncv):
    """A `SweepServer` on 127.0.0.1 over a card-backed `SweepService`
    (rcv1, 2 epochs), driven through the port's `SweepClient`: a lone fused
    request flushed by the deadline, then two tenants' three requests
    (`server_specs`: L2 logistic and the registered `NonconvexLogistic`)
    reaching ``max_rows`` and flushed by size, the three fused L2 rows
    coalesced into one group; each result against a
    standalone `run_sweep` (fused rows equal bits, the batched row rtol
    1e-5, atol 1e-6); a 3-group fused job through POST /job, one group a
    turn, each turn resuming from the job's checkpoint, against the job in
    one call (equal bits); /stats and /metrics answering. Flush and request
    latency from the server's own stats."""
    from repro_torch.core.objective import (register_objective,
                                            unregister_objective)
    from repro_torch.core.sweep import SweepSpec, run_sweep
    from repro_torch.server import FairShare, FlushPolicy, SweepClient, SweepServer
    from repro_torch.service import SweepService

    register_objective("rcv1-nonconvex", ncv)
    lone = [SweepSpec(seed=10, scheme="inconsistent", step_size=STEP_SIZE,
                      num_threads=THREADS, engine_mode="fused")]
    requests = server_specs()
    job = [SweepSpec(seed=15, scheme="consistent", step_size=STEP_SIZE,
                     num_threads=THREADS, engine_mode="fused"),
           SweepSpec(algo="hogwild", scheme="inconsistent", seed=16,
                     step_size=STEP_SIZE, num_threads=THREADS, tau=-1,
                     engine_mode="fused"),
           SweepSpec(algo="svrg", seed=17, step_size=STEP_SIZE,
                     num_threads=THREADS, inner_steps=4096,
                     engine_mode="fused")]
    timeout = 300.0
    svc = SweepService(obj, epochs=RCV1_EPOCHS)
    rows = sum(len(s) for _, s in requests)
    server = SweepServer(svc, policy=FlushPolicy(
        max_rows=rows, max_delay_ms=SERVER_DELAY_MS, job_groups_per_slice=1,
        heartbeat_stall_s=120.0), fairness=FairShare(quantum_rows=8))
    try:
        torch.cuda.synchronize()
        reset_counts()
        t_phase = time.perf_counter()
        server.start()
        client = SweepClient(server.url, timeout=timeout, poll_s=5.0)
        t0 = time.perf_counter()
        rid = client.submit(lone, tenant="tenant-a")
        got_lone = client.result(rid, timeout=timeout)
        lone_s = time.perf_counter() - t0
        after_deadline = server.daemon.stats_snapshot()
        server.daemon.policy = dataclasses.replace(server.daemon.policy,
                                                   max_delay_ms=3_600_000.0)
        t0 = time.perf_counter()
        rids = [client.submit(specs, tenant=tenant)
                for tenant, specs in requests]
        got = [client.result(r, timeout=timeout) for r in rids]
        size_s = time.perf_counter() - t0
        daemon_stats = server.daemon.stats_snapshot()
        handle = client.submit_job(job, RCV1_EPOCHS, tenant="tenant-c")
        got_job = client.job_result(handle["job_id"], timeout=timeout)
        job_stats = server.daemon.stats_snapshot()
        stats = client.stats()
        metrics = client.metrics()
        health = client.healthz()
        wall = time.perf_counter() - t_phase
        counts = read_counts()
        alone_lone = run_sweep(obj, RCV1_EPOCHS, lone)
        alone = [run_sweep(None if specs[0].objective else obj, RCV1_EPOCHS,
                           specs) for _, specs in requests]
        alone_job = run_sweep(obj, RCV1_EPOCHS, job)
    finally:
        server.stop()
        unregister_objective("rcv1-nonconvex")

    def bits(a, b):
        return bool(np.array_equal(a.histories, b.histories)
                    and np.array_equal(a.final_w, b.final_w))

    fused_equal = [bits(got_lone, alone_lone), bits(got[0], alone[0]),
                   bits(got[2], alone[2])]
    ncv_fused_equal = bool(
        np.array_equal(got[1].histories[0], alone[1].histories[0])
        and np.array_equal(got[1].final_w[0], alone[1].final_w[0]))
    ncv_batched_close = bool(
        np.allclose(got[1].histories[1], alone[1].histories[1], rtol=1e-5,
                    atol=1e-6)
        and np.allclose(got[1].final_w[1], alone[1].final_w[1], rtol=1e-5,
                        atol=1e-6))
    job_equal = bits(got_job, alone_job)
    rec = dict(
        phase="server", url_host="127.0.0.1", epochs=RCV1_EPOCHS,
        requests=[dict(tenant=t, rows=len(s),
                       engine_modes=[x.engine_mode for x in s],
                       objective=s[0].objective or "rcv1")
                  for t, s in requests],
        wall_s=wall, lone_request_s=lone_s, size_flush_requests_s=size_s,
        deadline_flushes=after_deadline.deadline_flushes,
        size_flushes=daemon_stats.size_flushes - after_deadline.size_flushes,
        job_slices=job_stats.job_slices, jobs_completed=job_stats.jobs_completed,
        launches=counts, fused_bits_equal_alone=fused_equal,
        nonconvex_fused_bits_equal_alone=ncv_fused_equal,
        nonconvex_batched_within_tol_alone=ncv_batched_close,
        job_equals_one_call=job_equal,
        flush_latency=stats["flush_latency"],
        request_latency=stats["request_latency"],
        rows_coalesced=stats["service"]["rows_coalesced"],
        stats_policy=stats["daemon"]["policy"],
        metrics_lines=len(metrics.splitlines()), health=health["status"])
    emit(**rec)
    if rec["deadline_flushes"] < 1 or rec["size_flushes"] < 1:
        raise AssertionError(f"server: a flush trigger did not fire: {rec}")
    if not (all(fused_equal) and ncv_fused_equal and ncv_batched_close
            and rec["rows_coalesced"] >= 3):
        raise AssertionError(f"server: served results differ from "
                             f"standalone run_sweep: {rec}")
    if not (job_equal and rec["job_slices"] == 3 and rec["jobs_completed"]):
        raise AssertionError(f"server: the time-sliced job: {rec}")
    if not (counts["logreg_grad"] and counts["sweep_epoch"]
            and counts["svrg_update"]) or counts["flash_attention"]:
        raise AssertionError(f"server: launches {counts}")
    if health["status"] != "ok" or rec["metrics_lines"] < 10:
        raise AssertionError(f"server: /healthz or /metrics: {rec}")
    return rec


# phase `sharding`: config-row sharding over torch.distributed and the
# bounded-staleness epoch. Its ranks are spawned processes; on the one card
# of this machine the 2-rank world is `gloo` (NCCL refuses two ranks on
# one device) and NCCL runs in a world of one.
BSE_H, BSE_BATCH, BSE_STEP = 4, 64, 1.0
BSE_METHODS = ("none", "topk", "randk", "int8")
BSE_INT8_FLIPS = 4      # int8 coordinates a card/CPU rounding may flip


def bse_run(mesh, ds, device, method, workers):
    """`bounded_staleness_epoch` at rcv1 width on ``device``: RCV1_EPOCHS
    epochs of H = BSE_H local steps on BSE_BATCH-row minibatches drawn
    from rcv1 by a numpy seed, the residuals carried, the key of epoch e
    ``PRNGKey(e)``; the snapshot from the port's snapshot pass over epoch
    0's minibatches. Returns ([(params, residual)] per epoch as numpy,
    (the loss, the snapshot state, the minibatches))."""
    from repro_torch import prng
    from repro_torch.config import SVRGConfig
    from repro_torch.core import distributed as D

    def loss(params, batch):
        X, y = batch
        margins = y * (X @ params["w"])
        return (torch.mean(torch.nn.functional.softplus(-margins))
                + 0.5 * ds.l2_reg * torch.sum(params["w"] * params["w"]))

    rng = np.random.default_rng(0)
    batches = []
    for _ in range(RCV1_EPOCHS):
        idx = rng.integers(0, ds.n, size=(workers, BSE_H, BSE_BATCH))
        batches.append((torch.from_numpy(ds.X[idx]).to(device),
                        torch.from_numpy(ds.y[idx]).to(device)))
    params = {"w": torch.zeros(ds.p, device=device)}
    X0, y0 = batches[0]
    svrg = D.snapshot_accumulate(loss, params,
                                 D.snapshot_begin(D.init_svrg_state(params)),
                                 (X0.reshape(-1, ds.p), y0.reshape(-1)))
    svrg = D.snapshot_finalize(params, svrg, 0)
    cfg = SVRGConfig(local_steps=BSE_H, compression=method)
    ef, out = None, []
    for e, batch in enumerate(batches):
        params, ef = D.bounded_staleness_epoch(
            mesh, loss, params, svrg, batch, BSE_STEP, cfg,
            rng=prng.PRNGKey(e, device), ef=ef)
        out.append((params["w"].cpu().numpy(),
                    ef.residual["w"].cpu().numpy()))
    return out, (loss, svrg, batches)


def sharded_sweep(mesh, obj, mode):
    """The 5-row grid of `sweep_specs` through `run_sweep(mesh=mesh)`,
    twice: the first run in this process (its runners constructed, first
    calls paid) and a warm one. Per run, its launch counts read in this
    rank and its wall between a barrier and a synchronise."""
    import torch.distributed as dist

    from repro_torch.core.sweep import run_sweep

    specs, total = sweep_specs(obj, mode)
    runs = []
    for _ in ("cold", "warm"):
        dist.barrier()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = run_sweep(obj, RCV1_EPOCHS, specs, mesh=mesh)
        torch.cuda.synchronize()
        runs.append(dict(histories=res.histories, final_w=res.final_w,
                         total=total, wall_s=time.perf_counter() - t0,
                         launches=read_counts()))
    return runs


def sharding_gloo_rank(rank, world):
    """A rank of phase `sharding` (a): the fused grid at full rcv1 and the
    batched grid at a tenth of its rows through `run_sweep` over a 2-rank
    `data` mesh; a `SweepService(mesh=...)` flush of two requests, the
    same requests through standalone sharded `run_sweep`, and a warm
    flush, the first from a cleared runner cache (the sweeps above built
    the same group keys); `bounded_staleness_epoch` for each compression
    method on the card and on the CPU."""
    import torch.distributed as dist

    from repro_torch import LogisticRegression
    from repro_torch.core.sweep import SweepSpec, run_sweep
    from repro_torch.data.libsvm import make_synthetic_libsvm
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_sweep_mesh
    from repro_torch.service import SweepService, cache_stats, clear_cache
    from repro_torch.sharding.context import collective_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_sweep_mesh()
    group = mesh.get_group("data")
    ds = make_synthetic_libsvm("rcv1", scale=1.0)
    obj = LogisticRegression(ds.X, ds.y, ds.l2_reg)
    sds = make_synthetic_libsvm("rcv1", scale=SERVICE_SMALL_SCALE)
    small = LogisticRegression(sds.X, sds.y, sds.l2_reg)
    out = dict(device=str(torch.device("cuda", torch.cuda.current_device())),
               backend=dist.get_backend(group),
               collective_device=str(collective_device(group)),
               fused=sharded_sweep(mesh, obj, "fused"),
               batched=sharded_sweep(mesh, small, "vmap"))

    requests = [[SweepSpec(seed=seed, scheme=scheme, step_size=STEP_SIZE,
                           num_threads=THREADS, engine_mode="fused")
                 for seed, scheme in ((5, "consistent"), (6, "unlock"))],
                [SweepSpec(seed=7, algo="hogwild", scheme="unlock",
                           step_size=STEP_SIZE, num_threads=THREADS, tau=-1,
                           engine_mode="fused")]]
    svc = SweepService(obj, epochs=RCV1_EPOCHS, mesh=mesh)
    clear_cache()
    flushes = []
    for _ in range(2):
        rids = [svc.submit(specs) for specs in requests]
        dist.barrier()
        torch.cuda.synchronize()
        base, built = cache_stats(), _build.builds()
        reset_counts()
        t0 = time.perf_counter()
        svc.flush()
        flush_s = time.perf_counter() - t0
        delta = cache_stats().since(base)
        flushes.append(dict(
            flush_s=flush_s, launches=read_counts(),
            runners_constructed=delta.misses, compiles=delta.compiles,
            kernels_built=_build.builds() - built,
            results=[(r.histories, r.final_w)
                     for r in (svc.result(rid) for rid in rids)]))
        if len(flushes) == 1:
            alone = [run_sweep(obj, RCV1_EPOCHS, specs, mesh=mesh)
                     for specs in requests]
            out["alone"] = [(r.histories, r.final_w) for r in alone]
    out["flushes"] = flushes

    t0 = time.perf_counter()
    out["bse"] = {m: (bse_run(mesh, ds, "cuda", m, 2)[0],
                      bse_run(mesh, ds, "cpu", m, 2)[0]) for m in BSE_METHODS}
    out["bse_s"] = time.perf_counter() - t0
    return out


def sharding_nccl_rank(rank, world):
    """Phase `sharding` (b), a world of one on `nccl`: `make_sweep_mesh()`'s
    1-rank `data` axis takes the unsharded path (the fused grid at full
    rcv1), and `bounded_staleness_epoch` at W = 1 against H sequential
    local SVRG steps, its all-reduce through NCCL."""
    import torch.distributed as dist

    from repro_torch import LogisticRegression
    from repro_torch.core.distributed import svrg_direction, value_and_grad
    from repro_torch.core.sweep import run_sweep
    from repro_torch.data.libsvm import make_synthetic_libsvm
    from repro_torch.launch.mesh import make_sweep_mesh
    from repro_torch.sharding.context import collective_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_sweep_mesh()
    group = mesh.get_group("data")
    ds = make_synthetic_libsvm("rcv1", scale=1.0)
    obj = LogisticRegression(ds.X, ds.y, ds.l2_reg)
    specs, _ = sweep_specs(obj, "fused")
    torch.cuda.synchronize()
    reset_counts()
    res = run_sweep(obj, RCV1_EPOCHS, specs, mesh=mesh)
    out = dict(backend=dist.get_backend(group),
               collective_device=str(collective_device(group)),
               histories=res.histories, final_w=res.final_w,
               launches=read_counts())
    # one epoch at W = 1 against the same H steps taken one after another
    got, (loss, svrg, batches) = bse_run(mesh, ds, "cuda", "none", 1)
    vgrad = value_and_grad(loss)
    w = {"w": torch.zeros_like(svrg.w_snap["w"])}   # the start: zeros
    X, y = batches[0]
    for h in range(BSE_H):
        _, g = vgrad(w, (X[0, h], y[0, h]))
        _, g0 = vgrad(svrg.w_snap, (X[0, h], y[0, h]))
        v = svrg_direction(g, g0, svrg.g_snap)
        w = {"w": w["w"] - BSE_STEP * v["w"]}
    out["bse_w"], out["sequential_w"] = got[0][0], w["w"].cpu().numpy()
    return out


def _bse_gap(card, cpu):
    """Card against CPU over the epochs of one method: the largest gap and
    the coordinates beyond rtol 1e-4, atol 1e-5 (the card-vs-CPU limits),
    per epoch, in the params and in the residuals."""
    gaps, beyond = 0.0, []
    for (w, r), (w_ref, r_ref) in zip(card, cpu):
        n = 0
        for a, b in ((w, w_ref), (r, r_ref)):
            d = np.abs(a - b)
            gaps = max(gaps, float(d.max()))
            n += int(np.sum(d > 1e-5 + 1e-4 * np.abs(b)))
        beyond.append(n)
    return gaps, beyond


def phase_sharding(obj, fused, fused_s_per_epoch):
    """Config-row sharding and the bounded-staleness epoch over
    torch.distributed, ranks as spawned processes under
    `launch.mesh.WORLD_DEADLINE_S` each:

      (a) 2 ranks, `gloo`, both on cuda:0 (two processes time-sharing the
          one card: no multi-GPU figure): the 5-row fused grid at full
          rcv1 row-sharded (the 4-row group 2 rows a rank, the Hogwild!
          row padded to 2) against the unsharded fused `run_sweep` of
          phase `run_sweep_fused` (equal bits); the batched grid at a
          tenth of rcv1's rows against the unsharded run here (rtol 1e-5,
          atol 1e-6); each grid run twice, cold and warm, both checked;
          each rank's K1/K2/K3 launches its shard's groups x epochs (x M̃
          for K1); a sharded `SweepService` flush of two requests from a
          cleared runner cache, which constructs runners, against
          standalone sharded `run_sweep` (equal bits), and a warm flush
          that constructs no runner and builds no kernel;
          `bounded_staleness_epoch` for each compression method on the card
          against the same call on the CPU (int8 may flip up to
          ``BSE_INT8_FLIPS`` coordinates an epoch, where x/scale + noise
          rounds on the other side of a half-integer);
      (b) 1 rank, `nccl`: `make_sweep_mesh()` of one gives the unsharded
          path's bits; `bounded_staleness_epoch` at W = 1 equals H
          sequential local steps, its all-reduce through NCCL."""
    import shutil
    import tempfile

    from repro_torch import LogisticRegression
    from repro_torch.core.sweep import run_sweep
    from repro_torch.data.libsvm import make_synthetic_libsvm
    from repro_torch.launch.mesh import run_world

    sds = make_synthetic_libsvm("rcv1", scale=SERVICE_SMALL_SCALE)
    small = LogisticRegression(sds.X, sds.y, sds.l2_reg)
    specs, total_small = sweep_specs(small, "vmap")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    unsharded_b = run_sweep(small, RCV1_EPOCHS, specs)
    unsharded_b_s = time.perf_counter() - t0

    root = ROOT / "build"
    root.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_world-", dir=root))
    try:
        t0 = time.perf_counter()
        ranks = run_world(sharding_gloo_rank, 2, backend="gloo",
                          init_file=str(tmp / "gloo"))
        gloo_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        (nccl,) = run_world(sharding_nccl_rank, 1, backend="nccl",
                            init_file=str(tmp / "nccl"))
        nccl_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    want_fused = {"sweep_epoch": 2 * RCV1_EPOCHS, "logreg_grad": RCV1_EPOCHS,
                  "svrg_update": 0, "flash_attention": 0}
    want_batched = {"svrg_update": RCV1_EPOCHS * total_small,
                    "logreg_grad": RCV1_EPOCHS, "sweep_epoch": 0,
                    "flash_attention": 0}
    per_rank = []
    def within_tol(run, want):
        return bool(np.allclose(run["histories"], want.histories, rtol=1e-5,
                                atol=1e-6)
                    and np.allclose(run["final_w"], want.final_w, rtol=1e-5,
                                    atol=1e-6))

    for out in ranks:
        (f_cold, f), (b_cold, b) = out["fused"], out["batched"]
        cold, warm = out["flushes"]
        bse = {m: _bse_gap(card, cpu) for m, (card, cpu) in out["bse"].items()}
        per_rank.append(dict(
            device=out["device"], backend=out["backend"],
            collective_device=out["collective_device"],
            fused_bits_equal_unsharded=bool(all(
                np.array_equal(run["histories"], fused.histories)
                and np.array_equal(run["final_w"], fused.final_w)
                for run in (f_cold, f))),
            batched_within_tol_unsharded=bool(
                within_tol(b_cold, unsharded_b)
                and within_tol(b, unsharded_b)),
            batched_max_abs_dw=float(max(
                np.abs(run["final_w"] - unsharded_b.final_w).max()
                for run in (b_cold, b))),
            fused_launches=f["launches"], batched_launches=b["launches"],
            cold_launches_equal=bool(f_cold["launches"] == f["launches"]
                                     and b_cold["launches"] == b["launches"]),
            fused_wall_s=f["wall_s"], batched_wall_s=b["wall_s"],
            fused_cold_wall_s=f_cold["wall_s"],
            batched_cold_wall_s=b_cold["wall_s"],
            service_equal_alone=bool(all(
                np.array_equal(g[0], a[0]) and np.array_equal(g[1], a[1])
                for flush in (cold, warm)
                for g, a in zip(flush["results"], out["alone"]))),
            flushes=[{k: v for k, v in fl.items() if k != "results"}
                     for fl in (cold, warm)],
            bse_max_gap={m: g for m, (g, _) in bse.items()},
            bse_beyond_tol={m: n for m, (_, n) in bse.items()},
            bse_s=out["bse_s"]))
    ranks_agree = bool(all(
        np.array_equal(ranks[0][k][i]["final_w"], ranks[1][k][i]["final_w"])
        for k in ("fused", "batched") for i in (0, 1)))
    nccl_rec = dict(
        backend=nccl["backend"], collective_device=nccl["collective_device"],
        launches=nccl["launches"],
        bits_equal_unsharded=bool(
            np.array_equal(nccl["histories"], fused.histories)
            and np.array_equal(nccl["final_w"], fused.final_w)),
        bse_vs_sequential_max_abs=float(np.abs(nccl["bse_w"]
                                               - nccl["sequential_w"]).max()))
    rec = dict(
        phase="sharding", card_sharing="2 processes time-sharing one card "
        "(gloo); not a multi-GPU figure", epochs=RCV1_EPOCHS,
        n=obj.n, n_small=sds.n, p=obj.p, ranks=per_rank,
        ranks_agree=ranks_agree, nccl=nccl_rec,
        unsharded_fused_wall_s=fused_s_per_epoch * RCV1_EPOCHS,
        unsharded_batched_wall_s=unsharded_b_s,
        gloo_world_s=gloo_s, nccl_world_s=nccl_s,
        bse=dict(H=BSE_H, batch=BSE_BATCH, step=BSE_STEP,
                 methods=list(BSE_METHODS)))
    emit(**rec)
    for r in per_rank:
        if (r["backend"], r["device"], r["collective_device"]) != \
                ("gloo", "cuda:0", "cpu"):
            raise AssertionError(f"sharding: rank placement {r}")
        if not (r["fused_bits_equal_unsharded"]
                and r["batched_within_tol_unsharded"] and ranks_agree):
            raise AssertionError(f"sharding: sharded rows differ from "
                                 f"unsharded: {r}")
        if r["fused_launches"] != want_fused \
                or r["batched_launches"] != want_batched \
                or not r["cold_launches_equal"]:
            raise AssertionError(f"sharding: per-rank launches "
                                 f"{r['fused_launches']} / "
                                 f"{r['batched_launches']} != {want_fused} / "
                                 f"{want_batched}")
        cold, warm = r["flushes"]
        if not r["service_equal_alone"] or cold["runners_constructed"] < 1 \
                or warm["runners_constructed"] or warm["compiles"] \
                or warm["kernels_built"]:
            raise AssertionError(f"sharding: service flush {r}")
        for m, beyond in r["bse_beyond_tol"].items():
            if max(beyond) > (BSE_INT8_FLIPS if m == "int8" else 0):
                raise AssertionError(f"sharding: bounded_staleness_epoch "
                                     f"{m} card vs CPU: {r}")
    if (nccl_rec["backend"], nccl_rec["collective_device"]) != \
            ("nccl", "cuda:0") or not nccl_rec["bits_equal_unsharded"] \
            or nccl_rec["launches"] != want_fused \
            or nccl_rec["bse_vs_sequential_max_abs"] > 1e-6:
        raise AssertionError(f"sharding: nccl world of one {nccl_rec}")
    return rec


def greedy_steps(bundle, params, batch, cache_len: int, new_tokens: int):
    """The serve session stepped by hand, greedy: (prefill logits, each
    decode's logits, the tokens [B, new_tokens], the final cache), nothing
    synchronised."""
    from repro_torch.serve.loop import ServeSession

    sess = ServeSession(bundle, params, cache_len)
    logits = [sess.prefill(batch)]
    toks = [torch.argmax(logits[0], dim=-1).to(torch.int32)]
    for _ in range(new_tokens - 1):
        logits.append(sess.decode(toks[-1]))
        toks.append(torch.argmax(logits[-1], dim=-1).to(torch.int32))
    return logits, torch.stack(toks, dim=1), sess.cache


def attention_layers(cfg) -> int:
    """The flash_attention launches of one prefill of ``cfg``: one per
    layer that attends; for the encoder-decoder one per encoder layer and
    two per decoder layer (its self- and cross-attention)."""
    from repro_torch.models import rglru

    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return rglru._pattern(cfg)[0]
    if cfg.family == "encdec":
        return cfg.encoder_layers + 2 * cfg.num_layers
    return cfg.num_layers


def modality_draws(cfg, batch: int, seed: int):
    """The modality stubs of ``cfg``'s batch (`factory._modality_extra`:
    whisper's frame embeddings, the vision model's patch embeddings) drawn
    standard normal in float32 on the card from ``seed``, so that the
    encoder's and the cross-attention's weights are not uniform; none for
    the other families."""
    from repro_torch.models.factory import _modality_extra

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {name: torch.randn((batch, *shape), generator=gen, device="cuda")
            for name, shape in _modality_extra(cfg).items()}


def scale_to_full_depth(params, defs, full_defs):
    """The params of a depth cut (``defs``) rescaled in place to the full
    model's init (``full_defs``): each stacked "normal" leaf times
    sqrt(L_cut / L_full), the first layers of the full model's draw in
    distribution. The init rule's fan-in is a stack's length, so a 2-layer
    stack drawn on its own has std 1/sqrt(2), where these families' scores
    reach the thousands and a softmax's near-ties make float32 chaotic
    (PERF.md §6, the encoder-decoder and vision findings)."""
    for key, d in defs.items():
        if isinstance(d, dict):
            scale_to_full_depth(params[key], d, full_defs[key])
        elif d.init == "normal" and d.shape and \
                d.shape[0] != full_defs[key].shape[0]:
            params[key].mul_(float(np.sqrt(d.shape[0]
                                           / full_defs[key].shape[0])))


def draw_zero_leaves(params, defs, gen, scale=0.5):
    """Every leaf whose init is "zeros" (biases, the vision model's tanh
    gates, RMS-norm and q/k-norm scales) overwritten in place by
    ``scale``·normal draws from ``gen``, so that none is 0: with the
    config's zero gates tanh(0) = 0 switches the image path off."""
    for key, d in defs.items():
        if isinstance(d, dict):
            draw_zero_leaves(params[key], d, gen, scale)
        elif d.init == "zeros":
            x = params[key]
            x.copy_(scale * torch.randn(x.shape, generator=gen,
                                        device=x.device))


def drive_serve(phase, arch, k4_ms_per_prefill, prompt=SERVE_PROMPT,
                inputs=None):
    """The serve path at full width through `launch.serve.run` (the CLI's
    function: build_model, init_from_defs, prompts from prng.randint,
    generate), batch 4, ``prompt`` tokens, 16 new tokens, the modality
    stubs ``inputs`` beside them: flash_attention launches at prefill as
    `attention_layers` counts them (none for an SSM), each on the
    tensor-core route, none in decode, no other kernel. Then the same
    session stepped by hand, synchronised after the prefill and after the
    decodes, for the split of the time, and three warm prefills. Returns
    (config, launch counts of `generate`)."""
    from repro_torch.kernels.flash_attention.ops import gqa_flash
    from repro_torch.launch.serve import run
    from repro_torch.serve.loop import ServeSession
    from repro_torch.utils.tree import tree_leaves

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = run(arch, batch=SERVE_BATCH, prompt_len=prompt,
              new_tokens=SERVE_NEW, device="cuda", inputs=inputs)
    counts = read_counts()
    routes = dict(gqa_flash.launches_by_route)
    cfg, bundle, params = res["cfg"], res["bundle"], res["params"]
    n_attn = attention_layers(cfg)
    want = {"svrg_update": 0, "logreg_grad": 0, "sweep_epoch": 0,
            "flash_attention": n_attn}
    if counts != want:
        raise AssertionError(f"{phase} launch counts {counts} != {want}")
    if routes != {"wgmma": n_attn, "simt": 0}:
        raise AssertionError(f"{phase} flash_attention routes {routes}")

    cache_len = prompt + SERVE_NEW
    batch = res["batch"]
    sess = ServeSession(bundle, params, cache_len)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logits = sess.prefill(batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    after_prefill = read_counts()
    prefill_routes = dict(gqa_flash.launches_by_route)
    finite = torch.isfinite(logits).all()
    toks = [torch.argmax(logits, dim=-1).to(torch.int32)]
    t0 = time.perf_counter()
    for _ in range(SERVE_NEW - 1):
        logits = sess.decode(toks[-1])
        finite &= torch.isfinite(logits).all()
        toks.append(torch.argmax(logits, dim=-1).to(torch.int32))
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    after_decode = read_counts()
    stepwise = torch.stack(toks, dim=1).cpu()
    # the prefill again, warm: host clock and CUDA events of each (a single
    # host-clock reading varies between calls with the host's load)
    repeats = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        sess.prefill(batch)
        stop.record()
        torch.cuda.synchronize()
        repeats.append((time.perf_counter() - t0,
                        start.elapsed_time(stop) / 1e3))
    rec = dict(phase=phase, arch=cfg.name, layers=cfg.num_layers,
               encoder_layers=cfg.encoder_layers, attention_layers=n_attn,
               inputs={k: list(v.shape) for k, v in batch.items()},
               d_model=cfg.d_model, vocab=cfg.vocab_size, batch=SERVE_BATCH,
               prompt=prompt, new_tokens=SERVE_NEW, cache_len=cache_len,
               dtype=cfg.dtype, param_dtype=cfg.param_dtype,
               params=sum(x.numel() for x in tree_leaves(params)),
               launches=counts, flash_routes=routes,
               flash_routes_prefill=prefill_routes,
               generate_s=res["seconds"], tokens_per_s=res["tokens_per_s"],
               prefill_s=prefill_s,
               prefill_repeat_s=[w for w, _ in repeats],
               prefill_repeat_event_s=[e for _, e in repeats],
               decode_ms_per_token=1e3 * decode_s / (SERVE_NEW - 1),
               flash_launches_prefill=after_prefill["flash_attention"],
               flash_launches_decode=(after_decode["flash_attention"]
                                      - after_prefill["flash_attention"]),
               k4_ms_per_prefill=k4_ms_per_prefill,
               k4_share_of_prefill=k4_ms_per_prefill / (1e3 * prefill_s),
               k4_share_of_prefill_events=k4_ms_per_prefill / (
                   1e3 * min(e for _, e in repeats)),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               logits_finite=bool(finite),
               tokens=res["tokens"][:, :8].tolist(),
               stepwise_equals_generate=bool(torch.equal(stepwise,
                                                         res["tokens"])))
    emit(**rec)
    if not rec["logits_finite"]:
        raise AssertionError(f"{phase}: non-finite logits")
    if (rec["flash_launches_prefill"], rec["flash_launches_decode"]) != \
            (n_attn, 0) or prefill_routes != routes:
        raise AssertionError(f"{phase}: flash launches {after_prefill} after "
                             f"prefill, {after_decode} after decode")
    if tuple(res["tokens"].shape) != (SERVE_BATCH, SERVE_NEW) \
            or res["tokens"].dtype != torch.int32 \
            or not rec["stepwise_equals_generate"]:
        raise AssertionError(f"{phase}: generate and the stepped session "
                             "differ")
    return cfg, counts


def phase_serve(report):
    """gemma3-4b at full width and depth (34 layers: 29 window-1024 and 5
    global)."""
    from repro_torch.models.transformer import _layer_flags

    cfg, counts = drive_serve("serve", SERVE_ARCH,
                              report["flash_attention"]["per_prefill_ms"])
    windows = _layer_flags(cfg).tolist()
    if {w: windows.count(w) for w in set(windows)} != LAYER_MIX:
        raise AssertionError(f"serve: layer windows {windows}")
    return counts


def release_memory():
    """Free what earlier phases left to the caching allocator, so the next
    phase's weights fit."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_serve_moe(report):
    """deepseek-moe-16b at full width and depth (28 layers: 1 dense, 27 MoE
    with 64 experts, top 6, 2 shared; MHA, h = 128). `launch.serve.run`
    draws the weights in bf16 (the float32 masters, 65.5 GB, and their
    bf16 copy would not fit 80 GB; no width is changed). The peak memory
    covers the weights' draw."""
    release_memory()
    cfg, counts = drive_serve(
        "serve_moe", MOE_ARCH,
        report["flash_attention"]["moe"]["per_prefill_ms"])
    if cfg.num_layers != MOE_LAYERS:
        raise AssertionError(f"serve_moe: {cfg.num_layers} layers")
    return counts


def phase_serve_hybrid(report):
    """recurrentgemma-2b at full width and depth (26 layers: 8 groups of
    two RG-LRU layers and one local-attention layer, 2 trailing RG-LRU
    layers), prompt 4096, twice the window: K4 masks the window at
    prefill, and the ring cache wraps in prefill and in decode."""
    release_memory()
    cfg, counts = drive_serve(
        "serve_hybrid", HYBRID_ARCH,
        report["flash_attention"]["hybrid"]["per_prefill_ms"],
        prompt=HYBRID_PROMPT)
    if (cfg.num_layers, attention_layers(cfg)) != (26, HYBRID_ATTN_LAYERS):
        raise AssertionError(f"serve_hybrid: {cfg.num_layers} layers")
    return counts


def phase_serve_ssm():
    """falcon-mamba-7b at full width and depth (64 layers, d_inner 8192,
    N 16), prompt 2048. The path has no TPU kernel and launches none of
    the repo's: the selective scan runs in torch ops."""
    release_memory()
    cfg, counts = drive_serve("serve_ssm", SSM_ARCH, 0.0)
    if cfg.num_layers != 64:
        raise AssertionError(f"serve_ssm: {cfg.num_layers} layers")
    return counts


@contextmanager
def recorded_routes():
    """Every MoE routing (`models.moe.route`) made inside the block, copied
    to the CPU, in call order (none for a dense model)."""
    from repro_torch.models import moe

    seen, real = [], moe.route

    def spy(*args, **kw):
        r = real(*args, **kw)
        seen.append(moe.Routing(*(t.detach().cpu() for t in r)))
        return r

    moe.route = spy
    try:
        yield seen
    finally:
        moe.route = real


NEAR_TIE = 1e-5     # relative gap of two router probabilities called a tie


def route_flips(got, want):
    """Tokens whose chosen experts (``topi``, in rank order) differ between
    two runs' routings of the same calls: per token its call, batch row,
    group and position, the first rank r that differs, and the relative
    gap between the r-th and (r+1)-th largest router probabilities in each
    run (a near-tie if both are within NEAR_TIE)."""
    flips = []
    for call, (a, b) in enumerate(zip(got, want)):
        for idx in (a.topi != b.topi).any(-1).nonzero().tolist():
            at = tuple(idx)
            r = int((a.topi[at] != b.topi[at]).nonzero()[0])
            gaps = []
            for run in (a, b):
                p = torch.sort(run.probs[at], descending=True).values
                gaps.append(float((p[r] - p[r + 1]) / p[r]))
            flips.append(dict(call=call, row=idx[0], group=idx[1],
                              token=idx[2], rank=r, rel_gaps=gaps,
                              near_tie=max(gaps) <= NEAR_TIE))
    return flips


def prefill_kernel_vs_plain(phase, cfg, seed, against="plain",
                            prompt=SERVE_PROMPT, zeros_drawn=False,
                            full_cfg=None):
    """``cfg`` (full width, a few layers) in bf16, batch 1, ``prompt``
    tokens (and the modality stubs, `modality_draws`): the prefill logits
    with attention through the tensor-core kernel against the same
    prefill, same weights (with ``zeros_drawn``, every zero-initialised
    leaf drawn: `draw_zero_leaves`; with ``full_cfg``, the weights drawn
    as the first layers of that full-depth model's, `scale_to_full_depth`),
    with the plain attention on the card:
    ``against="plain"``, `ref.attention_ref` on the bf16 q, k, v (the JAX
    package's oracle, which rounds the scores to bf16); ``"float32"``, the
    same plain attention on q, k, v cast to float32, output rounded to bf16
    (the function of the TPU kernel, which computes the scores and the
    softmax in float32). Limit: the relative gap ||a - b|| / ||b|| <= 2e-2;
    against float32 the kernel must also be nearer to it than the bf16
    plain attention is, and so must the first attention layer's output
    (within 2e-2 of the float32 attention's; all three prefills give it
    the same inputs). All three prefills run, and every gap is recorded.

    With ``full_cfg`` (the encoder-decoder and vision families) every
    kernel call of the prefill is held against the float32 attention of
    its own inputs instead, within 2e-2, and the logits only to be nearer
    to the float32 attention's than the bf16 plain attention's are: their
    self-attention has no QK-norm, its scores reach the hundreds, and the
    bf16 roundings of the residual stream alone move their logits by
    several percent. A control prefill records that: the float32
    attention with its output scaled by 1 + CONTROL_EPS (1e-3, the size of
    the kernel's own per-call gap) before the bf16 rounding.

    Where the scores stay small (gemma3-4b: QK-norm) the kernel and the
    bf16 plain attention differ by bf16 roundings (max |dO| ~ 1.6e-2 at
    |O| ~ 2-4 in the kernel check), about four bf16 ulps after two layers.
    Without QK-norm, the init rule's std 1/sqrt(L) is 1 in a one-layer
    stack, and deepseek-moe-16b's scores reach the thousands
    (``max_abs_score``), where bf16's spacing is 8 or more: the bf16
    plain attention then departs from the float32 one, and the kernel,
    whose scores stay float32, does not. For a MoE model the tokens whose
    experts differ between the kernel's and the bf16 plain prefill are
    counted."""
    from repro_torch import prng
    from repro_torch.kernels.flash_attention.ops import gqa_flash
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import encdec, transformer, vlm
    from repro_torch.models.factory import build_model
    from repro_torch.models.transformer import _layer_flags
    from repro_torch.serve.loop import ServeSession
    from repro_torch.sharding.rules import init_from_defs

    def plain_gqa(q, k, v, *, causal=True, window=0):
        G = q.shape[2] // k.shape[2]
        kt, vt = (t.transpose(1, 2).repeat_interleave(G, dim=1)
                  for t in (k, v))
        return attention_ref(q.transpose(1, 2), kt, vt, causal=causal,
                             window=window).transpose(1, 2)

    def f32_gqa(q, k, v, *, causal=True, window=0):
        # the largest scaled score q.k / sqrt(h) of the layer on or below
        # the diagonal (every one, not causal), in float32
        G = q.shape[2] // k.shape[2]
        scores = torch.einsum("bqnh,bknh->bnqk", q.float(),
                              k.float().repeat_interleave(G, dim=2)).abs()
        max_abs_score.append(float(scores.tril().max() if causal
                                   else scores.max()) / q.shape[-1] ** 0.5)
        del scores
        return plain_gqa(q.float(), k.float(), v.float(), causal=causal,
                         window=window).to(q.dtype)

    def prefill_with(name, attention):
        """The prefill's logits with ``attention`` in every attention
        layer; the first layer's output (the same inputs in every
        prefill) kept as ``first_out[name]``."""
        def attend(q, k, v, **kw):
            out = attention(q, k, v, **kw)
            first_out.setdefault(name, out.float())
            if name == "kernel" and full_cfg is not None:
                call_gaps.append(rel_gap(out.float(), plain_gqa(
                    q.float(), k.float(), v.float(), **kw)))
            return out

        for mod in (transformer, encdec, vlm):  # this one prefill only
            mod.gqa_flash = attend
        try:
            return ServeSession(bundle, params, prompt).prefill(
                batch).float()
        finally:
            for mod in (transformer, encdec, vlm):
                mod.gqa_flash = gqa_flash

    def f32_scaled_gqa(q, k, v, **kw):
        out = plain_gqa(q.float(), k.float(), v.float(), **kw)
        return (out * (1 + CONTROL_EPS)).to(q.dtype)

    def rel_gap(a, b):
        return float((a - b).norm() / b.norm())

    bundle = build_model(cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_from_defs(gen, bundle.param_defs)
    if full_cfg is not None:
        scale_to_full_depth(params, bundle.param_defs,
                            build_model(full_cfg, "cuda").param_defs)
    if zeros_drawn:
        draw_zero_leaves(params, bundle.param_defs, gen)
    call_gaps = []
    batch = {"tokens": prng.randint(prng.PRNGKey(seed), (1, prompt), 0,
                                    cfg.vocab_size),
             **modality_draws(cfg, 1, seed)}
    first_out = {}
    before = dict(gqa_flash.launches_by_route)
    with recorded_routes() as kern_routes:
        kern = prefill_with("kernel", gqa_flash)
    torch.cuda.synchronize()
    routes = {r: n - before[r] for r, n in gqa_flash.launches_by_route.items()}
    with recorded_routes() as plain_routes:
        plain = prefill_with("plain", plain_gqa)
    max_abs_score = []
    with recorded_routes() as f32_routes:
        f32 = prefill_with("float32", f32_gqa)
    control = None
    if full_cfg is not None:
        control = rel_gap(prefill_with("control", f32_scaled_gqa), f32)
    torch.cuda.synchronize()
    ref = {"plain": plain, "float32": f32}[against]
    rel = rel_gap(kern, ref)
    rec = dict(phase=phase, arch=cfg.name,
               layers=cfg.num_layers, encoder_layers=cfg.encoder_layers,
               windows=_layer_flags(cfg).tolist(), zeros_drawn=zeros_drawn,
               batch=1, prompt=prompt, dtype=cfg.dtype, routes=routes,
               against=against, rel_tol=2e-2, rel_logit_gap=rel,
               rel_gap_kernel_vs_plain=rel_gap(kern, plain),
               rel_gap_kernel_vs_f32_attention=rel_gap(kern, f32),
               rel_gap_plain_vs_f32_attention=rel_gap(plain, f32),
               first_attention_rel_gap_kernel_vs_f32=rel_gap(
                   first_out["kernel"], first_out["float32"]),
               first_attention_rel_gap_plain_vs_f32=rel_gap(
                   first_out["plain"], first_out["float32"]),
               max_abs_score=max_abs_score,
               kernel_call_rel_gaps_vs_f32=call_gaps,
               control_eps=CONTROL_EPS,
               rel_gap_control_vs_f32_attention=control,
               max_abs_logit_gap=float((kern - ref).abs().max()),
               max_abs_logit=float(ref.abs().max()),
               argmax_equal=bool(torch.equal(kern.argmax(-1), ref.argmax(-1))),
               finite=bool(torch.isfinite(kern).all()),
               moe_layer_calls=len(kern_routes),
               tokens_with_other_experts_vs_plain=len(
                   route_flips(kern_routes, plain_routes)),
               tokens_with_other_experts_vs_f32=len(
                   route_flips(kern_routes, f32_routes)),
               of_tokens=prompt * len(kern_routes))
    emit(**rec)
    # against float32 the kernel is also the nearer one, in the logits and
    # in the first attention layer's output: where the residual stream
    # swamps the attention's share in bf16 (recurrentgemma-2b's RG-LRU
    # layers before it) the logits alone cannot tell the attentions apart
    nearer = against == "plain" or (
        rec["rel_gap_kernel_vs_f32_attention"]
        <= rec["rel_gap_plain_vs_f32_attention"]
        and rec["first_attention_rel_gap_kernel_vs_f32"] <= 2e-2
        and rec["first_attention_rel_gap_kernel_vs_f32"]
        <= rec["first_attention_rel_gap_plain_vs_f32"])
    if full_cfg is None:
        held = rel <= 2e-2
    else:
        held = (len(call_gaps) == attention_layers(cfg)
                and max(call_gaps) <= 2e-2)
    if not (held and nearer and rec["finite"]
            and routes == {"wgmma": attention_layers(cfg), "simt": 0}):
        raise AssertionError(f"bf16 prefill, kernel against {against}: "
                             f"{rec}")


# the control prefill's relative change of each attention output
# (`prefill_kernel_vs_plain`)
CONTROL_EPS = 1e-3


def phase_serve_bf16_vs_plain():
    """gemma3-4b at full width and 2 layers (one window-1024 layer, one
    global)."""
    from repro_torch.configs import get_config

    prefill_kernel_vs_plain(
        "serve_bf16_vs_plain",
        get_config(SERVE_ARCH).with_overrides(num_layers=2, global_every=2), 2)


def phase_serve_moe_bf16_vs_plain():
    """deepseek-moe-16b at full width and 2 layers (the dense one and one
    MoE layer), against the plain attention in float32: its scores reach
    the thousands (no QK-norm), where the bf16 plain attention's rounding
    of them departs from the function the kernel and the TPU kernel
    compute (PERF.md §6); that gap is recorded beside."""
    from repro_torch.configs import get_config

    release_memory()
    prefill_kernel_vs_plain(
        "serve_moe_bf16_vs_plain",
        get_config(MOE_ARCH).with_overrides(num_layers=2), 4,
        against="float32")


def phase_serve_hybrid_bf16_vs_plain():
    """recurrentgemma-2b at full width and 3 layers (one group: two RG-LRU
    layers and one local-attention layer), prompt 4096, against the plain
    attention in float32: without QK-norm, and with the init rule's std 1
    for a one-layer attention stack, its scores reach the thousands, as
    deepseek-moe-16b's do (`phase_serve_moe_bf16_vs_plain`); the bf16
    plain attention's gap is recorded beside."""
    from repro_torch.configs import get_config

    release_memory()
    prefill_kernel_vs_plain(
        "serve_hybrid_bf16_vs_plain",
        get_config(HYBRID_ARCH).with_overrides(num_layers=3), 6,
        against="float32", prompt=HYBRID_PROMPT)


# the recurrent families' float32 serve, card against CPU (logits; a cache
# leaf's of its scale): see `serve_card_vs_cpu`
RECURRENT_ATOL = 5e-3


def forced_steps(bundle, params, batch, cache_len: int, toks):
    """The serve session fed the given tokens [B, n] after the prompt:
    (prefill logits and each decode's, the final cache)."""
    from repro_torch.serve.loop import ServeSession

    sess = ServeSession(bundle, params, cache_len)
    logits = [sess.prefill(batch)]
    for j in range(toks.shape[1] - 1):
        logits.append(sess.decode(toks[:, j].to(bundle.device)))
    return logits, sess.cache


def serve_card_vs_cpu(phase, cfg, seed, batch, prompt, new, anchor64=False,
                      zeros_drawn=False, full_cfg=None, atol=None):
    """``cfg`` (full width, 2 or 3 layers) in float32, ``batch`` rows of
    ``prompt`` tokens, ``new`` new tokens, on the card and on the CPU from
    the same weights: prefill and decode logits within rtol 1e-3, atol 5e-4
    (cache against recompute's tolerance in tests/test_models_smoke.py),
    greedy tokens equal. For a MoE model each layer's chosen experts are
    compared too: a token whose experts differ must sit on a near-tie of
    its router probabilities (`route_flips`), and the logits and tokens
    are compared only over the batch rows whose routes agree in every
    call (rows route apart: groups never span two). No row left to
    compare fails the phase.

    ``anchor64`` (the recurrent families): every leaf of the final cache
    is compared too, and the limit is atol `RECURRENT_ATOL` (logits; for
    a cache leaf, of its scale, its largest magnitude), rtol 1e-3. Their
    float32 at full width departs from the function by more than 5e-4:
    at the init's scale (activations up to ~1e11 in falcon-mamba-7b,
    recurrent states fed through √(1 − a²) by 1 − exp(2·log a) near
    a = 1) the card's and the CPU's roundings differ by up to ~1.5e-3.
    So that the size of float32's own error stands beside the gaps, the
    same steps also run on the CPU in float64 (float64 outside the
    model's own float32 points), fed the CPU's tokens, and each device's
    distance to that run is recorded. The modality stubs are drawn
    (`modality_draws`); with ``zeros_drawn`` so is every zero-initialised
    leaf (`draw_zero_leaves`: biases, gates, norm scales); with
    ``full_cfg`` the weights are drawn as the first layers of that
    full-depth model's (`scale_to_full_depth`)."""
    from repro_torch import prng
    from repro_torch.models.factory import build_model
    from repro_torch.models.transformer import _layer_flags
    from repro_torch.sharding.rules import init_from_defs, tree_map

    on_card, on_cpu = build_model(cfg, "cuda"), build_model(cfg, "cpu")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_from_defs(gen, on_card.param_defs)
    if full_cfg is not None:
        scale_to_full_depth(params, on_card.param_defs,
                            build_model(full_cfg, "cuda").param_defs)
    if zeros_drawn:
        draw_zero_leaves(params, on_card.param_defs, gen)
    prompts = {"tokens": prng.randint(prng.PRNGKey(seed), (batch, prompt),
                                      0, cfg.vocab_size),
               **modality_draws(cfg, batch, seed)}
    cache_len = prompt + new
    t0 = time.perf_counter()
    with recorded_routes() as card_routes:
        card_logits, card_toks, card_cache = greedy_steps(
            on_card, params, prompts, cache_len, new)
        card_logits = [x.cpu() for x in card_logits]
        card_cache = {k: v.cpu() for k, v in card_cache.items()}
    card_s = time.perf_counter() - t0
    params = tree_map(lambda t: t.cpu(), params)
    t0 = time.perf_counter()
    with recorded_routes() as cpu_routes:
        cpu_logits, cpu_toks, cpu_cache = greedy_steps(
            on_cpu, params, prompts, cache_len, new)
    cpu_s = time.perf_counter() - t0
    flips = route_flips(card_routes, cpu_routes)
    rows = [r for r in range(card_toks.shape[0])
            if all(f["row"] != r for f in flips)]
    gaps = [float((a[rows] - b[rows]).abs().max()) if rows else None
            for a, b in zip(card_logits, cpu_logits)]
    if atol is None:
        atol = RECURRENT_ATOL if anchor64 else 5e-4
    close = [bool(torch.allclose(a[rows], b[rows], rtol=1e-3, atol=atol))
             for a, b in zip(card_logits, cpu_logits)]
    toks_equal = bool(torch.equal(card_toks.cpu()[rows], cpu_toks[rows]))
    extra, cache_ok = {}, True
    if anchor64:
        cfg64 = cfg.with_overrides(dtype="float64", param_dtype="float64")
        logits64, cache64 = forced_steps(
            build_model(cfg64, "cpu"), tree_map(torch.Tensor.double, params),
            prompts, cache_len, cpu_toks)
        del params

        def of_scale(a, b, ref):
            return float((a.double() - b.double()).abs().max()
                         / max(1.0, float(ref.abs().max())))

        cache = {}
        for key, want in cpu_cache.items():
            got, ref = card_cache[key], cache64[key]
            scale = max(1.0, float(want.abs().max()))
            cache[key] = dict(
                card_vs_cpu=of_scale(got, want, want),
                card_vs_f64=of_scale(got, ref, ref),
                cpu_vs_f64=of_scale(want, ref, ref),
                within_tol=bool(torch.allclose(got, want, rtol=1e-3,
                                               atol=atol * scale)))
        extra = dict(
            max_abs_logit_gap_card_vs_f64=[
                float((a.double() - b).abs().max())
                for a, b in zip(card_logits, logits64)],
            max_abs_logit_gap_cpu_vs_f64=[
                float((a.double() - b).abs().max())
                for a, b in zip(cpu_logits, logits64)],
            cache_gaps=cache)
        cache_ok = all(c["within_tol"] for c in cache.values())
    rec = dict(phase=phase, arch=cfg.name, layers=cfg.num_layers,
               encoder_layers=cfg.encoder_layers,
               windows=_layer_flags(cfg).tolist(), batch=batch,
               prompt=prompt, new_tokens=new, zeros_drawn=zeros_drawn,
               init_of=(full_cfg or cfg).name + (
                   f" at {full_cfg.num_layers} layers" if full_cfg else ""),
               inputs={k: list(v.shape) for k, v in prompts.items()},
               dtype=cfg.dtype, rtol=1e-3, atol=atol,
               max_abs_logit_gap=gaps, within_tol=close, **extra,
               rows_compared=rows, moe_layer_calls=len(card_routes),
               tokens_with_other_experts=len(flips),
               near_tie=NEAR_TIE, route_flips=flips,
               tokens_card=card_toks.cpu().tolist(),
               tokens_cpu=cpu_toks.tolist(), card_s=card_s, cpu_s=cpu_s)
    emit(**rec)
    if len(card_routes) != len(cpu_routes) or \
            not all(f["near_tie"] for f in flips):
        raise AssertionError(f"{phase}: experts differ off a near-tie: {rec}")
    if not rows:
        raise AssertionError(f"{phase}: every row's experts differ at a "
                             f"near-tie, no logits left to compare: {rec}")
    if not all(close) or not toks_equal or not cache_ok:
        raise AssertionError(f"{phase}: serve on the card and the CPU "
                             f"disagree: {rec}")


def phase_serve_card_vs_cpu():
    """gemma3-4b at full width and 2 layers (one window-1024 layer, one
    global), prompt 2048, 4 new tokens."""
    from repro_torch.configs import get_config

    serve_card_vs_cpu(
        "serve_card_vs_cpu",
        get_config(SERVE_ARCH).with_overrides(num_layers=2, global_every=2,
                                              dtype="float32"),
        1, 1, SERVE_PROMPT, 4)


def phase_serve_moe_card_vs_cpu():
    """deepseek-moe-16b at full width and 2 layers (the dense one and one
    MoE layer), batch 2 (a flip at a near-tie drops one row from the
    comparison, not all), prompt 512 (two routing groups of 256 a row), 4
    new tokens."""
    from repro_torch.configs import get_config

    release_memory()
    serve_card_vs_cpu(
        "serve_moe_card_vs_cpu",
        get_config(MOE_ARCH).with_overrides(num_layers=2, dtype="float32"),
        5, 2, 512, 4)


def phase_serve_recurrent_card_vs_cpu():
    """recurrentgemma-2b at 3 layers (one group) and falcon-mamba-7b at 2,
    full width, float32, batch 2, prompt 640 (the chunk halves to 128: 5
    chunks in every scan), 4 new tokens."""
    from repro_torch.configs import get_config

    for arch, layers, seed in ((HYBRID_ARCH, 3, 7), (SSM_ARCH, 2, 8)):
        release_memory()
        serve_card_vs_cpu(
            "serve_recurrent_card_vs_cpu",
            get_config(arch).with_overrides(num_layers=layers,
                                            dtype="float32"),
            seed, 2, 640, 4, anchor64=True)


# the training phase's shape: gemma3-4b at full width, depth cut from 34 to
# 12 layers (two local:global periods; layers 6 and 12 global) so that
# SVRG's six float32 param-sized trees fit in 80 GB; batch 2, sequence 2048
TRAIN_ARCH, TRAIN_LAYERS = "gemma3-4b", 12
TRAIN_BATCH, TRAIN_SEQ = 2, 2048
TRAIN_STEPS, TRAIN_SNAPSHOT_EVERY, TRAIN_SNAPSHOT_BATCHES = 5, 4, 2
TRAIN_FUSED_STEPS = 2
TRAIN_LR = 3e-3        # launch/train.py's default --lr


def svrg_update_tok_embed(gen, shape):
    """K1 against its plain version at the largest leaf of the training
    phase's tree (tok_embed, [262144, 2560] float32), a step size per row:
    equal bits; both timed beside the bound."""
    from repro_torch.kernels.svrg_update.ops import svrg_update
    from repro_torch.kernels.svrg_update.ref import svrg_update_ref

    u, g, g0, gf = (torch.randn(shape, generator=gen, device="cuda")
                    for _ in range(4))
    lr = 0.1 * torch.rand(shape[0], generator=gen, device="cuda")
    before = svrg_update.launches
    out = svrg_update(u, g, g0, gf, lr)
    if svrg_update.launches != before + 1:
        raise AssertionError("svrg_update at tok_embed's shape did not launch")
    ref = svrg_update_ref(u, g, g0, gf, lr)
    n = u.numel()
    bnd, by = bound_ms(5 * 4 * n + 4 * shape[0], 4 * n)
    rec = dict(kernel="svrg_update", shape=list(shape), dtype="float32",
               bits_equal=bool(torch.equal(out, ref)),
               max_abs_err=float((out - ref).abs().max()),
               ms=median_ms(lambda: svrg_update(u, g, g0, gf, lr), reps=5,
                            inner=3),
               plain_ms=median_ms(lambda: svrg_update_ref(u, g, g0, gf, lr),
                                  reps=5, inner=3),
               bound_ms=bnd, bound_by=by)
    emit(phase="kernels_vs_plain", **rec)
    if not rec["bits_equal"]:
        raise AssertionError(f"svrg_update at tok_embed's shape: {rec}")
    return rec


def phase_train():
    """The training path at gemma3-4b's full width, 12 layers, batch 2,
    sequence 2048 (random weights from seed 0, `SyntheticLMDataset` seed
    0): `train(...)` with SVRG (snapshot every 4 steps over 2 batches) for
    5 steps, unfused as the CLI runs it, each step's loss finite, timed per
    step at its log hook (which reads the loss back, so each interval ends
    synchronised). Then 2 steps through the fused SVRG update, each from
    the state the unfused step starts from: params allclose (rtol 1e-5, atol
    1e-6), metrics equal, K1 launched once per leaf per fused step, K4
    never. K1's time per fused step (CUDA events over `apply_tree` on the
    step's trees) beside its bound and the unfused step's torch ops for the
    same update."""
    from repro_torch.config import SVRGConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic_lm import SyntheticLMDataset
    from repro_torch.models.factory import build_model
    from repro_torch.models.transformer import _layer_flags
    from repro_torch.train.loop import train
    from repro_torch.utils.tree import tree_leaves, tree_size

    release_memory()
    cfg = get_config(TRAIN_ARCH).with_overrides(num_layers=TRAIN_LAYERS)
    bundle = build_model(cfg, "cuda")
    tok_embed = svrg_update_tok_embed(
        torch.Generator(device="cuda").manual_seed(3),
        bundle.param_defs["tok_embed"].shape)
    release_memory()
    torch.cuda.reset_peak_memory_stats()
    tcfg = TrainConfig(steps=TRAIN_STEPS, optimizer="svrg",
                       learning_rate=TRAIN_LR, seed=0, log_every=1,
                       svrg=SVRGConfig(snapshot_every=TRAIN_SNAPSHOT_EVERY,
                                       snapshot_batches=TRAIN_SNAPSHOT_BATCHES))
    ds = SyntheticLMDataset(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    logged = []
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    state = train(bundle, tcfg, ds.batch_at,
                  hooks=lambda s, m: logged.append((s, time.perf_counter(), m)))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = read_counts()
    train_peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [m["loss"] for _, _, m in logged]
    ends = [t for _, t, _ in logged]
    step_s = np.diff(ends).tolist()                # steps 2..5
    snap = [s % TRAIN_SNAPSHOT_EVERY == 0 for s, _, _ in logged][1:]
    plain_steps = [t for t, sn in zip(step_s, snap) if not sn]
    s_per_step = float(np.mean(plain_steps))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    if [s for s, _, _ in logged] != list(range(TRAIN_STEPS)) \
            or not np.all(np.isfinite(losses)):
        raise AssertionError(f"train: steps {[s for s, _, _ in logged]}, "
                             f"losses {losses}")
    if counts != {"svrg_update": 0, "logreg_grad": 0, "sweep_epoch": 0,
                  "flash_attention": 0}:
        raise AssertionError(f"train (unfused) launch counts {counts}")

    # the fused SVRG step against the unfused one, each from the same state
    leaves = len(tree_leaves(state.params))
    state, compare, fused_counts = fused_vs_unfused(
        bundle, tcfg, state,
        [ds.batch_at(TRAIN_STEPS + i) for i in range(TRAIN_FUSED_STEPS)])
    fused_peak = torch.cuda.max_memory_allocated() / 1e9
    k1_ms, k1_bound, k1_by, torch_ms = k1_over_tree(tcfg, state)
    n = tree_size(state.params)
    windows = _layer_flags(cfg).tolist()
    rec = dict(phase="train", arch=cfg.name, layers=cfg.num_layers,
               windows=windows, d_model=cfg.d_model, vocab=cfg.vocab_size,
               params=n, leaves=leaves, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
               dtype=cfg.dtype, param_dtype=cfg.param_dtype, remat=cfg.remat,
               optimizer=tcfg.optimizer, lr=TRAIN_LR,
               snapshot_every=TRAIN_SNAPSHOT_EVERY,
               snapshot_batches=TRAIN_SNAPSHOT_BATCHES, steps=TRAIN_STEPS,
               losses=losses, launches=counts, train_s=train_s,
               step_s=step_s, step_has_snapshot=snap,
               s_per_step=s_per_step, tokens_per_s=tokens / s_per_step,
               tokens_per_s_with_snapshots=tokens * len(step_s) / sum(step_s),
               peak_memory_gb_train=train_peak,
               peak_memory_gb=fused_peak, fused_vs_unfused=compare,
               fused_launches=fused_counts,
               k1_launches_per_fused_step=fused_counts["svrg_update"]
               / TRAIN_FUSED_STEPS,
               k1_ms_per_fused_step=k1_ms, k1_bound_ms_per_fused_step=k1_bound,
               k1_bound_by=k1_by, unfused_update_torch_ms=torch_ms,
               tok_embed=tok_embed)
    emit(**rec)
    check_fused(compare, fused_counts, leaves, "train")
    return rec


def fused_vs_unfused(bundle, tcfg, state, batches):
    """For each batch, the fused SVRG step (K1 per leaf) and the unfused
    one from the same state; the unfused step carries the state on.
    Returns (the last state, a comparison per step: params allclose at rtol
    1e-5, atol 1e-6, the largest gap, both steps' metrics and whether they
    are equal; the fused steps' launch counts, summed)."""
    from repro_torch.train.loop import device_batch
    from repro_torch.train.state import make_train_step
    from repro_torch.utils.tree import tree_flatten_with_path, tree_leaves

    fused = make_train_step(bundle, tcfg, use_fused_update=True)
    unfused = make_train_step(bundle, tcfg)
    compare, fused_counts = [], None
    for b in batches:
        batch = device_batch(b, "cuda")
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        sf, mf = fused(state, batch)
        torch.cuda.synchronize()
        fused_s = time.perf_counter() - t0
        counts = read_counts()
        fused_counts = counts if fused_counts is None else {
            k: fused_counts[k] + n for k, n in counts.items()}
        t0 = time.perf_counter()
        state, mu = unfused(state, batch)
        torch.cuda.synchronize()
        unfused_s = time.perf_counter() - t0
        gaps = {k: float((a - b).abs().max()) for (k, a), (_, b) in zip(
            tree_flatten_with_path(sf.params),
            tree_flatten_with_path(state.params))}
        close = all(bool(torch.allclose(a, b, rtol=1e-5, atol=1e-6))
                    for a, b in zip(tree_leaves(sf.params),
                                    tree_leaves(state.params)))
        compare.append(dict(
            step=int(state.step) - 1, params_allclose=close,
            max_abs_param_gap=max(gaps.values()),
            metrics_fused={k: float(v) for k, v in mf.items()},
            metrics_unfused={k: float(v) for k, v in mu.items()},
            metrics_equal=all(bool(torch.equal(mf[k], mu[k])) for k in mu),
            fused_s=fused_s, unfused_s=unfused_s))
        del sf
    return state, compare, fused_counts


def check_fused(compare, fused_counts, leaves, phase):
    if not all(c["params_allclose"] and c["metrics_equal"] for c in compare):
        raise AssertionError(f"{phase}: fused and unfused train steps "
                             f"disagree: {compare}")
    if fused_counts != {"svrg_update": leaves * len(compare),
                        "logreg_grad": 0, "sweep_epoch": 0,
                        "flash_attention": 0}:
        raise AssertionError(f"{phase}: fused train steps' launch counts "
                             f"{fused_counts}, want {leaves} svrg_update "
                             f"launches per step and nothing else")


def k1_over_tree(tcfg, state):
    """K1 over the whole param tree, as the fused step launches it (CUDA
    events), against the unfused step's torch ops for the same update (v,
    then SGD's apply): (K1 ms, its bound ms, what bounds it, torch ms)."""
    from repro_torch.core.distributed import svrg_direction
    from repro_torch.kernels.svrg_update.ops import apply_tree
    from repro_torch.optim import make_optimizer
    from repro_torch.utils.tree import tree_bytes, tree_leaves, tree_map

    params, w_snap, g_snap = state.params, state.svrg.w_snap, state.svrg.g_snap
    fourth = tree_map(torch.zeros_like, params)
    lr = torch.tensor(tcfg.learning_rate, device="cuda")
    opt = make_optimizer(tcfg)
    k1_ms = median_ms(lambda: apply_tree(params, w_snap, g_snap, fourth, lr),
                      reps=5, inner=1)
    torch_ms = median_ms(lambda: opt.apply(
        svrg_direction(w_snap, g_snap, fourth), {}, lr, params, state.step),
        reps=5, inner=1)
    # five float32 trees through HBM (u, g, g0, gf read, u' written) and a
    # step size per row; 4 flops an element
    k1_bound, k1_by = bound_ms(5 * tree_bytes(params) + 4 * sum(
        x.numel() // x.shape[-1] if x.dim() else 1 for x in tree_leaves(params)),
        4 * sum(x.numel() for x in tree_leaves(params)))
    return k1_ms, k1_bound, k1_by, torch_ms


# the MoE training phase's shape: deepseek-moe-16b at full width, 2 layers
# (the dense one and one MoE layer, 1.09 B params: SVRG's six float32 trees
# take ~26 GB), batch 2, sequence 2048 (8 routing groups of 256 per row)
TRAIN_MOE_LAYERS = 2
TRAIN_SNAPSHOT_BATCHES_FUSED = 1


def fused_train_phase(phase, cfg, **fields):
    """The training path of ``cfg`` (full width, its depth cut), float32
    params, bf16 activations, ``remat="full"``, batch 2, sequence 2048
    (random weights from seed 0, `SyntheticLMDataset` seed 0, the modality
    stubs drawn from seed 0 beside them: `modality_draws`): a snapshot
    over one batch and one unfused step (the warm-up's lr 0), then 2 fused
    SVRG steps against 2 unfused ones, each from the same state: params
    allclose (rtol 1e-5, atol 1e-6), metrics equal, K1 launched once per
    leaf per fused step, K4 never. K1's ms per fused step beside its
    bound. ``fields`` join the record."""
    from repro_torch.config import SVRGConfig, TrainConfig
    from repro_torch.data.synthetic_lm import SyntheticLMDataset
    from repro_torch.models.factory import build_model
    from repro_torch.train.loop import device_batch
    from repro_torch.train.state import (init_train_state, make_snapshot_fns,
                                         make_train_step)
    from repro_torch.utils.tree import tree_leaves, tree_size

    release_memory()
    torch.cuda.reset_peak_memory_stats()
    bundle = build_model(cfg, "cuda")
    # warm-up of one step: step 0's lr is 0, so one unfused step comes
    # before the compared ones
    tcfg = TrainConfig(optimizer="svrg", learning_rate=TRAIN_LR, seed=0,
                       warmup_steps=1,
                       svrg=SVRGConfig(
                           snapshot_batches=TRAIN_SNAPSHOT_BATCHES_FUSED))
    ds = SyntheticLMDataset(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    extra = modality_draws(cfg, TRAIN_BATCH, 0)

    def batch_at(i):
        return device_batch({**ds.batch_at(i), **extra}, "cuda")

    state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                             bundle, tcfg)
    begin, accum, fin = make_snapshot_fns(bundle, tcfg)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    state = begin(state)
    for j in range(TRAIN_SNAPSHOT_BATCHES_FUSED):
        state = accum(state, batch_at(j))
    state = fin(state)
    torch.cuda.synchronize()
    snapshot_s = time.perf_counter() - t0
    state, first = make_train_step(bundle, tcfg)(
        state, batch_at(TRAIN_SNAPSHOT_BATCHES_FUSED))
    snapshot_counts = read_counts()
    leaves = len(tree_leaves(state.params))
    state, compare, fused_counts = fused_vs_unfused(
        bundle, tcfg, state,
        [batch_at(TRAIN_SNAPSHOT_BATCHES_FUSED + 1 + i)
         for i in range(TRAIN_FUSED_STEPS)])
    peak = torch.cuda.max_memory_allocated() / 1e9
    k1_ms, k1_bound, k1_by, torch_ms = k1_over_tree(tcfg, state)
    rec = dict(phase=phase, arch=cfg.name, layers=cfg.num_layers, **fields,
               d_model=cfg.d_model, vocab=cfg.vocab_size,
               params=tree_size(state.params), leaves=leaves,
               batch=TRAIN_BATCH, seq=TRAIN_SEQ, dtype=cfg.dtype,
               param_dtype=cfg.param_dtype, remat=cfg.remat,
               optimizer=tcfg.optimizer, lr=TRAIN_LR,
               snapshot_batches=TRAIN_SNAPSHOT_BATCHES_FUSED,
               snapshot_s=snapshot_s, snapshot_launches=snapshot_counts,
               first_step_loss=float(first["loss"]),
               fused_vs_unfused=compare, fused_launches=fused_counts,
               k1_launches_per_fused_step=fused_counts["svrg_update"]
               / len(compare),
               k1_ms_per_fused_step=k1_ms, k1_bound_ms_per_fused_step=k1_bound,
               k1_bound_by=k1_by, unfused_update_torch_ms=torch_ms,
               peak_memory_gb=peak)
    emit(**rec)
    if not all(np.isfinite(c["metrics_unfused"]["loss"]) for c in compare):
        raise AssertionError(f"{phase}: losses {compare}")
    if snapshot_counts != dict.fromkeys(snapshot_counts, 0):
        raise AssertionError(f"{phase} snapshot launch counts "
                             f"{snapshot_counts}")
    check_fused(compare, fused_counts, leaves, phase)
    return rec


def phase_train_moe():
    """The MoE training path at deepseek-moe-16b's full width, 2 layers
    (the expert leaves [1, 64, 2048, 1408] viewed [numel/1408, 1408] by
    K1; the loss holds the router aux)."""
    from repro_torch.configs import get_config

    cfg = get_config(MOE_ARCH).with_overrides(num_layers=TRAIN_MOE_LAYERS)
    return fused_train_phase(
        "train_moe", cfg, first_dense_layers=cfg.first_dense_layers,
        experts=cfg.num_experts, top_k=cfg.experts_per_token)


# the recurrent families' training shapes: recurrentgemma-2b at 5 layers
# (one group + 2 trailing RG-LRU layers, 1.05 B params), falcon-mamba-7b
# at 2 (0.74 B params); at sequence 2048 each RG-LRU scan takes 4 chunks
# of 512 and each selective scan 8 of 256, rematerialised under grad
TRAIN_RECURRENT = ((HYBRID_ARCH, 5), (SSM_ARCH, 2))


def phase_train_recurrent():
    """Both recurrent families' training paths (`fused_train_phase`);
    returns {family: record}."""
    from repro_torch.configs import get_config

    out = {}
    for arch, layers in TRAIN_RECURRENT:
        cfg = get_config(arch).with_overrides(num_layers=layers)
        out[cfg.family] = fused_train_phase("train_recurrent", cfg,
                                            family=cfg.family)
    return out


def phase_serve_encdec(report):
    """whisper-large-v3 at full width and depth (32 encoder layers over
    1500 frames padded to 1504, 32 decoder layers), prompt 448 (its
    decoder context), its frame embeddings drawn from seed 0: 96
    flash_attention launches per prefill, a third of them with a key
    length of their own (the encoder's 1504 queries over 1500 frames)."""
    from repro_torch.configs import get_config

    release_memory()
    cfg, counts = drive_serve(
        "serve_encdec", ENCDEC_ARCH,
        report["flash_attention"]["encdec"]["per_prefill_ms"],
        prompt=ENCDEC_PROMPT,
        inputs=modality_draws(get_config(ENCDEC_ARCH), SERVE_BATCH, 0))
    if (cfg.encoder_layers, cfg.num_layers, counts["flash_attention"]) != \
            (ENCDEC_LAYERS, ENCDEC_LAYERS, 3 * ENCDEC_LAYERS):
        raise AssertionError(f"serve_encdec: {cfg.encoder_layers} + "
                             f"{cfg.num_layers} layers, {counts}")
    return counts


def phase_serve_vlm(report):
    """llama-3.2-vision-11b at full width and depth (8 groups [self, self,
    self, cross, self]), prompt 2048, its 1601 patch embeddings drawn from
    seed 0: 40 flash_attention launches per prefill (8 of them non-causal
    over the image tokens). As the config draws them, the tanh gates are
    0, so the image path adds nothing to the residual; its work is done
    all the same."""
    from repro_torch.configs import get_config

    release_memory()
    cfg, counts = drive_serve(
        "serve_vlm", VLM_ARCH,
        report["flash_attention"]["vlm"]["per_prefill_ms"],
        inputs=modality_draws(get_config(VLM_ARCH), SERVE_BATCH, 0))
    if (cfg.num_layers, counts["flash_attention"]) != \
            (VLM_SELF_LAYERS + VLM_CROSS_LAYERS,) * 2:
        raise AssertionError(f"serve_vlm: {cfg.num_layers} layers, {counts}")
    return counts


# the encoder-decoder and vision families at a cut depth: whisper-large-v3
# at 2 encoder + 2 decoder layers, llama-3.2-vision-11b at one group (5
# layers); (arch, overrides, prompt)
ENCDEC_VLM_CUT = ((ENCDEC_ARCH, dict(encoder_layers=2, num_layers=2),
                   ENCDEC_PROMPT),
                  (VLM_ARCH, dict(num_layers=5), SERVE_PROMPT))


def phase_serve_encdec_vlm_bf16_vs_plain():
    """Both families at full width and the cut depth, bf16, batch 1, the
    weights drawn as the first layers of the full model's
    (`scale_to_full_depth`), every zero-initialised leaf drawn (the
    vision model's gates non-zero: the image path on), against the plain
    attention in float32, and every kernel call against the float32
    attention of its own inputs (`prefill_kernel_vs_plain`): without
    QK-norm in the self-attention their scores reach the hundreds, where
    bf16's spacing is a unit or more."""
    from repro_torch.configs import get_config

    for seed, (arch, overrides, prompt) in enumerate(ENCDEC_VLM_CUT, 9):
        release_memory()
        full = get_config(arch)
        prefill_kernel_vs_plain(
            "serve_encdec_vlm_bf16_vs_plain", full.with_overrides(**overrides),
            seed, against="float32", prompt=prompt, zeros_drawn=True,
            full_cfg=full)


# the card-vs-CPU limits of `phase_serve_encdec_vlm_card_vs_cpu`, whisper's
# and the vision model's. whisper's logits are 3.7e-4 to 7.8e-4 apart on an
# H100 80GB HBM3 at 700 W since its sinusoid table is built on the CPU for
# both devices; with the table computed on the card, whose float32 exp and
# sin round apart from the CPU's, they were 3.1e-3 to 5.2e-3
# (tools/bisect_encdec.py). Its limit stands 1.5x above the new gaps; the
# vision model keeps `RECURRENT_ATOL`.
ENCDEC_VLM_ATOL = (1.2e-3, RECURRENT_ATOL)


def phase_serve_encdec_vlm_card_vs_cpu():
    """Both families at full width and the cut depth in float32 (K4's
    CUDA-core route: h 64 MHA with the key length of the encoder and the
    cross-attention, h 128 GQA over the image tokens), batch 2, prompts 64
    and 128, 4 new tokens, the weights drawn as the first layers of the
    full model's (`scale_to_full_depth`), every zero-initialised leaf drawn
    (biases, gates, norm scales): logits, greedy tokens and every cache
    leaf (``k``, ``v``, ``xk``, ``xv``, whisper's padded frames included)
    on the card against the CPU, rtol 1e-3, atol `ENCDEC_VLM_ATOL` (of the
    leaf's scale for a cache), each device's distance to a float64 run
    recorded beside, as for the recurrent families. Drawn at the 2-layer
    stack's own std instead, float32 is chaotic here: near-tied softmax
    rows at scores in the thousands (PERF.md §6, the encoder-decoder and vision findings)."""
    from repro_torch.configs import get_config

    for seed, (arch, overrides, _), prompt, atol in zip(
            (11, 12), ENCDEC_VLM_CUT, (64, 128), ENCDEC_VLM_ATOL):
        release_memory()
        full = get_config(arch)
        serve_card_vs_cpu(
            "serve_encdec_vlm_card_vs_cpu",
            full.with_overrides(dtype="float32", **overrides), seed, 2,
            prompt, 4, anchor64=True, zeros_drawn=True, full_cfg=full,
            atol=atol)


# the training shapes: whisper-large-v3 at full depth (32 + 32 layers,
# 1.54 B params), llama-3.2-vision-11b at one group (5 layers, 2.1 B
# params, half of them the two [128256, 4096] embeddings)
TRAIN_ENCDEC_VLM = ((ENCDEC_ARCH, {}), (VLM_ARCH, dict(num_layers=5)))


def phase_train_encdec_vlm():
    """Both families' training paths (`fused_train_phase`); returns
    {family: record}."""
    from repro_torch.configs import get_config

    out = {}
    for arch, overrides in TRAIN_ENCDEC_VLM:
        cfg = get_config(arch).with_overrides(**overrides)
        out[cfg.family] = fused_train_phase(
            "train_encdec_vlm", cfg, family=cfg.family,
            encoder_layers=cfg.encoder_layers)
    return out


def phase_train_card_vs_cpu():
    """The reduced gemma3-4b at 2 layers (one window-8 layer, one global),
    float32, batch 4, sequence 64: one snapshot over 2 batches and 3 SVRG
    steps on the card and on the CPU from the same state (drawn on the CPU,
    copied to the card): loss per step rtol 1e-4, params atol 1e-5."""
    from repro_torch.config import SVRGConfig, TrainConfig
    from repro_torch.configs import reduced_config
    from repro_torch.data.synthetic_lm import SyntheticLMDataset
    from repro_torch.models.factory import build_model
    from repro_torch.train.loop import device_batch
    from repro_torch.train.state import (init_train_state, make_snapshot_fns,
                                         make_train_step)
    from repro_torch.utils.tree import tree_leaves, tree_map

    cfg = reduced_config(TRAIN_ARCH).with_overrides(num_layers=2,
                                                    global_every=2)
    tcfg = TrainConfig(steps=3, optimizer="svrg", learning_rate=0.05,
                       warmup_steps=1, svrg=SVRGConfig(snapshot_batches=2))
    ds = SyntheticLMDataset(cfg.vocab_size, 64, 4, seed=0)
    cpu_state = init_train_state(torch.Generator().manual_seed(0),
                                 build_model(cfg, "cpu"), tcfg)
    results = {}
    for device in ("cuda", "cpu"):
        bundle = build_model(cfg, device)
        state = tree_map(lambda t: t.to(device), cpu_state)
        begin, accum, fin = make_snapshot_fns(bundle, tcfg)
        step = make_train_step(bundle, tcfg)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        state = begin(state)
        for j in range(tcfg.svrg.snapshot_batches):
            state = accum(state, device_batch(ds.batch_at(j), device))
        state = fin(state)
        losses = []
        for i in range(tcfg.steps):
            state, m = step(state, device_batch(ds.batch_at(i + 1), device))
            losses.append(m["loss"])
        losses = [float(x) for x in losses]
        torch.cuda.synchronize()
        results[device] = (losses, [x.cpu() for x in tree_leaves(state.params)],
                           time.perf_counter() - t0, read_counts())
    (l_card, p_card, card_s, counts), (l_cpu, p_cpu, cpu_s, _) = \
        results["cuda"], results["cpu"]
    gap = float(np.max(np.abs(np.subtract(l_card, l_cpu)) / np.abs(l_cpu)))
    dp = max(float((a - b).abs().max()) for a, b in zip(p_card, p_cpu))
    rec = dict(phase="train_card_vs_cpu", arch=cfg.name, layers=cfg.num_layers,
               d_model=cfg.d_model, dtype=cfg.dtype, batch=4, seq=64,
               steps=tcfg.steps, losses_card=l_card, losses_cpu=l_cpu,
               loss_rel_gap=gap, max_abs_param_gap=dp, rtol_loss=1e-4,
               atol_params=1e-5, launches_card=counts, card_s=card_s,
               cpu_s=cpu_s)
    emit(**rec)
    if not (gap <= 1e-4 and dp <= 1e-5 and np.all(np.isfinite(l_card))):
        raise AssertionError(f"training on the card and the CPU disagree: "
                             f"{rec}")
    if counts != {"svrg_update": 0, "logreg_grad": 0, "sweep_epoch": 0,
                  "flash_attention": 0}:
        raise AssertionError(f"train_card_vs_cpu launch counts {counts}")


# phase `dryrun`: the dry-run's memory estimate at HOST_MESH against the
# card's peak, at the `train` phase's shape and the `serve` phase's prefill
# and one decode token from its cache; and one full-size cell over the fake
# (16, 16) world, in a process of its own, last
DRYRUN_TOL = 0.10               # |estimate - max_memory_allocated| / measured
DRYRUN_CELL_DEADLINE_S = 300.0  # the fake-world cells, from their start
DRYRUN_OUT = ROOT / "build" / "dryrun_smoke"


# falcon-mamba-7b's train_4k step cut to 2 layers (plain SGD, one
# microbatch) on a fake mesh, traced in a process of its own: its
# channel-sharded residual once failed the backward pass on both meshes
# (the full 64-layer cell traces for many minutes on one core)
DRYRUN_SSM_CELL = """
import json, sys
from repro_torch.configs import get_config
from repro_torch.config import SHAPE_GRID
from repro_torch.launch import dryrun
mesh = dryrun.cell_mesh(sys.argv[1])
cfg = get_config(sys.argv[2]).with_overrides(num_layers=2)
rec = dryrun.trace_cell(cfg, SHAPE_GRID["train_4k"], mesh, variant="sgd",
                        microbatches=1)
rec.update(status="ok", num_devices=mesh.size(), num_layers=2)
print("CELL " + json.dumps(rec))
"""


def run_dryrun_cells():
    """Trace, side by side and each in a process of its own with no card
    visible to it (their tensors are fake; each makes its world in its own
    process): gemma3-4b's full-size train_4k cell over the fake (16, 16)
    world through ``python -m repro_torch.launch.dryrun``, and
    falcon-mamba-7b's train_4k cell cut to 2 layers over both fake meshes
    (`DRYRUN_SSM_CELL`). Returns their records with their wall times. They
    run after every timed phase, so no timing shares the host with them;
    each is killed at the deadline."""
    import os
    import shutil

    shutil.rmtree(DRYRUN_OUT, ignore_errors=True)
    DRYRUN_OUT.mkdir(parents=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    commands = {SERVE_ARCH: [
        sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
        SERVE_ARCH, "--shape", "train_4k", "--mesh", "single", "--out",
        str(DRYRUN_OUT)]}
    for mesh in ("single", "multi"):
        commands[f"{SSM_ARCH} {mesh}"] = [sys.executable, "-c",
                                          DRYRUN_SSM_CELL, mesh, SSM_ARCH]
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for name, cmd in commands.items()}
    records = {}
    try:
        for name, proc in procs.items():
            left = DRYRUN_CELL_DEADLINE_S - (time.perf_counter() - t0)
            try:
                output, _ = proc.communicate(timeout=max(left, 1.0))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"dryrun: the fake-world cell {name} "
                                     f"ran past {DRYRUN_CELL_DEADLINE_S} s"
                                     ) from None
            path = DRYRUN_OUT / f"single__{SERVE_ARCH}__train_4k.json"
            lines = [x for x in output.splitlines() if x.startswith("CELL ")]
            if name == SERVE_ARCH and path.exists():
                rec = json.loads(path.read_text())
            elif name != SERVE_ARCH and proc.returncode == 0 and lines:
                rec = json.loads(lines[-1][5:])
            else:
                raise AssertionError(f"dryrun: no record of {name} (exit "
                                     f"{proc.returncode}): {output[-2000:]}")
            rec["wall_s"] = time.perf_counter() - t0
            records[name] = rec
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(10)
    return records


def phase_dryrun():
    """Trace gemma3-4b at HOST_MESH at three shapes (the `train` phase's:
    12 layers, batch 2, sequence 2048, unfused SVRG, one microbatch; the
    `serve` phase's prefill: 34 layers, batch 4, prompt 2048, bf16; one
    decode token from that cache), no launch; then run each once on the
    card from `reset_peak_memory_stats` with random weights from a seed:
    the estimate within DRYRUN_TOL of `max_memory_allocated` (both with
    the step's inputs; the allocator's 512-byte rounding counted), the real
    prefill 34 flash_attention launches. Then gemma3-4b's full-size
    train_4k cell over the fake (16, 16) world and falcon-mamba-7b's, cut
    to 2 layers, over both fake meshes run side by side
    (`run_dryrun_cells`) and must come back ok."""
    from repro_torch.config import ShapeConfig, SVRGConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models.factory import build_model
    from repro_torch.sharding.rules import init_from_defs
    from repro_torch.train.state import init_train_state, make_train_step

    host = dryrun.cell_mesh("host")
    train_cfg = get_config(TRAIN_ARCH).with_overrides(num_layers=TRAIN_LAYERS)
    serve_cfg = get_config(SERVE_ARCH)
    shapes = {
        "train": (train_cfg, ShapeConfig("train", "train", TRAIN_SEQ,
                                         TRAIN_BATCH)),
        "prefill": (serve_cfg, ShapeConfig("prefill", "prefill",
                                           SERVE_PROMPT, SERVE_BATCH)),
        "decode": (serve_cfg, ShapeConfig("decode", "decode", SERVE_PROMPT,
                                          SERVE_BATCH))}
    estimate, trace_s = {}, {}
    reset_counts()
    for name, (cfg, shape) in shapes.items():
        t0 = time.perf_counter()
        estimate[name] = dryrun.trace_cell(cfg, shape, host, "svrg",
                                           microbatches=1)["memory"]
        trace_s[name] = time.perf_counter() - t0
    trace_counts = read_counts()

    measured = {}
    release_memory()
    base = torch.cuda.memory_allocated()
    bundle = build_model(train_cfg, "cuda")
    tcfg = TrainConfig(optimizer="svrg", learning_rate=1e-3, microbatches=1,
                       svrg=SVRGConfig())
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = init_train_state(gen, bundle, tcfg)
    batch = bundle.make_inputs(TRAIN_BATCH, TRAIN_SEQ, gen)
    step = make_train_step(bundle, tcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    measured["train"] = torch.cuda.max_memory_allocated() - base
    train_loss = float(metrics["loss"])
    del state, batch, metrics, step, bundle
    release_memory()

    base = torch.cuda.memory_allocated()
    bundle = build_model(serve_cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = bundle.cast(init_from_defs(gen, bundle.param_defs))
    batch = bundle.make_inputs(SERVE_BATCH, SERVE_PROMPT, gen)
    release_memory()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    logits, cache = bundle.prefill_fn(params, batch, SERVE_PROMPT)
    torch.cuda.synchronize()
    measured["prefill"] = torch.cuda.max_memory_allocated() - base
    prefill_counts = read_counts()
    tokens = logits.argmax(-1).to(torch.int32)
    del logits, batch
    release_memory()
    torch.cuda.reset_peak_memory_stats()
    logits, cache = bundle.decode_fn(params, cache, tokens, SERVE_PROMPT - 1)
    torch.cuda.synchronize()
    measured["decode"] = torch.cuda.max_memory_allocated() - base
    finite = bool(torch.isfinite(logits).all()) and np.isfinite(train_loss)
    del params, cache, logits, tokens, bundle
    release_memory()

    gap = {name: (estimate[name]["peak_allocator_bytes"] - measured[name])
           / measured[name] for name in shapes}
    fakes = run_dryrun_cells()
    rec = dict(phase="dryrun", arch=SERVE_ARCH,
               estimate_gb={n: e["peak_allocator_bytes"] / 1e9
                            for n, e in estimate.items()},
               estimate_exact_gb={n: e["peak_per_device_bytes"] / 1e9
                                  for n, e in estimate.items()},
               argument_gb={n: e["argument_bytes"] / 1e9
                            for n, e in estimate.items()},
               measured_gb={n: m / 1e9 for n, m in measured.items()},
               rel_gap=gap, tolerance=DRYRUN_TOL, trace_s=trace_s,
               trace_launches=trace_counts, prefill_launches=prefill_counts,
               train_loss=train_loss,
               fake_world_cells={name: {k: fake.get(k) for k in (
                   "status", "error", "num_devices", "num_layers", "memory",
                   "cost", "collectives", "t_trace_s", "wall_s",
                   "params_total", "model_flops")}
                   for name, fake in fakes.items()})
    emit(**rec)
    if any(trace_counts.values()):
        raise AssertionError(f"dryrun: the traces launched {trace_counts}")
    if prefill_counts["flash_attention"] != serve_cfg.num_layers:
        raise AssertionError(f"dryrun: the real prefill launched "
                             f"{prefill_counts}")
    if not finite:
        raise AssertionError("dryrun: a real step gave non-finite values")
    bad = {n: g for n, g in gap.items() if abs(g) > DRYRUN_TOL}
    if bad:
        raise AssertionError(f"dryrun: estimates off the card's peaks: {bad} "
                             f"(estimate {rec['estimate_gb']}, measured "
                             f"{rec['measured_gb']})")
    bad = {name: {k: fake.get(k) for k in ("status", "error")}
           for name, fake in fakes.items() if fake.get("status") != "ok"}
    if bad:
        raise AssertionError(f"dryrun: the fake-world cells: {bad}")
    return rec


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

    phase_analysis()

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
    batched, batched_s = phase_sweep(obj)
    emit(phase="run_sweep_done", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    fused_counts, fused, fused_s = phase_sweep_fused(obj, batched, batched_s)
    emit(phase="run_sweep_fused_done", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    phase_obs(obj, batched, batched_s, fused, fused_s)
    emit(phase="obs_done", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    service = phase_service(obj)
    emit(phase="service_done", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    objectives, ncv, k2_clipped, k3_clipped = phase_objectives(ds)
    emit(phase="objectives_done", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    mlp_fused = phase_objectives_mlp_fused()
    emit(phase="objectives_mlp_fused_done", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    server = phase_server(obj, ncv)
    del ncv
    emit(phase="server_done", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    sharding = phase_sharding(obj, fused, fused_s)
    emit(phase="sharding_done", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    serve_counts = phase_serve(report)
    emit(phase="serve_done", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    phase_serve_bf16_vs_plain()
    emit(phase="serve_bf16_vs_plain_done", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    phase_serve_card_vs_cpu()
    emit(phase="serve_card_vs_cpu_done", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    train_rec = phase_train()
    emit(phase="train_done", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    phase_train_card_vs_cpu()
    emit(phase="train_card_vs_cpu_done", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    moe_counts = phase_serve_moe(report)
    emit(phase="serve_moe_done", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    phase_serve_moe_bf16_vs_plain()
    emit(phase="serve_moe_bf16_vs_plain_done", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    phase_serve_moe_card_vs_cpu()
    emit(phase="serve_moe_card_vs_cpu_done", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    train_moe_rec = phase_train_moe()
    emit(phase="train_moe_done", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    hybrid_counts = phase_serve_hybrid(report)
    emit(phase="serve_hybrid_done", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    phase_serve_hybrid_bf16_vs_plain()
    emit(phase="serve_hybrid_bf16_vs_plain_done",
         seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    phase_serve_ssm()
    emit(phase="serve_ssm_done", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    phase_serve_recurrent_card_vs_cpu()
    emit(phase="serve_recurrent_card_vs_cpu_done",
         seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    train_recurrent = phase_train_recurrent()
    emit(phase="train_recurrent_done", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    encdec_counts = phase_serve_encdec(report)
    emit(phase="serve_encdec_done", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    vlm_counts = phase_serve_vlm(report)
    emit(phase="serve_vlm_done", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    phase_serve_encdec_vlm_bf16_vs_plain()
    emit(phase="serve_encdec_vlm_bf16_vs_plain_done",
         seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    phase_serve_encdec_vlm_card_vs_cpu()
    emit(phase="serve_encdec_vlm_card_vs_cpu_done",
         seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    train_encdec_vlm = phase_train_encdec_vlm()
    emit(phase="train_encdec_vlm_done", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    phase_dryrun()
    emit(phase="dryrun_done", seconds=time.perf_counter() - t0)

    replaces = {"svrg_update": "src/repro/kernels/svrg_update/kernel.py:23",
                "logreg_grad": "src/repro/kernels/logreg_grad/kernel.py:31",
                "sweep_epoch": "src/repro/kernels/sweep_epoch/kernel.py:92",
                "flash_attention": "src/repro/kernels/flash_attention/kernel.py:33"}
    # launches: each kernel's count in the run of its path — run_asysvrg for
    # svrg_update and logreg_grad, the fused run_sweep for sweep_epoch, the
    # gemma3-4b serve run for flash_attention (deepseek-moe-16b's beside it)
    launches = {**counts, "sweep_epoch": fused_counts["sweep_epoch"],
                "flash_attention": serve_counts["flash_attention"]}
    # flash_attention: the tensor-core kernel, the route of every launch on
    # the serve path (the CUDA-core one keeps float32)
    sources = {"flash_attention": "flash_attention_wgmma"}
    kernels = []
    for name in ("svrg_update", "logreg_grad", "sweep_epoch", "flash_attention"):
        rec = report[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{sources.get(name, name)}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": rec.get("library_ms")})
        for extra in ("kernel_route", "yardstick_ms", "bare_ms"):
            if extra in rec:
                kernels[-1][extra] = rec[extra]
    # K1 on the training path too: launches and time per fused step over
    # the 12-layer tree, and alone at tok_embed's shape
    kernels[0].update(
        train_launches_per_fused_step=train_rec["k1_launches_per_fused_step"],
        train_ms_per_fused_step=train_rec["k1_ms_per_fused_step"],
        train_bound_ms_per_fused_step=train_rec["k1_bound_ms_per_fused_step"],
        train_torch_ms_per_fused_step=train_rec["unfused_update_torch_ms"],
        tok_embed_ms=train_rec["tok_embed"]["ms"],
        tok_embed_plain_ms=train_rec["tok_embed"]["plain_ms"],
        tok_embed_bound_ms=train_rec["tok_embed"]["bound_ms"],
        moe_train_launches_per_fused_step=train_moe_rec[
            "k1_launches_per_fused_step"],
        moe_train_ms_per_fused_step=train_moe_rec["k1_ms_per_fused_step"],
        moe_train_bound_ms_per_fused_step=train_moe_rec[
            "k1_bound_ms_per_fused_step"])
    for family, rec in {**train_recurrent, **train_encdec_vlm}.items():
        kernels[0].update({
            f"{family}_train_launches_per_fused_step":
                rec["k1_launches_per_fused_step"],
            f"{family}_train_ms_per_fused_step": rec["k1_ms_per_fused_step"],
            f"{family}_train_bound_ms_per_fused_step":
                rec["k1_bound_ms_per_fused_step"]})
    # K2 and K3 on the service path: launches in its first flush (2 groups,
    # one fused, over 2 epochs)
    for i, name in ((1, "logreg_grad"), (2, "sweep_epoch")):
        kernels[i]["service_launches_per_flush"] = \
            service["first_flush"]["launches"][name]
    # K1, K2 and K3 on the row-sharded sweeps (phase `sharding`): each
    # rank's launches in the fused grid at full rcv1 and in the batched
    # grid at a tenth of its rows, 2 ranks sharing the card
    for i, name in enumerate(("svrg_update", "logreg_grad", "sweep_epoch")):
        kernels[i]["sharded_launches_per_rank"] = {
            mode: [r[f"{mode}_launches"][name] for r in sharding["ranks"]]
            for mode in ("fused", "batched")}
    # K2 and K3 with the clipped penalty (NonconvexLogistic, phase
    # `objectives`): each against its plain version, timed at the L2 case's
    # shape beside its own bound; launches in the fused 5-row sweep, and in
    # the server phase
    for i, name, rec in ((1, "logreg_grad", k2_clipped),
                         (2, "sweep_epoch", k3_clipped)):
        kernels[i].update({f"clipped_{key}": rec[key] for key in (
            "ms", "bound_ms", "bound_by", "max_abs_err") if key in rec})
        kernels[i]["clipped_launches"] = \
            objectives["fused_launches"][name]
        kernels[i]["server_launches"] = server["launches"][name]
    kernels[1]["clipped_plain_ms"] = k2_clipped["plain_ms"]
    kernels[2]["clipped_us_per_update"] = k3_clipped["us_per_update"]
    kernels[2]["clipped_plain_ms_per_update"] = \
        k3_clipped["plain_ms_per_update"]
    # K4 on the deepseek-moe-16b serve path too: launches per prefill, and
    # its time at that shape beside SDPA and the bound
    moe_k4 = report["flash_attention"]["moe"]
    kernels[3].update(
        moe_launches_per_prefill=moe_counts["flash_attention"],
        moe_ms=moe_k4["ms"], moe_plain_ms=moe_k4["plain_ms"],
        moe_library_ms=moe_k4["library_ms"], moe_bound_ms=moe_k4["bound_ms"],
        moe_max_abs_err=moe_k4["max_abs_err"])
    # and on the recurrentgemma-2b serve path: 8 launches a prefill
    hybrid_k4 = report["flash_attention"]["hybrid"]
    kernels[3].update(
        hybrid_launches_per_prefill=hybrid_counts["flash_attention"],
        hybrid_ms=hybrid_k4["ms"], hybrid_plain_ms=hybrid_k4["plain_ms"],
        hybrid_library_ms=hybrid_k4["library_ms"],
        hybrid_bound_ms=hybrid_k4["bound_ms"],
        hybrid_max_abs_err=hybrid_k4["max_abs_err"])
    # and on the whisper-large-v3 and llama-3.2-vision-11b serve paths:
    # launches per prefill, and the time of each part at its shape (the
    # whisper encoder's and both vision cases are the ones a key length of
    # its own or GQA at h 128 made new)
    k4 = report["flash_attention"]
    kernels[3].update(
        encdec_launches_per_prefill=encdec_counts["flash_attention"],
        vlm_launches_per_prefill=vlm_counts["flash_attention"],
        encdec_per_prefill_ms=k4["encdec"]["per_prefill_ms"],
        vlm_per_prefill_ms=k4["vlm"]["per_prefill_ms"])
    for family in ("encdec", "vlm"):
        for part, rec in k4[family].items():
            if isinstance(rec, dict):
                kernels[3].update({
                    f"{family}_{part}_{key}": rec[key] for key in (
                        "ms", "plain_ms", "library_ms", "bound_ms",
                        "max_abs_err")})
    # the MLP objective's own sweep kernel (phase `objectives_mlp_fused`):
    # its launches in the fused MLP run at the frontier widths, its epoch
    # launch at that run's shape beside its plain version and bound
    kernels.append({
        "name": "sweep_epoch_mlp", "route": "cuda",
        "source": "src/repro_torch/csrc/sweep_epoch_mlp.cu",
        "replaces": "src/repro/kernels/sweep_epoch/kernel.py:92",
        **{key: mlp_fused[key] for key in (
            "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "equal_bits", "back_to_back_ms",
            "defaults_back_to_back_ms", "uncached_ms",
            "defaults_uncached_ms", "defaults_ms",
            "defaults_plain_ms", "defaults_bound_ms", "defaults_launches",
            "full_grad_ms", "defaults_full_grad_ms", "full_grad_plain_ms",
            "defaults_full_grad_plain_ms", "wide_ms", "wide_updates",
            "wide_bound_ms", "wide_plain_ms", "fused_s_per_epoch",
            "batched_s_per_epoch", "defaults_fused_s_per_epoch",
            "defaults_batched_s_per_epoch", "sample_grad_max_abs_err")}})
    emit(phase="total", seconds=time.perf_counter() - t_all)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
