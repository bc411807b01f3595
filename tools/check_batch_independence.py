#!/usr/bin/env python3
"""Does a sweep row's result on the card depend on the rows it runs with?

    python3 tools/check_batch_independence.py

At the rcv1 width (n = 20242, p = 2048), computes each piece of the AsySVRG
inner loop for the 4 rows of `chip_smoke.py`'s sweep group at once and for
each row alone, and compares the bits: the snapshot gradient (`logreg_grad`),
the loss, the sample gradient of one step ([C] indices) and of a chunk of
steps ([L, C]), the ring-buffer gather and the `svrg_update` kernel. Then
4096 inner updates of `repro_torch.core.asysvrg._epoch_core` for the group
against each row alone, and the same group run twice (run-to-run
determinism), with the wall time per update of each run; and, for each
row, the first inner step at which its sample or anchor gradient in the
group differs from the row alone, with that gradient recomputed from the
recorded inputs.

Each check runs twice: with the engine as it is, whose sample gradient sums
the margin x·w in float64 (``float64_margin``), and with that margin summed
in float32 as torch does by default (``float32_margin``), the form that made
a row differ alone and in its group. One JSON line per check, the card's
name and power limit first. Needs a CUDA device; fails without one.
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
STEPS = 4096
GROUP = (("inconsistent", 7), ("consistent", 7), ("unlock", 7), ("consistent", 0))


def sample_grad_float32_margin(X, y, l2, w, i):
    """`objective.sample_grad_stable` with the margin summed in float32."""
    x = X[i]
    yi = y[i]
    z = torch.sum(x * w, dim=-1)
    s = torch.sigmoid((-yi * z).to(torch.float64)).to(torch.float32)
    return (-yi * s)[..., None] * x + l2 * w


def _emit(**fields):
    print(json.dumps(fields), flush=True)


def _alone_vs_group(variant, name, fn, C, axis):
    """``fn(rows)`` computes a piece for the rows of the slice ``rows``, with
    the rows along ``axis`` of its result: all C rows at once against each
    row alone."""
    group = fn(slice(None))
    diffs = []
    for c in range(C):
        alone = fn(slice(c, c + 1)).select(axis, 0)
        diffs.append(float((group.select(axis, c) - alone).abs().max()))
    _emit(variant=variant, check=name, bits_equal=all(d == 0.0 for d in diffs),
          max_abs_diff_per_row=diffs)


def _epoch(obj, rows, keys):
    from repro_torch.core.asysvrg import SCHEME_IDS, _epoch_core

    C = len(rows)
    w = torch.zeros((C, obj.p), device="cuda")
    eta = torch.full((C,), 2.0, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = _epoch_core(obj, obj.data_args(), w, keys, eta, [t for _, t in rows],
                      [SCHEME_IDS[s] for s, _ in rows],
                      [1 if t else 0 for _, t in rows], total=STEPS, buf_len=8,
                      option=1, drop_prob=0.02)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) / STEPS


def _recorded_epoch(obj, rows, keys):
    """`_epoch` with every sample-gradient call recorded, per inner step:
    the step's (read iterate, index, gradient) and the anchor gradient g0
    of its chunk."""
    from repro_torch.core import objective

    real = objective.sample_grad_stable
    steps, anchors = [], []

    def recording(X, y, l2, w, i):
        out = real(X, y, l2, w, i)
        if i.dim() == 1:
            steps.append((w.clone(), i.clone(), out))
        else:
            anchors.extend(out.unbind(0))
        return out

    objective.sample_grad_stable = recording
    try:
        _epoch(obj, rows, keys)
    finally:
        objective.sample_grad_stable = real
    return steps, anchors


def _first_divergence(obj, keys, c):
    """Row c in the group against row c alone: the first inner step whose
    sample gradient (g) or anchor gradient (g0) differs, whether that
    step's inputs were equal, and the same gradient recomputed from the
    group's recorded inputs for all rows and for row c alone."""
    from repro_torch.core.objective import sample_grad_stable

    X, y, l2 = obj.data_args()
    g_steps, g_anchors = _recorded_epoch(obj, GROUP, keys)
    a_steps, a_anchors = _recorded_epoch(obj, GROUP[c:c + 1], keys[c:c + 1])
    for j in range(STEPS):
        (gw, gi, gg), (aw, ai, ag) = g_steps[j], a_steps[j]
        g0_equal = bool(torch.equal(g_anchors[j][c], a_anchors[j][0]))
        if torch.equal(gg[c], ag[0]) and g0_equal:
            continue
        group_again = sample_grad_stable(X, y, l2, gw, gi)[c]
        alone_again = sample_grad_stable(X, y, l2, gw[c:c + 1], gi[c:c + 1])[0]
        return dict(row=c, step=j, g0_equal=g0_equal,
                    g_equal=bool(torch.equal(gg[c], ag[0])),
                    inputs_equal=bool(torch.equal(gw[c], aw[0])
                                      and torch.equal(gi[c], ai[0])),
                    recomputed_group_equals_recorded=bool(
                        torch.equal(group_again, gg[c])),
                    recomputed_alone_equals_recorded=bool(
                        torch.equal(alone_again, ag[0])),
                    recomputed_alone_equals_group=bool(
                        torch.equal(alone_again, group_again)))
    return dict(row=c, step=None)


def main() -> int:
    if not torch.cuda.is_available():
        print("check_batch_independence: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import LogisticRegression, prng
    from repro_torch.core import asysvrg, objective
    from repro_torch.data.libsvm import make_synthetic_libsvm
    from repro_torch.kernels.logreg_grad.ops import logreg_grad
    from repro_torch.kernels.svrg_update.ops import svrg_update

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip(),
        flush=True)
    ds = make_synthetic_libsvm("rcv1", scale=1.0)
    obj = LogisticRegression(ds.X, ds.y, ds.l2_reg)
    X, y, l2 = obj.data_args()
    C = len(GROUP)
    gen = torch.Generator(device="cuda").manual_seed(0)
    W = 0.1 * torch.randn((C, obj.p), generator=gen, device="cuda")
    idx_step = torch.randint(0, obj.n, (C,), generator=gen, device="cuda")
    idx_chunk = torch.randint(0, obj.n, (512, C), generator=gen, device="cuda")
    buffer = torch.randn((C, 8, obj.p), generator=gen, device="cuda")
    slots = torch.randint(0, 8, (C, obj.p), generator=gen, device="cuda")
    G, G0, GF = (torch.randn((C, obj.p), generator=gen, device="cuda")
                 for _ in range(3))
    lr = torch.rand(C, generator=gen, device="cuda")
    keys = prng.split(prng.PRNGKey(0, "cuda"), C)

    original = objective.sample_grad_stable
    for variant, sample_grad in (("float64_margin", original),
                                 ("float32_margin", sample_grad_float32_margin)):
        objective.sample_grad_stable = sample_grad
        checks = (
            ("logreg_grad", 0,
             lambda r: logreg_grad(X, y, W[r].contiguous(), l2)),
            ("loss", 0, lambda r: objective.loss_fixed_order(X, y, l2, W[r])),
            ("sample_grad_step", 0,
             lambda r: sample_grad(X, y, l2, W[r], idx_step[r])),
            ("sample_grad_chunk", 1,
             lambda r: sample_grad(X, y, l2, W[r], idx_chunk[:, r])),
            ("gather", 0, lambda r: asysvrg._gather_read(buffer[r], slots[r])),
            ("svrg_update", 0, lambda r: svrg_update(
                *(t[r].contiguous() for t in (W, G, G0, GF, lr)))),
        )
        for name, axis, fn in checks:
            _alone_vs_group(variant, name, fn, C, axis)

        group, s_group = _epoch(obj, GROUP, keys)
        again, _ = _epoch(obj, GROUP, keys)
        diffs, s_alone = [], []
        for c in range(C):
            alone, s = _epoch(obj, GROUP[c:c + 1], keys[c:c + 1])
            diffs.append(float((group[c] - alone[0]).abs().max()))
            s_alone.append(s)
        _emit(variant=variant, check="epoch", steps=STEPS,
              bits_equal=all(d == 0.0 for d in diffs),
              max_abs_diff_per_row=diffs,
              run_to_run_bits_equal=bool(torch.equal(group, again)),
              s_per_update_group=s_group, s_per_update_alone=s_alone)
        for c in range(C):
            _emit(variant=variant, check="first_divergence",
                  **_first_divergence(obj, keys, c))
    objective.sample_grad_stable = original
    return 0


if __name__ == "__main__":
    sys.exit(main())
