"""The analytic roofline of the sweep engine, the port of the analytic half
of `repro.launch.roofline`.

`sweep_epoch_roofline` counts the operations and the bytes of one
(rows × epochs × M̃) group for both engine paths, the batched rows and the
fused sweep-epoch kernel, and `attained_fraction` divides the path's
lower bound by a measured wall time: what the performance ledger
(`repro_torch.obs.ledger`) records per group. Both are arithmetic on the
group's shape, the JAX package's formulas unchanged; the default hardware
is the H100 (`repro_torch.config.H100_SXM`).

Not ported: the reference's HLO and jaxpr parsers (`_shape_bytes`,
`jaxpr_cost`, the collective scan of compiled HLO) and `roofline_terms`,
which reads a dry-run record built from them. They read XLA's compiled
artifacts, which a torch program does not have.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.config import H100_SXM, HardwareSpec


def sweep_epoch_roofline(*, rows: int, dim: int, total: int, epochs: int,
                         buf_len: int, hw: HardwareSpec = H100_SXM,
                         dtype_bytes: int = 4) -> Dict:
    """Arithmetic-intensity headroom of the fused sweep-epoch kernel over
    the batched engine for one (rows × epochs × M̃) group.

    Both paths run the same operations — per update, two component
    gradients (~2·2·dim each for the dot + axpy shape of the repo's
    objectives) plus the control-variate combine (~3·dim), ≈ 11·dim. What
    differs is the device-memory traffic per update:

      * batched: the iterate ``w``, the key + loss slot and the
        ``buf_len``-deep delay ring are read AND written through device
        memory every update, so bytes/update ≈ 2·(buf_len + 2)·dim·b plus
        the sampled data row.
      * fused: the state lives on chip for the whole (row × epoch); only
        the sampled data row moves per update, with the per-row boundary
        I/O (w0 in, w_fin + history out) amortised over epochs·M̃ updates.

    At ~2.75 operations per byte (fused) the inner loop is memory-bound
    against every peak of ``hw``. Returns both paths' terms.
    """
    updates = float(rows) * epochs * total
    flops_per_update = 11.0 * dim
    flops = updates * flops_per_update
    row_bytes = dim * dtype_bytes                       # sampled data row
    carry_bytes = 2.0 * (buf_len + 2) * dim * dtype_bytes
    boundary = rows * dtype_bytes * (2.0 * dim + epochs + 1)

    out: Dict = {"rows": rows, "dim": dim, "total": total, "epochs": epochs,
                 "buf_len": buf_len, "flops": flops}
    for path, bytes_ in (("vmap", updates * (row_bytes + carry_bytes)
                          + boundary),
                         ("fused", updates * row_bytes + boundary)):
        t_compute = flops / hw.peak_flops_bf16
        t_memory = bytes_ / hw.hbm_bandwidth
        out[path] = {
            "bytes": bytes_,
            "intensity_flops_per_byte": flops / bytes_,
            "t_compute_s": t_compute,
            "t_memory_s": t_memory,
            "step_lower_bound_s": max(t_compute, t_memory),
            "dominant": "compute" if t_compute >= t_memory else "memory",
        }
    out["intensity_headroom"] = (
        out["fused"]["intensity_flops_per_byte"]
        / out["vmap"]["intensity_flops_per_byte"])
    out["predicted_speedup"] = (out["vmap"]["step_lower_bound_s"]
                                / out["fused"]["step_lower_bound_s"])
    return out


def attained_fraction(*, rows: int, dim: int, total: int, epochs: int,
                      buf_len: int, fused: bool, wall_s: float,
                      hw: HardwareSpec = H100_SXM) -> Dict:
    """Attained-vs-roofline fraction for one MEASURED group dispatch: the
    lower bound of the group's path (batched or fused) of
    :func:`sweep_epoch_roofline` over the measured wall time. A
    utilisation only where ``hw`` is the machine that ran the group (a CPU
    run against the H100's figures is a cross-hardware ratio)."""
    rf = sweep_epoch_roofline(rows=rows, dim=dim, total=total,
                              epochs=epochs, buf_len=buf_len, hw=hw)
    path = rf["fused" if fused else "vmap"]
    return {
        "roofline_s": path["step_lower_bound_s"],
        "attained_frac": (path["step_lower_bound_s"] / wall_s
                          if wall_s > 0 else 0.0),
        "flops": rf["flops"],
        "bytes": path["bytes"],
        "dominant": path["dominant"],
    }
