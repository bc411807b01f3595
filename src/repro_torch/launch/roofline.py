"""The analytic roofline, the port of the analytic half of
`repro.launch.roofline`, and the three roofline terms of a dry-run record.

`sweep_epoch_roofline` counts the operations and the bytes of one
(rows × epochs × M̃) group for both engine paths, the batched rows and the
fused sweep-epoch kernel, and `attained_fraction` divides the path's
lower bound by a measured wall time: what the performance ledger
(`repro_torch.obs.ledger`) records per group. `count_params`,
`attention_flops` and `model_flops` are the useful-work count of an LM
cell (6·N·D to train, 2·N·D to serve, plus the attention term), formula
for formula the JAX package's. `roofline_terms` reads one record of
`repro_torch.launch.dryrun` (or of the JAX package's dry-run) into its
compute, memory and collective times. The default hardware is the H100
(`repro_torch.config.H100_SXM`).

Not ported: the reference's HLO and jaxpr parsers (`_shape_bytes`,
`jaxpr_cost`, the collective scan of compiled HLO). They read XLA's
compiled artifacts, which a torch program does not have; their
counterparts are the dry-run's dispatch-mode counters, which see every
operation rank 0 runs (`repro_torch.launch.dryrun.Recorder`).
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.config import H100_SXM, HardwareSpec, ModelConfig, ShapeConfig

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")


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


# ---------------------------------------------------------------------------
# Analytic useful-work FLOPs
# ---------------------------------------------------------------------------

def count_params(cfg: ModelConfig, defs) -> Tuple[int, int]:
    """(total, active) param counts from the ParamDef tree: a leaf whose
    path holds "moe" but neither "shared" nor "router" counts
    ``experts_per_token / num_experts`` of its size as active."""
    from repro_torch.sharding.rules import is_param_def
    from repro_torch.utils.tree import tree_flatten_with_path

    total = 0
    active = 0
    frac = 1.0
    if cfg.num_experts > 0:
        frac = cfg.experts_per_token / cfg.num_experts
    for key, d in tree_flatten_with_path(defs, is_leaf=is_param_def):
        n = 1
        for s in d.shape:
            n *= s
        total += n
        if "moe" in key and "shared" not in key and "router" not in key:
            active += int(n * frac)
        else:
            active += n
    return total, active


def attention_flops(cfg: ModelConfig, S: int, B: int, decode: bool) -> float:
    """QK^T + AV flops (fwd). Window-aware; causal halves the full case."""
    if cfg.family == "ssm":
        return 0.0
    d_attn = cfg.num_heads * cfg.head_dim
    if cfg.family == "hybrid":
        layers = cfg.num_layers // 3           # only attn layers
        keys = min(cfg.local_window, S)        # local
        eff = S * keys if not decode else keys
        return 4.0 * B * layers * d_attn * eff
    layers = cfg.num_layers
    if decode:
        keys = S
        per_layer = 4.0 * B * d_attn * keys      # one query
    else:
        if cfg.attn_pattern == "local_global":
            n_global = layers // cfg.global_every
            n_local = layers - n_global
            w = min(cfg.local_window, S)
            per_global = 4.0 * B * d_attn * S * S * 0.5
            per_local = 4.0 * B * d_attn * S * w
            return n_global * per_global + n_local * per_local
        per_layer = 4.0 * B * d_attn * S * S * 0.5
    total = layers * per_layer
    if cfg.family == "encdec" and not decode:
        total += cfg.encoder_layers * 4.0 * B * d_attn * cfg.encoder_seq ** 2
        total += layers * 4.0 * B * d_attn * S * cfg.encoder_seq
    if cfg.family == "vlm":
        n_cross = layers // 5
        total += n_cross * 4.0 * B * d_attn * (1 if decode else S) * cfg.num_image_tokens
    return total


def model_flops(cfg: ModelConfig, shape: ShapeConfig, defs) -> float:
    _, active = count_params(cfg, defs)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active * tokens + 3.0 * attention_flops(
            cfg, shape.seq_len, shape.global_batch, decode=False)
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active * tokens + attention_flops(
            cfg, shape.seq_len, shape.global_batch, decode=False)
    # decode: one token per sequence
    return 2.0 * active * shape.global_batch + attention_flops(
        cfg, shape.seq_len, shape.global_batch, decode=True)


# ---------------------------------------------------------------------------
# Terms
# ---------------------------------------------------------------------------

def roofline_terms(record: Dict, hw: HardwareSpec = H100_SXM) -> Dict:
    """The compute, memory and collective times of one dry-run record.

    Sources, in order of trust:
      * flops and bytes: the port's ``op_cost``, counted op by op on rank
        0 and so PER DEVICE by definition; else the JAX
        package's ``jaxpr_cost``, GLOBAL, divided by the chip count; else
        ``cost`` (per device).
      * collectives: ``collectives_trips``, per device (the port's equals
        its ``collectives``: eager mode runs every layer, so its counts
        are totals already), else ``collectives``.
    """
    chips = record["num_devices"]
    oc = record.get("op_cost")
    jc = record.get("jaxpr_cost")
    if oc:
        flops = oc["flops"]
        bytes_acc = oc["bytes"]
        source = "op_cost"
    elif jc:
        flops = jc["flops"] / chips
        bytes_acc = jc["bytes"] / chips
        source = "jaxpr"
    else:
        flops = record["cost"].get("flops", 0.0)
        bytes_acc = record["cost"].get("bytes accessed", 0.0)
        source = "hlo_cost_analysis"
    coll = record.get("collectives_trips") or record["collectives"]
    coll_bytes = sum(coll.get(k, 0) for k in _COLLECTIVES)
    t_compute = flops / hw.peak_flops_bf16
    t_memory = bytes_acc / hw.hbm_bandwidth
    t_coll = coll_bytes / hw.ici_bandwidth
    dominant = max((t_compute, "compute"), (t_memory, "memory"),
                   (t_coll, "collective"))[1]
    bound = max(t_compute, t_memory, t_coll)
    mf = record.get("model_flops", 0.0)
    hlo_total = flops * chips
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "step_lower_bound_s": bound,
        "model_flops": mf,
        "hlo_flops_total": hlo_total,
        "useful_ratio": (mf / hlo_total) if hlo_total else 0.0,
        "mfu_upper_bound": (mf / (chips * hw.peak_flops_bf16)) / bound
        if bound else 0.0,
        "cost_source": source,
    }
