#!/usr/bin/env python3
"""The port's dry-run train peaks against the JAX package's own lowering.

    PYTHONPATH=src python3 tools/dryrun_vs_xla.py [--mesh single multi]
        [--port-src DIR] [--jobs N]

Each cell is one architecture cut to a few layers, the train_4k shape, an
optimizer and a microbatch count (0: the arch's ``MICROBATCHES``), on the
fake (16, 16) or (2, 16, 16) world of 256 / 512 ranks. For each cell and
mesh two processes run side by side, each under a deadline (900 s):

- the port: `repro_torch.launch.dryrun.trace_cell`, the per-device peak,
  argument bytes and FLOPs of rank 0 (no JAX in that process);
- the reference: `repro.launch.dryrun.lower_cell(...).compile()`'s
  ``memory_analysis()`` (argument + output + temp - alias, the JAX record's
  peak) and its ``jaxpr_cost`` FLOPs over the devices, with XLA's host
  platform forced to 512 devices before JAX is imported.

Prints one JSON line per cell and mesh, then the table (GB are 1e9 bytes).
``--port-src`` traces the port of another checkout (a parent commit
unpacked with ``git archive``) against the same lowering. The cells, in
two tables:

- ``unfused``: the unfused SVRG step at each arch's ``MICROBATCHES``;
- ``split``: plain SGD or SVRG at one or two microbatches, the cells that
  tell a microbatch split from the optimizer.

Runs on the CPU; no card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (arch, layers, optimizer, microbatches)
TABLES = {
    "unfused": [
        ("gemma3-4b", 2, "svrg", 0),
        ("stablelm-12b", 2, "svrg", 0),
        ("chatglm3-6b", 2, "svrg", 0),
        ("deepseek-moe-16b", 2, "svrg", 0),
        ("command-r-plus-104b", 2, "svrg", 0),
        ("recurrentgemma-2b", 3, "svrg", 0),
        ("qwen3-moe-235b-a22b", 2, "svrg", 0),
    ],
    "split": [
        ("gemma3-4b", 2, "sgd", 1),
        ("recurrentgemma-2b", 3, "sgd", 1),
        ("recurrentgemma-2b", 3, "svrg", 1),
        ("recurrentgemma-2b", 3, "sgd", 2),
        ("qwen3-moe-235b-a22b", 2, "sgd", 1),
        ("falcon-mamba-7b", 2, "sgd", 1),
        ("falcon-mamba-7b", 2, "sgd", 2),
    ],
}

PORT_CELL = """
import json, sys
from repro_torch.config import SHAPE_GRID
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
arch, layers, variant, mb, mesh_kind = sys.argv[1:6]
mesh = dryrun.cell_mesh(mesh_kind)
cfg = get_config(arch).with_overrides(num_layers=int(layers))
rec = dryrun.trace_cell(cfg, SHAPE_GRID["train_4k"], mesh, variant=variant,
                        microbatches=int(mb))
mem = rec["memory"]
print("CELL", json.dumps({"peak": mem["peak_per_device_bytes"],
                          "argument": mem["argument_bytes"],
                          "flops": rec["op_cost"]["flops"],
                          "devices": mesh.size()}))
"""

XLA_CELL = """
import json, sys
import repro.launch.dryrun as ref
from repro.config import SHAPE_GRID
from repro.launch.mesh import make_production_mesh
arch, layers, variant, mb, mesh_kind = sys.argv[1:6]
get_config = ref.get_config
ref.get_config = lambda a: get_config(a).with_overrides(num_layers=int(layers))
mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
lowered, aux = ref.lower_cell(arch, SHAPE_GRID["train_4k"], mesh, variant,
                              int(mb))
mem = lowered.compile().memory_analysis()
print("CELL", json.dumps({
    "peak": int(mem.argument_size_in_bytes + mem.output_size_in_bytes
                + mem.temp_size_in_bytes - mem.alias_size_in_bytes),
    "argument": int(mem.argument_size_in_bytes),
    "flops": float(aux["jaxpr_cost"]["flops"]) / mesh.size,
    "devices": mesh.size}))
"""


def _env(src: Path, xla: bool) -> dict:
    env = {"PYTHONPATH": str(src), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1",
           "JAX_PLATFORMS": "cpu"}
    for key in ("HOME", "TMPDIR"):
        if key in os.environ:
            env[key] = os.environ[key]
    if xla:
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    return env


def run_cells(cells, meshes=("single",), port_src: Path = ROOT / "src",
              jobs: int = 0, deadline: float = 600.0):
    """{(arch, layers, variant, mb, mesh): {"port": {...}, "xla": {...}}}:
    each side's record (peak and argument bytes, FLOPs per device), every
    process started at once up to ``jobs`` (0: the CPU count) and killed
    past ``deadline`` seconds, which raises, naming the cell."""
    todo = [(cell + (mesh,), side) for cell in cells for mesh in meshes
            for side in ("port", "xla")]
    jobs = jobs or os.cpu_count() or 1
    running, out = [], {}
    try:
        while todo or running:
            while todo and len(running) < jobs:
                key, side = todo.pop(0)
                xla = side == "xla"
                proc = subprocess.Popen(
                    [sys.executable, "-c", XLA_CELL if xla else PORT_CELL,
                     *map(str, key)],
                    cwd=ROOT, env=_env(ROOT / "src" if xla else port_src, xla),
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                running.append((key, side, proc, time.monotonic()))
            time.sleep(0.2)
            for item in list(running):
                key, side, proc, t0 = item
                if proc.poll() is None:
                    if time.monotonic() - t0 > deadline:
                        raise TimeoutError(f"{side} {key}: past {deadline} s")
                    continue
                running.remove(item)
                stdout, stderr = proc.communicate()
                lines = [x for x in stdout.splitlines() if x.startswith("CELL ")]
                if proc.returncode != 0 or not lines:
                    raise RuntimeError(f"{side} {key}: exit {proc.returncode}\n"
                                       + stderr[-3000:])
                record = json.loads(lines[0][5:])
                record["seconds"] = round(time.monotonic() - t0, 1)
                out.setdefault(key, {})[side] = record
    finally:
        for _, _, proc, _ in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait(10)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", nargs="+", default=["single", "multi"],
                    choices=["single", "multi"])
    ap.add_argument("--port-src", type=Path, default=ROOT / "src",
                    help="the src/ directory whose repro_torch is traced")
    ap.add_argument("--jobs", type=int, default=0,
                    help="processes at once (0: the CPU count)")
    args = ap.parse_args(argv)

    cells = list(dict.fromkeys(c for table in TABLES.values() for c in table))
    results = run_cells(cells, args.mesh, args.port_src.resolve(), args.jobs,
                        deadline=900.0)
    rows = []
    for key in sorted(results, key=lambda k: (k[4], cells.index(k[:4]))):
        rec = {"arch": key[0], "layers": key[1], "variant": key[2],
               "microbatches": key[3], "mesh": key[4], **results[key]}
        rows.append(rec)
        print(json.dumps(rec))
    print(f"{'mesh':6} {'arch':22} {'L':>2} {'opt':4} {'mb':>2} "
          f"{'port GB':>9} {'XLA GB':>9} {'ratio':>6} {'args equal':>10} "
          f"{'port TF/dev':>11} {'jaxpr TF/dev':>12}")
    for r in rows:
        port, xla = r["port"], r["xla"]
        print(f"{r['mesh']:6} {r['arch']:22} {r['layers']:>2} "
              f"{r['variant']:4} {r['microbatches']:>2} "
              f"{port['peak'] / 1e9:9.2f} {xla['peak'] / 1e9:9.2f} "
              f"{port['peak'] / xla['peak']:6.2f} "
              f"{str(port['argument'] == xla['argument']):>10} "
              f"{port['flops'] / 1e12:11.1f} {xla['flops'] / 1e12:12.1f}")


if __name__ == "__main__":
    main()
