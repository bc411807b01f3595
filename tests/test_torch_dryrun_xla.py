"""The dry-run's per-device train peaks held against the JAX package's own
lowering.

Four train_4k cells on the fake (16, 16) world, each cut in depth:

- recurrentgemma-2b, 3 layers, plain SGD, 2 microbatches: each microbatch
  keeps its rows sharded over ``data`` through the recurrent and attention
  blocks (the fsdp weights gathered where the rows are sharded, the gates
  on the channels' sharding);
- qwen3-moe-235b-a22b, 2 layers, plain SGD, 1 microbatch: the dispatch puts
  each rank's own tokens into their expert slots before they move to the
  experts' layout, and the combine reads them back the same way;
- falcon-mamba-7b, 2 layers, plain SGD, 1 microbatch: the input
  projection keeps its output sharded over ``model`` (the rows gathered
  there, as the narrower side) and its split into the scan's input and
  gate moves through the sequence, not gathered;
- gemma3-4b, 2 layers, plain SGD, 1 microbatch: a dense cell.

All-to-all moves are traced as the card's one op (on a CPU mesh
``DTensor`` would gather the whole dim and cut the new shard from it).

For each, the port's trace (`repro_torch.launch.dryrun.trace_cell`) and the
JAX package's lowering (``repro.launch.dryrun.lower_cell(...).compile()
.memory_analysis()``) run in processes of their own, all side by side,
each under a deadline: tests/conftest.py imports JAX into this process, and
XLA's host device count must be set before JAX is imported. The port's peak
per device is at most XLA's (argument + output + temp - alias), the
argument bytes are equal, and the port's FLOPs per device are at least
FLOPS_FLOOR of the reference's even share (its ``jaxpr_cost`` over the
devices), so a trace that dropped work cannot pass for a lower peak. The
processes are `tools/dryrun_vs_xla.py`'s (`run_cells`), which prints the
wider tables.
"""
import importlib.util
import os
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "dryrun_vs_xla", REPO / "tools" / "dryrun_vs_xla.py")
vs_xla = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(vs_xla)

# (arch, layers, optimizer, microbatches)
CELLS = [("recurrentgemma-2b", 3, "sgd", 2),
         ("qwen3-moe-235b-a22b", 2, "sgd", 1),
         ("falcon-mamba-7b", 2, "sgd", 1),
         ("gemma3-4b", 2, "sgd", 1)]
# alone the slowest processes (recurrentgemma-2b's and falcon-mamba-7b's
# traces) take ~60 s on an 8-core host; a deadline of 5x that leaves room
# for the suite's other workers
DEADLINE_S = 300
# at most half the host's cores at once, so the traces do not crowd the
# suite's other workers
JOBS = min(2 * len(CELLS), max(2, (os.cpu_count() or 4) // 2))
# the port's FLOPs per device over the reference's even share: 0.99-1.54 in
# these cells (falcon-mamba-7b's lowest); dropping a layer of two halves it
FLOPS_FLOOR = 0.9


def _id(cell):
    arch, layers, variant, mb = cell
    return f"{arch}-L{layers}-{variant}-mb{mb}"


@pytest.fixture(scope="module")
def pairs():
    return vs_xla.run_cells(CELLS, ("single",), jobs=JOBS,
                            deadline=DEADLINE_S)


@pytest.mark.parametrize("cell", CELLS, ids=_id)
def test_port_peak_at_most_xla(pairs, cell):
    got = pairs[cell + ("single",)]
    assert got["port"]["peak"] <= got["xla"]["peak"], got


@pytest.mark.parametrize("cell", CELLS, ids=_id)
def test_argument_bytes_equal_xla(pairs, cell):
    got = pairs[cell + ("single",)]
    assert got["port"]["argument"] == got["xla"]["argument"], got


@pytest.mark.parametrize("cell", CELLS, ids=_id)
def test_port_flops_cover_the_reference_share(pairs, cell):
    got = pairs[cell + ("single",)]
    assert got["port"]["flops"] >= FLOPS_FLOOR * got["xla"]["flops"], got
