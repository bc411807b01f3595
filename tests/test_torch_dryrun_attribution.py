"""The dry-run's attribution of a peak (`repro_torch.launch.dryrun.Recorder`
with ``attribute``, ``trace_cell(..., attribute=True)``).

- On a fake world of 4 ranks, a (2, 2) ``("data", "model")`` mesh, a value
  whose batch a constraint site planted wrong has gathered is reported, at
  the peak, as holding dim 0 whole over ``data`` where the next site's
  layout shards it, with the op and the line that made it and the line of
  that site; with the planted site taken out nothing is held whole.
- At `HOST_MESH` (plain fake tensors) the storages listed at the peak of a
  narrow 2-layer gemma3-4b train step add up to the peak, and each one the
  step made names its op and where in the port it was made.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch import config
from repro_torch.configs import get_config
from repro_torch.launch import dryrun

REPO = Path(__file__).resolve().parents[1]

_PLANTED = """
import json
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch import dryrun
from repro_torch.sharding import context as ctx

dryrun.fake_world(4)
mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                  mesh_dim_names=("data", "model"))

def step(x, planted):
    y = x * 2.0
    if planted:
        y = ctx.constrain(y, (None, None))     # PLANTED
    z = y + 1.0                                # MADE
    return ctx.constrain(z, ("batch", None))   # SITE

out = {}
for planted in (False, True):
    fm = FakeTensorMode()
    with fm:
        x = DTensor.from_local(torch.zeros(32, 64), mesh,
                               [Shard(0), Replicate()], run_check=False,
                               shape=torch.Size((64, 64)), stride=(64, 1))
    rec = dryrun.Recorder(attribute=True)
    rec.track(x)
    with dryrun.recording(rec, mesh, fm):
        step(x, planted)
    out[str(planted)] = [rec.peak, rec.attribution()]
print("ATTRIBUTION", json.dumps(out))
"""


def _line(marker):
    return next(i for i, text in enumerate(_PLANTED.splitlines(), 1)
                if marker in text)


@pytest.fixture(scope="module")
def planted():
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", _PLANTED], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [x for x in proc.stdout.splitlines()
            if x.startswith("ATTRIBUTION ")][0]
    return json.loads(line[len("ATTRIBUTION "):])


def test_planted_site_is_reported_holding_a_dim_whole(planted):
    peak, held = planted["True"]
    whole = [h for h in held if h["whole"]]
    assert len(whole) == 1, held
    h = whole[0]
    assert h["whole"] == ["dim 0 over data"]
    assert (h["op"], h["site"]) == ("aten.add", f"<string>:{_line('MADE')}")
    assert h["constrained_at"] == f"<string>:{_line('SITE')}"
    assert (h["global_shape"], h["local_shape"]) == ([64, 64], [64, 64])
    assert (h["placements"], h["site_layout"]) == (["R", "R"], ["S(0)", "R"])
    assert sum(x["bytes"] for x in held) == peak


def test_without_the_planted_site_nothing_is_whole(planted):
    peak, held = planted["False"]
    assert not [h for h in held if h["whole"]], held
    made = [h for h in held if h["site"] == f"<string>:{_line('MADE')}"]
    assert len(made) == 1 and made[0]["local_shape"] == [32, 64], held
    assert made[0]["constrained_at"] == f"<string>:{_line('SITE')}"
    assert sum(x["bytes"] for x in held) == peak


# a narrow 2-layer gemma3-4b (as tests/test_torch_dryrun.py's)
TINY = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=1,
            head_dim=32, d_ff=128, vocab_size=256, local_window=8)


def test_host_mesh_attribution_adds_up_to_the_peak():
    cfg = get_config("gemma3-4b").with_overrides(**TINY)
    shape = config.ShapeConfig("train", "train", 16, 4)
    plain = dryrun.trace_cell(cfg, shape, dryrun.cell_mesh("host"),
                              microbatches=1)
    rec = dryrun.trace_cell(cfg, shape, dryrun.cell_mesh("host"),
                            microbatches=1, attribute=True)
    assert rec["memory"] == plain["memory"]
    held = rec["attribution"]
    assert sum(h["bytes"] for h in held) == rec["memory"]["peak_per_device_bytes"]
    assert [h["bytes"] for h in held] == sorted((h["bytes"] for h in held),
                                                reverse=True)
    made = [h for h in held if h["op"] != "argument"]
    assert made and all(h["op"].startswith("aten.") for h in made)
    assert all(h["site"] and h["site"] != "?" for h in made), made
    assert any(h["site"].startswith("models/") for h in made), made
