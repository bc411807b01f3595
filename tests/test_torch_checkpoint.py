"""The port's checkpointer: the behaviours tests/test_checkpoint.py holds
the JAX package's to (round trip, latest + retention, async save, corrupt
manifest skipped, partial directories ignored, no checkpoint raises), plus
what the port adds: NamedTuple train states, bfloat16 leaves bit for bit,
the manifest's dtypes and shapes, restore onto the template's device, and
a template that does not match. (The elastic restore onto a new mesh waits
for the sharding slice.)
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.core.distributed import SVRGState
from repro_torch.train.state import TrainState


def _state(x):
    return {"params": {"w": torch.full((4, 3), x)},
            "step": torch.tensor(int(x), dtype=torch.int32)}


def test_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(_state(7.0), step=7)
    restored, step = ck.restore(_state(0.0))
    assert step == 7
    assert torch.equal(restored["params"]["w"], torch.full((4, 3), 7.0))
    assert restored["step"].dim() == 0 and int(restored["step"]) == 7


def test_restore_latest_and_retention(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_last_k=2)
    for s in (1, 2, 3, 4):
        ck.save(_state(float(s)), step=s)
    assert ck.list_steps() == [3, 4]      # retention pruned 1, 2
    _, step = ck.restore(_state(0.0))
    assert step == 4


def test_async_save(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(_state(5.0), step=5, blocking=False)
    ck.wait()
    assert ck.list_steps() == [5]


def test_corrupt_manifest_skipped(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(_state(1.0), step=1)
    ck.save(_state(2.0), step=2)
    with open(tmp_path / "step_0000000002" / "manifest.json", "w") as f:
        f.write("{not json")
    assert ck.list_steps() == [1]
    _, step = ck.restore(_state(0.0))
    assert step == 1


def test_tmp_dirs_ignored(tmp_path):
    """A crash mid-write leaves step_*.tmp — must be invisible to restore."""
    ck = Checkpointer(str(tmp_path))
    ck.save(_state(1.0), step=1)
    os.makedirs(tmp_path / "step_0000000009.tmp")
    assert ck.list_steps() == [1]


def test_no_checkpoint_raises(tmp_path):
    ck = Checkpointer(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ck.restore(_state(0.0))


def _train_state(gen):
    params = {"w": torch.randn((3, 5), generator=gen),
              "h": torch.randn((2, 4), generator=gen).to(torch.bfloat16)}
    svrg = SVRGState(w_snap={k: v.clone() for k, v in params.items()},
                     g_snap={k: v * 2 for k, v in params.items()},
                     snap_step=torch.tensor(3, dtype=torch.int32),
                     accum_count=torch.tensor(0, dtype=torch.int32))
    return TrainState(params=params, opt_state={}, svrg=svrg,
                      step=torch.tensor(9, dtype=torch.int32))


def test_train_state_with_bf16_roundtrips_bit_for_bit(tmp_path):
    ck = Checkpointer(str(tmp_path))
    state = _train_state(torch.Generator().manual_seed(0))
    ck.save(state, step=9)
    with open(tmp_path / "step_0000000009" / "manifest.json") as f:
        man = json.load(f)
    assert man["keys"] == sorted(man["dtypes"]) == sorted(man["shapes"])
    assert man["dtypes"]["params/h"] == "bfloat16"
    assert man["shapes"]["svrg/g_snap/w"] == [3, 5]
    assert man["shapes"]["step"] == []
    template = _train_state(torch.Generator().manual_seed(1))
    restored, step = ck.restore(template)
    assert step == 9 and isinstance(restored, TrainState)
    assert isinstance(restored.svrg, SVRGState)
    for got, want in zip(
            [restored.params, restored.svrg.w_snap, restored.svrg.g_snap],
            [state.params, state.svrg.w_snap, state.svrg.g_snap]):
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert torch.equal(got[k].view(torch.int16) if got[k].dtype ==
                               torch.bfloat16 else got[k],
                               want[k].view(torch.int16) if want[k].dtype ==
                               torch.bfloat16 else want[k])
    assert int(restored.svrg.snap_step) == 3 and int(restored.step) == 9


def test_restore_onto_the_template_device(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(_state(2.0), step=2)
    template = _state(0.0)
    template["params"]["w"] = torch.zeros((4, 3), device="meta")
    restored, _ = ck.restore(template)
    assert restored["params"]["w"].device.type == "meta"
    assert restored["step"].device.type == "cpu"


@pytest.mark.parametrize("change", ["shape", "dtype", "key"])
def test_template_that_does_not_match_raises(tmp_path, change):
    ck = Checkpointer(str(tmp_path))
    ck.save(_state(1.0), step=1)
    template = _state(0.0)
    if change == "shape":
        template["params"]["w"] = torch.zeros((3, 4))
    elif change == "dtype":
        template["params"]["w"] = torch.zeros((4, 3), dtype=torch.float64)
    else:
        template["params"]["v"] = torch.zeros(1)
    with pytest.raises(KeyError if change == "key" else ValueError,
                       match="does not match"):
        ck.restore(template)
    assert np.asarray(ck.list_steps()).tolist() == [1]
