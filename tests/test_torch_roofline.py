"""repro_torch.launch.roofline (the analytic half) and the port's
HardwareSpec against repro.launch.roofline and repro.config.

The same arithmetic on the same shapes: at TPU_V5E both packages' numbers
are equal exactly; the port's default hardware is the H100 (NVIDIA's H100
SXM5 datasheet figures).
"""
import dataclasses

import pytest

from repro import config as jconfig
from repro.launch import roofline as jroofline
from repro_torch import config
from repro_torch.launch import roofline

SHAPES = [
    dict(rows=4, dim=2048, total=40480, epochs=2, buf_len=8),
    dict(rows=1, dim=2048, total=20224, epochs=2, buf_len=8),
    dict(rows=3, dim=1355191, total=39992, epochs=3, buf_len=41),
    dict(rows=2, dim=16, total=12, epochs=1, buf_len=1),
]


def test_hardware_spec_copies_the_reference():
    assert [f.name for f in dataclasses.fields(config.HardwareSpec)] == \
        [f.name for f in dataclasses.fields(jconfig.HardwareSpec)]
    assert dataclasses.asdict(config.TPU_V5E) == \
        dataclasses.asdict(jconfig.TPU_V5E)


def test_h100_figures():
    hw = config.H100_SXM
    assert (hw.name, hw.peak_flops_bf16, hw.hbm_bandwidth, hw.ici_bandwidth,
            hw.hbm_bytes) == ("h100_sxm", 989e12, 3.35e12, 900e9, 80e9)


@pytest.mark.parametrize("shape", SHAPES)
def test_sweep_epoch_roofline_equals_reference(shape):
    want = jroofline.sweep_epoch_roofline(**shape, hw=jconfig.TPU_V5E)
    got = roofline.sweep_epoch_roofline(**shape, hw=config.TPU_V5E)
    assert got == want


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("wall_s", [0.0, 0.33])
def test_attained_fraction_equals_reference(shape, fused, wall_s):
    want = jroofline.attained_fraction(**shape, fused=fused, wall_s=wall_s,
                                       hw=jconfig.TPU_V5E)
    got = roofline.attained_fraction(**shape, fused=fused, wall_s=wall_s,
                                     hw=config.TPU_V5E)
    assert got == want


@pytest.mark.parametrize("shape", SHAPES)
def test_default_hardware_is_the_h100(shape):
    """Memory-bound on the H100 too: the fused path's bound is its bytes
    over 3.35 TB/s."""
    got = roofline.sweep_epoch_roofline(**shape)
    assert got == roofline.sweep_epoch_roofline(**shape, hw=config.H100_SXM)
    fused = got["fused"]
    assert fused["dominant"] == "memory"
    assert fused["step_lower_bound_s"] == fused["bytes"] / 3.35e12
    frac = roofline.attained_fraction(**shape, fused=True, wall_s=1.0)
    assert frac["roofline_s"] == fused["step_lower_bound_s"]


# ---------------------------------------------------------------------------
# The LM cells' analytic count and the terms of a dry-run record
# ---------------------------------------------------------------------------

# a record as the JAX package's dry-run writes it (jaxpr_cost global)
JAX_RECORD = {
    "num_devices": 256,
    "cost": {"flops": 3.1e13, "bytes accessed": 7.0e11},
    "jaxpr_cost": {"flops": 2.56e16, "bytes": 1.28e14},
    "collectives": {"all-reduce": 1.0e9, "all-gather": 2.0e9,
                    "reduce-scatter": 5.0e8, "all-to-all": 0.0,
                    "collective-permute": 0.0, "count": 12},
    "collectives_trips": {"all-reduce": 3.4e10, "all-gather": 6.8e10,
                          "reduce-scatter": 1.7e10, "all-to-all": 0.0,
                          "collective-permute": 1.0e6, "count": 400},
    "model_flops": 1.9e16,
}


@pytest.mark.parametrize("record", [
    JAX_RECORD,
    {k: v for k, v in JAX_RECORD.items() if k != "jaxpr_cost"},
    {k: v for k, v in JAX_RECORD.items() if k != "collectives_trips"}],
    ids=["jaxpr_cost", "cost_analysis", "no_trips"])
def test_roofline_terms_equals_reference_tpu(record):
    want = jroofline.roofline_terms(record, jconfig.TPU_V5E)
    got = roofline.roofline_terms(record, config.TPU_V5E)
    assert got == want


def test_roofline_terms_equals_reference_h100():
    """The port's default hardware against a JAX HardwareSpec holding the
    H100's numbers."""
    h100 = jconfig.HardwareSpec(**dataclasses.asdict(config.H100_SXM))
    want = jroofline.roofline_terms(JAX_RECORD, h100)
    assert roofline.roofline_terms(JAX_RECORD) == want
    assert want["t_collective_s"] == (3.4e10 + 6.8e10 + 1.7e10 + 1.0e6) / 900e9


def test_roofline_terms_reads_op_cost_per_device():
    """The port's record counts its FLOPs on rank 0: per device, never
    divided by the chip count again."""
    rec = dict(JAX_RECORD)
    del rec["jaxpr_cost"]
    rec["op_cost"] = {"flops": 1.0e14, "bytes": 2.0e12}
    got = roofline.roofline_terms(rec)
    assert got["cost_source"] == "op_cost"
    assert got["t_compute_s"] == 1.0e14 / 989e12
    assert got["t_memory_s"] == 2.0e12 / 3.35e12
    assert got["hlo_flops_total"] == 1.0e14 * 256
