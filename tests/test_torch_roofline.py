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
