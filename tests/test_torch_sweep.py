"""repro_torch.core.sweep against repro.core.sweep on the CPU.

One JAX `run_sweep` over a mixed grid (the three schemes, serial SVRG,
Hogwild! and mixed per-row epochs) serves every comparison here.
Tolerances: rtol 1e-5, atol 1e-6 on histories and final iterates (summation
order); normalized specs, plans and accounting must be equal.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import sweep as jsw
from repro.core.objective import LogisticRegression as JaxLogReg
from repro_torch.core import sweep as psw
from repro_torch.core.objective import LogisticRegression
from repro_torch.service import SweepService
from repro_torch.sharding.context import mesh_context

TOL = dict(rtol=1e-5, atol=1e-6)


def _specs(mod):
    specs = mod.make_grid(step_sizes=(0.5,), num_threads=4, inner_steps=16,
                          seeds=(0, 1))
    specs += [
        mod.SweepSpec(algo="svrg", step_size=0.5, num_threads=4,
                      inner_steps=64),
        mod.SweepSpec(algo="svrg", step_size=0.3, num_threads=1,
                      inner_steps=40, epochs=1),
        mod.SweepSpec(algo="hogwild", scheme="unlock", step_size=0.5,
                      num_threads=4, tau=-1, epochs=3),
        mod.SweepSpec(seed=2, scheme="unlock", step_size=0.4, num_threads=4,
                      inner_steps=16, delay_kind="uniform", epochs=1),
    ]
    return specs


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(0)
    n, p = 96, 64
    X = (rng.standard_normal((n, p)) / 8).astype(np.float32)
    y = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    jo = JaxLogReg(X, y, 1e-3)
    po = LogisticRegression(X, y, 1e-3, device="cpu")
    jres = jsw.run_sweep(jo, 2, _specs(jsw))
    pres = psw.run_sweep(po, 2, _specs(psw))
    return jo, po, jres, pres


def test_sweep_matches_jax(runs):
    jo, po, jres, pres = runs
    assert [dataclasses.asdict(s) for s in pres.specs] == \
        [dataclasses.asdict(s) for s in jres.specs]
    assert psw.plan_sweep(po, 2, _specs(psw)).groups == \
        jsw.plan_sweep(jo, 2, _specs(jsw)).groups
    assert pres.histories.shape == jres.histories.shape == (10, 4)
    np.testing.assert_allclose(pres.histories, jres.histories, **TOL)
    np.testing.assert_allclose(pres.final_w, jres.final_w, **TOL)
    np.testing.assert_array_equal(pres.effective_passes, jres.effective_passes)
    np.testing.assert_array_equal(pres.total_updates, jres.total_updates)
    np.testing.assert_array_equal(pres.epochs_per_row, jres.epochs_per_row)
    assert pres.param_shapes == jres.param_shapes
    for c in range(len(pres.specs)):
        passes, hist = pres.curve(c)
        assert len(hist) == pres.epochs_per_row[c] + 1 == len(passes)
        assert pres.row(c)["total_updates"] == pres.total_updates[c]


def test_row_alone_equals_row_in_batch(runs):
    """A row's results do not depend on the rows it runs with: bit for bit."""
    _, po, _, pres = runs
    specs = _specs(psw)
    for c in (0, 4, 7, 8, 9):
        alone = psw.run_sweep(po, 2, [specs[c]])
        width = alone.histories.shape[1]
        assert np.array_equal(alone.final_w[0], pres.final_w[c])
        assert np.array_equal(alone.histories[0], pres.histories[c, :width])


def test_short_row_equals_shorter_run(runs):
    """A 1-epoch row of a 2-epoch group freezes after its own budget."""
    _, po, _, pres = runs
    alone = psw.run_sweep(po, 1, [dataclasses.replace(_specs(psw)[9],
                                                      epochs=0)])
    assert np.array_equal(alone.final_w[0], pres.final_w[9])
    assert np.array_equal(alone.histories[0], pres.histories[9, :2])
    assert np.all(pres.histories[9, 2:] == pres.histories[9, 1])


@pytest.mark.parametrize("kwargs", [dict(mesh=object())])
def test_unported_options_raise(runs, kwargs):
    """A mesh runs since the sharding slice (tests/test_torch_distributed.py);
    what is not a named `DeviceMesh` is refused at the sweep service's entry
    point. ``telemetry=True``, which raised before the obs slice, runs now
    (tests/test_torch_obs.py)."""
    _, po, _, _ = runs
    with pytest.raises(TypeError, match="DeviceMesh"):
        SweepService(po, **kwargs)


def test_mesh_raises(runs):
    """``run_sweep`` refuses a mesh that is not a named `DeviceMesh`, given
    explicitly or ambiently; a real mesh row-shards the groups
    (tests/test_torch_distributed.py)."""
    _, po, _, _ = runs
    with pytest.raises(TypeError, match="DeviceMesh"):
        psw.run_sweep(po, 1, [psw.SweepSpec()], mesh=object())
    with mesh_context({"data": 2}):
        with pytest.raises(TypeError, match="DeviceMesh"):
            psw.run_sweep(po, 1, [psw.SweepSpec()])


@pytest.mark.parametrize("kwargs", [dict(algo="svrg", tau=3),
                                    dict(algo="sgd"), dict(scheme="nope"),
                                    dict(engine_mode="pallas"), dict(epochs=-1)])
def test_bad_specs_raise(runs, kwargs):
    _, po, _, _ = runs
    with pytest.raises(ValueError):
        psw.plan_sweep(po, 1, [psw.SweepSpec(**kwargs)])


def test_grid_matches_jax():
    kw = dict(schemes=("unlock",), seeds=(0, 3), taus=(0, 2), algo="hogwild")
    assert [dataclasses.asdict(s) for s in psw.make_grid(**kw)] == \
        [dataclasses.asdict(s) for s in jsw.make_grid(**kw)]
