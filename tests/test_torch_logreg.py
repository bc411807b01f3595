"""The factory's logistic-regression bundle (the paper's workload as a
"model") on the CPU against the JAX package's: its params, loss and
gradient from the same numpy X, y, w, and its inputs; and the two CLIs,
which have no path for it and say so.

Tolerance, float32: loss rtol 1e-6, gradient rtol 1e-5, atol 1e-7 (one
matrix-vector product and a mean, summed in another order).
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ShapeConfig
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models.factory import build_model as jax_build_model
from repro_torch.configs import get_config, reduced_config
from repro_torch.models.factory import build_model

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("reduced", [False, True])
def test_config_and_param_defs_equal_jax(reduced):
    cfg = reduced_config("paper-logreg") if reduced else get_config("paper-logreg")
    jcfg = (jax_reduced_config("paper-logreg") if reduced
            else jax_get_config("paper-logreg"))
    assert cfg.to_dict() == jcfg.to_dict()
    bundle, jbundle = build_model(cfg, device="cpu"), jax_build_model(jcfg)
    (d,), (t,) = bundle.param_defs.values(), jbundle.param_defs.values()
    assert list(bundle.param_defs) == list(jbundle.param_defs) == ["w"]
    assert (d.shape, d.axes, d.init, d.dtype) == (t.shape, t.axes, t.init,
                                                  t.dtype)
    assert bundle.prefill_fn is None and bundle.decode_fn is None
    assert bundle.cache_defs is None


@pytest.mark.parametrize("w_scale", [0.0, 0.3])
def test_loss_and_gradient_match_jax(w_scale):
    """At w = 0 (the init) and at a random w, over 32 rows of the reduced
    config's 64 features."""
    cfg = reduced_config("paper-logreg")
    bundle = build_model(cfg, device="cpu")
    jbundle = jax_build_model(jax_reduced_config("paper-logreg"))
    rng = np.random.default_rng(0)
    X = rng.standard_normal((32, cfg.num_features)).astype(np.float32)
    y = np.sign(rng.standard_normal(32) + 0.1).astype(np.float32)
    w = (w_scale * rng.standard_normal(cfg.num_features)).astype(np.float32)
    want, jgrad = jax.value_and_grad(jbundle.loss_fn)(
        {"w": jnp.asarray(w)}, {"X": jnp.asarray(X), "y": jnp.asarray(y)})
    tw = torch.tensor(w, requires_grad=True)
    got = bundle.loss_fn({"w": tw}, {"X": torch.tensor(X), "y": torch.tensor(y)})
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgrad["w"]),
                               rtol=1e-5, atol=1e-7)
    assert bundle.cast({"w": tw})["w"] is tw


def test_make_inputs_matches_jax_shapes():
    """X [batch, F] standard normal and y in ±1, the JAX package's keys,
    shapes and dtypes, on the generator's device."""
    cfg = reduced_config("paper-logreg")
    got = build_model(cfg, device="cpu").make_inputs(
        16, 0, torch.Generator().manual_seed(0))
    want = jax_build_model(jax_reduced_config("paper-logreg")).make_inputs(
        ShapeConfig("t", "train", 0, 16), jax.random.PRNGKey(0))
    assert sorted(got) == sorted(want) == ["X", "y"]
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        assert str(got[key].dtype) == f"torch.{want[key].dtype}"
    assert set(got["y"].tolist()) <= {-1.0, 1.0}


def _cli(module, *args):
    return subprocess.run(
        [sys.executable, "-m", module, "--arch", "paper-logreg", "--reduced",
         "--device", "cpu", *args],
        cwd=REPO, env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
                       "CUDA_VISIBLE_DEVICES": ""},
        capture_output=True, text=True, timeout=120)


def test_serve_cli_refuses_logreg_as_jax_does():
    proc = _cli("repro_torch.launch.serve")
    assert proc.returncode != 0
    assert "paper-logreg-smoke has no serve path" in proc.stderr


def test_train_cli_refuses_logreg_with_a_clear_error():
    proc = _cli("repro_torch.launch.train", "--steps", "2")
    assert proc.returncode != 0
    assert "has no training path here" in proc.stderr
    assert "Traceback" not in proc.stderr
