"""The port stands alone: it imports neither JAX nor the JAX package, never
moves to the CPU on its own, and its smoke script refuses to run without a
card.

The import check runs in a subprocess because tests/conftest.py imports JAX
into the test process.
"""
import ast
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import objective
from repro_torch.kernels import _build

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
"""


def _run(args, cwd, timeout=120):
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_port_imports_no_jax_and_no_repro():
    proc = _run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.strip().split(" ", 1)
    assert int(count) >= 20
    assert bad == "[]", bad


# the modules of the training slice: each must be imported and scanned
TRAINING_MODULES = (
    "repro_torch.utils.tree", "repro_torch.utils.misc",
    "repro_torch.optim.optimizers", "repro_torch.optim.schedules",
    "repro_torch.core.distributed", "repro_torch.train.state",
    "repro_torch.train.loop", "repro_torch.checkpoint.checkpointer",
    "repro_torch.data.synthetic_lm", "repro_torch.launch.train")

_LIST_ALL = """
import pkgutil, repro_torch
print(" ".join(m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                    "repro_torch.")))
"""


# the modules of the mixture-of-experts slice
MOE_MODULES = (
    "repro_torch.models.moe", "repro_torch.configs.deepseek_moe_16b",
    "repro_torch.configs.qwen3_moe_235b", "repro_torch.configs.paper_logreg")


# the modules of the recurrent slice
RECURRENT_MODULES = (
    "repro_torch.models.rglru", "repro_torch.models.mamba",
    "repro_torch.configs.recurrentgemma_2b",
    "repro_torch.configs.falcon_mamba_7b")


# the modules of the obs and service slice
OBS_SERVICE_MODULES = (
    "repro_torch.obs.trace", "repro_torch.obs.metrics",
    "repro_torch.obs.progress", "repro_torch.obs.prometheus",
    "repro_torch.obs.ledger", "repro_torch.obs.telemetry",
    "repro_torch.obs.watchdog", "repro_torch.launch.roofline",
    "repro_torch.service.cache",
    "repro_torch.service.scheduler", "repro_torch.service.api")


# the modules of the objectives and server slice
OBJECTIVES_SERVER_MODULES = (
    "repro_torch.core.objectives", "repro_torch.kernels.regularizer",
    "repro_torch.server.fairness", "repro_torch.server.daemon",
    "repro_torch.server.metrics", "repro_torch.server.http",
    "repro_torch.server.client")


# the modules of the sharding slice
SHARDING_MODULES = (
    "repro_torch.core.compression", "repro_torch.core.distributed",
    "repro_torch.sharding.rules", "repro_torch.sharding.context",
    "repro_torch.launch.mesh")


# the modules of the dry-run slice
DRYRUN_MODULES = (
    "repro_torch.launch.dryrun", "repro_torch.launch.roofline",
    "repro_torch.config", "repro_torch.models.factory",
    "repro_torch.data.synthetic_lm", "repro_torch.sharding.rules",
    "repro_torch.sharding.context",
    "repro_torch.kernels.flash_attention.ops")


# the modules of the fused MLP slice
MLP_FUSED_MODULES = (
    "repro_torch.kernels.sweep_epoch_mlp.ops",
    "repro_torch.kernels.sweep_epoch_mlp.kernel",
    "repro_torch.kernels.sweep_epoch_mlp.ref",
    "repro_torch.kernels.sweep_epoch.ref")


def _assert_checked(modules):
    proc = _run([sys.executable, "-c", _LIST_ALL], cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    walked = set(proc.stdout.split())
    scanned = {".".join(p.relative_to(REPO / "src").with_suffix("").parts)
               for p in PORT.rglob("*.py")}
    for name in modules:
        assert name in walked and name in scanned, name


def test_checks_cover_the_training_modules():
    _assert_checked(TRAINING_MODULES)


def test_checks_cover_the_moe_modules():
    _assert_checked(MOE_MODULES)


def test_checks_cover_the_recurrent_modules():
    _assert_checked(RECURRENT_MODULES)


def test_checks_cover_the_obs_and_service_modules():
    _assert_checked(OBS_SERVICE_MODULES)


def test_checks_cover_the_objectives_and_server_modules():
    _assert_checked(OBJECTIVES_SERVER_MODULES)


def test_checks_cover_the_sharding_modules():
    _assert_checked(SHARDING_MODULES)


def test_checks_cover_the_dryrun_modules():
    _assert_checked(DRYRUN_MODULES)


def test_checks_cover_the_mlp_fused_modules():
    _assert_checked(MLP_FUSED_MODULES)


def test_source_never_names_jax_or_repro():
    for path in [*PORT.rglob("*.py"), REPO / "chip_smoke.py"]:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not set(roots) & {"jax", "jaxlib", "repro"}, (path, roots)


def test_no_cuda_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.zeros((4, 3), np.float32)
    y = np.ones(4, np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        objective.LogisticRegression(X, y)
    assert objective.LogisticRegression(X, y, device="cpu").X.device.type == "cpu"


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_build_targets_follow_the_sources():
    for name in _build.SOURCES:
        src, lib = _build.target(name)
        assert src.is_file() and src.parent == PORT / "csrc"
        assert lib.parent == REPO / "build" / "repro_torch"
        assert lib.name.startswith(f"{name}-") and lib.suffix == ".so"


def test_chip_smoke_fails_without_a_card():
    proc = _run([sys.executable, "chip_smoke.py"], cwd=REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run([sys.executable, "chip_smoke.py"], cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
