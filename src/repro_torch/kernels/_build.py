"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``repro_torch/csrc/<name>.cu`` exports a plain C interface and compiles
on its own, with no PyTorch headers (seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o <name>-<hash>.so <name>.cu

into ``build/repro_torch/`` at the repository root (listed in .gitignore).
The file name carries a hash of the source, the headers of ``csrc/`` (the
sources include them by relative path) and the flags, so an edited source
or header rebuilds at its next use and an unchanged one loads as it is. The
compiler's output (``-Xptxas -v``: registers, shared memory, spills) is kept
beside each library as ``<name>-<hash>.log``.

Building happens at first use (`library`) or up front for every source at
once, one nvcc process each, all started together (`build`). This module,
not the ``kernel.py`` launchers, owns the file system and the environment.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("svrg_update", "logreg_grad", "sweep_epoch", "sweep_epoch_mlp",
           "flash_attention", "flash_attention_wgmma")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_BUILDS = [0]  # libraries nvcc compiled in this process (see `builds`)


def nvcc() -> str:
    """Path of the CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME
    (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if path.is_file():
        return str(path)
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels build only where the CUDA "
        "toolkit is installed")


def target(name: str) -> Tuple[Path, Path]:
    """(source, library path) of one kernel source."""
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"{name}-{digest}.so"


def build(names: Sequence[str] = SOURCES) -> None:
    """Compile every named source whose library is missing, all nvcc
    processes at once; each compiler output goes to ``<name>-<hash>.log``."""
    compiler = nvcc()
    running = {}
    for name in names:
        src, lib = target(name)
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [compiler, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in running.items():
        out, _ = proc.communicate()
        lib.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{out}")
            continue
        os.replace(tmp, lib)
        _BUILDS[0] += 1
    if failed:
        raise RuntimeError("\n".join(failed))


def builds() -> int:
    """How many kernel libraries nvcc has compiled in this process; the
    runner cache counts the ones built during a group's call as compiles
    (`repro_torch.service.cache`)."""
    return _BUILDS[0]


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(target(name)[1]))
            _LIBS[name] = lib
        return lib
