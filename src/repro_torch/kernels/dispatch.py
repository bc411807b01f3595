"""Where a kernel call runs, decided by the device of its tensors alone.

A CPU tensor takes the kernel's plain torch version (``ref.py``); a CUDA
tensor launches the hand-written kernel, and a failed build or launch
raises. There is no override: nothing can send CUDA tensors to the plain
version or CPU tensors to a kernel, so a run on the card provably went
through its kernels (each wrapper counts its launches).
"""
from __future__ import annotations

import torch

REFERENCE = "reference"
CUDA = "cuda"


def route(*tensors: torch.Tensor) -> str:
    """``"reference"`` for CPU tensors, ``"cuda"`` for CUDA tensors; raises
    when the tensors disagree on their device or lie on any other device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel inputs lie on several devices: {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return REFERENCE
    if device.type == "cuda":
        return CUDA
    raise ValueError(f"no kernel for device {device}")


def mode_tags(fused: bool, device) -> dict:
    """Span tags describing HOW a group dispatch executes, stamped onto the
    tracer's ``execute`` spans by `repro_torch.core.sweep._dispatch_group`:
    the engine mode, and as ``backend`` the device type of the group's
    tensors (``"cuda"`` launches the kernels, ``"cpu"`` takes their plain
    versions)."""
    return {"engine_mode": "fused" if fused else "vmap",
            "backend": torch.device(device).type}
