"""Fault-tolerant checkpointing, the port of the JAX package's
``checkpoint/checkpointer.py``:

  * step-atomic: arrays are written to ``step_<N>.tmp/`` then the directory
    is os.rename()d — a crash mid-write never corrupts the latest checkpoint.
  * manifest.json records the step and each leaf's key path, dtype and
    shape.
  * async: `save(..., blocking=False)` hands the host copy to a writer
    thread so the train loop overlaps checkpoint IO with compute.
  * retention: keep_last_k with atomic cleanup.
  * restore picks the newest VALID manifest (partial/corrupt dirs skipped)
    and places every leaf on the device of the template's leaf.

A state is a tree of tensors (nested dicts, NamedTuples, sequences; see
`utils.tree`), flattened here to "/"-joined key paths. numpy has no
bfloat16, so a bfloat16 leaf is stored as its 16-bit patterns and comes
back bit for bit.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils.tree import tree_flatten_with_path, tree_unflatten_like

def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _from_numpy(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    t = torch.from_numpy(arr.copy())     # C order; a 0-d array stays 0-d
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


def _flatten(tree) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    flat, dtypes = {}, {}
    for key, leaf in tree_flatten_with_path(tree):
        flat[key] = _to_numpy(leaf)
        dtypes[key] = _dtype_name(leaf.dtype)
    return flat, dtypes


class Checkpointer:
    def __init__(self, directory: str, keep_last_k: int = 3):
        self.dir = directory
        self.keep = keep_last_k
        self._thread: Optional[threading.Thread] = None
        if directory:
            os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, state, step: int, blocking: bool = True,
             extra: Optional[Dict[str, Any]] = None) -> None:
        if not self.dir:
            return
        flat, dtypes = _flatten(state)   # host copy happens on the calling thread
        manifest = {
            "step": int(step),
            "keys": sorted(flat),
            "dtypes": dtypes,
            "shapes": {key: list(arr.shape) for key, arr in flat.items()},
            "extra": extra or {},
            "format": 1,
        }
        if blocking:
            self._write(flat, manifest, step)
        else:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(flat, manifest, step), daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def delete(self) -> None:
        """Remove the whole checkpoint directory (after any in-flight async
        save)."""
        self.wait()
        if self.dir and os.path.isdir(self.dir):
            shutil.rmtree(self.dir, ignore_errors=True)

    def _write(self, flat, manifest, step: int) -> None:
        tmp = os.path.join(self.dir, f"step_{step:010d}.tmp")
        final = os.path.join(self.dir, f"step_{step:010d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)            # atomicity boundary
        self._cleanup()

    def _cleanup(self) -> None:
        steps = self.list_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def list_steps(self):
        if not self.dir or not os.path.isdir(self.dir):
            return []
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                man = os.path.join(self.dir, name, "manifest.json")
                if os.path.exists(man):
                    try:
                        with open(man) as f:
                            steps.append(int(json.load(f)["step"]))
                    except (ValueError, KeyError, json.JSONDecodeError):
                        continue          # corrupt manifest -> skip
        return sorted(steps)

    def restore(self, template, step: Optional[int] = None) -> Tuple[Any, int]:
        """Restore into the structure of ``template``, each leaf on the
        device of the template's leaf. Returns (state, step)."""
        steps = self.list_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        step = step if step is not None else steps[-1]
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as npz:
            flat = {k: npz[k] for k in npz.files}

        paths = tree_flatten_with_path(template)
        missing = [k for k, _ in paths if k not in flat]
        if missing:
            raise KeyError(
                f"checkpoint step {step} in {self.dir} does not match the "
                f"restore template: missing keys {missing} "
                f"(checkpoint holds {sorted(flat)})")
        mismatched = [
            f"{k}: checkpoint {flat[k].shape}/{manifest['dtypes'][k]} != "
            f"template {tuple(leaf.shape)}/{_dtype_name(leaf.dtype)}"
            for k, leaf in paths
            if (tuple(flat[k].shape), manifest["dtypes"][k])
            != (tuple(leaf.shape), _dtype_name(leaf.dtype))]
        if mismatched:
            raise ValueError(
                f"checkpoint step {step} in {self.dir} does not match the "
                f"restore template: {'; '.join(mismatched)}")
        leaves = [_from_numpy(flat[k], manifest["dtypes"][k], leaf.device)
                  for k, leaf in paths]
        return tree_unflatten_like(template, leaves), step
