"""LibSVM-style binary-classification datasets for the paper's experiments.

The paper evaluates on rcv1 / real-sim / news20 (sparse bag-of-words, labels
in {-1,+1}). Offline we synthesize datasets with matched *statistical* shape
(instances, features, sparsity, label balance, separability) at reduced
feature dimension via feature hashing, plus a real ``parse_libsvm_file`` so
the true datasets can be dropped in unchanged.

Synthesis is numpy-only and seeded by crc32 of the dataset name, so ``X`` and
``y`` come out byte-identical to the JAX package's `repro.data.libsvm` for
the same (name, seed, scale). Storage is dense (n, p) float32; `as_torch`
places it on a device.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class LogRegDataset:
    X: np.ndarray          # (n, p) float32
    y: np.ndarray          # (n,) float32 in {-1, +1}
    name: str = "synthetic"
    l2_reg: float = 1e-4

    @property
    def n(self) -> int:
        return self.X.shape[0]

    @property
    def p(self) -> int:
        return self.X.shape[1]

    def as_torch(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        return (torch.as_tensor(self.X, device=device),
                torch.as_tensor(self.y, device=device))


# Matched to Table 1 of the paper (features reduced by hashing; density kept).
PAPER_DATASETS: Dict[str, Dict] = {
    "rcv1":     dict(n=20242, p=47236, p_reduced=2048, density=0.0016, l2=1e-4),
    "real-sim": dict(n=72309, p=20958, p_reduced=1024, density=0.0024, l2=1e-4),
    "news20":   dict(n=19996, p=1355191, p_reduced=4096, density=0.0003, l2=1e-4),
}


def make_synthetic_libsvm(
    name: str = "rcv1",
    seed: int = 0,
    scale: float = 1.0,
) -> LogRegDataset:
    """Synthesize a dataset with rcv1-like statistics.

    A ground-truth separator w* generates labels with ~8% label noise, so the
    optimum is interior (strongly convex via the L2 term) and the loss
    landscape matches the regime the paper's theory targets.
    """
    spec = PAPER_DATASETS[name]
    n = max(64, int(spec["n"] * scale))
    p = spec["p_reduced"]
    nnz_per_row = max(4, int(spec["density"] * spec["p"]))
    # crc32, NOT hash(): str hashing is salted per process (PYTHONHASHSEED)
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % (2**31))

    X = np.zeros((n, p), dtype=np.float32)
    for i in range(n):
        idx = rng.choice(p, size=min(nnz_per_row, p), replace=False)
        X[i, idx] = rng.standard_normal(len(idx)).astype(np.float32)
    # tf-idf-like positive skew + row normalization (libsvm convention)
    X = np.abs(X) * np.sign(rng.standard_normal((n, p)) + 0.3).astype(np.float32)
    norms = np.linalg.norm(X, axis=1, keepdims=True)
    X = X / np.maximum(norms, 1e-8)

    w_star = rng.standard_normal(p).astype(np.float32) / np.sqrt(p)
    margins = X @ w_star
    y = np.sign(margins + 1e-12)
    flip = rng.random(n) < 0.08
    y = np.where(flip, -y, y).astype(np.float32)
    y[y == 0] = 1.0
    return LogRegDataset(X=X, y=y, name=name, l2_reg=spec["l2"])


def parse_libsvm_file(path: str, num_features: int) -> LogRegDataset:
    """Parse a real libsvm-format file into a dense LogRegDataset."""
    rows, ys = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            ys.append(1.0 if float(parts[0]) > 0 else -1.0)
            row = np.zeros(num_features, np.float32)
            for kv in parts[1:]:
                k, v = kv.split(":")
                j = int(k) - 1
                if 0 <= j < num_features:
                    row[j] = float(v)
            rows.append(row)
    return LogRegDataset(X=np.stack(rows), y=np.asarray(ys, np.float32),
                         name=path)
