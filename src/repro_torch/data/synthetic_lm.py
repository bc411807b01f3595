"""Deterministic synthetic LM token pipeline, the port of the JAX package's
``data/synthetic_lm.py`` (numpy, the same batches bit for bit).

Produces packed (tokens, targets, mask) batches from a counter-based hash so
any (step, shard) pair regenerates identical data — restart-safe without
storing a cursor beyond the step number, and shardable across data-parallel
hosts by slicing the global batch. The interface (``batch_at(step)``)
matches what a real tokenized-corpus loader would expose. Batches are numpy;
the train loop moves them to its device. ``lm_batch_specs`` is the
dry-run's shape-only batch (`TensorSpec`s).
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def _hash_u32(x: np.ndarray) -> np.ndarray:
    """xxhash-style integer mix, vectorized (counter-based RNG)."""
    x = x.astype(np.uint64)
    x = (x ^ (x >> 33)) * np.uint64(0xFF51AFD7ED558CCD)
    x = (x ^ (x >> 33)) * np.uint64(0xC4CEB9FE1A85EC53)
    x = x ^ (x >> 33)
    return (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)


class SyntheticLMDataset:
    """Counter-based synthetic corpus of ``vocab_size`` tokens.

    Tokens follow a mixture of a hash stream and a deterministic bigram map so
    the LM loss is learnable (non-uniform next-token structure).
    """

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, shard_index: int = 0, num_shards: int = 1):
        if global_batch % num_shards:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"into {num_shards} shards")
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.local_batch = global_batch // num_shards
        self.seed = seed
        self.shard_index = shard_index
        self.num_shards = num_shards

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        b, s = self.local_batch, self.seq_len
        row0 = step * self.global_batch + self.shard_index * self.local_batch
        rows = np.arange(row0, row0 + b, dtype=np.uint64)[:, None]
        cols = np.arange(s + 1, dtype=np.uint64)[None, :]
        ctr = rows * np.uint64(1_000_003) + cols + np.uint64(self.seed) * np.uint64(0x9E3779B9)
        stream = _hash_u32(ctr)
        # learnable structure: with prob 3/4 the next token = f(prev token)
        raw = (stream % np.uint32(self.vocab_size)).astype(np.int32)
        toks = raw.copy()
        follow = (stream % np.uint32(4)) != 0
        for j in range(1, s + 1):
            mapped = (toks[:, j - 1] * 7 + 13) % self.vocab_size
            toks[:, j] = np.where(follow[:, j], mapped, raw[:, j])
        return {
            "tokens": toks[:, :-1],
            "targets": toks[:, 1:],
            "mask": np.ones((b, s), np.float32),
        }

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def lm_batch_specs(global_batch: int, seq_len: int, mesh=None, rules=None
                   ) -> Dict:
    """`TensorSpec` stand-ins for an LM training batch (the dry-run path):
    tokens and targets int32, mask float32, each [global_batch, seq_len]
    placed by `batch_pspec` on ``mesh`` (``rules`` is unused, as in the JAX
    package)."""
    import torch

    from repro_torch.sharding.rules import batch_pspec, spec_on

    spec = batch_pspec(mesh) if mesh is not None else None
    shape = (global_batch, seq_len)
    return {"tokens": spec_on(shape, torch.int32, spec, mesh),
            "targets": spec_on(shape, torch.int32, spec, mesh),
            "mask": spec_on(shape, torch.float32, spec, mesh)}
