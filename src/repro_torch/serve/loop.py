"""Batched serving loop: prefill + greedy/temperature decode, the port of
the JAX package's ``serve/loop.py``.

The session owns the cache and the position; `generate` drives a fixed
batch of requests. Sampling draws from `repro_torch.prng`, so a seed means
the same noise as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.config import ServeConfig
from repro_torch.models.factory import ModelBundle


class ServeSession:
    """Holds activation-dtype copies of the params, cast once here rather
    than at every call as the JAX package's jit'd functions do: the same
    function, one cast per session."""

    def __init__(self, bundle: ModelBundle, params, cache_len: int,
                 scfg: Optional[ServeConfig] = None):
        self.bundle = bundle
        self.params = bundle.cast(params)
        self.cache_len = cache_len
        self.scfg = scfg or ServeConfig()
        self.cache = None
        self.pos = 0

    def prefill(self, batch):
        """Prefill every input of ``batch`` (the tokens, and the modality
        stubs of the encoder-decoder and vision families), each moved to
        the bundle's device."""
        batch = {name: _on_device(x, self.bundle.device)
                 for name, x in batch.items()}
        logits, self.cache = self.bundle.prefill_fn(
            self.params, batch, self.cache_len)
        self.pos = batch["tokens"].shape[1]
        return logits

    def decode(self, tokens):
        logits, self.cache = self.bundle.decode_fn(
            self.params, self.cache, tokens, self.pos)
        self.pos += 1
        return logits


def _on_device(x, device) -> torch.Tensor:
    """An array (numpy, a JAX array, a tensor) as a tensor on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(np.asarray(x))
    return x.to(device)


def _sample(logits, temperature: float, key):
    """Next tokens [B], int32 as in the JAX package."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return prng.categorical(key, logits / temperature).to(torch.int32)


def generate(bundle: ModelBundle, params, batch, max_new_tokens: int,
             cache_len: int, temperature: float = 0.0, seed: int = 0):
    """Prefill ``batch`` then decode ``max_new_tokens`` (greedy at
    temperature 0); returns [B, max_new_tokens] int32 tokens on the
    bundle's device, as the JAX package does."""
    sess = ServeSession(bundle, params, cache_len)
    key = prng.PRNGKey(seed, bundle.device)
    logits = sess.prefill(batch)
    outs = []
    tok = _sample(logits, temperature, key)
    outs.append(tok)
    for _ in range(max_new_tokens - 1):
        key, sub = prng.split(key)
        logits = sess.decode(tok)
        tok = _sample(logits, temperature, sub)
        outs.append(tok)
    return torch.stack(outs, dim=1)
