"""Counter-based randomness: the pieces of `jax.random` the engines draw from,
bit for bit, as integer tensor ops.

The JAX package draws every sample index, delay, reader mask and drop mask
from `jax.random` with the threefry2x32 generator in its partitionable mode
(`jax_threefry_partitionable=True`, the default since JAX 0.5). This module
reproduces that generator, so `run_asysvrg(seed=s)` here and in the JAX
package visit the same samples in the same order, and a seed keeps one
meaning across both packages.

A key is an int64 tensor of shape ``[..., 2]`` holding two uint32 words;
leading dimensions batch independent keys (one per sweep row, one per step).
Arithmetic runs in int64 with 32-bit masks because torch's uint32 support is
incomplete. Every function works on any device; nothing here syncs with the
host.

Sources (JAX 0.9.0): ``jax/_src/prng.py`` (`threefry_seed`,
`_threefry2x32_lowering`, `_threefry_split_foldlike`,
`_threefry_random_bits_partitionable`) and ``jax/_src/random.py``
(`_uniform`, `_randint`, `_bernoulli`, `_normal_real`, `_shuffle`).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: ``[0, seed mod 2^32]``."""
    seed = int(seed)
    if not -2**31 <= seed < 2**31:
        raise ValueError(f"seed {seed} does not fit in 32 bits")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64, device=device)


def keys_from_seeds(seeds: Sequence[int], device=None) -> torch.Tensor:
    """``vmap(jax.random.PRNGKey)(seeds)``: one key per seed, ``[len, 2]``."""
    return torch.stack([PRNGKey(s, device) for s in seeds])


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash (20 rounds) of counter words ``(x1, x2)`` under
    key words ``(k1, k2)``; all int64 holding uint32, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def _hash_iota(key: torch.Tensor, shape: Tuple[int, ...]):
    """threefry of the 64-bit iota over ``shape`` (high word 0, as every
    shape here holds fewer than 2^32 elements), for each key in the batch:
    returns two ``[*key.shape[:-1], *shape]`` word tensors."""
    count = int(np.prod(shape)) if shape else 1
    if count >= 2**32:
        raise ValueError(f"shape {shape} holds more than 2^32 elements")
    lo = torch.arange(count, dtype=torch.int64, device=key.device)
    lo = lo.reshape(shape)
    lead = key.shape[:-1]
    expand = (...,) + (None,) * len(shape)
    k1, k2 = key[..., 0][expand], key[..., 1][expand]
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    out_shape = tuple(lead) + tuple(shape)
    return b1.expand(out_shape), b2.expand(out_shape)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` (fold-like form): ``[..., num, 2]``."""
    b1, b2 = _hash_iota(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """32 random bits per element, partitionable form ``bits1 ^ bits2``."""
    b1, b2 = _hash_iota(key, tuple(shape))
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Tuple[int, ...], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=, maxval=)`` in float32 on
    [minval, maxval): the top 23 bits become the mantissa of a float in
    [1, 2), minus 1, then ``max(minval, f * (maxval - minval) + minval)``
    with both bounds rounded to float32."""
    bits = random_bits(key, shape)
    mant = (bits >> 9) | 0x3F800000
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    if (minval, maxval) == (0.0, 1.0):
        return floats                   # the affine map is exact here
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


# The single-precision inverse error function XLA evaluates for
# `lax.erf_inv` (M. Giles' approximation): w = −log1p(−x²); a degree-8
# polynomial in w − 2.5 (w < 5) or in √w − 3, then times x.
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def _erfinv32(x: torch.Tensor) -> torch.Tensor:
    """erfinv of float32 ``x`` in (−1, 1) by XLA's float32 polynomial. The
    Horner steps are fused multiply-adds, as XLA's CPU code runs them,
    formed as an exact float64 product plus a float64 sum rounded once;
    log1p is taken in float64 and rounded. Every step is then an IEEE
    operation, so the result is the same on every device."""
    f64 = torch.float64
    w = -torch.log1p(-(x * x).to(f64)).to(torch.float32)
    small = w < 5.0
    t = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).to(f64)
    coef = [torch.where(small, a, b).to(f64)
            for a, b in zip(_ERFINV_SMALL, _ERFINV_LARGE)]
    p = coef[0].to(torch.float32)
    for c in coef[1:]:
        p = (c + p.to(f64) * t).to(torch.float32)
    return p * x


def normal(key: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in float32: u uniform on the open
    interval (−1, 1) (`uniform` from the float32 just above −1 to 1), then
    ``sqrt(2)·erfinv(u)``. The uniform draws are JAX's bit for bit; the
    inverse error function is XLA's float32 polynomial (`_erfinv32`), which
    lands within an ulp of `jax.random.normal` (within 1e-6, not every bit
    equal: tests/test_torch_objectives.py)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, minval=lo, maxval=1.0)
    return float(np.float32(np.sqrt(2.0))) * _erfinv32(u)


def bernoulli(key: torch.Tensor, p: float, shape: Tuple[int, ...]) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: ``uniform < p`` with ``p``
    rounded to float32, as JAX rounds a Python float."""
    return uniform(key, shape) < float(np.float32(p))


def randint(key: torch.Tensor, shape: Tuple[int, ...], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32 semantics,
    returned as int64): two 32-bit draws folded modulo the span through the
    multiplier ``2^32 mod span``."""
    if not -2**31 <= minval < 2**31 or not -2**31 <= maxval < 2**31:
        raise ValueError("randint bounds must fit in int32")
    k = split(key, 2)
    higher = random_bits(k[..., 0, :], shape)
    lower = random_bits(k[..., 1, :], shape)
    span = max(1, maxval - minval) & MASK32
    multiplier = (2**16 % span)
    multiplier = ((multiplier * multiplier) & MASK32) % span
    offset = ((higher % span) * multiplier) & MASK32
    offset = ((offset + lower % span) & MASK32) % span
    return offset + minval


def gumbel(key: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` in float32, its default ("low")
    mode: ``-log(-log(u))`` with u uniform on [tiny, 1)."""
    tiny = float(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(uniform(key, shape, minval=tiny)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis of float32
    logits: the argmax of Gumbel noise plus the logits (int64)."""
    noise = gumbel(key, tuple(logits.shape))
    return torch.argmax(noise + logits, dim=-1)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` for an int ``n`` (int64 on the
    key's device): ``ceil(3·ln n / ln(2^32 − 1))`` rounds, each splitting
    ``key, sub = split(key)``, drawing 32 random bits per element from
    ``sub`` and stable-sorting the elements by them (JAX's `_shuffle`,
    `lax.sort_key_val`). A bit word is a non-negative int64, so the int64
    sort orders them as JAX's uint32 sort does."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(MASK32)))
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    for _ in range(rounds):
        key, sub = split(key, 2)
        order = torch.sort(random_bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x


def choice(key: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """``jax.random.choice(key, n, (k,), replace=False)``: the first ``k``
    entries of ``permutation(key, n)``."""
    if not 0 <= k <= n:
        raise ValueError(f"cannot draw {k} of {n} without replacement")
    return permutation(key, n)[:k]
