"""Plain torch version of causal (optionally windowed) attention, the
counterpart of the JAX package's ``attention_ref``.

Shapes: q, k, v ``[B, H, S, d]`` (the GQA repeat happens in ``ops.py``).
The order of rounding is the JAX oracle's: scores in the input dtype, then
float32 and scaled; masked entries set to -1e30; softmax in float32; the
probabilities cast to the input dtype before the product with v.
``window=0`` means global.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, causal: bool = True, window: int = 0):
    S, d = q.shape[-2], q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).to(torch.float32) * scale
    pos = torch.arange(S, device=q.device)
    pos_q, pos_k = pos[:, None], pos[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        ok &= pos_q >= pos_k
    if window > 0:
        ok &= (pos_q - pos_k) < window
    scores = torch.where(ok, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(q.dtype), v)
