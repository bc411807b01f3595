"""Plain torch version of causal (optionally windowed) attention, the
counterpart of the JAX package's ``attention_ref``, and of non-causal
attention over a key length of its own.

Shapes: q ``[B, H, Sq, d]``, k, v ``[B, H, Sk, d]`` (the GQA repeat happens
in ``ops.py``); query i and key j sit at positions i and j, so the mask is
``[Sq, Sk]`` (the causal and window masks are meant for ``Sq == Sk``).
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
    Sq, Sk, d = q.shape[-2], k.shape[-2], q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).to(torch.float32) * scale
    pos_q = torch.arange(Sq, device=q.device)[:, None]
    pos_k = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= pos_q >= pos_k
    if window > 0:
        ok &= (pos_q - pos_k) < window
    scores = torch.where(ok, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(q.dtype), v)
