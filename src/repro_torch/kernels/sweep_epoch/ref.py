"""Plain torch version of one epoch's inner loop for the C rows of a sweep
group: the function ``csrc/sweep_epoch.cu`` computes, written straight from
the definition (`repro.core.asysvrg._epoch_core`,
`repro.core.hogwild._hogwild_epoch_core`). Its step loop (`epoch_loop`,
around any objective's sample gradient) and its draws are also the MLP
kernel's plain version's (`repro_torch.kernels.sweep_epoch_mlp.ref`).

A Python loop over the ``total`` steps; rows run side by side and never mix.
Each row's draws come from its epoch key with `repro_torch.prng`, as the
JAX engine draws them: ``k_idx, k_delay, k_scan = split(key, 3)``, the
sample indices ``randint(k_idx, (total,))``, the delays from
``uniform(k_delay, (total,))``, and at step m ``k_read, k_drop =
split(split(k_scan, total)[m])`` with per-coordinate ``(d,)`` draws. It
shares no code with the batched engine's chunked streams
(`repro_torch.core.asysvrg._delay_chunks`), so it checks them.

Float32 arithmetic in the kernel's order: the margin is summed in float64
and the sigmoid taken in float64, rounded once; the sample gradient adds
the penalty's gradient (L2 or clipped, `repro_torch.kernels.regularizer`);
the update is
``u − step·((g − g0) + mu)`` (Hogwild!: ``u − step·g``); option 2 returns
``acc / total``. The loss at the new iterate is summed in float64 and
rounded once, as `repro_torch.core.objective.loss_fixed_order` computes it.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch import prng
from repro_torch.kernels import regularizer

ENGINES = ("asysvrg", "hogwild")
_CONSISTENT, _INCONSISTENT, _UNLOCK = 0, 1, 2
_ZERO, _FIXED = 0, 1


def _sample_grad(x, yi, reg, w):
    """∇f_i(w) = −y_i σ(−y_i x_i·w) x_i + R'(w) for one sample per row."""
    z = torch.sum(x * w, dim=-1, dtype=torch.float64)
    s = torch.sigmoid(-yi * z).to(torch.float32)
    return (-yi * s)[:, None] * x + regularizer.grad(reg, w)


def _loss(X, y, reg, w):
    """f(w) for each row of ``w`` [C, d] → [C]."""
    z = -(y * torch.sum(X * w[:, None, :], dim=-1, dtype=torch.float64))
    t = torch.logaddexp(torch.zeros_like(z), z)
    return ((torch.sum(t, dim=-1) / X.shape[0]).to(w.dtype)
            + regularizer.value(reg, w))


def epoch_streams(keys, n: int, total: int, tau, delay_id):
    """Per row: sample indices and read ages [C, total] (int64), and the
    read and drop keys of every step [C, total, 2]."""
    m = torch.arange(total, device=keys.device)
    k_idx, k_delay, k_scan = prng.split(keys, 3).unbind(1)
    idx = prng.randint(k_idx, (total,), 0, n)
    cap = torch.minimum(m, tau[:, None])
    u = prng.uniform(k_delay, (total,))
    jitter = torch.floor(u * (cap + 1).to(torch.float32)).to(torch.int64)
    did = delay_id[:, None]
    delay = torch.where(did == _ZERO, 0, torch.where(did == _FIXED, cap, jitter))
    age = torch.clamp(m - delay, min=0)
    k_read, k_drop = prng.split(prng.split(k_scan, total), 2).unbind(2)
    return idx, age, k_read, k_drop


def draws(key, n: int, d: int, tau: int, delay_id: int, steps: int):
    """One key's first ``steps`` steps: sample index and read age [steps],
    reader and drop uniforms [steps, d] — what the kernel draws."""
    ints = dict(dtype=torch.int64, device=key.device)
    idx, age, k_read, k_drop = epoch_streams(
        key[None], n, steps, torch.tensor([tau], **ints),
        torch.tensor([delay_id], **ints))
    return (idx[0], age[0], prng.uniform(k_read[0], (d,)),
            prng.uniform(k_drop[0], (d,)))


def sweep_epoch_ref(X, y, reg, w, mu, keys, step, tau: Sequence[int],
                    scheme_id: Sequence[int], delay_id: Sequence[int], *,
                    engine: str, total: int, buf_len: int, option: int,
                    drop_prob: float):
    """X [n, d], y [n], w [C, d], mu [C, d] (None for Hogwild!), keys
    [C, 2], step [C] → the rows' iterates after one epoch [C, d] and the
    loss at each [C]. ``reg``: a float λ (L2) or ``(lam, alpha)``
    (clipped)."""
    reg = regularizer.regularizer(reg)
    u = epoch_loop(lambda i, v: _sample_grad(X[i], y[i], reg, v), X.shape[0],
                   w, mu, keys, step, tau, scheme_id, delay_id, engine=engine,
                   total=total, buf_len=buf_len, option=option,
                   drop_prob=drop_prob)
    return u, _loss(X, y, reg, u)


def check_rows(C: int, tau, scheme_id, delay_id, *, engine: str, total: int,
               buf_len: int, option: int, drop_prob: float) -> None:
    """Raise unless the rows' settings are ones the sweep kernels take."""
    if engine not in ENGINES:
        raise ValueError(f"sweep_epoch: unknown engine {engine!r}")
    if engine == "asysvrg" and option not in (1, 2):
        raise ValueError(f"sweep_epoch: option must be 1 or 2, got {option}")
    if not len(tau) == len(scheme_id) == len(delay_id) == C:
        raise ValueError(f"sweep_epoch: tau, scheme_id and delay_id need one "
                         f"entry per row ({C})")
    if total < 1 or min(tau) < 0 or buf_len < max(tau) + 1:
        raise ValueError(f"sweep_epoch: total {total}, buf_len {buf_len} "
                         f"and tau {list(tau)} need total >= 1 and "
                         "buf_len >= max(tau) + 1")
    if not set(scheme_id) <= {0, 1, 2} or not set(delay_id) <= {0, 1, 2}:
        raise ValueError("sweep_epoch: scheme and delay ids are 0, 1 or 2")
    if not 0.0 <= drop_prob < 1.0:
        raise ValueError(f"sweep_epoch: drop_prob {drop_prob} not in [0, 1)")


def epoch_loop(sample_grad, n: int, w, mu, keys, step, tau: Sequence[int],
               scheme_id: Sequence[int], delay_id: Sequence[int], *,
               engine: str, total: int, buf_len: int, option: int,
               drop_prob: float):
    """The update chain of one epoch for the rows of ``w`` [C, d], in the
    kernels' order, around ``sample_grad(i [C], u [C, d]) -> [C, d]``, the
    objective's float32 sample gradient of each row's sample at its own
    iterate: the rows' results [C, d] (the last iterate, or for AsySVRG
    with option 2 the epoch's average). Shared by the plain versions of
    both sweep kernels."""
    C, d = w.shape
    device = w.device
    ints = dict(dtype=torch.int64, device=device)
    taus = torch.tensor(list(tau), **ints)
    scheme = torch.tensor(list(scheme_id), **ints)[:, None]
    idx, age, k_read, k_drop = epoch_streams(
        keys, n, total, taus, torch.tensor(list(delay_id), **ints))
    slots = taus + 1
    rows = torch.arange(C, device=device)
    svrg = engine == "asysvrg"
    readers = any(s != _CONSISTENT for s in scheme_id)
    dropping = drop_prob > 0 and any(s == _UNLOCK for s in scheme_id)
    keep_p = float(np.float32(1.0 - drop_prob))
    rate = step[:, None]
    ring = w[:, None, :].repeat(1, buf_len, 1)          # slot m%(τ+1) = u_m
    u, acc = w, torch.zeros_like(w)
    for m in range(total):
        a = age[:, m]
        slot = (a % slots)[:, None].expand(C, d)
        if readers:
            r = prng.uniform(k_read[:, m], (d,))
            slot_b = (torch.clamp(a + 1, max=m) % slots)[:, None]
            mixed = torch.where(r < 0.5, slot, slot_b)
            span = (m - a + 1).to(torch.float32)[:, None]
            ages = a[:, None] + torch.floor(r * span).to(torch.int64)
            slot = torch.where(scheme == _INCONSISTENT, mixed,
                               torch.where(scheme == _UNLOCK,
                                           ages % slots[:, None], slot))
        i = idx[:, m]
        g = sample_grad(i, ring.gather(1, slot[:, None, :])[:, 0])
        keep = None
        if dropping:
            kept = (prng.uniform(k_drop[:, m], (d,)) < keep_p).to(torch.float32)
            keep = torch.where(scheme == _UNLOCK, kept, 1.0)
        if svrg:
            g0, gf = sample_grad(i, w), mu
            if keep is not None:
                g, g0, gf = g * keep, g0 * keep, gf * keep
            u = u - rate * ((g - g0) + gf)
            acc = acc + u
        else:
            if keep is not None:
                g = g * keep
            u = u - rate * g
        ring[rows, (m + 1) % slots] = u
    if svrg and option == 2:
        u = acc / torch.full((C, 1), float(total), device=device)
    return u
