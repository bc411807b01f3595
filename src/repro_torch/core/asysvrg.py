"""AsySVRG — the paper's contribution, as an exact delay-simulation engine.

The port of `repro.core.asysvrg`. The paper's analysis (§4) models the
asynchronous run as a SERIAL sequence of updates u_{m+1} = u_m − η v_m whose
gradient was evaluated at a stale view of u, at most τ updates old:

  * consistent reading (§4.1): the read is one whole buffered iterate
    u_{a(m)}, with m − a(m) ≤ τ;
  * inconsistent reading (§4.2, Eq. 10): each coordinate comes from u_{a(m)}
    or u_{a(m)+1};
  * unlock (§5.2): every coordinate has its own age in [a(m), m], and a
    write race drops a random fraction of each update's coordinates.

A ring buffer holds the last τ+1 iterates; delays come from a schedule
("fixed": p round-robin threads, Assumption 3; "uniform": speed jitter).

The engine runs C configurations at once, one row each of a ``[C, d]``
iterate block with per-row τ, scheme, delay kind and step size: a single run
is C = 1, and `repro_torch.core.sweep` batches a group. Rows never mix, so a
row's result does not depend on the rows it runs with.

Every random draw comes from `repro_torch.prng`, which reproduces
`jax.random` bit for bit, from each row's key exactly as the JAX engine
draws it — the same sample indices, delays and reader masks. The JAX
``lax.scan`` becomes a Python loop over steps. At the start of each epoch the
epoch's streams (indices, delays, per-step keys) are drawn vectorised on the
device; the per-coordinate read slots and drop masks follow in chunks of
steps (`_delay_chunks`), so a chunk stays a few tens of MB. Only the schemes
present draw, as under ``lax.switch``. Inside the loop nothing syncs with
the host and nothing branches on a device value: every step is a fixed
sequence of launches, the update itself being the fused ``svrg_update``
kernel (`repro_torch.kernels.svrg_update`), which also writes the new
iterate into its ring slot and adds it to the running sum.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence

import torch

from repro_torch import prng
from repro_torch.config import SVRGConfig
from repro_torch.core.objective import LogisticRegression, Objective
from repro_torch.kernels.svrg_update.ops import svrg_update

SCHEME_IDS = {"consistent": 0, "inconsistent": 1, "unlock": 2}
DELAY_IDS = {"zero": 0, "fixed": 1, "uniform": 2}
_UNLOCK = SCHEME_IDS["unlock"]
# elements of one [steps, C, d] chunk of read slots (int64: 32 MB)
_CHUNK_ELEMS = 1 << 22


class AsyRunResult(NamedTuple):
    w: torch.Tensor
    history: tuple          # objective value after each epoch (incl. epoch 0)
    effective_passes: tuple # cumulative effective passes at each history point
    total_updates: int


def _delay_schedule_core(delay_id, num_updates: int, tau, key) -> torch.Tensor:
    """Delays d_m with 0 ≤ d_m ≤ min(m, τ) for each row: ``key`` [C, 2],
    ``delay_id``/``tau`` [C] → [C, num_updates] int64.

    "fixed":    d_m = min(m, τ) — p equal-speed round-robin threads.
    "uniform":  d_m ~ U{0..min(m, τ)} — jittered thread speeds.
    "zero":     d_m = 0 — degenerates to sequential SVRG.

    All three kinds come from the same key and are selected elementwise;
    τ=0 collapses every kind to zero."""
    m = torch.arange(num_updates, device=key.device)
    tau = torch.as_tensor(tau, device=key.device)[..., None]
    delay_id = torch.as_tensor(delay_id, device=key.device)[..., None]
    cap = torch.minimum(m, tau)
    u = prng.uniform(key, (num_updates,))
    uniform = torch.floor(u * (cap + 1).to(torch.float32)).to(torch.int64)
    return torch.where(delay_id == DELAY_IDS["zero"], 0,
                       torch.where(delay_id == DELAY_IDS["fixed"], cap,
                                   uniform))


# Readers: for rows of one scheme, the ring-buffer slot each coordinate is
# read from. ``a`` (read ages), ``m`` (step) are [R, L]; ``tau`` is [R, 1];
# ``key`` is the per-step read key [R, L, 2]; the result is [R, L, dim].
# The slot arithmetic uses the row's own τ, so a buffer padded to any
# length ≥ τ+1 reads identically.

def _read_consistent(a, m, tau, key, dim):
    """Locked read: one whole iterate of age a."""
    del m, key
    return (a % (tau + 1))[..., None].expand(*a.shape, dim)


def _read_inconsistent(a, m, tau, key, dim):
    """Eq. 10: coordinates mix ages a and a+1 (a+1 capped at m)."""
    mask = prng.bernoulli(key, 0.5, (dim,))
    slot_a = (a % (tau + 1))[..., None]
    slot_b = (torch.minimum(a + 1, m) % (tau + 1))[..., None]
    return torch.where(mask, slot_a, slot_b)


def _read_unlock(a, m, tau, key, dim):
    """Lock-free read: every coordinate gets an independent age in [a, m]."""
    span = (m - a + 1).to(torch.float32)[..., None]
    ages = a[..., None] + torch.floor(
        prng.uniform(key, (dim,)) * span).to(torch.int64)
    return ages % (tau + 1)[..., None]


# in SCHEME_IDS order
_READER_LIST = (_read_consistent, _read_inconsistent, _read_unlock)


def read_dispatch(scheme_id: Sequence[int], tau: torch.Tensor, a, m, key,
                  dim: int) -> torch.Tensor:
    """Ring-buffer slots read at L steps by C rows: ``tau`` [C], ``a`` [C, L]
    ages, ``m`` [L] steps, ``key`` [C, L, 2] read keys → [L, C, dim].

    ``scheme_id`` holds each row's scheme (host ints); each reader runs
    only for the rows of its scheme, as ``lax.switch`` runs one branch.
    """
    C, L = a.shape
    slots = torch.empty((L, C, dim), dtype=torch.int64, device=a.device)
    for sid, reader in enumerate(_READER_LIST):
        rows = [c for c in range(C) if scheme_id[c] == sid]
        if not rows:
            continue
        sel = torch.tensor(rows, device=a.device)
        vals = reader(a[sel], m.expand(len(rows), L), tau[sel][:, None],
                      key[sel], dim)
        slots[:, sel] = vals.transpose(0, 1)
    return slots


def _gather_read(buffer, slots):
    """u_read[c, j] = buffer[c, slots[c, j], j] for buffer [C, B, d]."""
    return buffer.gather(1, slots[:, None, :])[:, 0]


def _delay_chunks(key, n: int, tau: Sequence[int], scheme_id: Sequence[int],
                  delay_id: Sequence[int], *, total: int, dim: int,
                  drop_prob: float):
    """The random streams of one epoch of the delay engine, per row, drawn
    from each row's epoch key ``key`` [C, 2] as the JAX engine draws them,
    and delivered in chunks of consecutive steps.

    Yields ``(idx [L, C], slots [L, C, dim], keep, wslot [L, C])``: sample
    indices, the buffer slot of every coordinate read, the 0/1 write mask
    of the unlock rows (float32 [L, C, dim], ones on other rows; None when
    no row drops coordinates) and the slot each update is written to.
    """
    C = key.shape[0]
    device = key.device
    taus = torch.tensor(list(tau), device=device)
    k_idx, k_delay, k_scan = prng.split(key, 3).unbind(1)
    idx = prng.randint(k_idx, (total,), 0, n)
    delays = _delay_schedule_core(torch.tensor(list(delay_id), device=device),
                                  total, taus, k_delay)
    m = torch.arange(total, device=device)
    ages = torch.clamp(m - delays, min=0)
    wslot = (m + 1) % (taus[:, None] + 1)
    k_read, k_drop = prng.split(prng.split(k_scan, total), 2).unbind(2)
    dropping = [c for c in range(C)
                if drop_prob > 0 and scheme_id[c] == _UNLOCK]
    drop_rows = torch.tensor(dropping, dtype=torch.int64, device=device)
    steps = max(1, _CHUNK_ELEMS // (C * dim))
    for s in range(0, total, steps):
        e = min(total, s + steps)
        slots = read_dispatch(scheme_id, taus, ages[:, s:e], m[s:e],
                              k_read[:, s:e], dim)
        keep = None
        if dropping:
            # unlock write-write race: drop a random coordinate fraction
            keep = torch.ones((e - s, C, dim), device=device)
            draws = prng.bernoulli(k_drop[drop_rows, s:e], 1.0 - drop_prob,
                                   (dim,))
            keep[:, drop_rows] = draws.transpose(0, 1).to(torch.float32)
        yield (idx[:, s:e].T.contiguous(), slots, keep,
               wslot[:, s:e].T.contiguous())


def _epoch_core(obj: Objective, data, w, key, eta, tau, scheme_id, delay_id,
                *, total: int, buf_len: int, option: int, drop_prob: float):
    """One outer iteration of Algorithm 1 for C rows.

    ``w`` [C, d] flat iterates, ``key`` [C, 2] epoch keys, ``eta`` [C]
    float32 step sizes; ``tau``/``scheme_id``/``delay_id`` hold each row's
    value (host ints). Static: total = M̃ = pM, buf_len ≥ max τ + 1, option
    (1 = last iterate, 2 = inner average), drop_prob.
    """
    C, dim = w.shape
    mu = obj.flat_full_grad(data, w)                    # snapshot pass
    u0 = w
    buffer = u0[:, None, :].repeat(1, buf_len, 1)       # slot m%(τ+1) = u_m
    u = u0
    acc = torch.zeros_like(u0) if option == 2 else None  # option 1 never reads it
    for idx, slots, keep, wslot in _delay_chunks(
            key, obj.num_samples(data), tau, scheme_id, delay_id,
            total=total, dim=dim, drop_prob=drop_prob):
        g0s = obj.flat_sample_grad(data, idx, u0)       # [L, C, d]
        gfs = mu.expand(idx.shape[0], C, dim)
        if keep is not None:
            # masking the three inputs with the same 0/1 mask equals masking
            # v = g − g0 + gf, which keeps the update the kernel's 4-read form
            g0s, gfs = g0s * keep, gfs * keep
        for j in range(idx.shape[0]):
            u_read = _gather_read(buffer, slots[j])
            g = obj.flat_sample_grad(data, idx[j], u_read)
            if keep is not None:
                g = g * keep[j]
            # one launch: u_{m+1}, its ring slot and the running sum
            u = svrg_update(u, g, g0s[j], gfs[j], eta, ring=buffer,
                            slot=wslot[j], acc=acc)
    return u if option == 1 else acc / total


def _masked_epochs(obj: Objective, data, w0, key, *, epochs: int,
                   row_epochs: Optional[Sequence[int]],
                   epoch: Callable[[List[int], torch.Tensor, torch.Tensor],
                                   torch.Tensor],
                   loss0: Optional[torch.Tensor] = None):
    """``epochs`` outer iterations of C rows, with the loss recorded after
    every epoch (index 0 = loss at w0: ``loss0`` where the caller has it,
    else ``obj.flat_loss``). ``epoch(live, w, sub)`` runs one
    epoch for the rows ``live`` (host indices) from their iterates and
    epoch keys, and returns their new iterates and the loss at each.

    ``row_epochs`` is each row's own budget (default: ``epochs``): past it a
    row FREEZES — its iterate passes through and its last live loss is
    re-emitted — so a row with a shorter budget equals an independent
    shorter run. Every row's key advances every epoch, as in the JAX scan.
    """
    C = w0.shape[0]
    bound = [epochs] * C if row_epochs is None else [int(e) for e in row_epochs]
    w = w0
    losses = [obj.flat_loss(data, w0) if loss0 is None else loss0]
    for e in range(epochs):
        halves = prng.split(key, 2)
        key, sub = halves[:, 0], halves[:, 1]
        live = [c for c in range(C) if e < bound[c]]
        loss = losses[-1]
        if live:
            sel = torch.tensor(live, device=w.device)
            w_new, loss_new = epoch(live, w[sel], sub[sel])
            w, loss = w.clone(), loss.clone()
            w[sel] = w_new
            loss[sel] = loss_new
        losses.append(loss)
    return w, torch.stack(losses, dim=1)


def _asysvrg_epochs_core(obj: Objective, data, w0, key, eta, tau, scheme_id,
                         delay_id, *, epochs: int, total: int, buf_len: int,
                         option: int, drop_prob: float, row_epochs=None):
    """``epochs`` AsySVRG outer iterations for C rows: returns (w_fin [C, d],
    losses [C, epochs+1]). The ONE definition of the per-row epochs loop:
    `run_asysvrg` runs it with C = 1 and the sweep engine with a group."""

    def epoch(live, w, sub):
        w_new = _epoch_core(
            obj, data, w, sub, eta[live], [tau[c] for c in live],
            [scheme_id[c] for c in live], [delay_id[c] for c in live],
            total=total, buf_len=buf_len, option=option, drop_prob=drop_prob)
        return w_new, obj.flat_loss(data, w_new)

    return _masked_epochs(obj, data, w0, key, epochs=epochs,
                          row_epochs=row_epochs, epoch=epoch)


def _resolve_steps(obj: Objective, cfg: SVRGConfig):
    """(p, M, M̃=pM, clamped τ) from the config — paper §5.1 defaults."""
    p_threads = max(1, cfg.num_threads)
    M = cfg.inner_steps or (2 * obj.n) // p_threads
    total = p_threads * M                               # M̃ = pM
    tau = cfg.tau if cfg.tau else (p_threads - 1)
    tau = max(0, min(tau, total - 1)) if total > 1 else 0
    return p_threads, M, total, tau


def make_delay_schedule(kind: str, num_updates: int, tau: int, key,
                        p: int = 1) -> torch.Tensor:
    """Delays d_m with 0 ≤ d_m ≤ min(m, τ) for one configuration, from a
    key [2], as [num_updates] int32 (the JAX package's dtype).

    "fixed":    d_m = min(m, τ)  — p equal-speed round-robin threads
                (thread that applies update m read the iterate τ updates ago).
    "uniform":  d_m ~ U{0..min(m, τ)} — jittered thread speeds.
    "zero":     d_m = 0 — degenerates to sequential SVRG.

    ``p`` is accepted for the JAX package's signature; τ carries it.
    """
    del p
    if kind not in DELAY_IDS:
        raise ValueError(f"unknown delay schedule {kind!r}")
    delay_id = DELAY_IDS["zero"] if tau == 0 else DELAY_IDS[kind]
    return _delay_schedule_core(delay_id, num_updates, tau,
                                key).to(torch.int32)


def _check_kinds(scheme: str, delay_kind: str) -> None:
    if scheme not in SCHEME_IDS:
        raise ValueError(f"unknown scheme {scheme!r}")
    if delay_kind not in DELAY_IDS:
        raise ValueError(f"unknown delay schedule {delay_kind!r}")


def asysvrg_epoch(obj: Objective, w, key, cfg: SVRGConfig,
                  delay_kind: str = "fixed", drop_prob: float = 0.02):
    """One outer iteration of Algorithm 1 under the chosen reading scheme:
    flat ``w`` [d] and key [2] → w_{t+1} [d] per cfg.option."""
    _check_kinds(cfg.scheme, delay_kind)
    _, _, total, tau = _resolve_steps(obj, cfg)
    delay_id = DELAY_IDS["zero"] if tau == 0 else DELAY_IDS[delay_kind]
    w = obj.as_flat(w)
    eta = torch.full((1,), cfg.step_size, dtype=torch.float32, device=w.device)
    return _epoch_core(
        obj, obj.data_args(), w[None], key.to(w.device)[None], eta, [tau],
        [SCHEME_IDS[cfg.scheme]], [delay_id], total=total, buf_len=tau + 1,
        option=cfg.option, drop_prob=drop_prob)[0]


def run_asysvrg(obj: Objective, epochs: int, cfg: SVRGConfig,
                seed: int = 0, w0=None, delay_kind: str = "fixed",
                drop_prob: float = 0.02) -> AsyRunResult:
    """Multi-epoch driver for one configuration, on the objective's device.

    Effective-pass accounting follows §5.1: each epoch visits the dataset
    1 + M̃/n times (1 full-gradient pass + M̃ inner visits).
    `AsyRunResult.w` is the flat iterate.
    """
    _check_kinds(cfg.scheme, delay_kind)
    w = obj.init_flat() if w0 is None else obj.as_flat(w0)
    _, _, total, tau = _resolve_steps(obj, cfg)
    delay_id = DELAY_IDS["zero"] if tau == 0 else DELAY_IDS[delay_kind]
    passes_per_epoch = 1.0 + total / obj.n
    eta = torch.full((1,), cfg.step_size, dtype=torch.float32, device=w.device)
    w_fin, losses = _asysvrg_epochs_core(
        obj, obj.data_args(), w[None], prng.PRNGKey(seed, w.device)[None],
        eta, [tau], [SCHEME_IDS[cfg.scheme]], [delay_id], epochs=epochs,
        total=total, buf_len=tau + 1, option=cfg.option, drop_prob=drop_prob)
    passes = [0.0]
    for _ in range(epochs):
        passes.append(passes[-1] + passes_per_epoch)
    return AsyRunResult(w=w_fin[0], history=tuple(losses[0].tolist()),
                        effective_passes=tuple(passes),
                        total_updates=epochs * total)


def parallel_full_grad(obj: LogisticRegression, w, p_threads: int):
    """The paper's partitioned snapshot pass: thread a computes φ_a over its
    disjoint shard; the sum of partitions equals n·∇f(w) (up to the L2 term).
    Used by tests to verify the partitioned pass is exact."""
    n = obj.n
    base = n // p_threads
    sizes = [base + (1 if a < n % p_threads else 0) for a in range(p_threads)]
    parts = []
    lo = 0
    for sz in sizes:
        parts.append(obj.partial_full_grad(w, lo, sz))
        lo += sz
    return sum(parts) / n + obj.l2 * w
