"""Sequential SVRG (Johnson & Zhang 2013) — the τ=0 oracle.

The port of `repro.core.svrg`. "If τ=0, the algorithm AsySVRG degenerates to
the sequential (single-thread) version of SVRG." This module IS that
degenerate case: the single-thread baseline and the oracle the delay engine
must match at τ=0. Its inner update is the fused ``svrg_update`` kernel.

For grid runs, serial SVRG rows go through the delay engine instead:
`repro_torch.core.sweep` maps ``SweepSpec(algo="svrg")`` onto
`asysvrg._epoch_core` with τ=0 / zero delays / consistent reads.
`sweep_spec` builds that spec from `run_svrg`'s arguments.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import prng
from repro_torch.core.objective import Objective
from repro_torch.kernels.svrg_update.ops import svrg_update


def sweep_spec(step_size: float, num_inner: Optional[int] = None,
               option: int = 2, seed: int = 0):
    """`run_svrg(obj, E, step_size, num_inner, option, seed)` as a sweep row
    (``SweepSpec(algo="svrg")``); `num_inner=None` keeps the 2n default."""
    from repro_torch.core.sweep import SweepSpec   # sweep imports this module
    return SweepSpec(algo="svrg", step_size=step_size,
                     inner_steps=num_inner or 0, option=option, seed=seed,
                     num_threads=1, scheme="consistent", tau=0)


def svrg_epoch(obj: Objective, w, key, step_size: float,
               num_inner: int, option: int = 2):
    """One outer iteration of Algorithm 1 with p=1.

    u_0 = w; full gradient μ = ∇f(w); num_inner inner updates
    v_m = ∇f_{i_m}(u_m) − ∇f_{i_m}(u_0) + μ ;  u_{m+1} = u_m − η v_m.
    Option 1 returns the last iterate, option 2 the average of
    u_0 … u_{num_inner−1} (the paper's analysis uses option 2).
    """
    mu = obj.full_grad(w)
    u0 = w
    idx = prng.randint(key.to(w.device), (num_inner,), 0, obj.n)
    lr = torch.full((1,), step_size, dtype=torch.float32, device=w.device)
    u = u0
    acc = torch.zeros_like(u0) if option == 2 else None
    if acc is not None and num_inner > 0:
        acc += u0
    for m, i in enumerate(idx):
        # the running sum u_0 + … + u_{M−1}: each update but the last adds
        # its result in the kernel's epilogue
        u = svrg_update(u, obj.sample_grad(u, i), obj.sample_grad(u0, i), mu,
                        lr, acc=None if m == num_inner - 1 else acc)
    return u if option == 1 else acc / num_inner


def run_svrg(obj: Objective, epochs: int, step_size: float,
             num_inner: Optional[int] = None, option: int = 2,
             seed: int = 0, w0=None):
    """Run SVRG for ``epochs`` outer iterations on the objective's device;
    returns (flat w, per-epoch loss list)."""
    num_inner = num_inner or 2 * obj.n
    w = obj.init_flat() if w0 is None else obj.as_flat(w0)
    key = prng.PRNGKey(seed, w.device)
    history = [obj.loss(w)]
    for _ in range(epochs):
        key, sub = prng.split(key, 2)
        w = svrg_epoch(obj, w, sub, step_size, num_inner, option)
        history.append(obj.loss(w))
    return w, torch.stack(history).tolist()
