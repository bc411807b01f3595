"""Beyond-paper objectives on the pluggable protocol: an MLP language model
(pytree params, nonconvex) and a nonconvex-regularized logistic regression.

The port of `repro.core.objectives`. Huo & Huang (1604.03584), Lian et al.
(1506.08272) and Reddi et al. (1506.06840) show that the AsySVRG/Hogwild!
semantics extend to nonconvex objectives: the engines never assumed
convexity. Both classes keep the port's row contract: a row's result never
depends on the other rows it is computed with (to within float64 rounding).

* `NonconvexLogistic` shares the logistic math of
  `repro_torch.core.objective` with the clipped penalty in place of the L2
  one, so its snapshot gradient goes through the ``logreg_grad`` kernel (K2)
  and, with ``engine_mode="fused"``, its epochs through ``sweep_epoch``
  (K3), both taking the penalty as an argument
  (`repro_torch.kernels.regularizer`).
* `MLPObjective` computes on the flat rows the engines hand it: each row
  is unravelled into the param dict, the forward runs in float64 and every
  gradient comes from `torch.func.grad` of it, batched over rows and
  samples with `torch.func.vmap`, rounded once to float32 (the JAX package
  computes in float32 with summation orders it pins; float64 here makes the
  rows independent of their batch and the card agree with the CPU). The
  batched engine runs its updates through K1; with ``engine_mode="fused"``
  its epochs, snapshot gradients and losses go through its own kernel
  (`repro_torch.kernels.sweep_epoch_mlp`), whose hand-written float64
  forward and backward sit inside the update chain and take the widths
  from `MLPObjective.kernel_widths`.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch.func import grad, vmap

from repro_torch import prng
from repro_torch.core.objective import (
    Objective,
    default_device,
    full_grad_stable,
    loss_fixed_order,
    sample_grad_stable,
)
from repro_torch.models.layers import _act

_RMS_EPS = 1e-6          # models.layers.rmsnorm's
_SAMPLE_BLOCK = 256      # samples per vmap call of a full gradient or loss


class MLPObjective(Objective):
    """Tiny MLP language model over a packed token corpus (pytree params).

    One sample = one packed sequence; the per-sample loss is the mean token
    cross-entropy of next-token prediction through

        one_hot(tokens) @ embed -> rmsnorm -> act(x @ w1 + b1) @ w2 -> CE

    with the activation of `repro_torch.models.layers` and the JAX
    package's rmsnorm (x·rsqrt(mean(x²) + 1e-6)·(1 + norm)), both in
    float64. Params are the dict {embed, norm, w1, b1, w2}, drawn as the
    JAX package draws them (`prng.normal`); flat rows lay the leaves out in
    its tree order (b1, embed, norm, w1, w2). The loss is NONCONVEX.

    ``tokens``/``targets`` are [n, S] integer arrays, e.g. a slice of
    `repro_torch.data.synthetic_lm.SyntheticLMDataset` (see
    :func:`mlp_lm_objective`), kept as int32 tensors on ``device`` (CUDA by
    default; ``device="cpu"`` runs on the CPU).
    """

    def __init__(self, tokens, targets, vocab_size: int, *,
                 d_model: int = 16, d_hidden: int = 32,
                 activation: str = "relu", init_seed: int = 0,
                 init_scale: float = 0.1, device=None):
        tokens = np.asarray(tokens)
        targets = np.asarray(targets)
        if tokens.shape != targets.shape or tokens.ndim != 2:
            raise ValueError(
                f"tokens/targets must be matching [n, S] arrays, got "
                f"{tokens.shape} / {targets.shape}")
        if tokens.min() < 0 or tokens.max() >= vocab_size:
            raise ValueError("token ids out of range for vocab_size="
                             f"{vocab_size}")
        device = default_device(device)
        self.tokens = torch.as_tensor(tokens.astype(np.int32), device=device)
        self.targets = torch.as_tensor(targets.astype(np.int32), device=device)
        self.n, self.seq_len = tokens.shape
        self.vocab_size = int(vocab_size)
        self.d_model = int(d_model)
        self.d_hidden = int(d_hidden)
        self.activation = str(activation)
        self.init_seed = int(init_seed)
        self.init_scale = float(init_scale)

    # -- protocol ------------------------------------------------------------
    def data_args(self) -> Tuple:
        return (self.tokens, self.targets)

    def init_params(self) -> Dict:
        """The JAX package's init: ``split(PRNGKey(init_seed), 3)`` keys the
        embedding, w1 and w2 draws (scaled normals); norm and b1 are zero.
        Drawn on the CPU and moved, so every device starts from the same
        values."""
        k_embed, k_w1, k_w2 = prng.split(prng.PRNGKey(self.init_seed), 3)
        s = self.init_scale
        V, D, H = self.vocab_size, self.d_model, self.d_hidden
        tree = {"embed": s * prng.normal(k_embed, (V, D)),
                "norm": torch.zeros(D),
                "w1": s * prng.normal(k_w1, (D, H)),
                "b1": torch.zeros(H),
                "w2": s * prng.normal(k_w2, (H, V))}
        return {k: v.to(self.tokens.device) for k, v in tree.items()}

    def static_key(self) -> Tuple:
        return (self.vocab_size, self.d_model, self.d_hidden,
                self.activation, self.init_seed, self.init_scale)

    @property
    def kernel_widths(self) -> Tuple[int, int, int, str]:
        """What the fused kernel needs beside the int32 tokens and targets
        of `data_args`: (vocab_size, d_model, d_hidden, activation), the
        fields of `repro_torch.kernels.sweep_epoch_mlp.ref.MLPWidths`."""
        return (self.vocab_size, self.d_model, self.d_hidden,
                self.activation)

    # -- one sample, one flat row (float64) ------------------------------------
    def _sample_loss(self, w, oh, tgt):
        """Mean token CE of one sequence: ``w`` [d] float64 flat params,
        ``oh`` [S, V] float64 one-hot tokens, ``tgt`` [S] targets."""
        p = self.unravel_params(w)
        x = oh @ p["embed"]                                       # [S, D]
        x = (x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True)
                             + _RMS_EPS)) * (1.0 + p["norm"])
        h = _act(self.activation, x @ p["w1"] + p["b1"])         # [S, H]
        logits = h @ p["w2"]                                      # [S, V]
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, tgt[:, None])[:, 0]
        return torch.sum(lse - gold) / self.seq_len

    def _batch(self, data, i, w):
        """Samples ``i`` [*lead] with ``w`` broadcast to [*lead, d], as one
        flat batch: (lead, one-hot tokens [B, S, V] and targets [B, S] of
        the samples, float64 rows [B, d])."""
        tokens, targets = data
        i = torch.as_tensor(i, device=tokens.device)
        lead = tuple(i.shape)
        flat_i = i.reshape(-1).long()
        # one-hot by comparison: F.one_hot checks its indices on the host,
        # a synchronisation per call on the card
        vocab = torch.arange(self.vocab_size, device=tokens.device)
        oh = tokens[flat_i].long()[..., None] == vocab
        rows = torch.broadcast_to(w, lead + (w.shape[-1],))
        return (lead, oh.to(torch.float64), targets[flat_i].long(),
                rows.reshape(-1, w.shape[-1]).to(torch.float64))

    def _over_samples(self, data, w, fn):
        """``fn`` (a per-(row, sample) map of float64 rows, one-hots and
        targets) summed over every sample for each row of ``w`` [..., d],
        in float64 and divided by n: [..., *fn's shape]."""
        n = self.num_samples(data)
        rows = w.reshape(-1, w.shape[-1])
        total = None
        for lo in range(0, n, _SAMPLE_BLOCK):
            i = torch.arange(lo, min(n, lo + _SAMPLE_BLOCK),
                             device=w.device)[:, None]
            i = i.expand(i.shape[0], rows.shape[0])               # [b, R]
            _, oh, tgt, wb = self._batch(data, i, rows)
            part = vmap(fn)(wb, oh, tgt)
            part = part.reshape(i.shape + part.shape[1:]).sum(dim=0)
            total = part if total is None else total + part
        return (total / n).reshape(tuple(w.shape[:-1]) + total.shape[1:])

    # -- engine-facing flat adapters ----------------------------------------
    def flat_loss(self, data, w_flat):
        """f(w) for each row of ``w_flat`` [..., d] → [...] float32."""
        return self._over_samples(data, w_flat,
                                  self._sample_loss).to(torch.float32)

    def flat_full_grad(self, data, w_flat):
        """∇f(w) for each row of ``w_flat`` [..., d]: the per-sample float64
        gradients summed over the samples, rounded once."""
        return self._over_samples(data, w_flat,
                                  grad(self._sample_loss)).to(torch.float32)

    def flat_sample_grad(self, data, i, w_flat):
        """∇f_i(w): ``i`` [*lead] with ``w_flat`` broadcasting against
        [*lead, d] → [*lead, d] float32."""
        lead, oh, tgt, wb = self._batch(data, i, w_flat)
        g = vmap(grad(self._sample_loss))(wb, oh, tgt)
        return g.to(torch.float32).reshape(lead + (w_flat.shape[-1],))

    # -- the pytree forms, through the flat ones: a param tree in, a tree
    # out; a flat vector (what the serial drivers hold) in, a flat one out
    def _like(self, w, flat):
        return self.unravel_params(flat) if isinstance(w, dict) else flat

    def loss_fixed_order(self, data, w):
        return self.flat_loss(data, self.ravel_params(w))

    def full_grad_stable(self, data, w):
        return self._like(w, self.flat_full_grad(data, self.ravel_params(w)))

    def sample_grad_stable(self, data, i, w):
        return self._like(
            w, self.flat_sample_grad(data, i, self.ravel_params(w)))


def mlp_lm_objective(n: int = 64, *, vocab_size: int = 32, seq_len: int = 8,
                     d_model: int = 16, d_hidden: int = 32,
                     activation: str = "relu", seed: int = 0,
                     init_seed: int = 0, device=None) -> MLPObjective:
    """An `MLPObjective` over a materialized `SyntheticLMDataset` slice:
    ``n`` deterministic packed sequences (the same (seed, n) always yields
    the same corpus, in either package)."""
    from repro_torch.data.synthetic_lm import SyntheticLMDataset

    ds = SyntheticLMDataset(vocab_size=vocab_size, seq_len=seq_len,
                            global_batch=n, seed=seed)
    batch = ds.batch_at(0)
    return MLPObjective(batch["tokens"], batch["targets"], vocab_size,
                        d_model=d_model, d_hidden=d_hidden,
                        activation=activation, init_seed=init_seed,
                        device=device)


class NonconvexLogistic(Objective):
    """Logistic loss + a smoothly-clipped (log-penalty style) NONCONVEX
    regularizer on the libsvm sets:

        f(w) = (1/n) Σ_i log(1 + exp(-y_i x_i·w)) + λ Σ_j α w_j² / (1 + α w_j²)

    The regularizer saturates at λ per coordinate (the clipped penalty the
    nonconvex SVRG papers analyze — Reddi et al. 1506.06840 §5; bounded,
    smooth, nonconvex), so large weights stop being pushed toward zero.
    Params are a flat (p,) vector. ``data_args`` is ``(X, y, lam, alpha)``,
    the constants as float32 values, as in the JAX package; ``X`` and ``y``
    are placed on ``device`` as float32 (CUDA by default).
    """

    def __init__(self, X, y, *, lam: float = 1e-3, alpha: float = 10.0,
                 device=None):
        device = default_device(device)
        self.X = torch.as_tensor(X, dtype=torch.float32, device=device)
        self.X = self.X.contiguous()
        self.y = torch.as_tensor(y, dtype=torch.float32, device=device)
        self.y = self.y.contiguous()
        self.lam = float(lam)
        self.alpha = float(alpha)
        self.n, self.p = self.X.shape

    # -- protocol ------------------------------------------------------------
    def data_args(self) -> Tuple:
        return (self.X, self.y, float(np.float32(self.lam)),
                float(np.float32(self.alpha)))

    def init_params(self):
        return torch.zeros(self.p, dtype=torch.float32, device=self.X.device)

    def loss_fixed_order(self, data, w):
        X, y, *reg = data
        return loss_fixed_order(X, y, tuple(reg), w)

    def full_grad_stable(self, data, w):
        X, y, *reg = data
        return full_grad_stable(X, y, tuple(reg), w)

    def sample_grad_stable(self, data, i, w):
        X, y, *reg = data
        return sample_grad_stable(X, y, tuple(reg), w, i)

    # flat == pytree for a (p,) parameter vector: skip the generic bridge
    flat_loss = loss_fixed_order
    flat_full_grad = full_grad_stable
    flat_sample_grad = sample_grad_stable
