"""Plain torch version of ``csrc/sweep_epoch_mlp.cu``: the MLP language
model's per-sample gradient, full gradient, loss and one epoch's inner loop
for the C rows of a sweep group, written from the definition
(`repro.core.objectives.MLPObjective._sample_loss`).

The forward and the backward are written out by hand in float64 from the
float32 params, not taken from `torch.func`, so they check the objective's
autograd gradient:

    e = embed[tokens]                       x̂ = e·r,  r = (mean(e²) + 1e-6)^-½
    x = x̂·(1 + norm)                        a = x·w1 + b1,  h = act(a)
    l = h·w2                                f_i = (1/S) Σ_s logsumexp(l_s) − l_s[t_s]

    dl = (softmax(l) − onehot(t)) / S       dw2 = hᵀ·dl
    da = (dl·w2ᵀ)·act'(a)                   db1 = Σ_s da,  dw1 = xᵀ·da
    dx = da·w1ᵀ                             dnorm = Σ_s dx·x̂
    dx̂ = dx·(1 + norm)                      de = r·dx̂ − r³·e·(Σ dx̂·e)/D
    dembed[t] = Σ_{s: tokens_s = t} de_s

each gradient rounded once to float32. The full gradient sums the samples'
float64 gradients in sample order and rounds once; the loss sums their
float64 losses. The epoch runs `kernels.sweep_epoch.ref.epoch_loop`, the
logistic kernel's plain step loop and its draws, around this gradient.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from repro_torch.kernels.sweep_epoch.ref import epoch_loop

ACTIVATIONS = ("relu", "gelu", "silu")   # the kernel's codes 0, 1, 2
_RMS_EPS = 1e-6
_GELU_BETA = 0.7978845608028654          # sqrt(2 / pi)
_GELU_KAPPA = 0.044715


class MLPWidths(NamedTuple):
    """The objective's static widths: the flat row is (b1 [H], embed [V, D],
    norm [D], w1 [D, H], w2 [H, V]); the sequence length S is the data's."""
    vocab_size: int
    d_model: int
    d_hidden: int
    activation: str

    @property
    def flat_dim(self) -> int:
        V, D, H = self.vocab_size, self.d_model, self.d_hidden
        return H + V * D + D + D * H + H * V


def _activate(name: str, a):
    """(act(a), act'(a)) in float64, as torch computes them and their
    backward."""
    if name == "relu":
        y = torch.clamp(a, min=0.0)
        return y, (y > 0).to(a.dtype)
    if name == "gelu":
        a2 = a * a
        t = torch.tanh(_GELU_BETA * (a + _GELU_KAPPA * a2 * a))
        deriv = 0.5 * (1.0 + t) + 0.5 * a * (1.0 - t * t) * _GELU_BETA \
            * (1.0 + 3.0 * _GELU_KAPPA * a2)
        return 0.5 * a * (1.0 + t), deriv
    if name == "silu":
        s = 1.0 / (1.0 + torch.exp(-a))
        return a * s, s * (1.0 + a * (1.0 - s))
    raise ValueError(f"unknown activation {name!r}")


def _unravel(w, widths: MLPWidths):
    """Flat float64 rows [C, d] → (b1 [C, H], embed [C, V, D], norm [C, D],
    w1 [C, D, H], w2 [C, H, V])."""
    V, D, H = widths.vocab_size, widths.d_model, widths.d_hidden
    b1, emb, nrm, w1, w2 = torch.split(w, [H, V * D, D, D * H, H * V], dim=-1)
    C = w.shape[0]
    return (b1, emb.reshape(C, V, D), nrm, w1.reshape(C, D, H),
            w2.reshape(C, H, V))


def _forward(tok, tgt, w, widths: MLPWidths):
    """Row c's params at samples tok[c], tgt[c] [C, B, S]: the activations
    and each sample's loss [C, B], in float64."""
    b1, emb, nrm, w1, w2 = _unravel(w, widths)
    C = w.shape[0]
    e = emb[torch.arange(C, device=w.device)[:, None, None], tok]  # [C,B,S,D]
    r = 1.0 / torch.sqrt(torch.sum(e * e, dim=-1, keepdim=True)
                         / widths.d_model + _RMS_EPS)
    nh = e * r
    x = nh * (1.0 + nrm[:, None, None, :])
    a = torch.matmul(x, w1[:, None]) + b1[:, None, None, :]
    h, deriv = _activate(widths.activation, a)
    logits = torch.matmul(h, w2[:, None])                     # [C,B,S,V]
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tgt[..., None])[..., 0]
    loss = torch.sum(lse - gold, dim=-1) / tok.shape[-1]
    return (e, r, nh, x, h, deriv, logits, lse), loss


def sample_grad64(tokens, targets, i, w, widths: MLPWidths):
    """∇f_i(w) in float64 for each row of ``w`` [C, d] at its own sample
    ``i`` [C] of ``tokens``/``targets`` [n, S]: [C, d] float64."""
    widths = MLPWidths(*widths)
    C = w.shape[0]
    S = tokens.shape[1]
    D = widths.d_model
    w = w.to(torch.float64)
    tok, tgt = tokens[i].long()[:, None], targets[i].long()[:, None]
    (e, r, nh, x, h, deriv, logits, lse), _ = _forward(tok, tgt, w, widths)
    _, _, nrm, w1, w2 = _unravel(w, widths)
    onehot = torch.nn.functional.one_hot(tgt, widths.vocab_size)
    dl = (torch.exp(logits - lse[..., None]) - onehot.to(w.dtype)) / S
    dw2 = torch.matmul(h.transpose(-1, -2), dl)[:, 0]          # [C, H, V]
    da = torch.matmul(dl, w2[:, None].transpose(-1, -2)) * deriv
    db1 = torch.sum(da, dim=2)[:, 0]
    dw1 = torch.matmul(x.transpose(-1, -2), da)[:, 0]          # [C, D, H]
    dx = torch.matmul(da, w1[:, None].transpose(-1, -2))
    dnorm = torch.sum(dx * nh, dim=2)[:, 0]
    dnh = dx * (1.0 + nrm[:, None, None, :])
    c = torch.sum(dnh * e, dim=-1, keepdim=True)
    de = r * dnh - r * r * r * e * c / D                       # [C,1,S,D]
    demb = torch.zeros((C, widths.vocab_size, D), dtype=w.dtype,
                       device=w.device)
    demb.index_put_((torch.arange(C, device=w.device)[:, None], tok[:, 0]),
                    de[:, 0], accumulate=True)
    return torch.cat([db1, demb.reshape(C, -1), dnorm, dw1.reshape(C, -1),
                      dw2.reshape(C, -1)], dim=-1)


def sample_grad_ref(tokens, targets, i, w, widths: MLPWidths):
    """∇f_i(w) [C, d], rounded once to float32."""
    return sample_grad64(tokens, targets, i, w, widths).to(torch.float32)


def loss_ref(tokens, targets, w, widths: MLPWidths):
    """f(w) = (1/n) Σ_i f_i(w) for each row of ``w`` [C, d] → [C] float32."""
    widths = MLPWidths(*widths)
    C = w.shape[0]
    n = tokens.shape[0]
    tok = tokens.long()[None].expand(C, -1, -1)
    tgt = targets.long()[None].expand(C, -1, -1)
    _, loss = _forward(tok, tgt, w.to(torch.float64), widths)
    total = torch.zeros(C, dtype=torch.float64, device=w.device)
    for k in range(n):
        total = total + loss[:, k]
    return (total / n).to(torch.float32)


def full_grad_ref(tokens, targets, w, widths: MLPWidths):
    """(μ, f): μ = (1/n) Σ_i ∇f_i(w) [C, d], the float64 gradients summed
    in sample order and rounded once, and f(w) [C]."""
    C = w.shape[0]
    n = tokens.shape[0]
    acc = torch.zeros(w.shape, dtype=torch.float64, device=w.device)
    for k in range(n):
        i = torch.full((C,), k, dtype=torch.int64, device=w.device)
        acc = acc + sample_grad64(tokens, targets, i, w, widths)
    return (acc / n).to(torch.float32), loss_ref(tokens, targets, w, widths)


def sweep_epoch_mlp_ref(tokens, targets, w, mu, keys, step,
                        tau: Sequence[int], scheme_id: Sequence[int],
                        delay_id: Sequence[int], *, widths: MLPWidths,
                        engine: str, total: int, buf_len: int, option: int,
                        drop_prob: float):
    """tokens, targets [n, S], w [C, d], mu [C, d] (None for Hogwild!),
    keys [C, 2], step [C] → the rows' iterates after one epoch [C, d] and
    the loss at each [C]. ``widths``: an `MLPWidths` or its fields."""
    widths = MLPWidths(*widths)
    u = epoch_loop(
        lambda i, v: sample_grad_ref(tokens, targets, i, v, widths),
        tokens.shape[0], w, mu, keys, step, tau, scheme_id, delay_id,
        engine=engine, total=total, buf_len=buf_len, option=option,
        drop_prob=drop_prob)
    return u, loss_ref(tokens, targets, u, widths)
