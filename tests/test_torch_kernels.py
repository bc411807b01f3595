"""The port's kernels on the CPU: each plain version against the JAX
package's kernel (Pallas interpret mode) and its jnp oracle, plus the
wrappers' device dispatch.

Tolerances are those of tests/test_kernels.py: svrg_update float32 atol
1e-6 (bfloat16 2e-2: the JAX oracle rounds to bfloat16 between operations,
the port computes in float32), logreg_grad atol 1e-5 (summation order).
The CUDA kernels themselves run only on the card (chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.objective import full_grad_stable as jax_full_grad_stable
from repro.kernels.logreg_grad import ops as jax_logreg_ops
from repro.kernels.svrg_update import ops as jax_svrg_ops
from repro.kernels.svrg_update.ref import svrg_update_ref as jax_svrg_ref
from repro_torch.kernels import dispatch
from repro_torch.kernels.logreg_grad.ops import logreg_grad
from repro_torch.kernels.logreg_grad.ref import logreg_grad_ref
from repro_torch.kernels.svrg_update.ops import svrg_update
from repro_torch.kernels.svrg_update.ref import svrg_update_ref

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-6),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("shape", [(64,), (1000,), (3, 2048), (4, 33)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_svrg_update_plain_matches_jax(shape, dtype, wd):
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _inputs(shape, seed=len(shape) + shape[-1])
    j_args = [jnp.asarray(a).astype(jdt) for a in arrays]
    t_args = [torch.tensor(a).to(tdt) for a in arrays]
    out = svrg_update(*t_args, 0.07, wd=wd)
    assert out.dtype == tdt and out.shape == t_args[0].shape
    got = out.to(torch.float32).numpy()
    for want in (jax_svrg_ref(*j_args, 0.07, wd),
                 jax_svrg_ops.apply_leaf(*j_args, 0.07, wd=wd, interpret=True,
                                         force_kernel=True)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol)


def test_svrg_update_per_row_lr():
    """One call with lr[C] equals C one-row calls, bit for bit."""
    u, g, g0, gf = (torch.tensor(a) for a in _inputs((3, 50), seed=1))
    lr = torch.tensor([0.5, 0.01, 2.0])
    out = svrg_update(u, g, g0, gf, lr)
    for c in range(3):
        one = svrg_update(u[c], g[c], g0[c], gf[c], float(lr[c]))
        assert torch.equal(out[c], one)


@pytest.mark.parametrize("shape", [(64,), (1, 2048), (3, 50), (4, 33)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("epilogue", ["ring", "acc", "ring+acc"])
def test_svrg_update_epilogue_plain(shape, dtype, epilogue):
    """The plain version's ``ring``/``slot``/``acc`` keywords equal the torch
    ops the engine ran before (``ring[rows, slot] = u'``, ``acc += u'``), bit
    for bit, and leave u' as it is; u' against JAX's `apply_leaf`."""
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _inputs(shape, seed=7 + shape[-1])
    u, g, g0, gf = (torch.tensor(a).to(tdt) for a in arrays)
    rows, d = (shape[0] if len(shape) == 2 else 1), shape[-1]
    lr = torch.linspace(0.05, 0.5, rows)
    lr_arg = lr if len(shape) == 2 else float(lr[0])
    rng = np.random.default_rng(3)
    ring0 = torch.tensor(rng.standard_normal((rows, 5, d)),
                         dtype=torch.float32).to(tdt)
    acc0 = torch.tensor(rng.standard_normal(shape), dtype=torch.float32).to(tdt)
    slot = torch.tensor(rng.integers(0, 5, rows), dtype=torch.int64)
    ring, acc = ring0.clone(), acc0.clone()
    kw = dict(ring=ring if "ring" in epilogue else None,
              slot=slot if "ring" in epilogue else None,
              acc=acc if "acc" in epilogue else None)
    out = svrg_update(u, g, g0, gf, lr_arg, **kw)
    bare = svrg_update(u, g, g0, gf, lr_arg)
    assert torch.equal(out, bare)
    want_ring, want_acc = ring0.clone(), acc0.clone()
    if "ring" in epilogue:
        want_ring[torch.arange(rows), slot] = bare.reshape(rows, d)
    if "acc" in epilogue:
        want_acc += bare
    assert torch.equal(ring, want_ring) and torch.equal(acc, want_acc)
    got = out.to(torch.float32).numpy().reshape(rows, d)
    for c in range(rows):   # apply_leaf takes one step size
        j_args = [jnp.asarray(a.reshape(rows, d)[c]).astype(jdt)
                  for a in arrays]
        want = jax_svrg_ops.apply_leaf(*j_args, float(lr[c]), interpret=True,
                                       force_kernel=True)
        np.testing.assert_allclose(got[c], np.asarray(want, np.float32),
                                   atol=tol)


@pytest.mark.parametrize("B,P", [(96, 64), (200, 300), (128, 512)])
def test_logreg_grad_plain_matches_jax(B, P):
    rng = np.random.default_rng(B + P)
    X = (rng.standard_normal((B, P)) / np.sqrt(P)).astype(np.float32)
    y = np.where(rng.random(B) < 0.5, -1.0, 1.0).astype(np.float32)
    w = (0.3 * rng.standard_normal(P)).astype(np.float32)
    got = logreg_grad(torch.tensor(X), torch.tensor(y),
                      torch.tensor(w)[None], 1e-4)[0].numpy()
    kern = jax_logreg_ops.logreg_grad(jnp.asarray(X), jnp.asarray(y),
                                      jnp.asarray(w), 1e-4, interpret=True,
                                      force_kernel=True)
    stable = jax_full_grad_stable(jnp.asarray(X), jnp.asarray(y), 1e-4,
                                  jnp.asarray(w))
    np.testing.assert_allclose(got, np.asarray(kern), atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(stable), atol=1e-5)


def test_logreg_grad_rows_independent():
    """C = 3 in one call equals three C = 1 calls, bit for bit."""
    rng = np.random.default_rng(5)
    X = torch.tensor(rng.standard_normal((96, 64)).astype(np.float32))
    y = torch.tensor(np.where(rng.random(96) < 0.5, -1.0, 1.0), dtype=torch.float32)
    W = torch.tensor(rng.standard_normal((3, 64)).astype(np.float32))
    G = logreg_grad(X, y, W, 1e-3)
    assert G.shape == (3, 64)
    for c in range(3):
        assert torch.equal(G[c], logreg_grad(X, y, W[c:c + 1], 1e-3)[0])
    assert torch.equal(G, logreg_grad_ref(X, y, W, 1e-3))


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrappers never launch (their counts stay put)."""
    before = (svrg_update.launches, logreg_grad.launches)
    x = torch.ones(2, 8)
    assert torch.equal(svrg_update(x, x, x, x, 0.5),
                       svrg_update_ref(x, x, x, x, 0.5))
    logreg_grad(x, torch.ones(2), torch.ones(1, 8), 0.0)
    assert (svrg_update.launches, logreg_grad.launches) == before


def test_route_follows_the_device():
    cpu = torch.zeros(3)
    assert dispatch.route(cpu, cpu) == dispatch.REFERENCE
    with pytest.raises(ValueError):
        dispatch.route(torch.zeros(3, device="meta"))
    with pytest.raises(ValueError):
        dispatch.route(cpu, torch.zeros(3, device="meta"))
