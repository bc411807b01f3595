"""repro_torch.core.objective against repro.core.objective on the CPU.

Tolerances: loss rtol 1e-6 (the JAX loss sums in a fixed float32 order, the
port in float64 rounded once), gradients atol 1e-6 (summation order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.asysvrg import parallel_full_grad as jax_parallel_full_grad
from repro.core.objective import LogisticRegression as JaxLogReg
from repro.data.libsvm import make_synthetic_libsvm
from repro_torch import convert
from repro_torch.core import objective as pobj
from repro_torch.core.asysvrg import parallel_full_grad


def _problem(seed=0, n=96, p=64):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((n, p)) / 8).astype(np.float32)
    y = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    W = (0.3 * rng.standard_normal((3, p))).astype(np.float32)
    return (JaxLogReg(X, y, 1e-3),
            pobj.LogisticRegression(X, y, 1e-3, device="cpu"), W)


def test_loss_and_gradients_match_jax():
    jo, po, W = _problem()
    jd, pd = jo.data_args(), po.data_args()
    for w in W:
        jw, tw = jnp.asarray(w), torch.tensor(w)
        np.testing.assert_allclose(float(po.flat_loss(pd, tw)),
                                   float(jo.flat_loss(jd, jw)), rtol=1e-6)
        np.testing.assert_allclose(po.flat_full_grad(pd, tw).numpy(),
                                   np.asarray(jo.flat_full_grad(jd, jw)),
                                   atol=1e-6)
        for i in (0, 17, 95):
            np.testing.assert_allclose(
                po.flat_sample_grad(pd, torch.tensor(i), tw).numpy(),
                np.asarray(jo.flat_sample_grad(jd, i, jw)), atol=1e-6)


def test_batched_rows_equal_single_rows():
    """Every math method treats a [C, p] block row by row, bit for bit."""
    _, po, W = _problem(seed=1)
    d = po.data_args()
    Wt = torch.tensor(W)
    idx = torch.tensor([5, 60, 2])
    loss, grad = po.flat_loss(d, Wt), po.flat_full_grad(d, Wt)
    sgrad = po.flat_sample_grad(d, idx, Wt)
    many = po.flat_sample_grad(d, torch.stack([idx, idx.flip(0)]), Wt)
    for c in range(3):
        assert torch.equal(loss[c], po.flat_loss(d, Wt[c]))
        assert torch.equal(grad[c], po.flat_full_grad(d, Wt[c]))
        assert torch.equal(sgrad[c], po.flat_sample_grad(d, idx[c], Wt[c]))
        assert torch.equal(many[0, c], sgrad[c])


def test_identity_matches_jax():
    jo, po, _ = _problem(seed=2)
    assert po.fingerprint() == jo.fingerprint()
    assert po.param_shapes() == jo.param_shapes()
    assert po.runner_static_key() == jo.runner_static_key()
    assert po.flat_dim == jo.flat_dim == 64
    other = pobj.LogisticRegression(po.X.numpy(), po.y.numpy(), 2e-3,
                                    device="cpu")
    assert other.fingerprint() != po.fingerprint()


def test_parallel_full_grad_matches():
    jo, po, W = _problem(seed=3)
    for threads in (1, 4, 7):
        got = parallel_full_grad(po, torch.tensor(W[0]), threads).numpy()
        np.testing.assert_allclose(
            got, np.asarray(jax_parallel_full_grad(jo, jnp.asarray(W[0]),
                                                   threads)), atol=1e-6)
        np.testing.assert_allclose(
            got, po.full_grad(torch.tensor(W[0])).numpy(), atol=1e-6)


def test_registry():
    _, po, _ = _problem()
    pobj.register_objective("tiny", po)
    try:
        assert pobj.get_objective("tiny") is po
        assert "tiny" in pobj.registered_objectives()
    finally:
        pobj.unregister_objective("tiny")
    with pytest.raises(KeyError):
        pobj.get_objective("tiny")
    with pytest.raises(TypeError):
        pobj.register_objective("bad", object())


def test_convert_carries_jax_state():
    ds = make_synthetic_libsvm("rcv1", scale=0.004)
    jo = JaxLogReg(ds.X, ds.y, ds.l2_reg)
    for source in (ds, jo, (ds.X, ds.y, ds.l2_reg)):
        po = convert.to_objective(source, "cpu")
        assert po.fingerprint() == jo.fingerprint()
    w = convert.to_params(np.ones(ds.p), "cpu")
    assert w.dtype == torch.float32 and w.shape == (ds.p,)
    tree = {"a": {"b": np.ones((2, 3))}, "c": np.zeros(4)}
    shapes = (("a/b", (2, 3), "float32"), ("c", (4,), "float32"))
    assert convert.to_params(tree, "cpu", shapes).tolist() == [1.0] * 6 + [0.0] * 4
