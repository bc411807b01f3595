"""repro_torch's beyond-paper objectives, pytree params and the clipped
penalty of K2/K3 against the JAX package on the CPU.

Same numpy-seeded inputs in both packages (96 × 64 logistic data, λ 1e-2,
α 10; `mlp_lm_objective(32, vocab 16, seq 4, d_model 8, d_hidden 16)`).
Tolerances: `NonconvexLogistic`'s loss and gradients within rtol 1e-5,
atol 1e-6 of JAX's (summation order); the MLP's within rtol 1e-5, atol
1e-7 (the port computes in float64 and rounds once, JAX in float32); sweeps
within rtol 1e-5, atol 1e-6 row by row, as tests/test_torch_sweep.py;
`prng.normal` within 1e-6 of `jax.random.normal` (its uniforms equal bits,
its erfinv XLA's float32 polynomial: most values equal bits, not all);
flat layouts, fingerprints and plans equal. On the CPU the fused sweep runs
the plain versions of K2 and K3, equal in bits to the batched engine.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sweep as jsw
from repro.core.objective import LogisticRegression as JaxLogReg
from repro.core.objective import params_from_flat as jax_params_from_flat
from repro.core.objectives import NonconvexLogistic as JaxNonconvex
from repro.core.objectives import mlp_lm_objective as jax_mlp
from repro.utils.tree import tree_ravel as jax_tree_ravel
from repro_torch import prng
from repro_torch.convert import to_objective
from repro_torch.core import sweep as psw
from repro_torch.core.objective import (LogisticRegression, Objective,
                                        params_from_flat)
from repro_torch.core.objectives import (MLPObjective, NonconvexLogistic,
                                         mlp_lm_objective)
from repro_torch.core.svrg import run_svrg
from repro_torch.kernels import regularizer
from repro_torch.kernels.logreg_grad.ops import logreg_grad
from repro_torch.utils.tree import tree_ravel, tree_unravel_fn

TOL = dict(rtol=1e-5, atol=1e-6)
TOL_MLP = dict(rtol=1e-5, atol=1e-7)
LAM, ALPHA = 1e-2, 10.0
MLP_KW = dict(vocab_size=16, seq_len=4, d_model=8, d_hidden=16)


def _data(n=96, p=64, seed=0):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((n, p)) / 8).astype(np.float32)
    y = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def ncv():
    X, y = _data()
    jo = JaxNonconvex(X, y, lam=LAM, alpha=ALPHA)
    return jo, to_objective(jo, "cpu")


@pytest.fixture(scope="module")
def mlp():
    jo = jax_mlp(32, **MLP_KW)
    return jo, to_objective(jo, "cpu")


def _rows(p, C=3, seed=1, scale=0.3):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((C, p))).astype(np.float32)


# ---------------------------------------------------------------------------
# NonconvexLogistic and the clipped penalty
# ---------------------------------------------------------------------------

def test_nonconvex_loss_and_full_grad_match_jax(ncv):
    """f and ∇f for three rows at once (the full gradient through the plain
    version of K2 with the clipped penalty)."""
    jo, po = ncv
    W = _rows(po.p)
    data = jo.data_args()
    want_f = jax.vmap(lambda w: jo.flat_loss(data, w))(W)
    want_g = jax.vmap(lambda w: jo.flat_full_grad(data, w))(W)
    got_f = po.flat_loss(po.data_args(), torch.from_numpy(W))
    got_g = po.flat_full_grad(po.data_args(), torch.from_numpy(W))
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), **TOL)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **TOL)
    assert float(po.loss(torch.zeros(po.p))) == pytest.approx(np.log(2.0))


@pytest.mark.parametrize("lead", [(3,), (5, 3)])
def test_nonconvex_sample_grads_match_jax(ncv, lead):
    """The engines' batched shapes: ``i`` [C] with ``w`` [C, d] (an inner
    update) and ``i`` [L, C] with ``w`` [C, d] (a chunk's g0)."""
    jo, po = ncv
    W = _rows(po.p)
    idx = np.random.default_rng(2).integers(0, po.n, lead)
    data = jo.data_args()
    row = jax.vmap(lambda i, w: jo.flat_sample_grad(data, i, w))
    want = row(idx, W) if len(lead) == 1 else jax.vmap(
        lambda ii: row(ii, W))(jnp.asarray(idx))
    got = po.flat_sample_grad(po.data_args(), torch.from_numpy(idx),
                              torch.from_numpy(W))
    assert tuple(got.shape) == lead + (po.p,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_penalty_plain_forms_match_jax(ncv):
    """regularizer.grad / value against `NonconvexLogistic._penalty_grad` /
    `_penalty`, and the L2 kind against (λ/2)‖w‖² and λw."""
    jo, _ = ncv
    w = _rows(64, C=1, scale=2.0)[0]
    reg = (LAM, ALPHA)
    lam, alpha = jnp.float32(LAM), jnp.float32(ALPHA)
    np.testing.assert_allclose(
        regularizer.grad(reg, torch.from_numpy(w)).numpy(),
        np.asarray(jo._penalty_grad(lam, alpha, w)), rtol=1e-6, atol=0)
    np.testing.assert_allclose(
        float(regularizer.value(reg, torch.from_numpy(w))),
        float(jo._penalty(lam, alpha, w)), rtol=1e-6)
    l2 = regularizer.regularizer(1e-3)
    assert l2.kind == regularizer.L2 and l2.alpha == 0.0
    np.testing.assert_array_equal(regularizer.grad(1e-3, torch.from_numpy(w)),
                                  np.float32(1e-3) * w)
    with pytest.raises(ValueError):
        regularizer.regularizer((1.0, 2.0, 3.0))


def test_logreg_grad_plain_clipped_matches_jax(ncv):
    """K2's plain version with the clipped penalty, rows one at a time and
    together: against JAX's full gradient, and rows independent (bits)."""
    jo, po = ncv
    W = torch.from_numpy(_rows(po.p, C=4))
    G = logreg_grad(po.X, po.y, W, (LAM, ALPHA))
    want = jax.vmap(lambda w: jo.full_grad_stable(jo.data_args(), w))(
        W.numpy())
    np.testing.assert_allclose(G.numpy(), np.asarray(want), **TOL)
    for c in range(4):
        assert torch.equal(G[c], logreg_grad(po.X, po.y, W[c:c + 1],
                                             (LAM, ALPHA))[0])


def _ncv_specs(mod, mode):
    specs = mod.make_grid(step_sizes=(0.5,), num_threads=4, inner_steps=16,
                          seeds=(0, 1))
    specs += [mod.SweepSpec(algo="hogwild", scheme="unlock", step_size=0.5,
                            num_threads=4, tau=-1),
              mod.SweepSpec(algo="svrg", step_size=0.5, num_threads=1,
                            inner_steps=40, epochs=1)]
    return [dataclasses.replace(s, engine_mode=mode) for s in specs]


@pytest.fixture(scope="module")
def ncv_runs(ncv):
    jo, po = ncv
    return (jsw.run_sweep(jo, 2, _ncv_specs(jsw, "vmap")),
            {mode: psw.run_sweep(po, 2, _ncv_specs(psw, mode))
             for mode in ("vmap", "fused")})


@pytest.mark.parametrize("mode", ["vmap", "fused"])
def test_nonconvex_sweep_matches_jax(ncv, ncv_runs, mode):
    """The three schemes, Hogwild! and serial SVRG with a shorter budget,
    batched and fused (K2 and K3 with the clipped penalty), row by row
    against the JAX package's batched sweep; plans and accounting equal."""
    jo, po = ncv
    jres, runs = ncv_runs
    pres = runs[mode]
    assert psw.plan_sweep(po, 2, _ncv_specs(psw, mode)).groups == \
        jsw.plan_sweep(jo, 2, _ncv_specs(jsw, mode)).groups
    assert [dataclasses.replace(s, engine_mode="") for s in pres.specs] == \
        [dataclasses.replace(psw.SweepSpec(**dataclasses.asdict(s)),
                             engine_mode="") for s in jres.specs]
    for c in range(len(pres.specs)):
        np.testing.assert_allclose(pres.histories[c], jres.histories[c], **TOL)
        np.testing.assert_allclose(pres.final_w[c], jres.final_w[c], **TOL)
    np.testing.assert_array_equal(pres.effective_passes,
                                  jres.effective_passes)
    assert np.all(np.diff(pres.histories[:4], axis=1) < 0)


def test_nonconvex_fused_equals_batched_bits(ncv_runs):
    """On the CPU the fused path runs K2's and K3's plain versions, whose
    arithmetic is the batched engine's: equal bits."""
    _, runs = ncv_runs
    np.testing.assert_array_equal(runs["fused"].histories,
                                  runs["vmap"].histories)
    np.testing.assert_array_equal(runs["fused"].final_w, runs["vmap"].final_w)


class _Quadratic(Objective):
    """An objective neither sweep kernel computes."""

    n = 4

    def data_args(self):
        return (torch.zeros((self.n, 3)),)

    def init_params(self):
        return torch.zeros(3)


def test_fused_mode_refuses_the_mlp_with_its_reason(mlp):
    """The MLP's fused mode runs on its own kernel
    (`kernels.sweep_epoch_mlp`): `plan_sweep` admits it, and still refuses,
    with the reason, an objective that no sweep kernel computes."""
    _, pm = mlp
    plan = psw.plan_sweep(pm, 1, [psw.SweepSpec(engine_mode="fused")])
    assert all(key[-1] for key in plan.groups)
    with pytest.raises(NotImplementedError, match="per-sample gradient"):
        psw.plan_sweep(_Quadratic(), 1, [psw.SweepSpec(engine_mode="fused")])
    psw.plan_sweep(_Quadratic(), 1, [psw.SweepSpec(engine_mode="vmap")])
    psw.plan_sweep(pm, 1, [psw.SweepSpec(engine_mode="vmap")])


# ---------------------------------------------------------------------------
# identity, flat layout, conversion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["logreg", "nonconvex", "mlp"])
def test_fingerprint_equals_jax(kind):
    X, y = _data()
    if kind == "logreg":
        jo = JaxLogReg(X, y, 1e-3)
    elif kind == "nonconvex":
        jo = JaxNonconvex(X, y, lam=LAM, alpha=ALPHA)
    else:
        jo = jax_mlp(16, **MLP_KW)
    assert to_objective(jo, "cpu").fingerprint() == jo.fingerprint()


def test_convert_carries_every_field(ncv, mlp):
    jo, po = ncv
    assert isinstance(po, NonconvexLogistic)
    assert (po.lam, po.alpha) == (jo.lam, jo.alpha)
    np.testing.assert_array_equal(po.X.numpy(), np.asarray(jo.X))
    jm, pm = mlp
    assert isinstance(pm, MLPObjective)
    for name in ("n", "seq_len", "vocab_size", "d_model", "d_hidden",
                 "activation", "init_seed", "init_scale"):
        assert getattr(pm, name) == getattr(jm, name)
    np.testing.assert_array_equal(pm.tokens.numpy(), np.asarray(jm.tokens))
    assert pm.tokens.dtype == torch.int32


def test_tree_ravel_order_matches_jax():
    """A nested dict flattens in JAX's tree order (keys sorted at every
    level), and unravels back exactly, batched rows too."""
    rng = np.random.default_rng(3)
    tree = {"z": rng.standard_normal((2, 3)).astype(np.float32),
            "a": {"y": rng.standard_normal(4).astype(np.float32),
                  "b": rng.standard_normal((1, 2)).astype(np.float32)},
            "m": rng.standard_normal(()).astype(np.float32)}
    want = np.asarray(jax_tree_ravel(jax.tree.map(jnp.asarray, tree)))
    ptree = {"z": torch.from_numpy(tree["z"]), "m": torch.from_numpy(tree["m"]),
             "a": {"y": torch.from_numpy(tree["a"]["y"]),
                   "b": torch.from_numpy(tree["a"]["b"])}}
    flat = tree_ravel(ptree)
    np.testing.assert_array_equal(flat.numpy(), want)
    back = tree_unravel_fn(ptree)(flat)
    assert torch.equal(back["a"]["b"], ptree["a"]["b"])
    assert torch.equal(back["m"], ptree["m"])
    rows = tree_unravel_fn(ptree)(torch.stack([flat, 2 * flat]))
    assert rows["z"].shape == (2, 2, 3)
    assert torch.equal(rows["z"][1], 2 * ptree["z"])
    with pytest.raises(ValueError):
        tree_ravel({"a": torch.zeros(2), "b": torch.zeros(2, dtype=torch.int32)})


def test_param_shapes_and_params_from_flat_match_jax(mlp, ncv):
    """`param_shapes` as JAX writes it (paths, shapes, dtype names), and
    `params_from_flat` rebuilding the same tree in both packages."""
    jm, pm = mlp
    assert pm.param_shapes() == jm.param_shapes()
    assert ncv[1].param_shapes() == ncv[0].param_shapes()
    flat = np.random.default_rng(4).standard_normal(pm.flat_dim) \
        .astype(np.float32)
    got, want = params_from_flat(flat, pm.param_shapes()), \
        jax_params_from_flat(flat, jm.param_shapes())
    assert sorted(got) == sorted(want) == ["b1", "embed", "norm", "w1", "w2"]
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
        assert got[key].dtype == want[key].dtype
    bare = params_from_flat(flat[:64], ncv[1].param_shapes())
    np.testing.assert_array_equal(bare, flat[:64])
    with pytest.raises(ValueError):
        params_from_flat(flat[:-1], pm.param_shapes())
    np.testing.assert_array_equal(pm.as_flat(got).numpy(), flat)


# ---------------------------------------------------------------------------
# prng.normal and the MLP
# ---------------------------------------------------------------------------

def test_normal_matches_jax_random_normal():
    """Within 1e-6 of `jax.random.normal` on the same keys; the uniforms are
    JAX's bits, the erfinv XLA's float32 polynomial (Horner steps as fused
    multiply-adds): all but ~1% of the values are equal bits."""
    total, equal = 0, 0
    for seed in (0, 5):
        for key in jax.random.split(jax.random.PRNGKey(seed), 3):
            want = np.asarray(jax.random.normal(key, (512, 16)))
            got = prng.normal(torch.from_numpy(
                np.asarray(key).astype(np.int64)), (512, 16)).numpy()
            assert got.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
            total, equal = total + want.size, equal + int((got == want).sum())
    assert equal / total > 0.95


def test_mlp_init_matches_jax(mlp):
    jm, pm = mlp
    want, got = jm.init_params(), pm.init_params()
    assert sorted(got) == sorted(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=1e-6)
    np.testing.assert_allclose(pm.init_flat().numpy(),
                               np.asarray(jax_tree_ravel(want)), rtol=0,
                               atol=1e-6)


def test_mlp_loss_and_grads_match_jax(mlp):
    """f, ∇f and the sample gradients at [L, C] for two rows (the init and
    a perturbed one), from the JAX init's flat bits."""
    jm, pm = mlp
    w0 = np.asarray(jax_tree_ravel(jm.init_params()))
    W = np.stack([w0, w0 + 0.05 * _rows(w0.size, C=1, seed=5)[0]])
    data = jm.data_args()
    Wt = torch.from_numpy(W)
    batched = jax.jit(lambda data, W: (
        jax.vmap(jm.flat_loss, in_axes=(None, 0))(data, W),
        jax.vmap(jm.flat_full_grad, in_axes=(None, 0))(data, W)))
    want_f, want_g = batched(data, W)
    np.testing.assert_allclose(pm.flat_loss(pm.data_args(), Wt).numpy(),
                               np.asarray(want_f), **TOL_MLP)
    np.testing.assert_allclose(pm.flat_full_grad(pm.data_args(), Wt).numpy(),
                               np.asarray(want_g), **TOL_MLP)
    idx = np.array([[3, 7], [0, 31], [12, 12]])
    row = jax.vmap(jm.flat_sample_grad, in_axes=(None, 0, 0))
    want = jax.jit(jax.vmap(lambda data, ii, W: row(data, ii, W),
                            in_axes=(None, 0, None)))(data, jnp.asarray(idx), W)
    got = pm.flat_sample_grad(pm.data_args(), torch.from_numpy(idx), Wt)
    assert tuple(got.shape) == (3, 2, pm.flat_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_MLP)
    tree = pm.full_grad(pm.init_params())
    assert sorted(tree) == ["b1", "embed", "norm", "w1", "w2"]


def test_mlp_rows_independent_of_their_batch(mlp):
    """A row's sample gradient alone equals the row in a batch, bit for bit
    (float64 inside, rounded once)."""
    _, pm = mlp
    w = pm.init_flat()
    W = torch.stack([w, w + 0.01, w - 0.02])
    idx = torch.tensor([4, 9, 30])
    batch = pm.flat_sample_grad(pm.data_args(), idx, W)
    for c in range(3):
        assert torch.equal(batch[c], pm.flat_sample_grad(
            pm.data_args(), idx[c:c + 1], W[c:c + 1])[0])


def _mlp_specs(mod, n):
    return [mod.SweepSpec(scheme=s, step_size=0.1, tau=2, num_threads=4,
                          inner_steps=n, seed=i)
            for i, s in enumerate(("consistent", "inconsistent", "unlock"))] + \
        [mod.SweepSpec(algo="hogwild", scheme="inconsistent", step_size=0.1,
                       num_threads=4, tau=-1)]


@pytest.fixture(scope="module")
def mlp_runs(mlp):
    jm, pm = mlp
    return (jsw.run_sweep(jm, 2, _mlp_specs(jsw, jm.n)),
            psw.run_sweep(pm, 2, _mlp_specs(psw, pm.n)))


def test_mlp_sweep_matches_jax(mlp_runs):
    """2 epochs of the three schemes and Hogwild! on the batched engine,
    row by row."""
    jres, pres = mlp_runs
    np.testing.assert_allclose(pres.histories, jres.histories, **TOL)
    np.testing.assert_allclose(pres.final_w, jres.final_w, **TOL)
    np.testing.assert_array_equal(pres.effective_passes, jres.effective_passes)
    assert np.all(pres.histories[:, -1] < pres.histories[:, 0])


def test_mlp_final_params_is_the_jax_tree(mlp_runs):
    jres, pres = mlp_runs
    assert pres.param_shapes == jres.param_shapes
    for c in range(len(pres.specs)):
        got, want = pres.final_params(c), jres.final_params(c)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].shape == want[key].shape
            assert got[key].dtype == want[key].dtype
            np.testing.assert_allclose(got[key], want[key], **TOL)


def test_mlp_serial_svrg_runs_on_flat_params(mlp):
    """The serial driver holds flat params; the MLP's pytree forms hand a
    flat vector back for a flat one."""
    _, pm = mlp
    w, history = run_svrg(pm, 1, 0.1, num_inner=16)
    assert history[-1] < history[0]
    assert tuple(w.shape) == (pm.flat_dim,)


def test_mlp_lm_objective_builds_the_jax_corpus():
    pm = mlp_lm_objective(8, device="cpu", **MLP_KW)
    jm = jax_mlp(8, **MLP_KW)
    np.testing.assert_array_equal(pm.targets.numpy(), np.asarray(jm.targets))
    assert pm.flat_dim == jm.flat_dim == 16 * 8 + 8 + 8 * 16 + 16 + 16 * 16


# ---------------------------------------------------------------------------
# LogisticRegression's theory-facing pieces
# ---------------------------------------------------------------------------

def test_logreg_theory_constants_match_jax():
    X, y = _data()
    jo = JaxLogReg(X, y, 1e-3)
    po = LogisticRegression(X, y, 1e-3, device="cpu")
    assert po.smoothness() == pytest.approx(jo.smoothness(), rel=1e-6)
    assert po.strong_convexity() == jo.strong_convexity()
    w = _rows(po.p, C=1)[0]
    idx = np.array([1, 5, 9, 40])
    np.testing.assert_allclose(
        po.minibatch_grad(torch.from_numpy(w), torch.from_numpy(idx)).numpy(),
        np.asarray(jo.minibatch_grad(w, jnp.asarray(idx))), **TOL)
    w_star, f_star = po.optimum(max_iter=300)
    jw, jf = jo.optimum(max_iter=300)
    np.testing.assert_allclose(w_star.numpy(), np.asarray(jw), **TOL)
    assert f_star == pytest.approx(jf, rel=1e-6)
