"""The MLP objective's fused sweep (`repro_torch.kernels.sweep_epoch_mlp`)
on the CPU, where the op runs its plain version, against the JAX package.

Size: `mlp_lm_objective(n=16, vocab 16, seq 4, d_model 8, d_hidden 8)`, the
JAX package's own fused MLP test (tests/test_kernel_sweep.py), 2 epochs of
the three reading schemes (the unlock row with drop_prob 0.1) and a
Hogwild! row.

Tolerances: the port's fused rows within rtol 1e-5, atol 1e-6 of the JAX
package's fused rows (run live, in interpret mode, as its own test runs
them; JAX computes the MLP in float32, the port in float64 rounded once)
and of the port's batched rows. The plain version's hand-written float64
gradient within rtol 1e-12 of the objective's `torch.func` gradient, also
float64: both are the same function, summed in other orders. Its full
gradient and loss within rtol 1e-6 of the objective's (float32, each
rounded once from float64).
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro.core import sweep as jsw
from repro.core.objectives import mlp_lm_objective as jax_mlp
from repro_torch.convert import to_objective
from repro_torch.core import sweep as psw
from repro_torch.core.objectives import mlp_lm_objective
from repro_torch.kernels.sweep_epoch_mlp import (mlp_full_grad, mlp_loss,
                                                 sample_grad, sweep_epoch_mlp)
from repro_torch.kernels.sweep_epoch_mlp import ops
from repro_torch.kernels.sweep_epoch_mlp.ref import MLPWidths, sample_grad64

TOL = dict(rtol=1e-5, atol=1e-6)
KW = dict(vocab_size=16, seq_len=4, d_model=8, d_hidden=8)
DROP = 0.1


def _specs(mod, mode):
    specs = [mod.SweepSpec(scheme=s, step_size=0.1, tau=2, num_threads=3,
                           inner_steps=10, seed=c, engine_mode=mode)
             for c, s in enumerate(("consistent", "inconsistent", "unlock"))]
    specs.append(mod.SweepSpec(algo="hogwild", scheme="consistent",
                               step_size=0.1, tau=2, num_threads=3, seed=9,
                               engine_mode=mode))
    return specs


@pytest.fixture(scope="module")
def mlp():
    jo = jax_mlp(16, **KW)
    return jo, to_objective(jo, "cpu")


@pytest.fixture(scope="module")
def runs(mlp):
    """The JAX package's fused sweep and the port's fused and batched
    sweeps, 2 epochs each, from the same specs."""
    jo, po = mlp
    return (jsw.run_sweep(jo, 2, _specs(jsw, "fused"), drop_prob=DROP),
            {mode: psw.run_sweep(po, 2, _specs(psw, mode), drop_prob=DROP)
             for mode in ("fused", "vmap")})


def test_fused_rows_match_the_jax_fused_rows(mlp, runs):
    jo, po = mlp
    jres, pres = runs[0], runs[1]["fused"]
    assert psw.plan_sweep(po, 2, _specs(psw, "fused")).groups == \
        jsw.plan_sweep(jo, 2, _specs(jsw, "fused")).groups
    np.testing.assert_allclose(pres.histories, jres.histories, **TOL)
    np.testing.assert_allclose(pres.final_w, jres.final_w, **TOL)
    np.testing.assert_array_equal(pres.effective_passes,
                                  jres.effective_passes)
    assert np.all(pres.histories[:, -1] < pres.histories[:, 0])


def test_fused_rows_match_the_batched_rows(runs):
    fused, batched = runs[1]["fused"], runs[1]["vmap"]
    np.testing.assert_allclose(fused.histories, batched.histories, **TOL)
    np.testing.assert_allclose(fused.final_w, batched.final_w, **TOL)
    np.testing.assert_array_equal(fused.effective_passes,
                                  batched.effective_passes)


def test_unlock_row_drops_coordinates(mlp):
    """The unlock row with drop_prob > 0 is not the row without drops, and
    matches the JAX package's fused unlock row with the same drops."""
    jo, po = mlp
    spec = [_specs(psw, "fused")[2]]
    with_drops = psw.run_sweep(po, 1, spec, drop_prob=DROP)
    without = psw.run_sweep(po, 1, spec, drop_prob=0.0)
    assert not np.array_equal(with_drops.final_w, without.final_w)
    jres = jsw.run_sweep(jo, 1, [_specs(jsw, "fused")[2]], drop_prob=DROP)
    np.testing.assert_allclose(with_drops.final_w, jres.final_w, **TOL)


def test_fused_group_calls_no_objective_gradient(mlp, monkeypatch):
    """The fused MLP group takes μ, the losses and every update from the
    op's entries: none of the objective's `torch.func` adapters runs."""
    _, po = mlp

    def refuse(*args, **kwargs):
        raise AssertionError("the fused group called the objective")

    for name in ("flat_loss", "flat_full_grad", "flat_sample_grad"):
        monkeypatch.setattr(po, name, refuse)
    from repro_torch.service import clear_cache
    clear_cache()
    res = psw.run_sweep(po, 1, _specs(psw, "fused")[:2], drop_prob=DROP)
    assert np.all(np.isfinite(res.histories))


@pytest.mark.parametrize("activation", ["relu", "gelu", "silu"])
def test_plain_sample_grad_matches_the_objective(activation):
    """The plain version's hand-written backward against `torch.func.grad`
    of `MLPObjective._sample_loss`, both float64, rtol 1e-12; and the op's
    float32 gradient against `flat_sample_grad`."""
    po = mlp_lm_objective(16, device="cpu", activation=activation, **KW)
    rng = np.random.default_rng(3)
    W = torch.tensor(0.3 * rng.standard_normal((4, po.flat_dim)),
                     dtype=torch.float32)
    i = torch.tensor([0, 5, 11, 15])
    mine = sample_grad64(*po.data_args(), i, W, MLPWidths(*po.kernel_widths))
    _, oh, tgt, wb = po._batch(po.data_args(), i, W)
    want = vmap(grad(po._sample_loss))(wb, oh, tgt)
    assert mine.dtype == want.dtype == torch.float64
    np.testing.assert_allclose(mine.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-15)
    for c in range(4):
        g = sample_grad(*po.data_args(), int(i[c]), W[c], po.kernel_widths)
        np.testing.assert_allclose(
            g.numpy(), po.flat_sample_grad(po.data_args(), i[c], W[c]).numpy(),
            rtol=1e-6, atol=1e-7)


def test_full_grad_and_loss_entries_match_the_objective(mlp):
    _, po = mlp
    rng = np.random.default_rng(4)
    W = torch.tensor(0.3 * rng.standard_normal((3, po.flat_dim)),
                     dtype=torch.float32)
    data = po.data_args()
    mu, f = mlp_full_grad(*data, W, po.kernel_widths)
    np.testing.assert_allclose(mu.numpy(), po.flat_full_grad(data, W).numpy(),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(f.numpy(), po.flat_loss(data, W).numpy(),
                               rtol=1e-6)
    np.testing.assert_array_equal(mlp_loss(*data, W, po.kernel_widths).numpy(),
                                  f.numpy())


def test_epoch_op_checks_its_inputs(mlp):
    _, po = mlp
    data = po.data_args()
    w = po.init_flat()[None]
    keys = torch.zeros((1, 2), dtype=torch.int64)
    step = torch.full((1,), 0.1)
    kw = dict(widths=po.kernel_widths, engine="hogwild", total=4, buf_len=3,
              option=1, drop_prob=0.0)
    with pytest.raises(ValueError, match="width"):
        sweep_epoch_mlp(*data, w[:, :-1], None, keys, step, [2], [0], [1],
                        **kw)
    with pytest.raises(ValueError, match="activation"):
        sweep_epoch_mlp(*data, w, None, keys, step, [2], [0], [1],
                        **dict(kw, widths=(16, 8, 8, "tanh")))
    with pytest.raises(ValueError, match="buf_len"):
        sweep_epoch_mlp(*data, w, None, keys, step, [3], [0], [1], **kw)


DEFAULT = MLPWidths(32, 16, 32, "relu")    # the objective's defaults, S 8
WIDE = MLPWidths(256, 64, 256, "relu")     # d 98624
H100_LIMIT = 232448                        # a block's opt-in shared memory


@pytest.mark.parametrize("engine", ["asysvrg", "hogwild"])
def test_placement_by_size(engine):
    """The ring and the vectors in shared memory at the objective's
    default widths (d 2096), in the device buffer at V 256, D 64, H 256 and
    τ 2 (d 98624), by the block's bytes alone."""
    assert DEFAULT.flat_dim == 2096 and WIDE.flat_dim == 98624
    assert ops.choose_placement(8, DEFAULT, 3, engine, H100_LIMIT) == \
        ops.SHARED
    assert ops.choose_placement(8, WIDE, 3, engine, H100_LIMIT) == ops.GLOBAL
    assert ops.shared_bytes(8, WIDE, 3, engine, ops.SHARED) > H100_LIMIT
    assert ops.shared_bytes(8, WIDE, 3, engine, ops.GLOBAL) <= H100_LIMIT
    sets = 2 if engine == "asysvrg" else 1
    acts = 8 * 8 * (4 * 16 + 2 * 32 + 32 + 4)
    vectors = (4 if engine == "asysvrg" else 1) + 3
    assert ops.shared_bytes(8, DEFAULT, 3, engine, ops.SHARED) == \
        sets * acts + 128 + 4 * vectors * 2096


def test_widths_past_a_block_are_refused_with_their_bytes():
    huge = MLPWidths(4096, 64, 256, "relu")
    need = ops.shared_bytes(8, huge, 3, "asysvrg", ops.GLOBAL)
    with pytest.raises(ValueError, match=f"{need} bytes"):
        ops.choose_placement(8, huge, 3, "asysvrg", H100_LIMIT)


def test_fused_final_params_is_the_tree(runs):
    fused = runs[1]["fused"]
    params = fused.final_params(0)
    assert sorted(params) == ["b1", "embed", "norm", "w1", "w2"]
    assert params["w2"].shape == (8, 16)
    flat = np.concatenate([np.asarray(params[k]).reshape(-1)
                           for k in sorted(params)])
    np.testing.assert_array_equal(flat, fused.final_w[0])


def test_fused_spec_round_trips(runs):
    fused = runs[1]["fused"]
    assert [s.engine_mode for s in fused.specs] == ["fused"] * 4
    assert [dataclasses.replace(s, engine_mode="") for s in fused.specs] == \
        [dataclasses.replace(s, engine_mode="") for s in runs[1]["vmap"].specs]
