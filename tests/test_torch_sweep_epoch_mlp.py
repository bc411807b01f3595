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
    acts = 8 * 8 * (4 * 16 + 2 * 32 + 32)
    queue = 2 * (48 + 8 * 8)             # two stages: mbarriers, header, tokens
    trans = 32 * 33 + 32 * 17            # w2 [32, 32 | 1], w1 [32, 16 | 1]
    floats = 3 + (2 if engine == "asysvrg" else 0) + 2   # ring, mu, acc, words
    row = 8 * sets * (2096 + trans) + 4 * floats * 2096  # a multiple of 16
    assert ops.row_bytes(DEFAULT, 3, engine) == row
    assert ops.shared_bytes(8, DEFAULT, 3, engine, ops.SHARED) == \
        sets * acts + queue + row
    assert ops.shared_bytes(8, DEFAULT, 3, engine, ops.GLOBAL) == \
        sets * acts + queue


def test_widths_past_a_block_are_refused_with_their_bytes():
    huge = MLPWidths(4096, 64, 256, "relu")
    need = ops.shared_bytes(8, huge, 3, "asysvrg", ops.GLOBAL)
    assert need == 2 * 8 * 8 * (4 * 64 + 2 * 256 + 4096) + 2 * (48 + 64)
    with pytest.raises(ValueError, match=f"{need} bytes"):
        ops.choose_placement(8, huge, 3, "asysvrg", H100_LIMIT)


def _old_global_bytes(S, widths, engine):
    """The epoch block's bytes under ``"global"`` before the warp-local
    layout: per set 8 S (4 D + 2 H + V + 4), and a 64 + 8 S byte header."""
    V, D, H = widths.vocab_size, widths.d_model, widths.d_hidden
    sets = 2 if engine == "asysvrg" else 1
    return (sets * 8 * S * (4 * D + 2 * H + V + 4)
            + -(-(64 + 8 * S) // 16) * 16)


@pytest.mark.parametrize("S", [1, 2, 4, 5, 8, 20, 256])
@pytest.mark.parametrize("engine", ["asysvrg", "hogwild"])
def test_block_layout_by_sequence_length(S, engine):
    """The epoch block: one warp per position in each gradient set, at
    most 8, then the 4 producer warps; its ``"global"`` bytes never exceed
    the earlier layout's, so no width that block took is refused. The
    full-gradient block: as many sets as 16 warps and the limit hold."""
    sets = 2 if engine == "asysvrg" else 1
    warps = min(S, 8)
    assert ops.position_warps(S) == warps
    assert ops.epoch_threads(S, engine) == 32 * (sets * warps + 4)
    assert ops.epoch_threads(S, engine) <= 640
    for widths in (DEFAULT, WIDE, MLPWidths(16, 8, 16, "gelu")):
        assert (ops.shared_bytes(S, widths, 3, engine, ops.GLOBAL)
                <= _old_global_bytes(S, widths, engine))
    narrow = MLPWidths(16, 8, 16, "relu")    # one set fits up to S 256
    full, staged = ops.full_layout(S, narrow, 64, H100_LIMIT)
    assert staged
    room = H100_LIMIT - 8 * (narrow.flat_dim + 16 * 17 + 16 * 9)
    assert full == max(1, min(16 // warps, room // ops._full_bytes(
        S, narrow)))
    assert ops.full_threads(S, full) <= 512
    assert ops._full_bytes(S, narrow, full, staged) <= H100_LIMIT


def test_full_layout_follows_the_samples_and_the_limit():
    """Fewer samples than sets take one set each; the row and its
    transposed copies (float64) in shared memory where they fit beside a
    set (d 2096: 29,568 bytes), not at d 98624, where
    two sets of 65,600 bytes fit (16 warps / 8), at a limit of one set's
    bytes one."""
    frontier = MLPWidths(16, 8, 16, "relu")
    assert ops.full_layout(4, frontier, 3, H100_LIMIT) == (3, True)
    assert ops.full_layout(8, DEFAULT, 64, H100_LIMIT) == (2, True)
    assert ops._full_bytes(8, DEFAULT, 2, True) == \
        2 * 8 * 8 * (4 * 16 + 2 * 32 + 32 + 1) \
        + 8 * (2096 + 32 * 33 + 32 * 17)
    assert ops._full_bytes(8, WIDE) == 8 * 8 * (4 * 64 + 2 * 256 + 256 + 1)
    assert ops.full_layout(8, WIDE, 64, H100_LIMIT) == (2, False)
    assert ops.full_layout(8, WIDE, 64, ops._full_bytes(8, WIDE)) == \
        (1, False)
    assert ops.full_threads(8, 2) == 512


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
