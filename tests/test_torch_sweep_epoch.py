"""repro_torch.kernels.sweep_epoch and the fused run_sweep against the JAX
package on the CPU.

On the CPU the wrapper runs the kernel's plain version (`ref.py`); the JAX
side runs its fused path as its own tests run it, through the Pallas
interpreter. Tolerances: rtol 1e-5, atol 1e-6 against JAX (summation
order); rtol 1e-6, atol 1e-7 between the port's fused and batched paths;
a row alone and in its group: equal bits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sweep as jsw
from repro.core.asysvrg import _epoch_core
from repro.core.hogwild import _hogwild_epoch_core
from repro.core.objective import LogisticRegression as JaxLogReg
from repro_torch import prng
from repro_torch.core import sweep as psw
from repro_torch.core.objective import LogisticRegression, Objective
from repro_torch.kernels.sweep_epoch import sweep_epoch
from repro_torch.kernels.sweep_epoch.ops import (PLACEMENTS, STAGES,
                                                 choose_placement,
                                                 shared_bytes)

TOL = dict(rtol=1e-5, atol=1e-6)
H100_SHARED = 232_448  # an H100 block's dynamic shared memory (opt-in)
TOL_BATCHED = dict(rtol=1e-6, atol=1e-7)
SCHEMES = ("consistent", "inconsistent", "unlock")


def _data(n=96, p=64, seed=0):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((n, p)) / 8).astype(np.float32)
    y = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    return X, y


def _specs(mod, mode="fused"):
    specs = mod.make_grid(step_sizes=(0.5,), num_threads=4, inner_steps=16,
                          seeds=(0, 1))
    specs += [
        mod.SweepSpec(algo="svrg", step_size=0.5, num_threads=4,
                      inner_steps=64),
        mod.SweepSpec(algo="svrg", step_size=0.3, num_threads=1,
                      inner_steps=40, epochs=1),
        mod.SweepSpec(algo="hogwild", scheme="unlock", step_size=0.5,
                      num_threads=4, tau=-1, epochs=3),
        mod.SweepSpec(seed=2, scheme="unlock", step_size=0.4, num_threads=4,
                      inner_steps=16, delay_kind="uniform", epochs=1),
    ]
    return [dataclasses.replace(s, engine_mode=mode) for s in specs]


@pytest.fixture(scope="module")
def objs():
    X, y = _data()
    return JaxLogReg(X, y, 1e-3), LogisticRegression(X, y, 1e-3, device="cpu")


@pytest.fixture(scope="module")
def runs(objs):
    jo, po = objs
    return jsw.run_sweep(jo, 2, _specs(jsw)), psw.run_sweep(po, 2, _specs(psw))


def test_fused_sweep_matches_jax_fused(objs, runs):
    """The slice as a whole: same plan, same executed specs, histories and
    final iterates within the summation-order tolerance."""
    jo, po = objs
    jres, pres = runs
    assert psw.plan_sweep(po, 2, _specs(psw)).groups == \
        jsw.plan_sweep(jo, 2, _specs(jsw)).groups
    assert [dataclasses.asdict(s) for s in pres.specs] == \
        [dataclasses.asdict(s) for s in jres.specs]
    assert all(s.engine_mode == "fused" for s in pres.specs)
    np.testing.assert_allclose(pres.histories, jres.histories, **TOL)
    np.testing.assert_allclose(pres.final_w, jres.final_w, **TOL)
    np.testing.assert_array_equal(pres.effective_passes, jres.effective_passes)
    np.testing.assert_array_equal(pres.total_updates, jres.total_updates)
    np.testing.assert_array_equal(pres.epochs_per_row, jres.epochs_per_row)


def test_fused_matches_batched_on_cpu(objs, runs):
    _, po = objs
    _, pres = runs
    vmap = psw.run_sweep(po, 2, _specs(psw, "vmap"))
    np.testing.assert_allclose(pres.histories, vmap.histories, **TOL_BATCHED)
    np.testing.assert_allclose(pres.final_w, vmap.final_w, **TOL_BATCHED)


def test_fused_row_alone_equals_row_in_group(objs, runs):
    """A row's results do not depend on the rows it runs with: bit for bit."""
    _, po = objs
    _, pres = runs
    specs = _specs(psw)
    for c in (1, 4, 8, 9):
        alone = psw.run_sweep(po, 2, [specs[c]])
        width = alone.histories.shape[1]
        assert np.array_equal(alone.final_w[0], pres.final_w[c])
        assert np.array_equal(alone.histories[0], pres.histories[c, :width])


@pytest.mark.parametrize("rows", [1, 3, 8])
def test_fused_group_widths(objs, rows):
    """Groups of 1, 3 and 8 rows against the JAX batched path."""
    jo, po = objs
    specs = [psw.SweepSpec(scheme=SCHEMES[c % 3], step_size=0.2, tau=3,
                           num_threads=4, inner_steps=15, seed=c,
                           engine_mode="fused")
             for c in range(rows)]
    jspecs = [jsw.SweepSpec(**{**dataclasses.asdict(s), "engine_mode": "vmap"})
              for s in specs]
    pres = psw.run_sweep(po, 2, specs)
    jres = jsw.run_sweep(jo, 2, jspecs)
    assert len(psw.plan_sweep(po, 2, specs).groups) == 1
    np.testing.assert_allclose(pres.histories, jres.histories, **TOL)
    np.testing.assert_allclose(pres.final_w, jres.final_w, **TOL)


def _one_epoch(jo, po, *, engine, scheme, option, tau=3, total=24,
               drop_prob=0.3, seed=5):
    """One epoch of the port's sweep_epoch (plain version) and of the JAX
    epoch core, from the same w, key and μ: (JAX iterate, JAX loss at it,
    port iterate, port loss)."""
    p = po.p
    w = (0.1 * np.random.default_rng(seed).standard_normal(p)).astype(np.float32)
    sid = psw.SCHEME_IDS[scheme]
    did = psw.DELAY_IDS["uniform"]
    buf_len = tau + 2
    jdata = jo.data_args()
    jkey = jax.random.PRNGKey(seed)
    if engine == "hogwild":
        want = _hogwild_epoch_core(
            jo, jdata, jnp.asarray(w), jkey, jnp.float32(0.5), tau, sid, did,
            total=total, buf_len=buf_len, drop_prob=drop_prob)
        mu = None
    else:
        want = _epoch_core(
            jo, jdata, jnp.asarray(w), jkey, jnp.float32(0.5), tau, sid, did,
            total=total, buf_len=buf_len, option=option, drop_prob=drop_prob)
        mu = torch.from_numpy(
            np.array(jo.flat_full_grad(jdata, jnp.asarray(w))))[None]
    got, loss = sweep_epoch(po.X, po.y, po.l2, torch.from_numpy(w)[None], mu,
                            prng.PRNGKey(seed)[None], torch.tensor([0.5]),
                            [tau], [sid], [did], engine=engine, total=total,
                            buf_len=buf_len, option=option,
                            drop_prob=drop_prob)
    return (np.asarray(want), float(jo.flat_loss(jdata, want)),
            got[0].numpy(), float(loss[0]))


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("engine,option", [("asysvrg", 1), ("asysvrg", 2),
                                           ("hogwild", 0)])
def test_sweep_epoch_plain_matches_jax_epoch(objs, scheme, engine, option):
    jo, po = objs
    want, want_loss, got, loss = _one_epoch(jo, po, engine=engine,
                                            scheme=scheme, option=option)
    assert np.all(np.isfinite(got)) and got.shape == (po.p,)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(loss, want_loss, **TOL)


@pytest.mark.parametrize("placement", list(PLACEMENTS))
def test_sweep_epoch_named_placement_on_cpu_runs_plain(objs, placement):
    """A placement is where the CUDA kernel keeps its state: on CPU tensors
    a named one runs the plain version, bit for bit, and counts no
    launch."""
    _, po = objs
    w = 0.1 * torch.randn((2, po.p), generator=torch.Generator().manual_seed(1))
    args = (po.X, po.y, po.l2, w, 0.01 * torch.ones_like(w),
            prng.keys_from_seeds([3, 4]), torch.tensor([0.5, 0.4]), [3, 1],
            [2, 1], [2, 1])
    kw = dict(engine="asysvrg", total=12, buf_len=4, option=2, drop_prob=0.1)
    launches, placements = sweep_epoch.launches, dict(sweep_epoch.placements)
    named = sweep_epoch(*args, **kw, placement=placement)
    plain = sweep_epoch(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(named, plain))
    assert sweep_epoch.launches == launches
    assert sweep_epoch.placements == placements


def test_sweep_epoch_rows_never_mix(objs):
    """Three rows in one call equal each row in a call of its own, iterate
    and loss."""
    _, po = objs
    w = 0.1 * torch.randn((3, po.p), generator=torch.Generator().manual_seed(0))
    mu = 0.01 * torch.ones_like(w)
    keys = prng.keys_from_seeds([0, 1, 2])
    kw = dict(engine="asysvrg", total=20, buf_len=4, option=2, drop_prob=0.2)
    rows = ([3, 0, 2], [0, 1, 2], [1, 0, 2])
    step = torch.tensor([0.5, 0.4, 0.3])
    group, group_loss = sweep_epoch(po.X, po.y, po.l2, w, mu, keys, step,
                                    *rows, **kw)
    for c in range(3):
        alone, loss = sweep_epoch(po.X, po.y, po.l2, w[c:c + 1], mu[c:c + 1],
                                  keys[c:c + 1], step[c:c + 1],
                                  *([r[c]] for r in rows), **kw)
        assert torch.equal(alone[0], group[c])
        assert torch.equal(loss[0], group_loss[c])


@pytest.mark.parametrize("mode", ["", "vmap", "fused", "bogus"])
def test_default_engine_mode_and_group_key_match_jax(objs, monkeypatch, mode):
    jo, po = objs
    monkeypatch.setenv("REPRO_SWEEP_ENGINE", mode)
    if mode == "bogus":
        for mod in (jsw, psw):
            with pytest.raises(ValueError):
                mod.default_engine_mode()
        return
    assert psw.default_engine_mode() == jsw.default_engine_mode()
    pspecs, jspecs = _specs(psw, ""), _specs(jsw, "")
    pplan, jplan = psw.plan_sweep(po, 2, pspecs), jsw.plan_sweep(jo, 2, jspecs)
    assert pplan.groups == jplan.groups
    assert [s.engine_mode for s in pplan.specs] == \
        [s.engine_mode for s in jplan.specs]


class _Shifted(Objective):
    """A non-logistic objective: f(w) = ½‖w − 1‖²."""

    def __init__(self):
        self.n = 4
        self.X = torch.zeros((4, 3))

    def data_args(self):
        return (self.X,)

    def init_params(self):
        return torch.zeros(3)

    def loss_fixed_order(self, data, w):
        return 0.5 * torch.sum((w - 1.0) ** 2, dim=-1)

    def full_grad_stable(self, data, w):
        return w - 1.0

    def sample_grad_stable(self, data, i, w):
        return w - 1.0


def test_fused_mode_takes_logistic_regression_only():
    obj = _Shifted()
    with pytest.raises(NotImplementedError, match="per-sample gradient"):
        psw.plan_sweep(obj, 1, [psw.SweepSpec(engine_mode="fused")])
    psw.plan_sweep(obj, 1, [psw.SweepSpec(engine_mode="vmap")])


@pytest.mark.parametrize("kwargs", [dict(engine="sgd"), dict(buf_len=2),
                                    dict(option=3), dict(drop_prob=1.0),
                                    dict(total=0), dict(placement="l2")])
def test_sweep_epoch_rejects_bad_arguments(objs, kwargs):
    _, po = objs
    w = torch.zeros((1, po.p))
    args = dict(engine="asysvrg", total=8, buf_len=4, option=2, drop_prob=0.0)
    args.update(kwargs)
    with pytest.raises(ValueError):
        sweep_epoch(po.X, po.y, po.l2, w, w, prng.PRNGKey(0)[None],
                    torch.tensor([0.1]), [3], [0], [1], **args)


def test_fused_group_fn_calling_convention(objs):
    """The group body takes (*data, *row_args) like the batched bodies and
    returns (w_fin [C, d], hist [C, E+1])."""
    _, po = objs
    data = po.data_args()
    run = psw._fused_group_fn(po, len(data), engine="hogwild", epochs=2,
                              total=12, buf_len=4, option=0, drop_prob=0.1)
    w0 = torch.zeros((2, po.p))
    w_fin, hist = run(*data, prng.keys_from_seeds([0, 1]),
                      torch.tensor([0.5, 0.5]), torch.tensor([0.9, 0.9]),
                      [3, 1], [2, 0], [1, 1], [2, 1], w0)
    assert w_fin.shape == (2, po.p) and hist.shape == (2, 3)
    assert hist[1, 2] == hist[1, 1] and hist[0, 2] < hist[0, 1] < hist[0, 0]


@pytest.mark.parametrize("engine", ["asysvrg", "hogwild"])
@pytest.mark.parametrize("d,buf_len", [(33, 4), (1000, 61), (2048, 8),
                                       (2048, 41), (4096, 10), (12000, 8)])
def test_sweep_epoch_block_bytes_and_placement(d, buf_len, engine):
    """The block's shared memory from unaligned rows (d = 33) through rcv1
    and news20 widths to one where only the L2 placement fits (a stage is
    the row's 16-byte-aligned cover plus one granule), and the placement:
    the first of PLACEMENTS that fits an H100 block."""
    vectors = 4 if engine == "asysvrg" else 1
    head = 512 + 64 * STAGES
    staged = STAGES * (16 * -(-d // 4) + 16)
    want = {"shared": head + staged + (vectors + buf_len) * 4 * d,
            "global": head + staged + vectors * 4 * d,
            "global_l2": head + vectors * 4 * d}
    got = {p: shared_bytes(d, buf_len, engine, p) for p in PLACEMENTS}
    assert got == want
    fits = [p for p in PLACEMENTS if want[p] <= H100_SHARED]
    assert choose_placement(d, buf_len, engine, H100_SHARED) == fits[0]


def test_sweep_epoch_placements_at_the_paths_widths():
    """rcv1 (τ = 7) stages its rows beside the ring in shared memory; at
    news20 (buf_len 10) an AsySVRG row's state alone takes 229,888 bytes,
    so no stage fits beside a shared ring and the ring moves to device
    memory."""
    assert shared_bytes(2048, 8, "asysvrg", "shared") == \
        512 + STAGES * 64 + STAGES * 8208 + 12 * 8192
    for engine in ("asysvrg", "hogwild"):
        assert choose_placement(2048, 8, engine, H100_SHARED) == "shared"
    assert (shared_bytes(4096, 10, "asysvrg", "shared")
            - STAGES * (64 + 16400)) == 229_888
    assert choose_placement(4096, 10, "asysvrg", H100_SHARED) == "global"
    with pytest.raises(ValueError, match="more shared memory"):
        choose_placement(20_000, 8, "asysvrg", H100_SHARED)
    with pytest.raises(ValueError, match="placement"):
        shared_bytes(2048, 8, "asysvrg", "registers")


def test_sweep_epoch_stage_covers_any_row():
    """A stage holds the 16-byte-aligned span that covers a row at each
    4-byte offset a float32 row can have: round_up(offset + 4 d, 16)."""
    for d in range(1, 70):
        stage = (shared_bytes(d, 1, "hogwild", "global")
                 - shared_bytes(d, 1, "hogwild", "global_l2")) // STAGES
        assert stage % 16 == 0
        assert all(-(-(r + 4 * d) // 16) * 16 <= stage for r in (0, 4, 8, 12))
