"""The port's delay engine, Hogwild! and serial SVRG against the JAX package,
from the same seeds, on the CPU.

Both packages draw the same samples, delays and masks (repro_torch.prng is
bit-equal to jax.random), so runs are compared elementwise. Tolerances:
rtol 1e-5, atol 1e-6 on iterates and losses (summation order in the dot
products; the JAX loss sums in fixed float32 order, the port in float64).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SVRGConfig as JaxCfg
from repro.core import asysvrg as ja
from repro.core import hogwild as jh
from repro.core import svrg as js
from repro.core.objective import LogisticRegression as JaxLogReg
from repro_torch import convert, prng
from repro_torch.config import SVRGConfig
from repro_torch.core import asysvrg as pa
from repro_torch.core import hogwild_epoch, make_delay_schedule
from repro_torch.core import hogwild as ph
from repro_torch.core import svrg as ps
from repro_torch.core.objective import LogisticRegression
from repro_torch.kernels.svrg_update.ops import svrg_update

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    n, p = 96, 64
    X = (rng.standard_normal((n, p)) / 8).astype(np.float32)
    y = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    w = (0.1 * rng.standard_normal(p)).astype(np.float32)
    return JaxLogReg(X, y, 1e-3), LogisticRegression(X, y, 1e-3, device="cpu"), w


@pytest.mark.parametrize("scheme", ["consistent", "inconsistent", "unlock"])
@pytest.mark.parametrize("delay_kind,option", [("fixed", 2), ("uniform", 1),
                                               ("zero", 2)])
def test_epoch_core_matches_jax(pair, scheme, delay_kind, option):
    jo, po, w = pair
    cfg = dict(scheme=scheme, step_size=0.5, num_threads=4, inner_steps=16,
               option=option)
    key = jax.random.PRNGKey(11)
    want = ja.asysvrg_epoch(jo, jnp.asarray(w), key, JaxCfg(**cfg),
                            delay_kind=delay_kind)
    got = pa.asysvrg_epoch(po, torch.tensor(w), convert.to_key(key),
                           SVRGConfig(**cfg), delay_kind=delay_kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("scheme", ["inconsistent", "unlock"])
def test_run_asysvrg_matches_jax(pair, scheme):
    jo, po, _ = pair
    cfg = dict(scheme=scheme, step_size=0.5, num_threads=4, inner_steps=16)
    want = ja.run_asysvrg(jo, 2, JaxCfg(**cfg), seed=3, delay_kind="uniform")
    got = pa.run_asysvrg(po, 2, SVRGConfig(**cfg), seed=3, delay_kind="uniform")
    np.testing.assert_allclose(got.history, want.history, **TOL)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), **TOL)
    assert got.effective_passes == want.effective_passes
    assert got.total_updates == want.total_updates


@pytest.mark.parametrize("kind", ["zero", "fixed", "uniform"])
def test_delay_schedule_matches_jax(kind):
    key = jax.random.PRNGKey(4)
    want = ja.make_delay_schedule(kind, 500, 7, key)
    got = pa._delay_schedule_core([pa.DELAY_IDS[kind]], 500, [7],
                                  convert.to_key(key)[None])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


@pytest.mark.parametrize("kind,tau", [("zero", 7), ("fixed", 7),
                                      ("uniform", 7), ("uniform", 0)])
def test_make_delay_schedule_public_matches_jax(kind, tau):
    """`repro_torch.core.make_delay_schedule`, the public single-config
    wrapper, against the JAX package's: values and dtype."""
    key = jax.random.PRNGKey(6)
    want = np.asarray(ja.make_delay_schedule(kind, 300, tau, key, p=8))
    got = make_delay_schedule(kind, 300, tau, convert.to_key(key), p=8)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        make_delay_schedule("nope", 10, tau, convert.to_key(key))


@pytest.mark.parametrize("scheme", ["consistent", "inconsistent", "unlock"])
def test_read_dispatch_matches_jax(scheme):
    """One read of a [buf_len, d] ring buffer, bit for bit."""
    rng = np.random.default_rng(2)
    buf_len, tau, dim, m, a = 8, 5, 40, 23, 20
    buffer = rng.standard_normal((buf_len, dim)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    sid = pa.SCHEME_IDS[scheme]
    want = ja.read_dispatch(jnp.int32(sid), jnp.asarray(buffer), jnp.int32(tau),
                            jnp.int32(a), jnp.int32(m), key, dim)
    slots = pa.read_dispatch([sid], torch.tensor([tau]), torch.tensor([[a]]),
                             torch.tensor([m]), convert.to_key(key)[None, None],
                             dim)
    got = pa._gather_read(torch.tensor(buffer)[None], slots[0])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


def test_rows_of_a_batch_equal_single_rows(pair):
    """The batched engine: C rows of different schemes, delays, τ and step
    sizes in one `_epoch_core` equal C one-row runs, bit for bit."""
    _, po, w = pair
    keys = prng.split(prng.PRNGKey(5), 3)
    eta = torch.tensor([0.5, 0.2, 0.8])
    tau, scheme, delay = [3, 1, 3], [2, 1, 0], [2, 1, 1]
    W = torch.tensor(w)[None].repeat(3, 1)
    kw = dict(total=20, buf_len=4, option=2, drop_prob=0.1)
    out = pa._epoch_core(po, po.data_args(), W, keys, eta, tau, scheme, delay,
                         **kw)
    for c in range(3):
        one = pa._epoch_core(po, po.data_args(), W[c:c + 1], keys[c:c + 1],
                             eta[c:c + 1], tau[c:c + 1], scheme[c:c + 1],
                             delay[c:c + 1], **kw)
        assert torch.equal(out[c], one[0])


def test_tau_zero_equals_serial_svrg(pair):
    """τ=0 ⇒ AsySVRG degenerates to sequential SVRG (paper §3): same
    samples (svrg_epoch gets the engine's index key), same last iterate."""
    _, po, w = pair
    key = prng.PRNGKey(3)
    cfg = SVRGConfig(scheme="consistent", step_size=1.0, num_threads=1, tau=0,
                     inner_steps=200, option=1)
    asy = pa.asysvrg_epoch(po, torch.tensor(w), key, cfg)
    k_idx = prng.split(key, 3)[0]
    ser = ps.svrg_epoch(po, torch.tensor(w), k_idx, 1.0, 200, option=1)
    np.testing.assert_allclose(asy.numpy(), ser.numpy(), **TOL)


def test_run_svrg_matches_jax(pair):
    jo, po, _ = pair
    jw, jhist = js.run_svrg(jo, 2, 0.5, num_inner=50, option=2, seed=3)
    tw, thist = ps.run_svrg(po, 2, 0.5, num_inner=50, option=2, seed=3)
    np.testing.assert_allclose(thist, jhist, **TOL)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
    jw1 = js.svrg_epoch(jo, jnp.zeros(64), jax.random.PRNGKey(1), 0.5, 30,
                        option=1)
    tw1 = ps.svrg_epoch(po, torch.zeros(64), prng.PRNGKey(1), 0.5, 30, option=1)
    np.testing.assert_allclose(tw1.numpy(), np.asarray(jw1), **TOL)


@pytest.mark.parametrize("scheme,tau", [("unlock", -1), ("inconsistent", 0)])
def test_run_hogwild_matches_jax(pair, scheme, tau):
    jo, po, _ = pair
    kw = dict(num_threads=4, decay=0.9, scheme=scheme, tau=tau, seed=2)
    want = jh.run_hogwild(jo, 2, 0.5, **kw)
    got = ph.run_hogwild(po, 2, 0.5, **kw)
    np.testing.assert_allclose(got.history, want.history, **TOL)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), **TOL)
    assert got.effective_passes == want.effective_passes
    assert got.total_updates == want.total_updates


def test_hogwild_epoch_matches_jax(pair):
    jo, po, w = pair
    key = jax.random.PRNGKey(8)
    want = jh.hogwild_epoch(jo, jnp.asarray(w), key, 0.3, num_threads=4,
                            scheme="unlock", delay_kind="uniform")
    got = ph._hogwild_epoch_core(
        po, po.data_args(), torch.tensor(w)[None], convert.to_key(key)[None],
        torch.tensor([0.3]), [3], [pa.SCHEME_IDS["unlock"]],
        [pa.DELAY_IDS["uniform"]], total=96, buf_len=4, drop_prob=0.02)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("scheme,tau,delay_kind", [
    ("unlock", -1, "uniform"), ("inconsistent", 2, "fixed"),
    ("consistent", 0, "fixed")])
def test_hogwild_epoch_public_matches_jax(pair, scheme, tau, delay_kind):
    """`repro_torch.core.hogwild_epoch` against the JAX package's."""
    jo, po, w = pair
    key = jax.random.PRNGKey(12)
    kw = dict(num_threads=4, tau=tau, scheme=scheme, drop_prob=0.05,
              delay_kind=delay_kind)
    want = jh.hogwild_epoch(jo, jnp.asarray(w), key, 0.3, **kw)
    got = hogwild_epoch(po, torch.tensor(w), convert.to_key(key), 0.3, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError):
        hogwild_epoch(po, torch.tensor(w), convert.to_key(key), 0.3,
                      num_threads=4, scheme="nope")
    with pytest.raises(ValueError):
        hogwild_epoch(po, torch.tensor(w), convert.to_key(key), 0.3,
                      num_threads=4, delay_kind="nope")


@pytest.mark.parametrize("scheme", ["consistent", "inconsistent", "unlock"])
@pytest.mark.parametrize("option", [1, 2])
def test_epoch_core_epilogue_with_drops_matches_jax(pair, scheme, option):
    """The engine's one call per update (the update, its ring slot and, for
    option 2, the running sum) against the JAX epoch, with drops on."""
    jo, po, w = pair
    cfg = dict(scheme=scheme, step_size=0.4, num_threads=4, inner_steps=12,
               option=option)
    key = jax.random.PRNGKey(21)
    want = ja.asysvrg_epoch(jo, jnp.asarray(w), key, JaxCfg(**cfg),
                            delay_kind="uniform", drop_prob=0.1)
    got = pa.asysvrg_epoch(po, torch.tensor(w), convert.to_key(key),
                           SVRGConfig(**cfg), delay_kind="uniform",
                           drop_prob=0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("option", [1, 2])
@pytest.mark.parametrize("num_inner", [1, 2, 25])
def test_svrg_epoch_epilogue_matches_jax(pair, option, num_inner):
    """Serial SVRG's running sum u_0 + … + u_{M−1} (u_0 added once, every
    update but the last in the kernel's epilogue) against the JAX epoch."""
    jo, po, w = pair
    key = jax.random.PRNGKey(4)
    want = js.svrg_epoch(jo, jnp.asarray(w), key, 0.5, num_inner,
                         option=option)
    got = ps.svrg_epoch(po, torch.tensor(w), convert.to_key(key), 0.5,
                        num_inner, option=option)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_updates_go_through_svrg_update(pair, monkeypatch):
    """Every AsySVRG inner update is one svrg_update call (on the card, one
    launch); Hogwild! keeps its own plain update."""
    _, po, _ = pair
    calls = []

    def counting(*args, **kwargs):
        calls.append(1)
        return svrg_update(*args, **kwargs)

    monkeypatch.setattr(pa, "svrg_update", counting)
    cfg = SVRGConfig(scheme="unlock", step_size=0.5, num_threads=4,
                     inner_steps=16)
    pa.run_asysvrg(po, 2, cfg, seed=1)
    assert len(calls) == 2 * 64
    ph.run_hogwild(po, 1, 0.5, num_threads=4)
    assert len(calls) == 2 * 64


def test_unknown_scheme_raises(pair):
    _, po, _ = pair
    with pytest.raises(ValueError):
        pa.run_asysvrg(po, 1, SVRGConfig(scheme="nope"))
    with pytest.raises(ValueError):
        ph.run_hogwild(po, 1, 0.1, delay_kind="nope")
