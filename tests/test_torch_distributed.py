"""The sharding slice's multi-rank paths against the unsharded port and the
JAX package, on the CPU.

One 2-rank ``gloo`` world is spawned for the module (`launch.mesh.
run_world`, rendezvous through a file under ``tmp_path``, joined under a
120 s deadline); each rank runs `tests/_torch_ranks.sharding_checks`,
every collective check of this file, and returns its results:

  * `run_sweep` over `make_sweep_mesh(device_type="cpu")`, batched and
    fused (K3's plain version here), on the 5-row paper grid (a 4-row
    group, a Hogwild! row padded to 2) and a 3-row group (padded to 4),
    and through the ambient `mesh_context`: equal bits to the unsharded
    port run on each rank, and within rtol 1e-5, atol 1e-6 of the JAX
    package's unsharded `run_sweep` (tests/test_torch_sweep.py's TOL; the
    JAX package's sharded rows equal its unsharded ones by its contract,
    and tests/test_sweep_sharded.py skips on one device);
  * a `SweepService(mesh=...)` flush of two requests, equal bits to
    standalone sharded `run_sweep`, and a warm flush that constructs no
    runner;
  * a sharded `SweepService.run_job` of the paper grid cut after its first
    group and resumed from the checkpoint directory both ranks share (the
    mesh's first rank writes it): equal bits to the sharded `run_sweep`;
  * `bounded_staleness_epoch` at W = 2 for each compression method over 2
    epochs with carried residuals, against a reference composed from the
    JAX package's pieces on one device: each worker's local steps through
    its `bounded_staleness_epoch` on a 1-device mesh, its delta through
    `compressed_update` with ``jax.random.split(rng, 2)[w]``, the mean in
    numpy (rtol 1e-5, atol 1e-6).

At W = 1 the port's `bounded_staleness_epoch` runs in this process on
`make_host_mesh(device_type="cpu")` (a world of one in memory, destroyed
at the module's end) against the JAX package's on its host mesh.
"""
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as dist

import _torch_ranks as R
from repro.config import SVRGConfig as JaxSVRGConfig
from repro.core import sweep as jsw
from repro.core.compression import ErrorFeedbackState as JaxEF
from repro.core.compression import compressed_update as jax_compressed_update
from repro.core.distributed import SVRGState as JaxSVRGState
from repro.core.distributed import bounded_staleness_epoch as jax_bse
from repro.core.objective import LogisticRegression as JaxLogReg
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro_torch.core import sweep as psw
from repro_torch.core.objective import LogisticRegression
from repro_torch.launch.mesh import make_host_mesh, run_world

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world's future: it runs while this process computes the JAX
    references; `ranks` waits for it."""
    root = tmp_path_factory.mktemp("world")
    checks = functools.partial(R.sharding_checks, ckpt_dir=str(root / "job"))
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(run_world, checks, 2, backend="gloo",
                          init_file=str(root / "rendezvous"))


@pytest.fixture(scope="module")
def ranks(world):
    return world.result()


@pytest.fixture(scope="module")
def objs():
    X, y = R.logreg_data()
    return JaxLogReg(X, y, R.LAM), LogisticRegression(X, y, R.LAM,
                                                      device="cpu")


@pytest.fixture(scope="module")
def jax_grid(objs):
    return jsw.run_sweep(objs[0], R.EPOCHS, R.paper_grid(jsw))


@pytest.mark.parametrize("name,mode,rows", [
    ("grid_vmap", "vmap", 5), ("grid_fused", "fused", 5),
    ("grid3", "vmap", 3), ("ambient", "vmap", 5)])
def test_sharded_sweep_equals_unsharded(world, objs, jax_grid, name, mode,
                                        rows):
    """Every rank gets the whole result, equal bits to the unsharded port
    run (padding rows dropped) and within TOL of the JAX package's."""
    want = psw.run_sweep(objs[1], R.EPOCHS, R.paper_grid(psw, mode)[:rows])
    for out in world.result():
        hist, final_w = out[name]
        assert hist.shape == want.histories.shape
        assert np.array_equal(hist, want.histories)
        assert np.array_equal(final_w, want.final_w)
        np.testing.assert_allclose(hist, jax_grid.histories[:rows], **TOL)
        np.testing.assert_allclose(final_w, jax_grid.final_w[:rows], **TOL)


def test_world_and_mesh(ranks):
    assert [out["rank"] for out in ranks] == [0, 1]
    assert all(out["world"] == 2 and out["same_mesh"] for out in ranks)


def test_service_flush_sharded(ranks):
    """Each request of a sharded flush equals a standalone sharded
    `run_sweep` of its specs, bit for bit; the cold flush constructs one
    runner per group (three), the warm one none and counts no compile."""
    for out in ranks:
        cold, warm = out["flushes"]
        for flush in (cold, warm):
            for got, alone in zip(flush["results"], out["alone"]):
                assert all(np.array_equal(g, a) for g, a in zip(got, alone))
        assert cold["misses"] == 3 and cold["compiles"] >= 3
        assert warm["misses"] == 0 and warm["compiles"] == 0
        assert warm["hits"] == 3
        assert out["groups_dispatched"] == 6


def test_sharded_job_resumes(ranks):
    """The job's first call runs one of the grid's two groups and stops;
    the second restores it and runs the other. Both ranks read the one
    checkpoint per group that the mesh's first rank wrote, and the
    resumed result equals the sharded `run_sweep` bit for bit."""
    for out in ranks:
        job = out["job"]
        assert job["cut"] == (None, False) and job["done"]
        assert job["steps_after_cut"] == [1] and job["steps"] == [1, 2]
        assert job["groups_dispatched"] == 2
        for got, want in zip(job["rows"], out["grid_vmap"]):
            assert np.array_equal(got, want)


def test_constrain_redistributes_a_dtensor(ranks):
    for rank, out in enumerate(ranks):
        placed, local, plain = out["constrain"]
        assert placed
        np.testing.assert_array_equal(
            local, np.arange(24.0, dtype=np.float32).reshape(4, 6)[
                2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(plain, np.ones(2, np.float32))


# ------------------------------------------------------ bounded staleness
def _jax_logistic_loss(params, batch):
    X, y = batch
    margins = y * (X @ params["w"])
    return (jnp.mean(jax.nn.softplus(-margins))
            + 0.5 * R.LAM * jnp.sum(params["w"] * params["w"]))


def _jax_svrg(w0, g_snap):
    return JaxSVRGState(w_snap={"w": jnp.asarray(w0)},
                        g_snap={"w": jnp.asarray(g_snap)},
                        snap_step=jnp.zeros((), jnp.int32),
                        accum_count=jnp.zeros((), jnp.int32))


@pytest.fixture(scope="module")
def jax_fns():
    """The JAX package's `bounded_staleness_epoch` (on its 1-device host
    mesh) and `compressed_update`, jitted once per compression method:
    called eagerly they would trace and compile on every call."""
    mesh = jax_host_mesh()
    fns = {}
    for method in R.BSE_METHODS:
        cfg = JaxSVRGConfig(local_steps=3, compression=method,
                            compression_k=R.BSE_FRAC)
        fns["bse", method] = jax.jit(
            lambda params, svrg, batches, rng, ef, cfg=cfg: jax_bse(
                mesh, _jax_logistic_loss, params, svrg, batches, R.BSE_STEP,
                cfg, rng=rng, ef=ef))
        fns["compress", method] = jax.jit(
            lambda delta, ef, key, method=method: jax_compressed_update(
                delta, ef, method, R.BSE_FRAC, key))
    return fns


def _composed_reference(jax_fns, method):
    """W = 2 from the JAX package's pieces on one device: per epoch each
    worker's local steps (its `bounded_staleness_epoch` on a 1-device
    mesh, no compression), its delta compressed with its key, the mean in
    numpy; the residuals carried."""
    w0, g_snap, batches = R.bse_data()
    svrg = _jax_svrg(w0, g_snap)
    params = w0
    residual = np.zeros((2,) + w0.shape, np.float32)
    no_ef = JaxEF({"w": jnp.zeros((1,) + w0.shape)})
    out = []
    for e, (X, y) in enumerate(batches):
        keys = jax.random.split(jax.random.PRNGKey(e), 2)
        deltas = []
        for w in range(2):
            w_local, _ = jax_fns["bse", "none"](
                {"w": jnp.asarray(params)}, svrg,
                (jnp.asarray(X[w:w + 1]), jnp.asarray(y[w:w + 1])),
                jax.random.PRNGKey(0), no_ef)
            delta = {"w": w_local["w"] - jnp.asarray(params)}
            delta, ef = jax_fns["compress", method](
                delta, JaxEF({"w": jnp.asarray(residual[w])}), keys[w])
            deltas.append(np.asarray(delta["w"]))
            residual[w] = np.asarray(ef.residual["w"])
        params = params + (deltas[0] + deltas[1]) / np.float32(2)
        out.append((params.copy(), residual.copy()))
    return out


@pytest.mark.parametrize("method", R.BSE_METHODS)
def test_bounded_staleness_two_workers(ranks, jax_fns, method):
    want = _composed_reference(jax_fns, method)
    for out in ranks:
        for (w, res), (w_ref, res_ref) in zip(out["bse"][method], want):
            np.testing.assert_allclose(w, w_ref, **TOL)
            np.testing.assert_allclose(res, res_ref, **TOL)
    # the replicas reconcile to the same params, bit for bit
    assert all(np.array_equal(a[0], b[0]) for a, b in
               zip(ranks[0]["bse"][method], ranks[1]["bse"][method]))


@pytest.fixture(scope="module")
def host_mesh():
    mesh = make_host_mesh(device_type="cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("method", R.BSE_METHODS)
def test_bounded_staleness_one_worker_matches_jax(host_mesh, jax_fns,
                                                  method):
    """W = 1: the port on its (1, 1) host mesh against the JAX package's
    `bounded_staleness_epoch` on its own, over 2 epochs, residuals
    carried."""
    got = R.bse_epochs(host_mesh, method)
    w0, g_snap, batches = R.bse_data()
    svrg = _jax_svrg(w0, g_snap)
    params = {"w": jnp.asarray(w0)}
    ef = JaxEF({"w": jnp.zeros((1,) + w0.shape)})
    for e, (X, y) in enumerate(batches):
        params, ef = jax_fns["bse", method](
            params, svrg, (jnp.asarray(X[:1]), jnp.asarray(y[:1])),
            jax.random.PRNGKey(e), ef)
        w, res = got[e]
        np.testing.assert_allclose(w, np.asarray(params["w"]), **TOL)
        np.testing.assert_allclose(res[0], np.asarray(ef.residual["w"])[0],
                                   **TOL)
