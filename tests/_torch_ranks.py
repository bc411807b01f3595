"""What each rank of the 2-rank CPU ``gloo`` world of
tests/test_torch_distributed.py runs. Imports torch and the port only: each
spawned rank imports this module, not the test file (which imports JAX).

Every sharded call here is collective: both ranks make the same calls in
the same order. Each rank returns its results as numpy; the test process
holds them against the unsharded port and the JAX package.
"""
import numpy as np
import torch

from repro_torch import prng
from repro_torch.checkpoint import Checkpointer
from repro_torch.config import SVRGConfig
from repro_torch.core import sweep as psw
from repro_torch.core.distributed import SVRGState, bounded_staleness_epoch
from repro_torch.core.objective import LogisticRegression
from repro_torch.launch.mesh import make_sweep_mesh
from repro_torch.service import SweepService, cache_stats, clear_cache
from repro_torch.sharding.context import constrain, mesh_context

EPOCHS = 2
LAM = 1e-3
BSE_STEP = 0.5
BSE_METHODS = ("none", "topk", "randk", "int8")
BSE_FRAC = 0.25


def logreg_data():
    """The sweep's dataset, from a numpy seed: n 64, p 32, labels ±1."""
    rng = np.random.default_rng(0)
    X = (rng.standard_normal((64, 32)) / 4).astype(np.float32)
    y = np.where(rng.random(64) < 0.5, -1.0, 1.0).astype(np.float32)
    return X, y


def paper_grid(mod, mode="vmap"):
    """The paper's 5-row grid at small M̃, as chip_smoke.py's: the three
    schemes and serial SVRG (one 4-row group, M̃ 32) and a Hogwild! row (a
    group of one, padded to 2 on two ranks)."""
    specs = [mod.SweepSpec(seed=0, scheme=s, step_size=0.5, num_threads=4,
                           inner_steps=8, engine_mode=mode)
             for s in ("consistent", "inconsistent", "unlock")]
    specs += [mod.SweepSpec(algo="svrg", step_size=0.5, num_threads=4,
                            inner_steps=32, engine_mode=mode),
              mod.SweepSpec(algo="hogwild", scheme="unlock", step_size=0.5,
                            num_threads=4, tau=-1, engine_mode=mode)]
    return specs


def service_requests(mod):
    """Two requests: 2 batched rows, then a fused AsySVRG row and a fused
    Hogwild! row (three groups in one flush)."""
    a = [mod.SweepSpec(seed=s, scheme="inconsistent", step_size=0.5,
                       num_threads=4, inner_steps=8, engine_mode="vmap")
         for s in (5, 6)]
    b = [mod.SweepSpec(seed=7, scheme="unlock", step_size=0.4, num_threads=4,
                       inner_steps=8, engine_mode="fused"),
         mod.SweepSpec(algo="hogwild", scheme="unlock", step_size=0.5,
                       num_threads=4, tau=-1, engine_mode="fused")]
    return a, b


def bse_data():
    """bounded_staleness_epoch's inputs from a numpy seed: params and the
    SVRG snapshot (p 32), and per epoch the [W=2, H=3, 8, ...] minibatches
    of a logistic loss."""
    rng = np.random.default_rng(1)
    p = 32
    w0 = (rng.standard_normal(p) / 8).astype(np.float32)
    g_snap = (rng.standard_normal(p) / 16).astype(np.float32)
    batches = [((rng.standard_normal((2, 3, 8, p)) / 4).astype(np.float32),
                np.where(rng.random((2, 3, 8)) < 0.5, -1.0, 1.0)
                .astype(np.float32)) for _ in range(EPOCHS)]
    return w0, g_snap, batches


def logistic_loss(params, batch):
    X, y = batch
    margins = y * (X @ params["w"])
    return (torch.mean(torch.nn.functional.softplus(-margins))
            + 0.5 * LAM * torch.sum(params["w"] * params["w"]))


def bse_epochs(mesh, method):
    """EPOCHS of bounded_staleness_epoch with the residuals carried; the
    key of epoch e is PRNGKey(e). Returns (params, residual) per epoch."""
    w0, g_snap, batches = bse_data()
    params = {"w": torch.from_numpy(w0)}
    svrg = SVRGState(w_snap={"w": torch.from_numpy(w0)},
                     g_snap={"w": torch.from_numpy(g_snap)},
                     snap_step=torch.zeros((), dtype=torch.int32),
                     accum_count=torch.zeros((), dtype=torch.int32))
    cfg = SVRGConfig(local_steps=3, compression=method,
                     compression_k=BSE_FRAC)
    ef, out = None, []
    for e, (X, y) in enumerate(batches):
        params, ef = bounded_staleness_epoch(
            mesh, logistic_loss, params, svrg,
            (torch.from_numpy(X), torch.from_numpy(y)), BSE_STEP, cfg,
            rng=prng.PRNGKey(e), ef=ef)
        out.append((params["w"].numpy().copy(),
                    ef.residual["w"].numpy().copy()))
    return out


def _rows(res):
    return res.histories, res.final_w


def sharding_checks(rank, world, ckpt_dir):
    """Every multi-rank check of tests/test_torch_distributed.py, in one
    world: the sharded sweeps (batched, fused, a padded 3-row group, the
    ambient mesh), a cold and a warm service flush with standalone sharded
    sweeps of the same requests, a sharded checkpointed job cut after its
    first group and resumed (its directory ``ckpt_dir``, shared by the
    ranks), bounded_staleness_epoch for each compression method, and
    `constrain` on a DTensor."""
    mesh = make_sweep_mesh(device_type="cpu")
    X, y = logreg_data()
    obj = LogisticRegression(X, y, LAM, device="cpu")
    out = {"rank": rank, "world": world,
           "same_mesh": make_sweep_mesh(device_type="cpu") is mesh}
    for mode in ("vmap", "fused"):
        out[f"grid_{mode}"] = _rows(psw.run_sweep(obj, EPOCHS,
                                                  paper_grid(psw, mode),
                                                  mesh=mesh))
    out["grid3"] = _rows(psw.run_sweep(obj, EPOCHS, paper_grid(psw)[:3],
                                       mesh=mesh))
    with mesh_context(mesh):
        out["ambient"] = _rows(psw.run_sweep(obj, EPOCHS, paper_grid(psw)))

    a, b = service_requests(psw)
    clear_cache()                # the first flush constructs its runners
    svc = SweepService(obj, epochs=EPOCHS, mesh=mesh)
    flushes = []
    for _ in range(2):
        rids = [svc.submit(a), svc.submit(b)]
        base = cache_stats()
        svc.flush()
        delta = cache_stats().since(base)
        flushes.append(dict(results=[_rows(svc.result(r)) for r in rids],
                            misses=delta.misses, compiles=delta.compiles,
                            hits=delta.hits))
        if not out.get("alone"):
            out["alone"] = [_rows(psw.run_sweep(obj, EPOCHS, r, mesh=mesh))
                            for r in (a, b)]
    out["flushes"] = flushes
    out["groups_dispatched"] = svc.stats().groups_dispatched

    job = SweepService(obj, epochs=EPOCHS, mesh=mesh)
    ckpt = Checkpointer(ckpt_dir)
    cut = job.run_job(paper_grid(psw), checkpointer=ckpt, max_groups=1)
    steps_after_cut = ckpt.list_steps()
    resumed, done = job.run_job(paper_grid(psw), checkpointer=ckpt)
    out["job"] = dict(cut=cut, steps_after_cut=steps_after_cut,
                      steps=ckpt.list_steps(), done=done,
                      rows=_rows(resumed),
                      groups_dispatched=job.stats().groups_dispatched)

    out["bse"] = {m: bse_epochs(mesh, m) for m in BSE_METHODS}

    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    x = distribute_tensor(torch.arange(24.0).reshape(4, 6), mesh,
                          [Replicate()])
    with mesh_context(mesh):
        sharded = constrain(x, ("batch", None))
    out["constrain"] = (tuple(sharded.placements) == (Shard(0),),
                        sharded.to_local().numpy(),
                        constrain(torch.ones(2), ("batch",)).numpy())
    return out
