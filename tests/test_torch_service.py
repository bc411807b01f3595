"""repro_torch.service against repro.service on the CPU.

Same numpy-seeded data in both packages (`make_synthetic_libsvm("rcv1",
scale=0.005)`, ≤ 3 epochs, ≤ 4 rows a request):

  * a coalesced flush from two tenants demuxes each request to what a
    standalone port `run_sweep` of its specs gives, bit for bit on the
    CPU, and to the JAX service's result within the sweep tolerance
    (rtol 1e-5, atol 1e-6, as tests/test_torch_sweep.py);
  * a warm flush of the same group shapes constructs no runner and counts
    no compile (a compile in the port: a runner construction or a kernel
    build);
  * `run_job` cut by ``max_groups`` resumes from its checkpoint to the
    one-call result;
  * the rest of the service's contract (result retention, selectors,
    progress events, stats) as the JAX package's tests pin it.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro.service as jservice
from repro.core import sweep as jsw
from repro.core.objective import LogisticRegression as JaxLogReg
from repro.data.libsvm import make_synthetic_libsvm
from repro_torch import obs, prng, service
from repro_torch.checkpoint import Checkpointer
from repro_torch.core import sweep as psw
from repro_torch.core.objective import LogisticRegression
from repro_torch.kernels import _build
from repro_torch.obs import progress
from repro_torch.obs.watchdog import JobDiverged, Watchdog
from repro_torch.service import (ResultEvictedError, SweepService, cache,
                                 cache_size, cache_stats, clear_cache)

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def objs():
    ds = make_synthetic_libsvm("rcv1", scale=0.005)
    return (JaxLogReg(ds.X, ds.y, ds.l2_reg),
            LogisticRegression(ds.X, ds.y, ds.l2_reg, device="cpu"))


def _grid_a(mod, mode="vmap"):
    """Two rows of one group. Against the JAX package the rows run batched
    (its fused mode runs the Pallas interpreter here); the port's fused
    rows are held against its own standalone runs."""
    return [mod.SweepSpec(scheme="inconsistent", step_size=0.5, tau=3,
                          num_threads=4, inner_steps=10, seed=s,
                          engine_mode=mode)
            for s in range(2)]


def _grid_mixed(mod):
    """The three algos and mixed per-row epoch budgets in one request."""
    return [mod.SweepSpec(scheme="unlock", step_size=0.25, tau=3,
                          num_threads=4, inner_steps=10, seed=7, epochs=1),
            mod.SweepSpec(scheme="consistent", step_size=0.5, tau=3,
                          num_threads=4, inner_steps=10, seed=8, epochs=3),
            mod.SweepSpec(algo="hogwild", scheme="consistent", step_size=0.5,
                          tau=2, num_threads=3, seed=1),
            mod.SweepSpec(algo="svrg", step_size=0.5, num_threads=1,
                          inner_steps=30, seed=2)]


def _tiny(seed=0):
    """A port row of 8 updates an epoch, for the service's bookkeeping."""
    return [psw.SweepSpec(seed=seed, step_size=0.5, num_threads=2,
                          inner_steps=4, engine_mode="vmap")]


def _job(**over):
    """A 3-group port job: two AsySVRG rows (M̃ 40), one (M̃ 20), serial
    SVRG (M̃ 12)."""
    return [psw.SweepSpec(seed=s, step_size=0.5, num_threads=4,
                          inner_steps=steps, **over)
            for s, steps in ((0, 10), (1, 10), (2, 5))] + \
        [psw.SweepSpec(algo="svrg", seed=3, step_size=0.5, num_threads=1,
                       inner_steps=12)]


def _requests(mod):
    """(tenant, specs, epochs) of the two tenants' three requests."""
    return [("team-a", _grid_a(mod), 2), ("team-b", _grid_mixed(mod), 2),
            ("team-a", _grid_a(mod)[:1], 3)]


def _same(got, want):
    for name in ("histories", "final_w", "effective_passes", "total_updates",
                 "epochs_per_row"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.specs == want.specs


def _close(got, want):
    np.testing.assert_allclose(got.histories, want.histories, **TOL)
    np.testing.assert_allclose(got.final_w, want.final_w, **TOL)
    for name in ("effective_passes", "total_updates", "epochs_per_row"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert [dataclasses.asdict(s) for s in got.specs] == \
        [dataclasses.asdict(s) for s in want.specs]


@pytest.fixture(scope="module")
def flushed(objs):
    """One flush of `_requests` in each package."""
    out = []
    for svc_cls, mod, obj in ((jservice.SweepService, jsw, objs[0]),
                              (SweepService, psw, objs[1])):
        svc = svc_cls(obj, epochs=2)
        rids = [svc.submit(specs, epochs, tenant=tenant)
                for tenant, specs, epochs in _requests(mod)]
        done = svc.flush()
        out.append((svc, rids, done))
    return out


# ----------------------------------------------------------------- names
@pytest.mark.parametrize("port,ref", [(service, jservice), (obs, jobs)])
def test_public_names_match_reference(port, ref):
    # not ported (ROADMAP Queue 1 item 6): the width policy (the port
    # dispatches every group at its natural width) and the cache-bound
    # setter (no caller; the bound is a constant)
    assert port.__all__ == [n for n in ref.__all__
                            if n not in ("WidthPolicy", "set_cache_limit")]
    for name in port.__all__:
        assert hasattr(port, name), name


def test_group_label_equals_reference(objs):
    jo, po = objs
    for (jk, _), (pk, _) in zip(
            jsw.plan_sweep(jo, 2, _grid_mixed(jsw)).groups.items(),
            psw.plan_sweep(po, 2, _grid_mixed(psw)).groups.items()):
        assert psw.group_label(pk) == jsw.group_label(jk)


# ------------------------------------------------------------- coalescing
def test_coalesced_flush_equals_standalone_and_reference(objs, flushed):
    _, po = objs
    (jsvc, jrids, jdone), (psvc, prids, pdone) = flushed
    assert pdone == jdone == sorted(prids)
    for (tenant, specs, epochs), jr, pr in zip(_requests(psw), jrids, prids):
        got = psvc.result(pr)
        _same(got, psw.run_sweep(po, epochs, specs))
        _close(got, jsvc.result(jr))
    fields = ("requests_submitted", "requests_completed", "rows_submitted",
              "rows_coalesced", "groups_dispatched", "groups_merged",
              "flushes", "rows_diverged")
    assert {f: getattr(psvc.stats(), f) for f in fields} == \
        {f: getattr(jsvc.stats(), f) for f in fields}
    assert psvc.tenant_rows() == jsvc.tenant_rows() == \
        {"team-a": (3, 3), "team-b": (4, 4)}


def test_fused_rows_coalesce_bit_equal_to_standalone(objs):
    """Fused rows of two tenants share one group (one sweep-epoch call per
    epoch); each request equals its standalone run bit for bit."""
    _, po = objs
    svc = SweepService(po, epochs=2)
    reqs = [(_grid_a(psw, "fused"), 2), (_grid_a(psw, "fused")[:1], 3)]
    rids = [svc.submit(specs, epochs, tenant=f"t{i}")
            for i, (specs, epochs) in enumerate(reqs)]
    svc.flush()
    assert svc.stats().groups_merged == 1
    for rid, (specs, epochs) in zip(rids, reqs):
        _same(svc.result(rid), psw.run_sweep(po, epochs, specs))


def test_coalesce_pools_rows_as_the_reference(objs):
    jo, po = objs
    sizes = []
    for mod, svc_mod, obj in ((jsw, jservice, jo), (psw, service, po)):
        reqs = [svc_mod.SweepRequest(request_id=i, specs=tuple(s), epochs=e,
                                     tenant=t)
                for i, (t, s, e) in enumerate(_requests(mod))]
        batch = svc_mod.coalesce(obj, reqs)
        sizes.append(sorted(len(m) for m in batch.groups.values()))
    assert sizes[0] == sizes[1]


@pytest.mark.parametrize("mode", ["fused", "vmap"])
def test_warm_flush_constructs_nothing(objs, mode):
    """A second flush of the same group shapes fetches the cached runners:
    no construction, no kernel build, no compile counted — also when the
    merged group has another row count, which the port's runners take
    without a new runner."""
    _, po = objs
    svc = SweepService(po, epochs=2)
    first = svc.sweep(_grid_a(psw, mode))
    base, built = cache_stats(), _build.builds()
    svc.submit(_grid_a(psw, mode))
    svc.submit(_grid_a(psw, mode)[:1])
    svc.flush()
    warm = cache_stats().since(base)
    assert (warm.misses, warm.compiles, _build.builds() - built) == (0, 0, 0)
    assert warm.hits >= 1
    _same(svc.result(1), first)


def test_compiles_count_constructions_and_builds(objs, monkeypatch):
    """The first call of a new runner counts one compile, and each kernel
    library built during a call one more; a later call counts none."""
    _, po = objs
    clear_cache()
    # `_build.builds()` read before and after each of three calls: the
    # second call builds two libraries
    reads = [0, 0, 0, 2, 2, 2]
    monkeypatch.setattr(_build, "builds", lambda: reads.pop(0))
    runner = cache.get_group_runner("asysvrg", group_epochs=1, total=8,
                                    option=2, buf_len=4, drop_prob=0.0,
                                    obj=po)
    assert cache_stats() == cache.CacheStats(hits=0, misses=1, compiles=0)
    specs = _tiny()
    plan = psw.plan_sweep(po, 1, specs)
    args = (*po.data_args(), *_row_args(po, plan))

    runner(*args)
    assert cache_stats().compiles == 1
    runner(*args)
    assert cache_stats().compiles == 3
    runner(*args)
    assert cache_stats().compiles == 3 and not reads


def _row_args(po, plan):
    r = plan.resolved[0]
    return (prng.keys_from_seeds([plan.specs[0].seed]),
            torch.tensor([plan.specs[0].step_size]), [r.tau], [r.scheme_id],
            [r.delay_id], [1], po.init_flat()[None])


def test_cache_keys_separate_static_dims(objs):
    _, po = objs
    k = dict(group_epochs=2, total=100, option=2, buf_len=4, drop_prob=0.02,
             obj=po)
    base = cache.runner_key("asysvrg", **k)
    assert cache.runner_key("asysvrg", **k) == base
    assert cache.runner_key("hogwild", **k) != base
    for change in (dict(group_epochs=3), dict(drop_prob=0.0),
                   dict(buf_len=8), dict(fused=True)):
        assert cache.runner_key("asysvrg", **{**k, **change}) != base
    same = LogisticRegression(po.X, po.y, po.l2, device="cpu")
    assert cache.runner_key("asysvrg", **{**k, "obj": same}) == base
    fused = cache.runner_key("asysvrg", **k, fused=True)
    # no mesh slot: a sharded dispatch wraps the runner of this same key
    assert fused[-1] == "cpu" and base[-1] is None
    assert base[6] == po.runner_static_key() and len(base) == 9
    assert base[7] == (((101, 2048), "float32", "cpu"),
                       ((101,), "float32", "cpu"), ((), "float", None))


def test_clear_cache_and_lru_bound(objs, monkeypatch):
    _, po = objs
    psw.run_sweep(po, 1, _tiny())
    assert cache_size() >= 1
    clear_cache()
    assert cache_size() == 0 and cache_stats() == cache.CacheStats()
    monkeypatch.setattr(cache, "_MAX_RUNNERS", 2)
    for epochs in (1, 2, 3):
        psw.run_sweep(po, epochs, _tiny())
    assert cache_size() == 2
    # the least recently used runner went, the newest stayed
    for epochs, hit in ((3, 1), (1, 0)):
        base = cache_stats()
        psw.run_sweep(po, epochs, _tiny())
        assert cache_stats().since(base).hits == hit


def test_mesh_raises(objs):
    """A mesh that is not a named `DeviceMesh` is refused by the service and
    by `run_sweep` (a real one row-shards: tests/test_torch_distributed.py).
    The runner cache takes no mesh: a sharded dispatch wraps its runner."""
    _, po = objs
    with pytest.raises(TypeError, match="DeviceMesh"):
        SweepService(po, mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        psw.run_sweep(po, 1, _tiny(), mesh=object())
    with pytest.raises(TypeError, match="mesh"):
        cache.get_group_runner("asysvrg", group_epochs=1, total=8, option=2,
                               buf_len=4, drop_prob=0.0, obj=po,
                               mesh=object())


# ---------------------------------------------------------------- results
def test_result_retention_and_errors(objs):
    _, po = objs
    svc = SweepService(po, epochs=1, max_results=1)
    a = svc.submit(_tiny())
    assert svc.pending() == 1 and svc.pending_rows() == 1
    res = svc.result(a)                          # flushes implicitly
    _same(res, psw.run_sweep(po, 1, _tiny()))
    b = svc.sweep(_tiny(1))
    assert b.histories.shape == (1, 2)
    with pytest.raises(ResultEvictedError):
        svc.result(a)
    svc.discard(1)
    with pytest.raises(ResultEvictedError):
        svc.wait_result(1, timeout=0.1)
    with pytest.raises(KeyError):
        svc.result(10_000)
    c = svc.submit(_tiny())
    with pytest.raises(TimeoutError):
        svc.wait_result(c, timeout=0.05)
    with pytest.raises(ValueError):
        svc.submit([])
    with pytest.raises(ValueError):
        svc.submit([psw.SweepSpec(algo="svrg", tau=3)])
    assert svc.pending() == 1                    # the bad one never queued


def test_wait_result_returns_another_threads_flush(objs):
    _, po = objs
    svc = SweepService(po, epochs=1)
    rid = svc.submit(_tiny())
    flusher = threading.Thread(target=svc.flush)
    flusher.start()
    res = svc.wait_result(rid, timeout=120)
    flusher.join(timeout=120)
    assert not flusher.is_alive()
    _same(res, psw.run_sweep(po, 1, _tiny()))


def test_flush_selector_must_partition(objs):
    _, po = objs
    svc = SweepService(po, epochs=1)
    svc.submit(_tiny())
    svc.submit(_tiny(1))
    with pytest.raises(ValueError):
        svc.flush(lambda q: (q[:1], ()))
    assert svc.flush(lambda q: (q[:1], q[1:])) == [0]
    assert svc.pending() == 1


def test_flush_events_histograms_and_latencies(objs):
    _, po = objs
    svc = SweepService(po, epochs=2)
    bus = progress.enable_progress()
    try:
        cursor = bus.latest_seq()
        rid = svc.submit(_grid_a(psw), tenant="team-a")
        svc.flush()
        events, _ = bus.watch(cursor, f"req-{rid}")
    finally:
        progress.disable_progress(clear=True)
    res = svc.result(rid)
    assert len(events) == 1 and events[0].tenant == "team-a"
    assert events[0].losses == tuple(tuple(float(v) for v in h)
                                     for h in res.histories)
    flush_s, req_s = svc.latencies()
    assert len(flush_s) == len(req_s) == 1
    _, _, count = svc.histograms.flush_latency_seconds.snapshot()
    assert count == 1


# ------------------------------------------------------------------- jobs
@pytest.mark.parametrize("max_groups", [1, 2])
def test_run_job_resumes_from_checkpoint(objs, tmp_path, max_groups):
    """A job of 3 groups cut after ``max_groups`` and resumed equals the
    job in one call and a standalone `run_sweep` (which
    tests/test_torch_sweep.py holds against the JAX package)."""
    _, po = objs
    svc = SweepService(po, epochs=2)
    specs = _job()
    ckpt = Checkpointer(str(tmp_path / "cut"))
    assert svc.run_job(specs, checkpointer=ckpt,
                       max_groups=max_groups) == (None, False)
    assert len(ckpt.list_steps()) == max_groups
    resumed, done = svc.run_job(specs, checkpointer=ckpt)
    whole, _ = svc.run_job(specs,
                           checkpointer=Checkpointer(str(tmp_path / "one")))
    assert done
    _same(resumed, whole)
    _same(resumed, psw.run_sweep(po, 2, specs))


def test_run_job_rejects_a_different_job(objs, tmp_path):
    _, po = objs
    svc = SweepService(po, epochs=1)
    ckpt = Checkpointer(str(tmp_path))
    svc.run_job(_job(), checkpointer=ckpt, max_groups=1)
    with pytest.raises(ValueError, match="different job"):
        svc.run_job(_job(), 2, checkpointer=ckpt)
    with pytest.raises(ValueError, match="different job"):
        SweepService(po, epochs=1, w0=np.ones(po.p, np.float32)).run_job(
            _job(), checkpointer=ckpt)


def test_run_job_watchdog_truncation_persists(objs, tmp_path):
    """``cancel_row`` freezes a diverging row inside a job, the freeze is
    checkpointed, and ``cancel_job`` raises `JobDiverged`."""
    _, po = objs
    specs = [psw.SweepSpec(seed=s, step_size=step, num_threads=4,
                           inner_steps=steps)
             for s, step, steps in ((0, 2.0, 10), (9, 1e4, 10), (1, 0.5, 5))]
    ckpt = Checkpointer(str(tmp_path / "row"))
    svc = SweepService(po, epochs=2, watchdog=Watchdog(policy="cancel_row"))
    assert svc.run_job(specs, checkpointer=ckpt, max_groups=1)[1] is False
    res, done = svc.run_job(specs, checkpointer=ckpt)
    assert done and res.diverged_rows.tolist() == [-1, 0, -1]
    assert res.epochs_per_row.tolist() == [2, 0, 2]
    assert np.all(res.histories[1] == res.histories[1, 0])
    alone = psw.run_sweep(po, 2, [specs[0], specs[2]])
    np.testing.assert_array_equal(res.histories[[0, 2]], alone.histories)
    with pytest.raises(JobDiverged) as exc:
        SweepService(po, epochs=2, watchdog=Watchdog(policy="cancel_job")) \
            .run_job(specs, checkpointer=Checkpointer(str(tmp_path / "job")))
    assert exc.value.rows == {1: 0}
