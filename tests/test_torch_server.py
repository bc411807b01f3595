"""repro_torch.server against repro.server on the CPU.

Same numpy-seeded data in both packages (96 × 64 logistic data, a
`NonconvexLogistic` on it, a tiny `mlp_lm_objective`), ≤ 2 epochs:

  * `FairShare` makes the same admission decisions as the JAX package's on
    the same request sequences, flush after flush;
  * the wire format is shared: a port result decodes through the JAX
    package's `result_from_dict` to equal arrays (an MLP result's
    `final_params` is the JAX tree), a JAX result through the port's; a
    JAX `SweepClient` gets from the port's `SweepServer` what the port's
    service computes in process, bit for bit, and the port's client talks
    to the JAX server;
  * the port's server: deadline and size flushes counted in `DaemonStats`,
    coalesced results equal to standalone `run_sweep` (bits, on the CPU),
    a `NonconvexLogistic` request named through the registry and served
    fused, a time-sliced job, `/stats` (its policy without the width
    padding's keys), `/metrics`, `/healthz` and the error mapping.

Every client call passes a timeout and every server stops in a
``finally``, so nothing waits unbounded.
"""
import dataclasses
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import repro.server as jserver
from repro.core import sweep as jsw
from repro.core.objective import LogisticRegression as JaxLogReg
from repro.core.objectives import mlp_lm_objective as jax_mlp
from repro.server import http as jhttp
from repro.service import SweepService as JaxService
from repro.service.scheduler import SweepRequest as JaxRequest
from repro_torch.core import sweep as psw
from repro_torch.core.objective import (LogisticRegression, register_objective,
                                        unregister_objective)
from repro_torch.core.objectives import NonconvexLogistic, mlp_lm_objective
from repro_torch.server import (DaemonStats, FairShare, FlushPolicy,
                                ServeDaemon, SweepClient, SweepServer,
                                TenantPolicy, snapshot)
from repro_torch.server import http as phttp
from repro_torch.service import ResultEvictedError, SweepService
from repro_torch.service.scheduler import SweepRequest

TIMEOUT = 60.0


def _data(n=96, p=64, seed=0):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((n, p)) / 8).astype(np.float32)
    y = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def obj():
    return LogisticRegression(*_data(), 1e-3, device="cpu")


def _specs(mod, seeds, **over):
    return [mod.SweepSpec(scheme="inconsistent", step_size=0.5, tau=3,
                          num_threads=4, inner_steps=10, seed=s, **over)
            for s in seeds]


def _same(got, want):
    for name in ("histories", "final_w", "effective_passes", "total_updates",
                 "epochs_per_row"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert [dataclasses.asdict(s) for s in got.specs] == \
        [dataclasses.asdict(s) for s in want.specs]
    assert tuple(got.param_shapes) == tuple(want.param_shapes)


# ---------------------------------------------------------------------------
# fairness: the same decisions as the JAX package's
# ---------------------------------------------------------------------------

def _queue(mod_req, mod_spec, plan):
    """Requests from (tenant, rows, priority) triples, ids in order."""
    return [mod_req(request_id=i, specs=tuple(mod_spec(seed=100 * i + k)
                                              for k in range(rows)),
                    epochs=1, tenant=tenant, priority=prio)
            for i, (tenant, rows, prio) in enumerate(plan)]


SCENARIOS = {
    "weights": (dict(quantum_rows=1, max_rows_per_flush=9),
                {"A": dict(weight=2.0), "B": dict(weight=1.0)},
                [(t, 1, 0) for _ in range(8) for t in ("A", "B")]),
    "priority": (dict(quantum_rows=4, max_rows_per_flush=4),
                 {"bulk": dict(weight=10.0), "live": dict(priority=5)},
                 [("bulk", 1, 0)] * 4 + [("live", 1, 0)] * 2
                 + [("bulk", 1, 9)]),
    "giant": (dict(quantum_rows=4, max_rows_per_flush=8), {},
              [("big", 30, 0)] + [("small", 1, 0)] * 12),
    "unbounded": (dict(quantum_rows=2), {"x": dict(weight=0.5)},
                  [("x", 3, 0), ("y", 1, 0), ("x", 1, 0), ("y", 5, 0)]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_fair_share_decisions_equal_jax(name):
    kw, tenants, plan = SCENARIOS[name]
    fairs = [jserver.FairShare(**kw), FairShare(**kw)]
    for fair in fairs:
        for tenant, pol in tenants.items():
            fair.set_tenant(tenant, **pol)
    queues = [_queue(JaxRequest, jsw.SweepSpec, plan),
              _queue(SweepRequest, psw.SweepSpec, plan)]
    for _ in range(40):
        if not queues[0]:
            break
        takes = []
        for k in (0, 1):
            take, queues[k] = fairs[k].select(queues[k])
            takes.append([r.request_id for r in take])
        assert takes[0] == takes[1]
        assert fairs[0].deficits() == fairs[1].deficits()
    assert not queues[0] and not queues[1]


def test_policies_validate_as_jax():
    for bad in (dict(weight=0.0), dict(weight=-1.0)):
        with pytest.raises(ValueError):
            TenantPolicy(**bad)
    for bad in (dict(quantum_rows=0), dict(max_rows_per_flush=0)):
        with pytest.raises(ValueError):
            FairShare(**bad)
    for bad in (dict(max_rows=0), dict(max_delay_ms=-1),
                dict(job_groups_per_slice=0), dict(heartbeat_stall_s=0)):
        with pytest.raises(ValueError):
            FlushPolicy(**bad)
    # the JAX policy's fields less the width padding's two
    jax_fields = {f.name for f in dataclasses.fields(jserver.FlushPolicy)}
    port_fields = {f.name for f in dataclasses.fields(FlushPolicy)}
    assert port_fields == jax_fields - {"stable_widths", "max_pad_factor"}
    assert {f.name for f in dataclasses.fields(DaemonStats)} == \
        {f.name for f in dataclasses.fields(jserver.DaemonStats)}


# ---------------------------------------------------------------------------
# the shared wire format
# ---------------------------------------------------------------------------

def _wire(payload):
    return json.loads(json.dumps(payload))


@pytest.fixture(scope="module")
def port_result(obj):
    specs = _specs(psw, [0, 1]) + [psw.SweepSpec(
        algo="hogwild", scheme="unlock", step_size=0.5, num_threads=4,
        tau=-1, telemetry=True)]
    return psw.run_sweep(obj, 2, specs)


def test_port_result_decodes_in_jax(port_result):
    back = jhttp.result_from_dict(_wire(phttp.result_to_dict(3, port_result)))
    _same(back, port_result)
    assert back.telemetry is not None
    for name in port_result.telemetry._fields:
        np.testing.assert_array_equal(getattr(back.telemetry, name),
                                      getattr(port_result.telemetry, name))
    assert back.final_w.dtype == np.float32


def test_jax_result_decodes_in_port():
    X, y = _data()
    jres = jsw.run_sweep(JaxLogReg(X, y, 1e-3), 1, _specs(jsw, [0]))
    back = phttp.result_from_dict(_wire(jhttp.result_to_dict(1, jres)))
    _same(back, jres)
    assert isinstance(back, psw.SweepResult)


def test_mlp_result_final_params_is_the_jax_tree():
    pm = mlp_lm_objective(16, vocab_size=16, seq_len=4, d_model=8,
                          d_hidden=16, device="cpu")
    res = psw.run_sweep(pm, 1, [psw.SweepSpec(step_size=0.1, tau=2,
                                              num_threads=4, inner_steps=8)])
    back = jhttp.result_from_dict(_wire(phttp.result_to_dict(0, res)))
    jm = jax_mlp(16, vocab_size=16, seq_len=4, d_model=8, d_hidden=16)
    assert back.param_shapes == jm.param_shapes()
    got = back.final_params(0)
    assert sorted(got) == ["b1", "embed", "norm", "w1", "w2"]
    for key, arr in res.final_params(0).items():
        np.testing.assert_array_equal(got[key], arr)


def test_codec_takes_tensors_off_their_device(port_result):
    """Tensor fields leave their device through ``.cpu()``; float32 values
    survive the JSON round trip exactly."""
    import torch
    as_tensors = port_result._replace(
        final_w=torch.from_numpy(port_result.final_w),
        histories=torch.from_numpy(port_result.histories))
    back = phttp.result_from_dict(_wire(phttp.result_to_dict(0, as_tensors)))
    _same(back, port_result)


def test_spec_codec_rejects_unknown_fields():
    assert phttp.spec_from_dict(phttp.spec_to_dict(psw.SweepSpec(seed=3))) \
        == psw.SweepSpec(seed=3)
    with pytest.raises(ValueError):
        phttp.spec_from_dict({"nope": 1})
    with pytest.raises(ValueError):
        phttp.spec_from_dict([1])


# ---------------------------------------------------------------------------
# clients and servers across the packages
# ---------------------------------------------------------------------------

def test_jax_client_against_port_server(obj):
    """The JAX package's client submits to the port's server: results equal
    the port's in-process sweep bit for bit."""
    svc = SweepService(obj, epochs=1)
    server = SweepServer(svc, policy=FlushPolicy(max_rows=64,
                                                 max_delay_ms=20)).start()
    try:
        client = jserver.SweepClient(server.url, timeout=TIMEOUT, poll_s=2.0)
        rid = client.submit(_specs(jsw, [4, 5]), tenant="jax-side")
        got = client.result(rid, timeout=TIMEOUT)
        assert client.healthz()["status"] == "ok"
    finally:
        server.stop()
    _same(got, psw.run_sweep(obj, 1, _specs(psw, [4, 5])))


def test_port_client_against_jax_server():
    X, y = _data()
    jo = JaxLogReg(X, y, 1e-3)
    server = jserver.SweepServer(JaxService(jo, epochs=1), policy=None).start()
    try:
        client = SweepClient(server.url, timeout=TIMEOUT, poll_s=2.0)
        rid = client.submit(_specs(psw, [6]))
        assert rid in client.flush()
        got = client.result(rid, timeout=TIMEOUT)
    finally:
        server.stop()
    _same(got, jsw.run_sweep(jo, 1, _specs(jsw, [6])))


# ---------------------------------------------------------------------------
# the port's server
# ---------------------------------------------------------------------------

def test_deadline_and_size_flushes_coalesce_tenants(obj):
    """A lone request flushes on the deadline; two tenants' rows reaching
    ``max_rows`` flush on size, coalesced; each result equals a standalone
    `run_sweep` bit for bit."""
    svc = SweepService(obj, epochs=1)
    server = SweepServer(svc, policy=FlushPolicy(max_rows=4,
                                                 max_delay_ms=50)).start()
    try:
        client = SweepClient(server.url, timeout=TIMEOUT, poll_s=2.0)
        rid = client.submit(_specs(psw, [0]), tenant="a")
        lone = client.result(rid, timeout=TIMEOUT)
        deadline = server.daemon.stats_snapshot().deadline_flushes
        server.daemon.policy = dataclasses.replace(server.daemon.policy,
                                                   max_delay_ms=3_600_000)
        rid_a = client.submit(_specs(psw, [1, 2]), tenant="a")
        rid_b = client.submit(_specs(psw, [3, 4]), tenant="b")
        got_a = client.result(rid_a, timeout=TIMEOUT)
        got_b = client.result(rid_b, timeout=TIMEOUT)
        stats = server.daemon.stats_snapshot()
    finally:
        server.stop()
    assert deadline >= 1 and stats.size_flushes >= 1
    _same(lone, psw.run_sweep(obj, 1, _specs(psw, [0])))
    _same(got_a, psw.run_sweep(obj, 1, _specs(psw, [1, 2])))
    _same(got_b, psw.run_sweep(obj, 1, _specs(psw, [3, 4])))
    assert svc.stats().rows_coalesced >= 4


def test_named_nonconvex_request_served_fused(obj):
    """A second tenant names a registered `NonconvexLogistic`; its fused
    rows (K2 and K3 with the clipped penalty, plain versions here) come
    back equal to a standalone run."""
    X, y = _data(seed=1)
    ncv = register_objective("ncv-test", NonconvexLogistic(
        X, y, lam=1e-2, alpha=10.0, device="cpu"))
    specs = _specs(psw, [0, 1], objective="ncv-test", engine_mode="fused")
    svc = SweepService(obj, epochs=2)
    server = SweepServer(svc, policy=FlushPolicy(max_rows=64,
                                                 max_delay_ms=20),
                         fairness=FairShare(quantum_rows=8)).start()
    try:
        client = SweepClient(server.url, timeout=TIMEOUT, poll_s=2.0)
        rid_l = client.submit(_specs(psw, [9], engine_mode="fused"),
                              tenant="logreg")
        rid_n = client.submit(specs, tenant="nonconvex")
        got_n = client.result(rid_n, timeout=TIMEOUT)
        got_l = client.result(rid_l, timeout=TIMEOUT)
        stats = client.stats()
        _same(got_n, psw.run_sweep(ncv, 2, specs))
    finally:
        server.stop()
        unregister_objective("ncv-test")
    _same(got_l, psw.run_sweep(obj, 2, _specs(psw, [9],
                                              engine_mode="fused")))
    assert all(s.engine_mode == "fused" for s in got_n.specs)
    assert set(stats["fairness"]) == {"quantum_rows", "max_rows_per_flush",
                                      "deficits"}


def test_job_time_slices_and_resumes(obj):
    """POST /job: a 3-group sweep runs one group a turn between flushes and
    ends equal to one `run_sweep` call."""
    specs = (_specs(psw, [0, 1])
             + [psw.SweepSpec(algo="svrg", step_size=0.5, num_threads=1,
                              inner_steps=12, seed=3),
                psw.SweepSpec(algo="hogwild", scheme="consistent",
                              step_size=0.5, tau=2, num_threads=3, seed=5)])
    svc = SweepService(obj, epochs=2)
    server = SweepServer(svc, policy=FlushPolicy(
        max_rows=64, max_delay_ms=20, job_groups_per_slice=1)).start()
    try:
        client = SweepClient(server.url, timeout=TIMEOUT, poll_s=2.0)
        job = client.submit_job(specs, epochs=2, tenant="big")
        assert job["watch_id"] == f"job-{job['job_id']}"
        got = client.job_result(job["job_id"], timeout=TIMEOUT)
        stats = server.daemon.stats_snapshot()
        with pytest.raises(KeyError):
            client.job_result(999, timeout=5.0)
    finally:
        server.stop()
    _same(got, psw.run_sweep(obj, 2, specs))
    assert stats.job_slices == 3 and stats.jobs_completed == 1


def test_stats_metrics_and_health(obj):
    svc = SweepService(obj, epochs=1)
    server = SweepServer(svc, policy=FlushPolicy(max_delay_ms=20),
                         fairness=FairShare()).start()
    try:
        client = SweepClient(server.url, timeout=TIMEOUT, poll_s=2.0)
        client.sweep(_specs(psw, [0]), tenant="t", timeout=TIMEOUT)
        stats = client.stats()
        text = client.metrics()
        health = client.healthz()
        ledger = client.ledger()
        trace = client.trace()
    finally:
        server.stop()
    assert health["status"] == "ok" and health["daemon_running"]
    assert {"service", "queue", "tenants", "flush_latency",
            "request_latency", "runner_cache", "daemon",
            "fairness"} <= set(stats)
    assert "stable_widths" not in stats["daemon"]["policy"]
    assert "max_pad_factor" not in stats["daemon"]["policy"]
    assert stats["tenants"]["t"] == {"rows_submitted": 1, "rows_completed": 1}
    assert "repro_service_requests_completed" in text or \
        "requests_completed" in text
    assert set(ledger) == {"enabled", "groups"}
    assert "recent" in trace


def test_snapshot_sections_equal_jax(obj):
    """`snapshot` over a worked service has the JAX package's sections, and
    its daemon block the same keys less the width padding's."""
    X, y = _data()
    jsvc = JaxService(JaxLogReg(X, y, 1e-3), epochs=1)
    psvc = SweepService(obj, epochs=1)
    jsvc.sweep(_specs(jsw, [0]))
    psvc.sweep(_specs(psw, [0]))
    jd = jserver.ServeDaemon(jsvc, jserver.FlushPolicy())
    pd = ServeDaemon(psvc, FlushPolicy())
    js = jserver.snapshot(jsvc, jd, jserver.FairShare())
    ps = snapshot(psvc, pd, FairShare())
    assert set(ps) == set(js)
    assert set(ps["daemon"]) == set(js["daemon"])
    assert set(ps["daemon"]["policy"]) == \
        set(js["daemon"]["policy"]) - {"stable_widths", "max_pad_factor"}
    assert set(ps["service"]) == set(js["service"]) - {"rows_padded"}
    assert json.loads(json.dumps(ps)) == ps


def test_error_mapping(obj):
    svc = SweepService(obj, epochs=1, max_results=2)
    server = SweepServer(svc, policy=FlushPolicy(max_delay_ms=20)).start()
    try:
        client = SweepClient(server.url, timeout=TIMEOUT, poll_s=1.0)
        with pytest.raises(KeyError):
            client.result(10_000, timeout=5.0)
        with pytest.raises(ValueError):
            client.submit([])
        with pytest.raises(ValueError):
            client.submit([psw.SweepSpec(scheme="bogus")])
        rid0 = client.submit(_specs(psw, [0]))
        client.result(rid0, timeout=TIMEOUT)
        for s in (1, 2):
            client.sweep(_specs(psw, [s]), timeout=TIMEOUT)
        with pytest.raises(ResultEvictedError):
            client.result(rid0, timeout=5.0)
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(server.url + "/nope", timeout=TIMEOUT)
        assert err.value.code == 404
    finally:
        server.stop()


def test_stop_drains_queue_and_jobs(obj):
    """``stop(drain=True)`` flushes what is queued and finishes the jobs."""
    svc = SweepService(obj, epochs=1)
    daemon = ServeDaemon(svc, FlushPolicy(max_rows=1000,
                                          max_delay_ms=3_600_000)).start()
    try:
        rid = svc.submit(_specs(psw, [0]))
        handle = daemon.submit_job(_specs(psw, [1]), 1)
    finally:
        daemon.stop(drain=True, timeout=TIMEOUT)
    assert svc.pending() == 0
    _same(svc.result(rid), psw.run_sweep(obj, 1, _specs(psw, [0])))
    _same(handle.result(timeout=TIMEOUT),
          psw.run_sweep(obj, 1, _specs(psw, [1])))
    assert daemon.stats_snapshot().jobs_completed == 1
