"""repro_torch.obs against repro.obs on the CPU.

The stdlib pieces (tracer, histograms, progress bus, Prometheus text) are
fed the same events in both packages and must give equal span trees
(times aside), equal bucket counts, equal event streams (publish stamps
aside) and byte-equal exposition text. The numeric pieces run on the same
numpy-seeded data (`make_synthetic_libsvm("rcv1", scale=0.005)`, 2
epochs): the realized delays of `obs.telemetry` equal the JAX package's
integer for integer (repro_torch.prng is bit-equal to jax.random), the
`SweepTelemetry` of a sweep equals it with integers exactly and floats
within 1e-6, the watchdog's three policies flag and freeze the same rows,
and the ledger's entries equal the reference's for the same dispatches
against the same hardware.
"""
import dataclasses
import math

import numpy as np
import pytest

from repro.core import sweep as jsw
from repro.core.objective import LogisticRegression as JaxLogReg
from repro.data.libsvm import make_synthetic_libsvm
from repro.obs import ledger as jledger
from repro.obs import metrics as jmetrics
from repro.obs import progress as jprogress
from repro.obs import prometheus as jprometheus
from repro.obs import telemetry as jtelemetry
from repro.obs import trace as jtrace
from repro.obs import watchdog as jwatchdog
from repro.service import SweepService as JaxService
from repro_torch import config
from repro_torch.core import sweep as psw
from repro_torch.core.objective import LogisticRegression
from repro_torch.launch import roofline
from repro_torch.obs import ledger, metrics, progress, prometheus, telemetry
from repro_torch.obs import trace, watchdog
from repro_torch.service import SweepService

EPOCHS = 2
DIVERGING_STEP = 1e4      # explodes the rcv1 loss at epoch 1


@pytest.fixture(scope="module")
def objs():
    ds = make_synthetic_libsvm("rcv1", scale=0.005)
    return (JaxLogReg(ds.X, ds.y, ds.l2_reg),
            LogisticRegression(ds.X, ds.y, ds.l2_reg, device="cpu"))


@pytest.fixture(autouse=True)
def _obs_off():
    """The process-global toggles of both packages off and empty around
    every test."""
    for mod in (jledger, ledger):
        mod.disable_ledger(clear=True)
    for mod in (jprogress, progress):
        mod.disable_progress(clear=True)
    for mod in (jtrace, trace):
        mod.disable_tracing(clear=True)
    yield
    for mod in (jledger, ledger):
        mod.disable_ledger(clear=True)
    for mod in (jprogress, progress):
        mod.disable_progress(clear=True)
    for mod in (jtrace, trace):
        mod.disable_tracing(clear=True)


# ------------------------------------------------------------------ tracer
def _nested(tr):
    a, b = tr.new_trace(), tr.new_trace()
    with tr.span(a, "submit", rows=3, tenant="t1"):
        with tr.span(a, "plan", parent_name="submit"):
            pass
    with tr.span(b, "submit", rows=1):
        pass
    with tr.span_all((a, b, a, ""), "coalesce", parent_name="submit",
                     requests=2):
        with tr.span_all((a, b), "dispatch", parent_name="coalesce"):
            tr.annotate(cache="miss")
            with tr.span_active("execute", engine="asysvrg"):
                tr.annotate(compiled=True)
    return (a, b)


def _errors(tr):
    a = tr.new_trace()
    with tr.span(a, "submit"):
        pass
    try:
        with tr.span(a, "dispatch", parent_name="submit"):
            raise ValueError("boom")
    except ValueError as exc:
        tr.record_error(a, exc)
    tr.record_error("", ValueError("ignored"))
    return (a,)


def _bounded(tr):
    tr.max_traces, tr.max_spans = 3, 4
    tids = [tr.new_trace() for _ in range(5)]
    for tid in tids:
        for i in range(6):
            with tr.span(tid, f"s{i}", i=i):
                pass
    with tr.span_active("orphan"):          # no open span: a no-op
        pass
    return tuple(tids)


def _disabled(tr):
    tr.disable()
    tid = tr.new_trace()
    with tr.span(tid, "submit"), tr.span_active("execute"):
        tr.annotate(x=1)
    return (tid,)


def _timeless(tree):
    """A span tree without its clock readings."""
    if tree is None:
        return None
    spans = [{k: v for k, v in sp.items()
              if k not in ("start_s", "duration_ms")} for sp in tree["spans"]]
    return {**tree, "spans": spans}


@pytest.mark.parametrize("script", [_nested, _errors, _bounded, _disabled])
def test_tracer_span_trees_equal_reference(script):
    got_tr, want_tr = trace.Tracer(), jtrace.Tracer()
    got_tr.enable()
    want_tr.enable()
    got_ids, want_ids = script(got_tr), script(want_tr)
    assert got_ids == want_ids
    for tid in got_ids:
        assert _timeless(got_tr.get(tid)) == _timeless(want_tr.get(tid))
    assert got_tr.recent(8) == want_tr.recent(8)
    got_err, want_err = got_tr.last_error(), want_tr.last_error()
    assert (got_err is None) == (want_err is None)
    if got_err:
        assert _timeless(got_err) == _timeless(want_err)


# -------------------------------------------------------------- histograms
@pytest.mark.parametrize("buckets,seed", [
    (metrics.LATENCY_BUCKETS_S, 0), (metrics.ROWS_BUCKETS, 1),
    ((1.0, 1.1, 1.25, 1.5, 2.0, 3.0, 5.0), 2), ((3.0, 1.0, 2.0), 3)])
def test_histogram_counts_equal_reference(buckets, seed):
    values = np.random.default_rng(seed).lognormal(0.0, 2.0, 200)
    values = list(values) + list(buckets) + [0.0, math.inf]
    got, want = metrics.Histogram(buckets), jmetrics.Histogram(buckets)
    for v in values:
        got.observe(v)
        want.observe(v)
    assert got.snapshot() == want.snapshot()
    assert metrics.LATENCY_BUCKETS_S == jmetrics.LATENCY_BUCKETS_S
    assert metrics.ROWS_BUCKETS == jmetrics.ROWS_BUCKETS


def test_service_histogram_set_equals_reference():
    got, want = metrics.ServiceHistograms(), jmetrics.ServiceHistograms()
    assert got.enabled is want.enabled is True
    # the reference's pad_factor measures its width padding, which the
    # port does not have
    assert {k: h.bounds for k, h in got.as_dict().items()} == \
        {k: h.bounds for k, h in want.as_dict().items() if k != "pad_factor"}


# ------------------------------------------------------------ progress bus
def _publish(bus):
    for i in range(7):
        bus.publish(kind="slice" if i % 3 else "flush", watch_id=f"job-{i % 2}",
                    tenant="t", group="asysvrg-fused-M200", slice_index=i,
                    slices_total=7, rows=(0, 1), losses=((0.69, 0.4 - i),),
                    loss_deltas=((-0.29,),), diverged=(1,) if i == 5 else (),
                    wall_s=0.25 * i, trace_id="t1")
    bus.publish(kind="done", watch_id="job-1")


@pytest.mark.parametrize("maxlen,cursor,watch_id", [
    (1024, 0, None), (1024, 3, "job-1"), (4, 0, None), (4, 2, "job-0")])
def test_progress_stream_equals_reference(maxlen, cursor, watch_id):
    got, want = progress.ProgressBus(maxlen), jprogress.ProgressBus(maxlen)
    _publish(got)
    _publish(want)
    (g, gc), (w, wc) = (bus.watch(cursor, watch_id) for bus in (got, want))
    assert gc == wc and got.latest_seq() == want.latest_seq()

    def stampless(events):
        return [{k: v for k, v in e.to_dict().items() if k != "ts"}
                for e in events]
    assert stampless(g) == stampless(w)


# -------------------------------------------------------------- prometheus
def _filled(mod):
    hs = mod.ServiceHistograms()
    rng = np.random.default_rng(5)
    for v in rng.exponential(0.2, 40):
        hs.flush_latency_seconds.observe(v)
        hs.request_latency_seconds.observe(2 * v)
    for v in rng.integers(1, 300, 30):
        hs.rows_per_flush.observe(int(v))
    # the port has no width padding, so no pad_factor histogram
    return {k: h for k, h in hs.as_dict().items() if k != "pad_factor"}


SNAPSHOTS = [
    {"service": {"flushes": 3, "cache_hit_rate": 0.75, "healthy": True,
                 "last_error": None, "name": "svc"},
     "tenants": {"team-a": {"rows_submitted": 128, "rows_completed": 64},
                 'we"ird\\n': {"rows_submitted": 1}}},
    {"ledger": {"asysvrg-fused-M40480-opt2-buf8-rows4-E2": {
        "dispatches": 2, "attained_frac": 0.0024, "flops_source": "analytic",
        "flops": 7.3e9}},
     "fairness": {"deficits": {"a": 1.5, "b": -0.25}},
     "weird": {"nan": float("nan"), "inf": float("inf"),
               "ninf": float("-inf"), "np": 3}},
    {},
]


@pytest.mark.parametrize("snapshot", SNAPSHOTS)
@pytest.mark.parametrize("with_histograms", [False, True])
def test_prometheus_text_byte_equal(snapshot, with_histograms):
    got = prometheus.render(snapshot,
                            _filled(metrics) if with_histograms else None)
    want = jprometheus.render(snapshot,
                              _filled(jmetrics) if with_histograms else None)
    assert got == want
    assert got.endswith("\n")


# --------------------------------------------------------------- telemetry
@pytest.mark.parametrize("seed,delay_id,tau,total,epochs", [
    (0, 1, 7, 40, 2), (3, 2, 7, 200, 2), (11, 2, 40, 64, 3),
    (-5, 0, 0, 16, 1), (2**31 - 1, 2, 1, 33, 2)])
def test_realized_delays_equal_reference(seed, delay_id, tau, total, epochs):
    got = telemetry.realized_delays(seed, delay_id, tau, total, epochs)
    want = jtelemetry.realized_delays(seed, delay_id, tau, total, epochs)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _telemetry_specs(mod):
    return [
        mod.SweepSpec(seed=3, scheme="inconsistent", step_size=2.0,
                      num_threads=8, inner_steps=5, delay_kind="uniform",
                      telemetry=True),
        mod.SweepSpec(seed=4, scheme="unlock", step_size=2.0, num_threads=8,
                      inner_steps=5, epochs=1),
        mod.SweepSpec(seed=5, scheme="consistent", step_size=1.0,
                      num_threads=4, inner_steps=10, delay_kind="fixed",
                      telemetry=True),
        mod.SweepSpec(algo="hogwild", seed=6, scheme="unlock", step_size=1.0,
                      num_threads=8, tau=-1, delay_kind="uniform",
                      telemetry=True, epochs=1),
    ]


@pytest.fixture(scope="module")
def telemetry_runs(objs):
    jo, po = objs
    return (jsw.run_sweep(jo, EPOCHS, _telemetry_specs(jsw)),
            psw.run_sweep(po, EPOCHS, _telemetry_specs(psw)))


def test_sweep_telemetry_equals_reference(telemetry_runs):
    want, got = telemetry_runs
    tw, tg = want.telemetry, got.telemetry
    assert isinstance(tg, telemetry.SweepTelemetry)
    assert tg._fields == tw._fields
    for name in ("rows", "staleness_max"):
        assert getattr(tg, name).dtype == getattr(tw, name).dtype
        np.testing.assert_array_equal(getattr(tg, name), getattr(tw, name))
    for name in ("staleness_mean", "staleness_var", "staleness_per_epoch"):
        np.testing.assert_array_equal(getattr(tg, name), getattr(tw, name))
    for name in ("update_norm", "loss_delta", "loss_delta_var"):
        np.testing.assert_allclose(getattr(tg, name), getattr(tw, name),
                                   rtol=0, atol=1e-6)
    assert tg.rows.tolist() == [True, False, True, True]
    assert got.diverged_rows is None and want.diverged_rows is None


def test_telemetry_flag_never_changes_results(objs, telemetry_runs):
    _, po = objs
    _, got = telemetry_runs
    off = psw.run_sweep(po, EPOCHS, [dataclasses.replace(s, telemetry=False)
                                     for s in _telemetry_specs(psw)])
    assert off.telemetry is None
    np.testing.assert_array_equal(off.histories, got.histories)
    np.testing.assert_array_equal(off.final_w, got.final_w)


def test_telemetry_wire_form_round_trips(telemetry_runs):
    _, got = telemetry_runs
    back = telemetry.from_dict(telemetry.to_dict(got.telemetry))
    for name in telemetry.SweepTelemetry._fields:
        a, b = getattr(back, name), getattr(got.telemetry, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert telemetry.to_dict(got.telemetry).keys() == \
        jtelemetry.to_dict(telemetry_runs[0].telemetry).keys()


# ---------------------------------------------------------------- watchdog
def _watch_specs(mod):
    return [mod.SweepSpec(seed=s, scheme="inconsistent", step_size=step,
                          num_threads=4, inner_steps=10)
            for s, step in ((0, 2.0), (99, DIVERGING_STEP), (1, 2.0))]


@pytest.mark.parametrize("policy", watchdog.POLICIES)
def test_watchdog_policies_equal_reference(objs, policy):
    """The same rows flagged and frozen by the same policy in both
    packages' coalesced flushes (``cancel_job`` degrades to ``cancel_row``
    in a flush); survivors within the sweep tolerance."""
    jo, po = objs
    out = []
    for svc_cls, mod, wd_mod, obj in ((JaxService, jsw, jwatchdog, jo),
                                      (SweepService, psw, watchdog, po)):
        svc = svc_cls(obj, epochs=EPOCHS,
                      watchdog=wd_mod.Watchdog(policy=policy))
        a = svc.submit(_watch_specs(mod)[:2], tenant="a")
        b = svc.submit(_watch_specs(mod)[2:], tenant="b")
        svc.flush()
        out.append((svc.result(a), svc.result(b), svc.stats().rows_diverged))
    (ja, jb, jn), (pa, pb, pn) = out
    assert pn == jn == 1
    np.testing.assert_array_equal(pa.diverged_rows, ja.diverged_rows)
    assert pa.diverged_rows.tolist() == [-1, 0]
    assert pb.diverged_rows is None and jb.diverged_rows is None
    np.testing.assert_array_equal(pa.epochs_per_row, ja.epochs_per_row)
    frozen = policy != "record"
    assert pa.epochs_per_row.tolist() == [EPOCHS, 0 if frozen else EPOCHS]
    np.testing.assert_array_equal(pa.total_updates, ja.total_updates)
    for got, want in ((pa, ja), (pb, jb)):
        rows = slice(0, 1) if got is pa else slice(None)
        np.testing.assert_allclose(got.histories[rows], want.histories[rows],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.final_w[rows], want.final_w[rows],
                                   rtol=1e-5, atol=1e-6)
    if frozen:
        np.testing.assert_array_equal(pa.histories[1],
                                      np.full(EPOCHS + 1, pa.histories[1, 0]))
        np.testing.assert_array_equal(pa.final_w[1], 0.0)
        np.testing.assert_allclose(ja.histories[1], pa.histories[1],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("policy", watchdog.POLICIES)
@pytest.mark.parametrize("rows", [4, 2])
def test_enforce_group_equals_reference(policy, rows):
    hist = np.asarray([[1.0, 0.5, 0.4], [1.0, np.nan, np.nan],
                       [1.0, 2e3, 3e3], [1.0, np.inf, 1.0]],
                      np.float32)[:rows]
    w = np.arange(12, dtype=np.float32).reshape(4, 3)[:rows]

    class _Row(tuple):
        epochs = 2

        def _replace(self, epochs):
            row = _Row()
            row.epochs = epochs
            return row

    def run(mod):
        calls = []

        def redispatch(amended):
            calls.append([r.epochs for r in amended])
            return np.full_like(hist, 7.0), np.full_like(w, -1.0)

        try:
            got = mod.enforce_group(
                mod.Watchdog(policy=policy), hist, w,
                members=list(range(rows)),
                resolved=[_Row() for _ in range(rows)],
                tenant_of=lambda c: "t", redispatch=redispatch)
        except mod.JobDiverged as exc:
            return ("raised", exc.rows, calls)
        return got, calls

    got, want = run(watchdog), run(jwatchdog)
    assert repr(got) == repr(want)


# ------------------------------------------------------------------ ledger
def _dispatches(mod):
    led = mod.PerfLedger()
    key_f = (7, "asysvrg", 40480, 2, 8, True)
    key_v = (7, "hogwild", 20224, 0, 8, False)
    mod.note_compile()
    led.record_dispatch(key=key_f, rows=4, dim=2048, epochs=2, wall_s=1.5)
    led.record_dispatch(key=key_f, rows=4, dim=2048, epochs=2, wall_s=0.33)
    led.record_dispatch(key=key_f, rows=4, dim=2048, epochs=2, wall_s=0.31)
    led.record_dispatch(key=key_v, rows=1, dim=2048, epochs=2, wall_s=12.0)
    led.record_dispatch(key=key_f, rows=5, dim=2048, epochs=3, wall_s=0.5)
    return led


def test_ledger_entries_equal_reference():
    """Equal entries for the same dispatches; the roofline is the same
    model against the H100 in the port, the TPU v5e in the reference."""
    got, want = _dispatches(ledger).snapshot(), _dispatches(jledger).snapshot()
    assert len(got) == len(want) == 3
    for (label, g), (jlabel, w) in zip(got.items(), want.items()):
        assert label == jlabel
        rf = roofline.attained_fraction(
            rows=g["rows"], dim=g["dim"], total=g["total"],
            epochs=g["epochs"], buf_len=g["buf_len"], fused=bool(g["fused"]),
            wall_s=g["warm_wall_min_s"] or g["wall_s_total"] / g["dispatches"],
            hw=config.H100_SXM)
        assert (g["roofline_s"], g["attained_frac"]) == \
            (rf["roofline_s"], rf["attained_frac"])
        for key in ("roofline_s", "attained_frac"):
            g.pop(key), w.pop(key)
        assert g == w


def test_ledger_brackets_each_group_dispatch(objs):
    """With the ledger on, the port's `_dispatch_group` records one entry
    per group with the analytic cost of its path and a wall time; the
    tracer's execute span sits around the same call."""
    _, po = objs
    specs = [psw.SweepSpec(seed=0, step_size=2.0, num_threads=4,
                           inner_steps=10, engine_mode="fused"),
             psw.SweepSpec(seed=1, scheme="unlock", step_size=2.0,
                           num_threads=4, inner_steps=5, engine_mode="vmap")]
    plan = psw.plan_sweep(po, EPOCHS, specs)
    off = psw.run_sweep(po, EPOCHS, specs)
    led = ledger.enable_ledger()
    tr = trace.enable_tracing()
    tid = tr.new_trace()
    with tr.span(tid, "sweep"):
        on = psw.run_sweep(po, EPOCHS, specs)
    np.testing.assert_array_equal(on.histories, off.histories)
    entries = led.snapshot()
    assert len(entries) == len(plan.groups) == 2
    for (key, members), (label, e) in zip(plan.groups.items(),
                                          entries.items()):
        _, engine, total, _, buf_len, fused = key
        assert label.startswith(psw.group_label(key))
        want = roofline.attained_fraction(
            rows=len(members), dim=po.p, total=total, epochs=EPOCHS,
            buf_len=buf_len, fused=fused, wall_s=e["wall_s_total"])
        assert (e["flops"], e["bytes"], e["roofline_s"]) == \
            (want["flops"], want["bytes"], want["roofline_s"])
        assert e["attained_frac"] == pytest.approx(want["attained_frac"])
        assert e["flops_source"] == "analytic" and e["dispatches"] == 1
    spans = [s for s in tr.get(tid)["spans"] if s["name"] == "execute"]
    assert [(s["tags"]["engine_mode"], s["tags"]["backend"]) for s in spans] \
        == [("fused", "cpu"), ("vmap", "cpu")]
