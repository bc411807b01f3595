"""Stdlib-only HTTP front-end over `SweepService` + `ServeDaemon`; the port
of `repro.server.http`, serving the port's service (its groups run on the
objective's device, the card by default).

One `ThreadingHTTPServer` (a thread per connection — the service and
daemon below it are already thread-safe) exposing the serving tier:

    POST /submit    {"specs": [...], "epochs"?, "tenant"?, "priority"?}
                    -> {"request_id": N}           (admits; nothing runs)
    GET  /result/N?timeout_s=S
                    -> the request's SweepResult   (blocks until the
                    daemon's size/deadline policy has flushed it — the
                    handler WAITS, it never forces a flush, so a result
                    poll cannot defeat coalescing)
    POST /flush     -> {"completed": [ids]}        (operator escape hatch)
    GET  /stats     -> repro_torch.server.metrics.snapshot(...)
    GET  /metrics   -> the same snapshot as Prometheus text exposition
                    0.0.4, plus the service histograms (flush/request
                    latency, rows-per-flush; the pad-factor histogram
                    stays empty: the port pads no group)
    GET  /trace     -> flight-recorder state: recent traces + the retained
                    last-error dump; ``?id=tNN`` returns one request's
                    full span tree (404 once evicted). Submit/result
                    responses echo the trace id in ``X-Trace-Id``.
    GET  /healthz   -> {"status": "ok", ...}; 503 {"status": "stalled"}
                    when the flush daemon's heartbeat is older than
                    ``FlushPolicy.heartbeat_stall_s`` or its thread died
    GET  /watch?id=job-N&cursor=C&timeout_s=S
                    -> {"events": [...], "cursor": C', "enabled": bool}
                    long-poll on the live-progress bus
                    (`repro_torch.obs.progress`): per-slice loss events while a
                    job/flush is still running. ``cursor`` resumes past
                    the last seen event; omit ``id`` for the firehose
                    (every channel). Empty ``events`` after ``timeout_s``
                    means "nothing new yet" — poll again with the same
                    cursor.
    POST /job       {"specs": [...], "epochs"?, "tenant"?}
                    -> {"job_id": N, "watch_id": "job-N"}  (requires the
                    flush daemon; the job time-slices between flushes and
                    streams per-slice events on its watch channel)
    GET  /job/N?timeout_s=S
                    -> the finished job's SweepResult (504 pending while
                    slices still run — watch /watch?id=job-N meanwhile)
    GET  /ledger    -> {"enabled": bool, "groups": {...}} — the per-group
                    performance ledger (`repro_torch.obs.ledger`): runner
                    construction, FLOPs/bytes, attained-vs-roofline
                    fraction per group runner (all zeros/empty until
                    ``enable_ledger()``)

Status mapping: bad input 400; unknown id 404; completed-but-evicted id
410 (`ResultEvictedError` — re-submit or raise ``max_results``); result
not ready within ``timeout_s`` 504 with ``{"status": "pending"}`` (the
client long-polls again). Everything is JSON; numeric payloads round-trip
bit-exactly (Python floats serialize via shortest-round-trip repr, and
float32→float64→float32 is lossless), so an HTTP client's `SweepResult`
equals the service's in-process result bit for bit.

The wire format is the JAX package's, key for key: a result this server
sends decodes with `repro.server.http.result_from_dict`, and one the JAX
server sends decodes with this module's (tests/test_torch_server.py).
"""
from __future__ import annotations

import dataclasses
import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from repro_torch.core.sweep import SweepResult, SweepSpec
from repro_torch.obs import ledger as _ledger
from repro_torch.obs import progress as _progress
from repro_torch.obs import prometheus as _prometheus
from repro_torch.obs import telemetry as _obs_telemetry
from repro_torch.obs.trace import tracer as _tracer
from repro_torch.server import metrics as _metrics
from repro_torch.server.daemon import ServeDaemon
from repro_torch.server.fairness import FairShare
from repro_torch.service.api import ResultEvictedError, SweepService

_SPEC_FIELDS = {f.name: f.type for f in dataclasses.fields(SweepSpec)}
_RESULT_PATH = re.compile(r"^/result/(\d+)$")
_JOB_PATH = re.compile(r"^/job/(\d+)$")
# bound server-side result waits so a dead daemon can't pin handler
# threads forever; clients long-poll in increments below this
MAX_WAIT_S = 30.0


# ------------------------------------------------------------- wire codecs
def spec_to_dict(spec: SweepSpec) -> dict:
    return dataclasses.asdict(spec)


def spec_from_dict(payload: dict) -> SweepSpec:
    if not isinstance(payload, dict):
        raise ValueError(f"spec must be an object, got {type(payload).__name__}")
    unknown = set(payload) - set(_SPEC_FIELDS)
    if unknown:
        raise ValueError(f"unknown SweepSpec fields {sorted(unknown)} "
                         f"(valid: {sorted(_SPEC_FIELDS)})")
    return SweepSpec(**payload)


def _host(a) -> np.ndarray:
    """An array on the host: tensors leave their device through ``.cpu()``."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def result_to_dict(request_id: int, res: SweepResult) -> dict:
    """JSON payload for one result. Arrays go as nested lists of Python
    scalars — exact: float32/float64 survive the repr round-trip."""
    return {
        "request_id": request_id,
        "specs": [spec_to_dict(s) for s in res.specs],
        "histories": _host(res.histories).tolist(),
        "effective_passes": _host(res.effective_passes).tolist(),
        "final_w": _host(res.final_w).tolist(),
        "total_updates": _host(res.total_updates).tolist(),
        "epochs_per_row": _host(res.epochs_per_row).tolist(),
        "param_shapes": [list(entry) for entry in res.param_shapes],
        "telemetry": (None if res.telemetry is None
                      else _obs_telemetry.to_dict(res.telemetry)),
        "diverged_rows": (None if res.diverged_rows is None
                          else _host(res.diverged_rows).tolist()),
    }


def result_from_dict(payload: dict) -> SweepResult:
    telemetry = payload.get("telemetry")
    diverged = payload.get("diverged_rows")   # absent on pre-watchdog wires
    return SweepResult(
        specs=tuple(spec_from_dict(s) for s in payload["specs"]),
        histories=np.asarray(payload["histories"], np.float32),
        effective_passes=np.asarray(payload["effective_passes"], np.float64),
        final_w=np.asarray(payload["final_w"], np.float32),
        total_updates=np.asarray(payload["total_updates"], np.int64),
        epochs_per_row=np.asarray(payload["epochs_per_row"], np.int64),
        param_shapes=tuple((path, tuple(shape), dtype) for path, shape, dtype
                           in payload.get("param_shapes", ())),
        telemetry=(None if telemetry is None
                   else _obs_telemetry.from_dict(telemetry)),
        diverged_rows=(None if diverged is None
                       else np.asarray(diverged, np.int64)))


# ---------------------------------------------------------------- handler
class _Handler(BaseHTTPRequestHandler):
    server_version = "repro-sweep-server/1.0"
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):        # quiet: metrics replace the log
        pass

    # `self.server` is the SweepHTTPServer below
    @property
    def svc(self) -> SweepService:
        return self.server.service

    def _json(self, code: int, payload: dict,
              headers: Optional[dict] = None) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for name, value in (headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def _text(self, code: int, body: str, content_type: str) -> None:
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _error(self, code: int, message: str, **extra) -> None:
        self._json(code, {"error": message, **extra})

    def _read_body(self) -> dict:
        length = int(self.headers.get("Content-Length") or 0)
        if length == 0:
            return {}
        payload = json.loads(self.rfile.read(length).decode())
        if not isinstance(payload, dict):
            raise ValueError("request body must be a JSON object")
        return payload

    # ------------------------------------------------------------- routes
    def do_GET(self) -> None:          # noqa: N802 (stdlib handler API)
        url = urlparse(self.path)
        m = _RESULT_PATH.match(url.path)
        mj = _JOB_PATH.match(url.path)
        try:
            if url.path == "/healthz":
                self._get_healthz()
            elif url.path == "/watch":
                self._get_watch(url.query)
            elif url.path == "/ledger":
                self._json(200, {"enabled": _ledger.ledger_enabled(),
                                 "groups": _ledger.ledger().snapshot()})
            elif url.path == "/stats":
                self._json(200, _metrics.snapshot(
                    self.svc, self.server.daemon, self.server.fairness))
            elif url.path == "/metrics":
                body = _prometheus.render(
                    _metrics.snapshot(self.svc, self.server.daemon,
                                      self.server.fairness),
                    histograms=self.svc.histograms.as_dict())
                self._text(200, body,
                           "text/plain; version=0.0.4; charset=utf-8")
            elif url.path == "/trace":
                self._get_trace(url.query)
            elif m:
                self._get_result(int(m.group(1)), url.query)
            elif mj:
                self._get_job(int(mj.group(1)), url.query)
            else:
                self._error(404, f"no route {url.path!r}")
        except BrokenPipeError:          # client went away mid-write
            pass
        except Exception as e:           # any other failure must still be
            self._safe_error(e)          # an HTTP answer, not a dropped
        #                                  socket the client can't map

    def _get_healthz(self) -> None:
        daemon = self.server.daemon
        payload = {
            "status": "ok",
            "uptime_s": time.monotonic() - self.server.started_at,
            "pending_requests": self.svc.pending(),
            "daemon_running": daemon is not None and daemon.running(),
        }
        if daemon is None:           # eager-flush deployment: no liveness
            return self._json(200, payload)   # to report beyond "we answered"
        age = daemon.heartbeat_age_s()
        payload["heartbeat_age_s"] = age
        payload["heartbeat_stall_s"] = daemon.policy.heartbeat_stall_s
        if (not daemon.running() or age is None
                or age > daemon.policy.heartbeat_stall_s):
            payload["status"] = "stalled"
            return self._json(503, payload)
        self._json(200, payload)

    def _get_trace(self, query: str) -> None:
        tr = _tracer()
        ids = parse_qs(query).get("id")
        if ids:
            dump = tr.get(ids[0])
            if dump is None:
                return self._error(
                    404, f"unknown trace id {ids[0]!r} (never minted, or "
                    "evicted from the ring buffer)", status="unknown")
            return self._json(200, dump)
        self._json(200, {"enabled": tr.enabled, "recent": tr.recent(),
                         "last_error": tr.last_error()})

    def _get_watch(self, query: str) -> None:
        q = parse_qs(query)
        try:
            cursor = int(q.get("cursor", ["0"])[0])
            timeout = float(q.get("timeout_s", ["10"])[0])
        except ValueError:
            return self._error(400, "cursor must be an int and timeout_s "
                               "a number")
        timeout = max(0.0, min(timeout, MAX_WAIT_S))
        ids = q.get("id")
        watch_id = ids[0] if ids else None    # None = firehose
        bus = _progress.progress_bus()
        events, nxt = bus.watch(cursor=cursor, watch_id=watch_id,
                                timeout=timeout)
        self._json(200, {"events": [e.to_dict() for e in events],
                         "cursor": nxt,
                         "enabled": _progress.progress_enabled()})

    def _get_job(self, job_id: int, query: str) -> None:
        daemon = self.server.daemon
        if daemon is None:
            return self._error(400, "no flush daemon: jobs need a "
                               "policy-driven server (policy=...)")
        try:
            timeout = float(parse_qs(query).get("timeout_s", ["10"])[0])
        except ValueError:
            return self._error(400, "timeout_s must be a number")
        timeout = max(0.0, min(timeout, MAX_WAIT_S))
        try:
            handle = daemon.job(job_id)
        except KeyError:
            return self._error(404, f"unknown job id {job_id} (never "
                               "submitted, or aged out of the handle "
                               "registry)", status="unknown")
        try:
            res = handle.result(timeout=timeout)
        except TimeoutError:
            return self._error(
                504, f"job {job_id} still running after {timeout}s "
                f"({handle.slices} slices so far; stream "
                f"/watch?id=job-{job_id} meanwhile)", status="pending")
        payload = result_to_dict(job_id, res)
        payload["job_id"] = job_id
        self._json(200, payload)

    def _safe_error(self, e: Exception) -> None:
        try:
            self._error(500, f"{type(e).__name__}: {e}")
        except OSError:                  # response already partly written
            pass

    def _get_result(self, rid: int, query: str) -> None:
        try:
            timeout = float(parse_qs(query).get("timeout_s", ["10"])[0])
        except ValueError:
            return self._error(400, "timeout_s must be a number")
        timeout = max(0.0, min(timeout, MAX_WAIT_S))
        try:
            res = self.svc.wait_result(rid, timeout=timeout)
        except ResultEvictedError as e:
            return self._error(410, str(e), status="evicted")
        except TimeoutError:
            return self._error(504, f"request {rid} still pending after "
                               f"{timeout}s (the flush daemon will run it;"
                               " poll again)", status="pending")
        except KeyError:
            return self._error(404, f"unknown request id {rid}",
                               status="unknown")
        tid = self.svc.trace_id(rid)
        self._json(200, result_to_dict(rid, res),
                   {"X-Trace-Id": tid} if tid else None)

    def do_POST(self) -> None:         # noqa: N802 (stdlib handler API)
        url = urlparse(self.path)
        try:
            if url.path == "/submit":
                self._post_submit()
            elif url.path == "/job":
                self._post_job()
            elif url.path == "/flush":
                if self.server.daemon is not None:
                    done = self.server.daemon.flush_now()
                else:
                    # no daemon: still honour a configured fair-share
                    # policy rather than draining in arrival order
                    fair = self.server.fairness
                    done = self.svc.flush(
                        fair.select if fair is not None else None)
                self._json(200, {"completed": done})
            else:
                self._error(404, f"no route {url.path!r}")
        except BrokenPipeError:
            pass
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            self._error(400, str(e))
        except Exception as e:           # e.g. a dispatch error from /flush
            self._safe_error(e)          # (requests re-queued service-side)

    def _post_submit(self) -> None:
        payload = self._read_body()
        specs_raw = payload.get("specs")
        if not isinstance(specs_raw, list) or not specs_raw:
            raise ValueError('"specs" must be a non-empty list of spec '
                             "objects")
        specs = [spec_from_dict(s) for s in specs_raw]
        epochs = payload.get("epochs")
        if epochs is not None:
            epochs = int(epochs)
        rid = self.svc.submit(
            specs, epochs, tenant=str(payload.get("tenant", "default")),
            priority=int(payload.get("priority", 0)))
        tid = self.svc.trace_id(rid)
        self._json(200, {"request_id": rid, "trace_id": tid},
                   {"X-Trace-Id": tid} if tid else None)

    def _post_job(self) -> None:
        if self.server.daemon is None:
            return self._error(400, "no flush daemon: jobs need a "
                               "policy-driven server (policy=...)")
        payload = self._read_body()
        specs_raw = payload.get("specs")
        if not isinstance(specs_raw, list) or not specs_raw:
            raise ValueError('"specs" must be a non-empty list of spec '
                             "objects")
        specs = [spec_from_dict(s) for s in specs_raw]
        epochs = payload.get("epochs")
        if epochs is not None:
            epochs = int(epochs)
        handle = self.server.daemon.submit_job(
            specs, epochs, tenant=str(payload.get("tenant", "default")))
        # watch_id matches the progress channel run_job publishes on for
        # daemon-sliced jobs (daemon passes progress_id=f"job-{id}")
        self._json(200, {"job_id": handle.job_id,
                         "watch_id": f"job-{handle.job_id}"})


# ----------------------------------------------------------------- server
class SweepHTTPServer(ThreadingHTTPServer):
    daemon_threads = True            # handler threads die with the process
    # a handler thread blocked in wait_result holds no lock that accept()
    # needs, so threading + blocking waits coexist

    def __init__(self, address: Tuple[str, int], service: SweepService,
                 daemon: Optional[ServeDaemon],
                 fairness: Optional[FairShare]):
        super().__init__(address, _Handler)
        self.service = service
        self.daemon = daemon
        self.fairness = fairness
        self.started_at = time.monotonic()


class SweepServer:
    """Bundle of service + flush daemon + HTTP listener with one lifecycle.

        server = SweepServer(svc, policy=FlushPolicy(max_delay_ms=25))
        server.start()                       # daemon thread + HTTP thread
        ... SweepClient(server.url) ...
        server.stop()                        # drains the queue first

    ``port=0`` binds an ephemeral port (tests); ``daemon=None`` with
    ``policy=None`` serves without a background flusher (clients must
    POST /flush — the eager baseline the latency benchmark compares).
    """

    def __init__(self, service: SweepService, *,
                 policy=None, fairness: Optional[FairShare] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.service = service
        self.fairness = fairness
        self.daemon = (ServeDaemon(service, policy, fairness=fairness)
                       if policy is not None else None)
        self._http = SweepHTTPServer((host, port), service, self.daemon,
                                     fairness)
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self._http.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "SweepServer":
        if self._thread is not None:
            raise RuntimeError("server already started")
        if self.daemon is not None:
            self.daemon.start()
        self._thread = threading.Thread(target=self._http.serve_forever,
                                        daemon=True,
                                        name="sweep-http-server")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._http.shutdown()        # stop accepting, then drain the daemon
        self._thread.join(30.0)
        self._thread = None
        self._http.server_close()
        if self.daemon is not None:
            self.daemon.stop(drain=True)

    def __enter__(self) -> "SweepServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
