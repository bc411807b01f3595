"""Python client for the sweep server's HTTP API (stdlib urllib only); the
port of `repro.server.client`. It speaks the shared wire format, so it
talks to the JAX package's server as well as to the port's.

    client = SweepClient("http://127.0.0.1:8742")
    rid = client.submit(specs, tenant="team-a")     # returns immediately
    res = client.result(rid, timeout=60)            # long-polls the server
    # res is a SweepResult, equal to the service's own result

``result`` long-polls: each round the SERVER blocks up to its per-request
wait bound and answers 504/"pending" if the flush daemon hasn't run the
request yet; the client re-polls until its own ``timeout``. Submitting
never triggers execution — batching is entirely the server's policy —
except through :meth:`flush`, the explicit escape hatch.

``submit`` returns a `SubmitTicket` — an ``int`` (so existing callers
keep working) that also carries the server-minted ``.trace_id`` echoed in
the response's ``X-Trace-Id`` header. Pass it (or an explicit
``trace_id=``) back into :meth:`result`/:meth:`watch` and the client
sends ``X-Trace-Id`` on the outgoing request, correlating client-side
polls with the server's flight recorder.

Live progress: :meth:`submit_job` starts a time-sliced background job and
:meth:`watch` long-polls ``GET /watch`` for its per-slice loss events
while :meth:`job_result` waits for the final `SweepResult`.

Error mapping mirrors the service's in-process exceptions: 404 raises
KeyError, 410 raises `repro_torch.service.ResultEvictedError`, 400 raises
ValueError, anything else `ServerError`.
"""
from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Sequence, Tuple
from urllib.parse import quote

from repro_torch.core.sweep import SweepResult, SweepSpec
from repro_torch.server.http import result_from_dict, spec_to_dict
from repro_torch.service.api import ResultEvictedError


class ServerError(RuntimeError):
    """A non-2xx response that doesn't map to a standard exception."""

    def __init__(self, status: int, payload: dict):
        super().__init__(f"HTTP {status}: {payload.get('error', payload)}")
        self.status = status
        self.payload = payload


class SubmitTicket(int):
    """The request id from ``POST /submit``, plus the echoed trace id.

    Subclassing ``int`` keeps every pre-existing call site working
    (``client.result(rid)``, dict keys, formatting) while new code reads
    ``rid.trace_id`` to correlate with ``GET /trace?id=...``."""

    trace_id: Optional[str]

    def __new__(cls, request_id: int,
                trace_id: Optional[str] = None) -> "SubmitTicket":
        obj = super().__new__(cls, request_id)
        obj.trace_id = trace_id
        return obj


class SweepClient:
    def __init__(self, base_url: str, *, timeout: float = 30.0,
                 poll_s: float = 10.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout           # per-HTTP-call socket timeout
        self.poll_s = poll_s             # server-side wait per result poll

    # ------------------------------------------------------------ plumbing
    def _call_full(self, method: str, path: str,
                   body: Optional[dict] = None,
                   headers: Optional[Dict[str, str]] = None
                   ) -> Tuple[dict, Dict[str, str]]:
        """One HTTP round trip -> (json payload, response headers)."""
        data = None if body is None else json.dumps(body).encode()
        send = {"Content-Type": "application/json"}
        if headers:
            send.update(headers)
        req = urllib.request.Request(
            self.base_url + path, data=data, method=method, headers=send)
        try:
            # socket timeout must outlast the server-side result wait
            with urllib.request.urlopen(
                    req, timeout=self.timeout + self.poll_s) as resp:
                return json.loads(resp.read().decode()), dict(resp.headers)
        except urllib.error.HTTPError as e:
            try:
                payload = json.loads(e.read().decode())
            except (ValueError, OSError):
                payload = {"error": str(e)}
            raise self._map_error(e.code, payload) from None

    def _call(self, method: str, path: str,
              body: Optional[dict] = None,
              headers: Optional[Dict[str, str]] = None) -> dict:
        return self._call_full(method, path, body, headers)[0]

    @staticmethod
    def _trace_headers(trace_id: Optional[str]) -> Optional[Dict[str, str]]:
        return {"X-Trace-Id": trace_id} if trace_id else None

    @staticmethod
    def _map_error(status: int, payload: dict) -> Exception:
        message = payload.get("error", f"HTTP {status}")
        if status == 404 and payload.get("status") == "unknown":
            return KeyError(message)
        if status == 410:
            return ResultEvictedError(message)
        if status == 504:
            return TimeoutError(message)
        if status == 400:
            return ValueError(message)
        return ServerError(status, payload)

    # ------------------------------------------------------------- the API
    def healthz(self) -> dict:
        return self._call("GET", "/healthz")

    def stats(self) -> dict:
        return self._call("GET", "/stats")

    def metrics(self) -> str:
        """The raw Prometheus text exposition from ``GET /metrics``."""
        req = urllib.request.Request(self.base_url + "/metrics")
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return resp.read().decode()

    def trace(self, trace_id: Optional[str] = None) -> dict:
        """Flight-recorder state: recent traces + last-error dump, or one
        request's full span tree when ``trace_id`` is given (KeyError once
        it has been evicted from the ring buffer)."""
        path = "/trace" if trace_id is None else f"/trace?id={trace_id}"
        return self._call("GET", path)

    def submit(self, specs: Sequence[SweepSpec],
               epochs: Optional[int] = None, *, tenant: str = "default",
               priority: int = 0) -> SubmitTicket:
        body = {"specs": [spec_to_dict(s) for s in specs],
                "tenant": tenant, "priority": priority}
        if epochs is not None:
            body["epochs"] = epochs
        payload, hdrs = self._call_full("POST", "/submit", body)
        return SubmitTicket(
            int(payload["request_id"]),
            payload.get("trace_id") or hdrs.get("X-Trace-Id"))

    def flush(self) -> List[int]:
        """Force a flush now (the eager path; normally the server's flush
        daemon decides when to dispatch)."""
        return [int(i) for i in self._call("POST", "/flush")["completed"]]

    def result(self, request_id: int,
               timeout: Optional[float] = 60.0, *,
               trace_id: Optional[str] = None) -> SweepResult:
        """Long-poll until the request's result is served (TimeoutError
        after ``timeout`` seconds; None polls forever). ``trace_id``
        (defaulting to a `SubmitTicket`'s own) is sent as ``X-Trace-Id``
        so the poll correlates with the server-side trace."""
        if trace_id is None:
            trace_id = getattr(request_id, "trace_id", None)
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            remaining = (self.poll_s if deadline is None
                         else deadline - time.monotonic())
            if remaining <= 0:
                raise TimeoutError(
                    f"request {request_id} not served within {timeout}s")
            try:
                payload = self._call(
                    "GET", f"/result/{request_id}"
                    f"?timeout_s={min(self.poll_s, remaining):.3f}",
                    headers=self._trace_headers(trace_id))
            except TimeoutError:
                continue                 # server said "pending": poll again
            return result_from_dict(payload)

    # ------------------------------------------------------- live progress
    def watch(self, watch_id: Optional[str] = None, *, cursor: int = 0,
              timeout_s: Optional[float] = None,
              trace_id: Optional[str] = None) -> dict:
        """One long-poll round on the live-progress bus. Returns
        ``{"events": [...], "cursor": N, "enabled": bool}``; feed the
        returned ``cursor`` into the next call to resume past events
        already seen. ``watch_id=None`` streams the firehose (every
        channel); jobs publish on ``"job-<id>"`` and flushed requests on
        ``"req-<id>"``. Empty ``events`` just means nothing new within
        ``timeout_s`` — keep polling while the job runs."""
        wait = self.poll_s if timeout_s is None else timeout_s
        params = [f"cursor={int(cursor)}", f"timeout_s={float(wait):.3f}"]
        if watch_id is not None:
            params.insert(0, f"id={quote(watch_id)}")
        return self._call("GET", "/watch?" + "&".join(params),
                          headers=self._trace_headers(trace_id))

    def submit_job(self, specs: Sequence[SweepSpec],
                   epochs: Optional[int] = None, *,
                   tenant: str = "default") -> dict:
        """Start a time-sliced background job on the server's flush
        daemon. Returns ``{"job_id": N, "watch_id": "job-N"}`` — stream
        :meth:`watch` with that id while it runs, then
        :meth:`job_result`."""
        body = {"specs": [spec_to_dict(s) for s in specs],
                "tenant": tenant}
        if epochs is not None:
            body["epochs"] = epochs
        return self._call("POST", "/job", body)

    def job_result(self, job_id: int,
                   timeout: Optional[float] = 60.0) -> SweepResult:
        """Long-poll ``GET /job/<id>`` until the sliced job finishes."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            remaining = (self.poll_s if deadline is None
                         else deadline - time.monotonic())
            if remaining <= 0:
                raise TimeoutError(
                    f"job {job_id} not finished within {timeout}s")
            try:
                payload = self._call(
                    "GET", f"/job/{int(job_id)}"
                    f"?timeout_s={min(self.poll_s, remaining):.3f}")
            except TimeoutError:
                continue                 # still slicing: poll again
            return result_from_dict(payload)

    def ledger(self) -> dict:
        """The per-group performance ledger (``GET /ledger``):
        ``{"enabled": bool, "groups": {label: entry-dict}}``."""
        return self._call("GET", "/ledger")

    def sweep(self, specs: Sequence[SweepSpec],
              epochs: Optional[int] = None, *, tenant: str = "default",
              priority: int = 0,
              timeout: Optional[float] = 60.0) -> SweepResult:
        """submit + result in one call (still batched by server policy)."""
        return self.result(
            self.submit(specs, epochs, tenant=tenant, priority=priority),
            timeout=timeout)
