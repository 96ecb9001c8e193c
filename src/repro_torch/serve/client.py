"""Small stdlib client for the topology HTTP front end (``serve/http.py``).

Mirrors the server's endpoint surface one method per endpoint, speaking the
same JSON shapes; non-2xx responses raise ``TopologyHTTPError`` carrying
the structured error payload (and the ``Retry-After`` hint on 503s), so
callers can distinguish retry-later from wrong-request without parsing
message strings.

Remote discovery (the write path) adds three verbs plus a poller:
``submit_discovery`` / ``discovery`` / ``cancel_discovery`` / ``wait``.
When the server requires auth, pass ``auth_token=`` and every request
carries ``Authorization: Bearer <token>``.

Client-side retry: ``max_retries > 0`` re-issues a request that failed
with **503** (quarantined entry, full job queue, overload) or a transport-
level ``URLError``, sleeping ``Retry-After`` seconds when the server said
so and otherwise ``min(backoff_cap_s, backoff_base_s * 2**attempt)`` —
bounded, capped, and off by default so the error-mapping tests (and any
caller that wants failures raw) see the first answer.  ``wait`` honors the
``Retry-After`` header unfinished job polls carry instead of hammering a
fixed interval.
"""
from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from urllib.parse import quote, urlencode

__all__ = ["TopologyHTTPError", "TopologyClient"]

TERMINAL_JOB_STATES = ("done", "failed", "cancelled")


class TopologyHTTPError(Exception):
    """A non-2xx response from the topology server."""

    def __init__(self, status: int, payload: dict,
                 retry_after_s: float | None = None):
        super().__init__(f"HTTP {status}: {payload.get('error', payload)}")
        self.status = status
        self.payload = payload
        self.retry_after_s = retry_after_s


class TopologyClient:
    """Client for one topology server, e.g. ``TopologyClient(server.url)``.

    ``max_retries`` bounds the 503/transport retry loop (0 = no retries);
    ``sleep`` is injectable so tests can assert the exact backoff schedule.
    """

    def __init__(self, base_url: str, timeout_s: float = 10.0, *,
                 auth_token: str | None = None, max_retries: int = 0,
                 backoff_base_s: float = 0.25, backoff_cap_s: float = 10.0,
                 sleep=time.sleep):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s
        self.auth_token = auth_token
        self.max_retries = int(max_retries)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self._sleep = sleep

    # ------------------------------------------------------------ plumbing
    def _request_once(self, path: str, params: dict | None = None,
                      body: dict | None = None,
                      method: str | None = None) -> tuple[dict, dict]:
        """One HTTP round trip -> (parsed payload, response headers)."""
        url = f"{self.base_url}{path}"
        if params:
            url += "?" + urlencode({k: v for k, v in params.items()
                                    if v is not None})
        data = None
        headers = {}
        if body is not None:
            data = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
        if self.auth_token is not None:
            headers["Authorization"] = f"Bearer {self.auth_token}"
        req = urllib.request.Request(url, data=data, headers=headers,
                                     method=method)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                return json.loads(resp.read()), dict(resp.headers)
        except urllib.error.HTTPError as e:
            try:
                payload = json.loads(e.read())
            except (json.JSONDecodeError, UnicodeDecodeError):
                payload = {"error": str(e)}
            retry_after = e.headers.get("Retry-After")
            raise TopologyHTTPError(
                e.code, payload,
                float(retry_after) if retry_after else None) from None

    def _request_full(self, path: str, params: dict | None = None,
                      body: dict | None = None,
                      method: str | None = None) -> tuple[dict, dict]:
        """``_request_once`` wrapped in the bounded 503/transport retry
        loop.  The sleep before attempt ``i`` is the server's
        ``Retry-After`` when present, else capped exponential backoff."""
        for attempt in range(self.max_retries + 1):
            try:
                return self._request_once(path, params, body, method)
            except TopologyHTTPError as e:
                if e.status != 503 or attempt >= self.max_retries:
                    raise
                delay = e.retry_after_s
            except urllib.error.URLError:
                if attempt >= self.max_retries:
                    raise
                delay = None
            self._sleep(min(self.backoff_cap_s,
                            delay if delay is not None
                            else self.backoff_base_s * (2 ** attempt)))
        raise AssertionError("unreachable")          # loop returns or raises

    def _request(self, path: str, params: dict | None = None,
                 body: dict | None = None, method: str | None = None) -> dict:
        return self._request_full(path, params, body, method)[0]

    @staticmethod
    def _k(key: str) -> str:
        return quote(key, safe="")

    # ----------------------------------------------------------- endpoints
    def healthz(self) -> dict:
        """``GET /healthz`` — liveness + store size + job-queue depth."""
        return self._request("/healthz")

    def metrics(self) -> dict:
        """``GET /metrics`` — per-endpoint counters, service stats, and
        the job engine's counter/histogram snapshot."""
        return self._request("/metrics")

    def topologies(self) -> list[dict]:
        """``GET /topologies`` — every stored ``{key, meta}`` entry."""
        return self._request("/topologies")["topologies"]

    def topology(self, key: str) -> dict:
        """``GET /topologies/<key>`` — one full topology document."""
        return self._request(f"/topologies/{self._k(key)}")

    def query(self, key: str, path: str) -> dict:
        """``GET /topologies/<key>/query?path=...`` — one dotted-path
        attribute lookup (e.g. ``L1.size``)."""
        return self._request(f"/topologies/{self._k(key)}/query",
                             params={"path": path})

    def query_batch(self, pairs) -> list[dict]:
        """``POST /query_batch`` — many ``(key, path)`` lookups in one
        round trip; results align with the request order."""
        body = {"requests": [[k, p] for k, p in pairs]}
        return self._request("/query_batch", body=body)["results"]

    def attributes(self, key: str, *, provenance: str | None = None,
                   min_confidence: float | None = None) -> list[dict]:
        """``GET /topologies/<key>/attributes`` with optional provenance /
        confidence filters."""
        return self._request(
            f"/topologies/{self._k(key)}/attributes",
            params={"provenance": provenance,
                    "min_confidence": min_confidence})["attributes"]

    def adjacency(self, key: str) -> dict:
        """``GET /adjacency/<key>`` — the interconnect adjacency map."""
        return self._request(f"/adjacency/{self._k(key)}")["adjacency"]

    def diff(self, key_a: str, key_b: str, rel_tol: float = 0.0) -> dict:
        """``GET /diff?a=...&b=...`` — attribute-level topology diff."""
        return self._request("/diff", params={"a": key_a, "b": key_b,
                                              "rel_tol": rel_tol})

    # ---------------------------------------------------- remote discovery
    def submit_discovery(self, params: dict) -> dict:
        """POST a serialized discovery request; returns the job document
        (``deduplicated: true`` when it attached to an in-flight
        equivalent).  Wire format: ``docs/HTTP_API.md``."""
        return self._request("/discoveries", body=params)

    def discoveries(self, state: str | None = None) -> list[dict]:
        """``GET /discoveries`` — all known jobs, optionally filtered to
        one state (``queued``/``running``/``done``/``failed``/
        ``cancelled``)."""
        return self._request("/discoveries",
                             params={"state": state})["jobs"]

    def discovery(self, job_id: str) -> dict:
        """``GET /discoveries/<job_id>`` — one job document (poll target)."""
        return self._request(f"/discoveries/{self._k(job_id)}")

    def cancel_discovery(self, job_id: str) -> dict:
        """``DELETE /discoveries/<job_id>`` — idempotent cancellation:
        immediate for queued jobs, best-effort for running ones."""
        return self._request(f"/discoveries/{self._k(job_id)}",
                             method="DELETE")

    def wait(self, job_id: str, timeout_s: float = 120.0,
             poll_s: float = 0.5) -> dict:
        """Poll ``GET /discoveries/<job_id>`` until the job is terminal.

        Sleeps the server's ``Retry-After`` hint between polls when the
        response carries one, else ``poll_s``.  Raises ``TimeoutError``
        when the deadline passes with the job still live — the job keeps
        running server-side; this only abandons the wait.
        """
        deadline = time.monotonic() + timeout_s
        while True:
            payload, headers = self._request_full(
                f"/discoveries/{self._k(job_id)}")
            if payload["state"] in TERMINAL_JOB_STATES:
                return payload
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"job {job_id} still {payload['state']} after "
                    f"{timeout_s}s")
            retry_after = headers.get("Retry-After")
            self._sleep(min(float(retry_after) if retry_after else poll_s,
                            max(deadline - time.monotonic(), 0.0)))

    def submit_and_wait(self, params: dict, timeout_s: float = 120.0,
                        poll_s: float = 0.5) -> dict:
        """``submit_discovery`` + ``wait`` in one call; returns the
        terminal job document."""
        job = self.submit_discovery(params)
        return self.wait(job["job_id"], timeout_s=timeout_s, poll_s=poll_s)
