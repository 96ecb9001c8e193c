"""HTTP front end over ``TopologyService`` (the topology serving tier).

Dependency-free: stdlib ``ThreadingHTTPServer`` threads + the in-process
query service, so discovered topologies become network artifacts — the
paper's §V consumption pattern (performance modeling, bottleneck analysis,
partitioning) can run in a different process, language, or machine from the
discovery runs that produced the store.

Endpoints (all JSON; the full reference with request/response shapes lives
in ``docs/HTTP_API.md``)::

    GET    /healthz                                liveness + entry count
    GET    /metrics                                lru + endpoint + job stats
    GET    /topologies                             [{key, meta}, ...]
    GET    /topologies/<key>                       full topology document
    GET    /topologies/<key>/query?path=L1.size    one dotted-path lookup
    GET    /topologies/<key>/attributes            provenance/min_confidence
    GET    /adjacency/<key>                        sharing/link adjacency
    GET    /diff?a=<key>&b=<key>&rel_tol=0.05      attribute-level diff
    POST   /query_batch   {"requests": [[key, path], ...]}
    POST   /discoveries   serialized discovery request -> 202 + job
    GET    /discoveries                            all known jobs
    GET    /discoveries/<job_id>                   job status (poll target)
    DELETE /discoveries/<job_id>                   cancel a job

The ``/discoveries`` endpoints are the remote **write** path: submissions
are validated, content-address-deduplicated, and executed server-side by
the ``serve.jobs.JobEngine`` worker pool, write-through to the same store
every read endpoint serves (see the module docstring of ``serve/jobs.py``).

Traffic hardening:

* request bodies above ``max_body_bytes`` are refused with **413** before
  being read into memory;
* each connection carries a socket **timeout** (a stuck client cannot pin a
  handler thread forever);
* errors map to structured JSON statuses — missing/invalid parameters
  **400**, unknown endpoint, topology key, or job id **404**, wrong method
  **405**, malformed JSON **400**, quarantined-on-disk entry **503** with a
  ``Retry-After`` hint (re-discovery repopulates the key), full job queue
  **503** with ``Retry-After``;
* **bearer-token auth on mutating endpoints** when the server is started
  with ``auth_token=...``: ``POST /discoveries`` and ``DELETE
  /discoveries/<job_id>`` require ``Authorization: Bearer <token>`` and
  answer **401** (with ``WWW-Authenticate``) on a missing or wrong token;
  read endpoints stay open — discovered topologies are the product, the
  write path is the privilege;
* ``stop()`` shuts down gracefully: the accept loop stops first, then
  in-flight handler threads are joined (drained), never killed mid-write;
  the job engine stops with it (queued jobs cancel, running jobs finish).

Per-item misses inside ``/query_batch`` and unresolvable attribute paths on
a *known* topology are data (``found: false``), not transport errors — the
batch contract mirrors ``TopologyService.query_batch``.
"""
from __future__ import annotations

import hmac
import json
import threading
import time
from dataclasses import asdict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from .jobs import JobEngine, QueueFullError
from .topology_service import TopologyService

__all__ = ["HttpError", "ServerMetrics", "TopologyHTTPServer",
           "MAX_BODY_BYTES", "REQUEST_TIMEOUT_S"]

MAX_BODY_BYTES = 1 << 20          # 1 MiB: a query_batch of ~10k pairs
REQUEST_TIMEOUT_S = 30.0
RETRY_AFTER_S = 5
JOB_POLL_S = 1                    # Retry-After hint on unfinished job polls

# Log-spaced latency histogram edges (us); the last bucket is +inf.
LATENCY_BUCKETS_US = (100, 250, 500, 1000, 2500, 5000, 10000, 25000,
                      50000, 100000, 250000, 1000000)


class HttpError(Exception):
    """A structured HTTP error response."""

    def __init__(self, status: int, message: str, *,
                 retry_after_s: int | None = None,
                 headers: dict | None = None):
        super().__init__(message)
        self.status = status
        self.message = message
        self.retry_after_s = retry_after_s
        self.headers = headers or {}


class ServerMetrics:
    """Thread-safe per-endpoint request counts + latency histograms."""

    def __init__(self):
        self._mutex = threading.Lock()
        self._endpoints: dict[str, dict] = {}
        self._statuses: dict[str, int] = {}
        self.started_at = time.time()

    def record(self, endpoint: str, status: int, elapsed_s: float) -> None:
        """Fold one served request into the counters and histograms."""
        us = elapsed_s * 1e6
        with self._mutex:
            ep = self._endpoints.setdefault(endpoint, {
                "requests": 0, "errors": 0, "latency_sum_us": 0.0,
                "latency_buckets_us": [0] * (len(LATENCY_BUCKETS_US) + 1),
            })
            ep["requests"] += 1
            ep["errors"] += status >= 400
            ep["latency_sum_us"] += us
            for i, edge in enumerate(LATENCY_BUCKETS_US):
                if us <= edge:
                    ep["latency_buckets_us"][i] += 1
                    break
            else:
                ep["latency_buckets_us"][-1] += 1
            bucket = f"{status // 100}xx"
            self._statuses[bucket] = self._statuses.get(bucket, 0) + 1

    def snapshot(self) -> dict:
        """Deep-copied metrics state, served by ``GET /metrics``."""
        with self._mutex:
            return {
                "uptime_s": round(time.time() - self.started_at, 3),
                "latency_bucket_edges_us": list(LATENCY_BUCKETS_US),
                "endpoints": json.loads(json.dumps(self._endpoints)),
                "statuses": dict(self._statuses),
            }


class _Handler(BaseHTTPRequestHandler):
    """Routes one request to the service; all responses are JSON."""

    server_version = "mt4g-topod/1.0"
    protocol_version = "HTTP/1.1"

    # -------------------------------------------------------- plumbing
    def setup(self):                        # per-connection socket timeout
        self.timeout = self.server.request_timeout_s
        super().setup()

    def log_message(self, fmt, *args):      # stay quiet; /metrics observes
        pass

    @property
    def svc(self) -> TopologyService:
        return self.server.service

    def _send_json(self, status: int, payload: dict,
                   retry_after_s: int | None = None,
                   headers: dict | None = None) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if retry_after_s is not None:
            self.send_header("Retry-After", str(retry_after_s))
        for name, value in (headers or {}).items():
            self.send_header(name, str(value))
        self.end_headers()
        self.wfile.write(body)

    # ------------------------------------------------------- dispatch
    def do_GET(self):                                          # noqa: N802
        self._dispatch("GET")

    def do_POST(self):                                         # noqa: N802
        self._dispatch("POST")

    def do_DELETE(self):                                       # noqa: N802
        self._dispatch("DELETE")

    def _dispatch(self, method: str) -> None:
        t0 = time.perf_counter()
        url = urlparse(self.path)
        endpoint, status = url.path, 500
        try:
            hook = self.server.on_request
            if hook is not None:
                hook(method, url.path)
            endpoint, handler, kwargs = self._route(method, url.path)
            out = handler(query=parse_qs(url.query), **kwargs)
            # Handlers return a payload dict, or (payload, status, headers)
            # when they need a non-200 success code / extra headers (the
            # job endpoints: 202 Accepted, Retry-After poll hints).
            payload, extra = out, {}
            status = 200
            if isinstance(out, tuple):
                payload, status, extra = out
            self._send_json(status, payload, headers=extra)
        except HttpError as e:
            status = e.status
            self._send_json(e.status, {"error": e.message,
                                       "status": e.status},
                            retry_after_s=e.retry_after_s,
                            headers=e.headers)
        except (BrokenPipeError, ConnectionResetError):
            status = 499                    # client went away mid-response
        except Exception as e:              # noqa: BLE001 — 500, keep serving
            status = 500
            try:
                self._send_json(500, {"error": f"{type(e).__name__}: {e}",
                                      "status": 500})
            except OSError:
                pass
        finally:
            self.server.metrics.record(endpoint, status,
                                       time.perf_counter() - t0)

    def _route(self, method: str, path: str):
        """(metrics label, handler, kwargs) for a request path."""
        parts = [p for p in path.split("/") if p]

        routes = {
            ("GET", ("healthz",)): ("/healthz", self._healthz, {}),
            ("GET", ("metrics",)): ("/metrics", self._metrics, {}),
            ("GET", ("topologies",)): ("/topologies", self._topologies, {}),
            ("GET", ("diff",)): ("/diff", self._diff, {}),
            ("POST", ("query_batch",)): ("/query_batch", self._query_batch,
                                         {}),
            ("GET", ("discoveries",)): ("/discoveries", self._discoveries,
                                        {}),
            ("POST", ("discoveries",)): ("/discoveries",
                                         self._submit_discovery, {}),
        }
        hit = routes.get((method, tuple(parts)))
        if hit is not None:
            return hit
        if len(parts) == 2 and parts[0] == "discoveries":
            if method == "GET":
                return ("/discoveries/{job_id}", self._discovery,
                        {"job_id": parts[1]})
            if method == "DELETE":
                return ("/discoveries/{job_id}", self._cancel_discovery,
                        {"job_id": parts[1]})
            raise HttpError(405, f"{method} not allowed here")
        if len(parts) == 2 and parts[0] == "topologies":
            if method != "GET":
                raise HttpError(405, f"{method} not allowed here")
            return ("/topologies/{key}", self._topology,
                    {"key": parts[1]})
        if len(parts) == 3 and parts[0] == "topologies" \
                and parts[2] in ("query", "attributes"):
            if method != "GET":
                raise HttpError(405, f"{method} not allowed here")
            handler = self._query if parts[2] == "query" else self._attributes
            return (f"/topologies/{{key}}/{parts[2]}", handler,
                    {"key": parts[1]})
        if len(parts) == 2 and parts[0] == "adjacency":
            if method != "GET":
                raise HttpError(405, f"{method} not allowed here")
            return ("/adjacency/{key}", self._adjacency, {"key": parts[1]})
        if tuple(parts) in {r[1] for r in routes}:      # known path, bad verb
            raise HttpError(405, f"{method} not allowed on {path}")
        raise HttpError(404, f"no such endpoint: {method} {path}")

    # ------------------------------------------------------- helpers
    def _topology_or_error(self, key: str):
        topo = self.svc.get(key)
        if topo is not None:
            return topo
        store = self.svc.store
        if store.is_quarantined(key) or store.has(key):
            raise HttpError(
                503, f"topology {key} is quarantined on disk; "
                     f"re-run discovery for this request to repopulate it",
                retry_after_s=self.server.retry_after_s)
        raise HttpError(404, f"unknown topology key: {key}")

    def _read_body_json(self):
        length = self.headers.get("Content-Length")
        if length is None:
            raise HttpError(411, "Content-Length required")
        try:
            length = int(length)
        except ValueError:
            raise HttpError(400, "malformed Content-Length") from None
        if length > self.server.max_body_bytes:
            # Refused before the body is read into memory; the connection
            # is closed (the unread body would poison keep-alive framing).
            self.close_connection = True
            raise HttpError(
                413, f"request body {length}B exceeds the "
                     f"{self.server.max_body_bytes}B limit")
        raw = self.rfile.read(length)
        try:
            return json.loads(raw)
        except (json.JSONDecodeError, UnicodeDecodeError):
            raise HttpError(400, "malformed JSON request body") from None

    def _authorize(self) -> None:
        """Bearer-token gate for mutating endpoints (no-op when the server
        runs without a token).  Constant-time compare; 401 carries a
        ``WWW-Authenticate`` challenge per RFC 6750."""
        token = self.server.auth_token
        if token is None:
            return
        supplied = self.headers.get("Authorization", "")
        if not supplied.startswith("Bearer ") or not hmac.compare_digest(
                supplied[len("Bearer "):], token):
            raise HttpError(
                401, "missing or invalid bearer token (mutating endpoints "
                     "require 'Authorization: Bearer <token>')",
                headers={"WWW-Authenticate": 'Bearer realm="mt4g-topod"'})

    def _jobs_or_404(self) -> "JobEngine":
        engine = self.server.job_engine
        if engine is None:
            raise HttpError(404, "remote discovery is disabled on this "
                                 "server (started with jobs=False)")
        return engine

    def _job_or_404(self, engine, job_id: str):
        job = engine.get(job_id)
        if job is None:
            raise HttpError(404, f"unknown job id: {job_id}")
        return job

    # ------------------------------------------------------ endpoints
    def _healthz(self, query) -> dict:
        engine = self.server.job_engine
        return {"status": "ok", "entries": len(self.svc.keys()),
                "draining": self.server.draining,
                "jobs_enabled": engine is not None,
                "job_queue_depth": (engine.queue_depth()
                                    if engine is not None else None)}

    def _metrics(self, query) -> dict:
        engine = self.server.job_engine
        return {"service": self.svc.stats(),
                "jobs": engine.stats() if engine is not None else None,
                **self.server.metrics.snapshot()}

    def _topologies(self, query) -> dict:
        return {"topologies": [{"key": k, "meta": meta}
                               for k, meta in self.svc.store.index()]}

    def _topology(self, query, key: str) -> dict:
        topo = self._topology_or_error(key)
        return {"key": key, "topology": topo.to_json()}

    def _query(self, query, key: str) -> dict:
        paths = query.get("path", [])
        if len(paths) != 1 or not paths[0]:
            raise HttpError(400, "exactly one non-empty path=... query "
                                 "parameter is required (e.g. path=L1.size)")
        self._topology_or_error(key)        # 404/503 before a found=False
        return asdict(self.svc.query(key, paths[0]))

    def _query_batch(self, query) -> dict:
        body = self._read_body_json()
        reqs = body.get("requests") if isinstance(body, dict) else body
        if not isinstance(reqs, list):
            raise HttpError(400, 'expected {"requests": [[key, path], ...]}')
        pairs = []
        for item in reqs:
            if (not isinstance(item, (list, tuple)) or len(item) != 2
                    or not all(isinstance(x, str) for x in item)):
                raise HttpError(400, f"bad request pair: {item!r} "
                                     f"(want [key, path])")
            pairs.append((item[0], item[1]))
        return {"results": [asdict(r) for r in self.svc.query_batch(pairs)]}

    def _attributes(self, query, key: str) -> dict:
        provenance = query.get("provenance", [None])[0]
        min_conf = query.get("min_confidence", [None])[0]
        if min_conf is not None:
            try:
                min_conf = float(min_conf)
            except ValueError:
                raise HttpError(400, f"min_confidence must be a number, "
                                     f"got {min_conf!r}") from None
        self._topology_or_error(key)
        attrs = self.svc.attributes(key, provenance=provenance,
                                    min_confidence=min_conf)
        return {"key": key, "attributes": [asdict(a) for a in attrs]}

    def _adjacency(self, query, key: str) -> dict:
        self._topology_or_error(key)
        return {"key": key, "adjacency": self.svc.adjacency(key)}

    # --------------------------------------------- remote discovery (jobs)
    def _submit_discovery(self, query):
        """POST /discoveries — validate, authorize, enqueue (or attach).

        202 on a newly created job, 200 when the submission deduplicated
        onto an in-flight equivalent (same content-addressed key); 400 on
        malformed params, 401 unauthorized, 503 + ``Retry-After`` on a
        full queue.
        """
        self._authorize()
        engine = self._jobs_or_404()
        body = self._read_body_json()
        try:
            job, created = engine.submit(body)
        except ValueError as e:
            raise HttpError(400, f"bad discovery request: {e}") from None
        except QueueFullError as e:
            raise HttpError(503, str(e),
                            retry_after_s=self.server.retry_after_s) \
                from None
        payload = {**job.to_json(), "deduplicated": not created,
                   "status_url": f"/discoveries/{job.job_id}"}
        return (payload, 202 if created else 200, {})

    def _discoveries(self, query) -> dict:
        engine = self._jobs_or_404()
        states = query.get("state", [])
        jobs = engine.jobs()
        if states:
            jobs = [j for j in jobs if j.state in states]
        return {"jobs": [j.to_json() for j in jobs]}

    def _discovery(self, query, job_id: str):
        """GET /discoveries/<job_id> — poll target.  Unfinished jobs carry
        a ``Retry-After`` header so clients can pace their polling."""
        engine = self._jobs_or_404()
        job = self._job_or_404(engine, job_id)
        payload = job.to_json()
        if job.terminal:
            return payload
        return (payload, 200, {"Retry-After": self.server.job_poll_s})

    def _cancel_discovery(self, query, job_id: str):
        """DELETE /discoveries/<job_id> — idempotent cancellation: queued
        jobs cancel immediately, running ones best-effort (between retry
        attempts), terminal ones are left as they finished."""
        self._authorize()
        engine = self._jobs_or_404()
        self._job_or_404(engine, job_id)
        job = engine.cancel(job_id)
        return job.to_json()

    def _diff(self, query) -> dict:
        a = query.get("a", [None])[0]
        b = query.get("b", [None])[0]
        if not a or not b:
            raise HttpError(400, "a=<key> and b=<key> query parameters "
                                 "are required")
        rel_tol = query.get("rel_tol", ["0"])[0]
        try:
            rel_tol = float(rel_tol)
        except ValueError:
            raise HttpError(400, f"rel_tol must be a number, "
                                 f"got {rel_tol!r}") from None
        for key in (a, b):
            self._topology_or_error(key)
        d = self.svc.diff(a, b, rel_tol=rel_tol)
        return {"key_a": d.key_a, "key_b": d.key_b,
                "identical": d.identical, "matching": d.matching,
                "only_in_a": d.only_in_a, "only_in_b": d.only_in_b,
                "changed": [asdict(c) for c in d.changed]}


class _Server(ThreadingHTTPServer):
    # Drain on close: handler threads are joined by server_close(), so an
    # in-flight response always finishes before stop() returns.
    daemon_threads = False
    block_on_close = True
    allow_reuse_address = True


class TopologyHTTPServer:
    """Threaded HTTP server over a ``TopologyService`` (or bare store).

    ::

        server = TopologyHTTPServer(store, port=0)   # 0 = ephemeral
        server.start()
        ...                                          # server.url
        server.stop()                                # graceful drain

    Also a context manager.  ``on_request`` is an optional
    ``(method, path) -> None`` observer hook called before routing —
    used by tests to model slow handlers (an ``HttpError`` it raises is
    served as that structured error, which is how tests and the bench
    inject 503-with-``Retry-After`` faults).

    Remote discovery (the write path) is on by default: a ``JobEngine``
    over the service's store starts/stops with the server.  Pass
    ``jobs=False`` to serve read-only, ``job_engine=`` to share a
    pre-configured engine (fault hooks, custom retry policy), and
    ``auth_token=`` to require ``Authorization: Bearer <token>`` on the
    mutating endpoints.
    """

    def __init__(self, service_or_store, host: str = "127.0.0.1",
                 port: int = 0, *, max_body_bytes: int = MAX_BODY_BYTES,
                 request_timeout_s: float = REQUEST_TIMEOUT_S,
                 retry_after_s: int = RETRY_AFTER_S,
                 hot_set: int = 8, on_request=None,
                 auth_token: str | None = None, jobs: bool = True,
                 job_engine: JobEngine | None = None, job_workers: int = 2,
                 job_queue: int = 32, job_poll_s: int = JOB_POLL_S):
        if isinstance(service_or_store, TopologyService):
            self.service = service_or_store
        else:
            self.service = TopologyService(service_or_store, hot_set=hot_set)
        if job_engine is not None:
            self.job_engine = job_engine
        elif jobs:
            self.job_engine = JobEngine(self.service.store,
                                        workers=job_workers,
                                        max_queue=job_queue)
        else:
            self.job_engine = None
        self.metrics = ServerMetrics()
        self._httpd = _Server((host, port), _Handler)
        self._httpd.service = self.service
        self._httpd.metrics = self.metrics
        self._httpd.max_body_bytes = int(max_body_bytes)
        self._httpd.request_timeout_s = float(request_timeout_s)
        self._httpd.retry_after_s = int(retry_after_s)
        self._httpd.job_poll_s = int(job_poll_s)
        self._httpd.auth_token = auth_token
        self._httpd.job_engine = self.job_engine
        self._httpd.on_request = on_request
        self._httpd.draining = False
        self._thread: threading.Thread | None = None

    # --------------------------------------------------------- lifecycle
    @property
    def address(self) -> tuple[str, int]:
        """``(host, port)`` actually bound (resolves port 0)."""
        return self._httpd.server_address[:2]

    @property
    def url(self) -> str:
        """Base URL, e.g. ``http://127.0.0.1:8423``."""
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "TopologyHTTPServer":
        """Start the job engine (if any) and the serving thread; returns
        ``self`` so ``TopologyHTTPServer(store).start()`` chains."""
        if self._thread is not None:
            raise RuntimeError("server already started")
        if self.job_engine is not None:
            self.job_engine.start()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.05},
            name="mt4g-topod", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop accepting, then drain: in-flight requests run to completion
        before this returns (``drain=False`` abandons handler threads).
        The job engine stops first — queued jobs are cancelled, the
        running job of each worker finishes."""
        if self._thread is None:
            return
        if self.job_engine is not None:
            self.job_engine.stop()
        self._httpd.draining = True
        self._httpd.shutdown()              # stops the accept loop
        self._httpd.block_on_close = drain
        self._httpd.server_close()          # joins handler threads
        self._thread.join(timeout=10.0)
        self._thread = None

    def __enter__(self) -> "TopologyHTTPServer":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False
