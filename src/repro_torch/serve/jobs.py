"""Server-side discovery job engine (the remote *write* path).

The HTTP front end makes stored topologies network-readable; this module
makes discovery itself a network service: a serialized discovery request (backend + device
identity + budget + gc policy) is accepted, enqueued, and executed
server-side by a small worker pool running the unified ``discover(request)``
core write-through to the shared ``TopologyStore`` — so the artifact a job
produces is immediately served by every read endpoint.

Design points (each one a production concern the HTTP front end surfaces):

* **Bounded FIFO queue + worker pool.**  ``JobEngine(store, workers=N,
  max_queue=M)``; a full queue refuses the submission (``QueueFullError``
  -> HTTP 503 with ``Retry-After``) instead of buffering unboundedly.
* **Per-job state machine** ``queued -> running -> done | failed |
  cancelled``.  Transitions are monotonic and lock-protected; every job
  records created/started/finished timestamps, attempt count, and either a
  result summary or a structured error string.
* **Idempotency by content address.**  A job is keyed by the same
  ``request_key(descriptor)`` that keys the ``TopologyStore``, computed
  with the *same descriptor functions* ``discover()`` uses internally.
  Submitting a request while an equivalent job is queued or running
  *attaches* to the in-flight job (same ``job_id``, no second execution);
  submitting after completion creates a new job whose ``discover()`` call
  is a pure store hit — zero runner probes (``result.store_hit``).
* **Capped retry with exponential backoff** on *transient* runner errors
  (``TransientRunnerError`` by default): attempt ``i`` sleeps
  ``min(backoff_cap_s, backoff_base_s * 2**i)`` before re-running.
  Non-transient exceptions fail immediately — a deterministic bug should
  not be retried into the store.
* **Per-job timeout.**  Each attempt runs on a helper thread joined with
  ``timeout_s``; an overrun marks the job failed and abandons the attempt
  thread (Python cannot preempt it).  Abandonment is safe by construction:
  store writes are atomic and content-addressed, so a late write is
  indistinguishable from a successful run of the same request.
* **Cancellation** is immediate for queued jobs and best-effort for
  running ones (checked between retry attempts — a probe sweep in flight
  cannot be preempted).
* **Metrics**: submission/dedup/terminal-state counters, retry and
  timeout totals, queue depth, and a log-bucketed job-latency histogram,
  folded into the HTTP server's ``/metrics``.
* **One card, one timed discovery at a time.**  ``"cuda"`` jobs time
  kernel launches on the card; two of them at once (the pool has several
  workers) would time each other's launches.  Every ``"cuda"`` run holds
  the process-wide ``CARD_LOCK``, so card discoveries queue behind each
  other while sim jobs stay concurrent.  A job's timeout covers its wait
  for the lock.

Backends: ``"sim"`` (the simulated devices), ``"cuda"`` (the
hand-written probe kernels on the card, ``discover_cuda``) and ``"host"``
(this machine's CPU, ``discover_host``).  A ``"host"`` run holds
``CARD_LOCK`` too: a card discovery spends most of its wall building chase
buffers on the host CPU, which would perturb a host measurement running
beside it, and a host run's own bandwidth probes would slow the card
discovery's host side in turn.

The wire format accepted by ``resolve_discovery`` is documented in
``docs/HTTP_API.md`` (``POST /discoveries``).
"""
from __future__ import annotations

import queue
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Callable

__all__ = ["TransientRunnerError", "QueueFullError", "Job", "JobEngine",
           "resolve_discovery", "JOB_STATES", "TERMINAL_STATES",
           "CARD_LOCK"]

JOB_STATES = ("queued", "running", "done", "failed", "cancelled")
TERMINAL_STATES = ("done", "failed", "cancelled")

# Log-spaced job-duration histogram edges (seconds); last bucket is +inf.
JOB_LATENCY_BUCKETS_S = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                         5.0, 10.0, 30.0, 120.0)


# Lives in core.errors so the probe/engine layers can share the retry
# taxonomy without importing from serve; re-exported here for callers.
from ..core.errors import TransientRunnerError  # noqa: E402  (compat)


class QueueFullError(Exception):
    """The engine's bounded job queue refused a submission (HTTP 503)."""


# --------------------------------------------------------------------------
# Wire-format parsing: serialized request -> (descriptor, key, run thunk)
# --------------------------------------------------------------------------
_SIM_ALIASES = {"h100": "sim-h100", "mi210": "sim-mi210", "v5e": "sim-v5e"}

_COMMON_FIELDS = {"backend", "device", "seed", "n_samples", "elements",
                  "budget", "gc_policy", "refresh", "survey"}
_BACKEND_FIELDS = {
    "sim": _COMMON_FIELDS,
    "cuda": _COMMON_FIELDS - {"device", "seed"},
    "host": {"backend", "n_samples", "gc_policy", "refresh", "max_bytes",
             "quick"},
}

# Held around every "cuda" and "host" run: one timed discovery at a time.
CARD_LOCK = threading.Lock()


def _parse_budget(raw):
    """``None`` | ``"default"`` | ``{SweepBudget kwargs}`` -> SweepBudget."""
    from ..core.engine.planner import SweepBudget

    if raw is None:
        return None
    if raw == "default":
        return SweepBudget()
    if not isinstance(raw, dict):
        raise ValueError(f"budget must be null, 'default', or an object of "
                         f"SweepBudget fields, got {raw!r}")
    allowed = {"max_rounds", "max_rows", "target_resolution", "ladder_chunk"}
    bad = set(raw) - allowed
    if bad:
        raise ValueError(f"unknown budget field(s): {sorted(bad)}")
    return SweepBudget(**raw)


def _parse_gc_policy(raw):
    from ..core.engine.store import GcPolicy

    if raw is None:
        return None
    if not isinstance(raw, dict):
        raise ValueError(f"gc_policy must be null or an object, got {raw!r}")
    bad = set(raw) - {"max_entries", "max_age_s"}
    if bad:
        raise ValueError(f"unknown gc_policy field(s): {sorted(bad)}")
    return GcPolicy(**raw)


def _parse_elements(raw):
    if raw is None:
        return None
    if (not isinstance(raw, list) or not raw
            or not all(isinstance(e, str) for e in raw)):
        raise ValueError("elements must be null or a non-empty list of "
                         "space names")
    return list(raw)


def resolve_discovery(params: dict, store, parallel=None):
    """Validate a wire-format discovery request and bind it to the store.

    Returns ``(descriptor, key, run)`` where ``descriptor`` is the
    content-address document (computed by the *same* functions the
    discovery wrappers use, so the job key equals the store key the run
    will persist under), ``key = request_key(descriptor)``, and ``run()``
    executes the discovery write-through to ``store`` and returns
    ``(topology, timings)``.

    A ``"cuda"`` or ``"host"`` thunk holds ``CARD_LOCK`` while it runs.

    ``parallel`` (an ``engine.parallel.ParallelConfig``, normally the
    owning ``JobEngine``'s) threads multiprocess probe execution into the
    run thunk.  It never appears in the descriptor: pooled and inline
    runs are bit-identical, so they must share a request key.  A
    ``"cuda"`` run takes it and stays inline (see ``discover_cuda``).

    Raises ``ValueError`` on any malformed field — the HTTP layer maps
    this to a 400 before anything is enqueued.
    """
    from ..core.discover import (cuda_request_descriptor,
                                 default_sweep_budget,
                                 host_request_descriptor,
                                 sim_request_descriptor)
    from ..core.engine.store import request_key
    from ..core.simulate import SIM_DEVICES

    if not isinstance(params, dict):
        raise ValueError("discovery request must be a JSON object")
    backend = params.get("backend", "sim")
    allowed = _BACKEND_FIELDS.get(backend)
    if allowed is None:
        raise ValueError(f"unknown backend {backend!r} "
                         f"(want one of {sorted(_BACKEND_FIELDS)})")
    bad = set(params) - allowed
    if bad:
        raise ValueError(f"unknown field(s) for backend {backend!r}: "
                         f"{sorted(bad)}")

    n_samples = int(params.get("n_samples", 9))
    if n_samples < 1:
        raise ValueError(f"n_samples must be >= 1, got {n_samples}")
    refresh = bool(params.get("refresh", False))
    survey = bool(params.get("survey", False))
    gc_policy = _parse_gc_policy(params.get("gc_policy"))

    if backend == "sim":
        from ..core.discover import discover_sim

        name = params.get("device")
        make = SIM_DEVICES.get(_SIM_ALIASES.get(name, name))
        if make is None:
            raise ValueError(f"unknown simulated device {name!r} (want one "
                             f"of {sorted(SIM_DEVICES)} or aliases "
                             f"{sorted(_SIM_ALIASES)})")
        device = make(seed=int(params.get("seed", 0)))
        elements = _parse_elements(params.get("elements"))
        budget = _parse_budget(params.get("budget"))
        descriptor = sim_request_descriptor(device, n_samples, elements,
                                            budget, survey=survey)

        run = lambda: discover_sim(  # noqa: E731 — close over parsed args
            device, n_samples, elements, store=store, refresh=refresh,
            budget=budget, gc_policy=gc_policy, survey=survey,
            parallel=parallel)

    elif backend == "cuda":
        from ..core.discover import discover_cuda
        from ..core.probes.cuda_runner import make_cuda_model

        elements = _parse_elements(params.get("elements"))
        budget = (_parse_budget(params["budget"])
                  if "budget" in params and params["budget"] != "default"
                  else default_sweep_budget())
        model = make_cuda_model()
        descriptor = cuda_request_descriptor(model, n_samples, elements,
                                             budget, survey=survey)

        def run():
            with CARD_LOCK:
                return discover_cuda(
                    model, n_samples, elements, store=store,
                    refresh=refresh, budget=budget, gc_policy=gc_policy,
                    survey=survey, parallel=parallel)

    else:                                                   # host
        from ..core.discover import discover_host

        max_bytes = int(params.get("max_bytes", 128 * 1024**2))
        quick = bool(params.get("quick", True))
        descriptor = host_request_descriptor(max_bytes, n_samples, quick)

        def run():
            with CARD_LOCK:
                return discover_host(
                    max_bytes, n_samples, quick, store=store,
                    refresh=refresh, gc_policy=gc_policy, parallel=parallel)

    return descriptor, request_key(descriptor), run


# --------------------------------------------------------------------------
# Jobs
# --------------------------------------------------------------------------
@dataclass
class Job:
    """One submitted discovery: identity, state machine, outcome.

    ``state`` moves ``queued -> running -> done|failed|cancelled`` and never
    backwards; all mutation happens under the owning engine's lock.
    """

    job_id: str
    key: str                       # content-addressed request key (store key)
    params: dict                   # the wire request, as submitted
    backend: str
    timeout_s: float | None
    state: str = "queued"
    created_at: float = field(default_factory=time.time)
    started_at: float | None = None
    finished_at: float | None = None
    attempts: int = 0              # run attempts started (1 = no retry)
    error: str | None = None
    result: dict | None = None
    done_event: threading.Event = field(default_factory=threading.Event,
                                        repr=False)
    cancel_event: threading.Event = field(default_factory=threading.Event,
                                          repr=False)

    @property
    def terminal(self) -> bool:
        """True once the job reached done/failed/cancelled (final)."""
        return self.state in TERMINAL_STATES

    def to_json(self) -> dict:
        """Wire shape served by ``GET /discoveries/<job_id>``."""
        return {
            "job_id": self.job_id, "state": self.state, "key": self.key,
            "backend": self.backend, "params": self.params,
            "created_at": self.created_at, "started_at": self.started_at,
            "finished_at": self.finished_at, "attempts": self.attempts,
            "error": self.error, "result": self.result,
        }


class _JobMetrics:
    """Thread-safe job counters + a log-bucketed run-duration histogram."""

    def __init__(self):
        self._mutex = threading.Lock()
        self.counters = {"submitted": 0, "deduplicated": 0, "rejected": 0,
                         "done": 0, "failed": 0, "cancelled": 0,
                         "retries": 0, "timeouts": 0}
        self.buckets = [0] * (len(JOB_LATENCY_BUCKETS_S) + 1)
        self.duration_sum_s = 0.0

    def bump(self, counter: str, n: int = 1) -> None:
        with self._mutex:
            self.counters[counter] += n

    def observe(self, seconds: float) -> None:
        with self._mutex:
            self.duration_sum_s += seconds
            for i, edge in enumerate(JOB_LATENCY_BUCKETS_S):
                if seconds <= edge:
                    self.buckets[i] += 1
                    break
            else:
                self.buckets[-1] += 1

    def snapshot(self) -> dict:
        with self._mutex:
            return {**self.counters,
                    "duration_sum_s": round(self.duration_sum_s, 6),
                    "duration_bucket_edges_s": list(JOB_LATENCY_BUCKETS_S),
                    "duration_buckets": list(self.buckets)}


class JobEngine:
    """Bounded-queue worker pool running discovery jobs against one store.

    ::

        engine = JobEngine(store, workers=2).start()
        job, created = engine.submit({"backend": "sim", "device": "h100"})
        engine.wait(job.job_id, timeout_s=60)
        engine.stop()

    ``on_attempt`` is an optional ``(job, attempt_index) -> None`` hook
    called on the worker thread immediately before each run attempt; an
    exception it raises is handled exactly as if the runner raised it —
    tests and the ``remote_discovery`` bench use it to inject
    ``TransientRunnerError`` faults deterministically.  ``sleep`` is the
    backoff sleep function (injectable for tests).
    """

    def __init__(self, store, *, workers: int = 2, max_queue: int = 32,
                 default_timeout_s: float | None = 300.0,
                 max_retries: int = 2, backoff_base_s: float = 0.25,
                 backoff_cap_s: float = 10.0,
                 retryable: tuple = (TransientRunnerError,),
                 on_attempt: Callable | None = None,
                 sleep: Callable[[float], None] = time.sleep,
                 max_history: int = 512, parallel=None):
        self.store = store
        # Multiprocess probe execution (engine/parallel.ParallelConfig):
        # threaded into every discovery thunk this engine resolves.  All
        # concurrent jobs share ONE process pool (the config-keyed global
        # pool), so N remote discoveries never spawn N pools.
        self.parallel = parallel
        self.workers = max(1, int(workers))
        self.max_retries = int(max_retries)
        self.default_timeout_s = default_timeout_s
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.retryable = tuple(retryable)
        self.on_attempt = on_attempt
        self.max_history = int(max_history)
        self._sleep = sleep
        self._queue: queue.Queue = queue.Queue(maxsize=int(max_queue))
        self._mutex = threading.Lock()
        self._jobs: dict[str, Job] = {}          # job_id -> job (insertion order)
        self._active: dict[str, Job] = {}        # request key -> live job
        self._runs: dict[str, Callable] = {}     # job_id -> run thunk
        self._threads: list[threading.Thread] = []
        self._stopping = False
        self.metrics = _JobMetrics()

    # --------------------------------------------------------- lifecycle
    def start(self) -> "JobEngine":
        """Spawn the worker pool (idempotent); returns ``self``."""
        if self._threads:
            return self
        self._stopping = False
        for i in range(self.workers):
            t = threading.Thread(target=self._worker, name=f"mt4g-job-{i}",
                                 daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self, *, timeout_s: float = 30.0) -> None:
        """Stop the pool: queued jobs are cancelled, the running job of each
        worker finishes (no mid-probe preemption), workers then exit."""
        self._stopping = True
        with self._mutex:
            for job in list(self._active.values()):
                if job.state == "queued":
                    self._finish(job, "cancelled",
                                 error="engine stopped before the job ran")
        # Drain the now-cancelled queued jobs so the wake sentinels below
        # always fit — a full queue must not swallow a sentinel, or a
        # worker would sit in ``get()`` until the join timeout.  Safe:
        # ``_stopping`` blocks new submissions and everything still queued
        # was just marked terminal (workers skip terminal jobs anyway).
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        for _ in self._threads:
            self._queue.put(None, timeout=timeout_s)         # wake sentinel
        for t in self._threads:
            t.join(timeout=timeout_s)
        self._threads = []

    # -------------------------------------------------------- submission
    def submit(self, params: dict) -> tuple[Job, bool]:
        """Enqueue a discovery request; returns ``(job, created)``.

        ``created=False`` means an equivalent request (same content-
        addressed key) is already queued or running and the caller was
        attached to it.  Raises ``ValueError`` on malformed params and
        ``QueueFullError`` when the bounded queue refuses the job.
        """
        descriptor, key, run = resolve_discovery(params, self.store,
                                                 parallel=self.parallel)
        with self._mutex:
            live = self._active.get(key)
            if live is not None and not live.terminal:
                self.metrics.bump("deduplicated")
                return live, False
            if self._stopping:
                raise QueueFullError("engine is stopping")
            job = Job(job_id=uuid.uuid4().hex[:12], key=key,
                      params=dict(params),
                      backend=params.get("backend", "sim"),
                      timeout_s=self.default_timeout_s)
            try:
                self._queue.put_nowait(job)
            except queue.Full:
                self.metrics.bump("rejected")
                raise QueueFullError(
                    f"job queue full ({self._queue.maxsize} pending)") \
                    from None
            self._jobs[job.job_id] = job
            self._active[key] = job
            self._runs[job.job_id] = run
            self.metrics.bump("submitted")
            self._trim_history()
            return job, True

    def _trim_history(self) -> None:
        # Terminal jobs beyond max_history age out oldest-first so a
        # long-lived server's job table stays bounded (the queue bounds
        # live jobs already).  Caller holds the lock.
        excess = len(self._jobs) - self.max_history
        if excess <= 0:
            return
        for job_id in [jid for jid, j in self._jobs.items()
                       if j.terminal][:excess]:
            del self._jobs[job_id]

    # ------------------------------------------------------------ lookup
    def get(self, job_id: str) -> Job | None:
        """The job with this id, or None if unknown / aged out."""
        with self._mutex:
            return self._jobs.get(job_id)

    def jobs(self) -> list[Job]:
        """All known jobs, oldest first (bounded by ``max_history``)."""
        with self._mutex:
            return list(self._jobs.values())

    def queue_depth(self) -> int:
        """Jobs currently waiting for a worker (approximate, racy)."""
        return self._queue.qsize()

    def wait(self, job_id: str, timeout_s: float = 60.0) -> Job:
        """Block until the job reaches a terminal state (in-process path;
        remote callers poll ``GET /discoveries/<job_id>`` instead)."""
        job = self.get(job_id)
        if job is None:
            raise KeyError(f"unknown job {job_id!r}")
        if not job.done_event.wait(timeout=timeout_s):
            raise TimeoutError(f"job {job_id} still {job.state} after "
                               f"{timeout_s}s")
        return job

    # ------------------------------------------------------ cancellation
    def cancel(self, job_id: str) -> Job:
        """Cancel a job: immediate for queued, best-effort for running
        (takes effect between retry attempts), a no-op once terminal."""
        job = self.get(job_id)
        if job is None:
            raise KeyError(f"unknown job {job_id!r}")
        with self._mutex:
            job.cancel_event.set()
            if job.state == "queued":
                self._finish(job, "cancelled", error="cancelled while queued")
        return job

    # ----------------------------------------------------------- workers
    def _finish(self, job: Job, state: str, *, error: str | None = None,
                result: dict | None = None) -> None:
        """Terminal transition; caller holds the lock (or is the sole
        owner of a just-dequeued job)."""
        if job.terminal:
            return
        job.state = state
        job.error = error
        job.result = result
        job.finished_at = time.time()
        self._runs.pop(job.job_id, None)
        if self._active.get(job.key) is job:
            del self._active[job.key]
        self.metrics.bump(state)
        job.done_event.set()

    def _worker(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:                                  # stop sentinel
                return
            if job.terminal:                                 # cancelled queued
                continue
            with self._mutex:
                if job.terminal:
                    continue
                job.state = "running"
                job.started_at = time.time()
                run = self._runs.get(job.job_id)
            self._run_job(job, run)

    def _run_job(self, job: Job, run: Callable) -> None:
        t_start = time.perf_counter()
        for attempt in range(self.max_retries + 1):
            if job.cancel_event.is_set():
                with self._mutex:
                    self._finish(job, "cancelled",
                                 error="cancelled before attempt "
                                       f"{attempt + 1}")
                return
            job.attempts = attempt + 1
            try:
                if self.on_attempt is not None:
                    self.on_attempt(job, attempt)
                topo, timings = self._attempt_with_timeout(job, run)
            except TimeoutError as e:
                self.metrics.bump("timeouts")
                with self._mutex:
                    self._finish(job, "failed", error=str(e))
                self.metrics.observe(time.perf_counter() - t_start)
                return
            except self.retryable as e:
                if attempt >= self.max_retries:
                    with self._mutex:
                        self._finish(
                            job, "failed",
                            error=f"transient error persisted through "
                                  f"{job.attempts} attempts: "
                                  f"{type(e).__name__}: {e}")
                    self.metrics.observe(time.perf_counter() - t_start)
                    return
                self.metrics.bump("retries")
                self._sleep(min(self.backoff_cap_s,
                                self.backoff_base_s * (2 ** attempt)))
                continue
            except Exception as e:          # noqa: BLE001 — deterministic
                with self._mutex:
                    self._finish(job, "failed",
                                 error=f"{type(e).__name__}: {e}")
                self.metrics.observe(time.perf_counter() - t_start)
                return
            else:
                # A store hit reconstructs only per-family timings —
                # ``meta`` stays empty — which is exactly the "zero runner
                # probes" signal the idempotency contract exposes.
                result = {
                    "model": topo.model, "vendor": topo.vendor,
                    "backend": topo.backend,
                    "store_hit": "cache" not in timings.meta,
                    "probe_rows": timings.probe_rows,
                    "families": {k: round(v, 6)
                                 for k, v in timings.per_family.items()},
                }
                with self._mutex:
                    self._finish(job, "done", result=result)
                self.metrics.observe(time.perf_counter() - t_start)
                return

    def _attempt_with_timeout(self, job: Job, run: Callable):
        """One attempt, bounded by the job timeout.

        The attempt runs on a daemon helper thread joined with
        ``timeout_s``; an overrun raises ``TimeoutError`` and abandons the
        thread.  The abandoned attempt may still complete and write
        through — harmless, because store writes are atomic and the key is
        content-addressed (a late write equals a successful run of the
        same request).
        """
        if job.timeout_s is None:
            return run()
        box: dict = {}

        def target():
            try:
                box["value"] = run()
            except BaseException as e:      # noqa: BLE001 — re-raised below
                box["error"] = e

        t = threading.Thread(target=target, daemon=True,
                             name=f"mt4g-job-attempt-{job.job_id}")
        t.start()
        t.join(timeout=job.timeout_s)
        if t.is_alive():
            raise TimeoutError(f"attempt {job.attempts} exceeded the "
                               f"{job.timeout_s}s job timeout")
        if "error" in box:
            raise box["error"]
        return box["value"]

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Counter snapshot + live queue/worker state (for ``/metrics``)."""
        with self._mutex:
            states: dict[str, int] = {}
            for j in self._jobs.values():
                states[j.state] = states.get(j.state, 0) + 1
        return {**self.metrics.snapshot(), "queue_depth": self.queue_depth(),
                "workers": self.workers, "states": states}
