"""Multiprocess probe execution: GIL-free sharding of batched capabilities.

The engine's remaining wall time after planning and fusion is single-core:
numpy probe synthesis holds the GIL, so the scheduler's thread pool cannot
scale past ~1 core and stays inline on small boxes (the oldest open
ROADMAP item).  This module moves the *batched capability calls* —
``pchase_batch``, ``cold_chase_batch``, ``pchase_many``,
``cold_chase_many``, ``eviction_many`` — into a persistent pool of worker
processes, sharded by rows, with sample matrices returned through
``multiprocessing.shared_memory`` segments instead of pickled copies.

Three properties make this sound:

* **Bit-identity.**  Request-keyed sampling (``simulate._KeyedSampler``)
  is counter-based and stateless: row i of a batch depends only on the
  request signature and the device seed, never on which process computes
  it or in what order.  Any row shard is therefore byte-identical to the
  inline dispatch, and equal to the reference package's pooled and inline
  runs of the same request.
* **Reconstructible runners.**  Workers rebuild the probe runner
  in-process from a picklable ``RunnerSpec`` (a module-level builder
  function plus its payload).  Sim/Caching/Chaos runners publish specs;
  runners without one (the ``CudaRunner``: built kernels and a CUDA
  context do not round-trip a pickle, and timed launches must not overlap)
  make ``maybe_parallel_runner`` a no-op and execution stays inline.
* **No torch in a worker.**  A worker imports numpy and the pure-Python
  probe modules only: this module, ``probes.runners`` and
  ``probes.chaos`` import neither ``torch`` nor CUDA, so a worker never
  opens a CUDA context and a pool never competes with the card's.
* **Crash containment.**  A worker that dies or wedges mid-shard is
  killed and respawned, and the batch call raises
  ``TransientRunnerError`` — the same taxonomy the resilience path
  (retry -> split -> degrade) and the fusion dispatcher's round-splitting
  already handle, so a lost worker costs one retry, not a discovery.

Shared-memory ownership: the *coordinator* creates every segment (the
result shape ``(rows, n_samples)`` is known before dispatch), workers
attach and write in place, and the coordinator unlinks in a ``finally``
regardless of outcome — so a killed worker can never leak a segment.
``ParallelPool.close`` (also registered via ``atexit`` and available as a
context manager) unlinks any stragglers by pool-unique name prefix.
"""
from __future__ import annotations

import atexit
import itertools
import os
import pickle
import queue
import threading
from dataclasses import dataclass
from multiprocessing import shared_memory
from typing import Callable

import numpy as np

from ..errors import TransientRunnerError

__all__ = ["ParallelConfig", "ParallelPool", "ParallelRunner", "RunnerSpec",
           "effective_cpu_count", "get_global_pool", "shutdown_global_pools",
           "maybe_parallel_runner", "POOL_WORKER_ENV"]

#: set in every pool worker's environment — lets wrapped runners (e.g. the
#: chaos runner's ``kill_worker_after`` switch) detect in-worker execution
#: without importing this module.
POOL_WORKER_ENV = "MT4G_POOL_WORKER"

#: the five batched capabilities the pool shards by rows.
POOLED_METHODS = ("pchase_batch", "cold_chase_batch", "pchase_many",
                  "cold_chase_many", "eviction_many")


# --------------------------------------------------------------------------
# Effective core counting (cgroup/affinity aware)
# --------------------------------------------------------------------------
def _cgroup_cpu_quota() -> int | None:
    """CPU quota in whole cores from the cgroup limits, or None.

    ``os.cpu_count`` reports the host's cores; a containerized run with a
    2-core quota on a 64-core host must not size pools for 64.  Reads the
    v2 ``cpu.max`` (``"<quota> <period>"`` or ``"max <period>"``) and
    falls back to the v1 ``cfs_quota_us``/``cfs_period_us`` pair.
    """
    try:
        with open("/sys/fs/cgroup/cpu.max") as f:
            quota_s, period_s = f.read().split()[:2]
        if quota_s != "max" and int(period_s) > 0:
            return max(1, int(int(quota_s) / int(period_s)))
    except (OSError, ValueError):
        pass
    try:
        with open("/sys/fs/cgroup/cpu/cpu.cfs_quota_us") as f:
            quota = int(f.read())
        with open("/sys/fs/cgroup/cpu/cpu.cfs_period_us") as f:
            period = int(f.read())
        if quota > 0 and period > 0:
            return max(1, quota // period)
    except (OSError, ValueError):
        pass
    return None


def effective_cpu_count() -> int:
    """Cores this process may actually use: affinity mask capped by any
    cgroup CPU quota (``os.cpu_count`` ignores both)."""
    try:
        cores = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        cores = os.cpu_count() or 1
    quota = _cgroup_cpu_quota()
    if quota is not None:
        cores = min(cores, quota)
    return max(1, cores)


# --------------------------------------------------------------------------
# Runner specs
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class RunnerSpec:
    """Picklable recipe for rebuilding a probe runner in a worker process.

    ``builder`` must be a *module-level* function (pickled by qualified
    name, imported on the worker side); ``payload`` is its positional
    argument tuple and must itself pickle — device models, schedule
    dataclasses, plain config scalars.  Runners advertise a spec through a
    ``runner_spec()`` method; returning None (or not having the method)
    opts the runner out of pooling and keeps execution inline.
    """

    builder: Callable
    payload: tuple = ()

    def build(self):
        """Construct the runner this spec describes (worker side)."""
        return self.builder(*self.payload)


@dataclass(frozen=True)
class ParallelConfig:
    """Process-pool policy for one discovery (or a shared job engine).

    ``workers=None`` sizes the pool from ``effective_cpu_count()`` —
    leaving one core for the coordinator, capped at 8 — and falls back to
    inline execution entirely below ``min_cores`` effective cores, where
    process overhead would exceed the win.  An explicit ``workers`` count
    always pools (the testing override).  The config is
    deliberately *not* part of the store request descriptor: pooled and
    inline runs are bit-identical, so they share a content address.
    """

    workers: int | None = None
    start_method: str = "spawn"      # or "forkserver"; never "fork" (CUDA)
    min_rows_per_shard: int = 8      # below this, one worker takes the batch
    call_timeout_s: float = 300.0    # per-shard wall ceiling -> worker killed
    min_cores: int = 4               # auto mode stays inline below this

    def resolved_workers(self) -> int:
        """Pool size after the core heuristic; 0 means stay inline."""
        if self.workers is not None:
            return max(1, int(self.workers))
        cores = effective_cpu_count()
        if cores < self.min_cores:
            return 0
        return min(8, cores - 1)


# --------------------------------------------------------------------------
# Worker side
# --------------------------------------------------------------------------
def _worker_main(conn) -> None:
    """Pool worker loop: rebuild runners from specs, serve shard calls.

    Each request carries a pickled ``RunnerSpec`` blob; the rebuilt runner
    is memoized by blob so the pool stays warm across batches *and across
    discoveries* that share a spec.  Results are written into the
    coordinator-owned shared-memory segment named in the request; the
    reply carries only ``("ok",)`` or ``("err", exception)``.
    """
    os.environ[POOL_WORKER_ENV] = "1"
    runners: dict[bytes, object] = {}
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            break
        if msg is None or msg[0] == "stop":
            break
        _, spec_blob, method, args, shm_name, shape = msg
        try:
            runner = runners.get(spec_blob)
            if runner is None:
                runner = pickle.loads(spec_blob).build()
                runners[spec_blob] = runner
            out = np.asarray(getattr(runner, method)(*args),
                             dtype=np.float64)
            if out.shape != tuple(shape):
                raise RuntimeError(
                    f"worker shard shape mismatch for {method}: "
                    f"{out.shape} != {tuple(shape)}")
            # Attach-side resource tracking is harmless here: spawn
            # children share the coordinator's resource tracker, whose
            # registry is a set — the attach re-register dedupes against
            # the coordinator's create-register, and the coordinator's
            # unlink balances both.  (Never unregister here: a second
            # unregister would make that unlink a tracker error.)
            shm = shared_memory.SharedMemory(name=shm_name)
            try:
                np.ndarray(tuple(shape), dtype=np.float64,
                           buffer=shm.buf)[...] = out
            finally:
                shm.close()
            reply = ("ok",)
        except BaseException as exc:  # noqa: BLE001 — delivered to caller
            try:
                pickle.dumps(exc)
                reply = ("err", exc)
            except Exception:  # noqa: BLE001 — unpicklable: re-wrap
                reply = ("err", RuntimeError(f"{type(exc).__name__}: {exc}"))
        try:
            conn.send(reply)
        except (BrokenPipeError, OSError):
            break
    conn.close()


# --------------------------------------------------------------------------
# Coordinator side
# --------------------------------------------------------------------------
class _Worker:
    """One pool worker: its process handle and the coordinator-side pipe."""

    __slots__ = ("proc", "conn")

    def __init__(self, proc, conn):
        self.proc = proc
        self.conn = conn


class _WorkerDied(Exception):
    """Internal marker: the worker serving a shard crashed or timed out."""


class ParallelPool:
    """Persistent worker-process pool sharding batched capability calls.

    Thread-safe: concurrent coordinator threads (the unfused scheduler's
    item threads, or concurrent ``JobEngine`` discoveries sharing the
    global pool) check workers out of a free list, so a worker never
    serves two shards at once.  Dead or timed-out workers are respawned
    in place and the affected batch raises ``TransientRunnerError``.

    Use as a context manager, or rely on ``close()`` — also registered
    with ``atexit`` — to stop workers and unlink any shared-memory
    segments (including by name-prefix sweep, covering abnormal exits).
    """

    def __init__(self, config: ParallelConfig | None = None):
        import multiprocessing

        self.config = config or ParallelConfig()
        n = max(1, self.config.resolved_workers())
        self._ctx = multiprocessing.get_context(self.config.start_method)
        self._prefix = f"mt4g{os.getpid()}p{id(self) % 100000:05d}"
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self._free: queue.Queue = queue.Queue()
        self._live_segments: set[str] = set()
        self._closed = False
        self.respawns = 0                # workers replaced after crash/timeout
        self.calls = 0                   # run_batch invocations
        self.shards = 0                  # worker dispatches issued
        for _ in range(n):
            self._free.put(self._spawn())
        self.workers = n
        atexit.register(self.close)

    # ------------------------------------------------------------ lifecycle
    def _spawn(self) -> _Worker:
        parent, child = self._ctx.Pipe()
        proc = self._ctx.Process(target=_worker_main, args=(child,),
                                 daemon=True, name="mt4g-pool-worker")
        proc.start()
        child.close()
        return _Worker(proc, parent)

    def close(self) -> None:
        """Stop all workers, reap them (a worker still alive 5 s after its
        stop is terminated, and 5 s after that killed, and joined), and
        unlink every pool segment (idempotent)."""
        if self._closed:
            return
        self._closed = True
        try:
            atexit.unregister(self.close)
        except Exception:  # noqa: BLE001 — interpreter teardown ordering
            pass
        workers = []
        while True:
            try:
                workers.append(self._free.get_nowait())
            except queue.Empty:
                break
        for w in workers:
            try:
                w.conn.send(("stop",))
            except (BrokenPipeError, OSError):
                pass
            w.conn.close()
        for w in workers:
            w.proc.join(timeout=5.0)
            if w.proc.is_alive():
                w.proc.terminate()
                w.proc.join(timeout=5.0)
            if w.proc.is_alive():
                w.proc.kill()
                w.proc.join()
        self._sweep_segments()

    def __enter__(self) -> "ParallelPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------ shared memory
    def _alloc(self, shape: tuple) -> shared_memory.SharedMemory:
        """Create one coordinator-owned result segment for a shard."""
        nbytes = max(8, int(np.prod(shape)) * 8)
        name = f"{self._prefix}n{next(self._seq)}"
        shm = shared_memory.SharedMemory(name=name, create=True, size=nbytes)
        with self._lock:
            self._live_segments.add(name)
        return shm

    def _release(self, shm: shared_memory.SharedMemory) -> None:
        """Close and unlink one segment; tolerates double release."""
        name = shm.name.lstrip("/")
        try:
            shm.close()
        finally:
            try:
                shm.unlink()
            except FileNotFoundError:
                pass
            with self._lock:
                self._live_segments.discard(name)

    def _sweep_segments(self) -> None:
        """Unlink tracked segments plus any /dev/shm entry with our prefix
        (the abnormal-exit backstop: a segment allocated but never released
        because the coordinator thread died mid-batch)."""
        with self._lock:
            leftovers = set(self._live_segments)
            self._live_segments.clear()
        if os.path.isdir("/dev/shm"):
            try:
                leftovers.update(n for n in os.listdir("/dev/shm")
                                 if n.startswith(self._prefix))
            except OSError:
                pass
        for name in leftovers:
            try:
                seg = shared_memory.SharedMemory(name=name)
                seg.close()
                seg.unlink()
            except FileNotFoundError:
                continue
            except OSError:
                continue

    # ------------------------------------------------------------ dispatch
    def _checkout(self, want: int) -> list[_Worker]:
        """Claim between 1 and ``want`` free workers (blocks for the first)."""
        if self._closed:
            raise RuntimeError("parallel pool is closed")
        try:
            workers = [self._free.get(timeout=self.config.call_timeout_s)]
        except queue.Empty:
            raise TransientRunnerError(
                "parallel pool starved: no worker freed within "
                f"{self.config.call_timeout_s}s") from None
        while len(workers) < want:
            try:
                workers.append(self._free.get_nowait())
            except queue.Empty:
                break
        return workers

    def _collect(self, w: _Worker):
        """Read one shard reply; crash/timeout kills + flags the worker.

        Returns ``(worker, error)`` where ``worker`` is ``w`` or a fresh
        respawn and ``error`` is None, the worker-raised exception, or a
        ``TransientRunnerError`` for a death/timeout.
        """
        try:
            if not w.conn.poll(self.config.call_timeout_s):
                raise _WorkerDied(
                    f"worker timed out after {self.config.call_timeout_s}s")
            reply = w.conn.recv()
        except (_WorkerDied, EOFError, OSError) as exc:
            try:
                w.conn.close()
            except OSError:
                pass
            if w.proc.is_alive():
                w.proc.terminate()
            w.proc.join(timeout=5.0)
            self.respawns += 1
            return self._spawn(), TransientRunnerError(
                f"pool worker died mid-shard ({exc}); respawned")
        if reply[0] == "ok":
            return w, None
        return w, reply[1]

    def run_batch(self, spec_blob: bytes, method: str, rows: list,
                  n_samples: int, make_args: Callable[[list], tuple]
                  ) -> np.ndarray:
        """Execute one batched capability call sharded across workers.

        ``rows`` is the per-row request list (whatever the capability
        shards over); ``make_args(shard_rows)`` builds the positional
        argument tuple the worker passes to ``runner.<method>``.  Large
        batches split into one contiguous shard per free worker (at least
        ``min_rows_per_shard`` rows each); small batches go to a single
        worker whole.  Returns the reassembled ``(len(rows), n_samples)``
        float64 matrix, bit-identical to the inline call.

        Raises whatever a worker's runner raised (``TransientRunnerError``
        passes through for the resilience path, ``NotImplementedError``
        etc. keep their types), or ``TransientRunnerError`` when a worker
        crashed or timed out (after respawning it).
        """
        n = int(n_samples)
        total = len(rows)
        out = np.empty((total, n), dtype=np.float64)
        if total == 0:
            return out
        want = max(1, min(self.workers,
                          total // max(1, self.config.min_rows_per_shard)))
        workers = self._checkout(want)
        k = len(workers)
        bounds = [(total * i // k, total * (i + 1) // k) for i in range(k)]
        self.calls += 1
        sent: list[tuple] = []          # (worker, shm, (lo, hi)) per shard
        errors: list[BaseException] = []
        returned: list[_Worker] = []
        try:
            for w, (lo, hi) in zip(workers, bounds):
                shape = (hi - lo, n)
                shm = self._alloc(shape)
                try:
                    w.conn.send(("call", spec_blob, method,
                                 make_args(rows[lo:hi]), shm.name.lstrip("/"),
                                 shape))
                    self.shards += 1
                    sent.append((w, shm, (lo, hi)))
                except (BrokenPipeError, OSError):
                    self._release(shm)
                    w, err = self._collect(w)     # reap + respawn
                    returned.append(w)
                    errors.append(err or TransientRunnerError(
                        "pool worker pipe broke before dispatch"))
            for w, shm, (lo, hi) in sent:
                w, err = self._collect(w)
                returned.append(w)
                if err is not None:
                    errors.append(err)
                else:
                    out[lo:hi] = np.ndarray((hi - lo, n), dtype=np.float64,
                                            buffer=shm.buf)
        finally:
            for _, shm, _ in sent:
                self._release(shm)
            for w in returned:
                self._free.put(w)
            # workers checked out but never dispatched (early error paths)
            for w in workers:
                if w not in returned and all(w is not s[0] for s in sent):
                    self._free.put(w)
        if errors:
            # Prefer the runner's own exception type (the resilience and
            # split paths dispatch on it); crash-transients only when no
            # worker produced a richer error.
            for err in errors:
                if not isinstance(err, TransientRunnerError):
                    raise err
            raise errors[0]
        return out


# --------------------------------------------------------------------------
# Runner facade
# --------------------------------------------------------------------------
class ParallelRunner:
    """ProbeRunner facade sharding the five batched capabilities by rows.

    Everything else — single probes, bandwidth, metadata hooks,
    ``deterministic`` — delegates to the local ``base`` runner via
    ``__getattr__``, so capability checks (``hasattr``) and the
    split-and-retry single-row fallback behave exactly as they would
    inline.  Sits *below* ``CachingRunner``: the coordinator keeps the
    sample cache and only cache-missing rows reach the pool.
    """

    def __init__(self, base, spec: RunnerSpec, pool: ParallelPool):
        self.base = base
        self.pool = pool
        self._spec_blob = pickle.dumps(spec)

    def __getattr__(self, name):
        return getattr(self.base, name)

    # ------------------------------------------------------ pooled methods
    def pchase_batch(self, space, array_bytes_list, stride, n_samples):
        """Size-sweep batch sharded by rows across the pool."""
        sizes = [int(ab) for ab in array_bytes_list]
        return self.pool.run_batch(
            self._spec_blob, "pchase_batch", sizes, n_samples,
            lambda rows: (space, rows, int(stride), int(n_samples)))

    def cold_chase_batch(self, space, array_bytes_list, stride_list,
                         n_samples):
        """Granularity stride-sweep batch sharded by rows."""
        pairs = [(int(ab), int(st))
                 for ab, st in zip(array_bytes_list, stride_list)]
        return self.pool.run_batch(
            self._spec_blob, "cold_chase_batch", pairs, n_samples,
            lambda rows: (space, [r[0] for r in rows], [r[1] for r in rows],
                          int(n_samples)))

    def pchase_many(self, requests, n_samples):
        """Heterogeneous fused warm batch sharded by rows."""
        reqs = [(sp, int(ab), int(st)) for sp, ab, st in requests]
        return self.pool.run_batch(
            self._spec_blob, "pchase_many", reqs, n_samples,
            lambda rows: (rows, int(n_samples)))

    def cold_chase_many(self, requests, n_samples):
        """Heterogeneous fused cold batch sharded by rows."""
        reqs = [(sp, int(ab), int(st)) for sp, ab, st in requests]
        return self.pool.run_batch(
            self._spec_blob, "cold_chase_many", reqs, n_samples,
            lambda rows: (rows, int(n_samples)))

    def eviction_many(self, requests, n_samples):
        """Mixed amount/sharing/cu eviction grid sharded by rows."""
        reqs = [tuple(v if isinstance(v, str) else int(v) for v in r)
                for r in requests]
        return self.pool.run_batch(
            self._spec_blob, "eviction_many", reqs, n_samples,
            lambda rows: (rows, int(n_samples)))


# --------------------------------------------------------------------------
# Shared pools + integration helper
# --------------------------------------------------------------------------
_POOLS: dict[tuple, ParallelPool] = {}
_POOLS_LOCK = threading.Lock()


def get_global_pool(config: ParallelConfig | None = None) -> ParallelPool:
    """The warm shared pool for ``config`` (created on first use).

    Keyed by ``(start_method, resolved worker count)`` so every discovery
    — including concurrent ``JobEngine`` jobs — with an equivalent config
    shares one set of worker processes; workers memoize rebuilt runners
    per spec, so repeat discoveries skip reconstruction too.
    """
    config = config or ParallelConfig()
    key = (config.start_method, config.resolved_workers())
    with _POOLS_LOCK:
        pool = _POOLS.get(key)
        if pool is None or pool._closed:
            pool = _POOLS[key] = ParallelPool(config)
        return pool


def shutdown_global_pools() -> None:
    """Close every shared pool (tests and embedders; atexit covers the rest)."""
    with _POOLS_LOCK:
        pools = list(_POOLS.values())
        _POOLS.clear()
    for pool in pools:
        pool.close()


def maybe_parallel_runner(runner, config: ParallelConfig | None,
                          pool: ParallelPool | None = None):
    """Wrap ``runner`` for pooled execution, or return it unchanged.

    Inline (identity) when ``config`` is None, when the effective-core
    heuristic says pooling cannot pay off, or when the runner publishes no
    ``RunnerSpec`` — the graceful-degradation contract that lets callers
    pass a config unconditionally.  ``pool`` overrides the shared global
    pool (tests that need an isolated lifecycle).
    """
    if config is None:
        return runner
    spec_fn = getattr(runner, "runner_spec", None)
    spec = spec_fn() if callable(spec_fn) else None
    if spec is None:
        return runner
    if pool is None:
        if config.resolved_workers() <= 0:
            return runner
        pool = get_global_pool(config)
    return ParallelRunner(runner, spec, pool)
