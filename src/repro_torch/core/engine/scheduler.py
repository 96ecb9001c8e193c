"""Dependency-aware work-item scheduler for the probe engine.

Discovery decomposes into (memory space × probe family) work items with a
small dependency DAG (line size needs size + fetch granularity; sharing
needs every partner's size; ...).  The scheduler runs all ready items
concurrently on a thread pool and releases dependents as their inputs
complete.

Correctness does not depend on scheduling: probe sample streams are keyed
by request (see ``simulate._KeyedSampler``), so any execution order — and
any ``max_workers`` — produces identical results.  The per-family wall
times are accumulated into the same ``DiscoveryTimings`` buckets the legacy
sequential loop reports (a sum of item durations, matching the paper's
§V-A per-family accounting).
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import dataclass, field
from typing import Any, Callable, Hashable

from ..errors import TransientRunnerError
from ..probes.runners import CURRENT_FAMILY

__all__ = ["WorkItem", "ScheduleResult", "run_work_items", "check_items"]


@dataclass(frozen=True)
class WorkItem:
    """One schedulable unit of discovery work.

    ``fn`` receives the results-so-far mapping (keyed like ``key``) and
    returns the item's result; it must only read keys listed in ``deps``.
    """

    key: Hashable
    fn: Callable[[dict], Any]
    deps: tuple = ()
    family: str = ""                # DiscoveryTimings bucket


@dataclass
class ScheduleResult:
    """Scheduler output: item results, completion order, wall time, and the
    fault-tolerance tallies (transient retries spent, items degraded)."""

    results: dict = field(default_factory=dict)
    order: list = field(default_factory=list)    # completion order
    wall_seconds: float = 0.0
    retries: int = 0                             # transient retries spent
    degraded: list = field(default_factory=list)  # keys past the budget


def check_items(items: list[WorkItem]) -> dict:
    """Validate keys/deps; returns the key->item map (shared with fusion)."""
    by_key = {it.key: it for it in items}
    if len(by_key) != len(items):
        raise ValueError("duplicate work-item keys")
    for it in items:
        unknown = [d for d in it.deps if d not in by_key]
        if unknown:
            raise ValueError(f"{it.key}: unknown deps {unknown}")
    return by_key


def run_work_items(items: list[WorkItem], *, max_workers: int | None = None,
                   timings=None, fuser=None, resilience=None,
                   on_exhausted=None, on_item_done=None,
                   parallel=None) -> ScheduleResult:
    """Execute ``items`` respecting dependencies; returns results + order.

    ``max_workers=0`` runs everything inline on the calling thread in
    topological order — no pool, no locks.  This is both the profiling mode
    and the fastest mode on GIL-bound runners with few cores; results are
    identical either way (request-keyed sampling).  ``max_workers=None``
    picks a pool size from the CPU count, staying inline on boxes where
    threads can only fight over the GIL.

    ``fuser`` (a ``fusion.FusionDispatcher``) switches to round-based
    cross-family batch fusion: ready items run concurrently but every
    probe dispatch is coalesced and executed serially by the coordinator —
    see ``engine/fusion.py``.  ``max_workers`` is ignored in that mode.

    Fault tolerance (``resilience``, an ``errors.Resilience``): an item
    raising ``TransientRunnerError`` is re-attempted up to
    ``resilience.max_retries`` times with capped exponential backoff.  Past
    the budget, if ``resilience.degrade`` and ``on_exhausted`` is given,
    ``on_exhausted(item, exc, attempts)`` supplies the item's stand-in
    result (recorded in ``ScheduleResult.degraded``) and scheduling
    continues; otherwise the error propagates as before.  Non-transient
    exceptions always propagate — a deterministic bug must not be retried
    into a topology.  ``on_item_done(key)`` fires after each item lands
    (the checkpoint write-through hook); it runs on the coordinating
    thread in every mode, so callbacks need no locking.

    ``parallel`` (an ``engine.parallel.ParallelConfig``) signals that the
    items' probe calls shard across the multiprocess pool (the engine
    wrapped the runner in a ``ParallelRunner`` before building the items).
    It replaces the GIL-bound thread mode: with ``max_workers=None`` the
    schedule then runs inline on the coordinator — real concurrency
    happens row-wise inside the worker processes, where numpy doesn't
    fight this process's GIL — and results are identical either way.

    Raises on unknown dependencies or cycles (both indicate a registry bug,
    not a runtime condition worth limping through).
    """
    if fuser is not None:
        from .fusion import run_fused

        return run_fused(items, fuser, timings=timings,
                         resilience=resilience, on_exhausted=on_exhausted,
                         on_item_done=on_item_done)

    by_key = check_items(items)

    out = ScheduleResult()
    t_start = time.perf_counter()
    pending = dict(by_key)
    lock = threading.Lock()

    def ready(it: WorkItem) -> bool:
        return all(d in out.results for d in it.deps)

    def run_one(it: WorkItem):
        token = CURRENT_FAMILY.set(it.family)
        t0 = time.perf_counter()
        try:
            value = it.fn(out.results)
        finally:
            CURRENT_FAMILY.reset(token)
        dt = time.perf_counter() - t0
        if timings is not None and it.family:
            with lock:
                timings.add(it.family, dt)
        return value

    def attempt(it: WorkItem):
        """``run_one`` under the resilience policy: retry transients with
        capped backoff, then degrade (via ``on_exhausted``) or re-raise."""
        attempts = 0
        while True:
            try:
                return run_one(it)
            except TransientRunnerError as exc:
                if resilience is None:
                    raise
                if attempts >= resilience.max_retries:
                    if resilience.degrade and on_exhausted is not None:
                        with lock:
                            out.degraded.append(it.key)
                        return on_exhausted(it, exc, attempts + 1)
                    raise
                resilience.sleep(resilience.backoff(attempts))
                attempts += 1
                with lock:
                    out.retries += 1

    if max_workers is None:
        if parallel is not None:
            # Pooled mode: batched probe calls already shard across worker
            # processes, so coordinator threads would only add GIL traffic.
            max_workers = 0
        else:
            from .parallel import effective_cpu_count

            # numpy probe work mostly holds the GIL: a pool only pays off
            # when there are spare cores for the pieces that do release it.
            # Effective cores, not os.cpu_count(): a cgroup CPU quota or
            # affinity mask must not be answered with 8 fighting threads.
            cores = effective_cpu_count()
            max_workers = min(8, cores - 2) if cores > 3 else 0

    if max_workers == 0:
        while pending:
            ready_now = [it for it in pending.values() if ready(it)]
            if not ready_now:
                raise ValueError("dependency cycle among work items: "
                                 f"{sorted(map(str, pending))}")
            for it in ready_now:
                out.results[it.key] = attempt(it)
                out.order.append(it.key)
                del pending[it.key]
                if on_item_done is not None:
                    on_item_done(it.key)
        out.wall_seconds = time.perf_counter() - t_start
        return out

    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        futures = {}
        for it in list(pending.values()):
            if ready(it):
                futures[pool.submit(attempt, it)] = it
                del pending[it.key]
        while futures:
            done, _ = wait(list(futures), return_when=FIRST_COMPLETED)
            for fut in done:
                it = futures.pop(fut)
                out.results[it.key] = fut.result()   # re-raises item errors
                out.order.append(it.key)
                if on_item_done is not None:
                    on_item_done(it.key)
            for it in list(pending.values()):
                if ready(it):
                    futures[pool.submit(attempt, it)] = it
                    del pending[it.key]
        if pending:
            raise ValueError(
                f"dependency cycle among work items: {sorted(map(str, pending))}")

    out.wall_seconds = time.perf_counter() - t_start
    return out
