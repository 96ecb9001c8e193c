"""The probe engine: registry × spaces -> scheduled, cached, batched probes.

``run_probes`` is the engine entry point: it wraps a ``ProbeRunner`` in the
keyed sample cache, expands the probe registry into (space × family) work
items with their dependency edges, runs them on the concurrent scheduler,
and returns the raw probe results plus per-family timings and cache/order
diagnostics.  The unified ``discover.discover(request)`` core drives this
function for every backend (the ``discover_sim``/``discover_host``/
``discover_pallas`` wrappers only build the request): it assembles the
returned results into a ``Topology`` in exactly the order the legacy
sequential loop did, which is why engine and legacy discovery stay
bit-identical on simulated devices.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..errors import DegradedResult
from .cache import CachingRunner, SampleCache
from .registry import (DEVICE_FAMILIES, ProbeContext, space_probe_specs)
from .scheduler import WorkItem, run_work_items

__all__ = ["EngineResult", "run_probes", "DEVICE_KEY"]

DEVICE_KEY = "<device>"


@dataclass
class EngineResult:
    """Raw engine output, pre-topology-assembly."""

    space_results: dict = field(default_factory=dict)  # space -> family -> res
    device_results: dict = field(default_factory=dict)  # family -> result
    infos: list = field(default_factory=list)           # probed spaces, in order
    order: list = field(default_factory=list)           # completion order
    cache_stats: dict = field(default_factory=dict)
    wall_seconds: float = 0.0
    degraded: list = field(default_factory=list)        # DegradedResult, in order
    retries: int = 0                                    # transient retries spent
    # fused runs: rounds, fused dispatches and the rows they carried
    fusion: dict | None = None


def run_probes(runner, n_samples: int = 33, elements: list[str] | None = None,
               *, device_families: tuple[str, ...] = (),
               max_workers: int | None = None, timings=None,
               cache: SampleCache | None = None, budget=None,
               fuse: bool = False, resilience=None,
               checkpoint=None, parallel=None) -> EngineResult:
    """Run the full registry against ``runner`` through the engine.

    ``device_families`` selects which device-scoped families to schedule
    (drivers gate e.g. ``cu_sharing`` on the device actually having CU
    groups, mirroring the legacy flow).

    ``budget`` (a ``planner.SweepBudget``) switches sweep-heavy families to
    the adaptive coarse-to-fine planner — identical discrete attributes,
    ~4-8x fewer probed rows.  ``fuse=True`` runs the schedule through the
    cross-family fusion dispatcher: concurrently ready items coalesce their
    probe rounds into single ``pchase_many``/``cold_chase_many`` dispatches
    (``max_workers`` is ignored in fused mode).

    ``resilience`` (an ``errors.Resilience``) turns on per-item transient
    retry with graceful degradation: an item that exhausts its retry
    budget lands as an ``errors.DegradedResult`` in the results (collected
    in ``EngineResult.degraded``) instead of aborting the run, and the
    policy's statistical knobs thread into the probe context.
    ``checkpoint(key)`` fires after every completed work item — the
    discovery layer's sample-cache write-through hook.

    ``parallel`` (an ``engine.parallel.ParallelConfig``) shards the
    batched capability calls across the persistent worker-process pool:
    the runner is wrapped in a ``ParallelRunner`` *below* the caching
    layer, so cached rows are served locally and only cache-missing rows
    cross the process boundary.  Runners without a ``RunnerSpec`` — or
    boxes below the config's effective-core floor — silently stay inline;
    results are bit-identical either way for deterministic runners.
    """
    if parallel is not None:
        from .parallel import maybe_parallel_runner

        runner = maybe_parallel_runner(runner, parallel)
    cached = CachingRunner(runner, cache=cache)
    dispatcher = None
    probe_runner = cached
    if fuse:
        from .fusion import FusionDispatcher

        dispatcher = FusionDispatcher(cached)
        probe_runner = dispatcher.proxy()
    infos = [i for i in cached.spaces()
             if not elements or i.name in elements]

    space_results: dict[str, dict] = {i.name: {} for i in infos}
    shared_ctx = ProbeContext(runner=probe_runner, n_samples=n_samples,
                              all_results=space_results, infos=infos,
                              budget=budget, resilience=resilience)

    degraded: list[DegradedResult] = []

    def on_exhausted(it, exc, attempts):
        """Stand-in result for an item past its retry budget.

        Space items write their result into ``space_results`` from inside
        ``fn`` — which raised — so the sentinel must be planted here for
        dependent families to see it (they all check ``.found`` first).
        """
        space, fam = it.key
        dr = DegradedResult(family=fam, key=f"{space}/{fam}",
                            error=f"{type(exc).__name__}: {exc}",
                            attempts=attempts)
        degraded.append(dr)
        if space in space_results:
            space_results[space][fam] = dr
        return dr

    items: list[WorkItem] = []
    scheduled: set[tuple[str, str]] = set()

    def make_space_item(info, spec, deps):
        ctx = ProbeContext(runner=probe_runner, n_samples=n_samples,
                           info=info, results=space_results[info.name],
                           all_results=space_results, infos=infos,
                           budget=budget, resilience=resilience)

        def fn(_results, spec=spec, ctx=ctx, name=info.name):
            value = spec.run(ctx)
            space_results[name][spec.family] = value
            return value
        return WorkItem(key=(info.name, spec.family), fn=fn, deps=deps,
                        family=spec.family)

    for info in infos:
        specs = space_probe_specs(info)
        families = {s.family for s in specs}
        for spec in specs:
            deps = tuple((info.name, d) for d in spec.depends
                         if d in families)
            items.append(make_space_item(info, spec, deps))
            scheduled.add((info.name, spec.family))

    # Device-scoped families: depend on every size result they might read.
    size_deps = tuple(k for k in scheduled if k[1] == "size")
    for spec in DEVICE_FAMILIES:
        if spec.family not in device_families:
            continue
        deps = size_deps if spec.family in ("sharing", "cu_sharing") else ()

        def fn(_results, spec=spec):
            return spec.run(shared_ctx)
        # Timing buckets match the legacy names (device-memory latency and
        # bandwidth fold into the per-family "latency"/"bandwidth" rows).
        bucket = {"device_memory_latency": "latency",
                  "device_memory_bandwidth": "bandwidth"}.get(spec.family,
                                                              spec.family)
        items.append(WorkItem(key=(DEVICE_KEY, spec.family), fn=fn,
                              deps=deps, family=bucket))

    sched = run_work_items(items, max_workers=max_workers, timings=timings,
                           fuser=dispatcher, resilience=resilience,
                           on_exhausted=on_exhausted if resilience else None,
                           on_item_done=checkpoint, parallel=parallel)

    device_results = {fam: sched.results[(DEVICE_KEY, fam)]
                      for fam in device_families
                      if (DEVICE_KEY, fam) in sched.results}
    return EngineResult(
        space_results=space_results,
        device_results=device_results,
        infos=infos,
        order=sched.order,
        cache_stats=cached.cache.stats(),
        wall_seconds=sched.wall_seconds,
        degraded=degraded,
        retries=sched.retries,
        fusion=None if dispatcher is None else {
            "rounds": dispatcher.rounds,
            "fused_calls": dispatcher.fused_calls,
            "fused_rows": dispatcher.fused_rows},
    )
