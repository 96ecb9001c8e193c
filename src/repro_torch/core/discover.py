"""Discovery orchestration — the ``mt4g`` entry point equivalent (paper C1).

Runs the full probe suite against a runner, auto-evaluates every result with
the statistics layer, and assembles a ``Topology`` report with provenance and
confidence annotations. Mirrors the MT4G CLI behavior: the whole suite by
default, an optional restriction to specific memory elements, and timing of
each benchmark family (paper §V-A reports per-family run times).

The center of this module is the **unified, runner-agnostic core**
``discover(request)``: engine invocation and topology assembly, shared by
every backend.  The public entry points are thin wrappers that only say
what is genuinely backend-specific:

* ``discover_sim``  — a ``SimRunner`` over a virtual device with known
  ground truth (the validation backend);
* ``discover_cuda`` — the ``CudaRunner``: hand-written CUDA C++ probe
  kernels (``repro_torch.kernels``) on the card, timed end-to-end
  against a configured ground-truth hierarchy.

Both run the dense, unfused engine path.  The options of the reference
package whose modules are not ported yet — the adaptive sweep planner
(``budget``), cross-family fusion (``fuse``), the topology store
(``store``, ``survey``), checkpointed fault tolerance (``resilience``) and
the process pool (``parallel``) — raise ``NotImplementedError`` naming the
missing module.  Left at their defaults they change nothing.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

from .errors import DegradedResult
from .probes.amount import align_segments
from .probes.runners import SimRunner
from .topology import (PROVENANCE_API, PROVENANCE_BENCHMARK,
                       PROVENANCE_DEGRADED, ComputeElement, MemoryElement,
                       Topology)

__all__ = ["DiscoveryTimings", "DiscoveryRequest", "discover",
           "discover_sim", "discover_cuda", "sim_request_descriptor",
           "cuda_request_descriptor"]

KIB = 1024


@dataclass
class DiscoveryTimings:
    """Per-family wall times + probe-volume diagnostics for one discovery
    (paper §V-A reports per-family run times)."""

    per_family: dict[str, float] = field(default_factory=dict)
    # Probe-volume diagnostics for the run (cache hits/misses, fusion round
    # count, planner mode).  Not persisted — a store hit reconstructs only
    # the per-family timings, since no probes ran.
    meta: dict = field(default_factory=dict)

    def add(self, family: str, seconds: float) -> None:
        """Accumulate seconds onto one benchmark family's total."""
        self.per_family[family] = self.per_family.get(family, 0.0) + seconds

    @property
    def total(self) -> float:
        """Summed per-family wall time for the whole run."""
        return sum(self.per_family.values())

    @property
    def probe_rows(self) -> int | None:
        """Grid rows actually sampled (cache misses) — the probe volume the
        adaptive planner minimizes; None when unknown (store hit, legacy)."""
        cache = self.meta.get("cache")
        return None if cache is None else int(cache["misses"])


class _Timer:
    def __init__(self, timings: DiscoveryTimings, family: str):
        self.t, self.f = timings, family

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t.add(self.f, time.perf_counter() - self.t0)
        return False


# --------------------------------------------------------------------------
# Request descriptors (content addresses for a later topology store)
# --------------------------------------------------------------------------
def sim_request_descriptor(device, n_samples: int,
                           elements: list[str] | None) -> dict:
    """Everything that determines a ``discover_sim`` result — and nothing
    that does not.  Worker count and batching are excluded: request-keyed
    sample streams make them result-invisible, so the key addresses that
    equivalence class.  Equal to the reference package's descriptor of the
    same dense request."""
    return {
        "kind": "discover_sim",
        "backend": f"simulated:{device.name}",
        "device": device.name,
        "vendor": device.vendor,
        "seed": device.seed,
        "n_samples": int(n_samples),
        "elements": sorted(elements) if elements else None,
    }


def cuda_request_descriptor(model, n_samples: int,
                            elements: list[str] | None) -> dict:
    """Content address of a ``discover_cuda`` request: model identity +
    seed + sample count + element restriction, laid out like the reference
    package's Pallas descriptor (dense sweeps: ``budget`` is None).
    Measured values vary run to run (real timings); the *request* is what
    is addressed."""
    return {
        "kind": "discover_cuda",
        "backend": f"cuda:{model.name}",
        "model": model.name,
        "vendor": model.vendor,
        "seed": model.seed,
        "n_samples": int(n_samples),
        "elements": sorted(elements) if elements else None,
        "budget": None,
    }


def _refuse_unported(*, budget=None, fuse=False, store=None, survey=False,
                     resilience=None, parallel=None) -> None:
    """Raise for an option whose module is not part of the port yet."""
    missing = [(budget is not None, "budget", "engine/planner.py"),
               (fuse, "fuse", "engine/fusion.py"),
               (store is not None, "store", "engine/store.py"),
               (survey, "survey", "engine/store.py"),
               (resilience is not None, "resilience",
                "engine/store.py (checkpoint/resume)"),
               (parallel is not None, "parallel", "engine/parallel.py")]
    for given, option, module in missing:
        if given:
            raise NotImplementedError(
                f"{option}: {module} is not ported to repro_torch yet")


# --------------------------------------------------------------------------
# The unified runner-agnostic core
# --------------------------------------------------------------------------
@dataclass
class DiscoveryRequest:
    """One backend's worth of 'what is different': identity and runner.

    Everything else — timings, engine invocation, topology assembly — is the
    shared ``discover()`` implementation.
    """

    descriptor: dict
    vendor: str
    model: str
    backend: str
    make_runner: Callable[[], object]
    n_samples: int = 33
    elements: list[str] | None = None
    device_families: tuple[str, ...] = ()
    max_workers: int | None = None
    clock_domain: str = "cycles"
    cu_space: str = "sL1d"            # the space CU-sharing groups attach to


def discover(request: DiscoveryRequest) -> tuple[Topology, DiscoveryTimings]:
    """Run one discovery request end to end (the backend-neutral core):
    the full registry through the dense engine, assembled into a
    ``Topology``."""
    from .engine import SampleCache, run_probes

    timings = DiscoveryTimings()
    runner = request.make_runner()
    eng = run_probes(runner, n_samples=request.n_samples,
                     elements=request.elements,
                     device_families=request.device_families,
                     max_workers=request.max_workers, timings=timings,
                     cache=SampleCache())
    timings.meta["cache"] = eng.cache_stats
    timings.meta["planned"] = False
    topo = _assemble_engine_topology(request, runner, eng, timings)
    return topo, timings


# Degraded probe family -> the topology attribute it would have filled.
_DEGRADED_ATTR = {"size": "size", "fetch_granularity": "fetch_granularity",
                  "latency": "load_latency", "line_size": "line_size",
                  "amount": "amount", "bandwidth": "read_bw"}


def _mark_degraded(topo: Topology, element, family: str, dr) -> None:
    """Record one degraded probe family on its element.

    Graceful degradation's assembly half: the attribute the family would
    have measured lands as ``"unknown"`` with ``degraded`` provenance and
    zero confidence, and the retry diagnostics go into the report notes —
    the topology stays structurally complete instead of aborting, and the
    gap is attributable (paper's reliability contract: never silently
    report a value that was not measured)."""
    attr = _DEGRADED_ATTR.get(family, family)
    element.set(attr, "unknown", "", PROVENANCE_DEGRADED, 0.0)
    topo.notes.append(
        f"{element.name}/{family}: degraded after {dr.attempts} attempts "
        f"({dr.error})")


def _assemble_engine_topology(request: DiscoveryRequest, runner, eng,
                              timings: DiscoveryTimings) -> Topology:
    """Registry results -> ``Topology``, in probe order (mirrors the legacy
    sequential loop so engine and legacy reports stay comparable).

    Backend-neutral by construction: API capacities come from the runner's
    ``api_size`` hook, core counts from ``cores_per_sm`` — never from a
    concrete device object.  Families that exhausted their transient-retry
    budget arrive as ``errors.DegradedResult`` sentinels; each is recorded
    via ``_mark_degraded`` (attribute ``"unknown"``, ``degraded``
    provenance) instead of crashing the assembly.
    """
    topo = Topology(vendor=request.vendor, model=request.model,
                    backend=request.backend)
    topo.set_general("clock_domain", request.clock_domain,
                     provenance=PROVENANCE_API)
    topo.compute.append(ComputeElement("cores_per_sm", runner.cores_per_sm))

    api_size = getattr(runner, "api_size", lambda _s: None)

    # ---- per-space assembly, in probe order
    for info in eng.infos:
        res = eng.space_results[info.name]
        me = MemoryElement(info.name, info.kind, info.scope)

        sr = res["size"]
        if isinstance(sr, DegradedResult):
            _mark_degraded(topo, me, "size", sr)
        elif sr.found:
            if info.scope == "chip":
                # Paper Table I: L2-style totals come from the API; the
                # benchmark contributes the per-core segment size (§IV-F.1).
                me.set("size", api_size(info.name), "B", PROVENANCE_API)
            else:
                me.set("size", sr.size, "B", PROVENANCE_BENCHMARK,
                       sr.confidence)
                if not sr.cusum_agrees:
                    topo.notes.append(
                        f"{info.name}: CUSUM cross-check disagrees with the "
                        f"K-S change point — size result is suspect")

        gr = res.get("fetch_granularity")
        if isinstance(gr, DegradedResult):
            _mark_degraded(topo, me, "fetch_granularity", gr)
        elif gr is not None and gr.found:
            me.set("fetch_granularity", gr.granularity, "B",
                   PROVENANCE_BENCHMARK, 1.0)

        lat = res["latency"]
        if isinstance(lat, DegradedResult):
            _mark_degraded(topo, me, "latency", lat)
        else:
            me.set("load_latency", round(lat.p50, 1), "cyc",
                   PROVENANCE_BENCHMARK)
            me.set("load_latency_mean", round(lat.mean, 1), "cyc",
                   PROVENANCE_BENCHMARK)
            me.set("load_latency_p95", round(lat.p95, 1), "cyc",
                   PROVENANCE_BENCHMARK)

        ls = res.get("line_size")
        if isinstance(ls, DegradedResult):
            _mark_degraded(topo, me, "line_size", ls)
        elif ls is not None and ls.found:
            me.set("line_size", ls.line_size, "B", PROVENANCE_BENCHMARK, 1.0)

        am = res.get("amount")
        if isinstance(am, DegradedResult):
            _mark_degraded(topo, me, "amount", am)
        elif am is not None:
            kind, payload = am
            if kind == "per_core" and payload.found:
                me.set("amount", payload.amount, "", PROVENANCE_BENCHMARK, 1.0)
            elif kind == "aligned":
                # L2-style: align measured segment to the API-reported total.
                with _Timer(timings, "amount"):
                    k, aligned, conf = align_segments(api_size(info.name),
                                                      payload)
                me.set("amount", k, "", PROVENANCE_BENCHMARK, conf)
                me.set("segment_size", aligned, "B", PROVENANCE_BENCHMARK,
                       conf)

        bw = res.get("bandwidth")
        if isinstance(bw, DegradedResult):
            _mark_degraded(topo, me, "bandwidth", bw)
        elif bw is not None:
            me.set("read_bw", round(bw.read_bw / 1e9, 1), "GB/s",
                   PROVENANCE_BENCHMARK)
            me.set("write_bw", round(bw.write_bw / 1e9, 1), "GB/s",
                   PROVENANCE_BENCHMARK)
        topo.memory.append(me)

    # ---- physical sharing between logical spaces (NVIDIA-style, §IV-G)
    shares = eng.device_results.get("sharing", [])
    if isinstance(shares, DegradedResult):
        topo.notes.append(f"sharing: degraded after {shares.attempts} "
                          f"attempts ({shares.error})")
        shares = []
    for share in shares:
        if not share.shared:
            continue
        ma = topo.find_memory(share.space_a)
        mb = topo.find_memory(share.space_b)
        if mb and mb.name not in ma.shared_with:
            ma.shared_with.append(mb.name)
        if ma and ma.name not in mb.shared_with:
            mb.shared_with.append(ma.name)

    # ---- AMD-style CU<->sL1d sharing (§IV-H)
    cus = eng.device_results.get("cu_sharing")
    if isinstance(cus, DegradedResult):
        sl1d = topo.find_memory(request.cu_space)
        if sl1d is not None:
            _mark_degraded(topo, sl1d, "cu_sharing", cus)
    elif cus is not None:
        sl1d = topo.find_memory(request.cu_space)
        sl1d.shared_with = [",".join(map(str, g)) for g in cus.groups
                            if len(g) > 1]
        sl1d.set("exclusive_cus", cus.exclusive, "", PROVENANCE_BENCHMARK)

    # ---- device memory
    if "device_memory_latency" in eng.device_results:
        dm = MemoryElement("DeviceMemory", "memory", "chip")
        lat = eng.device_results["device_memory_latency"]
        if isinstance(lat, DegradedResult):
            _mark_degraded(topo, dm, "latency", lat)
        else:
            dm.set("load_latency", round(lat.p50, 1), "cyc",
                   PROVENANCE_BENCHMARK)
        bw = eng.device_results.get("device_memory_bandwidth")
        if isinstance(bw, DegradedResult):
            _mark_degraded(topo, dm, "bandwidth", bw)
        elif bw is not None:
            dm.set("read_bw", round(bw.read_bw / 1e9, 1), "GB/s",
                   PROVENANCE_BENCHMARK)
            dm.set("write_bw", round(bw.write_bw / 1e9, 1), "GB/s",
                   PROVENANCE_BENCHMARK)
        topo.memory.append(dm)

    topo.notes.append(
        f"discovery wall time: {eng.wall_seconds:.2f}s (engine; "
        f"per-family cpu { {k: round(v, 2) for k, v in timings.per_family.items()} }; "
        f"cache {eng.cache_stats['hits']} hits / "
        f"{eng.cache_stats['misses']} misses)")
    return topo


# --------------------------------------------------------------------------
# Backend wrappers
# --------------------------------------------------------------------------
def _device_families(model, elements) -> tuple[str, ...]:
    fams = ["sharing", "device_memory_latency", "device_memory_bandwidth"]
    if model.cu_share_groups and (not elements or "sL1d" in elements):
        fams.insert(1, "cu_sharing")
    return tuple(fams)


def discover_sim(device, n_samples: int = 33,
                 elements: list[str] | None = None, *,
                 max_workers: int | None = None, budget=None,
                 fuse: bool = False, store=None, survey: bool = False,
                 resilience=None, parallel=None,
                 ) -> tuple[Topology, DiscoveryTimings]:
    """Full MT4G-style discovery of a simulated device through the unified
    core and the dense probe engine.  Bit-identical to the reference
    package's ``discover_sim`` for the same device and seed: the sample
    streams are request-keyed, so scheduling and batching change when
    samples are drawn, never what is drawn."""
    _refuse_unported(budget=budget, fuse=fuse, store=store, survey=survey,
                     resilience=resilience, parallel=parallel)
    request = DiscoveryRequest(
        descriptor=sim_request_descriptor(device, n_samples, elements),
        vendor=device.vendor, model=device.name,
        backend=f"simulated:{device.name}",
        make_runner=lambda: SimRunner(device),
        n_samples=n_samples, elements=elements,
        device_families=_device_families(device, elements),
        max_workers=max_workers,
    )
    return discover(request)


def discover_cuda(model=None, n_samples: int = 9,
                  elements: list[str] | None = None, *,
                  runner=None, device: str = "cuda",
                  max_workers: int | None = 0, budget=None,
                  fuse: bool = False, store=None, survey: bool = False,
                  resilience=None, parallel=None,
                  ) -> tuple[Topology, DiscoveryTimings]:
    """Discovery through the hand-written probe kernels on the card.

    Same engine, same registry, same statistics as ``discover_sim`` — the
    runner is the only moving part.  ``model`` is the configured
    ground-truth hierarchy (default ``make_cuda_model()``); pass ``runner``
    to reuse a warmed ``CudaRunner`` (built kernels, warmed launch shapes)
    across discoveries, in which case its model and device are used.
    ``device="cpu"`` runs the kernels' plain PyTorch versions instead, for
    tests.  The schedule stays inline (``max_workers=0``) so no two timed
    launches ever overlap.  The sweeps are dense and unfused: the planner
    and fusion of the reference package's ``discover_pallas`` defaults are
    not ported yet.
    """
    from .probes.cuda_runner import CudaRunner, make_cuda_model

    _refuse_unported(budget=budget, fuse=fuse, store=store, survey=survey,
                     resilience=resilience, parallel=parallel)
    if runner is not None:
        model = runner.model
    elif model is None:
        model = make_cuda_model()
    request = DiscoveryRequest(
        descriptor=cuda_request_descriptor(model, n_samples, elements),
        vendor=model.vendor, model=model.name,
        backend=f"cuda:{model.name}",
        make_runner=(lambda: runner) if runner is not None
        else (lambda: CudaRunner(model, device=device)),
        n_samples=n_samples, elements=elements,
        device_families=_device_families(model, elements),
        max_workers=max_workers,
        clock_domain="model-cycles",    # chain-length units, timed end-to-end
    )
    return discover(request)
