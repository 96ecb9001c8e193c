"""Discovery orchestration — the ``mt4g`` entry point equivalent (paper C1).

Runs the full probe suite against a runner, auto-evaluates every result with
the statistics layer, and assembles a ``Topology`` report with provenance and
confidence annotations. Mirrors the MT4G CLI behavior: the whole suite by
default, an optional restriction to specific memory elements, and timing of
each benchmark family (paper §V-A reports per-family run times).

The center of this module is the **unified, runner-agnostic core**
``discover(request)``: one implementation of request descriptors and
content-addressed store read-/write-through, sample-cache preload, engine
invocation, and topology assembly, shared by every backend.  The public
entry points are thin wrappers that only say what is genuinely
backend-specific:

* ``discover_sim``  — a ``SimRunner`` over a virtual device with known
  ground truth (the validation backend);
* ``discover_host`` — real measurements of this machine's CPU through a
  custom work-item plan (the hierarchy has one probeable space, so it
  skips the registry); the one entry point that touches no card;
* ``discover_cuda`` — the ``CudaRunner``: hand-written CUDA C++ probe
  kernels (``repro_torch.kernels``) on the card, timed end-to-end
  against a configured ground-truth hierarchy.  Like the reference
  package's ``discover_pallas`` it plans its sweeps (``SweepBudget()``)
  and fuses probe rounds across families by default.

A fourth path, ``discover_sim_legacy`` (also ``discover_sim(engine=False)``)
keeps the paper-faithful sequential loop: one probe at a time, exactly as
the paper's tool runs them — the reference implementation the engine is
held to.

Engine and legacy results are identical for simulated devices because those
runners key every sample stream by the request itself
(``simulate._KeyedSampler``): scheduling, batching, and caching change when
samples are drawn, never what is drawn.

The same wrappers also back the remote write path: ``serve/jobs.py``
parses a wire-format request into the identical descriptor (so the job's
content-addressed key equals the store key the run persists under) and
invokes these functions server-side from ``POST /discoveries``.

Fault tolerance (``resilience``: retry, graceful degradation, and on the
sim backend checkpoint write-through and resume) and the worker-process
pool (``parallel``) work as in the reference package.  Only transient
runner errors are retried or degraded: a build, launch or CUDA error from
a kernel propagates.  The CUDA backend neither checkpoints (its samples
are measured, not replayable) nor pools (its runner publishes no
``RunnerSpec``, so it stays inline under ``parallel``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from .catalog import HardwareSpec
from .errors import DegradedResult
from .probes.amount import (align_segments, find_amount, find_cu_sharing,
                            find_sharing)
from .probes.bandwidth import measure_bandwidth
from .probes.latency import measure_latency
from .probes.linesize import find_fetch_granularity, find_line_size
from .probes.runners import HostRunner, SimRunner
from .probes.size import find_size
from .topology import (PROVENANCE_API, PROVENANCE_BENCHMARK,
                       PROVENANCE_DEGRADED, ComputeElement, MemoryElement,
                       Topology)

__all__ = ["DiscoveryTimings", "DiscoveryRequest", "discover",
           "discover_sim", "discover_sim_legacy", "discover_host",
           "discover_cuda", "default_sweep_budget", "sim_request_descriptor",
           "host_request_descriptor", "cuda_request_descriptor",
           "spec_from_topology"]

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
# Request descriptors (content addresses for the TopologyStore)
# --------------------------------------------------------------------------
def default_sweep_budget():
    """Default sweep budget of the backends that plan adaptively out of the
    box (CUDA).  Exposed so request descriptors computed by callers
    (e.g. ``serve/jobs.py``) match the ones discovery uses internally."""
    from .engine.planner import SweepBudget

    return SweepBudget()


_DEFAULT_BUDGET = object()       # sentinel: "the backend's default budget"


def _budget_descriptor(budget) -> dict | None:
    return None if budget is None else budget.descriptor()


def sim_request_descriptor(device, n_samples: int,
                           elements: list[str] | None, budget=None,
                           survey: bool = False, resilience=None) -> dict:
    """Everything that determines a ``discover_sim`` result — and nothing
    that does not.  Worker count, engine-vs-legacy, batching, fusion and
    the process pool are excluded: request-keyed sample streams make them
    result-invisible, so the key addresses that equivalence class.  A
    ``budget`` IS part of the key (planned confidence metrics come from a
    window, not the full series); ``budget=None`` keys as a dense request.
    A ``resilience`` policy keys in only through its statistical knobs
    (``Resilience.descriptor_entry``): retry/backoff settings never change
    what a clean run measures, so a resilient rerun of a clean request is
    a pure store hit.  Equal to the reference package's descriptor of the
    same request, so both packages address one store alike."""
    d = {
        "kind": "discover_sim",
        "backend": f"simulated:{device.name}",
        "device": device.name,
        "vendor": device.vendor,
        "seed": device.seed,
        "n_samples": int(n_samples),
        "elements": sorted(elements) if elements else None,
    }
    if budget is not None:
        d["budget"] = _budget_descriptor(budget)
    res_entry = None if resilience is None else resilience.descriptor_entry()
    if res_entry is not None:
        d["resilience"] = res_entry
    if survey:
        # Survey results are spot-check-verified copies, not full measures —
        # they must never collide with a full run's key.  Only present when
        # on, so pre-survey stores keep their keys.
        d["survey"] = True
    return d


def host_request_descriptor(max_bytes: int, n_samples: int,
                            quick: bool) -> dict:
    """Content address of a ``discover_host`` request: sweep ceiling,
    sample count, and the quick-mode flag are all that shape the result
    (the host hierarchy itself has one probeable space).  Equal to the
    reference package's descriptor of the same request."""
    return {"kind": "discover_host", "max_bytes": int(max_bytes),
            "n_samples": int(n_samples), "quick": bool(quick)}


def cuda_request_descriptor(model, n_samples: int,
                            elements: list[str] | None,
                            budget=_DEFAULT_BUDGET,
                            survey: bool = False, resilience=None) -> dict:
    """Content address of a ``discover_cuda`` request: model identity +
    seed + sample count + element restriction + sweep budget, laid out like
    the reference package's Pallas descriptor, so CUDA topologies are
    stored and served through the same ``TopologyStore`` machinery as sim
    ones.  Measured values vary run to run (real timings); the *request* is
    what is addressed.  The budget defaults to the backend's default
    (``SweepBudget()``), matching ``discover_cuda``.  ``resilience`` keys
    in only through ``Resilience.descriptor_entry`` (statistical knobs),
    exactly as on the sim descriptor."""
    if budget is _DEFAULT_BUDGET:
        budget = default_sweep_budget()
    d = {
        "kind": "discover_cuda",
        "backend": f"cuda:{model.name}",
        "model": model.name,
        "vendor": model.vendor,
        "seed": model.seed,
        "n_samples": int(n_samples),
        "elements": sorted(elements) if elements else None,
        "budget": _budget_descriptor(budget),
    }
    res_entry = None if resilience is None else resilience.descriptor_entry()
    if res_entry is not None:
        d["resilience"] = res_entry
    if survey:
        d["survey"] = True      # keyed apart from full runs (see sim twin)
    return d


# --------------------------------------------------------------------------
# Store read-through: hit/persist helpers (shared by every backend)
# --------------------------------------------------------------------------
def _store_lookup(store, descriptor: dict):
    """(key, stored-result-or-None): a hit reconstructs the timings the
    original run recorded, so callers see the same (topo, timings) shape."""
    from .engine.store import request_key

    key = request_key(descriptor)
    entry = store.get(key)
    if entry is None:
        return key, None
    timings = DiscoveryTimings()
    timings.per_family.update(entry.meta.get("timings", {}))
    return key, (entry.topology, timings)


def _store_persist(store, key: str, descriptor: dict, topo: Topology,
                   timings: DiscoveryTimings, cache=None) -> None:
    """Write the topology + sample cache as one locked transaction, so a
    concurrent discovery on the same store cannot interleave a topology
    from one run with samples from another."""
    with store.lock():
        store.put(key, topo, meta={"request": descriptor,
                                   "timings": dict(timings.per_family)})
        if cache is not None and len(cache):
            store.put_samples(key, cache.snapshot())


# --------------------------------------------------------------------------
# Fleet survey mode: verify a sibling topology with a spot-check subset
# --------------------------------------------------------------------------
def _survey_spot_check(runner, topo, request) -> bool:
    """Planned spot-check: does this device match a sibling's topology?

    Probes a few decisive rows per discrete attribute instead of running
    the full sweeps — boundary straddles for sizes (margins from
    ``budget.target_resolution``), the classification flip for fetch
    granularity, two §IV-E score rows for core-scope line sizes, and one
    eviction row per §IV-F/§IV-G/§IV-H family.  Latency/bandwidth floats
    are NOT verified (they are measurements, not discrete attributes — a
    surveyed entry reports the sibling's).  Returns False on ANY
    disagreement; the caller then runs the full discovery, so a spot-check
    can only trade a failed shortcut for a full measure, never accuracy.
    """
    from .probes.amount import _hit_miss_refs, _is_miss, amount_ladder
    from .probes.linesize import granularity_refs, hit_scores
    from .probes.size import ShiftClassifier, classification_jump

    n_samples = request.n_samples
    tr = int(getattr(request.budget, "target_resolution", None) or 0)
    infos = {i.name: i for i in runner.spaces()}
    api_size = getattr(runner, "api_size", lambda _s: None)

    for me in topo.memory:
        info = infos.get(me.name)
        if info is None:
            if me.name in ("DeviceMemory", "DRAM"):
                continue            # float-only elements: nothing discrete
            return False            # sibling claims a space we cannot see
        size = me.get("size")
        if size:
            if info.scope == "chip":
                # chip totals are API-reported: a free exact comparison
                if api_size(me.name) != size:
                    return False
            else:
                # two rows straddling the capacity boundary must classify
                # unshifted below / shifted above, vs the dense base row
                step = 4 if info.kind == "scratchpad" else 32
                margin = max(tr, int(size) // 16, 8 * step)
                base = runner.pchase(me.name, 1 * KIB, step, n_samples)
                clf = ShiftClassifier(base, 0.01, classification_jump(runner))
                if clf.shifted(runner.pchase(me.name, int(size) - margin,
                                             step, n_samples)):
                    return False
                if not clf.shifted(runner.pchase(me.name, int(size) + margin,
                                                 step, n_samples)):
                    return False

        g = me.get("fetch_granularity")
        if g and info.supports_cold:
            # the stored granularity must be the §IV-D classification flip:
            # all-miss at g, still mixing hits one grid notch below
            _h, _m, thresh, hit_med, miss_med = granularity_refs(
                runner, me.name, 64 * KIB, 512, n_samples, 4)
            if miss_med < hit_med * 1.5:
                return False
            n_loads = 16 * n_samples
            min_frac = max(0.005, 2.0 / n_loads)

            def mixed(s: int) -> bool:
                arr = max(64 * KIB, s * (n_loads + 1))
                row = np.asarray(runner.cold_chase(me.name, arr, s, n_loads))
                return float(np.mean(row < thresh)) > min_frac

            if mixed(int(g)):
                return False
            if int(g) > 4 and not mixed(int(g) - 4):
                return False

        line = me.get("line_size")
        if line and size and g and info.supports_cold \
                and info.scope != "chip":
            # two §IV-E score rows bracketing the stored line's transition
            # (chip-scope lines are skipped: their sweeps are keyed on the
            # measured segment, which a survey does not re-derive)
            g2 = max(int(g) // 2, 4)
            arr = int(int(size) * 1.0625)
            pivot = runner.pchase(me.name, arr, g2, n_samples)
            href = runner.pchase(me.name, arr, 1024 * 8, n_samples)
            hi = runner.pchase(me.name, arr, 2 * int(line), n_samples)
            if float(hit_scores(hi, pivot, href)[0]) <= 0:
                return False
            if int(line) >= 8 * g2:
                lo = runner.pchase(me.name, arr, int(line) // 4, n_samples)
                if float(hit_scores(lo, pivot, href)[0]) > 0:
                    return False

        am = me.get("amount")
        if am and info.supports_amount and size:
            # one §IV-F eviction row at the stored boundary rung (plus its
            # evicting predecessor when the ladder has one)
            cores = runner.cores_per_sm
            arr = int(int(size) * 0.9)
            h_ref, m_ref = _hit_miss_refs(runner, me.name, arr, int(size),
                                          n_samples)
            ladder = amount_ladder(cores)
            if not ladder:
                pass
            elif int(am) <= 1:
                # amount 1 = even the largest rung still evicted
                row = runner.amount_probe(me.name, 0, ladder[-1], arr,
                                          n_samples)
                if not _is_miss(row, h_ref, m_ref):
                    return False
            else:
                b_star = max(cores // int(am), 1)
                row = runner.amount_probe(me.name, 0, b_star, arr, n_samples)
                if _is_miss(row, h_ref, m_ref):
                    return False
                if b_star >= 2:
                    row = runner.amount_probe(me.name, 0, b_star // 2, arr,
                                              n_samples)
                    if not _is_miss(row, h_ref, m_ref):
                        return False

    # ---- one §IV-G sharing row for the first name-sharing leader pair
    def _cu_grouped(name: str) -> bool:
        el = topo.find_memory(name)
        return el is not None and el.get("exclusive_cus") is not None

    ss = [i.name for i in runner.spaces()
          if i.supports_sharing and i.scope == "core"
          and not _cu_grouped(i.name)]
    if len(ss) >= 2:
        ea = topo.find_memory(ss[0])
        if ea is not None and ea.get("size") \
                and topo.find_memory(ss[1]) is not None:
            expected = ss[1] in ea.shared_with
            res = find_sharing(runner, ss[0], ss[1], int(ea.get("size")),
                               n_samples=n_samples)
            if res.shared != expected:
                return False

    # ---- one §IV-H row inside the first CU group + one across groups
    sl1d = topo.find_memory(request.cu_space)
    if sl1d is not None and sl1d.get("exclusive_cus") is not None \
            and sl1d.get("size"):
        groups = [tuple(int(x) for x in s.split(","))
                  for s in sl1d.shared_with]
        cu_ns = max(n_samples // 2, 9)
        size = int(sl1d.get("size"))
        arr = int(size * 0.9)
        h_ref, m_ref = _hit_miss_refs(runner, request.cu_space, arr, size,
                                      cu_ns)
        if groups:
            a, b = groups[0][0], groups[0][1]
            row = runner.cu_sharing_probe(a, b, arr, cu_ns,
                                          space=request.cu_space)
            if not _is_miss(row, h_ref, m_ref):
                return False
            other = (groups[1][0] if len(groups) > 1 else
                     (sl1d.get("exclusive_cus") or [None])[0])
            if other is not None:
                row = runner.cu_sharing_probe(a, int(other), arr, cu_ns,
                                              space=request.cu_space)
                if _is_miss(row, h_ref, m_ref):
                    return False
    return True


def _survey_discovery(request: DiscoveryRequest, store, key: str):
    """Serve a survey request from a verified sibling, or None to go full.

    Picks the newest stored entry with the same vendor/model/backend whose
    provenance is a real measure (surveys never chain off surveys), spot
    checks it against this request's runner, and on agreement persists the
    sibling's topology under THIS request's key with ``survey`` provenance
    and the reference key in the meta — auditable, and an ordinary store
    hit for every later lookup of the same request.
    """
    ref = None
    for entry in store.find(model=request.model, vendor=request.vendor,
                            backend=request.backend):
        if entry.key != key and entry.meta.get("provenance") != "survey":
            ref = entry
            break
    if ref is None:
        return None
    from .engine import SampleCache
    from .engine.cache import CachingRunner

    timings = DiscoveryTimings()
    cached = CachingRunner(request.make_runner(), cache=SampleCache())
    with _Timer(timings, "survey"):
        ok = _survey_spot_check(cached, ref.topology, request)
    timings.meta["cache"] = cached.cache.stats()
    timings.meta["survey"] = {"reference": ref.key, "verified": bool(ok)}
    if not ok:
        return None
    with store.lock():
        store.put(key, ref.topology,
                  meta={"request": request.descriptor,
                        "timings": dict(timings.per_family),
                        "provenance": "survey", "survey_of": ref.key})
    return ref.topology, timings


# --------------------------------------------------------------------------
# The unified runner-agnostic core
# --------------------------------------------------------------------------
@dataclass
class DiscoveryRequest:
    """One backend's worth of 'what is different': identity, runner, plan.

    Everything else — store lookup/persist, timings, sample-cache preload,
    engine invocation, topology assembly — is the shared ``discover()``
    implementation.  Registry-driven backends (sim, cuda) leave ``plan``
    unset and get the full (space x family) engine; backends with a bespoke
    probe set (host) provide a ``plan`` building scheduler work items and
    an ``assemble`` turning the schedule result into a ``Topology``.
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
    # Preloading persisted samples re-serves *recorded* probe rows.  That is
    # sound only for runners whose sample streams are request-keyed (sim);
    # measuring backends (host, cuda) must re-measure instead.
    preload_samples: bool = True
    # Fault-tolerance policy (errors.Resilience): per-item transient retry
    # with graceful degradation, plus — with a store and preloadable
    # samples — periodic checkpointing so an interrupted discovery resumes
    # without re-probing persisted rows.  The policy's statistical knobs
    # must already be reflected in ``descriptor`` (the wrappers handle
    # this); retry knobs deliberately are not (they never change what a
    # clean run measures).
    resilience: object | None = None
    # Multiprocess probe execution (engine/parallel.ParallelConfig): shard
    # the batched capability calls across the persistent worker-process
    # pool.  Deliberately EXCLUDED from the request descriptor — pooled
    # and inline runs are bit-identical (request-keyed sampling), so they
    # must share a content address.  Runners without a RunnerSpec (the
    # CudaRunner, and boxes under the effective-core floor) stay inline.
    parallel: object | None = None
    # Adaptive sweep planning (engine/planner.SweepBudget): None keeps the
    # dense sweeps — the equivalence oracle.  The budget must already be
    # reflected in ``descriptor`` (the wrappers handle this).
    budget: object | None = None
    # Cross-family batch fusion (engine/fusion.py): coalesce concurrently
    # ready probe rounds into single batched dispatches.  Kernel execution
    # stays serial, so it composes with timing-sensitive backends.
    fuse: bool = False
    # Fleet survey mode: instead of a full discovery, verify a stored
    # sibling topology (same vendor/model/backend, full provenance) with a
    # planned spot-check subset of probe rows and write it through under
    # THIS request's key with ``survey`` provenance.  Any mismatch — or no
    # usable sibling — silently degrades to the full discovery, so a survey
    # can be slower but never wrong.  Requires a ``store``.
    survey: bool = False
    plan: Callable[[object], list] | None = None
    assemble: Callable[[object, DiscoveryTimings], Topology] | None = None


def discover(request: DiscoveryRequest, *, store=None, refresh: bool = False,
             gc_policy=None) -> tuple[Topology, DiscoveryTimings]:
    """Run one discovery request end to end (the backend-neutral core).

    ``store`` (a ``TopologyStore``) makes discovery read-through/write-
    through persistent: a stored result for the same content-addressed
    request is returned without issuing a single runner probe, and a fresh
    run persists both the topology and the engine's sample cache.
    ``refresh=True`` skips the read (re-measures) but still writes through.

    ``gc_policy`` (a ``store.GcPolicy``) opts the write path into a
    retention sweep: after persisting, the oldest entries beyond the
    policy's ceilings are evicted (topology + samples pairs, under the
    store lock).  Ignored without a ``store``.
    """
    from .engine import SampleCache, run_probes
    from .engine.cache import CachingRunner
    from .engine.scheduler import run_work_items

    key = None
    if store is not None:
        if not refresh:
            key, hit = _store_lookup(store, request.descriptor)
            if hit is not None:
                return hit
        else:
            from .engine.store import request_key
            key = request_key(request.descriptor)

    if request.survey and store is not None:
        surveyed = _survey_discovery(request, store, key)
        if surveyed is not None:
            return surveyed
        # no usable sibling / spot-check mismatch: full discovery below

    timings = DiscoveryTimings()
    cache = SampleCache()
    if store is not None and not refresh and request.preload_samples:
        # Partial-recovery path: a quarantined topology with intact samples
        # re-assembles from disk-served probe rows instead of re-measuring.
        # Never under refresh=True — that contract is a real re-measure.
        persisted = store.load_samples(key)
        if persisted:
            cache.preload(persisted)
        elif request.resilience is not None:
            # Resume path: an interrupted resilient discovery left a
            # checkpoint (sample cache + completed families) instead of a
            # final topology.  Preloading it re-serves every persisted
            # probe row from disk, so the rerun re-probes zero of them.
            ckpt = store.load_checkpoint(key)
            if ckpt is not None:
                entries, families = ckpt
                cache.preload(entries)
                timings.meta["resume"] = {"rows": len(entries),
                                          "families_done": len(families)}

    runner = request.make_runner()
    checkpoint = None
    if (store is not None and request.resilience is not None
            and request.preload_samples):
        # Checkpoint write-through: after each completed work item, persist
        # the sample cache + completed-item manifest under the request key.
        # Gated on ``preload_samples`` because resume re-serves recorded
        # rows — only sound for request-keyed (replayable) runners, so a
        # CUDA discovery never checkpoints.
        done_items: list[str] = []

        def checkpoint(item_key):
            # Engine items are keyed (space, family); a plan's may be a
            # plain string, which is its own name (the reference package
            # joins its characters).
            done_items.append(item_key if isinstance(item_key, str)
                              else "/".join(map(str, item_key)))
            store.put_checkpoint(key, cache.snapshot(), done_items)

    if request.plan is None:
        eng = run_probes(runner, n_samples=request.n_samples,
                         elements=request.elements,
                         device_families=request.device_families,
                         max_workers=request.max_workers, timings=timings,
                         cache=cache, budget=request.budget,
                         fuse=request.fuse, resilience=request.resilience,
                         checkpoint=checkpoint, parallel=request.parallel)
        timings.meta["cache"] = eng.cache_stats
        timings.meta["planned"] = request.budget is not None
        if eng.fusion is not None:
            timings.meta["fusion"] = eng.fusion
        if eng.degraded or eng.retries:
            timings.meta["resilience"] = {
                "retries": eng.retries,
                "degraded": [d.key for d in eng.degraded]}
        topo = _assemble_engine_topology(request, runner, eng, timings)
    else:
        from .engine.parallel import maybe_parallel_runner

        cached = CachingRunner(
            maybe_parallel_runner(runner, request.parallel), cache=cache)
        sched = run_work_items(request.plan(cached),
                               max_workers=request.max_workers,
                               timings=timings,
                               resilience=request.resilience,
                               on_item_done=checkpoint,
                               parallel=request.parallel)
        timings.meta["cache"] = cached.cache.stats()
        topo = request.assemble(sched, timings)

    if store is not None:
        _store_persist(store, key, request.descriptor, topo, timings,
                       cache=cache)
        if checkpoint is not None:
            # The run completed and persisted: its checkpoint is spent.
            store.clear_checkpoint(key)
        if gc_policy is not None:
            store.gc(max_entries=gc_policy.max_entries,
                     max_age_s=gc_policy.max_age_s)
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
                 engine: bool = True, max_workers: int | None = None,
                 store=None, refresh: bool = False, budget=None,
                 fuse: bool = False, gc_policy=None, survey: bool = False,
                 resilience=None, parallel=None,
                 ) -> tuple[Topology, DiscoveryTimings]:
    """Full MT4G-style discovery of a simulated device.

    ``engine=True`` (default) routes through the unified core and the
    batched probe engine; ``engine=False`` runs the legacy sequential loop.
    Both produce the same topology for a fixed device seed, bit-identical
    to the reference package's ``discover_sim`` of the same request.
    ``store`` / ``refresh`` / ``gc_policy`` behave as documented on
    ``discover()``.

    ``budget`` (a ``SweepBudget``) turns on the adaptive sweep planner —
    identical discrete attributes, confidence metrics from a boundary
    window instead of the full sweep series, ~3-5x fewer probed rows.
    The default stays dense: the sim backend is the validation oracle.
    ``fuse=True`` coalesces concurrently ready probe rounds into single
    batched dispatches.

    ``survey=True`` (fleet survey mode, needs a ``store``) verifies a
    stored sibling topology with a planned spot-check subset instead of a
    full discovery, writing it through under this request's key with
    ``survey`` provenance; see ``DiscoveryRequest.survey``.

    ``resilience`` (an ``errors.Resilience``) turns on fault tolerance:
    transient probe failures are retried with capped backoff, families past
    the budget degrade to ``"unknown"`` attributes instead of aborting,
    and — with a ``store`` — the run checkpoints after every completed
    work item so an interrupted discovery resumes without re-probing.

    ``parallel`` (an ``engine.parallel.ParallelConfig``) shards batched
    probe calls across the persistent worker-process pool — bit-identical
    results (request-keyed sampling), so it shares the inline run's store
    key; it is pure wall-clock, like ``fuse``.
    """
    descriptor = sim_request_descriptor(device, n_samples, elements, budget,
                                        survey=survey, resilience=resilience)

    if not engine:
        key = None
        if store is not None:
            if not refresh:
                key, hit = _store_lookup(store, descriptor)
                if hit is not None:
                    return hit
            else:
                from .engine.store import request_key
                key = request_key(descriptor)
        topo, timings = discover_sim_legacy(device, n_samples, elements)
        if store is not None:
            _store_persist(store, key, descriptor, topo, timings)
        return topo, timings

    request = DiscoveryRequest(
        descriptor=descriptor,
        vendor=device.vendor, model=device.name,
        backend=f"simulated:{device.name}",
        make_runner=lambda: SimRunner(device),
        n_samples=n_samples, elements=elements,
        device_families=_device_families(device, elements),
        max_workers=max_workers,
        preload_samples=True,           # request-keyed streams: sound
        budget=budget, fuse=fuse, survey=survey, resilience=resilience,
        parallel=parallel,
    )
    return discover(request, store=store, refresh=refresh,
                    gc_policy=gc_policy)


def discover_cuda(model=None, n_samples: int = 9,
                  elements: list[str] | None = None, *,
                  runner=None, device: str = "cuda",
                  max_workers: int | None = 0, store=None,
                  refresh: bool = False, budget=_DEFAULT_BUDGET,
                  fuse: bool = True, gc_policy=None, survey: bool = False,
                  resilience=None, parallel=None,
                  ) -> tuple[Topology, DiscoveryTimings]:
    """Discovery through the hand-written probe kernels on the card.

    Same engine, same registry, same statistics as ``discover_sim`` — the
    runner is the only moving part.  ``model`` is the configured
    ground-truth hierarchy (default ``make_cuda_model()``); pass ``runner``
    to reuse a warmed ``CudaRunner`` (built kernels, warmed launch shapes)
    across discoveries, in which case its device is used, and its model
    unless ``model`` is given (a wrapping runner such as ``ChaosRunner``
    carries none).  ``device="cpu"`` runs the kernels' plain PyTorch
    versions instead, for tests.

    Kernel launches are this backend's cost, so it defaults to the
    probe-volume optimizers, as the reference package's ``discover_pallas``
    does: the adaptive sweep planner (``budget=SweepBudget()``; pass
    ``budget=None`` for dense sweeps) and cross-family batch fusion
    (``fuse=True``), which coalesces every concurrently ready probe round
    onto one grid launch.  Fused rounds are executed serially by the
    coordinator, and unfused ones inline (``max_workers=0``), so no two
    timed launches ever overlap.  Persisted samples are never preloaded (a
    re-measure is a re-measure).  Topologies are content-addressed in the
    ``TopologyStore`` by ``cuda_request_descriptor``; ``store``,
    ``refresh``, ``gc_policy`` and ``survey`` behave as on
    ``discover_sim``.

    ``resilience`` retries a probe that raised ``TransientRunnerError``
    and degrades a family past the budget, as on ``discover_sim``; every
    other error (a kernel that does not build or launch, a CUDA error)
    propagates.  A CUDA discovery never checkpoints: its samples are
    measured, so a resume could not re-serve them.  ``parallel`` is
    accepted as on ``discover_sim`` and changes nothing: the
    ``CudaRunner`` publishes no ``RunnerSpec`` (built kernels and a CUDA
    context do not cross a process boundary, and timed launches must not
    overlap), so execution stays inline and no worker is spawned.
    """
    from .probes.cuda_runner import CudaRunner, make_cuda_model

    if budget is _DEFAULT_BUDGET:
        budget = default_sweep_budget()
    if model is None:
        model = runner.model if runner is not None else make_cuda_model()
    request = DiscoveryRequest(
        descriptor=cuda_request_descriptor(model, n_samples, elements,
                                           budget, survey=survey,
                                           resilience=resilience),
        vendor=model.vendor, model=model.name,
        backend=f"cuda:{model.name}",
        make_runner=(lambda: runner) if runner is not None
        else (lambda: CudaRunner(model, device=device)),
        n_samples=n_samples, elements=elements,
        device_families=_device_families(model, elements),
        max_workers=max_workers,
        clock_domain="model-cycles",    # chain-length units, timed end-to-end
        preload_samples=False,          # real measurements: always re-measure
        budget=budget, fuse=fuse, survey=survey, resilience=resilience,
        parallel=parallel,
    )
    return discover(request, store=store, refresh=refresh,
                    gc_policy=gc_policy)


# --------------------------------------------------------------------------
# Backend wrappers: this machine's CPU hierarchy
# --------------------------------------------------------------------------
def discover_host(max_bytes: int = 128 * 1024**2, n_samples: int = 9,
                  quick: bool = True, *, store=None, refresh: bool = False,
                  gc_policy=None, parallel=None
                  ) -> tuple[Topology, DiscoveryTimings]:
    """Live discovery of this machine's CPU hierarchy (real measurements).

    It measures the host by definition: the one entry point of the port
    that touches no card and no CUDA.  The chase is a small C loop built
    by the host compiler at first use (``probes/host_chase.py``); a missing
    compiler raises.

    The host hierarchy has one probeable space, so instead of the registry
    it hands the unified core a small custom work-item plan (size ∥
    latencies ∥ bandwidths, all independent on real hardware) — sharing the
    same store, caching, scheduling, and timing machinery as the other
    backends.  ``store`` works as in ``discover()`` — host measurements are
    slow and real, so serving a prior run of the same request from the
    store is the common production path; ``refresh=True`` forces a
    re-measure.  ``parallel`` shards the size sweep's batched rows across
    the worker-process pool (each worker rebuilds the runner from its
    ``RunnerSpec``); pooled rows are real measurements too, so they are
    statistically, not bit-for-bit, the inline rows.
    """
    from .engine import WorkItem

    def plan(runner):
        return [
            WorkItem(key="size", family="size", fn=lambda _r: find_size(
                runner, "host-cache", lo=8 * KIB, step=4 * KIB,
                n_samples=n_samples, max_bytes=max_bytes, max_points=24,
                max_widenings=1, batched=True)),
            WorkItem(key="lat_small", family="latency", fn=lambda _r:
                     measure_latency(runner, "host-cache",
                                     fetch_granularity=64,
                                     n_samples=n_samples, array_factor=256)),
            WorkItem(key="lat_big", family="latency", fn=lambda _r:
                     measure_latency(runner, "host-cache",
                                     fetch_granularity=4096,
                                     n_samples=n_samples,
                                     array_factor=max_bytes // 4096 // 2)),
            WorkItem(key="bw_read", family="bandwidth",
                     fn=lambda _r: runner.bandwidth("DRAM", "read")),
            WorkItem(key="bw_write", family="bandwidth",
                     fn=lambda _r: runner.bandwidth("DRAM", "write")),
        ]

    def assemble(sched, timings):
        topo = Topology(vendor="host", model="cpu", backend="cpu")
        me = MemoryElement("host-cache", "cache", "host")
        sr = sched.results["size"]
        if sr.found:
            me.set("size", sr.size, "B", PROVENANCE_BENCHMARK, sr.confidence)
        me.set("load_latency", round(sched.results["lat_small"].mean, 2),
               "ns", PROVENANCE_BENCHMARK)
        topo.memory.append(me)

        dram = MemoryElement("DRAM", "memory", "host")
        dram.set("load_latency", round(sched.results["lat_big"].mean, 2),
                 "ns", PROVENANCE_BENCHMARK)
        dram.set("read_bw", round(sched.results["bw_read"] / 1e9, 2), "GB/s",
                 PROVENANCE_BENCHMARK)
        dram.set("write_bw", round(sched.results["bw_write"] / 1e9, 2),
                 "GB/s", PROVENANCE_BENCHMARK)
        topo.memory.append(dram)
        # The reference package's note, word for word: a host topology reads
        # the same from either package.
        topo.notes.append("host runner: per-sample = mean ns/load of a "
                          "jitted dependent chase (DESIGN.md adaptation "
                          "note 1)")
        return topo

    request = DiscoveryRequest(
        descriptor=host_request_descriptor(max_bytes, n_samples, quick),
        vendor="host", model="cpu", backend="cpu",
        make_runner=lambda: HostRunner(
            max_bytes=max_bytes, iters=1 << 14 if quick else 1 << 16),
        n_samples=n_samples,
        # Real measurements are perturbed by co-running probes: keep the
        # host schedule serial so timings stay trustworthy — the engine's
        # value here is the shared orchestration, not parallelism.
        max_workers=1,
        preload_samples=False,          # real measurements: always re-measure
        plan=plan, assemble=assemble, parallel=parallel,
    )
    return discover(request, store=store, refresh=refresh,
                    gc_policy=gc_policy)


# --------------------------------------------------------------------------
# Legacy sequential discovery (reference implementation + benchmark baseline)
# --------------------------------------------------------------------------
def discover_sim_legacy(device, n_samples: int = 33,
                        elements: list[str] | None = None
                        ) -> tuple[Topology, DiscoveryTimings]:
    """The paper-faithful sequential loop: one probe family at a time."""
    runner = SimRunner(device)
    topo = Topology(vendor=device.vendor, model=device.name,
                    backend=f"simulated:{device.name}")
    timings = DiscoveryTimings()

    topo.set_general("clock_domain", "cycles", provenance=PROVENANCE_API)
    topo.compute.append(ComputeElement("cores_per_sm", device.cores_per_sm))

    for info in runner.spaces():
        if elements and info.name not in elements:
            continue
        lvl = device.level(info.name)
        me = MemoryElement(info.name, info.kind, info.scope)

        # ---- size (benchmark; scratchpads would be API on real hardware).
        # Scratchpads are word-granular: probe them at 4 B steps, caches at
        # the 32 B default until the cold-pass granularity is known (§IV-D).
        step0 = 4 if info.kind == "scratchpad" else 32
        with _Timer(timings, "size"):
            sr = find_size(runner, info.name, lo=1 * KIB, step=step0,
                           n_samples=n_samples, max_bytes=info.max_bytes)
        if sr.found:
            if info.scope == "chip":
                # Paper Table I: L2-style totals come from the API; the
                # benchmark contributes the per-core segment size (§IV-F.1).
                me.set("size", lvl.size, "B", PROVENANCE_API)
            else:
                me.set("size", sr.size, "B", PROVENANCE_BENCHMARK, sr.confidence)
                if not sr.cusum_agrees:
                    topo.notes.append(
                        f"{info.name}: CUSUM cross-check disagrees with the "
                        f"K-S change point — size result is suspect")

        # ---- fetch granularity (cold-pass; caches only)
        fetch = 32
        if info.supports_cold:
            with _Timer(timings, "fetch_granularity"):
                gr = find_fetch_granularity(runner, info.name,
                                            n_samples=n_samples)
            if gr.found:
                fetch = gr.granularity
                me.set("fetch_granularity", gr.granularity, "B",
                       PROVENANCE_BENCHMARK, 1.0)

        # ---- load latency (p50 headline: robust to the rare large
        # outliers the K-S machinery is built to absorb — the mean is kept
        # as a secondary stat, cf. paper §IV-C's statistics set)
        # Small caches: keep the fixed-size latency array inside capacity
        # (paper §IV-C uses 256 x granularity; a 2 KiB constant cache needs
        # a smaller factor).
        factor = 256
        if sr.found:
            factor = max(min(256, sr.size // (2 * fetch)), 8)
        with _Timer(timings, "latency"):
            lat = measure_latency(runner, info.name, fetch_granularity=fetch,
                                  n_samples=n_samples * 4 + 1,
                                  array_factor=factor)
        me.set("load_latency", round(lat.p50, 1), "cyc", PROVENANCE_BENCHMARK)
        me.set("load_latency_mean", round(lat.mean, 1), "cyc",
               PROVENANCE_BENCHMARK)
        me.set("load_latency_p95", round(lat.p95, 1), "cyc", PROVENANCE_BENCHMARK)

        # ---- cache line size
        if info.supports_cold and sr.found:
            with _Timer(timings, "line_size"):
                ls = find_line_size(runner, info.name, sr.size, fetch,
                                    n_samples=n_samples)
            if ls.found:
                me.set("line_size", ls.line_size, "B", PROVENANCE_BENCHMARK, 1.0)

        # ---- amount per SM / per GPU
        if info.supports_amount and sr.found:
            with _Timer(timings, "amount"):
                am = find_amount(runner, info.name, sr.size,
                                 runner.cores_per_sm, n_samples=n_samples)
            if am.found:
                me.set("amount", am.amount, "", PROVENANCE_BENCHMARK, 1.0)
        elif info.scope == "chip" and sr.found:
            # L2-style: align measured segment to the API-reported total.
            with _Timer(timings, "amount"):
                k, aligned, conf = align_segments(lvl.size, sr.size)
            me.set("amount", k, "", PROVENANCE_BENCHMARK, conf)
            me.set("segment_size", aligned, "B", PROVENANCE_BENCHMARK, conf)

        # ---- bandwidth: higher-level caches + device memory only (Table I †)
        if info.scope == "chip" or info.kind == "memory":
            with _Timer(timings, "bandwidth"):
                bw = measure_bandwidth(runner, info.name)
            me.set("read_bw", round(bw.read_bw / 1e9, 1), "GB/s",
                   PROVENANCE_BENCHMARK)
            me.set("write_bw", round(bw.write_bw / 1e9, 1), "GB/s",
                   PROVENANCE_BENCHMARK)
        topo.memory.append(me)

    # ---- physical sharing between logical spaces (NVIDIA-style, §IV-G)
    cache_spaces = [i for i in runner.spaces()
                    if i.supports_sharing and i.scope == "core"
                    and (not elements or i.name in elements)]
    with _Timer(timings, "sharing"):
        for i, a in enumerate(cache_spaces):
            for b in cache_spaces[i + 1:]:
                size_a = topo.find_memory(a.name)
                size_a = size_a.get("size") if size_a else None
                if not size_a:
                    continue
                res = find_sharing(runner, a.name, b.name, size_a,
                                   n_samples=n_samples)
                if res.shared:
                    ma, mb = topo.find_memory(a.name), topo.find_memory(b.name)
                    if mb and mb.name not in ma.shared_with:
                        ma.shared_with.append(mb.name)
                    if ma and ma.name not in mb.shared_with:
                        mb.shared_with.append(ma.name)

    # ---- AMD-style CU<->sL1d sharing (§IV-H)
    if device.cu_share_groups and (not elements or "sL1d" in (elements or [])
                                   or elements is None):
        sl1d = topo.find_memory("sL1d")
        if sl1d and sl1d.get("size"):
            all_cus = sorted(cu for grp in device.cu_share_groups for cu in grp)
            with _Timer(timings, "cu_sharing"):
                cus = find_cu_sharing(runner, all_cus, sl1d.get("size"),
                                      n_samples=max(n_samples // 2, 9))
            sl1d.shared_with = [",".join(map(str, g)) for g in cus.groups
                                if len(g) > 1]
            sl1d.set("exclusive_cus", cus.exclusive, "", PROVENANCE_BENCHMARK)

    # ---- device memory
    dm = MemoryElement("DeviceMemory", "memory", "chip")
    with _Timer(timings, "latency"):
        lat = measure_latency(runner, "DeviceMemory", fetch_granularity=4096,
                              n_samples=n_samples * 4 + 1, array_factor=4096)
    dm.set("load_latency", round(lat.p50, 1), "cyc", PROVENANCE_BENCHMARK)
    with _Timer(timings, "bandwidth"):
        bw = measure_bandwidth(runner, "DeviceMemory")
    dm.set("read_bw", round(bw.read_bw / 1e9, 1), "GB/s", PROVENANCE_BENCHMARK)
    dm.set("write_bw", round(bw.write_bw / 1e9, 1), "GB/s", PROVENANCE_BENCHMARK)
    topo.memory.append(dm)

    topo.notes.append(f"discovery wall time: {timings.total:.2f}s "
                      f"({ {k: round(v, 2) for k, v in timings.per_family.items()} })")
    return topo, timings


def spec_from_topology(topo: Topology, base: HardwareSpec) -> HardwareSpec:
    """Overlay discovered values onto a catalog record (paper §VI-A usage:
    measured parameters feed the performance model)."""
    import dataclasses

    dm = topo.find_memory("DeviceMemory") or topo.find_memory("DRAM")
    updates = {}
    if dm is not None:
        if dm.get("read_bw"):
            updates["hbm_bandwidth"] = float(dm.get("read_bw")) * 1e9
        if dm.get("size"):
            updates["hbm_bytes"] = int(dm.get("size"))
    return dataclasses.replace(base, **updates) if updates else base
