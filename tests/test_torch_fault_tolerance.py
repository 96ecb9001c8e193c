"""The reference's fault-tolerant discovery suite, re-pointed at the port.

Every case of ``tests/test_fault_tolerance.py`` runs here against
``repro_torch`` unchanged (chaos -> retry -> degrade -> resume), followed
by cross-checks that hold the port to the reference package on the same
seeded requests: topologies, retries, degraded families, injected faults,
checkpoint contents and the resume arithmetic are equal in both, and
``request_key`` of a descriptor carrying a ``Resilience`` is bit-equal.

``TestCheckpointResume`` holds the reference's three cases to the same
contract on threads: ``make_request`` leaves ``max_workers=None``, so on a
box with more than three effective cores the scheduler runs the items on
threads, and which items finish before a kill, and which request
signature meets a fault first, follow the thread order.  The reference's
cases assume one order (an item done within 40 probe calls; the job done
within three attempts) and race; here the kill waits for the first
checkpoint when no item has finished by call 40, and the job engine has
the attempts that the faults of any order need, while every case still
checks that the rows persisted plus the rows probed on resume are the
clean run's misses, and that no persisted row is probed again (the keys
each cache stores from a probe).  On threads two items may probe one row
at once (the cache runs probes outside its lock); the cache counts the
later one as the hit it is in an inline run, so ``misses`` is the same
in any order.  ``TestCheckpointResumeInline`` runs the same three cases
with the scheduler inline (``max_workers=0``), where the order, and so
the result, is the same every run.
"""
import dataclasses
import functools
import sys

import numpy as np
import pytest

import repro.core as ref_core
from repro.core.discover import DiscoveryRequest as RefRequest
from repro.core.discover import discover as ref_discover
from repro.core.discover import pallas_request_descriptor
from repro.core.discover import sim_request_descriptor as ref_sim_descriptor
from repro.core.engine.store import TopologyStore as RefStore
from repro.core.engine.store import request_key as ref_request_key
from repro.core.errors import Resilience as RefResilience
from repro.core.probes import ChaosRunner as RefChaosRunner
from repro.core.probes import FaultSchedule as RefFaultSchedule
from repro.core.probes import SimRunner as RefSimRunner
from repro_torch.core import make_h100_like
from repro_torch.core.discover import (DiscoveryRequest,
                                       cuda_request_descriptor, discover,
                                       discover_cuda, discover_sim,
                                       sim_request_descriptor)
from repro_torch.core.engine.cache import CachingRunner, SampleCache
from repro_torch.core.engine.fusion import FusionDispatcher, run_fused
from repro_torch.core.engine.scheduler import WorkItem, run_work_items
from repro_torch.core.engine.store import TopologyStore, request_key
from repro_torch.core.errors import (DegradedResult, Resilience,
                                     TransientRunnerError)
from repro_torch.core.probes import ChaosRunner, FaultSchedule, SimRunner
from repro_torch.core.probes.size import ShiftClassifier, find_size
from repro_torch.core.stats import mad_gate
from repro_torch.core.topology import (PROVENANCE_DEGRADED,
                                       topology_equivalent)

KIB = 1024
DEVICE_FAMILIES = ("sharing", "device_memory_latency",
                   "device_memory_bandwidth")


def h100_runner():
    return SimRunner(make_h100_like(seed=3))


def no_sleep_resilience(**kw):
    kw.setdefault("max_retries", 3)
    return Resilience(sleep=lambda _s: None, **kw)


def make_request(make_runner, resilience, n_samples=9, max_workers=None):
    dev = make_h100_like(seed=3)
    return DiscoveryRequest(
        descriptor=sim_request_descriptor(dev, n_samples, None,
                                          resilience=resilience),
        vendor=dev.vendor, model=dev.name,
        backend=f"simulated:{dev.name}",
        make_runner=make_runner, n_samples=n_samples,
        device_families=DEVICE_FAMILIES, resilience=resilience,
        max_workers=max_workers)


# --------------------------------------------------------------------------
# Scheduler-level retry / degradation (synthetic work items)
# --------------------------------------------------------------------------
class TestSchedulerRetry:
    def _flaky_item(self, fail_times, key="a"):
        """A work item that raises TransientRunnerError ``fail_times`` times
        before returning; counts its invocations."""
        calls = {"n": 0}

        def fn(_results):
            calls["n"] += 1
            if calls["n"] <= fail_times:
                raise TransientRunnerError(f"flake #{calls['n']}")
            return f"{key}-ok"

        return WorkItem(key=key, fn=fn), calls

    @pytest.mark.parametrize("max_workers", [0, 2])
    def test_transient_retried_to_success(self, max_workers):
        it, calls = self._flaky_item(2)
        res = run_work_items([it], max_workers=max_workers,
                             resilience=no_sleep_resilience())
        assert res.results["a"] == "a-ok"
        assert calls["n"] == 3
        assert res.retries == 2
        assert res.degraded == []

    def test_backoff_schedule_capped(self):
        sleeps = []
        policy = Resilience(max_retries=4, backoff_base_s=1.0,
                            backoff_cap_s=3.0, sleep=sleeps.append)
        it, _ = self._flaky_item(4)
        run_work_items([it], max_workers=0, resilience=policy)
        assert sleeps == [1.0, 2.0, 3.0, 3.0]   # doubling, then the cap

    def test_exhaustion_degrades_via_on_exhausted(self):
        it, calls = self._flaky_item(99)
        seen = []

        def on_exhausted(item, exc, attempts):
            seen.append((item.key, str(exc), attempts))
            return "degraded-stand-in"

        res = run_work_items([it], max_workers=0,
                             resilience=no_sleep_resilience(max_retries=2),
                             on_exhausted=on_exhausted)
        assert res.results["a"] == "degraded-stand-in"
        assert res.degraded == ["a"]
        assert calls["n"] == 3                   # 1 try + 2 retries
        assert seen == [("a", "flake #3", 3)]

    def test_exhaustion_without_degrade_raises(self):
        it, _ = self._flaky_item(99)
        with pytest.raises(TransientRunnerError):
            run_work_items(
                [it], max_workers=0,
                resilience=no_sleep_resilience(max_retries=1, degrade=False))

    def test_no_policy_means_no_retry(self):
        it, calls = self._flaky_item(1)
        with pytest.raises(TransientRunnerError):
            run_work_items([it], max_workers=0)
        assert calls["n"] == 1

    def test_non_transient_never_retried(self):
        calls = {"n": 0}

        def fn(_results):
            calls["n"] += 1
            raise ValueError("deterministic bug")

        with pytest.raises(ValueError):
            run_work_items([WorkItem(key="a", fn=fn)], max_workers=0,
                           resilience=no_sleep_resilience())
        assert calls["n"] == 1

    def test_on_item_done_fires_per_completed_item(self):
        done = []
        items = [WorkItem(key="a", fn=lambda _r: 1),
                 WorkItem(key="b", fn=lambda _r: 2, deps=("a",))]
        run_work_items(items, max_workers=0, on_item_done=done.append)
        assert done == ["a", "b"]


# --------------------------------------------------------------------------
# Fused-mode fault handling (split rounds + item restart)
# --------------------------------------------------------------------------
class TestFusedFaults:
    def _fused_pchase_items(self, dispatcher, sizes):
        proxy = dispatcher.proxy()
        return [
            WorkItem(key=f"p{i}",
                     fn=lambda _r, s=s: proxy.pchase("L1", s, 32, 9))
            for i, s in enumerate(sizes)
        ]

    def test_batch_fault_splits_round_per_row(self):
        """A fused dispatch that faults must be split into single-row
        retries — untouched items keep their results, nothing aborts."""
        sched = FaultSchedule(seed=2, permanent_kinds=("pchase_many",))
        cached = CachingRunner(ChaosRunner(h100_runner(), sched),
                               cache=SampleCache())
        dispatcher = FusionDispatcher(cached)
        sizes = [8 * KIB, 16 * KIB, 24 * KIB]
        out = run_fused(self._fused_pchase_items(dispatcher, sizes),
                        dispatcher)
        assert dispatcher.split_rounds >= 1
        base = h100_runner()
        for i, s in enumerate(sizes):
            assert np.array_equal(out.results[f"p{i}"],
                                  base.pchase("L1", s, 32, 9))

    def test_single_row_transient_restarts_item(self):
        """When the split fallback itself faults, the owning item restarts
        under the policy and converges once the fault budget is spent."""
        sched = FaultSchedule(seed=5, transient_rate=1.0,
                              batch_fault_rate=1.0,
                              max_faults_per_request=1)
        cached = CachingRunner(ChaosRunner(h100_runner(), sched),
                               cache=SampleCache())
        dispatcher = FusionDispatcher(cached)
        sizes = [8 * KIB, 16 * KIB]
        out = run_fused(self._fused_pchase_items(dispatcher, sizes),
                        dispatcher, resilience=no_sleep_resilience())
        assert out.retries >= 1
        assert dispatcher.split_rounds >= 1
        base = h100_runner()
        for i, s in enumerate(sizes):
            assert np.array_equal(out.results[f"p{i}"],
                                  base.pchase("L1", s, 32, 9))

    def test_fused_exhaustion_degrades(self):
        sched = FaultSchedule(seed=5, permanent_kinds=("pchase",
                                                       "pchase_many"))
        cached = CachingRunner(ChaosRunner(h100_runner(), sched),
                               cache=SampleCache())
        dispatcher = FusionDispatcher(cached)
        out = run_fused(
            self._fused_pchase_items(dispatcher, [8 * KIB]), dispatcher,
            resilience=no_sleep_resilience(max_retries=1),
            on_exhausted=lambda it, exc, attempts: ("degraded", attempts))
        assert out.degraded == ["p0"]
        assert out.results["p0"] == ("degraded", 2)


# --------------------------------------------------------------------------
# Discovery-level behavior (the acceptance criteria)
# --------------------------------------------------------------------------
class TestResilientDiscovery:
    @pytest.fixture(scope="class")
    def clean(self):
        return discover_sim(make_h100_like(seed=3), n_samples=9)

    def test_transient_faults_yield_equivalent_topology(self, clean):
        """The headline contract: under a value-preserving transient fault
        schedule, retries reproduce the clean topology exactly."""
        sched = FaultSchedule(seed=11, transient_rate=0.05,
                              max_faults_per_request=1)
        holder = {}

        def mk():
            holder["r"] = ChaosRunner(h100_runner(), sched)
            return holder["r"]

        topo, timings = discover(make_request(mk, no_sleep_resilience()))
        assert holder["r"].faults_injected > 0   # chaos actually fired
        assert topology_equivalent(clean[0], topo, rel_tol=1e-6)
        meta = timings.meta["resilience"]
        assert meta["retries"] >= holder["r"].faults_injected
        assert meta["degraded"] == []

    def test_permanent_fault_degrades_not_aborts(self, clean):
        sched = FaultSchedule(seed=7, permanent_kinds=("bandwidth",))
        topo, timings = discover(make_request(
            lambda: ChaosRunner(h100_runner(), sched),
            no_sleep_resilience(max_retries=1)))
        degraded = timings.meta["resilience"]["degraded"]
        assert "L2/bandwidth" in degraded
        l2 = topo.find_memory("L2")
        attr = l2.attrs["read_bw"]
        assert attr.value == "unknown"
        assert attr.provenance == PROVENANCE_DEGRADED
        assert attr.confidence == 0.0
        # unaffected families still measured normally
        assert l2.get("size") == clean[0].find_memory("L2").get("size")
        assert any("degraded after" in n for n in topo.notes)

    def test_degraded_breaks_equivalence(self, clean):
        """Degradation must be *visible*: a degraded topology is NOT
        equivalent to the clean one (provenance is part of the contract)."""
        sched = FaultSchedule(seed=7, permanent_kinds=("bandwidth",))
        topo, _ = discover(make_request(
            lambda: ChaosRunner(h100_runner(), sched),
            no_sleep_resilience(max_retries=1)))
        assert not topology_equivalent(clean[0], topo, rel_tol=1e-6)

    def test_without_policy_transients_propagate(self):
        sched = FaultSchedule(seed=11, transient_rate=1.0,
                              max_faults_per_request=10)
        with pytest.raises(TransientRunnerError):
            discover(make_request(
                lambda: ChaosRunner(h100_runner(), sched), None))


def kill_past_first_checkpoint(monkeypatch, store, holder, horizon=40):
    """Arm the kill switch of the chaos runner in ``holder["r"]`` when the
    first checkpoint lands, at ``max(horizon, its calls by then)``.

    Inline, the first item finishes well within ``horizon`` calls, so this
    is ``FaultSchedule(kill_after=horizon)``.  On threads, six items may
    interleave their first sweeps past call ``horizon`` without finishing
    one; the kill then comes at the first call after the first checkpoint,
    so a kill always leaves something to resume, whatever the order."""
    put = store.put_checkpoint

    def put_checkpoint(key, entries, families=None):
        put(key, entries, families)
        chaos = holder["r"]
        if chaos.schedule.kill_after is None:
            chaos.schedule = dataclasses.replace(
                chaos.schedule, kill_after=max(horizon, chaos.calls))

    monkeypatch.setattr(store, "put_checkpoint", put_checkpoint)


def record_probed_rows(monkeypatch) -> list:
    """The keys of the rows every ``SampleCache`` made from now on stores
    from a probe (rows preloaded from a checkpoint are not among them)."""
    probed = []

    class Recording(dict):
        def __setitem__(self, key, value):
            probed.append(tuple(key))
            super().__setitem__(key, value)

    init = SampleCache.__init__

    def recording_init(self):
        init(self)
        self._store = Recording()

    monkeypatch.setattr(SampleCache, "__init__", recording_init)
    return probed


class TestCheckpointResume:
    def test_interrupt_then_resume_zero_recompute(self, tmp_path,
                                                  monkeypatch):
        """Kill a discovery mid-run; the rerun must (a) preload the
        checkpoint, (b) re-probe ZERO persisted rows (exact miss
        arithmetic), (c) produce the equivalent topology, (d) clear the
        spent checkpoint."""
        clean_topo, clean_t = discover_sim(make_h100_like(seed=3),
                                           n_samples=9)
        clean_misses = clean_t.meta["cache"]["misses"]

        store = TopologyStore(str(tmp_path / "store"))
        policy = no_sleep_resilience()
        holder = {}
        kill_past_first_checkpoint(monkeypatch, store, holder)

        def mk_killed():
            holder["r"] = ChaosRunner(h100_runner(), FaultSchedule(seed=5))
            return holder["r"]

        with pytest.raises(RuntimeError, match="chaos kill"):
            discover(make_request(mk_killed, policy), store=store)

        key = request_key(make_request(h100_runner, policy).descriptor)
        ckpt = store.load_checkpoint(key)
        assert ckpt is not None
        entries, families = ckpt
        assert entries and families

        probed = record_probed_rows(monkeypatch)
        resumed, t = discover(make_request(h100_runner, policy),
                              store=store)
        persisted = {tuple(k) for k in entries}
        again = persisted & set(probed)
        numbers = (f"{len(entries)} persisted entries, {len(families)} "
                   f"families; resume meta {t.meta.get('resume')}; cache on "
                   f"resume {t.meta['cache']}, {len(set(probed))} distinct "
                   f"rows probed, {len(again)} of them persisted; clean "
                   f"misses {clean_misses} (cache {clean_t.meta['cache']})")
        assert t.meta["resume"] == {"rows": len(entries),
                                    "families_done": len(families)}, numbers
        # no persisted row is probed again, and the persisted rows and the
        # rows probed on resume are the clean run's, counted distinct and
        # as misses (a row two threads probe at once is one miss)
        assert not again, numbers
        assert len(set(probed)) + len(entries) \
            == clean_t.meta["cache"]["entries"], numbers
        assert t.meta["cache"]["misses"] + len(entries) == clean_misses, \
            numbers
        assert topology_equivalent(clean_topo, resumed, rel_tol=1e-6), \
            numbers
        assert not store.has_checkpoint(key), numbers
        # the finished run persisted: a third call is a pure store hit
        _, t3 = discover(make_request(h100_runner, policy), store=store)
        assert "cache" not in t3.meta

    def test_checkpoint_is_per_request_key(self, tmp_path, monkeypatch):
        """Different request descriptors never share a checkpoint."""
        store = TopologyStore(str(tmp_path / "store"))
        policy = no_sleep_resilience()
        holder = {}
        kill_past_first_checkpoint(monkeypatch, store, holder)

        def mk():
            holder["r"] = ChaosRunner(h100_runner(), FaultSchedule(seed=5))
            return holder["r"]

        with pytest.raises(RuntimeError):
            discover(make_request(mk, policy), store=store)
        key9 = request_key(make_request(mk, policy).descriptor)
        key7 = request_key(make_request(mk, policy,
                                        n_samples=7).descriptor)
        assert store.has_checkpoint(key9)
        assert not store.has_checkpoint(key7)

    def test_job_engine_retry_resumes_from_checkpoint(self, tmp_path,
                                                      monkeypatch):
        """The serve path: attempt 1 dies on an escaped transient fault
        (engine retry disabled), the JobEngine's capped retry reruns the
        request, and the retries resume from the checkpoint until one
        finishes — every attempt probing fewer rows than a full run.

        Inline the job needs three attempts (two faults).  On threads the
        items still running when one faults finish or fault after the last
        checkpoint, and the uncached bandwidth rows run again in every
        attempt, so how many faults the job meets follows the thread
        order; the budget of nine attempts leaves room for any order, and
        every failed attempt must have met a fault."""
        from repro_torch.serve import jobs as jobs_module
        from repro_torch.serve.jobs import JobEngine

        store = TopologyStore(str(tmp_path / "store"))
        # No engine-level retries: the first TransientRunnerError escapes
        # discover(), leaving the checkpoint for the job retry to consume.
        policy = Resilience(max_retries=0, degrade=False,
                            sleep=lambda _s: None)
        # ONE chaos runner across attempts: its per-request fault budget
        # makes attempt 1 fail and attempt 2's retry of the same request
        # succeed (faults are spent, not random).
        chaos = ChaosRunner(h100_runner(),
                            FaultSchedule(seed=23, transient_rate=0.02,
                                          max_faults_per_request=1))
        # dispatch count of a full, clean, storeless run — the work a
        # non-resuming retry would pay every time
        probe = ChaosRunner(h100_runner())
        _, clean_t = discover(make_request(lambda: probe, policy))
        full_calls = probe.calls
        clean_misses = clean_t.meta["cache"]["misses"]
        calls_per_attempt = []
        timings_seen = []

        def run():
            before = chaos.calls
            try:
                topo, timings = discover(make_request(lambda: chaos,
                                                      policy), store=store)
                timings_seen.append(timings)
                return topo, timings
            finally:
                calls_per_attempt.append(chaos.calls - before)

        request = make_request(lambda: chaos, policy)

        def fake_resolve(params, _store, parallel=None):
            return request.descriptor, request_key(request.descriptor), run

        monkeypatch.setattr(jobs_module, "resolve_discovery", fake_resolve)
        engine = JobEngine(store, workers=1, max_retries=8,
                           sleep=lambda _s: None).start()
        try:
            job, created = engine.submit({"backend": "sim",
                                          "device": "h100"})
            assert created
            engine.wait(job.job_id, timeout_s=120)
        finally:
            engine.stop()
        assert job.state == "done", job.error
        assert job.attempts >= 2            # >= one job-level retry happened
        assert chaos.faults_injected >= job.attempts - 1
        # resume did real work-saving: every attempt (failed early OR
        # resumed from the checkpoint) dispatched fewer probes than a full
        # from-scratch run would have
        assert len(calls_per_attempt) == job.attempts
        assert all(c < full_calls for c in calls_per_attempt)
        # ...and the successful attempt really did preload the checkpoint,
        # and probed exactly the rows it did not hold
        resume = timings_seen[-1].meta["resume"]["rows"]
        assert resume > 0
        assert resume + timings_seen[-1].meta["cache"]["misses"] \
            == clean_misses
        assert not store.has_checkpoint(job.key)
        assert store.get(job.key) is not None


# --------------------------------------------------------------------------
# Statistical hardening: MAD gating + confidence-driven resampling
# --------------------------------------------------------------------------
class TestStatisticalHardening:
    def test_mad_gate_drops_spike_keeps_body(self):
        rng = np.random.default_rng(0)
        body = rng.normal(100.0, 3.0, 64)
        spiked = np.concatenate([body, [800.0]])     # 8x throttle spike
        gated = mad_gate(spiked, k=5.0)
        assert gated.size == 64
        assert gated.max() < 800.0

    def test_mad_gate_no_ops(self):
        short = np.array([1.0, 2.0, 900.0])
        assert np.array_equal(mad_gate(short), short)      # too short
        const = np.full(16, 7.0)
        assert np.array_equal(mad_gate(const), const)      # zero MAD

    def test_classifier_default_unchanged_by_knobs_off(self):
        rng = np.random.default_rng(1)
        base = rng.normal(100.0, 3.0, 33)
        cur = rng.normal(160.0, 3.0, 33)
        assert ShiftClassifier(base, 0.01, 0.15).shifted(cur)
        assert not ShiftClassifier(base, 0.01, 0.15).shifted(
            rng.normal(100.0, 3.0, 33))

    def test_mad_gating_suppresses_outlier_false_shift(self):
        """A clean row contaminated with throttle spikes must NOT classify
        as shifted once MAD gating is on — and DOES without it (same data,
        same test), proving the gate is what saves the verdict."""
        rng = np.random.default_rng(2)
        base = rng.normal(100.0, 2.0, 96)
        cur = rng.normal(100.0, 2.0, 96)
        cur[:29] = 800.0                  # ~30% throttle-spike contamination
        assert ShiftClassifier(base, 0.01, 0.0).shifted(cur.copy())
        assert not ShiftClassifier(base, 0.01, 0.0,
                                   mad_k=5.0).shifted(cur.copy())

    def test_ambiguous_verdict_triggers_resample(self):
        rng = np.random.default_rng(3)
        base = rng.normal(100.0, 3.0, 33)
        clf = ShiftClassifier(base, 0.01, 0.15, resample_band=1.0)
        called = {"n": 0}

        def resample():
            called["n"] += 1
            return rng.normal(100.0, 3.0, 33)

        # band=1.0 makes EVERY verdict ambiguous -> resample always fires
        clf.shifted(rng.normal(100.0, 3.0, 33), resample=resample)
        assert called["n"] == 1

    def test_find_size_robust_matches_dense_on_clean_runner(self):
        """On a clean runner the hardened dense path must find the same
        boundary as the historical dense path (defaults bit-identical;
        knobs only matter under contamination)."""
        runner = h100_runner()
        plain = find_size(runner, "L1", n_samples=17)
        hard = find_size(runner, "L1", n_samples=17,
                         robust=Resilience(mad_k=5.0, resample_band=0.02,
                                           resample_extra=9))
        assert plain.found and hard.found
        assert hard.size == plain.size


# --------------------------------------------------------------------------
# The promoted error taxonomy
# --------------------------------------------------------------------------
class TestErrorTaxonomy:
    def test_transient_error_single_class(self):
        import repro_torch.serve
        import repro_torch.serve.jobs
        from repro_torch import core

        assert (repro_torch.serve.TransientRunnerError
                is repro_torch.serve.jobs.TransientRunnerError
                is core.TransientRunnerError
                is TransientRunnerError)

    def test_resilience_descriptor_entry(self):
        assert Resilience().descriptor_entry() is None
        assert Resilience(max_retries=9).descriptor_entry() is None
        entry = Resilience(mad_k=5.0, resample_band=0.02,
                           resample_extra=9).descriptor_entry()
        assert entry == {"mad_k": 5.0, "resample_band": 0.02,
                         "resample_extra": 9}

    def test_statistical_knobs_key_the_descriptor(self):
        dev = make_h100_like(seed=3)
        base = sim_request_descriptor(dev, 9, None)
        retry_only = sim_request_descriptor(
            dev, 9, None, resilience=Resilience(max_retries=7))
        hardened = sim_request_descriptor(
            dev, 9, None, resilience=Resilience(mad_k=5.0))
        assert request_key(base) == request_key(retry_only)
        assert request_key(base) != request_key(hardened)

    def test_degraded_result_ducks_as_not_found(self):
        dr = DegradedResult(family="size", key="L1/size", error="boom",
                            attempts=3)
        assert dr.found is False

    def test_backoff_formula(self):
        r = Resilience(backoff_base_s=0.5, backoff_cap_s=2.0)
        assert [r.backoff(i) for i in range(4)] == [0.5, 1.0, 2.0, 2.0]


# --------------------------------------------------------------------------
# The checkpoint cases with the scheduler inline: the same every run
# --------------------------------------------------------------------------
class TestCheckpointResumeInline(TestCheckpointResume):
    """``TestCheckpointResume``'s three cases on ``make_request(...,
    max_workers=0)``: one item at a time, in dependency order, so the
    items done before the kill, the checkpoint they leave and the faults
    each job attempt meets do not depend on thread timing."""

    @pytest.fixture(autouse=True)
    def _inline(self, monkeypatch):
        monkeypatch.setattr(sys.modules[__name__], "make_request",
                            functools.partial(make_request, max_workers=0))


# --------------------------------------------------------------------------
# The port against the reference package, request by request
# --------------------------------------------------------------------------
def ref_request(make_runner, resilience, n_samples=9):
    dev = ref_core.make_h100_like(seed=3)
    return RefRequest(
        descriptor=ref_sim_descriptor(dev, n_samples, None,
                                      resilience=resilience),
        vendor=dev.vendor, model=dev.name,
        backend=f"simulated:{dev.name}",
        make_runner=make_runner, n_samples=n_samples,
        device_families=DEVICE_FAMILIES, resilience=resilience,
        max_workers=0)


def _report(topo) -> dict:
    """The topology document without the wall-time note."""
    doc = topo.to_json()
    doc["notes"] = [n for n in doc["notes"]
                    if not n.startswith("discovery wall time")]
    return doc


def _counters(chaos) -> tuple:
    return (chaos.calls, chaos.faults_injected, chaos.batch_faults,
            dict(chaos.base_calls))


# (schedule kwargs, max_retries): transient single-probe faults, transient
# faults on batched calls too, and a permanent family.  Unfused and inline
# only: a fused round's signature lists its rows in the order their item
# threads parked them, so which round a batch fault hits is the threads'
# to decide (``test_fused_faults_yield_equivalent_topology`` holds that
# path to the clean run instead).
CHAOS_CASES = {
    "transient": (dict(seed=11, transient_rate=0.05,
                       max_faults_per_request=1), 3),
    "batch": (dict(seed=5, transient_rate=0.05, batch_fault_rate=0.2,
                   max_faults_per_request=1), 3),
    "permanent": (dict(seed=7, permanent_kinds=("bandwidth",)), 1),
}


class TestAgainstReference:
    @pytest.mark.parametrize("case", list(CHAOS_CASES))
    def test_chaos_discovery_equals_reference(self, case):
        """Same schedule, same request, inline: the same faults on the same
        calls, the same retries and degraded families, the same report."""
        sched_kw, retries = CHAOS_CASES[case]
        holder = {}

        def mk_port():
            holder["port"] = ChaosRunner(h100_runner(),
                                         FaultSchedule(**sched_kw))
            return holder["port"]

        def mk_ref():
            holder["ref"] = RefChaosRunner(
                RefSimRunner(ref_core.make_h100_like(seed=3)),
                RefFaultSchedule(**sched_kw))
            return holder["ref"]

        topo, t = discover(make_request(
            mk_port, no_sleep_resilience(max_retries=retries),
            max_workers=0))
        want, wt = ref_discover(ref_request(
            mk_ref, RefResilience(max_retries=retries,
                                  sleep=lambda _s: None)))
        assert holder["port"].faults_injected > 0
        assert _counters(holder["port"]) == _counters(holder["ref"])
        assert t.meta["resilience"] == wt.meta["resilience"]
        assert t.meta["cache"] == wt.meta["cache"]
        assert _report(topo) == _report(want)

    @pytest.mark.parametrize("resilience", [
        None, dict(max_retries=7), dict(mad_k=5.0),
        dict(mad_k=5.0, resample_band=0.02, resample_extra=9)],
        ids=["none", "retry-only", "mad", "all-knobs"])
    def test_request_key_with_resilience_equals_reference(self, resilience):
        port = None if resilience is None else Resilience(**resilience)
        ref = None if resilience is None else RefResilience(**resilience)
        got = sim_request_descriptor(make_h100_like(seed=3), 9, None,
                                     resilience=port)
        want = ref_sim_descriptor(ref_core.make_h100_like(seed=3), 9, None,
                                  resilience=ref)
        assert got == want
        assert request_key(got) == ref_request_key(want)
        from repro.core.probes import make_pallas_model
        from repro_torch.core.probes import make_cuda_model

        cuda = cuda_request_descriptor(make_cuda_model(), 9, None,
                                       resilience=port)
        pallas = pallas_request_descriptor(make_pallas_model(), 9, None,
                                           resilience=ref)
        for d in (cuda, pallas):
            for name in ("kind", "backend", "model"):
                d.pop(name)
        assert cuda == pallas

    def test_fused_faults_yield_equivalent_topology(self):
        """Transient faults on single probes and fused batches on the fused
        path (the card's default): retried to the clean topology."""
        sched = FaultSchedule(seed=11, transient_rate=0.05,
                              batch_fault_rate=0.05,
                              max_faults_per_request=1)
        holder = {}

        def mk():
            holder["r"] = ChaosRunner(h100_runner(), sched)
            return holder["r"]

        req = make_request(mk, no_sleep_resilience())
        req.fuse = True
        topo, t = discover(req)
        clean, _ = discover_sim(make_h100_like(seed=3), n_samples=9,
                                fuse=True)
        assert holder["r"].faults_injected > 0
        assert t.meta.get("resilience", {"degraded": []})["degraded"] == []
        assert topology_equivalent(clean, topo, rel_tol=1e-6)

    def test_resume_equals_reference(self, tmp_path):
        """Kill both packages' inline runs at call 40, resume both: the
        same checkpoint (rows bit-equal, the same families done), the same
        resume counts and misses, and ``misses + rows == clean misses``."""
        policy = no_sleep_resilience()
        ref_policy = RefResilience(max_retries=3, sleep=lambda _s: None)
        store = TopologyStore(str(tmp_path / "port"))
        ref_store = RefStore(str(tmp_path / "ref"))
        sched = dict(seed=5, kill_after=40)
        with pytest.raises(RuntimeError, match="chaos kill"):
            discover(make_request(
                lambda: ChaosRunner(h100_runner(), FaultSchedule(**sched)),
                policy, max_workers=0), store=store)
        with pytest.raises(RuntimeError, match="chaos kill"):
            ref_discover(ref_request(
                lambda: RefChaosRunner(
                    RefSimRunner(ref_core.make_h100_like(seed=3)),
                    RefFaultSchedule(**sched)), ref_policy), store=ref_store)
        key = request_key(make_request(h100_runner, policy).descriptor)
        assert key == ref_request_key(ref_request(None, ref_policy)
                                      .descriptor)
        entries, families = store.load_checkpoint(key)
        ref_entries, ref_families = ref_store.load_checkpoint(key)
        assert families == ref_families and set(entries) == set(ref_entries)
        for k, row in entries.items():
            assert np.array_equal(row, ref_entries[k])

        resumed, t = discover(make_request(h100_runner, policy,
                                           max_workers=0), store=store)
        want, wt = ref_discover(ref_request(
            lambda: RefSimRunner(ref_core.make_h100_like(seed=3)),
            ref_policy), store=ref_store)
        clean = discover_sim(make_h100_like(seed=3), n_samples=9)[1]
        assert t.meta["resume"] == wt.meta["resume"]
        assert t.meta["cache"] == wt.meta["cache"]
        assert (t.meta["cache"]["misses"] + len(entries)
                == clean.meta["cache"]["misses"])
        assert _report(resumed) == _report(want)


# --------------------------------------------------------------------------
# Only transient errors are retried: everything else propagates
# --------------------------------------------------------------------------
KERNEL_CALLS = ("pchase", "pchase_batch", "pchase_many", "cold_chase",
                "cold_chase_batch", "cold_chase_many", "eviction_many",
                "amount_probe", "sharing_probe", "bandwidth")


class Broken:
    """A runner whose probe calls raise a plain ``RuntimeError``, as a
    kernel that failed to build or launch does; every other attribute is
    the wrapped runner's."""

    def __init__(self, base):
        self.base = base
        self.raised = 0

    def __getattr__(self, name):
        if name not in KERNEL_CALLS:
            return getattr(self.base, name)

        def fail(*_args, **_kw):
            self.raised += 1
            raise RuntimeError("CUDA error: unspecified launch failure")
        return fail


class TestNonTransientPropagates:
    @pytest.mark.parametrize("fuse", [False, True], ids=["inline", "fused"])
    def test_sim(self, fuse, tmp_path):
        broken = Broken(h100_runner())
        req = make_request(lambda: broken, no_sleep_resilience(),
                           max_workers=0)
        req.fuse = fuse
        store = TopologyStore(str(tmp_path / "store"))
        with pytest.raises(RuntimeError, match="launch failure"):
            discover(req, store=store)
        if not fuse:
            assert broken.raised == 1         # never retried
        assert store.get(request_key(req.descriptor)) is None

    @pytest.mark.parametrize("fuse", [False, True], ids=["inline", "fused"])
    def test_cuda(self, fuse):
        from repro_torch.core.probes import CudaRunner, make_cuda_model

        broken = Broken(CudaRunner(device="cpu", base_steps=512))
        with pytest.raises(RuntimeError, match="launch failure"):
            discover_cuda(make_cuda_model(), n_samples=9, elements=["VMEM"],
                          runner=broken, fuse=fuse,
                          resilience=no_sleep_resilience())
        if not fuse:
            assert broken.raised == 1
