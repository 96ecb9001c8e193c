"""The reference's planner, fusion and store-GC cases, re-pointed at the port.

``tests/test_planner.py``'s cases run here against ``repro_torch`` on the
same seeds.  The planner's contract is strong: for any hierarchy the dense sweeps can
discover, a planned search must return *identical discrete attributes*
(sizes, line size, fetch granularity, found-ness) while sampling strictly
fewer grid rows — the dense path stays available behind ``budget=None`` as
the equivalence oracle.  Identity holds by construction (both paths run the
same deterministic classification descent over the same sweep lattice) and
is exercised here over randomized hierarchies via the hypothesis shim, on
the Sim runner and on the CUDA runner's plain versions; on the host
runner, whose rows are real measurements, found-parity and one lattice
step (``TestPlannedHost``).

Fusion's contract mirrors it: coalescing ready work items' probe rounds
into single batched dispatches must be result-invisible (request-keyed
streams) while reducing dispatch counts.  Each fused dispatch runs under
the sorted, ``+``-joined probe families of the rows it carries.

Cross-checks: on both Sim devices the port's planned and fused
``discover_sim`` equals the reference's bit for bit (notes excluded, which
carry wall times), with equal sample-cache statistics and fusion round
counts.
"""
import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

import repro_torch.core as repro_torch_core
from repro_torch.core import (GcPolicy, SweepBudget, discover_sim,
                              make_h100_like, make_mi210_like,
                              topology_equivalent)
from repro_torch.core.engine import run_probes
from repro_torch.core.engine.cache import CachingRunner
from repro_torch.core.engine.fusion import FusionDispatcher, run_fused
from repro_torch.core.engine.scheduler import WorkItem
from repro_torch.core.probes import (SimRunner, find_fetch_granularity,
                                     find_line_size, find_size)
from repro_torch.core.simulate import SimDevice, SimLevel

KIB, MIB = 1024, 1024**2
BUDGET = SweepBudget()


class RowCountingRunner:
    """Counts grid rows fetched from the wrapped runner (probe volume)."""

    def __init__(self, base):
        self.base = base
        self.rows = 0

    def pchase(self, *a, **k):
        self.rows += 1
        return self.base.pchase(*a, **k)

    def pchase_batch(self, space, sizes, stride, n):
        self.rows += len(sizes)
        return self.base.pchase_batch(space, sizes, stride, n)

    def pchase_many(self, reqs, n):
        self.rows += len(reqs)
        return self.base.pchase_many(reqs, n)

    def cold_chase(self, *a, **k):
        self.rows += 1
        return self.base.cold_chase(*a, **k)

    def cold_chase_batch(self, space, sizes, strides, n):
        self.rows += len(sizes)
        return self.base.cold_chase_batch(space, sizes, strides, n)

    def amount_probe(self, *a, **k):
        self.rows += 1
        return self.base.amount_probe(*a, **k)

    def sharing_probe(self, *a, **k):
        self.rows += 1
        return self.base.sharing_probe(*a, **k)

    def cu_sharing_probe(self, *a, **k):
        self.rows += 1
        return self.base.cu_sharing_probe(*a, **k)

    def cu_sharing_probe_batch(self, cu_a, cu_bs, *a, **k):
        self.rows += len(cu_bs)
        return self.base.cu_sharing_probe_batch(cu_a, cu_bs, *a, **k)

    def eviction_many(self, requests, n):
        self.rows += len(requests)
        return self.base.eviction_many(requests, n)

    def __getattr__(self, name):
        return getattr(self.base, name)


def _device(levels, seed, **kw):
    return SimDevice(name="prop", vendor="x", levels=levels,
                     mem_latency=650.0, read_bw={}, write_bw={},
                     space_of_level={}, seed=seed, **kw)


# --------------------------------------------------------------- find_size
class TestPlannedSizeIdentity:
    @given(size_kib=st.sampled_from([4, 16, 48, 64, 192, 238, 768]),
           seed=st.integers(0, 200))
    @settings(max_examples=14, deadline=None)
    def test_randomized_hierarchies_identical_and_cheaper(self, size_kib,
                                                          seed):
        dev = _device([SimLevel("C", size_kib * KIB, 30.0, 64, 32,
                                noise=1.0)], seed)
        dense = RowCountingRunner(SimRunner(dev))
        d = find_size(dense, "C", lo=1 * KIB, step=32, n_samples=9,
                      batched=True)
        planned = RowCountingRunner(SimRunner(dev))
        p = find_size(planned, "C", lo=1 * KIB, step=32, n_samples=9,
                      budget=BUDGET)
        assert (d.size, d.found) == (p.size, p.found)
        assert planned.rows < dense.rows

    @given(levels=st.sampled_from([(16, 256), (4, 64), (32, 2048)]),
           seed=st.integers(0, 100))
    @settings(max_examples=8, deadline=None)
    def test_multi_level_hierarchies(self, levels, seed):
        """Doubling past an inner level must bracket the same (innermost)
        boundary on both paths — the coarse ladder stops at the first
        shifted octave exactly like the dense doubling loop."""
        l1_kib, l2_kib = levels
        dev = _device(
            [SimLevel("C1", l1_kib * KIB, 25.0, 64, 32, noise=0.8),
             SimLevel("C2", l2_kib * KIB, 140.0, 128, 32, scope="chip",
                      noise=3.0)], seed)
        for space in ("C1", "C2"):
            d = find_size(SimRunner(dev), space, lo=1 * KIB, step=32,
                          n_samples=9, batched=True)
            p = find_size(SimRunner(dev), space, lo=1 * KIB, step=32,
                          n_samples=9, budget=BUDGET)
            assert (d.size, d.found) == (p.size, p.found), space

    def test_not_found_parity(self):
        """No boundary below max_bytes: both paths must report not-found."""
        dev = _device([SimLevel("C", 64 * MIB, 30.0, 64, 32, noise=1.0)],
                      seed=3)
        kw = dict(lo=1 * KIB, step=32, n_samples=9, max_bytes=1 * MIB)
        d = find_size(SimRunner(dev), "C", batched=True, **kw)
        p = find_size(SimRunner(dev), "C", budget=BUDGET, **kw)
        assert d.found is False and p.found is False

    def test_budget_none_is_dense(self):
        """budget=None must be the unchanged dense path (the oracle)."""
        r = RowCountingRunner(SimRunner(make_h100_like(seed=4)))
        res = find_size(r, "L1", n_samples=9, batched=True, budget=None)
        assert res.found and r.rows > 60     # full lattice actually swept

    def test_target_resolution_coarsens(self):
        """target_resolution trades oracle identity for a coarser lattice —
        the detected size must still land within one coarse step of truth,
        for far fewer rows than the dense sweep."""
        dev = _device([SimLevel("C", 192 * KIB, 30.0, 64, 32, noise=1.0)],
                      seed=5)
        dense = RowCountingRunner(SimRunner(dev))
        find_size(dense, "C", n_samples=9, batched=True)
        coarse = RowCountingRunner(SimRunner(dev))
        pc = find_size(coarse, "C", n_samples=9,
                       budget=SweepBudget(target_resolution=4 * KIB))
        assert pc.found
        assert abs(pc.size - 192 * KIB) <= 4 * KIB
        assert coarse.rows < dense.rows

    def test_max_rows_exhaustion_falls_back_to_dense(self):
        """A too-tight row budget may not produce a wrong answer: the
        planner falls back to the dense sweep (slower, identical)."""
        dev = _device([SimLevel("C", 64 * KIB, 30.0, 64, 32, noise=1.0)],
                      seed=6)
        d = find_size(SimRunner(dev), "C", n_samples=9, batched=True)
        pt = find_size(SimRunner(dev), "C", n_samples=9,
                       budget=SweepBudget(max_rows=16))
        assert (pt.size, pt.found) == (d.size, d.found)


# ------------------------------------------- granularity / line size
class TestPlannedGranularityAndLine:
    @given(g=st.sampled_from([16, 32, 64, 128, 256]),
           seed=st.integers(0, 100))
    @settings(max_examples=10, deadline=None)
    def test_granularity_identity(self, g, seed):
        dev = _device([SimLevel("C", 64 * KIB, 30.0, max(g, 32), g,
                                noise=1.0)], seed)
        dense = RowCountingRunner(SimRunner(dev))
        d = find_fetch_granularity(dense, "C", n_samples=9, batched=True)
        planned = RowCountingRunner(SimRunner(dev))
        p = find_fetch_granularity(planned, "C", n_samples=9, budget=BUDGET)
        assert (d.granularity, d.found) == (p.granularity, p.found)

    @given(line=st.sampled_from([32, 64, 128, 256]),
           seed=st.integers(0, 100))
    @settings(max_examples=10, deadline=None)
    def test_line_size_identity_and_cheaper(self, line, seed):
        dev = _device([SimLevel("C", 64 * KIB, 30.0, line, 32, noise=1.0)],
                      seed)
        dense = RowCountingRunner(SimRunner(dev))
        d = find_line_size(dense, "C", 64 * KIB, 32, n_samples=9,
                           batched=True)
        planned = RowCountingRunner(SimRunner(dev))
        p = find_line_size(planned, "C", 64 * KIB, 32, n_samples=9,
                           budget=BUDGET)
        assert (d.line_size, d.found) == (p.line_size, p.found)
        assert planned.rows < dense.rows


# -------------------------------------------------- full discovery parity
class TestPlannedDiscovery:
    @pytest.mark.parametrize("make,seed", [(make_h100_like, 48),
                                           (make_mi210_like, 48),
                                           (make_h100_like, 11)])
    def test_planner_vs_dense_topology(self, make, seed):
        """The bench-gated contract: whole-topology planner-vs-dense
        equivalence with confidence excluded, and strictly fewer rows."""
        topo_d, td = discover_sim(make(seed=seed), n_samples=17,
                                  max_workers=0)
        topo_p, tp = discover_sim(make(seed=seed), n_samples=17,
                                  max_workers=0, budget=SweepBudget())
        assert topology_equivalent(topo_d, topo_p, rel_tol=1e-6,
                                   compare_confidence=False)
        assert tp.probe_rows < td.probe_rows

    def test_budget_addressed_in_store_key(self):
        from repro_torch.core.discover import sim_request_descriptor
        from repro_torch.core.engine.store import request_key

        dev = make_h100_like(seed=1)
        k_dense = request_key(sim_request_descriptor(dev, 9, None))
        k_plan = request_key(sim_request_descriptor(dev, 9, None,
                                                    SweepBudget()))
        k_plan2 = request_key(sim_request_descriptor(
            dev, 9, None, SweepBudget(max_rows=50)))
        assert len({k_dense, k_plan, k_plan2}) == 3


# ------------------------------------- planned eviction families (§IV-F/G/H)
class TestPlannedEvictionFamilies:
    """The bisected §IV-F ladder and §IV-G/H lattices must match
    the dense sweeps' discrete answers for fewer eviction rows, with dense
    fallback on any inconsistency."""

    @pytest.mark.parametrize("amount,cores", [(1, 32), (2, 32), (4, 64),
                                              (32, 256)])
    def test_amount_identity_and_cheaper(self, amount, cores):
        from repro_torch.core.probes import find_amount

        per_core = 32 * KIB
        dev = _device([SimLevel("C", per_core * amount, 25.0, 64, 32,
                                amount=amount, noise=0.8)], seed=5,
                      cores_per_sm=cores)
        dense = RowCountingRunner(SimRunner(dev))
        d = find_amount(dense, "C", per_core, cores, n_samples=33,
                        batched=True)
        planned = RowCountingRunner(SimRunner(dev))
        p = find_amount(planned, "C", per_core, cores, n_samples=33,
                        budget=SweepBudget())
        assert (d.amount, d.found) == (p.amount, p.found) == (amount, True)
        assert planned.rows <= dense.rows

    def test_amount_bisection_strictly_cheaper_on_long_ladder(self):
        from repro_torch.core.probes import find_amount

        dev = _device([SimLevel("C", 32 * KIB * 32, 25.0, 64, 32,
                                amount=32, noise=0.8)], seed=9,
                      cores_per_sm=256)
        dense = RowCountingRunner(SimRunner(dev))
        find_amount(dense, "C", 32 * KIB, 256, n_samples=33, batched=True)
        planned = RowCountingRunner(SimRunner(dev))
        find_amount(planned, "C", 32 * KIB, 256, n_samples=33,
                    budget=SweepBudget())
        assert planned.rows < dense.rows

    @staticmethod
    def _sharing_paths(dev, n_samples=17):
        """(dense results+rows, planned results+rows) over a device's
        ordered leader lattice — same pair order on both paths."""
        from repro_torch.core.engine.planner import find_sharing_planned
        from repro_torch.core.probes.amount import find_sharing_batch

        spaces = [i.name for i in SimRunner(dev).spaces()
                  if i.supports_sharing and i.scope == "core"]
        leaders = [(a, dev.level(a).size, spaces[i + 1:])
                   for i, a in enumerate(spaces)]
        dense = RowCountingRunner(SimRunner(dev))
        d = []
        for a, size, partners in leaders:
            d.extend(find_sharing_batch(dense, a, partners, size,
                                        n_samples=n_samples))
        planned = RowCountingRunner(SimRunner(dev))
        p = find_sharing_planned(planned, leaders, n_samples,
                                 budget=SweepBudget())
        return d, dense.rows, p, planned.rows

    def test_sharing_partition_closure_identity(self):
        d, d_rows, p, p_rows = self._sharing_paths(make_h100_like(seed=7))
        assert ([(r.space_a, r.space_b, r.shared) for r in d]
                == [(r.space_a, r.space_b, r.shared) for r in p])
        assert p_rows <= d_rows

    def test_sharing_closure_saves_rows_on_wide_lattice(self):
        """Two unified groups of three: once a group is witnessed, its
        later leaders infer every partner and pay one spot-check row."""
        levels = ([SimLevel(n, 64 * KIB, 30.0, 64, 32, noise=1.0,
                            physical_group="g1") for n in "ABC"]
                  + [SimLevel(n, 8 * MIB, 220.0, 128, 32, noise=6.0,
                              physical_group="g2") for n in "DEF"])
        dev = _device(levels, seed=11)
        d, d_rows, p, p_rows = self._sharing_paths(dev)
        assert ([(r.space_a, r.space_b, r.shared) for r in d]
                == [(r.space_a, r.space_b, r.shared) for r in p])
        assert p_rows < d_rows

    def test_cu_sharing_identity_and_cheaper(self):
        from repro_torch.core.probes import find_cu_sharing

        dev = make_mi210_like(seed=6)
        cus = SimRunner(dev).cu_ids()
        size = dev.level("sL1d").size
        dense = RowCountingRunner(SimRunner(dev))
        d = find_cu_sharing(dense, cus, size, n_samples=17, batched=True)
        planned = RowCountingRunner(SimRunner(dev))
        p = find_cu_sharing(planned, cus, size, n_samples=17,
                            budget=SweepBudget())
        assert [sorted(g) for g in d.groups] == [sorted(g) for g in p.groups]
        assert sorted(d.exclusive) == sorted(p.exclusive)
        assert planned.rows < dense.rows


# ------------------------------------------------------ fleet survey mode
class TestSurveyMode:
    """Verify a stored sibling with a planned spot-check subset
    instead of a full discovery; any doubt degrades to the full measure."""

    def _store(self, tmp_path):
        from repro_torch.core.engine.store import TopologyStore
        return TopologyStore(tmp_path / "topo")

    def test_survey_verifies_sibling_for_5x_fewer_rows(self, tmp_path):
        store = self._store(tmp_path)
        topo_full, t_full = discover_sim(make_h100_like(seed=48),
                                         n_samples=17, max_workers=0,
                                         store=store)
        topo_s, t_s = discover_sim(make_h100_like(seed=49), n_samples=17,
                                   max_workers=0, store=store, survey=True)
        assert t_s.meta["survey"]["verified"] is True
        assert topology_equivalent(topo_full, topo_s, rel_tol=1e-6,
                                   compare_confidence=False)
        assert t_s.probe_rows * 5 <= t_full.probe_rows

        # the written entry carries survey provenance + its reference key
        from repro_torch.core.discover import sim_request_descriptor
        from repro_torch.core.engine.store import request_key
        key = request_key(sim_request_descriptor(
            make_h100_like(seed=49), 17, None, None, survey=True))
        entry = store.get(key)
        assert entry.meta.get("provenance") == "survey"
        assert entry.meta.get("survey_of")
        # and a repeat of the same survey request is a plain store hit
        _, t_again = discover_sim(make_h100_like(seed=49), n_samples=17,
                                  max_workers=0, store=store, survey=True)
        assert t_again.probe_rows is None

    def test_survey_covers_cu_sharing_device(self, tmp_path):
        store = self._store(tmp_path)
        _, t_full = discover_sim(make_mi210_like(seed=7), n_samples=17,
                                 max_workers=0, store=store)
        _, t_s = discover_sim(make_mi210_like(seed=8), n_samples=17,
                             max_workers=0, store=store, survey=True)
        assert t_s.meta["survey"]["verified"] is True
        assert t_s.probe_rows * 5 <= t_full.probe_rows

    def test_survey_without_sibling_runs_full_discovery(self, tmp_path):
        store = self._store(tmp_path)
        topo, t = discover_sim(make_h100_like(seed=48), n_samples=17,
                               max_workers=0, store=store, survey=True)
        assert t.meta.get("survey") is None
        assert t.probe_rows is not None and t.probe_rows > 500
        assert topo.find_memory("L1") is not None

    def test_survey_mismatch_falls_back_to_full_discovery(self, tmp_path):
        import copy

        from repro_torch.core.discover import sim_request_descriptor
        from repro_torch.core.engine.store import request_key

        store = self._store(tmp_path)
        dev = make_h100_like(seed=48)
        topo, _ = discover_sim(dev, n_samples=17, max_workers=0, store=store)
        # doctor the stored reference's L1 size: the spot check must refuse
        key0 = request_key(sim_request_descriptor(dev, 17, None, None))
        bad = copy.deepcopy(topo)
        bad.find_memory("L1").set("size",
                                  int(bad.find_memory("L1").get("size")) * 2)
        store.put(key0, bad, meta={"request": "doctored"})

        topo_s, t_s = discover_sim(make_h100_like(seed=49), n_samples=17,
                                   max_workers=0, store=store, survey=True)
        assert t_s.probe_rows is not None and t_s.probe_rows > 500
        for m in topo.memory:       # full re-measure, not the doctored copy
            ms = topo_s.find_memory(m.name)
            for k in ("size", "fetch_granularity", "line_size", "amount"):
                assert m.get(k) == ms.get(k), (m.name, k)
            assert m.shared_with == ms.shared_with


def _grid_step(res) -> int:
    """The final sweep lattice step of a SizeResult (tolerance unit)."""
    s = res.sizes_swept
    return int(s[1] - s[0]) if s.size >= 2 else 1


class TestPlannedHost:
    def test_host_identity_on_shared_cache(self):
        """Host rows are real measurements: the planner descends over
        *cached* rows of the same request keys (a prior dense run's
        samples), but the final boundary window is deliberately
        re-measured fresh (drift robustness), so the discrete contract on
        measuring runners is found-parity plus one-lattice-step agreement
        — bit-exact identity is the request-keyed runners' guarantee."""
        from repro_torch.core.probes import HostRunner

        cached = CachingRunner(HostRunner(max_bytes=8 * MIB, iters=1 << 11))
        kw = dict(lo=64 * KIB, step=16 * KIB, n_samples=5,
                  max_bytes=8 * MIB, max_points=24, max_widenings=1)
        d = find_size(cached, "host-cache", batched=True, **kw)
        p = find_size(cached, "host-cache", budget=SweepBudget(), **kw)
        assert d.found == p.found
        if d.found:
            assert abs(d.size - p.size) <= 2 * max(_grid_step(d),
                                                   _grid_step(p))


# ------------------------------------------------------------- fusion
class TestFusion:
    def test_fused_equals_inline(self):
        fams = ("sharing", "device_memory_latency",
                "device_memory_bandwidth")
        a = run_probes(SimRunner(make_h100_like(seed=7)), n_samples=9,
                       device_families=fams, max_workers=0)
        b = run_probes(SimRunner(make_h100_like(seed=7)), n_samples=9,
                       device_families=fams, fuse=True)
        assert a.space_results.keys() == b.space_results.keys()
        for sp in a.space_results:
            ra, rb = a.space_results[sp], b.space_results[sp]
            assert ra["size"].size == rb["size"].size
            assert np.isclose(ra["latency"].p50, rb["latency"].p50)

    def test_fusion_coalesces_dispatches(self):
        """Concurrently ready items sharing a capability must land on ONE
        fused dispatch per round, not one dispatch per item."""
        base = CachingRunner(SimRunner(make_h100_like(seed=8)))
        dispatcher = FusionDispatcher(base)
        proxy = dispatcher.proxy()

        def probe(space):
            def fn(_results, space=space):
                return proxy.pchase(space, 64 * KIB, 32, 9)
            return fn

        items = [WorkItem(key=s, fn=probe(s))
                 for s in ("L1", "Texture", "Readonly")]
        sched = run_fused(items, dispatcher)
        assert len(sched.results) == 3
        assert dispatcher.rounds == 1          # one round...
        assert dispatcher.fused_calls == 1     # ...one fused dispatch
        for s in ("L1", "Texture", "Readonly"):
            want = SimRunner(make_h100_like(seed=8)).pchase(s, 64 * KIB,
                                                            32, 9)
            assert np.array_equal(sched.results[s], want)

    def test_fusion_dependency_order(self):
        base = CachingRunner(SimRunner(make_h100_like(seed=8)))
        dispatcher = FusionDispatcher(base)
        proxy = dispatcher.proxy()
        log = []

        def leaf(_results):
            log.append("leaf")
            return proxy.pchase("L1", 32 * KIB, 32, 9)

        def dependent(results):
            log.append("dep")
            assert results["leaf"] is not None
            return proxy.pchase("L1", 64 * KIB, 32, 9)

        sched = run_fused([WorkItem(key="leaf", fn=leaf),
                           WorkItem(key="dep", fn=dependent,
                                    deps=("leaf",))], dispatcher)
        assert log == ["leaf", "dep"]
        assert sched.order == ["leaf", "dep"]

    def test_fusion_propagates_item_errors(self):
        dispatcher = FusionDispatcher(
            CachingRunner(SimRunner(make_h100_like(seed=8))))

        def boom(_results):
            raise RuntimeError("probe exploded")

        with pytest.raises(RuntimeError, match="probe exploded"):
            run_fused([WorkItem(key="bad", fn=boom)], dispatcher)

    def test_fused_many_dedupes_shared_reference_rows(self):
        """Two families asking for the same reference distribution in one
        round must cost a single probe (the CachingRunner dedupes)."""
        cached = CachingRunner(SimRunner(make_h100_like(seed=9)))
        req = ("L1", 64 * KIB, 32)
        rows = cached.pchase_many([req, req, ("L2", 1 * MIB, 32)], 9)
        assert rows.shape[0] == 3
        assert np.array_equal(rows[0], rows[1])
        assert cached.cache.stats()["misses"] == 2   # deduped fetch


# ------------------------------------------------------------ store GC
class TestStoreGc:
    def _seed_store(self, tmp_path, n=4):
        from repro_torch.core.engine.store import TopologyStore
        from repro_torch.core.topology import Topology

        store = TopologyStore(str(tmp_path))
        for i in range(n):
            t = Topology(vendor="x", model=f"m{i}", backend="test")
            store.put(f"k{i}", t, meta={"created_at": 1000.0 + i})
            store.put_samples(f"k{i}", {("pchase", "L1", i): np.ones(3)})
        return store

    def test_gc_max_entries_evicts_oldest_pairs(self, tmp_path):
        store = self._seed_store(tmp_path)
        report = store.gc(max_entries=2)
        assert report["evicted"] == ["k0", "k1"]
        assert store.keys() == ["k2", "k3"]
        assert store.load_samples("k0") is None      # samples went with it
        assert store.load_samples("k3") is not None

    def test_gc_max_age(self, tmp_path):
        store = self._seed_store(tmp_path)
        report = store.gc(max_age_s=1.5, now=1004.0)  # horizon 1002.5
        assert report["evicted"] == ["k0", "k1", "k2"]
        assert store.keys() == ["k3"]

    def test_gc_sweeps_orphaned_samples(self, tmp_path):
        store = self._seed_store(tmp_path)
        import os
        os.remove(store._topo_path("k1"))            # orphan k1's samples
        report = store.gc()
        assert report["orphans"] == 1
        assert store.load_samples("k1") is None

    def test_gc_noop_without_limits(self, tmp_path):
        store = self._seed_store(tmp_path)
        report = store.gc()
        assert report["evicted"] == [] and len(store.keys()) == 4

    def test_discover_gc_policy_wired(self, tmp_path):
        from repro_torch.core.engine.store import TopologyStore

        store = TopologyStore(str(tmp_path))
        for seed in (1, 2, 3):
            discover_sim(make_h100_like(seed=seed), n_samples=9,
                         store=store, gc_policy=GcPolicy(max_entries=2))
        assert len(store.keys()) == 2


# ----------------------------------------------------- CUDA runner (CPU)
class TestPlannedCuda:
    """The CUDA runner on the CPU (the kernels' plain versions).  Its rows
    are real timed measurements, so — exactly as for the reference's Pallas
    runner — planner-vs-dense identity is asserted over *shared* rows (one
    CachingRunner: the dense sweep measures, the planner descends over the
    cached rows plus a handful of fresh ones, and its fallback rules absorb
    fresh-row flukes).  A measured miss gets one retry, as the reference's
    acceptance gives its Pallas discovery."""

    @staticmethod
    def _shared_rows_agree() -> bool:
        from repro_torch.core.probes import CudaRunner

        cached = CachingRunner(CudaRunner(device="cpu", base_steps=512))
        info = {i.name: i for i in cached.spaces()}
        for space, step in (("L1", 32), ("VMEM", 4), ("L2", 32)):
            kw = dict(lo=1024, step=step, n_samples=9,
                      max_bytes=info[space].max_bytes)
            d = find_size(cached, space, batched=True, **kw)
            p = find_size(cached, space, budget=SweepBudget(), **kw)
            if d.found != p.found:
                return False
            # boundary windows are re-measured fresh on measuring runners
            # (drift robustness): one-lattice-step agreement
            if d.found and abs(d.size - p.size) > 2 * max(_grid_step(d),
                                                          _grid_step(p)):
                return False
        dg = find_fetch_granularity(cached, "L1", n_samples=9, batched=True)
        pg = find_fetch_granularity(cached, "L1", n_samples=9,
                                    budget=SweepBudget())
        dl = find_line_size(cached, "L1", 16 * KIB, 32, n_samples=9,
                            batched=True)
        pl = find_line_size(cached, "L1", 16 * KIB, 32, n_samples=9,
                            budget=SweepBudget())
        return ((dg.granularity, dg.found) == (pg.granularity, pg.found)
                and (dl.line_size, dl.found) == (pl.line_size, pl.found))

    def test_planner_vs_dense_discrete_identity_shared_rows(self):
        torch = pytest.importorskip("torch")
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            assert self._shared_rows_agree() or self._shared_rows_agree()
        finally:
            torch.set_num_threads(threads)


# ---------------------------------------- bit for bit against the reference
def _without_notes(topo) -> dict:
    d = topo.to_json()
    d.pop("notes")
    return d


def _counting_dispatchers(monkeypatch, fusion_module) -> list:
    """Record every FusionDispatcher ``fusion_module`` builds."""
    made = []
    init = fusion_module.FusionDispatcher.__init__

    def recording_init(self, runner):
        init(self, runner)
        made.append(self)

    monkeypatch.setattr(fusion_module.FusionDispatcher, "__init__",
                        recording_init)
    return made


@pytest.mark.parametrize("device", ["make_h100_like", "make_mi210_like"])
@pytest.mark.parametrize("seed", [3, 48])
def test_planned_fused_discover_sim_equals_reference(monkeypatch, device,
                                                     seed):
    import repro.core as ref
    import repro.core.engine.fusion as ref_fusion
    import repro_torch.core.engine.fusion as port_fusion

    ref_made = _counting_dispatchers(monkeypatch, ref_fusion)
    port_made = _counting_dispatchers(monkeypatch, port_fusion)
    want, wt = ref.discover_sim(getattr(ref, device)(seed=seed),
                                n_samples=17, budget=ref.SweepBudget(),
                                fuse=True)
    got, gt = discover_sim(getattr(repro_torch_core, device)(seed=seed),
                           n_samples=17, budget=SweepBudget(), fuse=True)
    assert _without_notes(got) == _without_notes(want)
    assert gt.meta["cache"] == wt.meta["cache"]
    assert gt.meta["planned"] is wt.meta["planned"] is True
    assert len(ref_made) == len(port_made) == 1
    (r,), (p,) = ref_made, port_made
    assert (p.rounds, p.fused_calls, p.split_rounds) == \
        (r.rounds, r.fused_calls, r.split_rounds)
    assert gt.meta["fusion"] == {"rounds": p.rounds,
                                 "fused_calls": p.fused_calls,
                                 "fused_rows": p.fused_rows}


def test_fused_dispatches_carry_their_rows_families():
    """A round that fuses two families' rows runs under both names, joined
    in sorted order; an unfused inline run under each item's own."""
    from repro_torch.core.probes.runners import CURRENT_FAMILY

    seen = []

    class FamilyLog(SimRunner):
        def pchase_many(self, requests, n_samples):
            seen.append(CURRENT_FAMILY.get())
            return super().pchase_many(requests, n_samples)

    dispatcher = FusionDispatcher(CachingRunner(FamilyLog(
        make_h100_like(seed=8))))
    proxy = dispatcher.proxy()

    def probe(space):
        def fn(_results, space=space):
            return proxy.pchase(space, 64 * KIB, 32, 9)
        return fn

    run_fused([WorkItem(key="a", fn=probe("L1"), family="size"),
               WorkItem(key="b", fn=probe("L2"), family="latency")],
              dispatcher)
    assert seen == ["latency+size"]
    assert CURRENT_FAMILY.get() == ""
