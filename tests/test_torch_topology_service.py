"""The reference's query-service cases (``tests/test_topology_service.py``),
re-pointed at the port: dotted-path lookups with aliases, batched lookup
grouping, the LRU hot set (generation-validated and thread-safe),
provenance/confidence filters, adjacency, and the topology diff endpoint."""
import threading

import pytest

from repro_torch.core import discover_sim, make_h100_like, make_mi210_like
from repro_torch.core.engine.store import TopologyStore
from repro_torch.serve.topology_service import TopologyService

KIB, MIB = 1024, 1024**2


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    store = TopologyStore(str(tmp_path_factory.mktemp("svc") / "store"))
    discover_sim(make_h100_like(seed=71), n_samples=9, store=store)
    discover_sim(make_mi210_like(seed=72), n_samples=9, store=store)
    return store


@pytest.fixture
def svc(store):
    return TopologyService(store, hot_set=4)


def _key_of(store, model):
    return next(e.key for e in store.entries() if e.meta["model"] == model)


class TestQuery:
    def test_memory_attribute_lookup(self, svc, store):
        k = _key_of(store, "sim-h100")
        q = svc.query(k, "L1.size")
        assert q.found and q.element == "L1"
        assert abs(q.value - 238 * KIB) <= 2 * KIB
        assert q.unit == "B" and q.provenance == "benchmark"
        assert q.confidence > 0    # K-S confidence metric (unbounded above)

    def test_aliases(self, svc, store):
        k = _key_of(store, "sim-h100")
        assert svc.query(k, "hbm.bandwidth").element == "DeviceMemory"
        assert svc.query(k, "hbm.bandwidth").value == \
            svc.query(k, "DeviceMemory.read_bw").value
        assert svc.query(k, "l2.load_latency").found     # case-insensitive
        # l1 alias resolves vL1 on the AMD-style device
        k_amd = _key_of(store, "sim-mi210")
        assert svc.query(k_amd, "l1.size").element == "vL1"
        assert svc.query(k_amd, "vL1.latency").value == \
            svc.query(k_amd, "vL1.load_latency").value

    def test_general_and_compute_roots(self, svc, store):
        k = _key_of(store, "sim-h100")
        assert svc.query(k, "general.clock_domain").value == "cycles"
        assert svc.query(k, "compute.cores_per_sm").value == 128

    def test_misses_are_clean(self, svc, store):
        k = _key_of(store, "sim-h100")
        assert not svc.query(k, "L1.nonexistent").found
        assert not svc.query(k, "NoSuchElement.size").found
        assert not svc.query("0" * 32, "L1.size").found

    def test_batched_lookup_loads_each_topology_once(self, store):
        svc = TopologyService(store, hot_set=4)
        keys = store.keys()
        reqs = [(k, p) for k in keys
                for p in ("L2.load_latency", "hbm.bandwidth", "L1.size")] * 3
        store_reads_before = store.hits
        answers = svc.query_batch(reqs)
        assert len(answers) == len(reqs)
        assert all(a.found for a in answers)
        # one store read per distinct key, everything else from the hot set
        assert store.hits - store_reads_before == len(keys)
        # answers align with their requests
        for (k, p), a in zip(reqs, answers):
            assert (a.key, a.path) == (k, p)


class TestHotSet:
    def test_lru_eviction(self, store):
        svc = TopologyService(store, hot_set=1)
        k1, k2 = store.keys()
        svc.get(k1)
        svc.get(k2)          # evicts k1
        svc.get(k1)          # store read again
        stats = svc.stats()
        assert stats["hot_set"] == 1
        assert stats["lru_misses"] == 3

    def test_hot_hits_skip_the_store(self, store):
        svc = TopologyService(store, hot_set=4)
        k = store.keys()[0]
        svc.get(k)
        before = store.hits
        for _ in range(10):
            svc.get(k)
        assert store.hits == before
        assert svc.stats()["lru_hits"] == 10


class TestHotSetFreshness:
    """the LRU must never serve a dead generation —
    a refresh rewrite, a GC eviction, or a quarantine invalidates the
    cached object instead of pinning it forever."""

    def test_refresh_under_live_service_serves_the_new_value(self, tmp_path):
        store = TopologyStore(str(tmp_path / "fresh"))
        dev = make_h100_like(seed=91)
        discover_sim(dev, n_samples=9, store=store)
        key = store.keys()[0]

        svc = TopologyService(store, hot_set=4)
        stale = svc.query(key, "L1.load_latency")
        assert stale.found
        assert svc.query(key, "L1.load_latency").value == stale.value  # hot

        # refresh=True re-measures and rewrites the same content-addressed
        # key; same request => same values, but the service must reload.
        misses_before = svc.stats()["lru_misses"]
        discover_sim(dev, n_samples=9, store=store, refresh=True)
        assert svc.query(key, "L1.load_latency").value == stale.value
        assert svc.stats()["lru_misses"] > misses_before

        # a divergent rewrite (new firmware run) is visible at once
        entry = store.get(key)
        entry.topology.find_memory("L1").set("load_latency", 777.5, "cyc",
                                             "benchmark")
        store.put(key, entry.topology, meta=entry.meta)
        assert svc.query(key, "L1.load_latency").value == 777.5

    def test_gc_eviction_stops_serving_the_cached_object(self, tmp_path):
        store = TopologyStore(str(tmp_path / "gcd"))
        discover_sim(make_h100_like(seed=92), n_samples=9, store=store)
        key = store.keys()[0]
        svc = TopologyService(store)
        assert svc.get(key) is not None           # hot
        store.gc(max_entries=0)
        assert svc.get(key) is None               # evicted, not stale-served

    def test_cross_process_writer_is_visible(self, tmp_path):
        """A second store handle on the same root (another process's view)
        rewriting a key invalidates this service's hot entry."""
        root = str(tmp_path / "shared")
        store = TopologyStore(root)
        discover_sim(make_h100_like(seed=93), n_samples=9, store=store)
        key = store.keys()[0]
        svc = TopologyService(store)
        svc.get(key)                              # hot

        other = TopologyStore(root)
        entry = other.get(key)
        entry.topology.find_memory("L1").set("size", 12345, "B", "benchmark")
        other.put(key, entry.topology, meta=entry.meta)
        assert svc.query(key, "L1.size").value == 12345


class TestThreadSafety:
    """LRU mutation and the hit/miss counters sit
    behind a lock — a threaded front end cannot corrupt them."""

    N_THREADS = 8
    QUERIES_PER_THREAD = 200

    def test_hammer_counters_sum_and_no_lost_entries(self, store):
        svc = TopologyService(store, hot_set=1)    # max eviction contention
        keys = store.keys()
        errors = []

        def hammer(tid):
            try:
                for i in range(self.QUERIES_PER_THREAD):
                    k = keys[(tid + i) % len(keys)]
                    assert svc.get(k) is not None
            except Exception as e:      # noqa: BLE001 — surfaced below
                errors.append(e)

        threads = [threading.Thread(target=hammer, args=(i,))
                   for i in range(self.N_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors
        stats = svc.stats()
        # no lost counter increments: hits + misses == total get() calls
        assert stats["lru_hits"] + stats["lru_misses"] == \
            self.N_THREADS * self.QUERIES_PER_THREAD
        # the LRU respected its bound under contention
        assert stats["hot_set"] <= 1
        # and the store still serves every entry (nothing corrupted/lost)
        for k in keys:
            assert svc.query(k, "general.clock_domain").found

    def test_concurrent_query_batch_alignment(self, store):
        svc = TopologyService(store, hot_set=2)
        keys = store.keys()
        reqs = [(k, p) for k in keys
                for p in ("L2.load_latency", "hbm.bandwidth")] * 10
        bad = []

        def batch(_tid):
            for _ in range(20):
                answers = svc.query_batch(reqs)
                if not all(a.found and (a.key, a.path) == r
                           for a, r in zip(answers, reqs)):
                    bad.append(answers)

        threads = [threading.Thread(target=batch, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not bad


class TestFiltersAndAdjacency:
    def test_provenance_filter(self, svc, store):
        k = _key_of(store, "sim-h100")
        api = svc.attributes(k, provenance="api")
        bench = svc.attributes(k, provenance="benchmark")
        assert api and bench
        assert all(a.provenance == "api" for a in api)
        # L2 total size is API-provided (paper Table I), L1 size measured
        assert any(a.element == "L2" and a.path.endswith(".size") for a in api)

    def test_confidence_filter(self, svc, store):
        k = _key_of(store, "sim-h100")
        confident = svc.attributes(k, min_confidence=0.9)
        assert confident
        assert all(a.confidence >= 0.9 for a in confident)
        loose = svc.attributes(k, min_confidence=0.0)
        assert len(loose) >= len(confident)

    def test_adjacency_view(self, svc, store):
        k = _key_of(store, "sim-h100")
        adj = svc.adjacency(k)
        assert set(adj["L1"]) >= {"Texture", "Readonly"}
        assert "ConstL1" not in adj.get("L1", [])


class TestDiff:
    def test_same_device_same_seed_identical(self, store, tmp_path):
        other = TopologyStore(str(tmp_path / "other"))
        discover_sim(make_h100_like(seed=71), n_samples=9, store=other)
        # copy the second run into the main store under a distinct key
        entry = other.entries()[0]
        store.put("copy-under-test", entry.topology, meta=entry.meta)
        svc = TopologyService(store)
        d = svc.diff(_key_of(store, "sim-h100"), "copy-under-test")
        assert d.identical
        assert d.matching > 10
        store.delete("copy-under-test")

    def test_cross_vendor_diff_structured(self, svc, store):
        d = svc.diff(_key_of(store, "sim-h100"), _key_of(store, "sim-mi210"))
        assert not d.identical
        assert "L1" in d.only_in_a and "vL1" in d.only_in_b
        changed = {(c.element, c.attr) for c in d.changed}
        assert ("L2", "load_latency") in changed
        lat = next(c for c in d.changed
                   if (c.element, c.attr) == ("L2", "load_latency"))
        assert lat.rel_delta > 0.2

    def test_rel_tol_absorbs_jitter(self, svc, store, tmp_path):
        other = TopologyStore(str(tmp_path / "jitter"))
        discover_sim(make_h100_like(seed=99), n_samples=9, store=other)
        entry = other.entries()[0]
        store.put("jitter-run", entry.topology, meta=entry.meta)
        svc2 = TopologyService(store)
        strict = svc2.diff(_key_of(store, "sim-h100"), "jitter-run")
        loose = svc2.diff(_key_of(store, "sim-h100"), "jitter-run",
                          rel_tol=0.25)
        assert len(loose.changed) <= len(strict.changed)
        assert loose.matching >= strict.matching
        store.delete("jitter-run")

    def test_missing_key_raises(self, svc, store):
        with pytest.raises(KeyError, match="not in store"):
            svc.diff(store.keys()[0], "nope")
