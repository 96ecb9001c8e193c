"""The reference's topology-store cases, re-pointed at the port: round-trip
fidelity, read-through discovery that issues ZERO runner probes on a hit,
sample-cache persistence, corruption recovery, locking, generations and the
checkpoint API.  The catalog's discovered-before-datasheet fallback waits
for the port's ``catalog`` (``CATALOG``/``get_spec``).

Cross-checks: ``request_key`` of the same descriptors, and the descriptors
themselves, are equal in both packages — the sim descriptor with and
without a budget and survey, and the port's CUDA descriptor against the
reference's Pallas one laid out the same way — so one store is addressed
alike by both."""
import json
import os

import numpy as np
import pytest

import repro_torch.core as repro_core
from repro_torch.core import (SweepBudget, discover_sim, make_h100_like,
                              make_mi210_like)
from repro_torch.core.discover import (cuda_request_descriptor,
                                       sim_request_descriptor)
from repro_torch.core.engine import SampleCache
from repro_torch.core.engine.store import TopologyStore, request_key

KIB = 1024

# Every runner method that reaches the device for measurement.
PROBE_METHODS = ("pchase", "pchase_batch", "cold_chase", "cold_chase_batch",
                 "amount_probe", "sharing_probe", "cu_sharing_probe",
                 "cu_sharing_probe_batch", "bandwidth")


class CountingDevice:
    """Transparent SimDevice proxy counting every probe-serving call."""

    def __init__(self, device):
        self._device = device
        self.probe_calls = 0

    def __getattr__(self, name):
        attr = getattr(self._device, name)
        if name in PROBE_METHODS:
            def counted(*args, _attr=attr, **kw):
                self.probe_calls += 1
                return _attr(*args, **kw)
            return counted
        return attr


@pytest.fixture
def store(tmp_path):
    return TopologyStore(str(tmp_path / "topo-store"))


class TestRequestKey:
    def test_deterministic_and_sensitive(self):
        d1 = sim_request_descriptor(make_h100_like(seed=1), 17, None)
        d2 = sim_request_descriptor(make_h100_like(seed=1), 17, None)
        assert request_key(d1) == request_key(d2)
        d3 = sim_request_descriptor(make_h100_like(seed=2), 17, None)
        d4 = sim_request_descriptor(make_h100_like(seed=1), 33, None)
        d5 = sim_request_descriptor(make_h100_like(seed=1), 17, ["L1"])
        keys = {request_key(d) for d in (d1, d3, d4, d5)}
        assert len(keys) == 4

    def test_key_order_insensitive(self):
        a = {"x": 1, "y": "z"}
        b = {"y": "z", "x": 1}
        assert request_key(a) == request_key(b)


class TestRoundTrip:
    def test_topology_disk_roundtrip_bit_equal(self, store):
        """Topology -> disk -> Topology, bit-equal including provenance,
        confidence (full precision), sharing lists, and notes."""
        topo, _ = discover_sim(make_h100_like(seed=21), n_samples=9)
        store.put("k1", topo)
        back = store.get("k1").topology
        assert back.to_json() == topo.to_json()
        l1a, l1b = topo.find_memory("L1"), back.find_memory("L1")
        assert l1b.attrs["size"].confidence == l1a.attrs["size"].confidence
        assert l1b.attrs["size"].provenance == l1a.attrs["size"].provenance
        assert l1b.shared_with == l1a.shared_with
        assert back.notes == topo.notes

    def test_meta_defaults_and_merge(self, store):
        topo, _ = discover_sim(make_h100_like(seed=21), n_samples=9)
        store.put("k1", topo, meta={"custom": "x"})
        meta = store.get("k1").meta
        assert meta["model"] == "sim-h100"
        assert meta["vendor"] == "NVIDIA"
        assert meta["custom"] == "x"
        assert meta["created_at"] > 0

    def test_sample_cache_roundtrip(self, store):
        cache = SampleCache()
        cache.get_or_run(("pchase", "L1", 1024, 32, 9),
                         lambda: np.arange(9.0))
        cache.get_or_run(("cold", "L1", 2048, 64, 9),
                         lambda: np.ones(9) * 3.5)
        store.put_samples("k1", cache.snapshot())
        loaded = store.load_samples("k1")
        assert set(loaded) == {("pchase", "L1", 1024, 32, 9),
                               ("cold", "L1", 2048, 64, 9)}
        assert np.array_equal(loaded[("pchase", "L1", 1024, 32, 9)],
                              np.arange(9.0))
        fresh = SampleCache()
        fresh.preload(loaded)
        hit = fresh.get_or_run(("cold", "L1", 2048, 64, 9),
                               lambda: (_ for _ in ()).throw(AssertionError))
        assert np.array_equal(hit, np.ones(9) * 3.5)


class TestReadThrough:
    def test_second_discovery_issues_zero_probes(self, store):
        """The acceptance headline: an identical request hits the store and
        never reaches the runner — asserted by counting device calls."""
        first = CountingDevice(make_h100_like(seed=31))
        topo1, _ = discover_sim(first, n_samples=9, store=store)
        assert first.probe_calls > 0

        second = CountingDevice(make_h100_like(seed=31))
        topo2, t2 = discover_sim(second, n_samples=9, store=store)
        assert second.probe_calls == 0
        assert topo2.to_json() == topo1.to_json()
        # the hit reconstructs the recorded per-family timings
        assert set(t2.per_family) >= {"size", "latency"}

    def test_different_request_misses(self, store):
        discover_sim(make_h100_like(seed=31), n_samples=9, store=store)
        other = CountingDevice(make_h100_like(seed=32))   # different seed
        discover_sim(other, n_samples=9, store=store)
        assert other.probe_calls > 0
        assert len(store.keys()) == 2

    def test_refresh_bypasses_read_but_writes_through(self, store):
        discover_sim(make_h100_like(seed=31), n_samples=9, store=store)
        dev = CountingDevice(make_h100_like(seed=31))
        topo, _ = discover_sim(dev, n_samples=9, store=store, refresh=True)
        assert dev.probe_calls > 0                    # re-measured
        key = store.keys()[0]
        assert store.get(key).topology.to_json() == topo.to_json()

    def test_refresh_ignores_stale_persisted_samples(self, store):
        """refresh=True is a real re-measure: tampered/stale sample rows on
        disk must not be preloaded into the probe cache."""
        topo, _ = discover_sim(make_h100_like(seed=34), n_samples=9,
                               store=store)
        key = store.keys()[0]
        stale = {k: np.asarray(v) * 7.0           # corrupt every latency row
                 for k, v in store.load_samples(key).items()}
        store.put_samples(key, stale)
        fresh, _ = discover_sim(make_h100_like(seed=34), n_samples=9,
                                store=store, refresh=True)
        # measured, not served stale (notes differ: they embed wall time)
        a, b = fresh.to_json(), topo.to_json()
        a.pop("notes"), b.pop("notes")
        assert a == b

    def test_legacy_path_also_writes_through(self, store):
        topo, _ = discover_sim(make_h100_like(seed=33), n_samples=9,
                               store=store, engine=False)
        dev = CountingDevice(make_h100_like(seed=33))
        topo2, _ = discover_sim(dev, n_samples=9, store=store)
        assert dev.probe_calls == 0
        assert topo2.to_json() == topo.to_json()


class TestCorruptionRecovery:
    def _key_and_path(self, store):
        key = store.keys()[0]
        return key, store._topo_path(key)

    def test_corrupt_topology_quarantined_and_rediscovered(self, store):
        discover_sim(make_h100_like(seed=41), n_samples=9, store=store)
        key, path = self._key_and_path(store)
        with open(path, "w") as f:
            f.write("{ not json !!")
        dev = CountingDevice(make_h100_like(seed=41))
        topo, _ = discover_sim(dev, n_samples=9, store=store)
        assert topo.find_memory("L1") is not None     # recovered via re-run
        assert not os.path.exists(path) or store.get(key) is not None
        assert store.corrupt >= 1
        assert os.listdir(os.path.join(store.root, "corrupt"))
        # the re-run wrote a fresh, readable entry back under the same key
        assert store.get(key).topology.to_json() == topo.to_json()

    def test_corrupt_samples_quarantined(self, store):
        discover_sim(make_h100_like(seed=41), n_samples=9, store=store)
        key = store.keys()[0]
        with open(store._samples_path(key), "wb") as f:
            f.write(b"\x00\x01 definitely not an npz")
        assert store.load_samples(key) is None
        assert store.corrupt >= 1

    def test_corrupt_topology_with_intact_samples_serves_from_cache(self, store):
        """Partial recovery: topology JSON lost, sample rows intact — the
        re-run reassembles from disk-served rows (only uncacheable calls
        like bandwidth reach the device)."""
        dev0 = CountingDevice(make_h100_like(seed=42))
        discover_sim(dev0, n_samples=9, store=store)
        full_run_calls = dev0.probe_calls
        key, path = self._key_and_path(store)
        os.remove(path)
        dev = CountingDevice(make_h100_like(seed=42))
        topo, _ = discover_sim(dev, n_samples=9, store=store)
        assert topo.find_memory("L1") is not None
        assert 0 < dev.probe_calls < full_run_calls / 2

    def test_missing_key_is_clean_miss(self, store):
        assert store.get("deadbeef" * 4) is None
        assert store.load_samples("deadbeef" * 4) is None
        assert store.stats()["misses"] >= 1


class TestFind:
    def test_newest_entry_wins(self, store):
        d1, _ = discover_sim(make_h100_like(seed=51), n_samples=9, store=store)
        # A later run of the same device identity under a different request:
        d2, _ = discover_sim(make_h100_like(seed=52), n_samples=9, store=store)
        entries = store.find(model="sim-h100")
        assert len(entries) == 2
        assert entries[0].meta["created_at"] >= entries[1].meta["created_at"]


class TestStoreHygiene:
    def test_atomic_write_leaves_no_tmp_files(self, store):
        discover_sim(make_h100_like(seed=61), n_samples=9, store=store)
        for sub in ("topologies", "samples"):
            names = os.listdir(os.path.join(store.root, sub))
            assert not [n for n in names if ".tmp." in n]

    def test_delete(self, store):
        discover_sim(make_h100_like(seed=61), n_samples=9, store=store)
        key = store.keys()[0]
        store.delete(key)
        assert not store.has(key)
        assert store.load_samples(key) is None

    def test_stored_doc_shape(self, store):
        """The on-disk document is plain JSON a non-Python consumer can read."""
        discover_sim(make_h100_like(seed=61), n_samples=9, store=store)
        key = store.keys()[0]
        with open(store._topo_path(key)) as f:
            doc = json.load(f)
        assert set(doc) == {"meta", "topology"}
        assert doc["meta"]["schema"] == 1
        assert doc["topology"]["vendor"] == "NVIDIA"


class TestStoreLocking:
    """Advisory write locking: one lock file per store root, re-entrant
    within a thread, exclusive across holders, and spanning the
    topology+samples persist pair so concurrent discoveries cannot
    interleave the two files of different runs."""

    def test_lock_file_created_and_reentrant(self, store):
        lock = store.lock()
        with lock:
            assert lock.held
            with lock:                     # re-entrant: no deadlock
                assert lock.held
            assert lock.held               # inner exit keeps the outer hold
        assert not lock.held
        assert os.path.exists(os.path.join(store.root, ".lock"))

    def test_exclusive_across_independent_holders(self, store):
        """A second StoreLock on the same path (another process's view)
        must block until the first releases."""
        import threading
        import time as _time

        from repro_torch.core.engine.store import StoreLock

        other = StoreLock(os.path.join(store.root, ".lock"))
        order = []
        store.lock().acquire()
        try:
            t = threading.Thread(
                target=lambda: (other.acquire(), order.append("locked"),
                                other.release()))
            t.start()
            _time.sleep(0.15)
            assert order == []             # still blocked on our hold
        finally:
            store.lock().release()
        t.join(timeout=5)
        assert order == ["locked"]

    def test_writes_take_the_lock(self, store):
        """Bare put/put_samples/delete acquire the advisory lock on their
        own (observable through re-entrancy: they nest under a held lock
        without deadlocking, and leave it held afterwards)."""
        topo, _ = discover_sim(make_h100_like(seed=61), n_samples=9)
        lock = store.lock()
        with lock:
            store.put("lk", topo)
            store.put_samples("lk", {("pchase", "L1", 1, 2, 3):
                                     np.ones(3)})
            store.delete("lk")
            assert lock.held

    def test_in_process_thread_gate_mutual_exclusion(self, store):
        """Two threads in one process must serialize on
        the store lock even where the file lock cannot arbitrate them
        (fcntl-emulated flock treats record locks as per-process).  The
        in-process ``threading.Lock`` layer makes the critical section
        single-occupancy by construction, observable as an occupancy
        counter that never exceeds 1."""
        import threading
        import time as _time

        lock = store.lock()
        inside = []
        overlaps = []

        def critical(tid):
            for _ in range(30):
                with lock:
                    inside.append(tid)
                    if len(inside) > 1:
                        overlaps.append(list(inside))
                    _time.sleep(0.0005)
                    inside.remove(tid)

        threads = [threading.Thread(target=critical, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not overlaps
        assert not lock.held

    def test_two_thread_persist_pair_never_interleaves(self, store):
        """Two threads persisting the topology+samples pair under the lock:
        the written pair must always come from a single writer (the
        event order is strictly enter/exit bracketed per thread)."""
        import threading

        topo, _ = discover_sim(make_h100_like(seed=73), n_samples=9)
        events = []

        def persist(writer_id):
            for i in range(10):
                with store.lock():
                    events.append(("enter", writer_id))
                    store.put(f"pair-{writer_id}", topo,
                              meta={"writer": writer_id, "i": i})
                    store.put_samples(f"pair-{writer_id}",
                                      {("w",): np.full(2, writer_id)})
                    events.append(("exit", writer_id))

        threads = [threading.Thread(target=persist, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        # strictly bracketed: every enter is immediately followed by the
        # same writer's exit — no interleaving inside the locked pair
        assert len(events) == 2 * 2 * 10
        for enter, exit_ in zip(events[::2], events[1::2]):
            assert enter == ("enter", exit_[1]) and exit_[0] == "exit"
        assert store.corrupt == 0

    def test_concurrent_persist_pairs_stay_consistent(self, store):
        """Writers racing on the SAME key must never interleave the
        topology/samples pair: whoever holds the lock last writes both
        files, so the final topology's marker and the final sample
        archive's marker must agree.  (Without the lock spanning the pair,
        the last topology and last samples can come from different
        writers.)"""
        import threading

        topo, _ = discover_sim(make_h100_like(seed=70), n_samples=9)

        def persist(writer_id):
            for _ in range(25):
                marked = json.loads(json.dumps(topo.to_json()))
                with store.lock():
                    store.put("contended", type(topo).from_json(marked),
                              meta={"writer": writer_id})
                    store.put_samples(
                        "contended",
                        {("writer",): np.full(3, writer_id, np.int64)})

        threads = [threading.Thread(target=persist, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        entry = store.get("contended")
        samples = store.load_samples("contended")
        assert entry is not None and samples is not None
        assert int(samples[("writer",)][0]) == entry.meta["writer"]
        assert store.corrupt == 0


class TestGenerations:
    """Per-key freshness tokens: the serving layer's staleness oracle."""

    def test_generation_changes_on_put_and_dies_on_delete(self, store):
        topo, _ = discover_sim(make_h100_like(seed=74), n_samples=9)
        assert store.generation("g") is None
        store.put("g", topo)
        g1 = store.generation("g")
        assert g1 is not None
        store.put("g", topo, meta={"rev": 2})
        g2 = store.generation("g")
        assert g2 is not None and g2 != g1
        store.delete("g")
        assert store.generation("g") is None

    def test_gc_eviction_kills_the_generation(self, store):
        topo, _ = discover_sim(make_h100_like(seed=75), n_samples=9)
        store.put("g", topo)
        assert store.generation("g") is not None
        store.gc(max_entries=0)
        assert store.generation("g") is None

    def test_quarantine_detection(self, store):
        topo, _ = discover_sim(make_h100_like(seed=76), n_samples=9)
        store.put("q", topo)
        assert not store.is_quarantined("q")
        with open(store._topo_path("q"), "w") as f:
            f.write("not json at all")
        assert store.get("q") is None            # quarantines the file
        assert store.is_quarantined("q")
        assert store.generation("q") is None
        # a fresh put clears the quarantined verdict (newer doc wins)
        store.put("q", topo)
        assert not store.is_quarantined("q")
        assert store.get("q") is not None

    def test_unknown_key_is_neither_present_nor_quarantined(self, store):
        assert store.generation("never-stored") is None
        assert not store.is_quarantined("never-stored")


class TestLockfileFallbackStaleBreak:
    """The non-fcntl lockfile fallback must break stale
    locks only when the recorded holder pid is verifiably dead — age alone
    never justifies unlinking another process's live lock, and a fresh
    lockfile is never touched regardless of its pid."""

    @pytest.fixture
    def fallback_lock(self, tmp_path, monkeypatch):
        """A StoreLock forced onto the exclusive-create lockfile path."""
        import repro_torch.core.engine.store as store_module
        monkeypatch.setattr(store_module, "fcntl", None)
        return store_module.StoreLock(
            str(tmp_path / ".lock"), timeout=0.4, poll=0.01,
            stale_seconds=5.0)

    @staticmethod
    def _dead_pid():
        """A pid guaranteed to belong to no running process (reaped child)."""
        import subprocess
        import sys
        p = subprocess.Popen([sys.executable, "-c", "pass"])
        p.wait()
        return p.pid

    @staticmethod
    def _plant(path, content, *, age_s=0.0):
        with open(path, "w") as f:
            f.write(content)
        if age_s:
            import time as _time
            old = _time.time() - age_s
            os.utime(path, (old, old))

    def test_dead_holder_stale_lock_is_broken(self, fallback_lock):
        self._plant(fallback_lock.path, str(self._dead_pid()), age_s=1000.0)
        fallback_lock.acquire()                 # breaks + acquires, no timeout
        try:
            assert fallback_lock.held
            with open(fallback_lock.path) as f:
                assert int(f.read()) == os.getpid()
        finally:
            fallback_lock.release()
        assert not os.path.exists(fallback_lock.path)

    def test_live_holder_never_broken_regardless_of_age(self, fallback_lock):
        """The documented race fix: a decade-old lockfile whose holder is
        alive (a long critical section, not a crash) must never be broken."""
        self._plant(fallback_lock.path, str(os.getpid()), age_s=1_000_000.0)
        with pytest.raises(TimeoutError, match="store lock busy"):
            fallback_lock.acquire()
        assert os.path.exists(fallback_lock.path)   # lock left intact
        with open(fallback_lock.path) as f:
            assert int(f.read()) == os.getpid()

    def test_fresh_lock_not_broken_even_with_dead_pid(self, fallback_lock):
        """Age gates before liveness: a just-created lock (holder may not
        have written its pid yet, or pid was recycled) is left alone."""
        self._plant(fallback_lock.path, str(self._dead_pid()))
        with pytest.raises(TimeoutError, match="store lock busy"):
            fallback_lock.acquire()
        assert os.path.exists(fallback_lock.path)

    def test_unreadable_pid_is_treated_as_dead_once_stale(self, fallback_lock):
        self._plant(fallback_lock.path, "not-a-pid", age_s=1000.0)
        fallback_lock.acquire()
        fallback_lock.release()
        assert not os.path.exists(fallback_lock.path)

    def test_fallback_mutual_exclusion_and_release(self, fallback_lock):
        """Sanity: the fallback still excludes a second holder and the
        release unlinks so the next acquire is immediate."""
        import repro_torch.core.engine.store as store_module
        other = store_module.StoreLock(fallback_lock.path, timeout=0.2,
                                       poll=0.01)
        fallback_lock.acquire()
        try:
            assert store_module.fcntl is None
            with pytest.raises(TimeoutError):
                other.acquire()
        finally:
            fallback_lock.release()
        other.acquire()                         # immediate after release
        other.release()


class TestCheckpointAPI:
    """Checkpoint persistence for interrupted discoveries —
    put/load/clear round-trip, corruption quarantine, and lifecycle ties
    to delete/gc."""

    ENTRIES = {
        ("pchase", "L1", 4096, 32, 9): np.arange(9, dtype=np.float64),
        ("cold", "L2", 1 << 20, 64, 9): np.full(9, 3.5),
    }
    FAMILIES = [("L1", "size"), ("L1", "latency"), "<device>/sharing"]

    def test_roundtrip_bit_equal(self, store):
        assert not store.has_checkpoint("k1")
        store.put_checkpoint("k1", self.ENTRIES, self.FAMILIES)
        assert store.has_checkpoint("k1")
        entries, families = store.load_checkpoint("k1")
        assert set(entries) == set(self.ENTRIES)
        for k, arr in self.ENTRIES.items():
            np.testing.assert_array_equal(entries[k], arr)
        assert families == [("L1", "size"), ("L1", "latency"),
                            "<device>/sharing"]

    def test_missing_checkpoint_is_none(self, store):
        assert store.load_checkpoint("nope") is None
        assert not store.has_checkpoint("nope")

    def test_clear_checkpoint(self, store):
        store.put_checkpoint("k2", self.ENTRIES)
        store.clear_checkpoint("k2")
        assert not store.has_checkpoint("k2")
        store.clear_checkpoint("k2")            # idempotent on a missing file

    def test_corrupted_checkpoint_quarantined_to_miss(self, store):
        """A damaged checkpoint degrades to a from-scratch run — load
        returns None and the file is quarantined, never raised."""
        store.put_checkpoint("k3", self.ENTRIES)
        with open(store._ckpt_path("k3"), "wb") as f:
            f.write(b"\x00\x01 definitely not an npz")
        assert store.load_checkpoint("k3") is None
        assert not store.has_checkpoint("k3")   # quarantine moved it aside
        assert os.listdir(os.path.join(store.root, "corrupt"))

    def test_delete_removes_checkpoint(self, store):
        topo, _ = discover_sim(make_h100_like(seed=61), n_samples=9)
        store.put("k4", topo)
        store.put_checkpoint("k4", self.ENTRIES)
        store.delete("k4")
        assert store.get("k4") is None
        assert not store.has_checkpoint("k4")

    def test_gc_never_sweeps_checkpoints(self, store):
        """Checkpoints exist precisely for keys with no topology yet (an
        interrupted discovery awaiting resume); an aggressive gc must not
        treat them as orphans."""
        topo, _ = discover_sim(make_h100_like(seed=61), n_samples=9)
        store.put("old", topo)
        store.put_checkpoint("in-progress", self.ENTRIES)
        out = store.gc(max_entries=0)
        assert out["evicted"] == ["old"]
        assert store.has_checkpoint("in-progress")
        entries, _ = store.load_checkpoint("in-progress")
        assert set(entries) == set(self.ENTRIES)


# ------------------------------------------- keys across the two packages
BUDGETS = [None, SweepBudget(), SweepBudget(max_rows=50, target_resolution=4096)]


@pytest.mark.parametrize("budget", BUDGETS, ids=["dense", "default", "tight"])
@pytest.mark.parametrize("survey", [False, True], ids=["full", "survey"])
@pytest.mark.parametrize("device", ["make_h100_like", "make_mi210_like"])
def test_sim_request_key_equals_reference(device, budget, survey):
    import repro.core as ref
    from repro.core.discover import sim_request_descriptor as ref_descriptor
    from repro.core.engine.planner import SweepBudget as RefBudget
    from repro.core.engine.store import request_key as ref_key

    ref_budget = None if budget is None else RefBudget(**vars(budget))
    for elements in (None, ["L2", "L1"]):
        got = sim_request_descriptor(getattr(repro_core, device)(seed=7), 9,
                                     elements, budget, survey=survey)
        want = ref_descriptor(getattr(ref, device)(seed=7), 9, elements,
                              ref_budget, survey=survey)
        assert got == want
        assert request_key(got) == ref_key(want)


@pytest.mark.parametrize("budget", BUDGETS, ids=["dense", "default", "tight"])
def test_cuda_descriptor_is_laid_out_as_the_reference_pallas_one(budget):
    """Same fields, same budget document; the kind and backend name the
    CUDA runner, so the two never collide in one store."""
    from repro.core.discover import pallas_request_descriptor
    from repro.core.engine.planner import SweepBudget as RefBudget
    from repro.core.engine.store import request_key as ref_key
    from repro.core.probes import make_pallas_model
    from repro_torch.core.probes import make_cuda_model

    ref_budget = None if budget is None else RefBudget(**vars(budget))
    got = cuda_request_descriptor(make_cuda_model(), 9, ["L1"], budget)
    want = pallas_request_descriptor(make_pallas_model(), 9, ["L1"],
                                     ref_budget)
    assert got["kind"] == "discover_cuda" and want["kind"] == "discover_pallas"
    assert got["backend"] == "cuda:cuda-model"
    renamed = dict(got, kind=want["kind"], backend=want["backend"],
                   model=want["model"])
    assert renamed == want
    assert request_key(renamed) == ref_key(want)
    assert request_key(got) != ref_key(want)


def test_cuda_descriptor_defaults_to_the_default_budget():
    from repro_torch.core import default_sweep_budget
    from repro_torch.core.probes import make_cuda_model

    model = make_cuda_model()
    assert cuda_request_descriptor(model, 9, None) == \
        cuda_request_descriptor(model, 9, None, default_sweep_budget())
    assert cuda_request_descriptor(model, 9, None, None)["budget"] is None
