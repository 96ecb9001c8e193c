"""The port's host runner, host discovery and collective models against the
reference package.

``TestHostPChase`` and ``TestCollectiveModels`` are the reference's
``tests/test_host_probe.py`` re-pointed at ``repro_torch``: real
measurements on this CPU, tolerant by design, asserting only the
physically necessary ordering.  Beside them, on the same inputs:

* ``host_request_descriptor`` and its ``request_key``: bit-equal;
* the chase buffers: ``HostRunner(seed=s)`` hands its chase the same int32
  ``perm`` and step count as the reference's runner, call for call;
* the compiled chase: its final slot equals a numpy walk, exactly;
* the analytic collective models: equal to 1e-12 relative;
* ``discover_host`` over one deterministic, request-keyed stand-in runner
  swapped into both packages: the topology JSON and the store key
  bit-equal;
* a structural run of the real ``discover_host`` at 8 MiB and 5 samples:
  the reference's elements, attributes, units and provenance, and no
  assertion on a discrete host size (the sweep's footprint is
  ``4 * size / 4096`` bytes, so on most hosts it finds none).

The chase is built by the host C compiler at first use; a missing compiler
or a failed build raises, which ``TestNoFallback`` holds.
"""
import ctypes
import importlib
import zlib

import numpy as np
import pytest

import repro_torch.core.probes.host_chase as host_chase_module
from repro.core.engine.store import TopologyStore as RefStore
from repro.core.engine.store import request_key as ref_request_key
from repro.core.probes import HostRunner as RefHostRunner
from repro.core.probes import SpaceInfo as RefSpaceInfo
from repro.core.probes import bandwidth as ref_bandwidth
from repro_torch.core import TopologyStore, discover_host
from repro_torch.core.discover import host_request_descriptor
from repro_torch.core.engine.store import request_key
from repro_torch.core.probes import (HostRunner, SpaceInfo, measure_collective,
                                     sattolo_cycle)
from repro_torch.core.probes import bandwidth as port_bandwidth
from repro_torch.core.probes.bandwidth import (all_to_all_time,
                                               ring_all_gather_time,
                                               ring_all_reduce_time)
from repro_torch.core.probes.host_chase import (build_host_chase, host_chase,
                                                load_host_chase)

# The modules, not the ``discover`` functions each package re-exports
# under the same name.
ref_discover_module = importlib.import_module("repro.core.discover")
port_discover_module = importlib.import_module("repro_torch.core.discover")

KIB, MIB = 1024, 1024**2


@pytest.fixture(scope="module")
def runner():
    return HostRunner(max_bytes=64 * MIB, iters=1 << 13)


class TestHostPChase:
    def test_small_vs_large_latency_ordering(self, runner):
        # Best-case chase step over 64 MiB must be slower than over 16 KiB.
        # Min, not median: on shared CI hosts a steal-time spike can inflate
        # the small-array samples; the minimum is the uncontended estimate.
        # Virtualized hosts additionally show multi-second slow modes that
        # inflate the small-array chase past the DRAM one for a whole round,
        # so the ordering only needs to be *observable*: pass as soon as any
        # of a few independent rounds shows it, fail only if none does.
        ratios = []
        for _ in range(5):
            small = runner.pchase("host-cache", 16 * 1024, 64, 7)  # L1/L2
            large = runner.pchase("host-cache", 64 * MIB, 64, 7)   # DRAM
            ratios.append(np.min(large) / np.min(small))
            if ratios[-1] > 1.2:
                return
        raise AssertionError(
            f"DRAM chase never slower than cache chase: ratios {ratios}")

    def test_samples_positive_and_finite(self, runner):
        lats = runner.pchase("host-cache", 1 * MIB, 64, 7)
        assert lats.shape == (7,)
        assert np.all(np.isfinite(lats)) and np.all(lats > 0)

    def test_bandwidth_positive(self, runner):
        bw = runner.bandwidth("DRAM", "read", nbytes=32 * MIB, repeats=2)
        assert bw > 1e8  # >0.1 GB/s — any real machine clears this


class TestCollectiveModels:
    def test_ring_all_reduce_formula(self):
        # 2(n-1)/n * bytes / bw
        assert ring_all_reduce_time(100e6, 4, 50e9) == pytest.approx(
            2 * 3 / 4 * 100e6 / 50e9)
        assert ring_all_reduce_time(100e6, 1, 50e9) == 0.0

    def test_all_gather_and_a2a(self):
        assert ring_all_gather_time(1e6, 8, 50e9) == pytest.approx(7e6 / 50e9)
        assert all_to_all_time(8e6, 8, 50e9) == pytest.approx(7e6 / 50e9)

    def test_measure_collective_fallback(self):
        # No card here -> analytic path with documented provenance.
        est = measure_collective("all_reduce", 64 * MIB, 16, 50e9)
        expect = ring_all_reduce_time(64 * MIB, 16, 50e9)
        assert est.seconds == pytest.approx(expect)
        assert est.effective_bw > 0


# --------------------------------------------------------------------------
# Cross-checks against the reference package
# --------------------------------------------------------------------------
HOST_REQUESTS = [(128 * MIB, 9, True), (8 * MIB, 5, True),
                 (64 * MIB, 33, False), (4 * MIB + 4 * KIB, 1, False)]


@pytest.mark.parametrize("max_bytes, n_samples, quick", HOST_REQUESTS)
def test_descriptor_and_key_equal_reference(max_bytes, n_samples, quick):
    """Bit-equal: both packages address one store alike."""
    port = host_request_descriptor(max_bytes, n_samples, quick)
    ref = ref_discover_module.host_request_descriptor(max_bytes, n_samples,
                                                      quick)
    assert port == ref
    assert request_key(port) == ref_request_key(ref)


# (array_bytes, stride, n_samples): discovery's shapes — a size sweep row
# at its 4 KiB lattice step, both latency items, and slot counts under the
# floor of four.
CHASE_REQUESTS = [(8 * KIB, 4 * KIB, 5), (16 * KIB, 64, 3),
                  (3 * MIB, 4 * KIB, 2), (64, 64, 4), (1 * MIB, 4096, 3),
                  (16 * KIB, 64, 5), (200 * KIB, 48, 2)]


def _port_chase_calls(monkeypatch, seed, iters):
    """Every (perm, steps) the port's ``HostRunner`` hands its chase."""
    drawn, calls = [], []

    def recording_cycle(n, rng):
        drawn.append(sattolo_cycle(n, rng))
        return drawn[-1]

    def chase(addr, steps):
        perm = next(p for p in drawn if p.ctypes.data == addr)
        calls.append((perm.copy(), steps))
        return 0

    monkeypatch.setattr("repro_torch.core.probes.runners.sattolo_cycle",
                        recording_cycle)
    monkeypatch.setattr(host_chase_module, "load_host_chase",
                        lambda: (chase, None))
    runner = HostRunner(max_bytes=8 * MIB, iters=iters, seed=seed)
    for ab, stride, n in CHASE_REQUESTS:
        runner.pchase("host-cache", ab, stride, n)
    return calls


class _Ready:
    def block_until_ready(self):
        return self


def _ref_chase_calls(seed, iters):
    """Every (perm, steps) the reference's ``HostRunner`` hands its jitted
    chase (replaced by a recording stub: only the arrays are compared)."""
    calls = []

    def chase(perm, steps):
        calls.append((np.asarray(perm), steps))
        return _Ready()

    runner = RefHostRunner(max_bytes=8 * MIB, iters=iters, seed=seed)
    runner._chase_cache[0] = chase
    for ab, stride, n in CHASE_REQUESTS:
        runner.pchase("host-cache", ab, stride, n)
    return calls


@pytest.mark.parametrize("seed, iters", [(0, 1 << 10), (7, 1 << 14),
                                         (123, 16)])
def test_chase_buffers_equal_reference(monkeypatch, seed, iters):
    """Same generator, same draws, same order: bit-equal ``perm``s and the
    same step counts (one warm-up and ``n_samples`` timed calls each)."""
    port = _port_chase_calls(monkeypatch, seed, iters)
    ref = _ref_chase_calls(seed, iters)
    assert len(port) == len(ref) == sum(1 + n for *_, n in CHASE_REQUESTS)
    for (pp, ps), (rp, rs) in zip(port, ref):
        assert pp.dtype == rp.dtype == np.int32
        assert np.array_equal(pp, rp)
        assert ps == rs


def _numpy_walk(perm: np.ndarray, iters: int) -> int:
    x = 0
    for _ in range(iters):
        x = int(perm[x])
    return x


@pytest.mark.parametrize("n, iters", [(4, 0), (4, 1), (5, 7), (64, 1000),
                                      (1000, 4099), (4096, 20000)])
def test_compiled_chase_equals_numpy_walk(n, iters):
    """Exact: the final slot of the compiled chase over a Sattolo cycle and
    over an arbitrary map into the buffer (cycles of any length)."""
    rng = np.random.default_rng(n * 31 + iters)
    cycle = sattolo_cycle(n, rng)
    arbitrary = rng.integers(0, n, n).astype(np.int32)
    for perm in (cycle, arbitrary):
        assert host_chase(perm, iters) == _numpy_walk(perm, iters)


def test_host_chase_refuses_slots_outside_the_buffer():
    with pytest.raises(ValueError, match="outside"):
        host_chase(np.array([1, 4, 0, 2], np.int32), 3)


@pytest.mark.parametrize("nbytes, n", [(64 * MIB, 1), (64 * MIB, 2),
                                       (100_000_000, 4), (3 * MIB + 7, 8),
                                       (1, 16), (256 * MIB, 1024)])
@pytest.mark.parametrize("link_bw", [50e9, 450e9, 1.5e6])
def test_analytic_collectives_equal_reference(nbytes, n, link_bw):
    """The ring models, and ``measure_collective``'s analytic path at axis
    sizes that take it in both packages here (1, and more than the
    reference's 8 forced CPU devices), within 1e-12 relative."""
    for name in ("ring_all_reduce_time", "ring_all_gather_time",
                 "all_to_all_time"):
        got = getattr(port_bandwidth, name)(nbytes, n, link_bw)
        want = getattr(ref_bandwidth, name)(nbytes, n, link_bw)
        assert got == pytest.approx(want, rel=1e-12, abs=0.0)
    if n == 1 or n > 8:
        for op in ("all_reduce", "all_gather", "all_to_all"):
            got = measure_collective(op, nbytes, n, link_bw)
            want = ref_bandwidth.measure_collective(op, nbytes, n, link_bw)
            assert (got.op, got.bytes_moved, got.n_devices) == \
                (want.op, want.bytes_moved, want.n_devices)
            assert got.seconds == pytest.approx(want.seconds, rel=1e-12)
            assert got.effective_bw == pytest.approx(want.effective_bw,
                                                     rel=1e-12)


# --------------------------------------------------------------------------
# discover_host over one deterministic stand-in runner in both packages
# --------------------------------------------------------------------------
def _stand_in(space_info):
    """A request-keyed host runner: each row's samples are drawn from a
    generator seeded by the request itself, so either package's discovery
    sees the same rows whatever asks for them.  Loads step from 1.5 ns to
    12 ns past 1 MiB; bandwidths are fixed by mode."""

    class StandInHostRunner:
        deterministic = True

        def __init__(self, max_bytes, iters, seed=0):
            self.max_bytes, self.iters, self.seed = max_bytes, iters, seed

        def spaces(self):
            return [space_info(name="host-cache", scope="host", kind="cache",
                               max_bytes=self.max_bytes, supports_cold=False,
                               supports_amount=False, supports_sharing=False)]

        def pchase(self, space, array_bytes, stride, n_samples):
            key = repr((space, int(array_bytes), int(stride), int(n_samples)))
            rng = np.random.default_rng(zlib.crc32(key.encode()))
            level = 1.5 if array_bytes <= MIB else 12.0
            return level * (1.0 + 0.02 * rng.standard_normal(n_samples))

        def pchase_batch(self, space, array_bytes_list, stride, n_samples):
            return np.stack([self.pchase(space, ab, stride, n_samples)
                             for ab in array_bytes_list])

        def pchase_many(self, requests, n_samples):
            return np.stack([self.pchase(s, ab, st, n_samples)
                             for s, ab, st in requests])

        def bandwidth(self, space, mode="read"):
            return 23.456789e9 if mode == "read" else 11.111111e9

    return StandInHostRunner


@pytest.mark.parametrize("max_bytes, n_samples, quick",
                         [(8 * MIB, 5, True), (8 * MIB, 9, True),
                          (16 * MIB, 9, False)])
def test_discover_host_equals_reference_on_a_stand_in(
        monkeypatch, tmp_path, max_bytes, n_samples, quick):
    monkeypatch.setattr(port_discover_module, "HostRunner",
                        _stand_in(SpaceInfo))
    monkeypatch.setattr(ref_discover_module, "HostRunner",
                        _stand_in(RefSpaceInfo))
    port_store = TopologyStore(str(tmp_path / "port"))
    ref_store = RefStore(str(tmp_path / "ref"))

    got, t = discover_host(max_bytes, n_samples, quick, store=port_store)
    want, wt = ref_discover_module.discover_host(max_bytes, n_samples, quick,
                                                 store=ref_store)
    assert got.to_json() == want.to_json()
    # five samples are too few for the K-S test to place the step; nine
    # place it at the stand-in's 1 MiB
    size = got.find_memory("host-cache").get("size")
    assert size == (MIB if n_samples >= 9 else None)
    assert t.meta["cache"] == wt.meta["cache"]
    assert port_store.keys() == ref_store.keys() == [
        request_key(host_request_descriptor(max_bytes, n_samples, quick))]


# --------------------------------------------------------------------------
# The real discover_host on this CPU
# --------------------------------------------------------------------------
def _structure(topo) -> dict:
    """Element -> {attribute: (unit, provenance)}, host size left out."""
    return {me.name: (me.kind, me.scope,
                      {k: (a.unit, a.provenance) for k, a in me.attrs.items()
                       if (me.name, k) != ("host-cache", "size")})
            for me in topo.memory}


def test_discover_host_structural_against_reference(tmp_path):
    got, t = discover_host(8 * MIB, 5)
    want, _ = ref_discover_module.discover_host(8 * MIB, 5)
    assert (got.vendor, got.model, got.backend) == ("host", "cpu", "cpu")
    assert (got.vendor, got.model, got.backend) == \
        (want.vendor, want.model, want.backend)
    assert _structure(got) == _structure(want)
    assert got.notes == want.notes
    cache, dram = got.find_memory("host-cache"), got.find_memory("DRAM")
    assert cache.get("load_latency") > 0 and dram.get("load_latency") > 0
    assert dram.get("read_bw") > 0 and dram.get("write_bw") > 0
    assert set(t.per_family) == {"size", "latency", "bandwidth"}
    assert t.meta["cache"]["misses"] > 0


def test_discover_host_store_hit_probes_nothing(tmp_path, monkeypatch):
    store = TopologyStore(str(tmp_path / "store"))
    first, _ = discover_host(8 * MIB, 5, store=store)
    monkeypatch.setattr(port_discover_module, "HostRunner", None)  # no probe
    again, t = discover_host(8 * MIB, 5, store=store)
    assert again.to_json() == first.to_json()
    assert "cache" not in t.meta


# --------------------------------------------------------------------------
# No fallback: the chase is compiled or the runner raises
# --------------------------------------------------------------------------
class TestNoFallback:
    def test_missing_compiler_raises(self, monkeypatch, tmp_path):
        monkeypatch.delenv("CC", raising=False)
        monkeypatch.setenv("PATH", str(tmp_path))
        with pytest.raises(RuntimeError, match="no host C compiler"):
            build_host_chase(tmp_path / "build")

    def test_compiler_that_does_not_run_raises(self, monkeypatch, tmp_path):
        monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
        with pytest.raises(RuntimeError, match="did not run"):
            build_host_chase(tmp_path / "build")

    def test_failed_build_raises(self, monkeypatch, tmp_path):
        monkeypatch.setenv("CC", "false")
        with pytest.raises(RuntimeError, match="build failed"):
            build_host_chase(tmp_path / "build")
        assert not list((tmp_path / "build").glob("*.so"))

    def test_runner_raises_without_a_library(self, monkeypatch, tmp_path):
        """No library loaded yet and none can be built: the chase raises
        and nothing is measured in its place."""
        monkeypatch.setattr(host_chase_module, "_loaded", None)
        monkeypatch.setattr(host_chase_module, "BUILD_DIR", tmp_path / "b")
        monkeypatch.setenv("CC", "false")
        with pytest.raises(RuntimeError, match="build failed"):
            HostRunner(max_bytes=8 * MIB, iters=1 << 10).pchase(
                "host-cache", 16 * KIB, 64, 3)

    def test_build_is_keyed_and_reused(self, tmp_path):
        first = build_host_chase(tmp_path / "build")
        again = build_host_chase(tmp_path / "build")
        assert first.path == again.path and again.seconds == 0.0
        assert first.flags == ("-O2", "-fPIC", "-shared")
        lib = ctypes.CDLL(str(first.path))
        assert hasattr(lib, "host_chase")

    def test_loaded_chase_is_the_built_one(self):
        fn, info = load_host_chase()
        assert info.path.exists() and info.compiler
        perm = np.array([1, 2, 3, 0], np.int32)
        assert fn(perm.ctypes.data, 6) == 2
