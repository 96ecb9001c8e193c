"""The port's hardware catalog and performance model against the reference.

``TestCatalogFallback`` is the reference's class of ``tests/test_store.py``
and ``TestPerfModel`` the reference's class of ``tests/test_discovery.py``,
re-pointed at ``repro_torch``.  Beside them: the catalog's records equal
the reference's, and the same simulated discovery gives the same overlaid
``HardwareSpec`` and the same performance-model verdict in both packages;
a CUDA discovery in a store answers ``get_spec`` for its model.
"""
import dataclasses

import pytest

import repro.core as ref_core
from repro.core.perfmodel import evaluate as ref_evaluate
from repro.core.perfmodel import \
    gpu_params_from_topology as ref_gpu_params
from repro_torch.core import (CATALOG, TPU_V5E, discover_sim, get_spec,
                              make_h100_like, make_mi210_like,
                              spec_from_topology)
from repro_torch.core.engine.store import TopologyStore
from repro_torch.core.perfmodel import (AppParams, GpuParams, evaluate,
                                        gpu_params_from_topology)


@pytest.fixture
def store(tmp_path):
    return TopologyStore(str(tmp_path / "topo-store"))


@pytest.fixture(scope="module")
def h100_report():
    topo, timings = discover_sim(make_h100_like(seed=11), n_samples=17)
    return topo, timings


class TestCatalogFallback:
    def test_discovered_overrides_datasheet(self, store):
        topo, _ = discover_sim(make_h100_like(seed=51), n_samples=9,
                               store=store)
        # No static entry for the simulated device: served purely from store.
        spec = get_spec("sim-h100", store=store)
        dm = topo.find_memory("DeviceMemory")
        assert spec.hbm_bandwidth == pytest.approx(
            float(dm.get("read_bw")) * 1e9)
        assert spec.name == "sim-h100"
        assert "discovered" in spec.notes

    def test_static_answer_without_store(self):
        assert get_spec("tpu-v5e").hbm_bandwidth == CATALOG["tpu-v5e"].hbm_bandwidth
        with pytest.raises(KeyError, match="unknown hardware"):
            get_spec("sim-h100")

    def test_store_without_match_falls_back_to_datasheet(self, store):
        discover_sim(make_mi210_like(seed=51), n_samples=9, store=store)
        spec = get_spec("tpu-v5e", store=store)
        assert spec == CATALOG["tpu-v5e"]

    def test_newest_entry_wins(self, store):
        d1, _ = discover_sim(make_h100_like(seed=51), n_samples=9, store=store)
        # A later run of the same device identity under a different request:
        d2, _ = discover_sim(make_h100_like(seed=52), n_samples=9, store=store)
        entries = store.find(model="sim-h100")
        assert len(entries) == 2
        assert entries[0].meta["created_at"] >= entries[1].meta["created_at"]


class TestPerfModel:
    def test_memory_bound_detection(self):
        gpu = GpuParams(mem_latency=400, mem_bandwidth=800e9, mem_freq=1e9,
                        departure_delay=100)
        app = AppParams(comp_cycles=10, mem_cycles=4000, loads_per_warp=32,
                        active_warps_per_sm=32)
        res = evaluate(app, gpu)
        assert res.memory_bound
        assert res.cwp == 32  # capped at active warps

    def test_compute_bound_detection(self):
        gpu = GpuParams(mem_latency=40, mem_bandwidth=3e12, mem_freq=1e9,
                        departure_delay=1)
        app = AppParams(comp_cycles=10000, mem_cycles=40, loads_per_warp=1,
                        active_warps_per_sm=8)
        res = evaluate(app, gpu)
        assert not res.memory_bound

    def test_mwp_capped_by_warps(self):
        gpu = GpuParams(mem_latency=1000, mem_bandwidth=1e15, mem_freq=1e9,
                        departure_delay=0.1)
        app = AppParams(comp_cycles=100, mem_cycles=100, loads_per_warp=1,
                        active_warps_per_sm=4)
        assert evaluate(app, gpu).mwp <= 4

    def test_params_from_topology(self, h100_report):
        topo, _ = h100_report
        gpu = gpu_params_from_topology(topo)
        assert gpu.mem_latency > 500      # discovered DRAM latency
        assert gpu.mem_bandwidth > 1e12   # discovered bandwidth


# --------------------------------------------------------------------------
# The port against the reference
# --------------------------------------------------------------------------
def test_catalog_records_equal_reference():
    assert list(CATALOG) == list(ref_core.CATALOG)
    for name, spec in CATALOG.items():
        assert (dataclasses.asdict(spec)
                == dataclasses.asdict(ref_core.CATALOG[name]))


@pytest.fixture(scope="module")
def both_reports():
    """The same simulated discovery through both packages."""
    return (discover_sim(make_h100_like(seed=11), n_samples=17)[0],
            ref_core.discover_sim(ref_core.make_h100_like(seed=11),
                                  n_samples=17)[0])


def test_spec_from_topology_equals_reference(both_reports):
    port, ref = both_reports
    got = spec_from_topology(port, TPU_V5E)
    want = ref_core.spec_from_topology(ref, ref_core.TPU_V5E)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.hbm_bandwidth != TPU_V5E.hbm_bandwidth


@pytest.mark.parametrize("app", [
    dict(comp_cycles=10, mem_cycles=4000, loads_per_warp=32,
         active_warps_per_sm=32),
    dict(comp_cycles=10000, mem_cycles=40, loads_per_warp=1,
         active_warps_per_sm=8),
    dict(comp_cycles=200, mem_cycles=800, loads_per_warp=4,
         active_warps_per_sm=16)],
    ids=["memory-bound", "compute-bound", "mixed"])
def test_perfmodel_on_discovered_topology_equals_reference(both_reports,
                                                           app):
    """GPU parameters from each package's discovered topology, the same
    application: the same CWP/MWP and verdict, bit for bit."""
    port, ref = both_reports
    got = evaluate(AppParams(**app), gpu_params_from_topology(port))
    want = ref_evaluate(ref_core.perfmodel.AppParams(**app),
                        ref_gpu_params(ref))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_cuda_discovery_answers_get_spec(store):
    """A stored CUDA discovery overlays its measured device-memory read
    bandwidth onto ``HOST_CPU`` under its model's name."""
    import torch

    from repro_torch.core import HOST_CPU, discover_cuda
    from repro_torch.core.probes import CudaRunner

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        topo, _ = discover_cuda(runner=CudaRunner(device="cpu",
                                                  base_steps=512),
                                n_samples=9, elements=["VMEM"], store=store)
    finally:
        torch.set_num_threads(threads)
    spec = get_spec("cuda-model", store=store)
    bw = topo.find_memory("DeviceMemory").get("read_bw")
    assert bw > 0 and spec.hbm_bandwidth == pytest.approx(bw * 1e9)
    assert spec.name == "cuda-model" and "discovered" in spec.notes
    assert spec.peak_bf16_flops == HOST_CPU.peak_bf16_flops
