"""The port's discovery, end to end, against the reference package's.

* ``discover_sim`` runs the same dense engine over request-keyed simulated
  devices, so its topologies must equal the reference's bit for bit
  (memory attributes and compute elements; the notes carry wall times and
  are excluded).
* ``discover_cuda(device="cpu", budget=None, fuse=False)`` runs the
  kernels' plain versions under real timing, with dense, unfused sweeps
  (the planned and fused default is ``test_torch_planned_discovery.py``'s).  Its discrete attributes are held to the model's ground
  truth, which equals the reference's ``make_pallas_model()`` ground truth
  exactly; the run is measured, so a mismatch gets one retry, as the
  reference's own Pallas discovery test does.  (A second measured run of
  the reference is no yardstick: on a loaded CPU either run can miss.)
  The latencies are timing ratios on a CPU the test shares with other
  processes, so they are held to the model's order of levels and to
  within a factor of two; the card holds them to 50 % (``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from repro.core import discover_sim as ref_discover_sim
from repro.core import make_h100_like as ref_h100
from repro.core import make_mi210_like as ref_mi210
from repro.core.probes import make_pallas_model
from repro_torch.core import (discover_cuda, discover_sim, make_h100_like,
                              make_mi210_like)
from repro_torch.core.probes import CudaRunner, make_cuda_model
from repro_torch.kernels import ops

N_SAMPLES = 9
# Chains of 512 loads keep the plain versions' CPU walks short; the
# request/calibration ratio does not depend on the chain length.
BASE_STEPS = 512
SPACES = ("L1", "VMEM", "L2")
DISCRETE = ("size", "line_size", "fetch_granularity")


def _without_notes(topo) -> dict:
    d = topo.to_json()
    d.pop("notes")
    return d


@pytest.mark.parametrize("port_dev,ref_dev", [
    (make_h100_like, ref_h100), (make_mi210_like, ref_mi210)],
    ids=["h100", "mi210"])
def test_discover_sim_equals_reference(port_dev, ref_dev):
    got, timings = discover_sim(port_dev(), n_samples=N_SAMPLES)
    want, ref_timings = ref_discover_sim(ref_dev(), n_samples=N_SAMPLES)
    assert _without_notes(got) == _without_notes(want)
    assert set(timings.per_family) == set(ref_timings.per_family)
    assert timings.meta["cache"] == ref_timings.meta["cache"]


def _discrete(topo) -> dict:
    return {(name, attr): topo.find_memory(name).get(attr)
            for name in SPACES for attr in DISCRETE}


def _matches_ground_truth(topo, gt) -> bool:
    l1, vmem = topo.find_memory("L1"), topo.find_memory("VMEM")
    return (all(topo.find_memory(name).get(attr) == gt[name][attr]
                for name in ("L1", "L2") for attr in DISCRETE)
            and l1.get("amount") == gt["L1"]["amount"]
            and abs(vmem.get("size") - gt["VMEM"]["size"]) <= 64)


@pytest.fixture(scope="module")
def discovery():
    """One port discovery, rerun once if it misses the ground truth.

    One torch thread: the plain chase gathers from small tables, and
    intra-op threads only contend with the other test workers."""
    gt = make_cuda_model().ground_truth()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for attempt in range(2):
            ops.reset_launches()
            runner = CudaRunner(device="cpu", base_steps=BASE_STEPS)
            topo, timings = discover_cuda(runner=runner,
                                          n_samples=N_SAMPLES, budget=None,
                                          fuse=False)
            launches = [fn.launches for fn in ops.WRAPPERS]
            if attempt == 0 and not _matches_ground_truth(topo, gt):
                continue
            return {"runner": runner, "topo": topo, "timings": timings,
                    "launches": launches, "gt": gt}
    finally:
        torch.set_num_threads(threads)


def test_cache_spaces_match_ground_truth(discovery):
    gt = discovery["gt"]
    for name in ("L1", "L2"):
        me = discovery["topo"].find_memory(name)
        for attr in ("size", "line_size", "fetch_granularity"):
            assert me.get(attr) == gt[name][attr], (name, attr)


def test_l1_amount_matches_ground_truth(discovery):
    assert discovery["topo"].find_memory("L1").get("amount") == \
        discovery["gt"]["L1"]["amount"] == 1


def test_scratchpad_within_one_grid_step(discovery):
    gt = discovery["gt"]
    vmem = discovery["topo"].find_memory("VMEM")
    assert abs(vmem.get("size") - gt["VMEM"]["size"]) <= 64
    assert vmem.get("fetch_granularity") is None
    assert vmem.get("line_size") is None


def test_latencies_in_model_cycle_units(discovery):
    gt, topo = discovery["gt"], discovery["topo"]
    order = ("VMEM", "L1", "L2", "DeviceMemory")
    got = [topo.find_memory(name).get("load_latency") for name in order]
    assert got == sorted(got)
    for name, value in zip(order, got):
        assert 0.5 < value / gt[name]["latency"] < 2.0, (name, value)


def test_discrete_attributes_equal_reference(discovery):
    """Both packages describe the same device, and the port's measured
    discrete attributes are that device's."""
    gt = discovery["gt"]
    assert gt == make_pallas_model().ground_truth()
    got = _discrete(discovery["topo"])
    for name in ("L1", "L2"):
        for attr in DISCRETE:
            assert got[(name, attr)] == gt[name][attr], (name, attr)
    assert abs(got[("VMEM", "size")] - gt["VMEM"]["size"]) <= 64


def test_families_and_backend_identity(discovery):
    topo, timings = discovery["topo"], discovery["timings"]
    assert set(timings.per_family) >= {"size", "latency", "bandwidth",
                                       "fetch_granularity", "line_size"}
    assert topo.backend == "cuda:cuda-model"
    assert topo.general["clock_domain"].value == "model-cycles"
    assert timings.meta["planned"] is False


def test_every_kernel_wrapper_ran(discovery):
    assert all(n > 0 for n in discovery["launches"])
    runner = discovery["runner"]
    assert runner.kernel_calls > 100
    assert runner.eviction_grid_rows >= runner.eviction_grid_calls > 0


def test_bandwidth_values_are_finite(discovery):
    for name in ("L2", "DeviceMemory"):
        me = discovery["topo"].find_memory(name)
        for attr in ("read_bw", "write_bw"):
            assert np.isfinite(me.get(attr)) and me.get(attr) > 0


UNPORTED = [
    ({"resilience": object()}, "engine/store.py"),
    ({"parallel": object()}, "engine/parallel.py"),
]


@pytest.mark.parametrize("entry", ["sim", "cuda"])
@pytest.mark.parametrize("option,module", UNPORTED,
                         ids=[next(iter(o)) for o, _ in UNPORTED])
def test_unported_options_raise(entry, option, module):
    ops.reset_launches()
    with pytest.raises(NotImplementedError, match=module):
        if entry == "sim":
            discover_sim(make_h100_like(), n_samples=N_SAMPLES, **option)
        else:
            discover_cuda(device="cpu", **option)
    assert all(fn.launches == 0 for fn in ops.WRAPPERS)


def test_cuda_runner_defaults_to_the_card():
    import inspect

    assert inspect.signature(CudaRunner).parameters["device"].default \
        == "cuda"
    assert inspect.signature(discover_cuda).parameters["device"].default \
        == "cuda"
    assert torch.device(CudaRunner(device="cpu").device).type == "cpu"
