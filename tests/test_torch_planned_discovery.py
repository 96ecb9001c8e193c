"""The port's default discovery on the CUDA runner: planned and fused.

``discover_cuda()`` defaults to the reference's ``discover_pallas``
defaults: the adaptive sweep planner (``SweepBudget()``) and cross-family
fusion.  Here it runs on the CPU (``device="cpu"``: the kernels' plain
versions under real timing), write-through to a ``TopologyStore``.  Its
discrete attributes are held to the model's ground truth; the run is
measured, so a miss gets one retry, as the reference's own acceptance of
its planned Pallas discovery does (``tests/test_planner.py``).  Fused
dispatches are logged by the runner under the sorted, ``+``-joined
families of the rows they carry, and a repeat of the request is served by
the store with no launch at all.
"""
import pytest
import torch

from repro_torch.core import (SweepBudget, TopologyStore, default_sweep_budget,
                              discover_cuda)
from repro_torch.core.probes import CudaRunner, make_cuda_model
from repro_torch.kernels import ops

N_SAMPLES = 9
BASE_STEPS = 512         # short CPU walks; the ratio does not depend on it
DENSE_CHASE_LAUNCHES = 876   # the dense, unfused run's (``chip_smoke.py``)
DISCRETE = ("size", "line_size", "fetch_granularity")
FAMILIES = {"size", "fetch_granularity", "latency", "line_size", "amount",
            "bandwidth", "sharing"}


def _matches_ground_truth(topo, gt) -> bool:
    vmem = topo.find_memory("VMEM")
    return (all(topo.find_memory(name).get(attr) == gt[name][attr]
                for name in ("L1", "L2") for attr in DISCRETE)
            and abs(vmem.get("size") - gt["VMEM"]["size"]) <= 64)


@pytest.fixture(scope="module")
def planned(tmp_path_factory):
    """One default discovery, rerun once if it misses the ground truth."""
    gt = make_cuda_model().ground_truth()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for attempt in range(2):
            store = TopologyStore(tmp_path_factory.mktemp(f"run{attempt}"))
            ops.reset_launches()
            runner = CudaRunner(device="cpu", base_steps=BASE_STEPS)
            topo, timings = discover_cuda(runner=runner, n_samples=N_SAMPLES,
                                          store=store)
            launches = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
            if attempt == 0 and not _matches_ground_truth(topo, gt):
                continue
            return {"runner": runner, "topo": topo, "timings": timings,
                    "launches": launches, "gt": gt, "store": store,
                    "attempts": attempt + 1}
    finally:
        torch.set_num_threads(threads)


def test_default_is_planned_and_fused():
    import inspect

    params = inspect.signature(discover_cuda).parameters
    assert params["fuse"].default is True
    assert default_sweep_budget() == SweepBudget()


def test_planned_discovery_matches_ground_truth(planned):
    assert _matches_ground_truth(planned["topo"], planned["gt"])


def test_planned_discovery_launches_fewer_chase_grids(planned):
    launches = planned["launches"]
    assert 0 < launches["pchase_batch"] < DENSE_CHASE_LAUNCHES
    assert all(n > 0 for n in launches.values())


def test_planned_and_fused_meta(planned):
    meta = planned["timings"].meta
    assert meta["planned"] is True
    fusion = meta["fusion"]
    assert fusion["rounds"] > 0
    assert fusion["fused_rows"] >= fusion["fused_calls"] > 0
    assert planned["timings"].probe_rows == meta["cache"]["misses"] > 0


def test_fused_timed_loops_carry_family_labels(planned):
    labels = {e["family"] for e in planned["runner"].calibrations}
    assert "" not in labels
    for label in labels:
        parts = label.split("+")
        assert parts == sorted(set(parts)) and set(parts) <= FAMILIES, label
    assert any("+" in label for label in labels)


def test_repeat_is_served_by_the_store_with_no_launch(planned):
    ops.reset_launches()
    topo, timings = discover_cuda(runner=CudaRunner(device="cpu"),
                                  n_samples=N_SAMPLES,
                                  store=planned["store"])
    assert all(fn.launches == 0 for fn in ops.WRAPPERS)
    assert timings.probe_rows is None
    assert topo.to_json() == planned["topo"].to_json()
    assert set(timings.per_family) == set(planned["timings"].per_family)
