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
import copy
import multiprocessing
import os

import numpy as np
import pytest
import torch

from repro.core import discover_sim as ref_discover_sim
from repro.core import make_h100_like as ref_h100
from repro.core import make_mi210_like as ref_mi210
from repro.core.errors import Resilience as RefResilience
from repro.core.probes import make_pallas_model
from repro_torch.core import (discover_cuda, discover_sim, make_h100_like,
                              make_mi210_like)
from repro_torch.core import Resilience
from repro_torch.core.engine import parallel as parallel_module
from repro_torch.core.engine.parallel import (ParallelConfig,
                                              get_global_pool,
                                              shutdown_global_pools)
from repro_torch.core.probes import (ChaosRunner, CudaRunner, FaultSchedule,
                                     make_cuda_model)
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


# ``resilience`` and ``parallel`` on both entries.  Sim: bit for bit with
# the reference's same request (a hardened policy; a pool of two workers,
# on mi210, whose CU-sharing rows cross the pool too).  CUDA on the CPU,
# VMEM alone to keep it short: transient faults retried to the ground
# truth with nothing degraded, under the reference's descriptor layout; and
# the pool config accepted and ignored — nothing spawned, the same launches
# as the inline run.
HARDENED = dict(max_retries=3, mad_k=5.0, resample_band=0.02,
                resample_extra=9)
PCFG = ParallelConfig(workers=2, min_rows_per_shard=1, call_timeout_s=30.0)


def _vmem_discovery(**kw):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ops.reset_launches()
        topo, timings = discover_cuda(make_cuda_model(), n_samples=N_SAMPLES,
                                      elements=["VMEM"], **kw)
        return topo, timings, [fn.launches for fn in ops.WRAPPERS]
    finally:
        torch.set_num_threads(threads)


def test_sim_resilience_equals_reference():
    got, t = discover_sim(make_h100_like(), n_samples=N_SAMPLES,
                          resilience=Resilience(**HARDENED,
                                                sleep=lambda _s: None))
    want, wt = ref_discover_sim(ref_h100(), n_samples=N_SAMPLES,
                                resilience=RefResilience(
                                    **HARDENED, sleep=lambda _s: None))
    assert _without_notes(got) == _without_notes(want)
    assert t.meta["cache"] == wt.meta["cache"]


def test_sim_parallel_equals_reference():
    try:
        got, t = discover_sim(make_mi210_like(), n_samples=N_SAMPLES,
                              parallel=PCFG)
        assert get_global_pool(PCFG).respawns == 0
    finally:
        shutdown_global_pools()
    if os.path.isdir("/dev/shm"):
        assert not [n for n in os.listdir("/dev/shm")
                    if n.startswith(f"mt4g{os.getpid()}p")]
    want, wt = ref_discover_sim(ref_mi210(), n_samples=N_SAMPLES)
    assert _without_notes(got) == _without_notes(want)
    assert t.meta["cache"] == wt.meta["cache"]


def test_cuda_resilience_retries_to_ground_truth():
    from repro.core.discover import pallas_request_descriptor
    from repro_torch.core.discover import cuda_request_descriptor

    gt = make_cuda_model().ground_truth()
    policy = Resilience(**HARDENED, sleep=lambda _s: None)
    for attempt in range(2):
        # seed 2 faults the first DeviceMemory read-bandwidth call, so an
        # item retries whatever rows the measured sweeps ask for
        chaos = ChaosRunner(CudaRunner(device="cpu", base_steps=BASE_STEPS),
                            FaultSchedule(seed=2, transient_rate=0.2,
                                          batch_fault_rate=0.2))
        topo, timings, launches = _vmem_discovery(runner=chaos,
                                                  resilience=policy)
        assert chaos.faults_injected > 0 and all(n > 0 for n in launches[2:])
        assert timings.meta["resilience"]["retries"] >= 1
        assert timings.meta["resilience"]["degraded"] == []
        if abs(topo.find_memory("VMEM").get("size")
               - gt["VMEM"]["size"]) <= 64:
            break
    else:
        pytest.fail("VMEM size missed the ground truth twice")
    got = cuda_request_descriptor(make_cuda_model(), N_SAMPLES, ["VMEM"],
                                  resilience=policy)
    want = pallas_request_descriptor(
        make_pallas_model(), N_SAMPLES, ["VMEM"],
        resilience=RefResilience(**HARDENED))
    assert got["resilience"] == want["resilience"] == {
        "mad_k": 5.0, "resample_band": 0.02, "resample_extra": 9}
    assert set(got) == set(want)


class _Replay:
    """A ``CudaRunner`` on the CPU behind a log of its probe calls.

    Without ``recorded`` it keeps each call's (method, arguments) and
    result.  Given another replay's log it checks that each call asks what
    the recorded one asked, runs it on its own runner all the same (the
    kernels launch as they would) and returns the recorded result.  A
    discovery through it then takes the recorded discovery's path whatever
    the CPU's timings: the size sweep's bisection follows the timings, so
    two measured discoveries may launch different counts."""

    def __init__(self, recorded: list | None = None):
        self._base = CudaRunner(device="cpu", base_steps=BASE_STEPS)
        self._recorded = recorded
        self.log = []

    def __getattr__(self, name):
        attr = getattr(self._base, name)
        if not callable(attr):
            return attr

        def call(*args, **kwargs):
            out = attr(*args, **kwargs)
            asked = (name, repr(args), repr(kwargs))
            if self._recorded is not None:
                want, out = self._recorded[len(self.log)]
                assert asked == want, f"call {len(self.log)}: {asked}"
            self.log.append((asked, copy.deepcopy(out)))
            return copy.deepcopy(out)
        return call


def test_cuda_parallel_stays_inline():
    """``parallel=`` on a CUDA runner spawns no worker and registers no
    pool, and runs inline the discovery that the call without it runs: on
    the same probe results (``_Replay``) the same calls, launches and
    topology."""
    # an earlier test's pool may still be reaping its workers; closing every
    # pool joins them, so the snapshot holds no child on its way out
    shutdown_global_pools()
    children = set(multiprocessing.active_children())
    pooled_runner = _Replay()
    pooled_topo, _, pooled = _vmem_discovery(
        runner=pooled_runner, budget=None, fuse=False, parallel=PCFG)
    assert not parallel_module._POOLS
    assert set(multiprocessing.active_children()) == children
    inline_runner = _Replay(pooled_runner.log)
    inline_topo, _, inline = _vmem_discovery(
        runner=inline_runner, budget=None, fuse=False)
    assert len(inline_runner.log) == len(pooled_runner.log) > 0
    assert pooled == inline and all(n > 0 for n in pooled[2:])
    assert _without_notes(inline_topo) == _without_notes(pooled_topo)


def test_cuda_runner_defaults_to_the_card():
    import inspect

    assert inspect.signature(CudaRunner).parameters["device"].default \
        == "cuda"
    assert inspect.signature(discover_cuda).parameters["device"].default \
        == "cuda"
    assert torch.device(CudaRunner(device="cpu").device).type == "cpu"
