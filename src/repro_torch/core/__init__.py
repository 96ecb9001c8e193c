"""MT4G topology discovery (the paper's primary contribution), ported to
PyTorch: the probe engine, statistics and topology model of the reference
package, with probe kernels written by hand for NVIDIA Hopper."""
from .topology import (Attribute, ComputeElement, Link, MemoryElement,
                       Topology, topology_equivalent)
from .catalog import CATALOG, HOST_CPU, TPU_V4, TPU_V5E, HardwareSpec, get_spec
from .simulate import (SIM_DEVICES, SimDevice, SimLevel, device_from_dict,
                       make_h100_like, make_mi210_like, make_v5e_like)
from .discover import (DiscoveryRequest, DiscoveryTimings,
                       default_sweep_budget, discover, discover_cuda,
                       discover_host, discover_sim, discover_sim_legacy,
                       spec_from_topology)
from .engine.fusion import FusionDispatcher, run_fused
from .engine.planner import SweepBudget
from .engine.store import GcPolicy, TopologyStore, request_key
from .errors import DegradedResult, Resilience, TransientRunnerError

__all__ = [
    "Attribute", "ComputeElement", "Link", "MemoryElement", "Topology",
    "topology_equivalent",
    "CATALOG", "HOST_CPU", "TPU_V4", "TPU_V5E", "HardwareSpec", "get_spec",
    "SIM_DEVICES", "SimDevice", "SimLevel", "device_from_dict",
    "make_h100_like", "make_mi210_like", "make_v5e_like",
    "DiscoveryRequest", "DiscoveryTimings", "discover", "discover_cuda",
    "discover_host", "discover_sim", "discover_sim_legacy",
    "default_sweep_budget",
    "spec_from_topology",
    "SweepBudget", "GcPolicy", "TopologyStore", "request_key",
    "FusionDispatcher", "run_fused",
    "DegradedResult", "Resilience", "TransientRunnerError",
]
