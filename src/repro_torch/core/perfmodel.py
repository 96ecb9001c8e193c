"""Hong & Kim warp-parallelism performance model (paper §VI-A, eqs. 3-4).

MT4G's first integration scenario: the GPU-specific parameters of the
CWP/MWP analytical model (mem_latency, mem_bandwidth, mem_freq, active
warps, ...) are supplied by topology discovery instead of datasheets. We
implement the model faithfully and parameterize it from either a
``HardwareSpec`` (catalog) or a discovered ``Topology``.  The model itself is
vendor-agnostic arithmetic, the same as the reference package's; the
verdict is CWP >= MWP -> memory-bound.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["AppParams", "GpuParams", "PerfModelResult", "evaluate",
           "gpu_params_from_topology"]


@dataclass(frozen=True)
class AppParams:
    """Application-specific parameters (profiling side)."""

    comp_cycles: float            # compute cycles per warp between mem ops
    mem_cycles: float             # memory waiting cycles per warp
    loads_per_warp: float         # memory insts issued per warp
    active_warps_per_sm: float    # occupancy


@dataclass(frozen=True)
class GpuParams:
    """Device-specific parameters — the MT4G-supplied side."""

    mem_latency: float            # cycles (discovered: load_latency)
    mem_bandwidth: float          # bytes/s (discovered: read_bw)
    mem_freq: float               # Hz
    departure_delay: float        # cycles between consecutive mem requests
    bytes_per_load: float = 128.0


@dataclass(frozen=True)
class PerfModelResult:
    cwp: float
    mwp: float
    mwp_prime: float
    mwp_bw_bound: float
    memory_bound: bool
    est_cycles_per_warp_batch: float


def evaluate(app: AppParams, gpu: GpuParams) -> PerfModelResult:
    """Paper eqs. 3-4 plus the Hong&Kim cycle estimate."""
    n = max(app.active_warps_per_sm, 1.0)

    cwp_prime = (app.mem_cycles + app.comp_cycles) / max(app.comp_cycles, 1e-9)
    cwp = min(cwp_prime, n)

    mwp_prime = gpu.mem_latency / max(gpu.departure_delay, 1e-9)
    # MWP'' — bandwidth ceiling: how many warps the memory system can feed.
    per_warp_bw = (gpu.mem_freq * app.loads_per_warp * gpu.bytes_per_load
                   / max(gpu.mem_latency, 1e-9))
    mwp_bw = gpu.mem_bandwidth / max(per_warp_bw * n, 1e-9) * n
    mwp = min(mwp_prime, mwp_bw, n)

    # Hong & Kim case analysis: CWP > MWP -> memory bound; the saturated
    # case CWP == MWP == N is also the memory-limited regime (their Eq. 24),
    # hence >= rather than > .
    memory_bound = cwp >= mwp
    # Hong & Kim total-cycle estimates (simplified two-regime form).
    if memory_bound:
        est = app.mem_cycles * n / max(mwp, 1e-9)
    else:
        est = app.mem_cycles + app.comp_cycles * n
    return PerfModelResult(cwp=cwp, mwp=mwp, mwp_prime=mwp_prime,
                           mwp_bw_bound=mwp_bw, memory_bound=memory_bound,
                           est_cycles_per_warp_batch=est)


def gpu_params_from_topology(topo, mem_element: str = "DeviceMemory",
                             clock_hz: float = 1.0e9,
                             departure_delay: float = 4.0) -> GpuParams:
    """Build the GPU-side parameters from a discovered ``Topology`` —
    the paper's 'obtain GPU-specific parameters via MT4G' step."""
    me = topo.find_memory(mem_element)
    if me is None:
        raise KeyError(f"topology has no memory element '{mem_element}'")
    lat = float(me.get("load_latency", 500.0))
    bw = float(me.get("read_bw", 100.0)) * 1e9  # stored in GB/s
    return GpuParams(mem_latency=lat, mem_bandwidth=bw, mem_freq=clock_hz,
                     departure_delay=departure_delay)
