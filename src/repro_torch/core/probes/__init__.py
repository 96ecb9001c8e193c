"""Microbenchmark probes (paper contribution C2).

``CudaRunner`` and ``make_cuda_model`` load on first use: their module
imports ``torch``, and everything else here is numpy only, so a process
pool's worker (``engine.parallel``) rebuilds sim, chaos and host runners
without importing ``torch``.  ``HostRunner.bandwidth`` and
``measure_collective`` import it where they run.
"""
from .runners import (HostRunner, ProbeRunner, SimRunner, SpaceInfo,
                      random_cycle, sattolo_cycle)
from .chaos import ChaosRunner, FaultSchedule
from .size import SizeResult, find_size
from .latency import LatencyResult, measure_latency
from .linesize import (GranularityResult, LineSizeResult,
                       find_fetch_granularity, find_line_size, snap_pow2)
from .amount import (AmountResult, CuSharingResult, SharingResult,
                     align_segments, find_amount, find_cu_sharing, find_sharing)
from .bandwidth import (BandwidthResult, CollectiveEstimate, all_to_all_time,
                        measure_bandwidth, measure_collective,
                        ring_all_gather_time, ring_all_reduce_time)
from .adjacency import AdjacencyResult, SimPod, find_link_adjacency

__all__ = [
    "ChaosRunner", "FaultSchedule",
    "CudaRunner", "HostRunner", "ProbeRunner", "SimRunner", "SpaceInfo",
    "make_cuda_model", "random_cycle", "sattolo_cycle",
    "SizeResult", "find_size", "LatencyResult", "measure_latency",
    "GranularityResult", "LineSizeResult", "find_fetch_granularity",
    "find_line_size", "snap_pow2",
    "AmountResult", "CuSharingResult", "SharingResult", "align_segments",
    "find_amount", "find_cu_sharing", "find_sharing",
    "BandwidthResult", "CollectiveEstimate", "all_to_all_time",
    "measure_bandwidth", "measure_collective", "ring_all_gather_time",
    "ring_all_reduce_time",
    "AdjacencyResult", "SimPod", "find_link_adjacency",
]


def __getattr__(name):
    if name in ("CudaRunner", "make_cuda_model"):
        from . import cuda_runner

        return getattr(cuda_runner, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
