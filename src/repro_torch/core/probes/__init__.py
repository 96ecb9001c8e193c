"""Microbenchmark probes (paper contribution C2).

``CudaRunner`` and ``make_cuda_model`` load on first use: their module
imports ``torch``, and everything else here is numpy only, so a process
pool's worker (``engine.parallel``) rebuilds sim and chaos runners without
importing ``torch``.
"""
from .runners import (ProbeRunner, SimRunner, SpaceInfo, random_cycle,
                      sattolo_cycle)
from .chaos import ChaosRunner, FaultSchedule
from .size import SizeResult, find_size
from .latency import LatencyResult, measure_latency
from .linesize import (GranularityResult, LineSizeResult,
                       find_fetch_granularity, find_line_size, snap_pow2)
from .amount import (AmountResult, CuSharingResult, SharingResult,
                     align_segments, find_amount, find_cu_sharing, find_sharing)
from .bandwidth import BandwidthResult, measure_bandwidth

__all__ = [
    "ChaosRunner", "FaultSchedule",
    "CudaRunner", "ProbeRunner", "SimRunner", "SpaceInfo",
    "make_cuda_model", "random_cycle", "sattolo_cycle",
    "SizeResult", "find_size", "LatencyResult", "measure_latency",
    "GranularityResult", "LineSizeResult", "find_fetch_granularity",
    "find_line_size", "snap_pow2",
    "AmountResult", "CuSharingResult", "SharingResult", "align_segments",
    "find_amount", "find_cu_sharing", "find_sharing",
    "BandwidthResult", "measure_bandwidth",
]


def __getattr__(name):
    if name in ("CudaRunner", "make_cuda_model"):
        from . import cuda_runner

        return getattr(cuda_runner, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
