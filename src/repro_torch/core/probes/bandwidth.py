"""Bandwidth benchmark (paper §IV-I).

The stream-pattern bandwidth probe is delegated to the runner (SimDevice
returns its configured value with noise; the CUDA runner times the stream
kernels of ``repro_torch.kernels.stream_probe``).  The collective
probes of the reference package wait for a later slice of the port.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["BandwidthResult", "measure_bandwidth"]


@dataclass(frozen=True)
class BandwidthResult:
    read_bw: float      # bytes/s
    write_bw: float     # bytes/s


def measure_bandwidth(runner, space: str) -> BandwidthResult:
    return BandwidthResult(
        read_bw=float(runner.bandwidth(space, "read")),
        write_bw=float(runner.bandwidth(space, "write")),
    )
