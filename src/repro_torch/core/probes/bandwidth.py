"""Bandwidth benchmarks (paper §IV-I) and collective probes.

The stream-pattern bandwidth probe is delegated to the runner (SimDevice
returns its configured value with noise; the CUDA runner times the stream
kernels of ``repro_torch.kernels.stream_probe``; the host runner times a
``torch`` reduction/copy on the CPU).

The collective probes time ``torch.cuda.nccl`` collectives over the visible
cards when there are enough of them; otherwise they evaluate the standard
ring/bidirectional-torus analytic models against catalog constants — the
same numbers the roofline's collective term uses.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

__all__ = ["BandwidthResult", "measure_bandwidth",
           "CollectiveEstimate", "ring_all_reduce_time", "ring_all_gather_time",
           "all_to_all_time", "live_collective", "measure_collective"]


@dataclass(frozen=True)
class BandwidthResult:
    read_bw: float      # bytes/s
    write_bw: float     # bytes/s


def measure_bandwidth(runner, space: str) -> BandwidthResult:
    return BandwidthResult(
        read_bw=float(runner.bandwidth(space, "read")),
        write_bw=float(runner.bandwidth(space, "write")),
    )


# --------------------------------------------------------------------------
# Collective probes / analytic models
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class CollectiveEstimate:
    op: str
    bytes_moved: int
    n_devices: int
    seconds: float
    effective_bw: float     # bytes/s seen by one device


def ring_all_reduce_time(nbytes: int, n: int, link_bw: float) -> float:
    """Ring all-reduce: 2(n-1)/n * bytes across the slowest link."""
    if n <= 1:
        return 0.0
    return 2.0 * (n - 1) / n * nbytes / link_bw


def ring_all_gather_time(nbytes_per_shard: int, n: int, link_bw: float) -> float:
    """Ring all-gather of n shards of ``nbytes_per_shard``."""
    if n <= 1:
        return 0.0
    return (n - 1) * nbytes_per_shard / link_bw


def all_to_all_time(nbytes_total: int, n: int, link_bw: float) -> float:
    """All-to-all where each device exchanges 1/n of its data with each peer;
    on a ring/torus the bisection constrains it to ~bytes*(n-1)/n / bw."""
    if n <= 1:
        return 0.0
    return (n - 1) / n * nbytes_total / link_bw


def _live_collective_seconds(op: str, nbytes: int, axis_size: int,
                             repeats: int) -> float:
    """Best wall time of one ``torch.cuda.nccl`` collective over cards
    0..axis_size-1, each holding its 1/axis_size f32 shard."""
    import torch
    import torch.cuda.nccl as nccl

    n = max(nbytes // 4 // axis_size, 1)
    devices = range(axis_size)
    shards = [torch.ones(n, dtype=torch.float32, device=f"cuda:{d}")
              for d in devices]
    if op == "all_reduce":
        call = lambda: nccl.all_reduce(shards)  # noqa: E731 — in place
    elif op == "all_gather":
        gathered = [torch.empty(n * axis_size, dtype=torch.float32,
                                device=f"cuda:{d}") for d in devices]
        call = lambda: nccl.all_gather(shards, gathered)  # noqa: E731
    else:
        raise ValueError(f"unsupported live collective '{op}'")

    def timed() -> int:
        t0 = time.perf_counter_ns()
        call()
        for d in devices:
            torch.cuda.synchronize(d)
        return time.perf_counter_ns() - t0

    timed()                                 # warm-up: communicator set-up
    return min(timed() for _ in range(repeats)) * 1e-9


def live_collective(axis_size: int) -> bool:
    """Whether ``measure_collective`` times real cards at ``axis_size``:
    at least that many are visible, and more than one is asked for."""
    import torch

    return torch.cuda.device_count() >= axis_size > 1


def measure_collective(op: str, nbytes: int, axis_size: int,
                       link_bw: float, repeats: int = 3) -> CollectiveEstimate:
    """Measure a collective across the visible cards if there are at least
    ``axis_size > 1`` of them, otherwise fall back to the analytic torus
    model (documented provenance)."""
    if live_collective(axis_size):
        secs = _live_collective_seconds(op, nbytes, axis_size, repeats)
    else:
        if op == "all_reduce":
            secs = ring_all_reduce_time(nbytes, axis_size, link_bw)
        elif op == "all_gather":
            secs = ring_all_gather_time(nbytes // max(axis_size, 1), axis_size,
                                        link_bw)
        else:
            secs = all_to_all_time(nbytes, axis_size, link_bw)
    secs = max(secs, 1e-12)
    return CollectiveEstimate(op, nbytes, axis_size, secs, nbytes / secs)
