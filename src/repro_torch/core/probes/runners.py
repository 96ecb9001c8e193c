"""Probe runners: who actually executes a memory-access pattern.

The probe *workflows* (size, latency, line size, amount, ...) are runner-
agnostic — the same code drives:

* ``SimRunner``   — virtual devices with ground truth (validation tables);
* ``HostRunner``  — real measurements on this machine's CPU hierarchy using
                    a compiled dependent-load chase (``host_chase.py``; the
                    live-hardware sanity check);
* ``CudaRunner``  — the hand-written CUDA probe kernels in
                    ``repro_torch.kernels``, timed end-to-end on the card
                    against a configured ground-truth hierarchy; lives in
                    ``cuda_runner.py``.

Runners without a per-load clock time a short dependent chain end-to-end
and report the distribution across repetitions; the K-S evaluation is
identical either way.

``deterministic`` (class attribute) tells callers whether repeating a
request returns bit-identical samples: true for the request-keyed simulated
runners, false for runners whose samples are real wall-time measurements
(Host, Cuda).  The engine's caches are correctness-neutral only for
deterministic runners; for measuring runners they are a documented
trade-off (serve the first measurement) that discovery relies on anyway.
"""
from __future__ import annotations

import time
from contextvars import ContextVar
from dataclasses import dataclass
from typing import Protocol, runtime_checkable

import numpy as np

__all__ = ["ProbeRunner", "SpaceInfo", "SimRunner", "HostRunner",
           "sattolo_cycle", "random_cycle", "build_sim_runner",
           "build_host_runner", "CURRENT_FAMILY"]

# The probe family (its ``DiscoveryTimings`` bucket) whose work item the
# engine's scheduler is running in this context; "" outside one.  Runners
# that log what they time read it to file each entry under its family.
CURRENT_FAMILY: ContextVar[str] = ContextVar("probe_family", default="")


def build_sim_runner(device) -> "SimRunner":
    """Rebuild a ``SimRunner`` from its device model (pool-worker side)."""
    return SimRunner(device)


def build_host_runner(max_bytes: int, iters: int, seed: int) -> "HostRunner":
    """Rebuild a ``HostRunner`` from its config scalars (pool-worker side)."""
    return HostRunner(max_bytes=max_bytes, iters=iters, seed=seed)


@dataclass(frozen=True)
class SpaceInfo:
    """Search hints for one probeable memory space."""

    name: str
    scope: str                    # "core" | "chip" | "host"
    kind: str                     # "cache" | "scratchpad" | "memory"
    max_bytes: int                # upper bound for the size search
    supports_cold: bool = True    # cold-pass (fetch granularity) available?
    supports_amount: bool = True
    supports_sharing: bool = True


@runtime_checkable
class ProbeRunner(Protocol):
    """The capability surface the probe workflows rely on."""

    def spaces(self) -> list[SpaceInfo]: ...

    def pchase(self, space: str, array_bytes: int, stride: int,
               n_samples: int) -> np.ndarray: ...

    def pchase_batch(self, space: str, array_bytes_list, stride: int,
                     n_samples: int) -> np.ndarray: ...

    def cold_chase(self, space: str, array_bytes: int, stride: int,
                   n_samples: int) -> np.ndarray: ...

    def cold_chase_batch(self, space: str, array_bytes_list, stride_list,
                         n_samples: int) -> np.ndarray: ...

    # Heterogeneous fused batches — per-row (space, array_bytes, stride)
    # triples, the capability the cross-family fusion dispatcher coalesces
    # ready work items onto (one dispatch per round instead of one per
    # family).  Optional: the engine falls back to per-row calls when a
    # runner lacks them.
    def pchase_many(self, requests, n_samples: int) -> np.ndarray: ...

    def cold_chase_many(self, requests, n_samples: int) -> np.ndarray: ...

    def amount_probe(self, space: str, core_a: int, core_b: int,
                     array_bytes: int, n_samples: int) -> np.ndarray: ...

    def sharing_probe(self, space_a: str, space_b: str, array_bytes: int,
                      n_samples: int) -> np.ndarray: ...

    # Heterogeneous eviction-grid capability (§IV-F/G/H): requests mixes
    # ("amount", space, core_a, core_b, ab), ("sharing", space_a, space_b,
    # ab) and ("cu", space, cu_a, cu_b, ab) rows; returns (R, n_samples)
    # with row i bit-identical to the matching single-probe call.  Runners
    # without multi-actor control raise NotImplementedError.
    def eviction_many(self, requests, n_samples: int) -> np.ndarray: ...

    def bandwidth(self, space: str, mode: str = "read") -> float: ...


def sattolo_cycle(n: int, rng: np.random.Generator) -> np.ndarray:
    """Random single-cycle permutation (defeats stride prefetchers; the
    standard p-chase array construction, cf. Mei & Chu [39])."""
    perm = np.arange(n, dtype=np.int32)
    for i in range(n - 1, 0, -1):
        j = rng.integers(0, i)
        perm[i], perm[j] = perm[j], perm[i]
    return perm


def random_cycle(n: int, rng: np.random.Generator) -> np.ndarray:
    """Vectorized Sattolo equivalent: a uniform random single-cycle
    permutation built from one ``rng.permutation`` call.

    ``sattolo_cycle`` walks an O(n) Python loop — fine for host-probe slot
    counts, too slow for the Pallas sweeps that need fresh million-slot
    buffers.  Visiting a random ordering ``sigma`` cyclically
    (``perm[sigma[i]] = sigma[i+1]``) yields exactly the Sattolo
    distribution (every n-cycle equally likely), in numpy time.
    """
    if n <= 1:
        return np.zeros(max(n, 1), dtype=np.int32)
    sigma = rng.permutation(n).astype(np.int32)
    perm = np.empty(n, dtype=np.int32)
    perm[sigma] = np.roll(sigma, -1)
    return perm


# --------------------------------------------------------------------------
# Simulated runner
# --------------------------------------------------------------------------
class SimRunner:
    """Adapts a ``SimDevice`` to the ProbeRunner protocol."""

    deterministic = True     # request-keyed sample streams

    def __init__(self, device):
        self.device = device

    def spaces(self) -> list[SpaceInfo]:
        out = []
        for lvl in self.device.levels:
            out.append(SpaceInfo(
                name=lvl.name, scope=lvl.scope, kind=lvl.kind,
                max_bytes=lvl.size * 8,
                supports_cold=lvl.kind == "cache",
                supports_amount=lvl.kind == "cache" and lvl.scope == "core",
                supports_sharing=lvl.kind == "cache",
            ))
        return out

    def pchase(self, space, array_bytes, stride, n_samples):
        return self.device.pchase(space, array_bytes, stride, n_samples)

    def pchase_batch(self, space, array_bytes_list, stride, n_samples):
        """One vectorized call for a whole size sweep (engine fast path)."""
        return self.device.pchase_batch(space, array_bytes_list, stride,
                                        n_samples)

    def cold_chase(self, space, array_bytes, stride, n_samples):
        return self.device.cold_chase(space, array_bytes, stride, n_samples)

    def cold_chase_batch(self, space, array_bytes_list, stride_list,
                         n_samples):
        """One vectorized call for a whole granularity stride sweep."""
        return self.device.cold_chase_batch(space, array_bytes_list,
                                            stride_list, n_samples)

    def pchase_many(self, requests, n_samples):
        """Cross-family fused batch: per-row (space, array_bytes, stride)."""
        return self.device.pchase_many(requests, n_samples)

    def cold_chase_many(self, requests, n_samples):
        return self.device.cold_chase_many(requests, n_samples)

    def amount_probe(self, space, core_a, core_b, array_bytes, n_samples):
        return self.device.amount_probe(space, core_a, core_b, array_bytes, n_samples)

    def sharing_probe(self, space_a, space_b, array_bytes, n_samples):
        return self.device.sharing_probe(space_a, space_b, array_bytes, n_samples)

    def cu_sharing_probe(self, cu_a, cu_b, array_bytes, n_samples,
                         space="sL1d"):
        return self.device.cu_sharing_probe(cu_a, cu_b, array_bytes,
                                            n_samples, space=space)

    def cu_sharing_probe_batch(self, cu_a, cu_bs, array_bytes, n_samples,
                               space="sL1d"):
        return self.device.cu_sharing_probe_batch(cu_a, cu_bs, array_bytes,
                                                  n_samples, space=space)

    def eviction_many(self, requests, n_samples):
        """Mixed amount/sharing/cu eviction rows in one fused dispatch."""
        return self.device.eviction_many(requests, n_samples)

    def bandwidth(self, space, mode="read"):
        return self.device.bandwidth(space, mode)

    def api_size(self, space: str) -> int | None:
        """API-reported capacity (paper Table I: chip-scope totals come from
        the driver API, not the benchmark)."""
        try:
            return self.device.level(space).size
        except KeyError:
            return None

    def cu_ids(self) -> list[int]:
        """All CU ids participating in sL1d sharing groups (AMD, §IV-H)."""
        return sorted(cu for grp in self.device.cu_share_groups for cu in grp)

    @property
    def cores_per_sm(self) -> int:
        return self.device.cores_per_sm

    def runner_spec(self):
        """Rebuild recipe for pool workers: the device model is the whole
        state (request-keyed streams live in the device seed), so a worker
        rebuilt from it is bit-identical to this runner."""
        from ..engine.parallel import RunnerSpec

        return RunnerSpec(build_sim_runner, (self.device,))


# --------------------------------------------------------------------------
# Host (real CPU) runner
# --------------------------------------------------------------------------
class HostRunner:
    """Real p-chase measurements against this machine's cache hierarchy.

    Per-load timing at ns resolution is not available from Python, so each
    "sample" is the mean ns/load of a compiled dependent-load loop
    (``host_chase.py``; warm, single cycle), and the probe distribution is
    built across ``n_samples`` repetitions.  The chase buffers are the
    reference package's: the same ``sattolo_cycle`` drawn from the same
    ``np.random.default_rng(seed)`` in the same order.
    """

    ELEM_BYTES = 4  # int32 chase indices
    deterministic = False    # samples are real wall-time measurements

    def __init__(self, max_bytes: int = 256 * 1024**2, iters: int = 1 << 15,
                 seed: int = 0):
        self.max_bytes = max_bytes
        self.iters = iters
        self.seed = seed
        self._rng = np.random.default_rng(seed)

    def spaces(self) -> list[SpaceInfo]:
        return [SpaceInfo(
            name="host-cache", scope="host", kind="cache",
            max_bytes=self.max_bytes,
            supports_cold=False, supports_amount=False, supports_sharing=False,
        )]

    # ------------------------------------------------------------- chase
    def pchase(self, space, array_bytes, stride, n_samples):
        del space
        from .host_chase import load_host_chase

        stride_elems = max(stride // self.ELEM_BYTES, 1)
        n = max(array_bytes // self.ELEM_BYTES // stride_elems, 4)
        # Random single cycle over n dense int32 slots, as the reference
        # package builds it: the chase touches 4 * n = 4 * array_bytes /
        # stride bytes, not ``array_bytes`` (the same buffer in both
        # packages; see ROADMAP, queue C).
        perm = sattolo_cycle(n, self._rng)
        chase, _ = load_host_chase()
        addr = perm.ctypes.data
        iters = max(self.iters, n)
        chase(addr, iters)                  # warm-up pass (paper §IV-A)
        out = np.empty(n_samples)
        for s in range(n_samples):
            t0 = time.perf_counter_ns()
            chase(addr, iters)
            out[s] = (time.perf_counter_ns() - t0) / iters
        return out

    def pchase_batch(self, space, array_bytes_list, stride, n_samples):
        """Batched sweep over array sizes sharing one compiled chase.

        Real hardware cannot overlap dependent chases, so this is a loop —
        but it gives the engine one call site to schedule/cache, same as
        the simulator's vector path.
        """
        rows = [self.pchase(space, int(ab), stride, n_samples)
                for ab in array_bytes_list]
        return np.stack(rows)

    def pchase_many(self, requests, n_samples):
        """Fused heterogeneous batch: dependent chases cannot overlap on
        real hardware, so this is a loop — but it gives the fusion
        dispatcher one call site, same as the simulator's vector path."""
        return np.stack([self.pchase(space, int(ab), int(stride), n_samples)
                         for space, ab, stride in requests])

    def runner_spec(self):
        """Rebuild recipe for pool workers.  Host samples are real wall
        time, so shards are *statistically* interchangeable with inline
        rows, never bit-identical — same contract as ``deterministic``."""
        from ..engine.parallel import RunnerSpec

        return RunnerSpec(build_host_runner,
                          (self.max_bytes, self.iters, self.seed))

    def cold_chase(self, space, array_bytes, stride, n_samples):
        raise NotImplementedError("host runner has no cold-pass control")

    def cold_chase_batch(self, space, array_bytes_list, stride_list,
                         n_samples):
        raise NotImplementedError("host runner has no cold-pass control")

    def cold_chase_many(self, requests, n_samples):
        raise NotImplementedError("host runner has no cold-pass control")

    def amount_probe(self, *a, **k):
        raise NotImplementedError("host runner is single-actor")

    def sharing_probe(self, *a, **k):
        raise NotImplementedError("host runner has a unified cache path")

    def eviction_many(self, *a, **k):
        raise NotImplementedError("host runner is single-actor")

    # --------------------------------------------------------- bandwidth
    def bandwidth(self, space, mode="read", nbytes: int = 128 * 1024**2,
                  repeats: int = 5):
        """Bytes a second of ``torch.sum`` (read) or ``v + 1.0`` (write)
        over ``nbytes`` of f32 on the CPU, best of ``repeats`` after one
        warm-up call.  ``torch`` is imported here alone, so pool workers
        that only chase never load it."""
        del space
        import torch

        x = torch.arange(nbytes // 4, dtype=torch.float32)
        fn = torch.sum if mode == "read" else (lambda v: v + 1.0)
        fn(x)
        best = np.inf
        for _ in range(repeats):
            t0 = time.perf_counter_ns()
            fn(x)
            best = min(best, time.perf_counter_ns() - t0)
        return nbytes / (best * 1e-9)
