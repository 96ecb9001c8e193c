"""Pointer-chase probe kernels (paper §IV-A) for NVIDIA Hopper.

The CUDA C++ kernels live in ``csrc/pchase.cu``; this module launches them
and holds their plain PyTorch versions and the pure-Python contracts.

``pchase_kernel_batch`` is the probe-engine kernel: a whole §IV-B size sweep
maps onto the launch — row i carries its own single-cycle permutation
(zero-padded to a shared width) and its own chain length, read by the kernel
from device memory, so sweeps with different step counts reuse one compiled
kernel.  The *caller* times the whole call; each row returns its final
cursor and a visit checksum, so the chain cannot be dead-code-eliminated,
and both are the correctness contract checked against the references.

``pchase_kernel`` is the single-chain entry point (the reference's
``pchase_kernel``, ``pchase_probe.py:53``): one row of the same CUDA grid
kernel, with the chain length ``iters`` as that row's step count.

``eviction_kernel_batch`` extends the same trick to the eviction-pattern
probes (paper §IV-F/§IV-G/§IV-H, Fig. 3): each row first walks an *evictor*
chain (warm phase over buffer B) and then a *probe* chain (buffer A), both
phase lengths per-row kernel data.  A row with ``warm == 0`` is
bit-identical to the same ``pchase_kernel_batch`` row.

``chase_floor`` is a yardstick, not a port: one thread times dependent
loads with nothing else on the chain, which gives the chase rows the
latency bound of the level their footprint lives in.  It runs on the card
only (there is no plain version of a latency), is in no wrapper tuple of
``ops`` and is launched by ``chip_smoke.py`` alone.

Inputs are validated by the wrappers in ``ops``; the functions here assume
contiguous int32 tensors of matching shapes on one device.
"""
from __future__ import annotations

import numpy as np
import torch

from ._build import check_launch, load_library

__all__ = ["pchase_kernel", "pchase_kernel_batch", "eviction_kernel_batch",
           "chase_floor", "FLOOR_VARIANTS", "FLOOR_UNROLL", "pchase_plain", "pchase_batch_plain", "eviction_batch_plain",
           "pchase_reference", "eviction_reference"]


def pchase_kernel_batch(perms: torch.Tensor,
                        steps: torch.Tensor) -> torch.Tensor:
    """CUDA grid p-chase: perms (R, N), steps (R,) -> (R, 2) int32
    ``[final_cursor, checksum]`` rows, one thread per row."""
    lib, _ = load_library()
    rows, n = perms.shape
    out = torch.empty((rows, 2), dtype=torch.int32, device=perms.device)
    stream = torch.cuda.current_stream(perms.device).cuda_stream
    check_launch(lib, "pchase_batch", lib.pchase_batch(
        perms.data_ptr(), steps.data_ptr(), out.data_ptr(), rows, n, stream))
    return out


def pchase_kernel(perm: torch.Tensor, iters: int) -> torch.Tensor:
    """CUDA single-row p-chase: perm (N,) -> (2,) int32
    ``[final_cursor, checksum]`` after ``iters`` loads from slot 0."""
    steps = torch.full((1,), iters, dtype=torch.int32, device=perm.device)
    return pchase_kernel_batch(perm.view(1, -1), steps)[0]


def eviction_kernel_batch(perms: torch.Tensor, evictors: torch.Tensor,
                          warm: torch.Tensor,
                          probe: torch.Tensor) -> torch.Tensor:
    """CUDA grid eviction probe: walk ``evictors[i]`` for ``warm[i]`` loads,
    then ``perms[i]`` from slot 0 for ``probe[i]`` loads, the checksum
    covering both phases -> (R, 2) int32."""
    lib, _ = load_library()
    rows, n = perms.shape
    m = evictors.shape[1]
    out = torch.empty((rows, 2), dtype=torch.int32, device=perms.device)
    stream = torch.cuda.current_stream(perms.device).cuda_stream
    check_launch(lib, "eviction_batch", lib.eviction_batch(
        perms.data_ptr(), evictors.data_ptr(), warm.data_ptr(),
        probe.data_ptr(), out.data_ptr(), rows, n, m, stream))
    return out


# What sits on the floor's chain besides the load (csrc/pchase.cu
# chase_floor_kernel): the address alone, the kernels' clamp, or a signed
# index with a compare, an early exit and the checksum.
FLOOR_VARIANTS = ("load", "clamp", "check")
FLOOR_UNROLL = 256              # kFloorUnroll: loads of one timed run


def chase_floor(chain: torch.Tensor, *, warm: int, rounds: int,
                variant: str = "load") -> dict:
    """Dependent-load latency on the card: one thread walks ``chain`` (N,)
    int32, each slot holding the next slot, ``warm`` loads from slot 0 and
    then ``rounds`` x ``FLOOR_UNROLL`` timed loads.  Returns SM cycles and
    ns per timed load (``clock64`` and ``%globaltimer``), their ratio (the
    SM clock in GHz during the run) and the loads timed.  Raises without a
    card and for a tensor that is not on one: a latency has no plain
    version."""
    if not torch.cuda.is_available():
        raise RuntimeError("chase_floor: no CUDA device; the floor is a "
                           "measurement of the card and has no plain version")
    if not isinstance(chain, torch.Tensor) or chain.device.type != "cuda":
        raise ValueError(f"chase_floor: the chain must be a CUDA tensor, got "
                         f"{getattr(chain, 'device', type(chain))}")
    if chain.dtype != torch.int32 or chain.dim() != 1 \
            or not chain.is_contiguous() or not 0 < chain.shape[0] < 2**31:
        raise ValueError(f"chase_floor: expected a contiguous (N,) int32 "
                         f"chain, got {chain.dtype} {tuple(chain.shape)}")
    if variant not in FLOOR_VARIANTS:
        raise ValueError(f"chase_floor: variant {variant!r} not in "
                         f"{FLOOR_VARIANTS}")
    lib, _ = load_library()
    out = torch.empty(4, dtype=torch.int64, device=chain.device)
    stream = torch.cuda.current_stream(chain.device).cuda_stream
    check_launch(lib, "chase_floor", lib.chase_floor(
        chain.data_ptr(), chain.shape[0], int(warm), int(rounds),
        FLOOR_VARIANTS.index(variant), out.data_ptr(), stream))
    cycles, ns, loads, _ = out.tolist()
    if loads <= 0:
        raise ValueError("chase_floor: the chain left [0, N)")
    return {"cycles": cycles / loads, "ns": ns / loads, "loads": loads,
            "ghz": cycles / ns}


# --------------------------------------------------------------------------
# Plain PyTorch versions (CPU tests; the on-card yardstick of the kernels)
# --------------------------------------------------------------------------
_M32 = 0xFFFFFFFF


def _walk(rows: torch.Tensor, steps: torch.Tensor,
          checksum: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """All rows' chains at once from slot 0: final cursors and int64
    checksums (``checksum`` plus every loaded value).

    One gather per load for every row still walking: the rows are ordered
    by chain length, so those still walking are a suffix, updated in
    place.  The walk's time follows the chain lengths and the shape, never
    the rows' contents — which is what the runner's shape-matched
    calibration relies on when it times this version.
    """
    order = torch.argsort(steps, stable=True)
    lengths = steps[order].tolist()
    table = rows[order].long()
    cursor = torch.zeros((rows.shape[0], 1), dtype=torch.int64,
                         device=rows.device)
    nxt = torch.empty_like(cursor)
    total = checksum[order][:, None].clone()
    first = 0                       # rows before ``first`` are done
    views = None
    for t in range(lengths[-1] if lengths else 0):
        if views is None or lengths[first] <= t:
            while lengths[first] <= t:
                first += 1
            views = (table[first:], cursor[first:], nxt[first:],
                     total[first:])
        tab, cur, nx, tot = views
        torch.gather(tab, 1, cur, out=nx)
        cur.copy_(nx)
        tot.add_(nx)
    out_cursor = torch.empty_like(cursor[:, 0])
    out_total = torch.empty_like(out_cursor)
    out_cursor[order] = cursor[:, 0]
    out_total[order] = total[:, 0]
    return out_cursor, out_total


def _wrap_rows(cursor: torch.Tensor, checksum: torch.Tensor) -> torch.Tensor:
    """(R, 2) int32 rows, the int64 checksum wrapped to int32 as the
    kernels' 32-bit arithmetic does."""
    wrapped = checksum & _M32
    wrapped = torch.where(wrapped >= 1 << 31, wrapped - (1 << 32), wrapped)
    return torch.stack([cursor, wrapped], dim=1).to(torch.int32)


def pchase_batch_plain(perms: torch.Tensor,
                       steps: torch.Tensor) -> torch.Tensor:
    """Plain version of ``pchase_kernel_batch`` (same contract)."""
    zero = torch.zeros(perms.shape[0], dtype=torch.int64, device=perms.device)
    return _wrap_rows(*_walk(perms, steps, zero))


def pchase_plain(perm: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain version of ``pchase_kernel`` (same contract)."""
    steps = torch.full((1,), iters, dtype=torch.int32, device=perm.device)
    return pchase_batch_plain(perm.view(1, -1), steps)[0]


def eviction_batch_plain(perms: torch.Tensor, evictors: torch.Tensor,
                         warm: torch.Tensor,
                         probe: torch.Tensor) -> torch.Tensor:
    """Plain version of ``eviction_kernel_batch`` (same contract)."""
    zero = torch.zeros(perms.shape[0], dtype=torch.int64, device=perms.device)
    _, warm_sum = _walk(evictors, warm, zero)
    return _wrap_rows(*_walk(perms, probe, warm_sum & _M32))


# --------------------------------------------------------------------------
# Pure-Python contracts
# --------------------------------------------------------------------------
def _add_i32(a: int, b: int) -> int:
    """``a + b`` with int32 wrap-around, as the kernels add."""
    return (a + b + 2**31) % 2**32 - 2**31


def eviction_reference(perm, evictor, warm_steps: int,
                       probe_steps: int) -> tuple[int, int]:
    """Pure-Python two-phase walk: the contract for ``eviction_kernel_batch``."""
    checksum = 0
    cursor = 0
    ev = np.asarray(evictor)
    for _ in range(int(warm_steps)):
        cursor = int(ev[cursor])
        checksum = _add_i32(checksum, cursor)
    p = np.asarray(perm)
    cursor = 0
    for _ in range(int(probe_steps)):
        cursor = int(p[cursor])
        checksum = _add_i32(checksum, cursor)
    return cursor, checksum


def pchase_reference(perm, steps: int) -> tuple[int, int]:
    """Pure-Python chain walk: the correctness contract for both kernels.

    int32 wrap-around on the checksum matches the kernel's arithmetic.
    """
    p = np.asarray(perm)
    cursor = 0
    checksum = 0
    for _ in range(int(steps)):
        cursor = int(p[cursor])
        checksum = _add_i32(checksum, cursor)
    return cursor, checksum
