"""CudaRunner: the ProbeRunner backend over the hand-written probe kernels.

The port's counterpart of the reference package's ``PallasRunner``: every
probe request executes the Hopper kernels of ``repro_torch.kernels`` — the
CUDA C++ ``pchase_batch`` / ``eviction_batch`` grids for dependent-load
chains, the CUDA C++ ``stream_read`` and ``stream_write`` kernels for
bandwidth — and the *caller times the whole call* (host clock around the
launch plus ``torch.cuda.synchronize()``; on the CPU, where the plain
versions run on the calling thread, that thread's CPU clock).

The hit/miss behavior comes from a configured ground-truth hierarchy (a
``SimDevice`` model, default ``make_cuda_model``): the modeled level an
access hits sets the *length of the dependent chain the kernel actually
executes* — a modeled miss literally serializes more loads, exactly as a
real miss serializes more cycles — and the reported per-load value comes
from timing that execution.  Locations of the latency distributions
therefore track the configured hierarchy (sizes, line size, fetch
granularity are discoverable and checkable against
``model.ground_truth()``), while the distributions themselves carry real
end-to-end timing noise, which is what the K-S machinery is built to
absorb.

Calibration: the probe workflows compare distributions *across* requests
(a doubling step against its baseline, an eviction probe against hit/miss
references), so every timed execution is normalized by a back-to-back
**shape-matched calibration chain**: a separate buffer of the *same launch
shape and the same per-row chain lengths*, executed adjacent in time, so a
sample is ``modeled_cycles x (request wall / calibration wall)``.  On the
card the rows of one launch run at once on different SMs, so a launch's
wall time follows its longest row plus the launch overhead; the ratio stays
meaningful only because the calibration launch has the identical
(rows x bucket, steps) profile.  Reported latencies land in model-cycle
units comparable across requests *and across launch shapes*.

Implementation notes:

* chase buffers are Sattolo-style single-cycle permutations sized per
  request from the probed ``SpaceInfo`` (slot i stands for byte offset
  ``i * stride``, so the resident footprint matches ``array_bytes``),
  generated vectorized (``random_cycle``) and padded to power-of-two
  buckets; the numpy RNG is drawn in the reference runner's order, so for
  one seed both runners hand their kernels the same arrays;
* the chain length is passed to the kernel as data, so one compiled kernel
  serves every sweep;
* every array a timed loop launches with is moved to the device once,
  before the loop's first clock reading: a sweep's ``(R, bucket)`` int32
  matrix can be tens of MB, and a host-to-device copy inside the timed
  window would be timed with the kernel;
* scratchpad spaces advertise ``supports_cold=False``: end-to-end timing
  cannot classify individual loads of a cold pass there, and the engine
  registry honors the capability flag by never scheduling the family;
* every timed loop leaves one entry in ``calibrations``: the family the
  engine was running, the loop (``grid``, ``cold`` or ``evict``), each
  request row's footprint on the card and the calibration rows' (slots x
  4 B; a calibration row is a cycle over its whole power-of-two bucket),
  the median request/calibration wall ratio, the summed host wall of its
  timed launches and the host seconds spent since the entry before it on
  building chase buffers (``random_cycle``) and moving them to the device.
  A cache boundary that falls between the two footprints would bias the
  ratio.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ...kernels import ops
from ..simulate import SimDevice, SimLevel
from .runners import CURRENT_FAMILY, SpaceInfo, random_cycle

__all__ = ["CudaRunner", "make_cuda_model"]

KIB = 1024


def make_cuda_model(seed: int = 0) -> SimDevice:
    """Default ground-truth hierarchy for the kernel backend.

    The same levels, seed, ``cores_per_sm`` and ``space_of_level`` as the
    reference package's ``make_pallas_model``, so the two backends are
    held to one ground truth: one cache-kind space in front of global
    loads, a scratchpad (no cold pass — capability flag), and a chip-level
    L2 ahead of device memory.
    """
    levels = [
        SimLevel("L1", 16 * KIB, 40.0, 128, 32, noise=0.0),
        SimLevel("VMEM", 64 * KIB, 12.0, 4, 4, noise=0.0, kind="scratchpad"),
        SimLevel("L2", 256 * KIB, 150.0, 128, 64, amount=1, scope="chip",
                 noise=0.0),
    ]
    return SimDevice(
        name="cuda-model", vendor="Google", levels=levels,
        mem_latency=800.0, mem_noise=0.0,
        read_bw={}, write_bw={},        # bandwidth is measured, not modeled
        cores_per_sm=8,
        space_of_level={"global": "L1", "DeviceMemory": "L2"},
        outlier_prob=0.0,
        seed=seed,
    )


def _pow2_at_least(n: int) -> int:
    return 1 << max(int(n - 1).bit_length(), 2)


class CudaRunner:
    """ProbeRunner over the ``repro_torch.kernels`` p-chase/stream kernels.

    ``device`` is where the kernels run: ``"cuda"`` (default) launches the
    hand-written kernels and fails without a card; ``"cpu"`` runs their
    plain PyTorch versions, for tests.  ``base_steps`` is the minimum
    executed chain length per timed call: launch overhead must stay small
    against the kernel's run time for the wall-clock division to carry
    signal.  ``cold_reps`` controls how many timed executions back each
    scalar the cold-pass and bandwidth probes report.
    """

    ELEM_BYTES = 4               # int32 chase indices
    deterministic = False        # samples are real wall-time measurements

    def __init__(self, model: SimDevice | None = None, *,
                 base_steps: int = 6144, cold_reps: int = 3,
                 bandwidth_bytes: int = 1 << 21, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CudaRunner: device='cuda' but no CUDA device "
                               "is available (pass device='cpu' to run the "
                               "kernels' plain versions)")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"CudaRunner: unsupported device {self.device}")
        # On the card the host clock spans launch and synchronisation.  On
        # the CPU the plain versions run on the calling thread, whose CPU
        # clock times their work alone: time a shared CPU gives to other
        # processes stays out of the samples.
        self._clock = (time.perf_counter_ns if self.device.type == "cuda"
                       else time.thread_time_ns)
        self.model = model if model is not None else make_cuda_model()
        self.base_steps = int(base_steps)
        self.cold_reps = int(cold_reps)
        self.bandwidth_bytes = int(bandwidth_bytes)
        self._rng = np.random.default_rng(seed)
        self._perm_cache: dict[int, np.ndarray] = {}
        self._evictor_cache: dict[int, np.ndarray] = {}
        self._cal_cache: dict[tuple, np.ndarray] = {}  # (shape, tag) -> perms
        self._cal_cache_cap = 16
        self._warmed: set[tuple] = set()               # launch-shape keys
        self.kernel_calls = 0
        # Eviction-grid utilization (§IV-F/G/H): dispatches vs rows carried.
        self.eviction_grid_calls = 0
        self.eviction_grid_rows = 0
        self.calibrations: list[dict] = []              # one per timed loop
        self.buffer_seconds = 0.0     # building chase buffers, copying them
        self._buffer_mark = 0.0       # buffer_seconds at the last log entry

    # ------------------------------------------------------------- spaces
    def spaces(self) -> list[SpaceInfo]:
        out = []
        for lvl in self.model.levels:
            out.append(SpaceInfo(
                name=lvl.name, scope=lvl.scope, kind=lvl.kind,
                max_bytes=lvl.size * 8,
                # Scratchpads: end-to-end timing cannot classify individual
                # cold-pass loads; the registry honors the flag.
                supports_cold=lvl.kind == "cache",
                supports_amount=lvl.kind == "cache" and lvl.scope == "core",
                supports_sharing=lvl.kind == "cache",
            ))
        return out

    # ------------------------------------------------------ device plumbing
    def _sync(self) -> None:
        """Wait for the device (stands in for ``block_until_ready``)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _to_device(self, *arrays: np.ndarray) -> list[torch.Tensor]:
        """int32 device copies of ``arrays``, landed before returning, so
        no copy is in flight when a caller's clock starts."""
        t0 = time.perf_counter()
        out = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
               .to(self.device) for a in arrays]
        self._sync()
        self.buffer_seconds += time.perf_counter() - t0
        return out

    def _cycle(self, n: int) -> np.ndarray:
        """``random_cycle(n)`` from the runner's generator, timed."""
        t0 = time.perf_counter()
        cycle = random_cycle(n, self._rng)
        self.buffer_seconds += time.perf_counter() - t0
        return cycle

    # ------------------------------------------------------- chase plumbing
    def _slots(self, array_bytes: int, stride: int) -> int:
        stride_elems = max(int(stride) // self.ELEM_BYTES, 1)
        return max(int(array_bytes) // self.ELEM_BYTES // stride_elems, 4)

    def _perm(self, n: int) -> np.ndarray:
        """Single-cycle chase buffer over ``n`` slots (memoized per size)."""
        perm = self._perm_cache.get(n)
        if perm is None:
            perm = self._cycle(n)
            self._perm_cache[n] = perm
        return perm

    def _chain_factor(self, lat_cycles: float) -> int:
        """Repetitions of the modeled latency needed to beat launch cost."""
        return max(int(np.ceil(self.base_steps / max(lat_cycles, 1.0))), 1)

    def _run_batch(self, perms: torch.Tensor, steps: torch.Tensor) -> float:
        """One timed launch of the chase grid kernel; returns wall seconds."""
        t0 = self._clock()
        ops.pchase_batch(perms, steps)
        self._sync()
        self.kernel_calls += 1
        return (self._clock() - t0) * 1e-9

    def _stacked_perms(self, slot_counts: list[int]) -> np.ndarray:
        """(R, bucket) padded permutation matrix for a sweep's rows."""
        bucket = _pow2_at_least(max(slot_counts))
        out = np.zeros((len(slot_counts), bucket), dtype=np.int32)
        for i, n in enumerate(slot_counts):
            out[i, :n] = self._perm(n)
        return out

    def _cal_perms(self, shape: tuple[int, int], tag: str = "") -> np.ndarray:
        """Calibration buffers of the given (rows, bucket) launch shape.

        Independent random cycles (never the request's own buffers), small
        LRU so sweep-sized grids do not accumulate.  ``tag`` separates
        calibration roles that must use distinct buffers at the same shape
        (e.g. the eviction kernel's probe vs warm side).
        """
        key = (tuple(shape), tag)
        cal = self._cal_cache.pop(key, None)
        if cal is None:
            rows, bucket = shape
            cal = np.stack([self._cycle(bucket)
                            for _ in range(rows)]).astype(np.int32)
            while len(self._cal_cache) >= self._cal_cache_cap:
                self._cal_cache.pop(next(iter(self._cal_cache)))
        self._cal_cache[key] = cal                      # LRU: re-insert last
        return cal

    def _log_calibration(self, loop: str, slot_counts, bucket: int,
                         ratio: float, walls) -> None:
        """Keep one timed loop's footprints, request/calibration ratio, the
        summed wall seconds of its timed launches and the buffer seconds
        spent since the last entry."""
        self.calibrations.append({
            "family": CURRENT_FAMILY.get(), "loop": loop,
            "request_bytes": [self.ELEM_BYTES * int(n) for n in slot_counts],
            "calibration_bytes": self.ELEM_BYTES * int(bucket),
            "ratio": float(ratio), "launch_s": float(np.sum(walls)),
            "buffer_s": self.buffer_seconds - self._buffer_mark})
        self._buffer_mark = self.buffer_seconds

    def _maybe_warm(self, perms: torch.Tensor, steps: torch.Tensor) -> None:
        """Warm-up launch (paper §IV-A) once per (rows, bucket) grid shape.

        Chain lengths travel as data, so every launch of a seen shape runs
        the same loaded kernel — re-warming would only burn a launch."""
        shape = tuple(perms.shape)
        if shape not in self._warmed:
            self._run_batch(perms, steps)
            self._warmed.add(shape)

    # ------------------------------------------------------------- pchase
    def pchase(self, space, array_bytes, stride, n_samples):
        lat = self.model.hit_latency(space, array_bytes, stride)
        return self._timed_chase(array_bytes, stride, lat, int(n_samples))

    def _timed_chase(self, array_bytes, stride, lat_cycles,
                     n_samples) -> np.ndarray:
        """n_samples timed kernel executions of one modeled-latency chain.

        Each sample is the calibration-normalized per-load value
        ``lat_cycles x (c_request / c_calibration)`` — model-cycle units
        with real adjacent-in-time measurement noise.
        """
        n = self._slots(array_bytes, stride)
        m = self._chain_factor(lat_cycles)
        bucket = _pow2_at_least(n)
        perms = np.zeros((1, bucket), dtype=np.int32)
        perms[0, :n] = self._perm(n)
        steps = np.array([max(int(round(m * lat_cycles)), 1)], dtype=np.int32)
        walls, cal = self._timed_loop(perms, steps, n_samples, [n])
        return lat_cycles * walls / cal

    def pchase_batch(self, space, array_bytes_list, stride, n_samples):
        """A whole size sweep on the kernel grid: ONE launch per repetition.

        Row i's chain length encodes its own modeled hit latency; each timed
        launch yields one per-step cost estimate, and row i's sample for
        that repetition is that cost times ``lat_i`` — the same quantity
        ``pchase`` measures one row at a time.
        """
        sizes = [int(ab) for ab in array_bytes_list]
        return self._timed_grid(
            [(space, ab, int(stride)) for ab in sizes], int(n_samples))

    def pchase_many(self, requests, n_samples):
        """Heterogeneous batch — per-row (space, array_bytes, stride) on ONE
        kernel grid.  Row semantics are identical to ``pchase``."""
        reqs = [(space, int(ab), int(stride))
                for space, ab, stride in requests]
        return self._timed_grid(reqs, int(n_samples))

    def _timed_grid(self, reqs: list[tuple], n_samples: int) -> np.ndarray:
        """Shared grid-launch timing loop behind pchase_batch/pchase_many."""
        lats = np.array([self.model.hit_latency(space, ab, stride)
                         for space, ab, stride in reqs])
        slot_counts = [self._slots(ab, stride) for _, ab, stride in reqs]
        perms = self._stacked_perms(slot_counts)
        # Spread the launch-beating budget over the grid: per-row chains
        # can be shorter because one launch times all of them.
        per_row = max(self.base_steps // max(len(reqs), 1), 512)
        ms = np.maximum(np.ceil(per_row / np.maximum(lats, 1.0)), 1.0)
        steps = np.asarray(np.round(ms * lats), dtype=np.int32)
        walls, cal = self._timed_loop(perms, steps, n_samples, slot_counts)
        return lats[:, None] * (walls[None, :] / cal)

    def _timed_loop(self, perms: np.ndarray, steps: np.ndarray,
                    n_samples: int,
                    slot_counts: list[int]) -> tuple[np.ndarray, float]:
        """Warm-up, ``n_samples`` timed request walls and a burst-resistant
        calibration.

        Three calibration launches INTERLEAVED with the sample loop
        (before / middle / after), combined by median: per-sample request
        noise is the distribution the statistics consume, but the
        calibration divisor scales the whole row, so no single burst may
        own it.  Every array is on the device before the first clock.
        ``slot_counts`` are the request rows' slots, for the log.
        """
        perms_t, steps_t, cal_t = self._to_device(
            perms, steps, self._cal_perms(perms.shape))
        self._maybe_warm(perms_t, steps_t)
        cal_a = self._run_batch(cal_t, steps_t)
        half = max(n_samples // 2, 1)
        walls = [self._run_batch(perms_t, steps_t) for _ in range(half)]
        cal_b = self._run_batch(cal_t, steps_t)
        walls += [self._run_batch(perms_t, steps_t)
                  for _ in range(n_samples - half)]
        cal_c = self._run_batch(cal_t, steps_t)
        cal = float(np.median([cal_a, cal_b, cal_c]))
        self._log_calibration("grid", slot_counts, perms.shape[1],
                              np.median(walls) / cal,
                              walls + [cal_a, cal_b, cal_c])
        return np.asarray(walls), cal

    # --------------------------------------------------------- cold chase
    def _cold_cycles(self, space, array_bytes, stride, n_loads) -> np.ndarray:
        """Modeled per-load cycle costs of a cold pass (§IV-D pattern)."""
        info = self.model.level(space)
        if info.kind != "cache":
            raise NotImplementedError(
                f"cuda runner: no cold-pass control over scratchpad "
                f"space '{space}'")
        miss = self.model.cold_miss_pattern(space, array_bytes, stride,
                                            n_loads)
        hit_lat = info.latency
        miss_lat = self.model.next_level_latency(space)
        return np.where(miss, miss_lat, hit_lat)

    def cold_chase(self, space, array_bytes, stride, n_samples):
        """Per-load cold-pass values: modeled hit/miss pattern x measured
        per-step cost of a real chain executing the modeled total work."""
        cycles = self._cold_cycles(space, array_bytes, stride, n_samples)
        return self._cold_rows([cycles])[0]

    def _cold_rows(self, cycles_rows: list[np.ndarray]) -> np.ndarray:
        """Execute + time the chains behind one or many cold rows.

        One grid launch covers every row; ``cold_reps`` ADJACENT (request,
        calibration) pairs are measured and the median per-pair ratio
        scales the modeled hit/miss cycle pattern, which is what the §IV-D
        threshold classification consumes: a burst spanning one pair
        inflates both walls and cancels, a spike on a single launch is
        outvoted.
        """
        totals = np.array([float(c.sum()) for c in cycles_rows])
        reps = np.maximum(np.ceil(self.base_steps / totals), 1.0)
        steps = np.asarray(np.round(reps * totals), dtype=np.int32)
        slot_counts = [max(c.size, 4) for c in cycles_rows]
        perms = self._stacked_perms(slot_counts)
        perms_t, steps_t, cal_t = self._to_device(
            perms, steps, self._cal_perms(perms.shape))
        self._maybe_warm(perms_t, steps_t)
        ratios, walls = [], []
        for _ in range(self.cold_reps):
            w_req = self._run_batch(perms_t, steps_t)
            w_cal = self._run_batch(cal_t, steps_t)
            ratios.append(w_req / w_cal)
            walls += [w_req, w_cal]
        ratio = float(np.median(ratios))
        self._log_calibration("cold", slot_counts, perms.shape[1], ratio,
                              walls)
        return np.stack([ratio * cyc for cyc in cycles_rows])

    def cold_chase_batch(self, space, array_bytes_list, stride_list,
                         n_samples):
        """The §IV-D stride sweep as one grid launch (per-row strides AND
        array sizes, like the Sim backend's batch API)."""
        cycles_rows = [self._cold_cycles(space, int(ab), int(s), n_samples)
                       for ab, s in zip(array_bytes_list, stride_list)]
        return self._cold_rows(cycles_rows)

    def cold_chase_many(self, requests, n_samples):
        """Heterogeneous cold-pass batch: per-row spaces AND strides AND
        array sizes, one grid launch for the whole round."""
        cycles_rows = [self._cold_cycles(space, int(ab), int(s), n_samples)
                       for space, ab, s in requests]
        return self._cold_rows(cycles_rows)

    # ----------------------------------------------- eviction-pattern probes
    def amount_probe(self, space, core_a, core_b, array_bytes, n_samples):
        lvl = self.model.level(space)
        lat = (self.model.next_level_latency(space)
               if self.model.amount_evicted(space, core_a, core_b,
                                            array_bytes)
               else lvl.latency)
        return self._timed_chase(array_bytes, 64, lat, int(n_samples))

    def sharing_probe(self, space_a, space_b, array_bytes, n_samples):
        lvl = self.model.level(space_a)
        lat = (self.model.next_level_latency(space_a)
               if self.model.sharing_evicted(space_a, space_b, array_bytes)
               else lvl.latency)
        return self._timed_chase(array_bytes, 64, lat, int(n_samples))

    def cu_sharing_probe(self, cu_a, cu_b, array_bytes, n_samples,
                         space="sL1d"):
        """Single §IV-H pair probe (grid path: ``eviction_many``)."""
        return self.eviction_many(
            [("cu", space, cu_a, cu_b, array_bytes)], n_samples)[0]

    def _evict_row_latency(self, req) -> tuple[float, int]:
        """(modeled post-warm probe latency, probe array bytes) of one row."""
        kind = req[0]
        if kind == "amount":
            _, space, core_a, core_b, ab = req
            evicted = self.model.amount_evicted(space, core_a, core_b, ab)
        elif kind == "sharing":
            _, space, space_b, ab = req
            evicted = self.model.sharing_evicted(space, space_b, ab)
        elif kind == "cu":
            _, space, cu_a, cu_b, ab = req
            evicted = self.model.cu_sharing_evicted(cu_a, cu_b, ab, space)
        else:
            raise ValueError(f"unknown eviction request kind: {kind!r}")
        lat = (self.model.next_level_latency(space) if evicted
               else self.model.level(space).latency)
        return lat, int(ab)

    def _evictor_perm(self, n: int) -> np.ndarray:
        """Evictor-side chase buffer: independent of the probe buffer of the
        same size (warm phase must walk a *conflicting* working set, never
        the probe array itself)."""
        perm = self._evictor_cache.get(n)
        if perm is None:
            perm = self._cycle(n)
            self._evictor_cache[n] = perm
        return perm

    def _stacked_evictors(self, slot_counts: list[int]) -> np.ndarray:
        """(R, bucket) padded evictor matrix for an eviction grid's rows."""
        bucket = _pow2_at_least(max(slot_counts))
        out = np.zeros((len(slot_counts), bucket), dtype=np.int32)
        for i, n in enumerate(slot_counts):
            out[i, :n] = self._evictor_perm(n)
        return out

    def _run_evict(self, perms, evictors, warm, probe) -> float:
        """One timed launch of the eviction grid kernel; wall seconds.
        Its arguments are device tensors already: nothing is copied in
        the timed window."""
        t0 = self._clock()
        ops.eviction_batch(perms, evictors, warm, probe)
        self._sync()
        self.kernel_calls += 1
        return (self._clock() - t0) * 1e-9

    def eviction_many(self, requests, n_samples):
        """Mixed §IV-F/G/H rows on ONE eviction-kernel grid per repetition.

        Each row executes the Fig. 3 pattern for real: a warm phase walks
        the row's evictor cycle once end-to-end (conflicting working set of
        the probe's footprint), then the timed probe phase walks the probe
        cycle with a chain length encoding the *modeled* post-warm hit
        level — evicted rows literally serialize more loads.  The
        calibration chain matches the full two-phase (rows x bucket,
        warm+probe steps) launch profile, exactly as in ``_timed_grid``.
        """
        self.eviction_grid_calls += 1
        self.eviction_grid_rows += len(requests)
        params = [self._evict_row_latency(r) for r in requests]
        lats = np.array([lat for lat, _ in params])
        slot_counts = [self._slots(ab, 64) for _, ab in params]
        perms = self._stacked_perms(slot_counts)
        evictors = self._stacked_evictors(slot_counts)
        # One full pass over the evictor cycle: the minimal walk that
        # touches the whole conflicting footprint (and ends back at slot 0).
        warm = np.asarray(slot_counts, dtype=np.int32)
        per_row = max(self.base_steps // max(len(requests), 1), 512)
        ms = np.maximum(np.ceil(per_row / np.maximum(lats, 1.0)), 1.0)
        probe = np.asarray(np.round(ms * lats), dtype=np.int32)
        perms_t, evictors_t, warm_t, probe_t = self._to_device(
            perms, evictors, warm, probe)
        req_args = (perms_t, evictors_t, warm_t, probe_t)
        shape_key = ("evict", perms.shape, evictors.shape)
        if shape_key not in self._warmed:
            self._run_evict(*req_args)
            self._warmed.add(shape_key)
        cal_perms_t, cal_evictors_t = self._to_device(
            self._cal_perms(perms.shape, "evict-probe"),
            self._cal_perms(evictors.shape, "evict-warm"))
        cal_args = (cal_perms_t, cal_evictors_t, warm_t, probe_t)
        cal_a = self._run_evict(*cal_args)
        half = max(int(n_samples) // 2, 1)
        walls = [self._run_evict(*req_args) for _ in range(half)]
        cal_b = self._run_evict(*cal_args)
        walls += [self._run_evict(*req_args)
                  for _ in range(int(n_samples) - half)]
        cal_c = self._run_evict(*cal_args)
        cal = float(np.median([cal_a, cal_b, cal_c]))
        self._log_calibration("evict", slot_counts, perms.shape[1],
                              np.median(walls) / cal,
                              walls + [cal_a, cal_b, cal_c])
        return lats[:, None] * (np.asarray(walls)[None, :] / cal)

    # ---------------------------------------------------------- bandwidth
    def bandwidth(self, space, mode="read"):
        """Stream-kernel bandwidth: bytes moved over best-of-reps wall time.

        At the default 2 MiB the data sits in the card's L2 and a launch
        lasts microseconds, so the number characterizes one launch of this
        call, not HBM bandwidth.
        """
        del space  # one path to device memory
        n = self.bandwidth_bytes // 4
        block = min(64 * KIB, n)
        n = (n // block) * block
        x = torch.arange(n, dtype=torch.float32, device=self.device)
        if mode == "read":
            def fn():
                return ops.stream_read(x, block=block)
        else:
            def fn():
                return ops.stream_write(x, block=block)
        fn()
        self._sync()
        best = np.inf
        for _ in range(self.cold_reps):
            t0 = self._clock()
            fn()
            self._sync()
            best = min(best, self._clock() - t0)
            self.kernel_calls += 1
        moved = n * 4 * (2 if mode == "write" else 1)
        return moved / (best * 1e-9)

    # ------------------------------------------------------------- hooks
    def api_size(self, space: str) -> int | None:
        try:
            return self.model.level(space).size
        except KeyError:
            return None

    def cu_ids(self) -> list[int]:
        return sorted(cu for grp in self.model.cu_share_groups for cu in grp)

    @property
    def cores_per_sm(self) -> int:
        return self.model.cores_per_sm

    def ground_truth(self) -> dict[str, dict]:
        return self.model.ground_truth()
