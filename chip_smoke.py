"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which stops the run on failure (no fallback to the CPU or
to a plain version):

1. build   — ``nvcc`` builds ``src/repro_torch/kernels/csrc/*.cu`` (the
             chase, stream, the two flash-attention and the WKV6
             sources, one compiler each, all at once) into
             ``build/kernels/``; prints
             each source's compile time and ptxas's registers and spills,
             and checks that every instantiation of both attention
             sources (up to head dim 256 and past it) spills nothing, that
             the SASS of each tensor-core one holds wgmma (HGMMA) and TMA
             loads and that of each CUDA-core one 128-bit shared loads
             (LDS.128) and asynchronous copies (LDGSTS), with the FFMAs per
             shared load of its innermost loops printed (at least 4 in
             each; past 256 at least 8 in each loop but the Q K^T one), and
             that every instantiation of the two WKV6 kernels spills
             nothing (their registers printed);
2. kernels — first the floor: ``chase_floor`` (one thread, dependent
             loads with nothing else on the chain) at footprints from 4 KiB
             to 256 MiB, with ``nvidia-smi``'s SM clock and power beside
             it, which gives each level's ns and cycles a load and the L1
             capacity a kernel without shared memory gets; then what sits
             between one load of a chain and the next in the SASS of the
             chase kernels and the floor; then each probe kernel, at the
             shapes discovery gives it, against its plain PyTorch version
             on the card (bit-exact for the chase and eviction kernels, also
             at chain lengths 7 and 6143, which straddle their unroll of 8,
             and cursor -1 for rows that load a value outside [0, N); exact
             for the write kernel; rtol 1e-5 for the read kernel, whose
             summation order differs, at 2 MiB and at blocks of 1001), with
             CUDA-event times and device times from ``torch.profiler`` (the
             calls' device events told apart by marker kernels, not by the
             host's clock); the chase rows' ns and cycles a load beside the
             floor and their latency bound (steps times the floor of the
             level their footprint lives in); for the stream kernels
             ``torch.sum`` and ``torch.add`` and the median host time of
             one call;
3. discover — ``discover_cuda`` twice on the card, each on a fresh runner
             and read around its own run: dense and unfused
             (``budget=None, fuse=False``), its discrete attributes held
             to ``make_cuda_model().ground_truth()`` and its launches to
             876, 13, 8 and 8; then the default, planned and fused, held
             to the same ground truth (a measured miss gets one retry,
             printed as such; two misses fail) and to fewer
             ``pchase_batch`` launches than the dense run.  For each:
             wall, launches, ``kernel_calls``, probe rows, fusion rounds
             and rows a fused dispatch, per-family seconds, and per family
             label (fused loops under the ``+``-joined families of their
             rows) the runner's request/calibration wall ratios, the rows
             whose two footprints straddle the L1 capacity and the timed
             launches' and chase buffers' seconds;
3b. service — the port's ``TopologyHTTPServer`` on 127.0.0.1:0 over a
             ``TopologyStore`` in a temporary directory and its
             ``JobEngine``: ``{"backend": "cuda"}`` submitted through
             ``TopologyClient`` (each job's client wall printed beside its
             time on the server, ``finished_at - started_at``),
             ``L1.size``, ``L1.line_size`` and
             ``L2.fetch_granularity`` queried over HTTP and held to ground
             truth (one measured retry), the same request served from the
             store with no launch, ``refresh: true`` measuring again, and
             the server and its workers stopped;
3c. resilience — on phase 3's warmed runner, ``discover_cuda`` (planned,
             fused) over a ``ChaosRunner`` under ``Resilience(max_retries=3)``:
             value-preserving transient faults on single probes and batched
             calls, retried to the same ground truth (one retry on a
             measured miss) with retries >= 1 and nothing degraded; a
             permanent fault on the bandwidth family, which alone degrades
             (``L2`` and ``DeviceMemory`` ``read_bw`` unknown, the stream
             kernels never launched) while every other discrete attribute
             stays at ground truth; the dense, unfused run with
             ``parallel=ParallelConfig(workers=2)``, inline (no worker
             spawned, 876/13/8/8 launches); ``discover_sim`` pooled
             (two spawned workers) and inline on the host cores, bit-equal
             with no respawn, in a child process that never imports torch;
             and a resilient ``discover_sim`` killed after 40 probe calls
             and resumed from its checkpoint in a temporary
             ``TopologyStore``, with no persisted row probed again.  Each
             card run prints faults, retries, degraded families, launches
             and wall beside the clean planned run's;
3d. host    — the host chase (``core/probes/csrc/host_chase.c``) built by
             the host C compiler into ``build/host/`` (compiler, flags and
             seconds printed); ``discover_host()`` at its defaults (128 MiB,
             9 samples, quick) on this machine's CPU through a
             ``TopologyStore``: wall, per-family seconds, the host-cache
             size and the bytes its rows touched (4 size / 4096), both
             latencies and both bandwidths beside the CPU's model and
             caches (``lscpu``, sysfs or ``getconf``; printed, not
             compared); both
             elements present, the DRAM latency above the host-cache one
             (measured again on an inversion, up to five runs, as the
             reference's test of that order), both bandwidths positive, and its
             repeat a store hit with no chase call; ``{"backend": "host",
             "max_bytes": 8 MiB}`` over ``TopologyHTTPServer``, with the
             direct run's attributes, and its repeat from the store;
             ``find_link_adjacency`` on ``SimPod`` 4x4 and 4x8 held to the
             torus's links; ``measure_collective`` for each op at axis
             sizes 1 and 4, held to the analytic models (one card: no live
             path);
4. llm kernels — ``ops.mha`` (the tensor-core kernels for bf16 at head
             dims 16, 32, 64, 80, 96, 100, 128 and 256, the CUDA-core ones
             for f32 at 3, 16, 64, 78, 80, 128 and 256, causal and full,
             and at the f32 smoke run's own prefill; past 256 both sources'
             wide kernels at head dims 300 (a padded row in bf16), 320,
             384, 512 and 640 (two column slices), causal, and 320 and 512
             full), ``ops.wkv6``
             (its two kernels, at T 512, T 500, the model's strong decays,
             K 64 with V 32, the reference's chunk 64, and split into
             slices of at most 128 at K = V = 192 and K 160 with V 96) and
             ``ops.pchase`` at the shapes the serve phase gives them (and
             attention at head dim 256 also at paligemma-3b's head layout,
             and at the served moe, hybrid and audio models' heads: 32 on 4
             at d 128, 32 on 32 at d 80, 32 on 32 at d 64); the prefix-LM
             mask (``prefix_len``) at paligemma-3b's served prefill (8 on 1
             at d 256, S 768, P 256), at P = S, at P inside a kv tile (S 448
             P 200; d 64 P 192), on a ragged prompt (S 500, P 100), and in
             f32 at the vlm smoke config's prefill (4 on 1 and 4 on 4 at
             d 16, S 108, P 8) and at d 64 (P 256), each also counted by
             prefix where its kernel launches, with SDPA under the
             equivalent boolean mask as the yardstick,
             against their plain versions (tolerances at each check; the
             tensor-core kernel also against the plain emulation of its own
             numerics), with CUDA-event times, device times (both attention
             kernels and ``scaled_dot_product_attention`` beside them, the
             f32 kernel's SM clock while it runs), bounds and, for
             attention, ``scaled_dot_product_attention`` as the library
             yardstick;
5. serve   — ``repro_torch.launch.serve.main`` at full width and depth in
             bfloat16 for qwen3-14b (dense), rwkv6-3b (ssm),
             qwen3-moe-30b-a3b (moe, 30.5 B parameters, after the others
             are freed), zamba2-2.7b (hybrid), musicgen-large (audio, 4
             codebooks a position, 16 new frames of 4 ids) and
             paligemma-3b (vlm, 256 patches ahead of each prompt, every
             ``mha`` with the patches as the prefix, max_len 784) (8
             requests of 512 tokens, 16 new tokens each, 4 slots): the
             launch counts read
             around each call alone (one ``mha`` or ``wkv6`` per layer and
             wave, zamba2's one ``mha`` per site of its shared block; every
             ``mha`` a launch of the tensor-core kernel at the model's head
             dim, 128 or zamba2's 80, and none at another head dim or of
             the CUDA-core kernel, counted by head dim where each kernel
             launches), 16 tokens a request, finite logits, equal greedy
             tokens from a second, warm run of one wave; that warm wave's
             prefill and decode split, and a third run of it under
             ``torch.profiler`` for the device-busy time and idle share of
             each (the device's events split into the prefill's and each
             decode step's at a marker kernel queued after each sampling,
             in the order the device ran them; the prefill must show the
             tensor-core attention kernel once a layer or site, rwkv6-3b's
             each WKV6 kernel once a layer, a profiled wave that falls short
             of its parts or of those counts is run again, up to three, and
             each prints their device time there); for the moe model a
             profiled prefill and decode step with the moe FFN's parts
             (routing, dispatch, expert GEMMs, combine) split at markers,
             their device time and shares, and the pairs layer 0 drops by
             capacity; then the six smoke configs in f32 on the card
             (where the CUDA-core attention kernel runs, at head dim 16 on
             its d 32 instantiation, with a prefix of 8 for the vlm one)
             against the same weights on the CPU;
6. train   — training through ``repro_torch.train`` (``forward``,
             ``train_loss``, AdamW, ``train_loop``) and ``repro_torch.data``,
             which take the reference's plain attention and WKV, never a
             kernel: an ``ops.mha`` call on an input that requires grad is
             refused, and no ``mha`` or ``wkv6`` launches over the phase.
             The six smoke configs in f32 (TF32 off) on the card against
             the CPU from the same weights and ``SyntheticLM`` batch
             (2 x 64 tokens a microbatch): ``train_loss`` within 1e-4
             relative, every gradient leaf within 1e-3 of its largest
             |value|, three ``train_loop`` steps' losses within 1e-4; then
             internlm2-1.8b at full width and depth (1.889 B parameters,
             bf16 with a float32 master) with the reference launcher's
             data and optimizer: ``ByteCorpus`` batches of 8 x 512 tokens
             in 2 microbatches, ``remat="full"``, AdamW lr 1e-3, warmup 2,
             8 steps, printing the parameters, the peak memory, each
             step's loss, grad norm and wall (the first apart), tokens/s
             over steps 2-8, and one more warm step under
             ``torch.profiler`` (device busy, idle share, top device
             operations); every loss finite, the last below the first, the
             peak under 80 GB;
7. checkpoint — ``checkpoint/``, ``ft/`` and the launchers at full size,
             under a temporary directory that the phase removes (free disk
             and host memory printed first; each must hold twice the
             state, else the run fails): ``repro_torch.launch.train.main``
             on internlm2-1.8b (``--steps 50 --seq 64 --global-batch 8
             --remat full``; the launcher's ``ckpt_every=50`` saves step
             50), printing the save's host snapshot and write seconds, the
             bytes on disk and GB/s, the supervisor's host copy of the
             initial state and the peak memory; step 50 restored into a
             fresh ``init_train_state`` on the card, every leaf equal to
             the run's final state bit for bit (restore seconds printed),
             and ``--steps 52 --resume`` from it with finite losses;
             ``repro_torch.launch.serve.main --ckpt-dir`` at the serve
             phase's settings, twice, and without it: 48 ``mha`` launches
             each (the tensor-core kernel at d 128, counted around each
             run), equal greedy tokens from the checkpoint and others from
             the seed-0 weights; the ``Supervisor`` on the float32
             internlm2-1.8b-smoke (``ckpt_every=4``, 10 steps) with a
             failure at step 6 ("restart from step 4") and at step 2
             ("restart from scratch (no checkpoint)"), the final params
             held to an uninterrupted run bit for bit, or else within
             ``FT_TOL`` and bit for bit under
             ``torch.use_deterministic_algorithms``.  ``launch.train``
             runs on its one-card mesh (``--mesh 1x1``, the default),
             ``launch.serve`` without a mesh (its default);
8. mesh    — ``sharding/`` and ``launch/mesh.py`` on a one-card ``nccl``
             ``DeviceMesh`` (meshes of more ranks run only on the CPU, in
             ``tests/test_torch_elastic.py``; the run says so): 8a
             ``launch.train --mesh 1x1`` on internlm2-1.8b at phase 7's
             settings for 6 steps, its state DTensors, against the plain
             ``train_loop`` on the same seed, configuration and batches
             (the losses bit for bit or within ``MESH_LOSS_TOL``, the
             difference printed; each warm step's wall, device busy time
             and idle share, one step of each profiled); 8b the mesh
             state saved and restored by ``restore(shardings=...)`` onto
             a fresh 1x1 mesh, every leaf a DTensor there and equal bit
             for bit; 8c ``launch.serve --mesh 1x1`` at the serve phase's
             settings, its parameters DTensors, 48 ``mha`` launches on the
             local shards (the tensor-core kernel at d 128) and greedy
             tokens equal to the plain engine's on the same weights; 8d every full-size
             arch's specs on the production (16, 16) mesh under both rule
             sets;
9. ep      — expert parallelism (``models/moe_ep.py``) on the one-card
             ``nccl`` mesh, where the expert axis is a group of one and
             every all-to-all an exchange with itself: 9a qwen3-moe-30b-a3b
             at full size in bf16, its parameters DTensors laid out by
             ``SERVE_RULES`` (as ``launch.serve --mesh 1x1``), a prefill of
             4 x 512 and 15 greedy decode steps through ``Model.prefill``
             and ``decode_step`` with ``Runtime(moe_impl="ep")`` and with
             ``Runtime()`` under ``activation_sharding``: at the config's
             capacity factor the pairs each drops, finite logits, equal
             greedy tokens on a rerun, wall, and over the prefill and
             ``EP_PROFILE_STEPS`` decode steps the device busy time, idle
             share and the collective kernels' device time (a profile of
             all 15 steps collects ~1.3 x 10^5 device events, about half
             a minute each), 48 ``mha`` launches of
             the tensor-core kernel; then at the smallest factor of 2, 4, 8
             where neither drops a pair, the EP logits within
             ``EP_LOGIT_TOL`` of the sorted dispatch's; 9b the same config
             at full width with its depth cut to ``EP_TRAIN["layers"]``
             layers, 3 train steps of 8 x 64 uniform random tokens (state
             DTensors by ``TRAIN_RULES``) with moe_impl "ep" and remat
             "save_a2a", "ep" with "full" and the sorted dispatch with
             "full", at the smallest factor where neither path drops a
             pair in the first batch (none may drop in any step): the
             first step's loss within ``EP_LOSS_TOL`` and its gradient
             norm within ``EP_GRAD_NORM_TOL`` of the sorted dispatch's,
             each variant's peak memory and warm step.

The ``[smoke] all phases passed`` line gives the wall time of phases 1-9
and of phases 7, 8 and 9 alone.

The last two lines of standard output are the kernels summary and the
device line, each one JSON object.  Exits non-zero without them when there
is no CUDA device or the port's sources are missing.
"""
import functools
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12           # H100 SXM scalar float32 rate (data sheet)
BF16_OPS_PER_S = 989e12          # H100 SXM dense bf16 tensor rate (data sheet)
STEPS = 6144                     # CudaRunner's default base_steps
BW_BYTES = 1 << 21               # CudaRunner's default bandwidth_bytes
BLOCK = 64 * 1024                # the stream probe's block
REPS = 20                        # CUDA-event repetitions per timing


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def event_ms(fn, reps: int = REPS) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


PROFILER_SESSIONS = 5             # tries at a whole profiler session
SESSIONS = {"whole": 0, "retaken": 0}   # device_ms's sessions in this run
MARK_CYCLES = 1000                # the marker kernel's spin
LEAD_IN = 2                       # markers that open a session
LEAD_IN_CYCLES = 2_000_000        # the spin that opens a session, ~1 ms


def mark() -> None:
    """Queue the marker kernel (``torch.cuda._sleep``) on the current
    stream.  The device events of a ``torch.profiler`` session are split at
    the marker's, in the order the device started them, so no split
    depends on where the profiler places device events on the host's clock
    (in some sessions all of them fell into the first span)."""
    torch.cuda._sleep(MARK_CYCLES)


def lead_in() -> None:
    """Open a profiler session: one long spin of the marker kernel, waited
    for, then ``LEAD_IN`` markers.  A session's first device events are at
    times missing from the profile (the first eight kernels of the moe
    routing, in every session, when the markers alone opened it), so
    nothing that is measured runs in its first millisecond."""
    torch.cuda._sleep(LEAD_IN_CYCLES)
    torch.cuda.synchronize()
    for _ in range(LEAD_IN):
        mark()


def _device_events(prof) -> list:
    """(name, microseconds) of each kernel, copy and set the device ran in
    ``prof``'s session, in the order it started them."""
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.is_user_annotation),
                    key=lambda e: e.time_range.start)
    return [(e.name, e.time_range.elapsed_us()) for e in events]


_MARKER = []                      # the marker kernel's name, once seen


def _marker_name() -> str:
    """The name the profiler gives the marker kernel, from a session that
    runs it alone (``LEAD_IN`` times, of which one may go unrecorded)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILER_SESSIONS):
        if _MARKER:
            break
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(LEAD_IN):
                mark()
            torch.cuda.synchronize()
        names = [name for name, _ in _device_events(prof)]
        if names and len(set(names)) == 1:
            _MARKER.append(names[0])
        else:
            print(f"[device_ms] the marker alone gave device events {names}")
    check(_MARKER, "device_ms: no session showed the marker kernel alone")
    return _MARKER[0]


def split_at_marks(events: list, marker: str) -> list:
    """The device events between the marker's: one list more than there are
    markers."""
    parts = [[]]
    for name, us in events:
        if name == marker:
            parts.append([])
        else:
            parts[-1].append((name, us))
    return parts


def marked_parts(events: list, marker: str, n: int) -> list | None:
    """The last ``n`` parts between markers of a session that opened with
    ``LEAD_IN`` markers and closed with one, or None when the session does
    not hold them whole: fewer parts, or device work before them or after
    the last marker.  The session's first device event is at times missing
    from the profile, so it opens with markers that are not counted."""
    parts = split_at_marks(events, marker)
    if len(parts) < n + 1 or parts[-1] or any(parts[:-n - 1]):
        return None
    return parts[-n - 1:-1]


def device_ms(fns: dict, reps: int = REPS) -> dict:
    """Device time of one call of each function of ``fns``, which maps a
    label to ``(fn, events)``: the sum of the kernels and copies
    ``torch.profiler`` sees the device run for ``reps`` calls (after a
    warm-up), over ``reps``.  Host overhead between launches is left out.
    In one session each label runs one call and then ``reps`` calls, each
    part closed by the marker kernel.  The one call shows the device events
    a call makes, which must number ``events`` where that is given (a kernel
    of the port: one launch); the ``reps`` calls must hold each of them
    ``reps`` times and nothing else, and nothing may run outside the
    marked parts.  A session that falls short of that is printed and yields
    no time; the next of ``PROFILER_SESSIONS`` sessions is taken instead,
    and the run fails when none is whole."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    for fn, _ in fns.values():
        fn()
    torch.cuda.synchronize()
    marker = _marker_name()
    for attempt in range(1, PROFILER_SESSIONS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            lead_in()
            for fn, _ in fns.values():
                fn()
                mark()
                for _ in range(reps):
                    fn()
                mark()
            torch.cuda.synchronize()
        events, faults = _device_events(prof), []
        parts = marked_parts(events, marker, 2 * len(fns))
        if parts is None:
            faults.append("parts between markers " + str(
                [len(part) for part in split_at_marks(events, marker)]))
            parts = [[]] * (2 * len(fns))
        for i, (label, (_, events_per_call)) in enumerate(fns.items()):
            one, timed = parts[2 * i], parts[2 * i + 1]
            per_call = Counter(name for name, _ in one)
            want = Counter({name: n * reps for name, n in per_call.items()})
            if (not one or (events_per_call is not None
                            and len(one) != events_per_call)
                    or Counter(name for name, _ in timed) != want):
                faults.append(
                    f"{label}: one call "
                    f"{dict(Counter(name[:60] for name, _ in one))}, "
                    f"{reps} calls "
                    f"{dict(Counter(name[:60] for name, _ in timed))}, "
                    f"expected {events_per_call or 'as one call'} a call")
        if not faults:
            SESSIONS["whole"] += 1
            return {label: sum(us for _, us in parts[2 * i + 1]) / reps / 1e3
                    for i, label in enumerate(fns)}
        SESSIONS["retaken"] += 1
        print(f"[device_ms] profiler session {attempt} of "
              f"{PROFILER_SESSIONS} not whole, no time taken from it: "
              + "; ".join(faults))
    raise SmokeFailure(f"device_ms: no whole profiler session in "
                       f"{PROFILER_SESSIONS}")


HOST_CALLS = 1000                # host-only calls per timing


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Median host time of one call of ``fn``, in microseconds, over
    ``calls`` calls each timed with ``perf_counter_ns`` (launches queue on
    the device meanwhile; it is synchronised after the last)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter_ns()
        fn()
        times.append(time.perf_counter_ns() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) / 1e3


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    """The least time for the work: bytes over the memory rate or
    operations over the peak rate of the inputs' type (scalar f32 unless
    given), whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# The latency floor: what one dependent load costs at each cache level
# --------------------------------------------------------------------------
KIB, MIB = 1 << 10, 1 << 20
# Footprints at which ``chase_floor`` times dependent loads: two that sit in
# any L1, a sweep that finds the L1 capacity a kernel without shared memory
# gets (at most the SM's 256 KB), two in L2 and one far past it.
LEVEL_FOOTPRINTS = {"L1": (4 * KIB, 64 * KIB), "L2": (2 * MIB, 32 * MIB),
                    "HBM": (256 * MIB,)}
L1_SWEEP = tuple(k * KIB for k in (128, 160, 192, 208, 216, 224, 232, 240,
                                   256, 320))
FLOOR_ROUNDS = 64                # x FLOOR_UNROLL = 16384 timed loads a launch
FLOOR_LAUNCHES = 3               # the median of these is the floor
FLOOR_SLOTS = 1 << 18            # most slots on a floor's chain
L1_KNEE = 1.25                   # L1-resident: within this of the 4 KiB floor
SMI_SAMPLE = ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
              "--format=csv,noheader"]


def floor_chain(footprint: int, rng,
                stride: int | None = None) -> tuple[np.ndarray, int]:
    """A single cycle over ``footprint`` bytes for ``chase_floor``: slots
    ``stride`` bytes apart (by default one line, 128 B, wider where that
    would pass ``FLOOR_SLOTS``), in a random order from slot 0.  Returns the
    (footprint / 4,) int32 chain and the slots on its cycle."""
    from repro_torch.core.probes.runners import random_cycle

    stride = stride or max(128, footprint // FLOOR_SLOTS)
    slots, step = footprint // stride, stride // 4
    chain = np.zeros(footprint // 4, dtype=np.int32)
    chain[np.arange(slots) * step] = random_cycle(slots, rng) * step
    return chain, slots


def smi_beside(fn) -> dict:
    """``nvidia-smi``'s SM clock (MHz), power draw and limit (W), read while
    ``fn`` runs again and again on the card."""
    proc = subprocess.Popen(SMI_SAMPLE, stdout=subprocess.PIPE, text=True)
    while proc.poll() is None:
        fn()
        torch.cuda.synchronize()
    clock, draw, limit = (float(x.split()[0]) for x in
                          proc.stdout.read().strip().split(","))
    return {"clocks_sm_mhz": clock, "power_draw_w": draw,
            "power_limit_w": limit}


def level_of(footprints, l1_bytes: int, l2_bytes: int) -> list[str]:
    """The level each row of one launch lives in: L1 when the row alone fits
    an SM's L1 (each row runs on an SM of its own), else L2 when the rows
    past L1 fit the L2 together, else HBM."""
    fp = [int(f) for f in footprints]
    spilled = sum(f for f in fp if f > l1_bytes)
    outer = "L2" if spilled <= l2_bytes else "HBM"
    return ["L1" if f <= l1_bytes else outer for f in fp]


def latency_bound_ms(steps, footprints, floors: dict, l1_bytes: int,
                     l2_bytes: int) -> tuple[float, str]:
    """The least time of one launch of chase rows: each row's steps times
    the floor (ns a load) of the level its footprint lives in, and the
    launch as long as its longest row.  Returns ms and that row's level."""
    levels = level_of(footprints, l1_bytes, l2_bytes)
    ns = [int(s) * floors[lv] for s, lv in zip(steps, levels)]
    worst = int(np.argmax(ns))
    return ns[worst] / 1e6, levels[worst]


def eviction_bound_ms(warm, probe, evictor_bytes, probe_bytes, floors: dict,
                      l1_bytes: int, l2_bytes: int) -> tuple[float, str]:
    """The least time of one launch of eviction rows: each row's warm steps
    at the level of its evictor and its probe steps at the level of its
    probe row (each phase's rows placed as ``level_of`` places them), the
    launch as long as its longest row.  Returns ms and that row's levels."""
    warm_lv = level_of(evictor_bytes, l1_bytes, l2_bytes)
    probe_lv = level_of(probe_bytes, l1_bytes, l2_bytes)
    ns = [int(w) * floors[a] + int(p) * floors[b]
          for w, p, a, b in zip(warm, probe, warm_lv, probe_lv)]
    worst = int(np.argmax(ns))
    return ns[worst] / 1e6, f"{warm_lv[worst]}+{probe_lv[worst]}"


def floor_table(rng) -> dict:
    """``chase_floor`` at every footprint of ``LEVEL_FOOTPRINTS`` and
    ``L1_SWEEP`` (the median of ``FLOOR_LAUNCHES`` launches of each variant,
    ``nvidia-smi`` read beside the plain one).  Returns the floor of each
    level (ns a load, the least of its footprints' plain floors), the L1
    capacity (the largest footprint whose floor stays within ``L1_KNEE`` of
    the 4 KiB one), the L2 capacity (the card's), the table and the floor of
    a cold 4 KiB row of discovery's 4-byte slots."""
    from repro_torch.kernels.pchase_probe import (FLOOR_UNROLL,
                                                  FLOOR_VARIANTS, chase_floor)

    footprints = sorted({f for fps in LEVEL_FOOTPRINTS.values() for f in fps}
                        | set(L1_SWEEP))
    table = {}
    print("[floor] footprint: per load, by what sits on the chain besides "
          "the load (" + ", ".join(FLOOR_VARIANTS) + "): ns (SM cycles); "
          "SM GHz from clock64 over %globaltimer; nvidia-smi beside")
    for fp in footprints:
        chain, slots = floor_chain(fp, rng)
        c_t = torch.from_numpy(chain).cuda()
        row = {}
        for variant in FLOOR_VARIANTS:
            runs = [chase_floor(c_t, warm=slots, rounds=FLOOR_ROUNDS,
                                variant=variant)
                    for _ in range(FLOOR_LAUNCHES)]
            row[variant] = {key: statistics.median(r[key] for r in runs)
                            for key in ("ns", "cycles", "ghz")}
        row["smi"] = smi_beside(lambda: chase_floor(
            c_t, warm=slots, rounds=FLOOR_ROUNDS))
        table[fp] = row
        print(f"[floor] {fp / KIB:9.0f} KiB ({slots} slots): " + "; ".join(
            f"{v} {row[v]['ns']:.3f} ns ({row[v]['cycles']:.2f} cyc)"
            for v in FLOOR_VARIANTS)
            + f"; {row['load']['ghz']:.4f} GHz; smi "
            f"{row['smi']['clocks_sm_mhz']:.0f} MHz, "
            f"{row['smi']['power_draw_w']:.2f} W of "
            f"{row['smi']['power_limit_w']:.2f} W")
        del c_t
    base = table[min(footprints)]["load"]["ns"]
    l1_bytes = max(fp for fp in footprints
                   if all(table[f]["load"]["ns"] <= L1_KNEE * base
                          for f in footprints if f <= fp))
    over = min(fp for fp in footprints if fp > l1_bytes)
    l2_bytes = torch.cuda.get_device_properties(0).L2_cache_size
    floors = {lv: min(table[fp]["load"]["ns"] for fp in fps)
              for lv, fps in LEVEL_FOOTPRINTS.items()}
    cycles = {lv: min(table[fp]["load"]["cycles"] for fp in fps)
              for lv, fps in LEVEL_FOOTPRINTS.items()}
    # the chase rows' own start: a 4 KiB row of discovery's dense slots, 4 B
    # apart, walked STEPS loads from a cold L1 (no warm pass), as each
    # launch of a chase kernel finds it
    chain, _ = floor_chain(4 * KIB, rng, stride=4)
    c_t = torch.from_numpy(chain).cuda()
    runs = [chase_floor(c_t, warm=0, rounds=STEPS // FLOOR_UNROLL)
            for _ in range(FLOOR_LAUNCHES)]
    cold = {key: statistics.median(r[key] for r in runs)
            for key in ("ns", "cycles")}
    print(f"[floor] 4 KiB of 4-byte slots, {STEPS} loads from a cold L1: "
          f"{cold['ns']:.3f} ns ({cold['cycles']:.2f} cyc) a load")
    check(l1_bytes < 2 * MIB and floors["L1"] < floors["L2"]
          and floors["L1"] < floors["HBM"],
          f"floor: levels not told apart: {floors}, L1 {l1_bytes}")
    print(f"[floor] L1 capacity {l1_bytes / KIB:.0f} KiB (floor "
          f"{table[l1_bytes]['load']['ns']:.3f} ns just under; "
          f"{table[over]['load']['ns']:.3f} ns at {over / KIB:.0f} KiB, just "
          f"over); L2 {l2_bytes / MIB:.0f} MiB (the card's); floors a load: "
          + ", ".join(f"{lv} {floors[lv]:.3f} ns ({cycles[lv]:.2f} cyc)"
                      for lv in floors))
    return {"floors": floors, "cycles": cycles, "l1_bytes": l1_bytes,
            "l2_bytes": l2_bytes, "table": table, "cold": cold}


def _instructions(sass: str) -> list[tuple]:
    """(address, guard predicate or "", opcode, operands) of each
    instruction of one function's SASS."""
    out = []
    for addr, text in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;", sass):
        guard = ""
        if text.startswith("@"):
            guard, text = text.split(None, 1)
        op, _, rest = text.partition(" ")
        operands = [x.strip() for x in rest.split(",")] if rest.strip() else []
        out.append((int(addr, 16), guard, op, operands))
    return out


_NO_DEST = ("ST", "BRA", "EXIT", "BSYNC", "BSSY", "NOP", "RED", "WARPSYNC",
            "BAR", "CALL", "RET", "MEMBAR", "FENCE", "CCTL", "ERRBAR", "YIELD")


def _regs(operand: str, pair: bool = False) -> set:
    """The registers an operand names (a 64-bit one as its pair)."""
    regs = set()
    for name, num, wide in re.findall(r"\b(U?R|U?P)(\d+)(\.64)?", operand):
        regs.add(f"{name}{num}")
        if (wide or pair) and name.endswith("R"):
            regs.add(f"{name}{int(num) + 1}")
    return regs


def _reads_writes(guard: str, op: str, operands: list) -> tuple[set, set]:
    wide = ".WIDE" in op or op.endswith(".64") or op == "CS2R"
    reads = _regs(guard)
    if op.startswith(_NO_DEST) or not operands:
        for x in operands:
            reads |= _regs(x)
        return reads, set()
    writes = _regs(operands[0], pair=wide)
    srcs = operands[1:]
    if srcs and re.fullmatch(r"!?P\d|PT", srcs[0]):
        writes |= _regs(srcs[0])            # a second predicate or carry out
        srcs = srcs[1:]
    for i, x in enumerate(srcs):
        reads |= _regs(x, pair=wide and i == len(srcs) - 1 and "IMAD" in op)
    return reads, writes


def load_chains(sass: str) -> list[tuple]:
    """For each load (LDG) whose value forms the address of a later load,
    the instructions between the two that depend on the first: their
    opcodes, in order, following a loop's back branch once."""
    ins = _instructions(sass)
    index = {addr: i for i, (addr, *_) in enumerate(ins)}
    loops = [(index.get(int(m[1], 16)), i)
             for i, (_, _, op, operands) in enumerate(ins)
             if op.startswith("BRA") and operands
             and (m := re.match(r"(0x[0-9a-f]+)", operands[0]))
             and int(m[1], 16) < ins[i][0]]
    chains = []
    for i, (_, guard, op, operands) in enumerate(ins):
        if not op.startswith("LDG"):
            continue
        tainted = _reads_writes(guard, op, operands)[1]
        on_chain, j, wrapped = [], i + 1, False
        for _ in range(400):
            if j >= len(ins) or ins[j][2].startswith("EXIT"):
                break
            g, o, args = ins[j][1:]
            reads, writes = _reads_writes(g, o, args)
            if o.startswith("LDG"):
                if reads & tainted:
                    chains.append(tuple(on_chain))
                    break
                tainted -= writes
            elif reads & tainted:
                on_chain.append(o)
                tainted |= writes
            else:
                tainted -= writes
            back = [top for top, end in loops
                    if end == j and top is not None and top <= i]
            if back and not wrapped:
                j, wrapped = back[0], True
            else:
                j += 1
    return chains


@functools.lru_cache(maxsize=None)
def _sass(lib_path) -> str:
    """``cuobjdump -sass`` of the library, once a run."""
    from torch.utils.cpp_extension import CUDA_HOME

    return subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", str(lib_path)],
        capture_output=True, text=True, check=True).stdout


def sass_chains(lib_path, kernels) -> dict:
    """``load_chains`` of each function of the library whose name holds one
    of ``kernels``, counted: {function: Counter(chain -> loads)}."""
    from collections import Counter

    found = {}
    for part in _sass(lib_path).split("Function : ")[1:]:
        name = part.splitlines()[0].strip()
        label = next((k for k in kernels if k in name), None)
        if label is not None:
            variant = re.search(r"ILi(\d+)E", name)
            key = label + (f"<{variant[1]}>" if variant else "")
            found[key] = Counter(load_chains(part))
    return found


# --------------------------------------------------------------------------
# Phase 1: build
# --------------------------------------------------------------------------
def _sass_counts(lib_path, kernel: str) -> dict:
    """Tensor-core (HGMMA), TMA-load (UTMALDG), asynchronous-copy (LDGSTS)
    and shared-load (LDS, of which 128-bit LDS.128) instructions in the
    SASS of the library's functions whose name contains ``kernel``."""
    counts = {"functions": 0, "HGMMA": 0, "UTMALDG": 0, "LDGSTS": 0,
              "LDS": 0, "LDS.128": 0}
    for part in _sass(lib_path).split("Function : ")[1:]:
        if kernel in part.splitlines()[0]:
            counts["functions"] += 1
            for _, _, op, _ in _instructions(part):
                for key in ("HGMMA", "UTMALDG", "LDGSTS"):
                    counts[key] += op.startswith(key)
                if op.startswith("LDS"):
                    counts["LDS"] += 1
                    counts["LDS.128"] += op.endswith(".128")
    return counts


def inner_loops(lib_path, kernel: str) -> list[dict]:
    """The innermost loops (a backward branch with no other inside it) of
    the one function whose name contains ``kernel`` that hold FFMAs: their
    instructions, FFMAs and shared loads, and FFMAs per shared load."""
    parts = [part for part in _sass(lib_path).split("Function : ")[1:]
             if kernel in part.splitlines()[0]]
    check(len(parts) == 1, f"{kernel}: {len(parts)} functions in the SASS")
    ins = _instructions(parts[0])
    index = {addr: i for i, (addr, *_) in enumerate(ins)}
    loops = [(index[int(m[1], 16)], i)
             for i, (_, _, op, operands) in enumerate(ins)
             if op.startswith("BRA") and operands
             and (m := re.match(r"(0x[0-9a-f]+)", operands[0]))
             and int(m[1], 16) < ins[i][0] and int(m[1], 16) in index]
    found = []
    for top, end in loops:
        if any(top <= t2 and e2 < end for t2, e2 in loops
               if (t2, e2) != (top, end)):
            continue                                # holds another loop
        ops = [op for _, _, op, _ in ins[top:end + 1]]
        ffma = sum(op.startswith("FFMA") for op in ops)
        lds = sum(op.startswith("LDS") for op in ops)
        if ffma:
            found.append({"instructions": len(ops), "FFMA": ffma, "LDS": lds,
                          "FFMA_per_LDS": round(ffma / max(lds, 1), 2)})
    return found


def _ptxas_functions(log: str) -> dict:
    """Registers and spill bytes of each entry function, from ptxas -v."""
    funcs, name = {}, None
    for line in log.splitlines():
        found = re.search(r"(?:Compiling entry function '|Function "
                          r"properties for )([\w.$]+)", line)
        if found:
            name = found.group(1)
            funcs.setdefault(name, {})
            continue
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", line)
        regs = re.search(r"Used (\d+) registers", line)
        if name and spills:
            funcs[name]["spill_bytes"] = int(spills[1]) + int(spills[2])
        if name and regs:
            funcs[name]["registers"] = int(regs[1])
    return funcs


def phase_build() -> None:
    from repro_torch.kernels._build import load_library
    from repro_torch.kernels.flash_attention import INSTANTIATIONS
    from repro_torch.kernels.rwkv6_scan import HEAD_SIZES, KERNELS

    t0 = time.perf_counter()
    _, info = load_library()
    print(f"[build] nvcc {info.seconds:.2f}s -> {info.path.name}; "
          f"total {time.perf_counter() - t0:.2f}s")
    print("[build] nvcc per source, compiled at once: "
          + ", ".join(f"{name} {sec:.2f}s" for name, sec in
                      info.per_source.items())
          + f"; their sum {sum(info.per_source.values()):.2f}s")
    funcs = _ptxas_functions(info.log)
    for name, props in funcs.items():
        print(f"[build] {name}: {props}")
    # each attention kernel's instantiations, as their mangled names spell
    # them (the source's first kernel up to head dim 256, its wide one
    # past it): no spills; the tensor-core ones hold wgmma and TMA loads,
    # the CUDA-core ones vector shared loads and asynchronous copies
    for d in INSTANTIATIONS["cuda_core"]:
        wide = d > 256
        name = "flash_fwd_wide_kernel" if wide else "flash_fwd_kernel"
        kernel = f"{name}ILi{d}E"
        mine = [props for fn, props in funcs.items() if kernel in fn]
        check(len(mine) == 1 and mine[0].get("spill_bytes") == 0,
              f"{name}<{d}>: ptxas reports {mine}, not one function "
              f"without spills")
        sass = _sass_counts(info.path, kernel)
        loops = inner_loops(info.path, kernel)
        print(f"[build] {name}<{d}>: {mine[0]['registers']} "
              f"registers, {mine[0]['spill_bytes']} spill bytes; SASS {sass};"
              f" innermost loops with FFMA {loops}")
        check(sass["functions"] == 1 and sass["LDS.128"] > 0
              and sass["LDGSTS"] > 0,
              f"{name}<{d}> lacks LDS.128 or LDGSTS: {sass}")
        # the design feeds at least 4 FFMA from each shared load in both
        # products (an SM issues 4 warp-FFMAs a clock); past 256 the P V
        # loops (every loop but the Q K^T one, which has the fewest) 8
        ratios = sorted(loop["FFMA_per_LDS"] for loop in loops)
        check(ratios and ratios[0] >= 4
              and (not wide or (len(ratios) > 1 and ratios[1] >= 8)),
              f"{name}<{d}>: innermost loops {loops} feed fewer than 4 "
              f"FFMA a shared load" + (", or P V fewer than 8" if wide
                                       else ""))
    for d in INSTANTIATIONS["sm90"]:
        name = ("flash_fwd_sm90_wide_kernel" if d > 256
                else "flash_fwd_sm90_kernel")
        kernel = f"{name}ILi{d}E"
        mine = [props for fn, props in funcs.items() if kernel in fn]
        check(len(mine) == 1 and mine[0].get("spill_bytes") == 0,
              f"{name}<{d}>: ptxas reports {mine}, not one function "
              f"without spills")
        sass = _sass_counts(info.path, kernel)
        print(f"[build] {name}<{d}>: {mine[0]['registers']} "
              f"registers, {mine[0]['spill_bytes']} spill bytes; SASS {sass}")
        check(sass["functions"] == 1 and sass["HGMMA"] > 0
              and sass["UTMALDG"] > 0,
              f"{name}<{d}> lacks wgmma or TMA loads: {sass}")
    for kernel in KERNELS:
        # the WKV6 pair: one instantiation a head size (K = V), no spills
        mine = {int(re.search(rf"{kernel}ILi(\d+)E", name)[1]): props
                for name, props in funcs.items() if f"{kernel}ILi" in name}
        check(sorted(mine) == list(HEAD_SIZES)
              and all(p.get("spill_bytes") == 0 for p in mine.values()),
              f"{kernel}: ptxas reports {mine}, not one function without "
              f"spills for each head size {HEAD_SIZES}")
        print(f"[build] {kernel}<K>: registers "
              + ", ".join(f"K {hs}: {p['registers']}" for hs, p in
                          sorted(mine.items()))
              + "; 0 spill bytes each")


# --------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# --------------------------------------------------------------------------
def _cycles(rows: int, n: int, rng) -> np.ndarray:
    from repro_torch.core.probes.runners import random_cycle

    return np.stack([random_cycle(n, rng) for _ in range(rows)])


def _wrapping_row(n: int, rng) -> np.ndarray:
    """A single cycle through slot 0 and the top 1024 slots: 6144 loads of
    values near ``n`` = 2**19 sum past 2**31, so the checksum wraps."""
    top = np.arange(n - 1024, n, dtype=np.int32)
    order = np.concatenate([[0], rng.permutation(top)]).astype(np.int32)
    row = np.zeros(n, dtype=np.int32)
    row[order] = np.roll(order, -1)
    return row


def _leaving_row(row: np.ndarray, at: int, value: int) -> np.ndarray:
    """A copy of a single-cycle row whose chain loads ``value`` at load
    ``at`` (counted from 0): the slot that load reads holds it."""
    slot = 0
    for _ in range(at):
        slot = int(row[slot])
    bad = row.copy()
    bad[slot] = value
    return bad


CHASE_SHAPES = ((1, 10), (64, 10), (1, 19), (64, 19))   # (R, log2 N)
UNROLL_STEPS = (7, 6143)        # chain lengths off the walk's unroll of 8
CHASE_KERNELS = ("pchase_batch_kernel", "eviction_batch_kernel",
                 "chase_floor_kernel")


def print_sass_chains(lib_path) -> dict:
    """What sits between one load of a chain and the next, in the SASS of
    the chase kernels and the floor: each function's most common runs of
    dependent instructions, by the loads they follow."""
    chains = sass_chains(lib_path, CHASE_KERNELS)
    for fn, counts in sorted(chains.items()):
        print(f"[sass] {fn}: {sum(counts.values())} loads feed a later "
              f"load's address; on the chain between one and the next: "
              + "; ".join(f"{' '.join(ch) or '(nothing)'} after {k}"
                          for ch, k in counts.most_common(3)))
    check(all(chains.get(k) for k in CHASE_KERNELS[:2]),
          f"sass: no dependent loads found in {sorted(chains)}")
    return {fn: " ".join(counts.most_common(1)[0][0])
            for fn, counts in chains.items()}


def _per_load(ms: float, loads: int, smi: dict, floor_ns: float) -> dict:
    """A launch's ns and SM cycles a load (ns times the SM clock read
    beside it) and its share over the floor of its level."""
    ns = ms * 1e6 / loads
    return {"per_load_ns": ns,
            "per_load_cycles": ns * smi["clocks_sm_mhz"] / 1e3,
            "clocks_sm_mhz": smi["clocks_sm_mhz"],
            "over_floor": ns / floor_ns}


def phase_kernels(rng, floor: dict) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.kernels._build import load_library
    from repro_torch.kernels.pchase_probe import (eviction_batch_plain,
                                                  pchase_batch_plain,
                                                  pchase_reference)
    from repro_torch.kernels.stream_probe import (READ_SLICE, WRITE_SLICE,
                                                  stream_read_plain,
                                                  stream_write_plain)

    rows = {}
    chains = print_sass_chains(load_library()[1].path)
    floors, l1, l2 = floor["floors"], floor["l1_bytes"], floor["l2_bytes"]

    def record(name, **kw):
        """Keep the largest chase shape for the summary line, every shape's
        times under ``shapes``, and the largest error of any shape."""
        err = max(kw["max_abs_err"], rows.get(name, kw)["max_abs_err"])
        shapes = rows.get(name, {}).get("shapes", {})
        shapes[kw["shape"]] = {k: kw[k] for k in (
            "ms", "device_ms", "bound_ms", "bound_level", "per_load_ns",
            "per_load_cycles", "over_floor")}
        if name not in rows or kw["shape"] == "R=64,N=2^19":
            rows[name] = kw
        rows[name]["max_abs_err"] = err
        rows[name]["shapes"] = shapes

    for r, log_n in CHASE_SHAPES:
        n = 1 << log_n
        shape = f"R={r},N=2^{log_n}"
        perms = _cycles(r, n, rng)
        cycle = np.full(r, n)                    # slots on each row's cycle
        wraps = r > 1 and log_n == 19
        if wraps:
            perms[0], cycle[0] = _wrapping_row(n, rng), 1025
        evictors = _cycles(r, n, rng)
        p_t, e_t = (torch.from_numpy(a).cuda() for a in (perms, evictors))
        for length in UNROLL_STEPS + (STEPS,):     # STEPS last: timed below
            steps = np.full(r, length, dtype=np.int32)
            # one full pass over a small evictor, as discovery's rows make;
            # capped at the probe's chain length on the 2 MiB rows
            warm = np.minimum(steps, n)
            warm[0] = 0                              # the bit-identity anchor
            s_t, w_t = (torch.from_numpy(a).cuda() for a in (steps, warm))
            got = ops.pchase_batch(p_t, s_t)
            got_e = ops.eviction_batch(p_t, e_t, w_t, s_t)
            torch.cuda.synchronize()
            want = pchase_batch_plain(p_t, s_t)
            want_e = eviction_batch_plain(p_t, e_t, w_t, s_t)
            check(torch.equal(got, want),
                  f"pchase_batch {shape} steps={length}: differs")
            check(torch.equal(got_e, want_e),
                  f"eviction_batch {shape} steps={length}: differs")
            check(torch.equal(got_e[0], got[0]), f"eviction_batch {shape} "
                  f"steps={length}: warm=0 row differs from pchase row")
        print(f"[kernel] pchase_batch, eviction_batch {shape}: equal to the "
              f"plain versions at steps {UNROLL_STEPS + (STEPS,)}")
        if wraps:
            # every value is positive, so a negative checksum has wrapped
            ref = pchase_reference(perms[0], STEPS)
            check(tuple(got[0].tolist()) == ref and ref[1] < 0,
                  f"pchase_batch {shape}: wrap row {got[0].tolist()} vs "
                  f"reference {ref}")
        # rows that load n, or a negative value, end with cursor -1; the
        # rows beside them are untouched
        bad = perms.copy()
        bad[0] = _leaving_row(perms[0], 100, n)
        bad_ev = evictors.copy()
        if r > 1:
            bad[1] = _leaving_row(perms[1], 5, -7)
            bad_ev[r - 1] = _leaving_row(evictors[r - 1], 3, n)
        b_t, be_t = (torch.from_numpy(a).cuda() for a in (bad, bad_ev))
        got_b = ops.pchase_batch(b_t, s_t)
        got_be = ops.eviction_batch(p_t, be_t, w_t, s_t)
        torch.cuda.synchronize()
        left = [0, 1] if r > 1 else [0]
        check(all(int(got_b[i, 0]) == -1 for i in left)
              and torch.equal(got_b[len(left):], want[len(left):]),
              f"pchase_batch {shape}: rows leaving [0, N) gave "
              f"{got_b[:3].tolist()}")
        check(r == 1 or (int(got_be[r - 1, 0]) == -1
                         and torch.equal(got_be[:r - 1], want_e[:r - 1])),
              f"eviction_batch {shape}: an evictor leaving [0, N) gave "
              f"{got_be[-1].tolist()}")
        print(f"[kernel] {shape}: rows that load N or -7 end with cursor -1 "
              f"(pchase_batch rows {left}"
              + (f", eviction_batch row {r - 1}" if r > 1 else "") + ")")

        def chase():
            return ops.pchase_batch(p_t, s_t)

        def evict():
            return ops.eviction_batch(p_t, e_t, w_t, s_t)

        dev = device_ms({"pchase_batch": (chase, 1),
                         "eviction_batch": (evict, 1)})
        fps = 4 * cycle
        for name, fn, plain in (
                ("pchase_batch", chase, lambda: pchase_batch_plain(p_t, s_t)),
                ("eviction_batch", evict,
                 lambda: eviction_batch_plain(p_t, e_t, w_t, s_t))):
            k_ms = event_ms(fn)
            p_ms = event_ms(plain, reps=5)
            if name == "pchase_batch":
                b_ms, level = latency_bound_ms(steps, fps, floors, l1, l2)
                loads = STEPS
                err = int((got - want).abs().max())
                what = f"steps={STEPS}"
            else:
                b_ms, level = eviction_bound_ms(
                    warm, steps, np.full(r, 4 * n), fps, floors, l1, l2)
                loads = STEPS + int(warm.max())
                err = int((got_e - want_e).abs().max())
                what = f"warm={int(warm.max())} probe={STEPS}"
            floor_ns = b_ms * 1e6 / loads
            per = _per_load(dev[name], loads, smi_beside(fn), floor_ns)
            print(f"[kernel] {name} {shape} {what}: exact; kernel_ms="
                  f"{k_ms:.4f} device_ms={dev[name]:.4f} per_load_ns="
                  f"{per['per_load_ns']:.2f} ({per['per_load_cycles']:.1f} "
                  f"cyc at {per['clocks_sm_mhz']:.0f} MHz) against the "
                  f"floor's {floor_ns:.2f} at {level} "
                  f"({per['over_floor']:.3f}x); bound_ms={b_ms:.6f} "
                  f"(latency) plain_ms={p_ms:.3f} library_ms=null")
            record(name, shape=shape, ms=k_ms, device_ms=dev[name],
                   plain_ms=p_ms, bound_ms=b_ms, bound_by="latency",
                   bound_level=level, library_ms=None, max_abs_err=err,
                   sass_chain=chains.get(f"{name}_kernel"), **per)

    n = BW_BYTES // 4
    x = torch.from_numpy(rng.random(n, dtype=np.float32)).cuda()
    # discovery's 2 MiB in 64 Ki blocks (16-byte loads), then three blocks of
    # 1001, of which only the first starts 16-byte aligned (the others begin
    # with scalar loads, and every block ends with them)
    errs = {}
    for xs, block in ((x, BLOCK), (x[:3 * 1001], 1001)):
        shape = f"N={xs.shape[0]},block={block}"
        got = ops.stream_read(xs, block=block)
        again = ops.stream_read(xs, block=block)
        torch.cuda.synchronize()
        want = stream_read_plain(xs, block)
        check(torch.allclose(got, want, rtol=1e-5, atol=0.0),
              f"stream_read {shape}: {got} vs {want} beyond rtol 1e-5")
        check(torch.equal(got, again),
              f"stream_read {shape}: two calls differ")
        errs[block] = float((got - want).abs().max())
        if block != BLOCK:
            print(f"[kernel] stream_read {shape}: rtol 1e-5 ok "
                  f"(max_abs_err={errs[block]:g}); equal in two calls")
    shape = f"N=2^{n.bit_length() - 1},block={BLOCK}"

    def read():
        return ops.stream_read(x, block=BLOCK)

    def sum_():
        return torch.sum(x.view(-1, BLOCK), dim=1)

    def write():
        return ops.stream_write(x, block=BLOCK)

    def add():
        return torch.add(x, 1)

    # the write bit-exact on discovery's 2 MiB, on a tail that is not a
    # whole slice, and on a view that starts off a 16-byte boundary (every
    # element then a scalar)
    for xs, block in ((x, BLOCK), (x[:3 * 1001], 1001), (x[1:3004], 1001)):
        got = ops.stream_write(xs, block=block)
        torch.cuda.synchronize()
        check(torch.equal(got, stream_write_plain(xs)),
              f"stream_write N={xs.shape[0]}: differs from x + 1")
    for name, kernel, plain, library, nbytes, lib_name, ctas in (
            ("stream_read", read, lambda: stream_read_plain(x, BLOCK), sum_,
             4 * n + 4 * (n // BLOCK), "torch.sum",
             n // BLOCK * -(-BLOCK // READ_SLICE)),
            ("stream_write", write, lambda: stream_write_plain(x), add,
             8 * n, "torch.add", -(-n // WRITE_SLICE))):
        k_ms = event_ms(kernel)
        p_ms = event_ms(plain)
        l_ms = event_ms(library)
        dev = device_ms({"kernel": (kernel, 1), "library": (library, None)})
        k_dev, l_dev = dev["kernel"], dev["library"]
        k_host, l_host = host_us(kernel), host_us(library)
        b_ms, b_by = bound_ms(nbytes, n)
        err = (max(errs.values()) if name == "stream_read" else
               float((write() - stream_write_plain(x)).abs().max()))
        exact = ("rtol 1e-5 ok (max_abs_err={err:g}); equal in two calls"
                 if name == "stream_read" else "bit-exact").format(err=err)
        print(f"[kernel] {name} {shape} ({ctas} CTAs): {exact}; "
              f"kernel_ms={k_ms:.4f} (device {k_dev:.4f}; host us a call "
              f"{k_host:.2f}) bound_ms={b_ms:.6f} ({b_by}) plain_ms="
              f"{p_ms:.4f} library_ms={l_ms:.4f} ({lib_name}; device "
              f"{l_dev:.4f}; host us a call {l_host:.2f})")
        rows[name] = dict(shape=shape, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                          bound_by=b_by, library_ms=l_ms, max_abs_err=err,
                          device_ms=k_dev, library_device_ms=l_dev)
    return rows


# --------------------------------------------------------------------------
# Phase 3: discovery on the card
# --------------------------------------------------------------------------
# discover_cuda() with this script's defaults on an NVIDIA H100 80GB HBM3 at
# 700 W, with the chase kernel of commit 866db32 (a compare and an early
# exit on every loaded value): its wall and per-family seconds.
EARLIER_DISCOVERY = {"wall": 1.17, "size": 0.9337, "fetch_granularity": 0.0865,
                     "bandwidth": 0.0016, "latency": 0.0636,
                     "line_size": 0.0444, "amount": 0.0072, "sharing": 0.0}
DISCOVERY_LAUNCHES = {"pchase_batch": 876, "eviction_batch": 13,
                      "stream_read": 8, "stream_write": 8}


def calibration_summary(entries: list, l1_bytes: int) -> dict:
    """Per family, the request/calibration wall ratios of its timed loops
    (least, median, largest), the rows whose request footprint and
    calibration footprint lie on two sides of the L1 capacity, the host
    wall of its timed launches (each launch and its synchronize) and the
    host seconds its loops spent building chase buffers and copying them
    to the card."""
    out = {}
    for family in sorted({e["family"] for e in entries}):
        mine = [e for e in entries if e["family"] == family]
        ratios = [e["ratio"] for e in mine]
        straddle = sum((b <= l1_bytes) != (e["calibration_bytes"] <= l1_bytes)
                       for e in mine for b in e["request_bytes"])
        out[family] = {"loops": len(mine),
                       "rows": sum(len(e["request_bytes"]) for e in mine),
                       "ratio_min": min(ratios),
                       "ratio_median": statistics.median(ratios),
                       "ratio_max": max(ratios), "straddling_rows": straddle,
                       "launch_s": sum(e["launch_s"] for e in mine),
                       "buffer_s": sum(e["buffer_s"] for e in mine)}
    return out


def _print_discovery(label: str, runner, timings, wall: float,
                     launches: dict, floor: dict) -> None:
    """One discovery's launches, kernel calls, probe rows, fusion rounds,
    per-family seconds and the runner's calibration log by family label
    (a fused dispatch files its loops under the ``+``-joined families of
    the rows it carried)."""
    fusion = timings.meta.get("fusion")
    fused = ("unfused" if fusion is None else
             f"{fusion['rounds']} fused rounds, {fusion['fused_calls']} "
             f"fused dispatches carrying {fusion['fused_rows']} rows "
             f"({fusion['fused_rows'] / max(fusion['fused_calls'], 1):.2f} "
             f"rows a dispatch)")
    print(f"[discover] {label}: wall {wall:.4f}s; kernel_calls "
          f"{runner.kernel_calls}; eviction grids "
          f"{runner.eviction_grid_calls} carrying "
          f"{runner.eviction_grid_rows} rows; probe rows "
          f"{timings.probe_rows}; {fused}; launches {launches}")
    print(f"[discover] {label}: per-family seconds (fused items overlap "
          f"while parked) " + json.dumps(
              {k: round(v, 4) for k, v in timings.per_family.items()}))
    summary = calibration_summary(runner.calibrations, floor["l1_bytes"])
    for family, row in summary.items():
        own = timings.per_family.get(family)
        of = "" if own is None else f"of the family's {own:.4f}s, "
        print(f"[discover] {label}: calibration {family or '(none)'}: "
              f"{row['loops']} timed loops, {row['rows']} rows; "
              f"request/calibration wall ratio min {row['ratio_min']:.4f} "
              f"median {row['ratio_median']:.4f} max {row['ratio_max']:.4f}; "
              f"rows whose footprints straddle the L1's "
              f"{floor['l1_bytes'] / KIB:.0f} KiB: {row['straddling_rows']}; "
              f"{of}timed launches {row['launch_s']:.4f}s and chase buffers "
              f"{row['buffer_s']:.4f}s")
    sized = [e for e in runner.calibrations
             if "size" in e["family"].split("+")]
    print(f"[discover] {label}: all timed loops: launches "
          f"{sum(e['launch_s'] for e in runner.calibrations):.4f}s, chase "
          f"buffers {sum(e['buffer_s'] for e in runner.calibrations):.4f}s "
          f"of the wall {wall:.4f}s; loops carrying size rows: launches "
          f"{sum(e['launch_s'] for e in sized):.4f}s, chase buffers "
          f"{sum(e['buffer_s'] for e in sized):.4f}s")


def _ground_truth_misses(topo) -> list:
    """The discrete attributes of ``topo`` that miss the model's ground
    truth: L1 and L2 size, line size and fetch granularity exact, VMEM's
    size within 64 B and no cold-pass attribute on it, latencies within
    50 % (the reference's own acceptance)."""
    from repro_torch.core.probes import make_cuda_model

    gt = make_cuda_model().ground_truth()
    misses = []
    for name in ("L1", "L2"):
        me = topo.find_memory(name)
        if me is None:
            return [f"{name}: missing from the topology"]
        misses += [f"{name}.{attr} = {me.get(attr)}, ground truth "
                   f"{gt[name][attr]}"
                   for attr in ("size", "line_size", "fetch_granularity")
                   if me.get(attr) != gt[name][attr]]
    vmem = topo.find_memory("VMEM")
    if vmem is None or vmem.get("size") is None \
            or abs(vmem.get("size") - gt["VMEM"]["size"]) > 64:
        misses.append(f"VMEM size {vmem and vmem.get('size')} not within "
                      f"64 B of {gt['VMEM']['size']}")
    elif vmem.get("fetch_granularity") is not None \
            or vmem.get("line_size") is not None:
        misses.append("VMEM carries cold-pass attributes")
    for name in ("L1", "VMEM", "L2"):
        me = topo.find_memory(name)
        got, want = me and me.get("load_latency"), gt[name]["latency"]
        if got is None or abs(got - want) / want >= 0.5:
            misses.append(f"{name} latency {got} not within 50% of {want}")
    return misses


def phase_discover(floor: dict) -> tuple:
    """Dense and unfused discovery, then the default (planned and fused)
    one, each on a fresh runner and each read around its own run; returns
    the default run's launches and wall, and its (warmed) runner."""
    from repro_torch.core import discover_cuda
    from repro_torch.core.probes import CudaRunner, make_cuda_model
    from repro_torch.kernels import ops

    def run(**kw):
        runner = CudaRunner()           # discover_cuda's default runner
        ops.reset_launches()
        t0 = time.perf_counter()
        topo, timings = discover_cuda(runner=runner, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return (runner, topo, timings, wall,
                {fn.__name__: fn.launches for fn in ops.WRAPPERS})

    runner, topo, timings, wall, dense = run(budget=None, fuse=False)
    _print_discovery("dense, unfused", runner, timings, wall, dense, floor)
    print("[discover] dense, unfused: per-family seconds (with the chase "
          "kernel of 866db32 on an H100 at 700 W after the arrow) "
          + json.dumps({k: f"{v:.4f} <- {EARLIER_DISCOVERY.get(k, 'n/a')}"
                        for k, v in timings.per_family.items()})
          + f"; wall {wall:.4f} <- {EARLIER_DISCOVERY['wall']}")
    print(topo.to_markdown())
    check(dense == DISCOVERY_LAUNCHES,
          f"dense discovery launches {dense}, expected {DISCOVERY_LAUNCHES}")
    misses = _ground_truth_misses(topo)
    check(not misses, f"dense discovery: {misses}")
    check(timings.meta["planned"] is False and "fusion" not in timings.meta,
          f"dense discovery ran planned or fused: {timings.meta}")
    gt = make_cuda_model().ground_truth()
    amount = topo.find_memory("L1").get("amount")
    print(f"[discover] L1 amount {amount} (ground truth "
          f"{gt['L1']['amount']}; not held: the reference misses it too)")
    print("[discover] bandwidth (GB/s, one launch's host wall at 2 MiB): "
          + "; ".join(f"{name} read {me.get('read_bw')} write "
                      f"{me.get('write_bw')}" for name, me in (
                          ("L2", topo.find_memory("L2")),
                          ("DeviceMemory", topo.find_memory("DeviceMemory")))
                      if me is not None))

    # the default: planned and fused; a measured ground-truth miss gets one
    # retry, as the reference's acceptance of its planned Pallas discovery
    for attempt in (1, 2):
        runner, topo, timings, wall, planned = run()
        label = "planned, fused" + (" (retry)" if attempt == 2 else "")
        _print_discovery(label, runner, timings, wall, planned, floor)
        misses = _ground_truth_misses(topo)
        if not misses:
            break
        print(f"[discover] {label}: ground truth missed: {misses}"
              + ("; one retry" if attempt == 1 else ""))
    check(not misses, f"planned discovery missed the ground truth twice: "
          f"{misses}")
    print(topo.to_markdown())
    check(timings.meta["planned"] is True and timings.meta["fusion"]["rounds"]
          > 0, f"the default discovery was not planned and fused: "
          f"{timings.meta}")
    check(planned["pchase_batch"] < dense["pchase_batch"]
          and all(n > 0 for n in planned.values()),
          f"planned discovery launches {planned} against dense {dense}")
    labels = {e["family"] for e in runner.calibrations}
    check("" not in labels and any("+" in label for label in labels),
          f"fused timed loops not logged under family labels: {labels}")
    print(f"[discover] planned, fused against dense, unfused in this call: "
          f"pchase_batch launches {planned['pchase_batch']} vs "
          f"{dense['pchase_batch']}, all launches {sum(planned.values())} "
          f"vs {sum(dense.values())}")
    return planned, wall, runner


# --------------------------------------------------------------------------
# Phase 3b: the topology service over HTTP
# --------------------------------------------------------------------------
SERVICE_PATHS = (("L1", "size"), ("L1", "line_size"),
                 ("L2", "fetch_granularity"))


def phase_service() -> None:
    """The port's ``TopologyHTTPServer`` on 127.0.0.1:0 over a store in a
    temporary directory and a ``JobEngine``: a ``"cuda"`` discovery
    submitted through ``TopologyClient``, three attributes queried over
    HTTP and held to ground truth, the same request served from the store
    with no launch, ``refresh`` measuring again, and a clean shutdown."""
    import tempfile

    from repro_torch.core.engine.store import TopologyStore
    from repro_torch.core.probes import make_cuda_model
    from repro_torch.kernels import ops
    from repro_torch.serve import TopologyClient, TopologyHTTPServer

    gt = make_cuda_model().ground_truth()

    def submit(client, params):
        ops.reset_launches()
        t0 = time.perf_counter()
        job = client.submit_and_wait(params, timeout_s=300, poll_s=0.05)
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
        check(job["state"] == "done", f"service job {params}: "
              f"{job['state']} ({job['error']})")
        answers = {f"{name}.{attr}": client.query(job["key"],
                                                  f"{name}.{attr}")["value"]
                   for name, attr in SERVICE_PATHS}
        # the job's own time on the server beside the client's wall, which
        # includes the client's polls (JOB_POLL_S = 1 s when its first GET
        # comes before the job has finished)
        server_s = job["finished_at"] - job["started_at"]
        print(f"[service] {json.dumps(params)}: {job['state']} in "
              f"{wall:.4f}s (client), {server_s:.4f}s on the server "
              f"(finished_at - started_at), queued "
              f"{job['started_at'] - job['created_at']:.4f}s; store_hit "
              f"{job['result']['store_hit']}; probe "
              f"rows {job['result']['probe_rows']}; launches {launches}; "
              f"over HTTP {answers}")
        return job, launches, answers

    want = {f"{name}.{attr}": gt[name][attr] for name, attr in SERVICE_PATHS}
    with tempfile.TemporaryDirectory() as root:
        server = TopologyHTTPServer(TopologyStore(root), host="127.0.0.1",
                                    port=0).start()
        try:
            client = TopologyClient(server.url)
            print(f"[service] TopologyHTTPServer at {server.url}; healthz "
                  f"{client.healthz()}")
            job, launches, answers = submit(client, {"backend": "cuda"})
            check(not job["result"]["store_hit"]
                  and launches["pchase_batch"] > 0,
                  f"the first cuda job did not measure: {launches}")
            if answers != want:
                # a measured miss: one retry, measured again
                print(f"[service] ground truth {want} missed; one retry")
                job, launches, answers = submit(
                    client, {"backend": "cuda", "refresh": True})
            check(answers == want, f"service answers {answers}, ground "
                  f"truth {want}")
            again, launches, answers = submit(client, {"backend": "cuda"})
            check(again["key"] == job["key"] and again["result"]["store_hit"]
                  and not any(launches.values()) and answers == want,
                  f"the repeat was not a store hit without launches: "
                  f"{again['result']}, {launches}")
            fresh, launches, _ = submit(client, {"backend": "cuda",
                                                 "refresh": True})
            check(fresh["key"] == job["key"]
                  and not fresh["result"]["store_hit"]
                  and launches["pchase_batch"] > 0,
                  f"refresh did not measure again: {fresh['result']}, "
                  f"{launches}")
            jobs = client.metrics()["jobs"]
            print(f"[service] job metrics: {jobs}")
        finally:
            server.stop()
        check(server._thread is None and not server.job_engine._threads,
              "the server or its job workers did not stop")
    print("[service] server stopped: accept loop and job workers joined")


# --------------------------------------------------------------------------
# Phase 3c: resilient, chaos-tested and process-parallel discovery
# --------------------------------------------------------------------------
# The chaos schedule of the transient run: value-preserving (no jitter, no
# outliers), each request signature faulted at most once.  Which rows the
# planned sweeps ask for follows the card's measurements, so which of them
# a rate of 0.05 faults varies; seed 7 faults the first L2 read-bandwidth
# call, whose signature every run asks for, so at least one work item is
# retried in every run.
TRANSIENT = dict(seed=7, transient_rate=0.05, batch_fault_rate=0.05,
                 max_faults_per_request=1)
# The sim pool's run, in a child process started with ``-c``: a spawned
# worker re-imports its parent's main script, and this one imports torch;
# the child's workers import the numpy-only probe modules alone.
SIM_POOL_CHILD = r"""
import json, sys, time
from repro_torch.core import discover_sim, make_h100_like
from repro_torch.core.engine.parallel import (ParallelConfig, get_global_pool,
                                              shutdown_global_pools)
cfg = ParallelConfig(workers=2, min_rows_per_shard=1, call_timeout_s=120.0)
t0 = time.perf_counter()
inline, ti = discover_sim(make_h100_like())
inline_wall = time.perf_counter() - t0
try:
    t0 = time.perf_counter()
    pooled, tp = discover_sim(make_h100_like(), parallel=cfg)
    pooled_wall = time.perf_counter() - t0
    pool = get_global_pool(cfg)
    stats = {"workers": pool.workers, "calls": pool.calls,
             "shards": pool.shards, "respawns": pool.respawns}
finally:
    shutdown_global_pools()
doc = lambda t: {k: v for k, v in t.to_json().items() if k != "notes"}
print(json.dumps({"equal": doc(inline) == doc(pooled),
                  "cache_equal": ti.meta["cache"] == tp.meta["cache"],
                  "inline_wall": inline_wall, "pooled_wall": pooled_wall,
                  "torch_imported": "torch" in sys.modules, **stats}))
"""


def _chaos_discovery(runner, schedule, policy) -> tuple:
    """``discover_cuda`` (planned, fused) over ``ChaosRunner(runner,
    schedule)`` under ``policy``, read around its own run."""
    from repro_torch.core import discover_cuda
    from repro_torch.core.probes import ChaosRunner, make_cuda_model
    from repro_torch.kernels import ops

    chaos = ChaosRunner(runner, schedule)
    ops.reset_launches()
    t0 = time.perf_counter()
    topo, timings = discover_cuda(make_cuda_model(), runner=chaos,
                                  resilience=policy)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (chaos, topo, timings, wall,
            {fn.__name__: fn.launches for fn in ops.WRAPPERS})


def phase_resilience(runner, clean: dict, clean_wall: float) -> dict:
    """Resilient discovery on the card, on phase 3's warmed runner: under
    transient faults (retried to the ground truth, nothing degraded), under
    a permanent bandwidth fault (that family alone degraded), and with a
    pool config (inline: nothing spawned, the dense run's launches); then
    on the host, a pooled ``discover_sim`` bit-equal to the inline one, and
    a killed resilient ``discover_sim`` resumed from its checkpoint with no
    persisted row probed again.  Returns the transient run's launches."""
    import multiprocessing
    import tempfile

    from repro_torch.core import (Resilience, discover, discover_cuda,
                                  discover_sim, make_h100_like)
    from repro_torch.core.discover import (DiscoveryRequest,
                                           _device_families,
                                           sim_request_descriptor)
    from repro_torch.core.engine import parallel as parallel_module
    from repro_torch.core.engine.parallel import ParallelConfig
    from repro_torch.core.engine.store import TopologyStore, request_key
    from repro_torch.core.probes import (ChaosRunner, CudaRunner,
                                         FaultSchedule, SimRunner)
    from repro_torch.core.topology import PROVENANCE_DEGRADED
    from repro_torch.kernels import ops

    # backoff sleeps skipped: the wall is the retried work's alone
    policy = Resilience(max_retries=3, sleep=lambda _s: None)

    # 1. transient faults, retried to the ground truth (one retry on a
    # measured miss, as in phase 3)
    for attempt in (1, 2):
        chaos, topo, timings, wall, launches = _chaos_discovery(
            runner, FaultSchedule(**TRANSIENT), policy)
        meta = timings.meta.get("resilience", {"retries": 0, "degraded": []})
        label = "transient faults" + (" (retry)" if attempt == 2 else "")
        print(f"[resilience] {label}: {chaos.faults_injected} faults "
              f"injected ({chaos.batch_faults} on batched calls) in "
              f"{chaos.calls} gated calls; retries {meta['retries']}, "
              f"degraded {meta['degraded']}; launches {launches} (the "
              f"clean planned run {clean}); wall {wall:.4f}s (the clean "
              f"planned run {clean_wall:.4f}s)")
        misses = _ground_truth_misses(topo)
        if not misses:
            break
        print(f"[resilience] {label}: ground truth missed: {misses}")
    check(not misses, f"discovery under transient faults missed the ground "
          f"truth twice: {misses}")
    check(chaos.faults_injected > 0 and meta["retries"] >= 1
          and meta["degraded"] == [],
          f"transient faults: {chaos.faults_injected} injected, "
          f"resilience {meta}")
    check(all(n > 0 for n in launches.values()),
          f"a probe kernel never launched under transient faults: "
          f"{launches}")
    transient = launches

    # 2. a permanent fault on the bandwidth family: it alone degrades
    for attempt in (1, 2):
        chaos, topo, timings, wall, launches = _chaos_discovery(
            runner, FaultSchedule(seed=7, permanent_kinds=("bandwidth",)),
            Resilience(max_retries=1, sleep=lambda _s: None))
        meta = timings.meta["resilience"]
        print(f"[resilience] permanent bandwidth fault: degraded "
              f"{meta['degraded']}; retries {meta['retries']}; launches "
              f"{launches}; wall {wall:.4f}s")
        misses = _ground_truth_misses(topo)
        if not misses:
            break
        print(f"[resilience] permanent fault: ground truth missed: {misses}")
    check(not misses, f"discovery under a permanent bandwidth fault missed "
          f"the ground truth twice: {misses}")
    check(meta["degraded"]
          and all(k.endswith("bandwidth") for k in meta["degraded"]),
          f"permanent bandwidth fault: degraded {meta['degraded']}")
    for name in ("L2", "DeviceMemory"):
        attr = topo.find_memory(name).attrs.get("read_bw")
        check(attr is not None and attr.value == "unknown"
              and attr.provenance == PROVENANCE_DEGRADED,
              f"{name}.read_bw not degraded: {attr}")
    check(launches["stream_read"] == launches["stream_write"] == 0
          and launches["pchase_batch"] > 0 and launches["eviction_batch"] > 0,
          f"permanent bandwidth fault: launches {launches}")

    # 3. a pool config on the CUDA path: inline, the dense run's launches
    children = set(multiprocessing.active_children())
    ops.reset_launches()
    t0 = time.perf_counter()
    topo, timings = discover_cuda(runner=CudaRunner(), budget=None,
                                  fuse=False,
                                  parallel=ParallelConfig(workers=2))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
    spawned = set(multiprocessing.active_children()) - children
    print(f"[resilience] dense, unfused, parallel=ParallelConfig(workers=2):"
          f" launches {launches}; worker processes spawned {len(spawned)}; "
          f"pools {len(parallel_module._POOLS)}; wall {wall:.4f}s")
    check(not spawned and not parallel_module._POOLS,
          f"parallel= spawned workers on the CUDA path: {spawned}")
    check(launches == DISCOVERY_LAUNCHES, f"dense discovery with parallel= "
          f"launched {launches}, without it {DISCOVERY_LAUNCHES}")
    misses = _ground_truth_misses(topo)
    check(not misses, f"dense discovery with parallel=: {misses}")

    # 4. the sim pool on this machine's host cores
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    out = subprocess.run([sys.executable, "-c", SIM_POOL_CHILD], cwd=HERE,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    check(out.returncode == 0, f"sim pool child failed: {out.stderr}")
    pool = json.loads(out.stdout.strip().splitlines()[-1])
    print(f"[resilience] discover_sim(make_h100_like()) pooled "
          f"(workers=2, min_rows_per_shard=1) vs inline on "
          f"{os.cpu_count()} host cores: " + json.dumps(pool))
    check(pool["equal"] and pool["cache_equal"] and pool["respawns"] == 0
          and pool["shards"] > pool["calls"] > 0
          and not pool["torch_imported"], f"pooled sim discovery: {pool}")

    # 5. a killed resilient discover_sim resumed from its checkpoint
    dev = make_h100_like(seed=3)
    _, clean_t = discover_sim(dev, n_samples=9, max_workers=0)
    with tempfile.TemporaryDirectory() as root:
        store = TopologyStore(root)
        killed = DiscoveryRequest(
            descriptor=sim_request_descriptor(dev, 9, None,
                                              resilience=policy),
            vendor=dev.vendor, model=dev.name,
            backend=f"simulated:{dev.name}",
            make_runner=lambda: ChaosRunner(
                SimRunner(dev), FaultSchedule(seed=5, kill_after=40)),
            n_samples=9, device_families=_device_families(dev, None),
            max_workers=0, resilience=policy)
        try:
            discover(killed, store=store)
            raise SmokeFailure("the chaos kill did not fire")
        except RuntimeError as e:
            check("chaos kill" in str(e), f"unexpected error: {e}")
        key = request_key(killed.descriptor)
        entries, families = store.load_checkpoint(key)
        _, t = discover_sim(dev, n_samples=9, max_workers=0, store=store,
                            resilience=policy)
        resume, misses = t.meta["resume"], t.meta["cache"]["misses"]
        print(f"[resilience] checkpoint after the kill: {len(entries)} rows, "
              f"{len(families)} items done; resume {resume}; misses "
              f"{misses} + rows {len(entries)} = {misses + len(entries)} "
              f"(the clean run's misses {clean_t.meta['cache']['misses']});"
              f" checkpoint cleared {not store.has_checkpoint(key)}")
        check(resume == {"rows": len(entries), "families_done": len(families)}
              and len(entries) > 0
              and misses + len(entries) == clean_t.meta["cache"]["misses"]
              and not store.has_checkpoint(key),
              f"resume re-probed persisted rows: {resume}, misses {misses}")
    return transient


# --------------------------------------------------------------------------
# Phase 3d: host discovery, link adjacency and the collective models
# --------------------------------------------------------------------------
HOST_JOB = {"backend": "host", "max_bytes": 8 * MIB}
# Host discoveries until one shows the DRAM latency above the host-cache
# one.  "DRAM" is a 64 KiB chase (an L2 on most hosts) against a 1 KiB one,
# so the two are a few ns apart and a shared host can invert a run; the
# reference's own test of this ordering passes when any of five rounds
# shows it (``tests/test_host_probe.py``), and so does this gate.
HOST_ATTEMPTS = 5
# Simulated tori whose links find_link_adjacency must recover exactly.
PODS = ((4, 4, 3), (4, 8, 5))
# Collective models: a 64 MiB payload over one NVLink 4 direction of an
# H100 SXM (18 links x 25 GB/s a direction, NVIDIA data sheet).
COLLECTIVE_BYTES = 64 * MIB
NVLINK_BW = 450e9


def host_cpu() -> dict:
    """The host CPU's model (``lscpu``, else ``/proc/cpuinfo``) and its
    caches (cpu0's in sysfs, else ``lscpu``'s cache lines, else
    ``getconf``), printed beside the host numbers for comparison only."""
    import glob

    def run(cmd) -> str:
        try:
            return subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=30).stdout
        except OSError:
            return ""

    lscpu = run(["lscpu"]).splitlines()
    fields = {key.strip(): value.strip() for key, _, value in
              (line.partition(":") for line in lscpu)}
    model = fields.get("Model name")
    if model is None:
        try:
            with open("/proc/cpuinfo") as f:
                model = next((line.split(":", 1)[1].strip() for line in f
                              if line.startswith("model name")), "unknown")
        except OSError:
            model = "unknown"
    # a virtualised host may report no name; CPUID's vendor, family and
    # model remain
    ident = " ".join(f"{key} {fields[key]}" for key in
                     ("Vendor ID", "CPU family", "Model", "BogoMIPS")
                     if key in fields)
    if ident:
        model = f"{model} ({ident})"
    caches = []
    for index in sorted(glob.glob("/sys/devices/system/cpu/cpu0/cache/"
                                  "index*")):
        try:
            caches.append(" ".join(
                open(os.path.join(index, name)).read().strip()
                for name in ("level", "type", "size")))
        except OSError:
            continue
    source = "sysfs cpu0"
    if not caches:
        source = "lscpu"
        caches = [" ".join(line.split()) for line in lscpu
                  if re.match(r"L\d\w* cache:", line)]
    if not caches:
        source = "getconf"
        caches = [" ".join(line.split())
                  for line in run(["getconf", "-a"]).splitlines()
                  if "CACHE_SIZE" in line
                  and line.split()[1:] not in ([], ["0"])]
    return {"model": model, "caches": caches, "source": source,
            "cpus": os.cpu_count()}


def _host_report(topo) -> dict:
    """Element -> {attribute: (unit, provenance)}, the host-cache size left
    out: whether the sweep finds one depends on the host."""
    return {me.name: {k: (a.unit, a.provenance) for k, a in me.attrs.items()
                      if (me.name, k) != ("host-cache", "size")}
            for me in topo.memory}


def phase_host() -> None:
    """Host discovery on the card machine's CPU: the compiled chase built,
    ``discover_host()`` at its defaults (128 MiB, 9 samples, quick) through
    a ``TopologyStore`` and its repeat served from the store with no probe,
    a ``"host"`` job at 8 MiB over the HTTP service and its repeat from the
    store; then ``find_link_adjacency`` on simulated tori and
    ``measure_collective`` at axis sizes 1 and 4, analytic on one card."""
    import importlib
    import tempfile

    from repro_torch.core import discover_host
    from repro_torch.core.engine.store import TopologyStore
    from repro_torch.core.probes import (HostRunner, SimPod,
                                         find_link_adjacency,
                                         measure_collective)
    from repro_torch.core.probes import bandwidth as bandwidth_module
    from repro_torch.core.probes.host_chase import build_host_chase
    from repro_torch.core.topology import Topology
    from repro_torch.serve import TopologyClient, TopologyHTTPServer

    discover_module = importlib.import_module("repro_torch.core.discover")
    built = build_host_chase()
    print(f"[host] chase built by {built.compiler} {' '.join(built.flags)} "
          f"in {built.seconds:.3f}s (0 when an earlier build was loaded): "
          f"{os.path.relpath(built.path, HERE)}")
    cpu = host_cpu()
    print(f"[host] CPU {cpu['model']} ({cpu['cpus']} logical CPUs); caches "
          f"({cpu['source']}, for comparison only) {cpu['caches']}")

    probes = {"pchase": 0}

    class CountingHostRunner(HostRunner):
        def pchase(self, *args):
            probes["pchase"] += 1
            return super().pchase(*args)

    def run(store):
        probes["pchase"] = 0
        t0 = time.perf_counter()
        topo, timings = discover_host(store=store)
        return topo, timings, time.perf_counter() - t0, probes["pchase"]

    original = discover_module.HostRunner
    discover_module.HostRunner = CountingHostRunner
    try:
        with tempfile.TemporaryDirectory() as root:
            for attempt in range(1, HOST_ATTEMPTS + 1):
                store = TopologyStore(os.path.join(root, str(attempt)))
                topo, timings, wall, calls = run(store)
                cache, dram = (topo.find_memory("host-cache"),
                               topo.find_memory("DRAM"))
                check(cache is not None and dram is not None,
                      f"discover_host: elements {topo.memory}")
                size = cache.get("size")
                ordered = dram.get("load_latency") > cache.get("load_latency")
                print(f"[host] discover_host() (128 MiB, 9 samples, quick)"
                      f" attempt {attempt}: wall "
                      f"{wall:.4f}s; per family "
                      f"{json.dumps(timings.per_family)}; chase calls "
                      f"{calls}; probe rows {timings.probe_rows}; host-cache "
                      f"size {size} B (its rows touched "
                      f"{None if size is None else 4 * size // 4096} B); "
                      f"latency host-cache {cache.get('load_latency')} ns, "
                      f"DRAM {dram.get('load_latency')} ns; DRAM read "
                      f"{dram.get('read_bw')} GB/s, write "
                      f"{dram.get('write_bw')} GB/s")
                if ordered:
                    break
                print("[host] DRAM latency not above the host-cache "
                      "latency; measured again")
            check(ordered, "discover_host: DRAM latency "
                  f"{dram.get('load_latency')} ns not above host-cache "
                  f"{cache.get('load_latency')} ns in {HOST_ATTEMPTS} runs")
            check(dram.get("read_bw") > 0 and dram.get("write_bw") > 0,
                  f"discover_host: bandwidths {dram.attrs}")
            check(calls > 0 and timings.probe_rows > 0,
                  f"discover_host probed nothing: {calls} chase calls")
            again, again_t, again_wall, again_calls = run(store)
            print(f"[host] repeat through the store: {again_wall:.4f}s, "
                  f"chase calls {again_calls}, store hit "
                  f"{'cache' not in again_t.meta}")
            check(again_calls == 0 and "cache" not in again_t.meta
                  and again.to_json() == topo.to_json(),
                  "the repeated host discovery was not a store hit")
    finally:
        discover_module.HostRunner = original

    with tempfile.TemporaryDirectory() as root:
        server = TopologyHTTPServer(TopologyStore(root), host="127.0.0.1",
                                    port=0).start()
        try:
            client = TopologyClient(server.url)
            answers = []
            for _ in range(2):
                t0 = time.perf_counter()
                job = client.submit_and_wait(HOST_JOB, timeout_s=300,
                                             poll_s=0.05)
                wall = time.perf_counter() - t0
                check(job["state"] == "done",
                      f"host job: {job['state']} ({job['error']})")
                doc = client.topology(job["key"])["topology"]
                answers.append((job, doc))
                print(f"[host] {json.dumps(HOST_JOB)} over HTTP: "
                      f"{job['state']} in {wall:.4f}s; store_hit "
                      f"{job['result']['store_hit']}; probe rows "
                      f"{job['result']['probe_rows']}; DRAM.read_bw "
                      f"{client.query(job['key'], 'DRAM.read_bw')['value']}"
                      " GB/s")
        finally:
            server.stop()
    (first, first_doc), (second, second_doc) = answers
    check(_host_report(Topology.from_json(first_doc)) == _host_report(topo),
          f"the host job's attributes {first_doc['memory']} differ from "
          f"the direct run's")
    check(not first["result"]["store_hit"] and second["result"]["store_hit"]
          and second["key"] == first["key"] and second_doc == first_doc,
          f"the repeated host job was not a store hit: {second['result']}")

    for rows, cols, seed in PODS:
        pod = SimPod(rows=rows, cols=cols, seed=seed)
        res = find_link_adjacency(pod, n_samples=9)
        right = sum(res.neighbors.get(c) == pod.neighbors(c)
                    for c in range(pod.n_chips))
        print(f"[host] find_link_adjacency SimPod {rows}x{cols} (seed "
              f"{seed}): found {res.found}, threshold "
              f"{res.threshold_us:.4f} us, {right}/{pod.n_chips} chips' "
              f"links equal to the torus's")
        check(res.found and right == pod.n_chips,
              f"SimPod {rows}x{cols}: {res.neighbors}")

    formulas = {
        "all_reduce": lambda n: bandwidth_module.ring_all_reduce_time(
            COLLECTIVE_BYTES, n, NVLINK_BW),
        "all_gather": lambda n: bandwidth_module.ring_all_gather_time(
            COLLECTIVE_BYTES // n, n, NVLINK_BW),
        "all_to_all": lambda n: bandwidth_module.all_to_all_time(
            COLLECTIVE_BYTES, n, NVLINK_BW)}
    for op, formula in formulas.items():
        for axis in (1, 4):
            live = bandwidth_module.live_collective(axis)
            est = measure_collective(op, COLLECTIVE_BYTES, axis, NVLINK_BW)
            print(f"[host] measure_collective({op}, 64 MiB, axis {axis}) on "
                  f"{torch.cuda.device_count()} card(s): "
                  f"{'live' if live else 'analytic'} path, "
                  f"{est.seconds:.6e}s, {est.effective_bw / 1e9:.4f} GB/s")
            check(not live and est.seconds == max(formula(axis), 1e-12),
                  f"measure_collective({op}, axis {axis}): {est}")


# --------------------------------------------------------------------------
# Phase 4: the model kernels and the single-chain chase
# --------------------------------------------------------------------------
# The serve phase's shapes: a wave of 4 prompts of 512 tokens; qwen3-14b's
# 40 query and 8 kv heads of 128, rwkv6-3b's 40 heads of 64.
ATTN = dict(b=4, hq=40, hkv=8, s=512, d=128)
WKV = dict(b=4, t=512, h=40, k=64, chunk=32)
# Attention, |got - want| <= rtol |want| + atol, by (kernel, dtype): the
# kernel against the plain version (dense softmax in f32, output in q's
# dtype), and the tensor-core kernel also against the plain emulation of its
# own numerics.
# * sm90, bf16, against the plain version: both accumulate in f32 and round
#   the output once to bf16, which differs by at most one ulp, at most 2**-7
#   of the value.  The kernel also rounds each unnormalised probability p to
#   bf16 for P.V, as the reference's f32 dot does on the TPU's matrix unit:
#   each weight moves by at most 2**-9 of itself, so an output moves by at
#   most 2**-9 sum(p / l)|v| <= 2**-9 max|v|; atol is twice that,
#   2**-8 max|v|, and stays below the reference's own bf16 tolerance for the
#   kernel, 3e-2.  (The earlier atol of 2e-3 held a kernel that kept p in
#   f32; a few outputs in the first rows, where few keys carry the weight,
#   exceed it now, and each check prints their share.)
# * sm90, bf16, against flash_attention_sm90_plain (the same rounding of p,
#   the same 128-key tiles): one ulp of the output, 2**-7, and an atol of
#   2**-10 max|v|, for the rare p whose bf16 rounding flips between the two
#   because they sum the f32 scores in other orders (each flip moves an
#   output by 2**-8 (p / l)|v|; a CPU emulation with scores perturbed by
#   2**-20 of themselves, B 2, Hq 20, S 512, put the worst excess over
#   2**-7 |want| at 2**-11.9 max|v|).  A late causal row's outputs are about
#   0.05 at N(0, 1) inputs, so an error of a tenth of one of them fails.
# * sm90 at head dim 256 the same: its 64-key tiles change where the
#   softmax rescales, not how p is rounded, and the emulation follows the
#   tile (sm90_tile).  At head dims 16 and 32 the same again: they run the
#   d 64 instantiation, whose columns past d load as zeros and add nothing;
#   and at head dim 80, which runs the d 128 one the same way.
# * cuda_core, f32: the online and the dense softmax sum in other orders;
#   at every head dim, whose columns past d (to the instantiation) load as
#   zeros and add nothing.
# * sm90 at head dims 96 and 100 the same as at 80: the d 128 instantiation,
#   zeros past d (d 100 padded by the wrapper to a row of 104).
# * past head dim 256 each source's wide kernel, the same tolerances: in
#   bf16 the same numerics (p rounded to bf16 for P.V) on the tiles that
#   sm90_tile gives (64 keys at the d 320 instantiation, 32 past it), which
#   the emulation follows; in f32 the online softmax as at cuda_core; past
#   512 each column slice computes the same scores over the whole row.
ATTN_TOL = {("sm90", torch.bfloat16): (2 ** -7, 2 ** -8),
            ("cuda_core", torch.float32): (2e-5, 2e-5)}
SM90_EMULATION_TOL = (2 ** -7, 2 ** -10)       # atol in units of max|v|
OLD_BF16_ATOL = 2e-3
# (dtype, sequence length, causal, head dim, query heads, kv heads): the
# serving shape in bf16 and f32, a ragged prompt (padded by ops.mha), full
# attention, a length that is a multiple of 64 but not of 128 (the
# tensor-core kernel's half-empty query tile), head dim 64, bf16 at head
# dim 256 (the tensor-core kernel's 64-key tiles) at the serving heads and
# at paligemma-3b's (8 query heads on 1 kv head: 128 units for 132 SMs),
# bf16 at head dims 32 and 16 (the d 64 instantiation, zeros past d) and at
# zamba2-2.7b's head dim 80 (the d 128 instantiation, zeros past d), and at
# 96 and 100 (d 128 too; 100 padded to a row of 104 for TMA); f32 full
# attention and f32 at head dims 64, 80 (zamba2-2.7b's, the d 128
# instantiation) and 256 (64-row query tiles, 32-key tiles); f32 at head
# dim 16 (the d 32 instantiation, the only one that reads V as float2)
# at the serving heads and at the f32 smoke run's own prefill (6 query
# heads on 2 kv heads, a ragged 100-token prompt), and f32 at head dims 3
# and 78, no multiple of 4, which the wrapper pads to rows of 4 and 80
# (the d 32 and d 128 instantiations); past 256, in bf16 and f32, both
# sources' wide kernels at head dim 320 causal and full, 300 (bf16's row
# padded to 304), 384 and 512 (32-key tiles in bf16) causal, 512 full, and
# 640 causal (two column slices of the d 320 instantiation, each reading q
# and k in two chunks); and bf16 at the heads of the served moe and hybrid
# models (32 query heads on 4 kv heads at d 128, 32 on 32 at d 80), of
# musicgen-large (32 on 32 at d 64) and of internlm2-1.8b, served from its
# checkpoint in phase 7 (16 on 8 at d 128).  A seventh entry is a prefix of P
# positions (the prefix-LM mask, causal past it): paligemma-3b's served
# prefill (8 on 1 at d 256, 256 patches and 512 text positions, P 256 on
# a 64-key tile edge), P = S, P inside a kv tile at a length that is no
# multiple of 128, a ragged prompt with P 100, P 192 inside a 128-key tile
# at d 64; in f32 the smoke configs' own prefill (4 on 1 and 4 on 4 at
# d 16, P 8, the ragged 108 positions of 8 patches and 100 tokens) and
# P 256 at d 64 at the serving heads.
SERVE_HEADS = (ATTN["hq"], ATTN["hkv"])
MOE_HEADS = (32, 4)             # qwen3-moe-30b-a3b: a GQA group of 8, d 128
ZAMBA2_HEADS = (32, 32)         # zamba2-2.7b's shared block: d 80, no GQA
MUSICGEN_HEADS = (32, 32)       # musicgen-large: d 64, no GQA
INTERNLM2_HEADS = (16, 8)       # internlm2-1.8b (phase 7): d 128, group 2
WIDE_DIMS = (300, 384, 512, 640)     # past 256, beside d 320 (row 6c)
PALIGEMMA_HEADS = (8, 1)
PALIGEMMA_S = 256 + 512         # its 256 patches ahead of a 512-token prompt
SMOKE_HEADS = (6, 2)            # phase 5's qwen3-14b-smoke overrides
ATTN_CASES = ((torch.bfloat16, 512, True, 128, *SERVE_HEADS),
              (torch.float32, 512, True, 128, *SERVE_HEADS),
              (torch.bfloat16, 500, True, 128, *SERVE_HEADS),
              (torch.float32, 500, True, 128, *SERVE_HEADS),
              (torch.bfloat16, 512, False, 128, *SERVE_HEADS),
              (torch.bfloat16, 448, True, 128, *SERVE_HEADS),
              (torch.bfloat16, 512, True, 64, *SERVE_HEADS),
              (torch.bfloat16, 512, True, 256, *SERVE_HEADS),
              (torch.bfloat16, 512, True, 256, *PALIGEMMA_HEADS),
              (torch.bfloat16, 512, True, 32, *SERVE_HEADS),
              (torch.bfloat16, 512, True, 16, *SERVE_HEADS),
              (torch.bfloat16, 512, True, 80, *SERVE_HEADS),
              (torch.bfloat16, 512, True, 96, *SERVE_HEADS),
              (torch.bfloat16, 512, True, 100, *SERVE_HEADS),
              (torch.float32, 512, False, 128, *SERVE_HEADS),
              (torch.float32, 512, True, 64, *SERVE_HEADS),
              (torch.float32, 512, True, 80, *SERVE_HEADS),
              (torch.float32, 512, True, 256, *SERVE_HEADS),
              (torch.float32, 512, True, 16, *SERVE_HEADS),
              (torch.float32, 100, True, 16, *SMOKE_HEADS),
              (torch.float32, 512, True, 3, *SERVE_HEADS),
              (torch.float32, 512, True, 78, *SERVE_HEADS),
              (torch.bfloat16, 512, True, 320, *SERVE_HEADS),
              (torch.bfloat16, 512, False, 320, *SERVE_HEADS),
              (torch.float32, 512, True, 320, *SERVE_HEADS),
              (torch.float32, 512, False, 320, *SERVE_HEADS),
              *((dtype, 512, True, d, *SERVE_HEADS)
                for d in WIDE_DIMS
                for dtype in (torch.bfloat16, torch.float32)),
              (torch.bfloat16, 512, False, 512, *SERVE_HEADS),
              (torch.float32, 512, False, 512, *SERVE_HEADS),
              (torch.bfloat16, 512, True, 128, *MOE_HEADS),
              (torch.bfloat16, 512, True, 128, *INTERNLM2_HEADS),
              (torch.bfloat16, 512, True, 80, *ZAMBA2_HEADS),
              (torch.bfloat16, 512, True, 64, *MUSICGEN_HEADS),
              (torch.bfloat16, PALIGEMMA_S, True, 256, *PALIGEMMA_HEADS, 256),
              (torch.bfloat16, 512, True, 256, *PALIGEMMA_HEADS, 512),
              (torch.bfloat16, 448, True, 256, *PALIGEMMA_HEADS, 200),
              (torch.bfloat16, 500, True, 256, *PALIGEMMA_HEADS, 100),
              (torch.bfloat16, 512, True, 64, *MUSICGEN_HEADS, 192),
              (torch.float32, 108, True, 16, 4, 1, 8),
              (torch.float32, 108, True, 16, 4, 4, 8),
              (torch.float32, 512, True, 64, *SERVE_HEADS, 256))
# The rows of the kernels line that these cases give, by (head dim, dtype)
# at the serving heads, length and causal mask; the cases at a served
# model's own heads add their numbers to their row's ``shapes``.
ATTN_ROWS = {(128, torch.bfloat16): "mha", (128, torch.float32): "mha_f32",
             (64, torch.bfloat16): "mha_d64",
             (256, torch.bfloat16): "mha_d256", (32, torch.bfloat16): "mha_d32",
             (80, torch.bfloat16): "mha_d80", (100, torch.bfloat16): "mha_d100",
             (80, torch.float32): "mha_f32_d80",
             (256, torch.float32): "mha_f32_d256",
             (16, torch.float32): "mha_f32_d16",
             (320, torch.bfloat16): "mha_wide",
             (320, torch.float32): "mha_wide_f32",
             **{(d, dtype): f"mha_{'f32_' if dtype == torch.float32 else ''}"
                            f"d{d}"
                for d in WIDE_DIMS
                for dtype in (torch.bfloat16, torch.float32)}}
# The cases at a served model's own shape, (head dim, dtype, query heads,
# kv heads, length, prefix) -> the row they add to.
SERVED_HEAD_ROWS = {(128, torch.bfloat16, *MOE_HEADS, 512, 0): "mha",
                    (128, torch.bfloat16, *INTERNLM2_HEADS, 512, 0): "mha",
                    (80, torch.bfloat16, *ZAMBA2_HEADS, 512, 0): "mha_d80",
                    (64, torch.bfloat16, *MUSICGEN_HEADS, 512, 0): "mha_d64",
                    (256, torch.bfloat16, *PALIGEMMA_HEADS, PALIGEMMA_S,
                     256): "mha_d256"}
# WKV6 in f32: 64-term dot products and 32-step chunk sums in other
# orders; errors scale with the largest output.
WKV_RTOL = 1e-4


def _attn_work(b, hq, hkv, s, d, elem, causal=True,
               prefix=0) -> tuple[int, int]:
    """Bytes (q, k, v read once, o written once) and operations (a multiply
    and an add for each q.k and p.v term of the attended pairs: the causal
    triangle, and with a prefix of P the P (P - 1) / 2 pairs above the
    diagonal within it)."""
    pairs = s * (s + 1) // 2 + prefix * (prefix - 1) // 2 if causal \
        else s * s
    return elem * (2 * b * s * hq * d + 2 * b * s * hkv * d), \
        4 * d * pairs * b * hq


def _wkv_work(b, t, h, k, chunk) -> tuple[int, int]:
    """Bytes (r, k, w, v, u read once, y and the state written once) and
    operations per (b, h, chunk): the state read and carry (2 x 2CKV), the
    pairwise weights (C(C-1)/2 x 4K, the exp counted as one), their product
    with v (C(C-1)V) and the diagonal bonus (3CK + 2CV), with V = K."""
    v = k
    nbytes = 4 * (3 * b * t * h * k + 2 * b * t * h * v + h * k
                  + b * h * k * v)
    per_chunk = (4 * chunk * k * v + chunk * (chunk - 1) // 2 * 4 * k
                 + chunk * (chunk - 1) * v + 3 * chunk * k + 2 * chunk * v)
    return nbytes, b * h * (t // chunk) * per_chunk


def phase_llm_kernels(floor: dict) -> dict:
    import torch.nn.functional as F

    from repro_torch.core.probes.runners import random_cycle
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (
        BY_HEAD_DIM, BY_PREFIX, SOURCES, column_slices, flash_attention_plain,
        flash_attention_sm90_plain, instantiation, kernel_for, mask,
        row_width)
    from repro_torch.kernels.pchase_probe import (pchase_plain,
                                                  pchase_reference)
    from repro_torch.kernels.rwkv6_scan import CHUNK as WKV_CHUNK
    from repro_torch.kernels.rwkv6_scan import KERNELS as WKV_KERNELS
    from repro_torch.kernels.rwkv6_scan import head_size, wkv6_plain

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = {}

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    b = ATTN["b"]
    for dtype, seq, causal, d, hq, hkv, *extra in ATTN_CASES:
        prefix = extra[0] if extra else 0
        q = randn(b, seq, hq, d, dtype=dtype)
        k, v = (randn(b, seq, hkv, d, dtype=dtype) for _ in range(2))
        route = kernel_for(dtype, d)
        counts, by_p = BY_HEAD_DIM[route], BY_PREFIX[route]
        by_d, before_p = dict(counts), dict(by_p)

        def call():
            return ops.mha(q, k, v, causal=causal, prefix_len=prefix)

        got = call()
        torch.cuda.synchronize()
        want = flash_attention_plain(q, k, v, causal, prefix)
        check(counts == {**by_d, d: by_d.get(d, 0) + 1},
              f"mha d={d}: the {route} kernel's count by head dim rose "
              f"at {[x for x in counts if counts[x] != by_d.get(x)]}")
        check(by_p == {**before_p, prefix: before_p.get(prefix, 0) + 1},
              f"mha d={d} P={prefix}: the {route} kernel's count by prefix "
              f"rose at {[x for x in by_p if by_p[x] != before_p.get(x)]}")
        rtol, atol = ATTN_TOL[(route, dtype)]
        vmax = float(v.float().abs().max())
        if dtype == torch.bfloat16:
            atol *= vmax
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        old_refused = float((diff > OLD_BF16_ATOL + rtol * want.float().abs())
                            .float().mean())
        slices, _ = column_slices(dtype, d)
        kernel = (f"{route} kernel at its d {instantiation(dtype, d)} "
                  f"instantiation"
                  + (f", {slices} column slices" if slices > 1 else ""))
        shape = (f"B={b},Hq={hq},Hkv={hkv},S={seq},d={d},"
                 f"{str(dtype).split('.')[-1]},"
                 + (f"prefix-LM P={prefix}" if prefix
                    else "causal" if causal else "full"))
        check(got.dtype == dtype and got.shape == q.shape,
              f"mha {shape}: {got.dtype} {tuple(got.shape)}")
        check(torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol),
              f"mha {shape}: max_abs_err {err} beyond rtol={rtol:g}, "
              f"atol={atol:g}")
        emulated = ""
        if dtype == torch.bfloat16:
            e_rtol, e_atol = SM90_EMULATION_TOL
            e_atol *= vmax
            emu = flash_attention_sm90_plain(q, k, v, causal,
                                             prefix).float()
            e_diff = (got.float() - emu).abs()
            excess = float((e_diff - e_rtol * emu.abs()).max())
            check(bool((e_diff <= e_rtol * emu.abs() + e_atol).all()),
                  f"mha {shape}: against the emulation of its numerics, "
                  f"max_abs_err {float(e_diff.max())}, largest excess over "
                  f"rtol {e_rtol:g} {excess:g} beyond atol {e_atol:g}")
            late = float(e_diff[:, seq // 2:].max())
            emulated = (f"; against flash_attention_sm90_plain rtol="
                        f"{e_rtol:g} atol={e_atol:g} ok (max_abs_err="
                        f"{float(e_diff.max()):g}, largest excess over rtol "
                        f"{excess:g}, in rows >= S/2 {late:g})")
            del emu, e_diff
        k_ms = event_ms(call)
        p_ms = event_ms(lambda: flash_attention_plain(q, k, v, causal,
                                                      prefix), reps=5)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        # the library's yardstick: SDPA with is_causal, or with the
        # prefix-LM mask as a boolean mask
        keep = mask(seq, seq, causal, prefix, q.device) if prefix else None

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=keep, is_causal=causal and not prefix,
                enable_gqa=True)

        l_ms = event_ms(library)
        nbytes, n_ops = _attn_work(b, hq, hkv, seq, d, q.element_size(),
                                   causal, prefix)
        b_ms, b_by = bound_ms(nbytes, n_ops, BF16_OPS_PER_S
                              if dtype == torch.bfloat16 else FP32_OPS_PER_S)
        old = (f"; share beyond the old atol {OLD_BF16_ATOL:g}: "
               f"{old_refused:.2e}" if route == "sm90" else "")
        print(f"[llm] mha {shape} ({kernel}): rtol={rtol:g} "
              f"atol={atol:g} ok (max_abs_err={err:g}{old}){emulated}; "
              f"kernel_ms={k_ms:.4f} ({n_ops / k_ms / 1e9:.1f} TFLOP/s, "
              f"{b_ms / k_ms:.3f} of the bound) bound_ms={b_ms:.6f} "
              f"({b_by}) plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
              f"(scaled_dot_product_attention)")
        row = dict(shape=shape, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                   bound_by=b_by, library_ms=l_ms, max_abs_err=err,
                   source=SOURCES[route])
        served = SERVED_HEAD_ROWS.get((d, dtype, hq, hkv, seq, prefix))
        if (seq == ATTN["s"] and causal) or served:
            # the kernel's device time beside SDPA's (a row that is no
            # multiple of 16 bytes adds the wrapper's padding copies)
            dev = device_ms({
                "kernel": (call, 1 if row_width(dtype, d) == d else None),
                "library": (library, None)})
            row["device_ms"] = dev["kernel"]
            row["library_device_ms"] = dev["library"]
            clock = ""
            if route == "cuda_core" and d == ATTN["d"]:
                # the FFMA-bound kernel's SM clock against the 1980 MHz
                # its 67 TFLOP/s bound assumes
                smi = smi_beside(lambda: ops.mha(q, k, v, causal=causal))
                row["clocks_sm_mhz"] = smi["clocks_sm_mhz"]
                clock = (f"; SM clock {smi['clocks_sm_mhz']:.0f} MHz, "
                         f"{smi['power_draw_w']:.0f} W of "
                         f"{smi['power_limit_w']:.0f} W while it runs")
            print(f"[llm] mha {shape}: device_ms={row['device_ms']:.4f} "
                  f"({n_ops / row['device_ms'] / 1e9:.1f} TFLOP/s, "
                  f"{b_ms / row['device_ms']:.3f} of the bound); "
                  f"scaled_dot_product_attention device_ms="
                  f"{row['library_device_ms']:.4f}{clock}")
        name = ATTN_ROWS.get((d, dtype))
        if seq == ATTN["s"] and causal and not prefix \
                and hq == ATTN["hq"] and name:
            rows[name] = row
        if served:
            rows[served].setdefault("shapes", {})[shape] = {
                key: row[key] for key in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "library_device_ms", "max_abs_err")}
        del q, k, v, qt, kt, vt, got, want, diff, keep

    b, h, kd, chunk = (WKV[x] for x in ("b", "h", "k", "chunk"))
    errs = []
    for t, strong in ((WKV["t"], False), (500, False), (WKV["t"], True)):
        r, k, v = (randn(b, t, h, kd) for _ in range(3))
        if strong:
            # the model's decays, w = exp(-exp(x)) (models/rwkv6.py), at
            # x ~ U(-6, 2.5): w from 5e-6 to 0.9975, -L over a chunk in the
            # hundreds, where e^{-L} overflows float32
            x = torch.rand((b, t, h, kd), generator=gen, device="cuda")
            w = torch.exp(-torch.exp(x * 8.5 - 6.0))
        else:
            w = torch.rand((b, t, h, kd), generator=gen, device="cuda") \
                * 0.93 + 0.05                          # decays in (0.05, 0.98)
        u = randn(h, kd)
        y, st = ops.wkv6(r, k, v, w, u, chunk=chunk)
        torch.cuda.synchronize()
        # the plain version on the wrapper's padding: r = k = v = 0, w = 1
        extra = (0, 0, 0, 0, 0, -t % chunk)
        padded = [F.pad(x, extra, value=1.0 if x is w else 0.0)
                  for x in (r, k, v, w)]
        y_p, st_p = wkv6_plain(*padded, u, chunk)
        y_p = y_p[:, :t]
        shape = (f"B={b},T={t},H={h},K=V={kd},chunk={chunk},f32"
                 + (",strong decays" if strong else ""))
        err = max(float((y - y_p).abs().max()), float((st - st_p).abs().max()))
        errs.append(err)
        check(bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all()),
              f"wkv6 {shape}: values that are not finite")
        for got, want, name in ((y, y_p, "y"), (st, st_p, "state")):
            atol = WKV_RTOL * float(want.abs().max())
            check(torch.allclose(got, want, rtol=WKV_RTOL, atol=atol),
                  f"wkv6 {shape}: {name} max_abs_err "
                  f"{float((got - want).abs().max())} beyond rtol {WKV_RTOL},"
                  f" atol {atol}")
        if strong:
            neg_l = float(-torch.log(w.double()).reshape(
                b, t // chunk, chunk, h, kd).sum(2).min())
            print(f"[llm] wkv6 {shape}: rtol {WKV_RTOL} ok (max_abs_err="
                  f"{err:g}); finite; largest -L_C of a chunk {neg_l:.1f}")
            del r, k, v, w, u, y, st, y_p, st_p, padded, x
            continue
        k_ms = event_ms(lambda: ops.wkv6(r, k, v, w, u, chunk=chunk))
        p_ms = event_ms(lambda: wkv6_plain(*padded, u, chunk), reps=5)
        nbytes, n_ops = _wkv_work(b, t, h, kd, chunk)
        b_ms, b_by = bound_ms(nbytes, n_ops)
        device = ""
        if t == WKV["t"]:
            # one call is the pair of kernels and nothing else (a ragged T
            # adds the wrapper's padding: a fill and a copy a tensor)
            dev = device_ms({"kernel": (
                lambda: ops.wkv6(r, k, v, w, u, chunk=chunk),
                len(WKV_KERNELS))})["kernel"]
            device = (f" (device {dev:.4f}, {b_ms / dev:.3f} of the bound; "
                      f"{'+'.join(WKV_KERNELS)})")
            rows["wkv6"] = dict(shape=shape, ms=k_ms, plain_ms=p_ms,
                                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                                max_abs_err=err, device_ms=dev)
        print(f"[llm] wkv6 {shape}: rtol {WKV_RTOL} ok (max_abs_err={err:g})"
              f"; kernel_ms={k_ms:.4f}{device} bound_ms={b_ms:.6f} ({b_by}) "
              f"plain_ms={p_ms:.4f} library_ms=null")
        del r, k, v, w, u, y, st, y_p, st_p, padded
    # K != V (padded to K = V = 64 by the wrapper), the reference's chunk
    # 64 (the kernels run their own chunk 32), and K or V past 128 (split
    # by the wrapper into slices of at most 128, each run by the pair of
    # kernels), each against the plain version on the unsplit, unpadded
    # inputs at the caller's chunk
    for kd, vd, step in ((WKV["k"], WKV["k"] // 2, chunk),
                         (WKV["k"], WKV["k"], 64), (192, 192, chunk),
                         (160, 96, chunk)):
        r, k, w = (randn(b, WKV["t"], h, kd) for _ in range(3))
        w = torch.sigmoid(w) * 0.93 + 0.05
        v, u = randn(b, WKV["t"], h, vd), randn(h, kd)
        y, st = ops.wkv6(r, k, v, w, u, chunk=step)
        torch.cuda.synchronize()
        y_p, st_p = wkv6_plain(r, k, v, w, u, step)
        shape = f"B={b},T={WKV['t']},H={h},K={kd},V={vd},chunk={step},f32"
        for got, want, name in ((y, y_p, "y"), (st, st_p, "state")):
            atol = WKV_RTOL * float(want.abs().max())
            check(got.shape == want.shape
                  and torch.allclose(got, want, rtol=WKV_RTOL, atol=atol),
                  f"wkv6 {shape}: {name} {tuple(got.shape)} max_abs_err "
                  f"{float((got - want).abs().max())} beyond rtol "
                  f"{WKV_RTOL}, atol {atol}")
        err = max(float((y - y_p).abs().max()),
                  float((st - st_p).abs().max()))
        errs.append(err)
        slices = [(min(128, kd - k0), min(128, vd - v0))
                  for k0 in range(0, kd, 128) for v0 in range(0, vd, 128)]
        runs = ", ".join(f"K {a} V {b_} at K = V = {head_size(a, b_)}"
                         for a, b_ in slices)
        timing = ""
        if len(slices) > 1:
            k_ms = event_ms(lambda: ops.wkv6(r, k, v, w, u, chunk=step))
            p_ms = event_ms(lambda: wkv6_plain(r, k, v, w, u, step), reps=5)
            timing = f"; kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f}"
        print(f"[llm] wkv6 {shape}: rtol {WKV_RTOL} ok (max_abs_err={err:g})"
              f"; the kernels on {len(slices)} slice(s): {runs}, chunk "
              f"{WKV_CHUNK}{timing}")
        del r, k, v, w, u, y, st, y_p, st_p
    rows["wkv6"]["max_abs_err"] = max(errs)

    rng = np.random.default_rng(1)
    n = 1 << 19
    floors, l1, l2 = floor["floors"], floor["l1_bytes"], floor["l2_bytes"]
    for wraps, perm, cycle in ((False, random_cycle(n, rng), n),
                               (True, _wrapping_row(n, rng), 1025)):
        p_t = torch.from_numpy(perm).cuda()
        got = ops.pchase(p_t, iters=STEPS)
        torch.cuda.synchronize()
        want = pchase_plain(p_t, STEPS)
        ref = pchase_reference(perm, STEPS)
        check(torch.equal(got, want) and tuple(got.tolist()) == ref,
              f"pchase N=2^19 wraps={wraps}: {got.tolist()} vs plain "
              f"{want.tolist()} and reference {ref}")
        check(ref[1] < 0 or not wraps, f"pchase: the wrapping row {ref} "
              f"did not wrap")
        shape = f"N=2^19,iters={STEPS}" + (",wrapping" if wraps else "")

        def chase():
            return ops.pchase(p_t, iters=STEPS)

        k_ms = event_ms(chase)
        # the call's device time: the chase and the fill of its steps entry
        dev = device_ms({"pchase": (chase, None)})["pchase"]
        p_ms = event_ms(lambda: pchase_plain(p_t, STEPS), reps=5)
        b_ms, level = latency_bound_ms([STEPS], [4 * cycle], floors, l1, l2)
        per = _per_load(dev, STEPS, smi_beside(chase), floors[level])
        print(f"[llm] pchase {shape}: exact; kernel_ms={k_ms:.4f} device_ms="
              f"{dev:.4f} per_load_ns={per['per_load_ns']:.2f} "
              f"({per['per_load_cycles']:.1f} cyc at "
              f"{per['clocks_sm_mhz']:.0f} MHz) against the floor's "
              f"{floors[level]:.2f} at {level} ({per['over_floor']:.3f}x); "
              f"bound_ms={b_ms:.6f} (latency) "
              f"plain_ms={p_ms:.3f} library_ms=null")
        if not wraps:
            rows["pchase"] = dict(shape=shape, ms=k_ms, device_ms=dev,
                                  plain_ms=p_ms, bound_ms=b_ms,
                                  bound_by="latency", bound_level=level,
                                  library_ms=None,
                                  max_abs_err=0, **per)
    torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------------------
# Phase 5: token serving at full width
# --------------------------------------------------------------------------
SERVE = dict(requests=8, prompt_len=512, max_new=16, max_len=640, slots=4)
# The served models, full width and depth, and the wrapper each one's
# prefill launches: dense, ssm, moe, hybrid, audio and vlm (whose 256
# patches go ahead of the 512-token prompt, max_len 784).
SERVED = (("qwen3-14b", "mha"), ("rwkv6-3b", "wkv6"),
          ("qwen3-moe-30b-a3b", "mha"), ("zamba2-2.7b", "mha"),
          ("musicgen-large", "mha"), ("paligemma-3b", "mha"))
# The float32 smoke configs held on the card to the CPU (a GQA group of 3
# for the dense one, as the CPU tests run it).
SMOKE_CONFIGS = (("qwen3-14b-smoke", dict(n_heads=6, n_kv_heads=2)),
                 ("rwkv6-3b-smoke", {}), ("qwen3-moe-30b-a3b-smoke", {}),
                 ("zamba2-2.7b-smoke", {}), ("musicgen-large-smoke", {}),
                 ("paligemma-3b-smoke", {}))
# Smoke configs on the card against the CPU, float32 on both: the CPU runs
# the plain versions, the card the kernels and cuBLAS in full float32; the
# sums differ in order only.
SMOKE_TOL = 1e-4
SPANS = ("serve.prefill", "serve.decode_step")    # the engine's spans
TOP_KERNELS = 6


def _profile_wave(arch: str, eng, prompts, unprofiled: dict) -> dict | None:
    """One more run of a warm wave under ``torch.profiler``: the device's
    busy time (the sum of its kernels and copies; one stream, so they do not
    overlap) in the prefill and in the decode steps, each against the
    unprofiled wave's wall for that part.  The engine's prefill and each of
    its decode steps end where the sampled tokens reach the host, so the
    device is idle there: the marker kernel queued after each sampling
    splits the device's events into the prefill's and each step's, in the
    order the device ran them.  Returns, for each part, the device events
    by name: (microseconds, count); None when the session's events do not
    split into the wave's parts."""
    from torch.profiler import ProfilerActivity, profile

    marker = _marker_name()
    sample = eng._sample

    def sample_then_mark(logits, rng):
        out = sample(logits, rng)
        mark()
        return out

    eng._sample = sample_then_mark
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            lead_in()
            again = eng.generate_batch(prompts, SERVE["max_new"])
            torch.cuda.synchronize()
    finally:
        del eng._sample
    check(np.array_equal(again, unprofiled["tokens"]),
          f"{arch}: the profiled wave gave other tokens")
    spans = {name: sum(e.name == name and e.device_type ==
                       torch.autograd.DeviceType.CPU for e in prof.events())
             for name in SPANS}
    check(spans == {"serve.prefill": 1,
                    "serve.decode_step": SERVE["max_new"] - 1},
          f"{arch}: spans {spans}")
    events = _device_events(prof)
    steps = marked_parts(events, marker, SERVE["max_new"])
    if steps is None or not all(steps):
        print(f"[profile] {arch}: device events in the parts between "
              f"markers {[len(part) for part in split_at_marks(events, marker)]}"
              f", expected {SERVE['max_new']} parts that are not empty after "
              f"the lead-in and none after the last marker")
        return None
    parts = {}
    for part, mine in (("prefill", steps[0]),
                       ("decode", [ev for step in steps[1:] for ev in step])):
        busy = sum(us for _, us in mine) / 1e6
        by_name = {}
        for name, us_one in mine:
            us, n = by_name.get(name, (0.0, 0))
            by_name[name] = (us + us_one, n + 1)
        wall = unprofiled[part]
        print(f"[profile] {arch} {part} (warm wave, "
              f"{1 if part == 'prefill' else len(steps) - 1} part(s)): wall "
              f"{wall:.4f}s unprofiled; device busy {busy:.4f}s; idle share "
              f"{1 - busy / wall:.3f}; device events {len(mine)}")
        for kname, (us, n) in sorted(by_name.items(),
                                     key=lambda kv: -kv[1][0])[:TOP_KERNELS]:
            print(f"[profile]   {us / 1e3:9.3f} ms {us / 1e6 / busy:6.3f} of "
                  f"busy {n:6d}x {kname[:100]}")
        parts[part] = by_name
    return parts


def _max_len(cfg) -> int:
    """``SERVE``'s max_len, or what a vlm's patches, prompt and new tokens
    take where that is more."""
    return max(SERVE["max_len"],
               cfg.n_patches + SERVE["prompt_len"] + SERVE["max_new"])


def _serve_argv(cfg) -> list[str]:
    return ["--arch", cfg.name, "--requests", str(SERVE["requests"]),
            "--prompt-len", str(SERVE["prompt_len"]), "--max-new",
            str(SERVE["max_new"]), "--max-len", str(_max_len(cfg)),
            "--slots", str(SERVE["slots"]), "--dtype", "bfloat16"]


def _output_shape(cfg) -> tuple:
    """A request's generation: (new,), or (new, K) for audio."""
    new = SERVE["max_new"]
    return (new, cfg.n_codebooks) if cfg.family == "audio" else (new,)


def _to_card(tree):
    """A parameter tree (dictionaries and lists of tensors, nested) with
    every tensor copied to the card."""
    if isinstance(tree, dict):
        return {name: _to_card(sub) for name, sub in tree.items()}
    if isinstance(tree, list):
        return [_to_card(sub) for sub in tree]
    return tree.cuda()


def _numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(_numel(sub) for sub in tree.values())
    if isinstance(tree, list):
        return sum(_numel(sub) for sub in tree)
    return tree.numel()


def _attention_per_wave(cfg) -> int:
    """``mha`` calls of one prefill: one a layer, or one a site of zamba2's
    shared block."""
    from repro_torch.models.zamba2 import n_sites

    return n_sites(cfg) if cfg.family == "hybrid" else cfg.n_layers


def _smoke_agreement(arch: str, overrides: dict) -> float:
    """Prefill and two decode steps of a float32 smoke config on the card
    and on the CPU, on the same weights, in the family's batch layout
    (audio (2, K, 100) codebook ids and (2, K, 1) steps; vlm 8 patches
    ahead of 100 tokens); the largest logit difference."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model

    cfg = get_config(arch).replace(dtype="float32", **overrides)
    model = get_model(cfg)
    cpu = model.init(seed=0, device="cpu")
    card = _to_card(cpu)
    rng = np.random.default_rng(2)
    width = (cfg.n_codebooks,) if cfg.family == "audio" else ()
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, *width, 100)))}
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_patches, cfg.vision_embed_dim), dtype=np.float32))
    steps = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                          (2, 2, *width, 1)))
    worst = 0.0
    with torch.no_grad():
        outs = {}
        for dev, params in (("cpu", cpu), ("cuda", card)):
            logits, cache = model.prefill(
                params, {name: t.to(dev) for name, t in batch.items()}, 128)
            seq = [logits.cpu()]
            for tok in steps:
                logits, cache = model.decode_step(
                    params, {"tokens": tok.to(dev)}, cache)
                seq.append(logits.cpu())
            outs[dev] = seq
    for a, b in zip(outs["cpu"], outs["cuda"]):
        worst = max(worst, float((a - b).abs().max()))
        check(torch.allclose(b, a, rtol=SMOKE_TOL, atol=SMOKE_TOL),
              f"{arch}: card logits differ from the CPU's by "
              f"{float((a - b).abs().max())}")
    return worst


MOE_PARTS = ("routing", "dispatch", "experts", "combine")


def _moe_marked(cfg, run) -> tuple[dict, list] | None:
    """Run ``run`` (a prefill or a decode step of a moe model) under
    ``torch.profiler`` with the model's moe FFN split into its parts
    (``MOE_PARTS``: the router GEMM, the top-k sort, the sort of the pairs
    by expert and the group starts; the scatter into the (E, C, d) buffer;
    the three batched expert GEMMs; the gather back, the weights and the
    sum over k), each closed by a marker kernel, so the device's events
    split at the markers into each layer's parts.  Returns the device ms
    of each part summed over the layers, of ``other`` (all else) and of
    ``busy`` (all), and each layer's routing; None when the session does
    not split into the parts."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import moe, transformer

    marker = _marker_name()
    routings = []

    def marked(p, x, cfg_):
        bsz, seq, d = x.shape
        xt = x.reshape(bsz * seq, d)
        mark()
        r = moe.route(p, xt, cfg_)
        mark()
        buf = moe.dispatch(r, xt, cfg_)
        mark()
        out = moe.experts(p, buf)
        mark()
        y = moe.combine(r, out, cfg_)
        mark()
        routings.append(r)
        return y.reshape(bsz, seq, d), r.probs

    ffn, transformer.moe_ffn = transformer.moe_ffn, marked
    try:
        with torch.no_grad(), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            lead_in()
            run()
            mark()
            torch.cuda.synchronize()
    finally:
        transformer.moe_ffn = ffn
    per_layer = len(MOE_PARTS) + 1
    parts = marked_parts(_device_events(prof), marker,
                         per_layer * cfg.n_layers + 1)
    if parts is None:
        return None
    ms = {name: 0.0 for name in (*MOE_PARTS, "other")}
    for i, part in enumerate(parts):
        name = ("other", *MOE_PARTS)[i % per_layer] \
            if i < per_layer * cfg.n_layers else "other"
        ms[name] += sum(us for _, us in part) / 1e3
    ms["busy"] = sum(ms.values())
    return ms, routings


def _moe_report(eng, prompts) -> dict:
    """The moe FFN of the served model in a warm prefill wave and in its
    first decode step: the device time of each of its parts summed over
    the layers and their shares of the device's busy time
    (``_moe_marked``), and the pairs dropped by capacity in the first
    layer."""
    cfg = eng.model.cfg
    tokens = torch.as_tensor(prompts, dtype=torch.long, device=eng.device)
    params = eng.params       # plain tensors: the launcher ran with no mesh
    state = {}

    def prefill():
        state["logits"], state["cache"] = eng.model.prefill(
            params, {"tokens": tokens}, SERVE["max_len"])

    def decode():
        eng.model.decode_step(params, {"tokens": torch.argmax(
            state["logits"], dim=-1)[:, None]}, state["cache"])

    report = {}
    for part, run in (("prefill", prefill), ("decode step", decode)):
        for attempt in range(1, PROFILER_SESSIONS + 1):
            got = _moe_marked(cfg, run)
            if got is not None:
                SESSIONS["whole"] += 1
                break
            SESSIONS["retaken"] += 1
            print(f"[moe] {cfg.name} {part}: profiled session {attempt} of "
                  f"{PROFILER_SESSIONS} does not split into "
                  f"{len(MOE_PARTS) + 1} parts a layer")
        else:
            raise SmokeFailure(f"{cfg.name}: no whole profiled {part} with "
                               f"the moe parts marked")
        ms, routings = got
        check(len(routings) == cfg.n_layers,
              f"{cfg.name} {part}: {len(routings)} moe calls for "
              f"{cfg.n_layers} layers")
        first = routings[0]
        pairs = first.keep.numel()
        dropped = int((~first.keep).sum())
        print(f"[moe] {cfg.name} {part} ({pairs // cfg.moe_top_k} tokens, "
              f"top {cfg.moe_top_k} of {cfg.moe_experts}, capacity "
              f"{first.cap}): layer 0 dropped {dropped} of {pairs} pairs by "
              f"capacity; device ms over {cfg.n_layers} layers (share of "
              f"busy {ms['busy']:.3f} ms): "
              + ", ".join(f"{name} {ms[name]:.3f} "
                          f"({ms[name] / ms['busy']:.3f})"
                          for name in (*MOE_PARTS, "other")))
        report[part] = dict(ms, dropped=dropped, pairs=pairs, cap=first.cap)
        del routings, first
    return report


def _row_launches(by_head_dim: dict) -> dict:
    """The launches of each attention row of ``ATTN_ROWS`` but ``mha_f32``
    (whose count is the f32 smoke run's): its kernel's launches at its head
    dim."""
    from repro_torch.kernels.flash_attention import kernel_for

    return {name: by_head_dim[kernel_for(dtype, d)][d]
            for (d, dtype), name in ATTN_ROWS.items() if name != "mha_f32"}


def phase_serve() -> dict:
    """Returns the kernels' launch counts read around the serve runs: the
    wrappers' (the attention rows of ``ATTN_ROWS`` counted as their
    kernel's own launches at their head dim, ``mha`` the tensor-core
    kernel's at head dim 128 in qwen3-14b and qwen3-moe-30b-a3b,
    ``mha_d80`` at zamba2-2.7b's 80, ``mha_d64`` at musicgen-large's 64,
    ``mha_d256`` at paligemma-3b's 256, every one of those with its 256
    patches as the prefix) and, as ``mha_f32``, the CUDA-core attention
    kernel's launches in the qwen3-14b-smoke f32 run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import BY_HEAD_DIM, BY_PREFIX
    from repro_torch.kernels.flash_attention import LAUNCHES as ATTN_LAUNCHES
    from repro_torch.kernels.rwkv6_scan import KERNELS as WKV_KERNELS
    from repro_torch.launch import serve
    from repro_torch.serve.engine import stack

    torch.backends.cuda.matmul.allow_tf32 = False    # full f32 (smoke check)
    waves = -(-SERVE["requests"] // SERVE["slots"])
    launches = {"wkv6": 0, "pchase": 0,
                **{name: 0 for name in ATTN_ROWS.values()}}
    for arch, kernel in SERVED:
        cfg = get_config(arch)
        per_wave = _attention_per_wave(cfg) if kernel == "mha" \
            else cfg.n_layers
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        res = serve.main(_serve_argv(cfg))
        counts = {fn.__name__: fn.launches for fn in ops.LLM_WRAPPERS}
        routes = dict(ATTN_LAUNCHES)
        by_d = {route: dict(c) for route, c in BY_HEAD_DIM.items()}
        by_p = {route: dict(c) for route, c in BY_PREFIX.items()}
        want = {"mha": 0, "wkv6": 0, "pchase": 0, kernel: per_wave * waves}
        check(counts == want == res["launches"],
              f"{arch}: launches {counts} (reported {res['launches']}), "
              f"expected {want}")
        # every mha call of a bf16 model is a launch of the tensor-core
        # kernel at the model's head dim (128, or zamba2's 80), counted
        # where it launches; no launch at another head dim or of the
        # CUDA-core kernel
        want_routes = {"sm90": want["mha"], "cuda_core": 0}
        want_by_d = {"sm90": ({cfg.resolved_head_dim: want["mha"]}
                              if want["mha"] else {}),
                     "cuda_core": {}}
        check(routes == want_routes and by_d == want_by_d,
              f"{arch}: attention kernel launches {routes}, by head dim "
              f"{by_d}; expected {want_routes}, {want_by_d}")
        # every call of the vlm's with its patches as the prefix, every
        # other model's with none
        want_by_p = {"sm90": ({cfg.n_patches: want["mha"]}
                              if want["mha"] else {}),
                     "cuda_core": {}}
        check(by_p == want_by_p,
              f"{arch}: attention kernel launches by prefix {by_p}; "
              f"expected {want_by_p}")
        counts.pop("mha")
        counts.update(_row_launches(BY_HEAD_DIM))
        for name, count in counts.items():
            launches[name] += count
        check(all(o.shape == _output_shape(cfg) for o in res["outputs"]),
              f"{arch}: not {_output_shape(cfg)} tokens for every request")
        eng = res["engine"]
        n_params = _numel(eng.params)
        print(f"[serve] {arch}: {cfg.n_layers} layers, {n_params / 1e9:.4f} "
              f"B parameters in bfloat16 ({cfg.param_count() / 1e9:.4f} B by "
              f"ModelConfig.param_count), "
              f"{n_params * 2 / 1e9:.2f} GB; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"wall {res['wall_s']:.3f}s, {res['tok_per_s']:.1f} tok/s "
              f"({res['new_tokens']} ids in {res['frames']} positions), "
              f"prefill {res['prefill_s']:.3f}s ({eng.stats['prefills']} "
              f"waves), decode {res['decode_s']:.3f}s "
              f"({eng.stats['decode_steps']} steps); launches {counts}; "
              f"attention kernels {routes}, by head dim {by_d}, by prefix "
              f"{by_p}")
        prompts = stack(res["requests"][:SERVE["slots"]])
        before = dict(eng.stats)
        again = eng.generate_batch(prompts, SERVE["max_new"])
        check(np.array_equal(again, np.stack(res["outputs"][:SERVE["slots"]])),
              f"{arch}: a second run of the first wave gave other tokens")
        # the wave's prefill goes through the tensor-core kernel once a
        # layer (or a site of zamba2's shared block), or through each WKV6
        # kernel once a layer; a profiled wave whose device events fall
        # short of that, or of its parts between markers, is taken again,
        # up to PROFILER_SESSIONS waves, as device_ms takes sessions
        names = (("flash_fwd_sm90_kernel",) if kernel == "mha"
                 else WKV_KERNELS)
        for attempt in range(1, PROFILER_SESSIONS + 1):
            parts = _profile_wave(arch, eng, prompts, {
                "tokens": again,
                "prefill": eng.stats["prefill_s"] - before["prefill_s"],
                "decode": eng.stats["decode_s"] - before["decode_s"]})
            ran = {name: sum(n for kname, (_, n) in parts["prefill"].items()
                             if name in kname)
                   for name in names} if parts else {}
            if ran and all(n == per_wave for n in ran.values()):
                SESSIONS["whole"] += 1
                break
            SESSIONS["retaken"] += 1
            print(f"[profile] {arch}: profiled wave {attempt} of "
                  f"{PROFILER_SESSIONS} not whole (kernels in its prefill "
                  f"{ran or 'not split'}, expected {per_wave} each)")
        else:
            raise SmokeFailure(f"{arch}: no whole profiled wave in "
                               f"{PROFILER_SESSIONS}")
        busy_ms = sum(us for us, _ in parts["prefill"].values()) / 1e3
        for name in names:
            name_ms = sum(us for kname, (us, _) in parts["prefill"].items()
                          if name in kname) / 1e3
            print(f"[profile] {arch}: {name} {ran[name]}x in the warm wave's "
                  f"prefill, device time {name_ms:.4f} ms "
                  f"({name_ms / ran[name]:.4f} ms each), "
                  f"{name_ms / busy_ms:.4f} of the prefill's device busy "
                  f"time {busy_ms:.3f} ms")
        if cfg.family == "moe":
            _moe_report(eng, prompts)
        with torch.no_grad():
            logits, _ = eng.model.prefill(eng.params, eng._batch(prompts),
                                          _max_len(cfg))
        width = (cfg.n_codebooks,) if cfg.family == "audio" else ()
        check(tuple(logits.shape) == (SERVE["slots"], *width,
                                      cfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"{arch}: logits {tuple(logits.shape)} not finite or misshapen")
        print(f"[serve] {arch}: greedy tokens of a second run of the first "
              f"wave equal; logits finite")
        del res, eng, logits
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    # the serve runs are bf16, so the CUDA-core attention kernel runs in
    # the f32 smoke configs' prefill on the card
    for arch, overrides in SMOKE_CONFIGS:
        ops.reset_launches()
        err = _smoke_agreement(arch, overrides)
        routes = dict(ATTN_LAUNCHES)
        smoke_cfg = get_config(arch).replace(**overrides)
        head_dim = smoke_cfg.resolved_head_dim
        f32_by_d = dict(BY_HEAD_DIM["cuda_core"])
        f32_by_p = dict(BY_PREFIX["cuda_core"])
        check(routes["sm90"] == 0 and routes["cuda_core"] == ops.mha.launches
              // 2 and f32_by_d == ({head_dim: routes["cuda_core"]}
                                    if routes["cuda_core"] else {})
              and f32_by_p == ({smoke_cfg.n_patches: routes["cuda_core"]}
                               if routes["cuda_core"] else {}),
              f"{arch}: attention kernel launches {routes}, f32 by head dim "
              f"{f32_by_d}, by prefix {f32_by_p}, for {ops.mha.launches} mha "
              f"calls (half of them on the CPU)")
        if get_config(arch).family != "ssm":
            check(routes["cuda_core"] > 0,
                  f"{arch}: the CUDA-core attention kernel never launched")
        if arch == "qwen3-14b-smoke":
            launches["mha_f32"] = routes["cuda_core"]
        for name, count in _row_launches(BY_HEAD_DIM).items():
            launches[name] += count
        print(f"[serve] {arch} float32 on the card vs the CPU: logits within "
              f"rtol=atol={SMOKE_TOL} (max_abs_err={err:g}); attention "
              f"kernel launches on the card {routes}, f32 by head dim "
              f"{f32_by_d}, by prefix {f32_by_p}")
    return launches


# --------------------------------------------------------------------------
# Phase 6: training (forward, train_loss, train/ and data/)
# --------------------------------------------------------------------------
TRAIN_SMOKE = dict(seq_len=64, global_batch=4, microbatches=2, steps=3)
TRAIN_LOSS_TOL = 1e-4        # relative, card against the CPU (float32)
TRAIN_GRAD_TOL = 1e-3        # of each gradient leaf's largest |value|
# internlm2-1.8b at full width and depth with the reference launcher's data
# and optimizer (src/repro/launch/train.py): ByteCorpus, AdamW, bf16 params
# with a float32 master, every layer recomputed in the backward pass
TRAIN_FULL = dict(arch="internlm2-1.8b", global_batch=8, seq_len=512,
                  microbatches=2, steps=8, lr=1e-3, warmup_steps=2,
                  total_steps=8, remat="full")
TRAIN_PEAK_BYTES = 80e9


def _smoke_data(cfg):
    from repro_torch.data import DataConfig, SyntheticLM

    audio, vlm = cfg.family == "audio", cfg.family == "vlm"
    return SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SMOKE["seq_len"],
        global_batch=TRAIN_SMOKE["global_batch"], seed=1,
        n_codebooks=cfg.n_codebooks if audio else 0,
        n_patches=cfg.n_patches if vlm else 0,
        vision_embed_dim=cfg.vision_embed_dim if vlm else 0))


def _loss_and_grads(model, params, batch, device):
    from repro_torch.train.optimizer import tree_leaves

    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = model.train_loss(params, {name: torch.from_numpy(x).to(device)
                                     for name, x in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.cpu() for g in grads]


def _train_smoke_agreement(arch: str, overrides: dict) -> dict:
    """A float32 smoke config's ``train_loss``, its gradients and three
    ``train_loop`` steps (two microbatches) on the card and on the CPU,
    from the same weights and ``SyntheticLM`` batches; returns the largest
    relative loss difference, gradient difference over its leaf's largest
    |value|, and step-loss difference."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.train import OptConfig, TrainConfig, train_loop
    from repro_torch.train.optimizer import init_opt_state, tree_map

    cfg = get_config(arch).replace(dtype="float32", **overrides)
    model = get_model(cfg)
    cpu = model.init(seed=0, device="cpu")
    card = _to_card(cpu)
    data = _smoke_data(cfg)
    batch = data.batch_at(0)
    loss_cpu, grads_cpu = _loss_and_grads(model, cpu, batch, "cpu")
    loss_card, grads_card = _loss_and_grads(model, card, batch, "cuda")
    loss_err = abs(loss_card - loss_cpu) / abs(loss_cpu)
    check(np.isfinite(loss_card) and loss_err <= TRAIN_LOSS_TOL,
          f"{arch}: train_loss on the card {loss_card} against the CPU's "
          f"{loss_cpu}")
    grad_err = 0.0
    for i, (a, b) in enumerate(zip(grads_cpu, grads_card)):
        scale = float(a.abs().max())
        err = float((a - b).abs().max())
        check(bool(torch.isfinite(b).all()) and err <= TRAIN_GRAD_TOL * scale
              + 1e-7, f"{arch}: gradient leaf {i} {tuple(a.shape)} differs "
                      f"by {err:g}, its largest |value| {scale:g}")
        grad_err = max(grad_err, err / max(scale, 1e-30))
    tc = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=1, total_steps=8),
                     microbatches=TRAIN_SMOKE["microbatches"])
    hists = {}
    for where, params in (("cpu", cpu), ("card", card)):
        params = tree_map(lambda t: t.detach().clone(), params)
        state = {"params": params, "opt": init_opt_state(params, tc.opt)}
        _, hist = train_loop(model, tc, data, TRAIN_SMOKE["steps"],
                             state=state)
        hists[where] = [m["loss"] for _, m in hist]
    step_err = max(abs(a - b) / abs(a)
                   for a, b in zip(hists["cpu"], hists["card"]))
    check(all(np.isfinite(hists["card"])) and step_err <= TRAIN_LOSS_TOL,
          f"{arch}: train_loop losses on the card {hists['card']} against "
          f"the CPU's {hists['cpu']}")
    return {"loss": loss_err, "grad": grad_err, "steps": step_err,
            "losses": hists["card"]}


def _profile_train_step(step_fn, state, batch) -> tuple[list, dict] | None:
    """One more train step under ``torch.profiler``, opened by ``lead_in``
    and closed by a marker: (the step's device events, the state), or None
    with the state when the session does not hold the step whole."""
    from torch.profiler import ProfilerActivity, profile

    marker = _marker_name()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lead_in()
        state, metrics = step_fn(state, batch)
        float(metrics["loss"])
        mark()
        torch.cuda.synchronize()
    parts = marked_parts(_device_events(prof), marker, 1)
    return (parts[0] if parts and parts[0] else None), state


def _train_full() -> dict:
    """internlm2-1.8b trained at full width and depth (``TRAIN_FULL``)
    through ``init_train_state`` and ``train_loop`` on the card; then one
    warm step profiled for the device's busy time and idle share."""
    from repro_torch.configs import get_config
    from repro_torch.data import ByteCorpus, DataConfig
    from repro_torch.models import Runtime, get_model
    from repro_torch.train import (OptConfig, TrainConfig, init_train_state,
                                   make_train_step, train_loop)
    from repro_torch.train.optimizer import tree_leaves

    run = TRAIN_FULL
    cfg = get_config(run["arch"])
    model = get_model(cfg)
    tc = TrainConfig(opt=OptConfig(lr=run["lr"],
                                   warmup_steps=run["warmup_steps"],
                                   total_steps=run["total_steps"]),
                     microbatches=run["microbatches"],
                     runtime=Runtime(remat=run["remat"]))
    data = ByteCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                 seq_len=run["seq_len"],
                                 global_batch=run["global_batch"]))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(model, 0, tc, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = _numel(state["params"])
    state_bytes = sum(t.numel() * t.element_size() for part in (
        state["params"], state["opt"]["m"], state["opt"]["v"],
        state["opt"]["master"]) for t in tree_leaves(part))
    print(f"[train] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}; {n_params / 1e9:.4f} B parameters "
          f"({cfg.param_count() / 1e9:.4f} B by ModelConfig.param_count) in "
          f"{tree_leaves(state['params'])[0].dtype} with a float32 "
          f"master; params + m + v + master {state_bytes / 1e9:.2f} GB; "
          f"init {init_s:.3f}s")
    step_fn = make_train_step(model, tc)
    state, hist = train_loop(model, tc, data, run["steps"], state=state,
                             step_fn=step_fn)
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for _, m in hist]
    times = [m["step_time_s"] for _, m in hist]
    tokens = run["global_batch"] * run["seq_len"]
    for step, m in hist:
        print(f"[train] {cfg.name} step {step}{' (first)' if step == 0 else ''}"
              f": loss {m['loss']:.6f} grad_norm {m['grad_norm']:.6f} lr "
              f"{m['lr']:.6g} wall {m['step_time_s']:.4f}s")
    warm = times[1:]
    tok_s = tokens * len(warm) / sum(warm)
    print(f"[train] {cfg.name}: batch {run['global_batch']} x "
          f"{run['seq_len']} tokens in {run['microbatches']} microbatches, "
          f"remat {run['remat']!r}; first step {times[0]:.4f}s; steps 2-"
          f"{run['steps']}: median {statistics.median(warm):.4f}s, "
          f"{tok_s:.1f} tokens/s; peak memory {peak / 2**30:.2f} GiB "
          f"({peak / 1e9:.2f} GB)")
    check(all(np.isfinite(losses)), f"{cfg.name}: losses {losses}")
    check(losses[-1] < losses[0],
          f"{cfg.name}: last loss {losses[-1]} not below the first "
          f"{losses[0]}")
    check(peak < TRAIN_PEAK_BYTES, f"{cfg.name}: peak memory {peak} bytes")
    batch = data.batch_at(run["steps"])
    for attempt in range(1, PROFILER_SESSIONS + 1):
        events, state = _profile_train_step(step_fn, state, batch)
        if events is not None:
            SESSIONS["whole"] += 1
            break
        SESSIONS["retaken"] += 1
        print(f"[profile] {cfg.name}: profiled train step {attempt} of "
              f"{PROFILER_SESSIONS} not whole")
    else:
        raise SmokeFailure(f"{cfg.name}: no whole profiled train step")
    busy = sum(us for _, us in events) / 1e6
    wall = statistics.median(warm)
    by_name = {}
    for name, us in events:
        total, n = by_name.get(name, (0.0, 0))
        by_name[name] = (total + us, n + 1)
    print(f"[profile] {cfg.name} train step (warm): wall {wall:.4f}s "
          f"unprofiled (median of steps 2-{run['steps']}); device busy "
          f"{busy:.4f}s; idle share {1 - busy / wall:.3f}; device events "
          f"{len(events)}")
    for name, (us, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:TOP_KERNELS]:
        print(f"[profile]   {us / 1e3:9.3f} ms {us / 1e6 / busy:6.3f} of "
              f"busy {n:6d}x {name[:100]}")
    result = {"params": n_params, "peak": peak, "losses": losses,
              "times": times, "tok_s": tok_s, "busy": busy, "wall": wall}
    del state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return result


def phase_train() -> dict:
    """Phase 6: the six smoke configs trained on the card against the CPU
    (``_train_smoke_agreement``), then internlm2-1.8b at full size
    (``_train_full``).  Training takes the reference's plain path, so no
    ``mha`` or ``wkv6`` kernel launches over the phase; an ``mha`` call on
    an input that requires grad is refused."""
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False    # full f32 (smoke check)
    torch.backends.cudnn.allow_tf32 = False
    ops.reset_launches()
    q = torch.randn(1, 64, 4, 64, device="cuda", requires_grad=True)
    kv = torch.randn(1, 64, 4, 64, device="cuda")
    try:
        ops.mha(q, kv, kv, causal=True)
    except RuntimeError as e:
        check("requires grad" in str(e), f"ops.mha refused with {e}")
    else:
        raise SmokeFailure("ops.mha ran on an input that requires grad")
    for arch, overrides in SMOKE_CONFIGS:
        err = _train_smoke_agreement(arch, overrides)
        print(f"[train] {arch} float32 on the card vs the CPU: train_loss "
              f"within {err['loss']:.3g} relative (tol {TRAIN_LOSS_TOL}), "
              f"gradients within {err['grad']:.3g} of each leaf's largest "
              f"(tol {TRAIN_GRAD_TOL}), {TRAIN_SMOKE['steps']} train_loop "
              f"steps' losses within {err['steps']:.3g} "
              f"({', '.join(f'{x:.6f}' for x in err['losses'])})")
    full = _train_full()
    launched = {fn.__name__: fn.launches for fn in ops.LLM_WRAPPERS}
    check(launched["mha"] == 0 and launched["wkv6"] == 0,
          f"training launched kernels: {launched}")
    print(f"[train] kernel launches over the phase: {launched} (training "
          f"takes the plain attention and WKV, as the reference does)")
    return full


# --------------------------------------------------------------------------
# Phase 7: checkpoint/, ft/ and launch/train.py; serving from a checkpoint
# --------------------------------------------------------------------------
# The reference launcher's run (src/repro/launch/train.py) at full width and
# depth: its ckpt_every=50 saves step 50; the resume trains on to 52.
CKPT_ARCH = "internlm2-1.8b"
CKPT_ARGV = ["--arch", CKPT_ARCH, "--seq", "64", "--global-batch", "8",
             "--remat", "full"]
CKPT_STEPS, CKPT_RESUME_STEPS = 50, 52
# bytes a parameter of a bf16 state with a float32 master: the parameter,
# then the master, m and v in float32
STATE_BYTES_PER_PARAM = 2 + 4 + 4 + 4
# the supervisor on the card: the reference's tiny setup in float32
FT = dict(arch="internlm2-1.8b-smoke", steps=10, ckpt_every=4, seed=7,
          seq_len=32, global_batch=8)
# where the card's default mode is not bit for bit (atomic accumulation in
# another order), the params' largest difference to an uninterrupted run,
# of each leaf's largest |value|; the restarts must then be bit for bit
# under torch.use_deterministic_algorithms
FT_TOL = 1e-2


def _mem_available() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise SmokeFailure("/proc/meminfo holds no MemAvailable")


def _leaves_bytes(leaves) -> int:
    return sum(t.numel() * t.element_size() for t in leaves)


def _ckpt_train(root: str) -> dict:
    """7a: ``launch.train.main`` at full size, saving step 50 under
    ``root``; disk and host memory must each hold twice the state."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.train.optimizer import tree_leaves

    state_bytes = get_config(CKPT_ARCH).param_count() * STATE_BYTES_PER_PARAM
    disk, host = shutil.disk_usage(root).free, _mem_available()
    print(f"[ckpt] {CKPT_ARCH} state about {state_bytes / 1e9:.2f} GB; free "
          f"disk under {root} {disk / 1e9:.2f} GB, host MemAvailable "
          f"{host / 1e9:.2f} GB")
    check(disk >= 2 * state_bytes,
          f"{disk / 1e9:.2f} GB free on the disk of {root}: the checkpoint "
          f"phase needs twice the state, {2 * state_bytes / 1e9:.2f} GB")
    check(host >= 2 * state_bytes,
          f"{host / 1e9:.2f} GB of host memory available: the checkpoint "
          f"phase needs twice the state, {2 * state_bytes / 1e9:.2f} GB")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = launch_train.main(CKPT_ARGV + ["--steps", str(CKPT_STEPS),
                                         "--ckpt-dir", root])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    save, sup = res["checkpointer"].last_save, res["supervisor"]
    n_bytes = _leaves_bytes(tree_leaves(res["state"]))
    step_dir = os.path.join(root, f"step_{CKPT_STEPS:08d}")
    on_disk = sum(os.path.getsize(os.path.join(step_dir, name))
                  for name in os.listdir(step_dir))
    check(res["ckpt_steps"] == [CKPT_STEPS] and save["step"] == CKPT_STEPS
          and res["steps"] == CKPT_STEPS and res["restarts"] == 0,
          f"the launcher's run: checkpoints {res['ckpt_steps']}, last save "
          f"{save}, {res['steps']} steps, {res['restarts']} restarts")
    check(all(np.isfinite(res["losses"])), f"losses {res['losses']}")
    print(f"[ckpt] 7a launch.train {' '.join(CKPT_ARGV)} --steps "
          f"{CKPT_STEPS}: wall {wall:.3f}s; losses {res['losses'][0]:.4f} -> "
          f"{res['losses'][-1]:.4f}; peak memory {peak / 2**30:.2f} GiB "
          f"({peak / 1e9:.2f} GB)")
    print(f"[ckpt] 7a save of step {CKPT_STEPS}: host snapshot "
          f"{save['snapshot_s']:.3f}s ({n_bytes / 1e9:.2f} GB of state, "
          f"{n_bytes / save['snapshot_s'] / 1e9:.2f} GB/s device to host), "
          f"write {save['write_s']:.3f}s; {on_disk} bytes "
          f"on disk ({on_disk / 1e9:.2f} GB, "
          f"{on_disk / save['write_s'] / 1e9:.2f} GB/s)")
    print(f"[ckpt] 7a supervisor's host copy of init_state: "
          f"{sup.snapshot_bytes / 1e9:.2f} GB in {sup.snapshot_s:.3f}s")
    return {"res": res, "wall": wall, "peak": peak, "bytes": on_disk,
            "snapshot_s": save["snapshot_s"], "write_s": save["write_s"]}


def _ckpt_restore_resume(root: str, run: dict) -> dict:
    """7b: step 50 restored into a fresh state on the card, every leaf
    equal to 7a's final state; then ``--resume`` to step 52."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models import get_model
    from repro_torch.train import TrainConfig, init_train_state
    from repro_torch.train.optimizer import tree_leaves

    from repro_torch.sharding.context import full

    # 7a's state to the host: a third state beside the template and the
    # restored one would not fit the card (launch.train's leaves are
    # DTensors on its 1x1 mesh; their whole values)
    want = [full(t).to("cpu", copy=True)
            for t in tree_leaves(run["res"]["state"])]
    del run["res"]
    gc.collect()
    torch.cuda.empty_cache()
    template = init_train_state(get_model(get_config(CKPT_ARCH)), 1,
                                TrainConfig(), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, _ = Checkpointer(root).restore(template, step=CKPT_STEPS)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    got = tree_leaves(got)
    check(len(got) == len(want), f"{len(got)} leaves restored, "
                                 f"{len(want)} saved")
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.device.type == "cuda" and g.dtype == w.dtype
              and torch.equal(g.cpu(), w),
              f"restored leaf {i} {tuple(w.shape)} {w.dtype} differs from "
              f"the final state of the run")
    n_bytes = _leaves_bytes(want)
    print(f"[ckpt] 7b restore of step {CKPT_STEPS} into a fresh "
          f"init_train_state on the card: {restore_s:.3f}s "
          f"({n_bytes / restore_s / 1e9:.2f} GB/s of state); all {len(got)} "
          f"leaves equal to 7a's final state bit for bit")
    del template, got, want
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = launch_train.main(CKPT_ARGV + ["--steps", str(CKPT_RESUME_STEPS),
                                         "--ckpt-dir", root, "--resume"])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    sup = res["supervisor"]
    check(res["start"] == CKPT_STEPS
          and res["steps"] == CKPT_RESUME_STEPS - CKPT_STEPS
          and all(np.isfinite(res["losses"])),
          f"the resume: start {res['start']}, {res['steps']} steps, losses "
          f"{res['losses']}")
    print(f"[ckpt] 7b launch.train --steps {CKPT_RESUME_STEPS} --resume: "
          f"from step {res['start']}, losses "
          f"{', '.join(f'{x:.4f}' for x in res['losses'])}; wall {wall:.3f}s "
          f"(init, restore, host copy of the restored state "
          f"{sup.snapshot_s:.3f}s, {res['steps']} steps); peak memory "
          f"{peak / 2**30:.2f} GiB")
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return {"restore_s": restore_s, "resume_wall": wall, "resume_peak": peak}


def _ckpt_serve(root: str) -> int:
    """7c: internlm2-1.8b served from the checkpoint through
    ``launch.serve.main --ckpt-dir`` (twice), and from its seed-0 weights;
    returns the tensor-core attention kernel's launches in the first."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import BY_HEAD_DIM
    from repro_torch.kernels.flash_attention import LAUNCHES as ATTN_LAUNCHES
    from repro_torch.launch import serve

    cfg = get_config(CKPT_ARCH)
    waves = -(-SERVE["requests"] // SERVE["slots"])
    want = {"mha": cfg.n_layers * waves, "wkv6": 0, "pchase": 0}
    outputs = {}
    for run, extra in (("checkpoint", ["--ckpt-dir", root]),
                       ("checkpoint again", ["--ckpt-dir", root]),
                       ("seed 0", [])):
        ops.reset_launches()
        t0 = time.perf_counter()
        res = serve.main(_serve_argv(cfg) + extra)
        wall = time.perf_counter() - t0
        counts = {fn.__name__: fn.launches for fn in ops.LLM_WRAPPERS}
        routes = dict(ATTN_LAUNCHES)
        by_d = {route: dict(c) for route, c in BY_HEAD_DIM.items()}
        check(counts == want == res["launches"]
              and routes == {"sm90": want["mha"], "cuda_core": 0}
              and by_d == {"sm90": {cfg.resolved_head_dim: want["mha"]},
                           "cuda_core": {}},
              f"{CKPT_ARCH} served from {run}: launches {counts}, attention "
              f"kernels {routes} by head dim {by_d}; expected {want}")
        check(all(o.shape == (SERVE["max_new"],) for o in res["outputs"]),
              f"{CKPT_ARCH} served from {run}: not {SERVE['max_new']} tokens "
              f"for every request")
        outputs[run] = np.stack(res["outputs"])
        if run == "checkpoint":
            launches = counts["mha"]
        print(f"[ckpt] 7c serve {CKPT_ARCH} from {run}: main {wall:.3f}s "
              f"(init{', restore' if extra else ''}, serve "
              f"{res['wall_s']:.3f}s, {res['tok_per_s']:.1f} tok/s); "
              f"launches {counts}; "
              f"tensor-core attention {routes['sm90']}x at d "
              f"{cfg.resolved_head_dim}; first request's tokens "
              f"{res['outputs'][0].tolist()}")
        del res
        gc.collect()
        torch.cuda.empty_cache()
    check(np.array_equal(outputs["checkpoint"], outputs["checkpoint again"]),
          "two serves from the checkpoint gave other tokens")
    check(not np.array_equal(outputs["checkpoint"], outputs["seed 0"]),
          "the serve from the checkpoint gave the seed-0 weights' tokens")
    print(f"[ckpt] 7c greedy tokens: equal in both serves from the "
          f"checkpoint, other than the seed-0 weights' in "
          f"{int((outputs['checkpoint'] != outputs['seed 0']).any(1).sum())} "
          f"of {len(outputs['seed 0'])} requests")
    return launches


def _ft_runs(root: str, tag: str) -> dict:
    """The smoke config trained 10 steps on the card: uninterrupted twice,
    and under the supervisor with a failure at step 6 (a checkpoint at 4)
    and at step 2 (none yet): {run: (params' leaves, supervisor)}."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data import ByteCorpus, DataConfig
    from repro_torch.ft import FailureInjector, Supervisor
    from repro_torch.models import get_model
    from repro_torch.train import (OptConfig, TrainConfig, init_train_state,
                                   make_train_step, train_loop)
    from repro_torch.train.optimizer import tree_leaves

    cfg = get_config(FT["arch"]).replace(dtype="float32")
    model = get_model(cfg)
    tc = TrainConfig(opt=OptConfig(lr=3e-3, warmup_steps=4, total_steps=64),
                     ckpt_every=FT["ckpt_every"])
    data = ByteCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                 seq_len=FT["seq_len"],
                                 global_batch=FT["global_batch"]))
    runs = {}
    for run, fail_at in (("uninterrupted", None), ("again", None),
                         ("fail at 6", 6), ("fail at 2", 2)):
        state = init_train_state(model, FT["seed"], tc, device="cuda")
        step_fn = make_train_step(model, tc)
        sup = None
        if fail_at is None:
            state, _ = train_loop(model, tc, data, FT["steps"], state=state,
                                  step_fn=step_fn)
        else:
            ck = Checkpointer(os.path.join(root, f"{tag}_{fail_at}"))
            injector = FailureInjector({fail_at})
            sup = Supervisor(ck, max_restarts=2)

            def train_fn(st, start, ck=ck, injector=injector,
                         step_fn=step_fn):
                return train_loop(model, tc, data, FT["steps"], state=st,
                                  start_step=start, checkpointer=ck,
                                  step_fn=step_fn, callbacks=[injector])

            state, _ = sup.run(train_fn, state)
        runs[run] = ([t.detach().cpu() for t in
                      tree_leaves(state["params"])], sup)
    return runs


def _ft_diff(a: list, b: list) -> tuple[bool, float]:
    """(bit for bit, the largest difference over its leaf's largest
    |value|)."""
    exact = all(torch.equal(x, y) for x, y in zip(a, b))
    err = max(float((x - y).abs().max()) / max(float(x.abs().max()), 1e-30)
              for x, y in zip(a, b))
    return exact, err


def _ckpt_supervisor(root: str) -> dict:
    """7d: the supervisor on the card, restarting from step 4's checkpoint
    and from scratch; the final parameters against an uninterrupted run.
    Where a run is not bit for bit (a second uninterrupted run shows the
    card's own variation), all four again under
    ``torch.use_deterministic_algorithms``, where they must be; its
    warnings name the operations that have no deterministic version."""
    import warnings

    logs = {6: "restart from step 4",
            2: "restart from scratch (no checkpoint)"}

    def compare(runs, mode) -> dict:
        want, out = runs["uninterrupted"][0], {}
        for run in ("again", "fail at 6", "fail at 2"):
            got, sup = runs[run]
            if sup is not None:
                fail_at = int(run.split()[-1])
                check(sup.restarts == 1 and sup.log[-1] == logs[fail_at],
                      f"supervisor {run}: {sup.restarts} restarts, log "
                      f"{sup.log}")
            out[run] = _ft_diff(want, got)
            exact, err = out[run]
            print(f"[ckpt] 7d {FT['arch']} float32, {FT['steps']} steps on "
                  f"the card, {mode}, {run}"
                  f"{': ' + '; '.join(sup.log) if sup else ''}: final params "
                  f"against the uninterrupted run: "
                  + ("bit for bit" if exact else
                     f"largest difference {err:.3g} of its leaf's largest"))
        return out

    result = {"default": compare(_ft_runs(root, "ft"), "default")}
    if all(exact for exact, _ in result["default"].values()):
        print("[ckpt] 7d the restarts are bit for bit on the card")
        return result
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            det = _ft_runs(root, "ft_det")
    finally:
        torch.use_deterministic_algorithms(False)
    nondet = sorted({str(w.message).split(".")[0] for w in caught
                     if "deterministic" in str(w.message)})
    print(f"[ckpt] 7d operations without a deterministic version on this "
          f"path: {nondet or 'none'}")
    result["deterministic"] = compare(det, "deterministic algorithms")
    check(all(exact for exact, _ in result["deterministic"].values()),
          "under torch.use_deterministic_algorithms the runs still differ")
    for run, (_, err) in result["default"].items():
        check(err <= FT_TOL, f"{run}: params differ by {err:g} of their "
                             f"leaf's largest |value| (tol {FT_TOL})")
    print(f"[ckpt] 7d the restarts are bit for bit under deterministic "
          f"algorithms; in the default mode within {FT_TOL} of each leaf's "
          f"largest |value|, as a second uninterrupted run is")
    return result


def phase_checkpoint() -> dict:
    """Phase 7: train, checkpoint, restore, resume and serve internlm2-1.8b
    at full size through the launchers, and the supervisor's restarts,
    under a temporary directory that the phase removes."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as root:
        run = _ckpt_train(root)
        numbers = {key: run[key] for key in
                   ("wall", "peak", "bytes", "snapshot_s", "write_s")}
        numbers.update(_ckpt_restore_resume(root, run))
        numbers["mha"] = _ckpt_serve(root)
        numbers["ft"] = _ckpt_supervisor(root)
    numbers["phase_s"] = time.perf_counter() - t0
    print(f"[ckpt] phase 7 in {numbers['phase_s']:.1f}s; the temporary "
          f"checkpoint directory removed")
    return numbers


# --------------------------------------------------------------------------
# Phase 8: sharding/ and launch/mesh.py on a one-card DeviceMesh
# --------------------------------------------------------------------------
# internlm2-1.8b at full width and depth through launch.train --mesh 1x1 on
# a one-card nccl DeviceMesh, with phase 7's launcher settings (a
# host-bound step: 8 x 64 tokens); the plain train_loop on the same seed,
# configuration and batches beside it.
MESH_STEPS = 6
MESH_LOSS_TOL = 1e-3         # relative, where the two runs are not bitwise
PRODUCTION_MESH = (16, 16)


def _mesh_plain_train():
    """8a's yardstick: ``launch.train``'s configuration, seed, data and
    steps through the plain ``init_train_state`` and ``train_loop``: (its
    losses, its step walls, the plain step function, its state)."""
    from repro_torch.configs import get_config
    from repro_torch.data import ByteCorpus, DataConfig
    from repro_torch.models import Runtime, get_model
    from repro_torch.train import (OptConfig, TrainConfig, init_train_state,
                                   make_train_step, train_loop)

    argv = dict(zip(CKPT_ARGV[::2], CKPT_ARGV[1::2]))
    cfg = get_config(CKPT_ARCH)
    model = get_model(cfg)
    tc = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=10,
                                   total_steps=MESH_STEPS),
                     runtime=Runtime(remat=argv["--remat"]), ckpt_every=50)
    data = ByteCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                 seq_len=int(argv["--seq"]),
                                 global_batch=int(argv["--global-batch"])))
    state = init_train_state(model, 0, tc, device="cuda")
    step_fn = make_train_step(model, tc)
    state, hist = train_loop(model, tc, data, MESH_STEPS, state=state,
                             step_fn=step_fn)
    return ([m["loss"] for _, m in hist], [m["step_time_s"] for _, m in hist],
            step_fn, state, data)


def _warm_profile(label: str, step_fn, state, batch, walls: list) -> dict:
    """One more step under the profiler: busy and idle share of the warm
    step, against the median unprofiled wall of steps 2 on."""
    for attempt in range(1, PROFILER_SESSIONS + 1):
        events, state = _profile_train_step(step_fn, state, batch)
        if events is not None:
            SESSIONS["whole"] += 1
            break
        SESSIONS["retaken"] += 1
        print(f"[mesh] {label}: profiled step {attempt} of "
              f"{PROFILER_SESSIONS} not whole")
    else:
        raise SmokeFailure(f"{label}: no whole profiled train step")
    busy = sum(us for _, us in events) / 1e6
    wall = statistics.median(walls[1:])
    print(f"[mesh] 8a {label} warm step: wall {wall:.4f}s unprofiled "
          f"(median of steps 2-{len(walls)}); device busy {busy:.4f}s; idle "
          f"share {1 - busy / wall:.3f}; device events {len(events)}")
    return {"wall": wall, "busy": busy, "idle": 1 - busy / wall,
            "events": len(events), "state": state}


def _mesh_train(root: str) -> dict:
    """8a and 8b: launch.train --mesh 1x1 against the plain train_loop,
    then the mesh state saved and restored onto a fresh 1x1 mesh."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.launch import train as launch_train
    from repro_torch.models import get_model
    from repro_torch.sharding import TRAIN_RULES, tree_shardings
    from repro_torch.sharding.context import full
    from repro_torch.train import TrainConfig, init_train_state
    from repro_torch.train.optimizer import opt_state_specs, tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    losses, walls, step_fn, state, data = _mesh_plain_train()
    plain_s = time.perf_counter() - t0
    batch = data.batch_at(MESH_STEPS)
    plain = _warm_profile("plain train_loop", step_fn, state, batch, walls)
    del state, step_fn, plain["state"]
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    res = launch_train.main(CKPT_ARGV + ["--steps", str(MESH_STEPS),
                                         "--mesh", "1x1", "--ckpt-dir",
                                         os.path.join(root, "train")])
    mesh_s = time.perf_counter() - t0
    wq = res["state"]["params"]["layers"][0]["wq"]
    check(type(wq).__name__ == "DTensor"
          and tuple(res["mesh"].shape) == (1, 1)
          and res["mesh"].device_type == "cuda"
          and torch.distributed.get_backend() == "nccl",
          f"launch.train --mesh 1x1: wq is {type(wq).__name__} on "
          f"{res['mesh']}")
    got = res["losses"]
    rel = max(abs(a - b) / abs(a) for a, b in zip(losses, got))
    check(all(np.isfinite(got)) and rel <= MESH_LOSS_TOL,
          f"launch.train --mesh 1x1 losses {got} against train_loop's "
          f"{losses}")
    print(f"[mesh] 8a {CKPT_ARCH} {MESH_STEPS} steps, {' '.join(CKPT_ARGV)}: "
          f"launch.train --mesh 1x1 (one-card nccl DeviceMesh, "
          f"placements of wq {[str(p) for p in wq.placements]}) in "
          f"{mesh_s:.3f}s against the plain train_loop in {plain_s:.3f}s; "
          f"losses " + ("bit for bit" if got == losses else
                        f"differ by {rel:.3g} relative at most")
          + f": mesh {', '.join(f'{x:.6f}' for x in got)}; plain "
          f"{', '.join(f'{x:.6f}' for x in losses)}")
    print(f"[mesh] 8a step walls: mesh "
          f"{', '.join(f'{x:.4f}' for x in res['step_s'])}s; plain "
          f"{', '.join(f'{x:.4f}' for x in walls)}s")
    mesh = _warm_profile("launch.train --mesh 1x1", res["step_fn"],
                         res["state"], batch, res["step_s"])
    print(f"[mesh] 8a DTensor's host cost on the warm step: wall "
          f"{mesh['wall']:.4f}s against {plain['wall']:.4f}s "
          f"({mesh['wall'] / plain['wall']:.3f}x); idle share "
          f"{mesh['idle']:.3f} against {plain['idle']:.3f}; device busy "
          f"{mesh['busy']:.4f}s against {plain['busy']:.4f}s")

    # 8b: the mesh state saved, then restored onto a fresh 1x1 mesh
    ck = Checkpointer(os.path.join(root, "mesh_ckpt"))
    state = mesh.pop("state")
    del res
    t0 = time.perf_counter()
    ck.save(MESH_STEPS, state)
    save_s = time.perf_counter() - t0
    want = [full(t).to("cpu", copy=True) for t in tree_leaves(state)]
    del state
    gc.collect()
    torch.cuda.empty_cache()
    model = get_model(get_config(CKPT_ARCH))
    fresh = launch_mesh.make_mesh((1, 1), ("data", "model"), "cuda")
    template = init_train_state(model, 1, TrainConfig(), device="cuda")
    pspecs = model.param_specs()
    logical = {"params": pspecs,
               "opt": opt_state_specs(pspecs, TrainConfig().opt,
                                      has_master="master" in template["opt"])}
    shardings = tree_shardings(template, logical, TRAIN_RULES, fresh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored, _ = ck.restore(template, step=MESH_STEPS, shardings=shardings)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    del template
    got = tree_leaves(restored)
    check(len(got) == len(want), f"{len(got)} leaves restored of "
                                 f"{len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        check(type(g).__name__ == "DTensor" and g.device_mesh is fresh
              and g.dtype == w.dtype and torch.equal(full(g).cpu(), w),
              f"8b: restored leaf {i} {tuple(w.shape)} differs from the mesh "
              f"state")
    n_bytes = _leaves_bytes(want)
    print(f"[mesh] 8b save of the mesh state {save_s:.3f}s "
          f"({n_bytes / 1e9:.2f} GB); restore(shardings=...) onto a fresh "
          f"1x1 mesh {restore_s:.3f}s; all {len(got)} leaves DTensors on the "
          f"new mesh, equal to the saved state bit for bit")
    del restored, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return {"plain": {k: plain[k] for k in ("wall", "busy", "idle")},
            "mesh": {k: mesh[k] for k in ("wall", "busy", "idle")},
            "loss_rel": rel, "save_s": save_s, "restore_s": restore_s}


def _timed_serve(eng, reqs, want) -> float:
    """The wall of a warm ``eng.serve(reqs)``, its tokens held to
    ``want``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = np.stack(eng.serve(reqs, max_new=SERVE["max_new"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(np.array_equal(got, want), "a warm serve gave other tokens")
    return wall


def _mesh_serve() -> int:
    """8c: launch.serve --mesh 1x1 at full size against the plain engine
    on the same seed-0 weights and requests; returns its mha launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import BY_HEAD_DIM
    from repro_torch.kernels.flash_attention import LAUNCHES as ATTN_LAUNCHES
    from repro_torch.launch import serve
    from repro_torch.models import get_model
    from repro_torch.serve import Engine, ServeConfig

    cfg = get_config(CKPT_ARCH).replace(dtype="bfloat16")
    waves = -(-SERVE["requests"] // SERVE["slots"])
    want = {"mha": cfg.n_layers * waves, "wkv6": 0, "pchase": 0}
    reqs = serve.requests(cfg, SERVE["requests"], SERVE["prompt_len"])
    params = get_model(cfg).init(seed=0, device="cuda")
    eng = Engine(get_model(cfg), params, ServeConfig(
        max_len=_max_len(cfg), slots=SERVE["slots"], device="cuda"))
    plain = np.stack(eng.serve(reqs, max_new=SERVE["max_new"]))
    plain_s = _timed_serve(eng, reqs, plain)
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launches()
    res = serve.main(_serve_argv(cfg) + ["--mesh", "1x1"])
    counts = {fn.__name__: fn.launches for fn in ops.LLM_WRAPPERS}
    routes = dict(ATTN_LAUNCHES)
    by_d = {route: dict(c) for route, c in BY_HEAD_DIM.items()}
    embed = res["engine"].params["embed"]
    check(type(embed).__name__ == "DTensor",
          f"launch.serve --mesh 1x1: parameters are {type(embed).__name__}")
    check(counts == want == res["launches"]
          and routes == {"sm90": want["mha"], "cuda_core": 0}
          and by_d == {"sm90": {cfg.resolved_head_dim: want["mha"]},
                       "cuda_core": {}},
          f"launch.serve --mesh 1x1: launches {counts}, attention kernels "
          f"{routes} by head dim {by_d}; expected {want}")
    got = np.stack(res["outputs"])
    check(np.array_equal(got, plain),
          f"launch.serve --mesh 1x1 tokens differ from the plain engine's "
          f"in {int((got != plain).any(1).sum())} of {len(plain)} requests")
    mesh_s = _timed_serve(res["engine"], reqs, plain)
    tokens = plain.size
    print(f"[mesh] 8c serve {CKPT_ARCH} --mesh 1x1 (parameters DTensors, "
          f"SERVE_RULES): the launcher's serve {res['wall_s']:.3f}s "
          f"(prefill {res['prefill_s']:.3f}s, decode {res['decode_s']:.3f}s); "
          f"launches {counts}, the tensor-core attention {routes['sm90']}x "
          f"at d {cfg.resolved_head_dim} on the local shards; greedy tokens "
          f"equal to the plain engine's in all {len(plain)} requests")
    print(f"[mesh] 8c warm serve of the same {len(reqs)} requests: mesh "
          f"{mesh_s:.3f}s ({tokens / mesh_s:.1f} tok/s) against the plain "
          f"engine's {plain_s:.3f}s ({tokens / plain_s:.1f} tok/s), "
          f"{mesh_s / plain_s:.3f}x")
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return counts["mha"]


def _mesh_specs() -> None:
    """8d: every full-size arch's resolved specs on the production (16, 16)
    mesh under both rule sets (pure logic, no device)."""
    from types import SimpleNamespace

    from repro_torch.configs import ARCHS, get_config
    from repro_torch.models import get_model
    from repro_torch.sharding import SERVE_RULES, TRAIN_RULES, tree_specs

    mesh = SimpleNamespace(axis_names=("data", "model"),
                           shape=PRODUCTION_MESH)
    for arch in sorted(ARCHS):
        model = get_model(get_config(arch))
        shapes, logical = model.param_shapes(), model.param_specs()
        for rules in (TRAIN_RULES, SERVE_RULES):
            specs = tree_specs(shapes, logical, rules, mesh)
            top = {k: v for k, v in specs.items() if k != "layers"}
            layer = specs["layers"][0]
            flat = {**top, **{f"layer.{k}": v for k, v in layer.items()}}
            text = "; ".join(f"{k} {v}" for k, v in flat.items())
            print(f"[mesh] 8d {arch} {rules.name} {PRODUCTION_MESH}: "
                  f"{len(specs['layers'])} layers; {text}")


def phase_mesh() -> dict:
    """Phase 8: launch.train and launch.serve on a one-card DeviceMesh
    against the plain paths, the mesh state restored onto a fresh mesh,
    and the production mesh's specs."""
    import tempfile

    t0 = time.perf_counter()
    print("[mesh] this machine has one card: meshes of more than one rank "
          "run only on the CPU (gloo, tests/test_torch_elastic.py); here "
          "every mesh is 1x1 over nccl")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as root:
        numbers = _mesh_train(root)
    numbers["mha"] = _mesh_serve()
    _mesh_specs()
    numbers["phase_s"] = time.perf_counter() - t0
    print(f"[mesh] phase 8 in {numbers['phase_s']:.1f}s")
    return numbers


EP_ARCH = "qwen3-moe-30b-a3b"
EP_SERVE = dict(batch=4, prompt_len=512, decode_steps=15, max_len=640)
EP_FACTORS = (2.0, 4.0, 8.0)     # capacity factors tried for no drop
EP_PROFILE_STEPS = 3             # decode steps in 9a's profiled window
# EP against gspmd where neither drops a pair: the relative Frobenius
# distance of the logits.  Both run the same expert GEMMs on the same rows
# in the same order; only the buffers' capacity (their padding rows)
# differs, which may change cuBLAS's kernel and so re-round each expert
# output once in bf16 (2^-8 relative).  Re-roundings that differ, once a
# layer over 48 layers and random in sign, add up to about 7 x 2^-8 x the
# share of the residual stream the moe adds, under 2e-2 of the logits.
EP_LOGIT_TOL = 2e-2
EP_TRAIN = dict(layers=4, global_batch=8, seq_len=64, steps=3, lr=1e-3)
EP_LOSS_TOL = 1e-3               # relative, the first step's loss
# The first step's gradient norm, relative: the paths' bf16 gradients
# differ in the order of their sums (the expert GEMMs' row counts differ).
# The later steps' losses are printed, not held: AdamW's first updates are
# about lr x sign(gradient), so a rounding that flips the sign of a tiny
# gradient moves its parameter by 2 lr on one path and not the other.
EP_GRAD_NORM_TOL = 1e-2


def _ep_mesh():
    """A one-card ``nccl`` mesh (1, 1) of ("data", "model"), as
    ``launch.serve --mesh 1x1`` makes it."""
    from repro_torch.launch.mesh import init_process_group, make_mesh

    init_process_group("cuda", 1)
    return make_mesh((1, 1), ("data", "model"), "cuda")


def _ep_serve(model, params, tokens, rt, mesh, steps: int,
              record: bool = False) -> dict:
    """A greedy prefill of ``tokens`` and ``steps`` decode steps through
    ``Model.prefill``/``decode_step`` with ``rt`` under
    ``activation_sharding(mesh, SERVE_RULES)``: the logits (on the host,
    float32), the greedy tokens, the wall, and with ``record`` the pairs
    the moe FFNs dropped by capacity in the prefill and in the decode
    steps (this rank's, summed over the layers)."""
    import contextlib

    from repro_torch.models.moe import recording_drops
    from repro_torch.sharding import SERVE_RULES
    from repro_torch.sharding.context import (activation_sharding, full,
                                              replicate_like)

    embed = params["embed"]
    logits_all, picked = [], []
    drops = {"prefill": [], "decode": []}
    rec = recording_drops if record else contextlib.nullcontext
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad(), activation_sharding(mesh, SERVE_RULES):
        with rec() as got:
            logits, cache = model.prefill(
                params, {"tokens": replicate_like(tokens, embed)},
                EP_SERVE["max_len"], rt=rt)
        if record:
            drops["prefill"] = got
        for _ in range(steps + 1):
            logits = full(logits).float()
            logits_all.append(logits)
            nxt = torch.argmax(logits, dim=-1)
            picked.append(nxt)
            if len(picked) > steps:
                break
            with rec() as got:
                logits, cache = model.decode_step(
                    params, {"tokens": replicate_like(nxt[:, None], embed)},
                    cache, rt=rt)
            if record:
                drops["decode"] += got
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {"logits": torch.stack(logits_all).cpu(),
           "tokens": torch.stack(picked, 1).cpu().numpy(), "wall": wall}
    if record:
        out["dropped"] = {part: int(sum(int(n) for n in ns))
                          for part, ns in drops.items()}
        out["pairs"] = {"prefill": tokens.numel() * model.cfg.moe_top_k
                        * model.cfg.n_layers,
                        "decode": tokens.shape[0] * model.cfg.moe_top_k
                        * model.cfg.n_layers * steps}
    return out


def _ep_profile(run) -> dict | None:
    """``run()`` under ``torch.profiler``, opened by ``lead_in`` and closed
    by a marker: device busy s, and the device time and count of the
    collective (``nccl``) kernels; None when the session is not whole.
    The device's activity alone is recorded: the host's ~10^5 DTensor ops
    a run would take the profiler minutes to collect."""
    from torch.profiler import ProfilerActivity, profile

    marker = _marker_name()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        lead_in()
        run()
        mark()
        torch.cuda.synchronize()
    parts = marked_parts(_device_events(prof), marker, 1)
    if not parts or not parts[0]:
        return None
    events = parts[0]
    nccl = [(name, us) for name, us in events if "nccl" in name.lower()]
    return {"busy": sum(us for _, us in events) / 1e6,
            "events": len(events),
            "nccl_ms": sum(us for _, us in nccl) / 1e3,
            "nccl_n": len(nccl),
            "nccl_names": sorted({name[:60] for name, _ in nccl})}


def _logit_distance(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(relative Frobenius distance, largest |difference|) of two logit
    tensors."""
    return (float((a - b).norm() / b.norm()), float((a - b).abs().max()))


def _ep_serve_phase(mesh) -> dict:
    """9a: qwen3-moe-30b-a3b at full size on the one-card mesh, its
    parameters laid out by SERVE_RULES, served with moe_impl="ep" against
    the sorted dispatch."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import LAUNCHES as ATTN_LAUNCHES
    from repro_torch.launch import serve
    from repro_torch.models import Runtime, get_model
    from repro_torch.sharding import SERVE_RULES, tree_shardings
    from repro_torch.sharding.context import distribute

    cfg = get_config(EP_ARCH)
    model = get_model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed=0, device="cuda")
    params = distribute(params, tree_shardings(params, model.param_specs(),
                                               SERVE_RULES, mesh))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(type(params["embed"]).__name__ == "DTensor",
          f"9a: parameters are {type(params['embed']).__name__}")
    tokens = torch.as_tensor(np.stack(serve.requests(
        cfg, EP_SERVE["batch"], EP_SERVE["prompt_len"])), device="cuda")
    steps = EP_SERVE["decode_steps"]
    ep, plain = Runtime(moe_impl="ep"), Runtime()
    print(f"[ep] 9a {cfg.name}: {cfg.n_layers} layers, {cfg.moe_experts} "
          f"experts top {cfg.moe_top_k}, capacity factor "
          f"{cfg.moe_capacity_factor}; {_numel(params) / 1e9:.3f} B "
          f"parameters ({params['embed'].dtype}) as DTensors on the 1x1 "
          f"{torch.distributed.get_backend()} mesh by "
          f"SERVE_RULES in {init_s:.3f}s; prefill {EP_SERVE['batch']} x "
          f"{EP_SERVE['prompt_len']}, {steps} decode steps")

    ops.reset_launches()
    runs = {"ep": _ep_serve(model, params, tokens, ep, mesh, steps, True)}
    mha = ops.mha.launches
    routes = dict(ATTN_LAUNCHES)
    check(mha == cfg.n_layers
          and routes == {"sm90": cfg.n_layers, "cuda_core": 0},
          f"9a: moe_impl='ep' serve launched mha {mha}x ({routes}); "
          f"expected {cfg.n_layers}, one a layer in the prefill")
    runs["gspmd"] = _ep_serve(model, params, tokens, plain, mesh, steps,
                              True)
    for name, run in runs.items():
        check(bool(torch.isfinite(run["logits"]).all()),
              f"9a {name}: logits not finite")
    rerun = {name: _ep_serve(model, params, tokens, rt, mesh, steps)
             for name, rt in (("ep", ep), ("gspmd", plain))}
    for name in runs:
        check(np.array_equal(rerun[name]["tokens"], runs[name]["tokens"]),
              f"9a {name}: a greedy rerun gave other tokens")
    # the profiled window: the prefill and EP_PROFILE_STEPS decode steps,
    # with the same window's unprofiled wall for the idle share
    window = EP_PROFILE_STEPS
    profiles = {}
    t0 = time.perf_counter()
    for name, rt in (("ep", ep), ("gspmd", plain)):
        window_s = _ep_serve(model, params, tokens, rt, mesh, window)["wall"]
        for attempt in range(1, PROFILER_SESSIONS + 1):
            got = _ep_profile(lambda: _ep_serve(model, params, tokens, rt,
                                                mesh, window))
            if got is not None:
                SESSIONS["whole"] += 1
                break
            SESSIONS["retaken"] += 1
            print(f"[ep] 9a {name}: profiled session {attempt} not whole")
        else:
            raise SmokeFailure(f"9a {name}: no whole profiled serve")
        profiles[name] = dict(got, wall=window_s)
    print(f"[ep] 9a two profiled windows in {time.perf_counter() - t0:.1f}s")
    same = float((runs["ep"]["tokens"] == runs["gspmd"]["tokens"]).mean())
    for name in runs:
        run, prof = runs[name], profiles[name]
        wall = rerun[name]["wall"]
        print(f"[ep] 9a {name} at capacity factor "
              f"{cfg.moe_capacity_factor}: dropped {run['dropped']['prefill']}"
              f" of {run['pairs']['prefill']} pairs in the prefill and "
              f"{run['dropped']['decode']} of {run['pairs']['decode']} in "
              f"the decode steps; logits finite; greedy tokens equal on a "
              f"rerun; wall {wall:.3f}s (prefill + {steps} steps, warm; "
              f"the first run {run['wall']:.3f}s); over the prefill and "
              f"{window} steps: wall {prof['wall']:.3f}s, device busy "
              f"{prof['busy']:.4f}s, idle share "
              f"{1 - prof['busy'] / prof['wall']:.3f}, {prof['events']} "
              f"device events, collective kernels {prof['nccl_n']}x "
              f"{prof['nccl_ms']:.3f} ms {prof['nccl_names']}")
    print(f"[ep] 9a greedy tokens of ep and gspmd agree at {same:.3f} of "
          f"{runs['ep']['tokens'].size} positions (at the config's "
          f"factor, where the two drop different pairs)")
    del runs, rerun

    held = None
    for factor in EP_FACTORS:
        model_f = get_model(cfg.replace(moe_capacity_factor=factor))
        # a prefill and one decode step first, where a factor that drops
        # shows it as a rule, then the whole run
        for n in (1, steps):
            got = {name: _ep_serve(model_f, params, tokens, rt, mesh, n,
                                   True)
                   for name, rt in (("ep", ep), ("gspmd", plain))}
            dropped = {name: sum(run["dropped"].values())
                       for name, run in got.items()}
            print(f"[ep] 9a capacity factor {factor}, prefill and {n} "
                  f"decode step(s): pairs dropped {dropped}")
            if any(dropped.values()):
                break
        if any(dropped.values()):
            continue
        rel, err = _logit_distance(got["ep"]["logits"],
                                   got["gspmd"]["logits"])
        tok = float((got["ep"]["tokens"] == got["gspmd"]["tokens"]).mean())
        print(f"[ep] 9a capacity factor {factor}, nothing dropped: ep "
              f"logits against gspmd's over the prefill and {steps} steps "
              f"(each on its own greedy tokens): relative distance "
              f"{rel:.3e} (tolerance {EP_LOGIT_TOL}), largest |difference| "
              f"{err:.4f} of largest |logit| "
              f"{float(got['gspmd']['logits'].abs().max()):.3f}; greedy "
              f"tokens equal at {tok:.3f}")
        check(rel <= EP_LOGIT_TOL, f"9a: ep logits {rel:.3e} from gspmd's "
                                   f"at capacity factor {factor}")
        held = {"factor": factor, "rel": rel, "max_abs": err, "tokens": tok}
        break
    check(held is not None, f"9a: a pair dropped at every factor of "
                            f"{EP_FACTORS}")
    peak = torch.cuda.max_memory_allocated()
    print(f"[ep] 9a peak memory {peak / 2**30:.2f} GiB")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"mha": mha, "profiles": profiles, "held": held, "peak": peak}


def _ep_train_batch(data, step: int, like) -> dict:
    from repro_torch.sharding.context import replicate_like

    return {name: replicate_like(torch.from_numpy(x).cuda(), like)
            for name, x in data.batch_at(step).items()}


def _ep_train_factor(cfg, data, mesh) -> float:
    """The smallest capacity factor of ``EP_FACTORS`` (then 16, 32) at
    which neither moe path drops a pair in the first batch's
    ``train_loss`` from the seed-0 parameters."""
    from repro_torch.models import Runtime, get_model
    from repro_torch.models.moe import recording_drops
    from repro_torch.sharding import TRAIN_RULES, tree_shardings
    from repro_torch.sharding.context import activation_sharding, distribute

    model = get_model(cfg)
    params = model.init(seed=0, device="cuda")
    params = distribute(params, tree_shardings(params, model.param_specs(),
                                               TRAIN_RULES, mesh))
    batch = _ep_train_batch(data, 0, params["embed"])
    chosen = None
    for factor in (*EP_FACTORS, 16.0, 32.0):
        model_f = get_model(cfg.replace(moe_capacity_factor=factor))
        dropped = {}
        for impl in ("ep", "gspmd"):
            with torch.no_grad(), activation_sharding(mesh, TRAIN_RULES), \
                    recording_drops() as drops:
                model_f.train_loss(params, batch, Runtime(moe_impl=impl))
            dropped[impl] = int(sum(int(n) for n in drops))
        print(f"[ep] 9b capacity factor {factor}: pairs dropped in the first "
              f"batch {dropped}")
        if not any(dropped.values()):
            chosen = factor
            break
    del params
    check(chosen is not None, "9b: a pair dropped at every factor")
    return chosen


def _ep_train_phase(mesh) -> dict:
    """9b: three training steps of qwen3-moe-30b-a3b at full width, its
    depth cut to ``EP_TRAIN["layers"]``, on the one-card mesh (state laid
    out by TRAIN_RULES, as ``launch.train`` does) on uniform random tokens
    (``SyntheticLM``): moe_impl="ep" with remat="save_a2a" against
    remat="full" and against gspmd, at a factor where nothing drops."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import Runtime, get_model
    from repro_torch.models.moe import recording_drops
    from repro_torch.sharding import TRAIN_RULES, tree_shardings
    from repro_torch.sharding.context import activation_sharding, distribute
    from repro_torch.train import (OptConfig, TrainConfig, init_train_state,
                                   make_train_step)
    from repro_torch.train.optimizer import opt_state_specs

    run = EP_TRAIN
    full_cfg = get_config(EP_ARCH)
    cfg = full_cfg.replace(n_layers=run["layers"])
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=run["seq_len"],
                                  global_batch=run["global_batch"]))
    gc.collect()
    torch.cuda.empty_cache()
    factor = _ep_train_factor(cfg, data, mesh)
    cfg = cfg.replace(moe_capacity_factor=factor)
    model = get_model(cfg)
    variants = (("ep save_a2a", Runtime(remat="save_a2a", moe_impl="ep")),
                ("ep full", Runtime(remat="full", moe_impl="ep")),
                ("gspmd full", Runtime(remat="full")))
    print(f"[ep] 9b {cfg.name} at full width (d {cfg.d_model}, "
          f"{cfg.moe_experts} experts of d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}), depth cut from {full_cfg.n_layers} to "
          f"{cfg.n_layers} layers ({cfg.param_count() / 1e9:.3f} B "
          f"parameters: bf16 with a float32 master and AdamW's moments, "
          f"~16 bytes a parameter, so {full_cfg.n_layers} layers' "
          f"{full_cfg.param_count() / 1e9:.1f} B do not fit 80 GB); "
          f"batch {run['global_batch']} x {run['seq_len']} uniform random "
          f"tokens, capacity factor {factor}")
    out = {"factor": factor}
    for label, rt in variants:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tc = TrainConfig(opt=OptConfig(lr=run["lr"], warmup_steps=2,
                                       total_steps=run["steps"]),
                         runtime=rt)
        state = init_train_state(model, 0, tc, device="cuda")
        pspecs = model.param_specs()
        logical = {"params": pspecs, "opt": opt_state_specs(
            pspecs, tc.opt, has_master="master" in state["opt"])}
        state = distribute(state, tree_shardings(state, logical,
                                                 TRAIN_RULES, mesh))
        train_step = make_train_step(model, tc)
        losses, norms, walls, dropped = [], [], [], 0
        for step in range(run["steps"]):
            batch = _ep_train_batch(data, step, state["opt"]["step"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with activation_sharding(mesh, TRAIN_RULES), \
                    recording_drops() as drops:
                state, metrics = train_step(state, batch)
                loss = float(metrics["loss"])
            walls.append(time.perf_counter() - t0)
            losses.append(loss)
            norms.append(float(metrics["grad_norm"]))
            dropped += int(sum(int(n) for n in drops))
        peak = torch.cuda.max_memory_allocated()
        warm = statistics.median(walls[1:])
        print(f"[ep] 9b {label}: losses "
              f"{', '.join(f'{x:.6f}' for x in losses)}; gradient norms "
              f"{', '.join(f'{x:.6f}' for x in norms)}; pairs dropped "
              f"{dropped}; peak memory {peak / 2**30:.2f} GiB; step walls "
              f"{', '.join(f'{x:.4f}' for x in walls)}s (warm "
              f"{warm:.4f}s)")
        check(all(np.isfinite(losses)), f"9b {label}: losses {losses}")
        check(dropped == 0, f"9b {label}: {dropped} pairs dropped at "
                            f"capacity factor {factor}")
        out[label] = {"losses": losses, "norms": norms, "peak": peak,
                      "warm": warm}
        del state, train_step, metrics
    ref = out["gspmd full"]
    for label in ("ep save_a2a", "ep full"):
        got = out[label]
        rel = abs(got["losses"][0] - ref["losses"][0]) / ref["losses"][0]
        norm = abs(got["norms"][0] - ref["norms"][0]) / ref["norms"][0]
        later = max(abs(a - b) / b for a, b in zip(got["losses"][1:],
                                                   ref["losses"][1:]))
        print(f"[ep] 9b {label} against gspmd full, first step from the "
              f"same state: loss within {rel:.3e} relative (tolerance "
              f"{EP_LOSS_TOL}), gradient norm within {norm:.3e} (tolerance "
              f"{EP_GRAD_NORM_TOL}); later steps' losses (after updates "
              f"that differ) within {later:.3e}")
        check(rel <= EP_LOSS_TOL, f"9b {label}: first loss "
                                  f"{got['losses'][0]} against "
                                  f"{ref['losses'][0]}")
        check(norm <= EP_GRAD_NORM_TOL, f"9b {label}: first gradient norm "
                                        f"{got['norms'][0]} against "
                                        f"{ref['norms'][0]}")
        got["rel"] = rel
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_ep() -> dict:
    """Phase 9: expert parallelism (``models/moe_ep.py``) on the one-card
    mesh: qwen3-moe-30b-a3b served at full size and trained at full width
    through moe_impl="ep" against the sorted dispatch."""
    t0 = time.perf_counter()
    print("[ep] one card: the expert axis is a group of one, so each "
          "all-to-all exchanges with itself; more ranks run only on the "
          "CPU (gloo, tests/test_torch_moe_ep.py)")
    mesh = _ep_mesh()
    numbers = _ep_serve_phase(mesh)
    serve_s = time.perf_counter() - t0
    numbers["train"] = _ep_train_phase(mesh)
    numbers["phase_s"] = time.perf_counter() - t0
    print(f"[ep] phase 9 in {numbers['phase_s']:.1f}s (9a {serve_s:.1f}s, "
          f"9b {numbers['phase_s'] - serve_s:.1f}s)")
    return numbers


# --------------------------------------------------------------------------
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"[device] {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    phase_build()
    floor = floor_table(np.random.default_rng(3))
    rows = phase_kernels(np.random.default_rng(0), floor)
    launches, clean_wall, runner = phase_discover(floor)
    phase_service()
    resilient = phase_resilience(runner, dict(launches), clean_wall)
    phase_host()
    del runner
    rows.update(phase_llm_kernels(floor))
    launches.update(phase_serve())      # pchase, mha_d256: serve-run counts
    phase_train()
    ckpt = phase_checkpoint()
    mesh = phase_mesh()
    ep = phase_ep()
    print(f"[smoke] all phases passed in {time.perf_counter() - t0:.1f}s "
          f"(phase 7 {ckpt['phase_s']:.1f}s, phase 8 "
          f"{mesh['phase_s']:.1f}s, phase 9 {ep['phase_s']:.1f}s); "
          f"device_ms profiler sessions {SESSIONS}")

    replaces = {
        "pchase_batch": "src/repro/kernels/pchase_probe.py:81",
        "eviction_batch": "src/repro/kernels/pchase_probe.py:138",
        "stream_read": "src/repro/kernels/stream_probe.py:36",
        "stream_write": "src/repro/kernels/stream_probe.py:53",
        "pchase": "src/repro/kernels/pchase_probe.py:53",
        **{name: "src/repro/kernels/flash_attention.py:78"
           for name in ATTN_ROWS.values()},
        "wkv6": "src/repro/kernels/rwkv6_scan.py:74",
    }
    sources = {
        "pchase_batch": ("cuda", "src/repro_torch/kernels/csrc/pchase.cu"),
        "eviction_batch": ("cuda", "src/repro_torch/kernels/csrc/pchase.cu"),
        "stream_read": ("cuda",
                        "src/repro_torch/kernels/csrc/stream_probe.cu"),
        "stream_write": ("cuda",
                         "src/repro_torch/kernels/csrc/stream_probe.cu"),
        "pchase": ("cuda", "src/repro_torch/kernels/csrc/pchase.cu"),
        "wkv6": ("cuda", "src/repro_torch/kernels/csrc/wkv6.cu"),
    }
    paths = {**{name: None for name in ATTN_ROWS.values()},
             "mha": "serve qwen3-14b, qwen3-moe-30b-a3b; internlm2-1.8b "
                    "from its checkpoint (phase 7) and on a 1x1 "
                    "DeviceMesh (phase 8); qwen3-moe-30b-a3b through "
                    "moe_impl='ep' (models/moe_ep.py) on a 1x1 "
                    "DeviceMesh (phase 9)",
             "mha_d80": "serve zamba2-2.7b", "wkv6": "serve rwkv6-3b",
             "mha_d64": "serve musicgen-large",
             "mha_d256": "serve paligemma-3b (prefix-LM, P 256)",
             "pchase": None,
             "mha_f32": "qwen3-14b-smoke f32 prefill on the card",
             "mha_f32_d16": "qwen3-14b-smoke, qwen3-moe-30b-a3b-smoke, "
                            "zamba2-2.7b-smoke, musicgen-large-smoke, "
                            "paligemma-3b-smoke (prefix-LM, P 8) f32 "
                            "prefill on the card"}
    kernels = []
    for name, row in rows.items():
        route, source = sources.get(
            name, ("cuda", "src/repro_torch/kernels/" + row.get("source", "")))
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"],
            "path": paths.get(name, "discover_cuda (planned, fused)"),
            "ok": True,
            # the probe kernels' launches in the resilient run under
            # transient faults (phase 3c), read around that run alone
            **({"resilient_launches": resilient[name]}
               if name in resilient else {}),
            # the launches of the serve from the checkpoint (phase 7),
            # read around that run alone
            **({"checkpoint_launches": ckpt["mha"]} if name == "mha"
               else {}),
            # the launches of the serve on the one-card mesh (phase 8c),
            # read around that run alone
            **({"mesh_launches": mesh["mha"]} if name == "mha" else {}),
            # the launches of the expert-parallel serve (phase 9a), read
            # around its first run alone
            **({"ep_launches": ep["mha"]} if name == "mha" else {}),
            **{key: row[key] for key in (
                "device_ms", "library_device_ms", "bound_level",
                "per_load_ns", "per_load_cycles",
                "clocks_sm_mhz", "over_floor", "sass_chain", "shapes")
               if key in row},
        })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
