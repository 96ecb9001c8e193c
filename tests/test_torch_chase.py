"""The chase kernels' contracts, their latency bound and the runner's log.

The CUDA chase and eviction kernels walk their rows unrolled by 8 with a
remainder loop, so their plain versions, which the card holds them to
bit for bit, are pinned here to the reference package's Pallas kernels
(interpret mode) and pure-Python contracts at chain lengths on both sides
of the unroll.  The rest is what ``chip_smoke.py`` computes from what it
measures on the card, checked on hand-made inputs: the latency bound of a
launch from its rows' steps and footprints and the floor of each level,
the floor's chains, what sits between two loads in a SASS listing, and the
summary of ``CudaRunner``'s calibration log.  Tolerances: none; every
check is exact.
"""
import importlib.util
import os
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pchase_probe import (eviction_kernel_batch,
                                        eviction_reference,
                                        pchase_kernel_batch,
                                        pchase_reference)
from repro_torch.core.engine.scheduler import WorkItem, run_work_items
from repro_torch.core.probes import CudaRunner
from repro_torch.core.probes.runners import random_cycle
from repro_torch.kernels import ops
from repro_torch.kernels.pchase_probe import (FLOOR_UNROLL, FLOOR_VARIANTS,
                                              chase_floor,
                                              eviction_batch_plain,
                                              pchase_batch_plain)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAIN_LENGTHS = (1, 7, 8, 9, 6143, 6144)     # around the walk's unroll of 8
KIB, MIB = 1 << 10, 1 << 20
FLOORS = {"L1": 20.0, "L2": 140.0, "HBM": 250.0}      # ns a load, made up
L1, L2 = 216 * KIB, 50 * MIB


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def card() -> bool:
    """Whether a CUDA device is present, decided when a test runs."""
    return torch.cuda.is_available()


def _rows(rows: int, width: int, seed: int) -> np.ndarray:
    """(rows, width) zero-padded single cycles, the last over all slots."""
    rng = np.random.default_rng(seed)
    out = np.zeros((rows, width), dtype=np.int32)
    for i in range(rows):
        n = width if i == rows - 1 else int(rng.integers(1, width + 1))
        out[i, :n] = random_cycle(n, rng)
    return out


@pytest.mark.parametrize("length", CHAIN_LENGTHS)
def test_pchase_plain_matches_pallas_around_the_unroll(length):
    perms = _rows(3, 1024, seed=length)
    steps = np.array([length, length // 2, length], dtype=np.int32)
    got = pchase_batch_plain(torch.from_numpy(perms),
                             torch.from_numpy(steps)).numpy()
    pallas = np.asarray(pchase_kernel_batch(jnp.asarray(perms),
                                            jnp.asarray(steps)))
    ref = np.array([pchase_reference(perms[i], steps[i]) for i in range(3)],
                   dtype=np.int32)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("length", CHAIN_LENGTHS)
def test_eviction_plain_matches_pallas_around_the_unroll(length):
    perms, evictors = _rows(3, 1024, seed=length), _rows(3, 512, seed=9)
    probe = np.array([length, length, 3], dtype=np.int32)
    warm = np.array([0, length, min(length, 512)], dtype=np.int32)
    args = [torch.from_numpy(a) for a in (perms, evictors, warm, probe)]
    got = eviction_batch_plain(*args).numpy()
    pallas = np.asarray(eviction_kernel_batch(
        *(jnp.asarray(a) for a in (perms, evictors, warm, probe))))
    ref = np.array([eviction_reference(perms[i], evictors[i], warm[i],
                                       probe[i]) for i in range(3)],
                   dtype=np.int32)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, ref)
    # a row that never warms is the chase row, bit for bit
    np.testing.assert_array_equal(
        got[0], pchase_batch_plain(args[0], args[3]).numpy()[0])


@pytest.mark.parametrize("length", [6143, 6144])
def test_wrapping_row_matches_pallas_at_the_discovery_length(length, smoke):
    """``chip_smoke.py``'s wrapping row (a cycle through slot 0 and the top
    1024 of 2**19 slots): the checksum passes 2**31 and wraps as int32 in
    the plain versions, the Pallas kernels and the contracts alike."""
    rng = np.random.default_rng(length)
    perms = smoke._wrapping_row(1 << 19, rng)[None]
    steps = np.array([length], dtype=np.int32)
    got = pchase_batch_plain(torch.from_numpy(perms),
                             torch.from_numpy(steps)).numpy()
    ref = pchase_reference(perms[0], length)
    assert ref[1] < 0                           # positive loads: it wrapped
    np.testing.assert_array_equal(got[0], ref)
    np.testing.assert_array_equal(got, np.asarray(pchase_kernel_batch(
        jnp.asarray(perms), jnp.asarray(steps))))
    warm = np.array([1025], dtype=np.int32)
    got_e = eviction_batch_plain(*(torch.from_numpy(a) for a in (
        perms, perms, warm, steps))).numpy()
    np.testing.assert_array_equal(got_e, np.asarray(eviction_kernel_batch(
        *(jnp.asarray(a) for a in (perms, perms, warm, steps)))))
    np.testing.assert_array_equal(
        got_e[0], eviction_reference(perms[0], perms[0], 1025, length))


@pytest.mark.parametrize("at,value", [(0, 1 << 10), (100, -7), (5, 1 << 30)])
def test_leaving_row_loads_the_value_at_that_load(at, value, smoke):
    """The row the smoke run hands the kernels to see cursor -1: its chain
    is the original one up to load ``at``, which reads ``value``."""
    rng = np.random.default_rng(at)
    row = random_cycle(1 << 10, rng)
    bad = smoke._leaving_row(row, at, value)
    slot, seen = 0, []
    for _ in range(at + 1):
        seen.append(int(bad[slot]))
        slot = int(bad[slot]) if 0 <= bad[slot] < row.size else slot
    assert seen[-1] == value
    assert seen[:-1] == [pchase_reference(row, k)[0] for k in range(1, at + 1)]
    assert int((bad != row).sum()) == 1


@pytest.mark.parametrize("steps,footprints,want", [
    ([6144], [4 * KIB], (6144 * 20.0 / 1e6, "L1")),
    ([6144] * 64, [4 * KIB] * 64, (6144 * 20.0 / 1e6, "L1")),
    ([6144], [2 * MIB], (6144 * 140.0 / 1e6, "L2")),
    ([6144] * 64, [2 * MIB] * 64, (6144 * 250.0 / 1e6, "HBM")),
    ([6144] * 3, [4100, 2 * MIB, 2 * MIB], (6144 * 140.0 / 1e6, "L2")),
    ([6144, 512], [4 * KIB, 8 * MIB], (6144 * 20.0 / 1e6, "L1")),
    ([100, 100], [L1, L1 + 4], (100 * 140.0 / 1e6, "L2")),
], ids=["R1-4KiB", "R64-4KiB", "R1-2MiB", "R64-2MiB", "wrapping-row",
        "longest-row-decides", "at-the-L1-capacity"])
def test_latency_bound_takes_each_rows_level(steps, footprints, want, smoke):
    ms, level = smoke.latency_bound_ms(steps, footprints, FLOORS, L1, L2)
    assert level == want[1]
    assert ms == pytest.approx(want[0], rel=1e-12)


def test_level_of_sums_the_rows_past_l1_against_l2(smoke):
    """Rows past L1 share the L2: 25 of 2 MiB fit, 26 do not; rows that fit
    an SM's L1 stay there whatever the others do."""
    assert smoke.level_of([2 * MIB] * 25, L1, L2) == ["L2"] * 25
    assert smoke.level_of([2 * MIB] * 26 + [KIB], L1, L2) == \
        ["HBM"] * 26 + ["L1"]


def test_eviction_bound_adds_each_phase_at_its_level(smoke):
    ms, level = smoke.eviction_bound_ms(
        [0, 1024], [6144, 6144], [4 * KIB] * 2, [4 * KIB] * 2, FLOORS, L1,
        L2)
    assert (ms, level) == (pytest.approx((1024 + 6144) * 20.0 / 1e6),
                           "L1+L1")
    ms, level = smoke.eviction_bound_ms(
        [6144] * 64, [6144] * 64, [2 * MIB] * 64, [4 * KIB] * 64, FLOORS,
        L1, L2)
    assert (ms, level) == (pytest.approx(6144 * 270.0 / 1e6), "HBM+L1")


@pytest.mark.parametrize("footprint", [4 * KIB, 216 * KIB, 2 * MIB,
                                       256 * MIB])
def test_floor_chain_is_one_cycle_over_the_footprint(footprint, smoke):
    chain, slots = smoke.floor_chain(footprint, np.random.default_rng(1))
    assert chain.dtype == np.int32 and chain.size == footprint // 4
    stride = max(128, footprint // smoke.FLOOR_SLOTS)
    assert slots == footprint // stride <= smoke.FLOOR_SLOTS
    slot, seen = 0, set()
    for _ in range(slots):
        slot = int(chain[slot])
        seen.add(slot)
    assert slot == 0 and len(seen) == slots
    assert all(s % (stride // 4) == 0 for s in seen)


def test_chase_floor_raises_on_a_cpu_tensor(card):
    """The floor is a measurement of the card: no plain version runs."""
    chain = torch.zeros(32, dtype=torch.int32)
    with pytest.raises(ValueError if card else RuntimeError):
        chase_floor(chain, warm=32, rounds=1)


def test_chase_floor_raises_without_a_card(card):
    if card:
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chase_floor(torch.zeros(32, dtype=torch.int32), warm=0, rounds=1)


def test_chase_floor_is_no_wrapper_on_a_path():
    """Only the smoke run launches the floor: no wrapper tuple of ``ops``
    holds it and no wrapper counts it."""
    names = {fn.__name__ for fn in ops.WRAPPERS + ops.LLM_WRAPPERS}
    assert "chase_floor" not in names
    assert chase_floor not in ops.WRAPPERS + ops.LLM_WRAPPERS
    assert FLOOR_VARIANTS == ("load", "clamp", "check")


def test_floor_unroll_and_variants_match_the_source():
    src = open(os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                            "pchase.cu")).read()
    assert f"constexpr int kFloorUnroll = {FLOOR_UNROLL};" in src
    for i in range(len(FLOOR_VARIANTS)):
        assert f"case {i}: chase_floor_kernel<{i}>" in src
    assert "constexpr int kUnroll = 8;" in src


# A hand-written listing in cuobjdump's format: an unrolled pair of loads
# and a loop whose one load feeds the next through its back branch.
SASS = """
        /*0000*/                   LDC.64 R16, c[0x0][0x210] ;
        /*0010*/                   IMAD.WIDE.U32 R12, R5, 0x4, R16 ;
        /*0020*/                   LDG.E R11, desc[UR4][R12.64] ;
        /*0030*/                   IADD3 R4, R4, 0x1, RZ ;
        /*0040*/                   VIMNMX.U32 R15, R2, R11, PT ;
        /*0050*/                   IMAD.WIDE.U32 R14, R15, 0x4, R16 ;
        /*0060*/                   LDG.E R3, desc[UR4][R14.64] ;
        /*0070*/                   IADD3 R6, R6, R3, RZ ;
        /*0080*/                   ISETP.GE.U32.AND P0, PT, R3, R2, PT ;
        /*0090*/              @P0 BRA 0x100 ;
        /*00a0*/                   MOV R5, R3 ;
        /*00b0*/                   IMAD.WIDE R8, R5, 0x4, R16 ;
        /*00c0*/                   LDG.E R3, desc[UR4][R8.64] ;
        /*00d0*/                   ISETP.NE.AND P1, PT, R4, RZ, PT ;
        /*00e0*/              @P1 BRA 0xa0 ;
        /*0100*/                   STG.E desc[UR4][R8.64], R6 ;
        /*0110*/                   EXIT ;
"""


def test_load_chains_follows_registers_predicates_and_back_branches(smoke):
    chains = Counter(smoke.load_chains(SASS))
    assert chains == Counter({
        ("VIMNMX.U32", "IMAD.WIDE.U32"): 1,
        ("IADD3", "ISETP.GE.U32.AND", "BRA", "MOV", "IMAD.WIDE"): 1,
        ("MOV", "IMAD.WIDE"): 1})


def test_calibration_log_has_one_entry_per_timed_loop():
    """Each timed loop of the runner leaves its family, its rows' and its
    calibration's footprints (slots x 4 B) and a ratio."""
    runner = CudaRunner(device="cpu", base_steps=256)
    runner.pchase_batch("L1", [4096, 8192], 64, 3)
    runner.pchase("L1", 2048, 32, 3)
    runner.cold_chase_batch("L1", [4096, 8192], [32, 64], 6)
    runner.eviction_many([("amount", "L1", 0, 1, 8192)], 3)
    entries = runner.calibrations
    assert [e["loop"] for e in entries] == ["grid", "grid", "cold", "evict"]
    # 4096 and 8192 B at a 64 B step: 64 and 128 slots, a 128-slot bucket
    assert entries[0]["request_bytes"] == [4 * 64, 4 * 128]
    assert entries[0]["calibration_bytes"] == 4 * 128
    assert entries[1]["request_bytes"] == [4 * 64]        # 2048 B at 32 B
    assert entries[1]["calibration_bytes"] == 4 * 64
    # a cold row holds one slot a sample: 6, in a bucket of 8
    assert entries[2]["request_bytes"] == [4 * 6, 4 * 6]
    assert entries[2]["calibration_bytes"] == 4 * 8
    assert entries[3]["request_bytes"] == [4 * 128]       # 8192 B at 64 B
    assert entries[3]["calibration_bytes"] == 4 * 128
    assert all(e["family"] == "" and e["ratio"] > 0 and e["launch_s"] > 0
               and e["buffer_s"] > 0 for e in entries)
    assert sum(e["buffer_s"] for e in entries) == \
        pytest.approx(runner.buffer_seconds)


def test_calibration_log_names_the_family_the_scheduler_runs():
    runner = CudaRunner(device="cpu", base_steps=256)
    items = [WorkItem(key="a", family="size",
                      fn=lambda _: runner.pchase("L1", 2048, 32, 3)),
             WorkItem(key="b", family="latency", deps=("a",),
                      fn=lambda _: runner.pchase("L1", 1024, 32, 3))]
    run_work_items(items, max_workers=0)
    assert [e["family"] for e in runner.calibrations] == ["size", "latency"]
    runner.pchase("L1", 1024, 32, 3)
    assert runner.calibrations[-1]["family"] == ""


def test_calibration_summary_counts_rows_across_the_l1_capacity(smoke):
    entries = [
        {"family": "size", "loop": "grid", "ratio": 0.9, "launch_s": 0.5, "buffer_s": 2.0,
         "request_bytes": [4 * KIB, 200 * KIB, 300 * KIB],
         "calibration_bytes": 256 * KIB},
        {"family": "size", "loop": "grid", "ratio": 1.2, "launch_s": 0.25, "buffer_s": 1.0,
         "request_bytes": [64 * KIB], "calibration_bytes": 64 * KIB},
        {"family": "amount", "loop": "evict", "ratio": 1.0, "launch_s": 0.1, "buffer_s": 0.0,
         "request_bytes": [8 * KIB], "calibration_bytes": 8 * KIB}]
    got = smoke.calibration_summary(entries, L1)
    assert got["size"] == {"loops": 2, "rows": 4, "ratio_min": 0.9,
                           "ratio_median": pytest.approx(1.05),
                           "ratio_max": 1.2, "straddling_rows": 2,
                           "launch_s": 0.75, "buffer_s": 3.0}
    assert got["amount"]["straddling_rows"] == 0
    assert set(got) == {"size", "amount"}
