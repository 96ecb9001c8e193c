"""The port's probe kernels, held to the reference package's.

On the CPU the wrappers in ``repro_torch.kernels.ops`` run the kernels'
plain PyTorch versions, so these tests pin those versions to the Pallas
kernels (interpret mode) and to the pure-Python contracts.  The CUDA
kernels themselves are held to the same plain versions on the card
by ``chip_smoke.py``; here only the contract between the wrappers and the
CUDA sources (entry points, argument counts, tile constants) is read from
the sources.

Tolerances: the chase and eviction rows are integer contracts and must be
bit-exact (int32 checksum wrap-around included); ``stream_write`` adds 1.0
to float32 values and must be exact; ``stream_read`` sums 2**15 float32
values per block in another order than XLA, so it is held to rtol 1e-5
(float32 pairwise-sum error over 2**15 positive terms is below 1e-6).
"""
import os
import pathlib
import re
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pchase_probe import (eviction_kernel_batch,
                                        eviction_reference,
                                        pchase_kernel_batch,
                                        pchase_reference)
from repro.kernels.stream_probe import stream_read_kernel, stream_write_kernel
from repro_torch.core.probes.runners import random_cycle
from repro_torch.kernels import _build, ops, stream_probe
from repro_torch.kernels.pchase_probe import (eviction_batch_plain,
                                              pchase_batch_plain)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _padded_cycles(rows: int, width: int, rng) -> np.ndarray:
    """(rows, width) zero-padded single cycles over a random prefix each."""
    out = np.zeros((rows, width), dtype=np.int32)
    for i in range(rows):
        n = int(rng.integers(1, width + 1))
        out[i, :n] = random_cycle(n, rng)
    return out


def _chase_case(rows: int, width: int, seed: int):
    rng = np.random.default_rng(seed)
    perms = _padded_cycles(rows, width, rng)
    evictors = _padded_cycles(rows, width, rng)
    steps = rng.integers(0, 3 * width, rows).astype(np.int32)
    warm = rng.integers(0, 2 * width, rows).astype(np.int32)
    steps[0] = 0                       # a row that never loads
    warm[rows // 2] = 0                # the pchase bit-identity anchor
    return perms, evictors, steps, warm


CHASE_SHAPES = [(r, n) for r in (1, 5, 17) for n in (16, 1024)]


@pytest.mark.parametrize("rows,width", CHASE_SHAPES)
def test_pchase_plain_matches_pallas_and_reference(rows, width):
    perms, _, steps, _ = _chase_case(rows, width, seed=rows * width)
    got = ops.pchase_batch(torch.from_numpy(perms), torch.from_numpy(steps))
    pallas = np.asarray(pchase_kernel_batch(jnp.asarray(perms),
                                            jnp.asarray(steps)))
    ref = np.array([pchase_reference(perms[i], steps[i])
                    for i in range(rows)], dtype=np.int32)
    assert got.dtype == torch.int32 and got.shape == (rows, 2)
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("rows,width", CHASE_SHAPES)
def test_eviction_plain_matches_pallas_and_reference(rows, width):
    perms, evictors, steps, warm = _chase_case(rows, width, seed=7 + rows)
    args = [torch.from_numpy(a) for a in (perms, evictors, warm, steps)]
    got = ops.eviction_batch(*args).numpy()
    pallas = np.asarray(eviction_kernel_batch(
        jnp.asarray(perms), jnp.asarray(evictors), jnp.asarray(warm),
        jnp.asarray(steps)))
    ref = np.array([eviction_reference(perms[i], evictors[i], warm[i],
                                       steps[i]) for i in range(rows)],
                   dtype=np.int32)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, ref)
    # warm == 0 rows equal the plain chase rows bit for bit
    chase = pchase_batch_plain(args[0], args[3]).numpy()
    cold = warm == 0
    np.testing.assert_array_equal(got[cold], chase[cold])


def _wrapping_rows(width: int, rows: int, rng) -> np.ndarray:
    """Single cycles through slot 0 and the top 256 slots: their values are
    near ``width``, so a few tens of thousands of loads pass 2**31."""
    out = np.zeros((rows, width), dtype=np.int32)
    top = np.arange(width - 256, width, dtype=np.int32)
    for i in range(rows):
        order = np.concatenate([[0], rng.permutation(top)]).astype(np.int32)
        out[i, order] = np.roll(order, -1)
    return out


def test_checksum_wraps_like_int32():
    rng = np.random.default_rng(3)
    width = 1 << 16
    perms = _wrapping_rows(width, 2, rng)
    evictors = _wrapping_rows(width, 2, rng)
    steps = np.array([40000, 33000], dtype=np.int32)
    warm = np.array([0, 20000], dtype=np.int32)
    got = pchase_batch_plain(torch.from_numpy(perms),
                             torch.from_numpy(steps)).numpy()
    ref = [pchase_reference(perms[i], steps[i]) for i in range(2)]
    assert all(c < 0 for _, c in ref)          # positive loads: it wrapped
    np.testing.assert_array_equal(got, np.array(ref, dtype=np.int32))
    pallas = np.asarray(pchase_kernel_batch(jnp.asarray(perms),
                                            jnp.asarray(steps)))
    np.testing.assert_array_equal(got, pallas)
    got_e = eviction_batch_plain(*(torch.from_numpy(a) for a in
                                   (perms, evictors, warm, steps))).numpy()
    ref_e = [eviction_reference(perms[i], evictors[i], warm[i], steps[i])
             for i in range(2)]
    np.testing.assert_array_equal(got_e, np.array(ref_e, dtype=np.int32))


@pytest.mark.parametrize("n,block", [(1 << 17, 1 << 15), (1 << 16, 1 << 16),
                                     (3 * 1001, 1001)])
def test_stream_read_matches_pallas(n, block):
    x = np.random.default_rng(n).random(n, dtype=np.float32)
    got = ops.stream_read(torch.from_numpy(x), block=block).numpy()
    want = np.asarray(stream_read_kernel(jnp.asarray(x), block=block))
    assert got.dtype == np.float32 and got.shape == (n // block,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("n", [1 << 16, 1 << 17])
def test_stream_write_matches_pallas(n):
    x = (np.random.default_rng(n).random(n, dtype=np.float32) - 0.5) * 1e3
    got = ops.stream_write(torch.from_numpy(x), block=1 << 15).numpy()
    want = np.asarray(stream_write_kernel(jnp.asarray(x), block=1 << 15))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["read", "write"])
def test_stream_length_off_the_block_fails_in_both_packages(mode):
    """A length that is not a multiple of ``block`` is refused by the
    reference's assert and by the port's ``ValueError``, before any
    launch."""
    n, block = 3 * 1001 + 1, 1001
    x = np.zeros(n, dtype=np.float32)
    ref_fn = stream_read_kernel if mode == "read" else stream_write_kernel
    port_fn = ops.stream_read if mode == "read" else ops.stream_write
    with pytest.raises(AssertionError):
        ref_fn(jnp.asarray(x), block=block)
    ops.reset_launches()
    with pytest.raises(ValueError, match="not a multiple of block"):
        port_fn(torch.from_numpy(x), block=block)
    assert port_fn.launches == 0


def _entry_points() -> dict:
    """Each ``extern "C"`` function of ``csrc/*.cu``: its parameter count."""
    found = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for name, params in re.findall(
                r'extern "C" [\w ]+?\*?\s*(\w+)\(([^)]*)\)', src.read_text()):
            found[name] = len([p for p in params.split(",") if p.strip()])
    return found


def test_every_entry_point_has_a_signature_of_its_arity():
    """ctypes passes what ``_SIGNATURES`` says: a missing or miscounted
    entry would cut a pointer or shift every argument after it."""
    found = _entry_points()
    assert {"stream_read_fwd", "stream_write_fwd",
            "flash_attention_sm90_fwd", "flash_attention_fwd"} <= set(found)
    assert set(found) == set(_build._SIGNATURES)
    for name, arity in found.items():
        assert len(_build._SIGNATURES[name][0]) == arity, name


def test_stream_read_slice_matches_its_source():
    """The wrapper sizes the partials buffer by the kernel's slice."""
    src = (pathlib.Path(_build.CSRC) / "stream_probe.cu").read_text()
    assert f"constexpr int kSlice = {stream_probe.READ_SLICE};" in src


def test_stream_write_slice_matches_its_source():
    """``WRITE_SLICE`` is the write kernel's slice, one CTA's elements."""
    src = (pathlib.Path(_build.CSRC) / "stream_probe.cu").read_text()
    assert f"constexpr int kWriteSlice = {stream_probe.WRITE_SLICE};" in src
    assert "stream_write_kernel<<<" in src


def test_wrappers_count_each_launch_on_cpu():
    ops.reset_launches()
    perms = torch.zeros((2, 4), dtype=torch.int32)
    steps = torch.ones(2, dtype=torch.int32)
    x = torch.zeros(8, dtype=torch.float32)
    ops.pchase_batch(perms, steps)
    ops.pchase_batch(perms, steps)
    ops.eviction_batch(perms, perms, steps, steps)
    ops.stream_read(x, block=4)
    ops.stream_write(x, block=4)
    assert [fn.launches for fn in ops.WRAPPERS] == [2, 1, 1, 1]
    ops.reset_launches()
    assert [fn.launches for fn in ops.WRAPPERS] == [0, 0, 0, 0]


@pytest.mark.parametrize("call,exc", [
    (lambda: ops.pchase_batch(torch.zeros((2, 4), dtype=torch.int64),
                              torch.ones(2, dtype=torch.int32)), TypeError),
    (lambda: ops.pchase_batch(torch.zeros(4, dtype=torch.int32),
                              torch.ones(1, dtype=torch.int32)), ValueError),
    (lambda: ops.pchase_batch(torch.zeros((4, 2), dtype=torch.int32).t(),
                              torch.ones(2, dtype=torch.int32)), ValueError),
    (lambda: ops.pchase_batch(torch.zeros((2, 4), dtype=torch.int32),
                              torch.ones(3, dtype=torch.int32)), ValueError),
    (lambda: ops.eviction_batch(torch.zeros((2, 4), dtype=torch.int32),
                                torch.zeros((1, 4), dtype=torch.int32),
                                torch.ones(2, dtype=torch.int32),
                                torch.ones(2, dtype=torch.int32)),
     ValueError),
    (lambda: ops.stream_read(torch.zeros(10), block=4), ValueError),
    (lambda: ops.stream_write(torch.zeros(8, dtype=torch.float64)),
     TypeError),
    (lambda: ops.stream_write(torch.zeros(8, device="meta"), block=4),
     ValueError),
    (lambda: ops.stream_write(torch.zeros(10), block=4), ValueError),
    (lambda: ops.stream_write(torch.zeros(8), block=0), ValueError),
])
def test_wrappers_reject_what_the_kernels_do_not_take(call, exc):
    ops.reset_launches()
    with pytest.raises(exc):
        call()
    assert all(fn.launches == 0 for fn in ops.WRAPPERS)


def test_cuda_without_a_card_raises_instead_of_running_on_cpu():
    from repro_torch.core import discover_cuda
    from repro_torch.core.probes import CudaRunner

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CudaRunner()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        discover_cuda()


_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("repro_torch.kernels.flash_attention",
             "repro_torch.kernels.rwkv6_scan", "repro_torch.configs",
             "repro_torch.models.transformer", "repro_torch.models.rwkv6",
             "repro_torch.models.convert", "repro_torch.models.model",
             "repro_torch.serve.engine", "repro_torch.launch.serve"):
    assert name in names, name
import chip_smoke
import torch
from repro_torch.kernels import ops
ops.stream_write(torch.zeros(8), block=4)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
assert "triton" not in sys.modules
"""


def test_port_imports_neither_jax_nor_the_reference():
    code = _IMPORT_ALL.format(src=os.path.join(ROOT, "src"), root=ROOT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.split(" ", 1)
    assert int(count) >= 53 and bad.strip() == "[]"


def test_port_holds_no_triton_kernel():
    """Every kernel of the port is CUDA C++: no source of the package, and
    not ``chip_smoke.py``, imports ``triton``."""
    sources = list(pathlib.Path(ROOT, "src", "repro_torch").rglob("*.py"))
    sources.append(pathlib.Path(ROOT, "chip_smoke.py"))
    assert len(sources) > 50
    for path in sources:
        assert not re.search(r"^\s*(import|from)\s+triton\b",
                             path.read_text(), re.M), path


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card_or_a_checkout(alone, tmp_path):
    """No CUDA device here: the smoke run must exit non-zero and print no
    result line, in the checkout and in a directory holding it alone."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = os.path.join(ROOT, "chip_smoke.py")
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, env=env, cwd=os.path.dirname(script),
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_splits_device_events_at_its_markers():
    """The smoke run tells the device events of its calls apart by the
    marker kernel between them, in the device's order, never by the host's
    clock: each part holds what ran between two markers, and the parts
    before the first and after the last are there (empty or not)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    events = [("mark", 1.0), ("k", 2.0), ("mark", 1.0), ("k", 2.5),
              ("Memset", 0.5), ("k", 2.0), ("mark", 1.0), ("late", 3.0)]
    assert smoke.split_at_marks(events, "mark") == [
        [], [("k", 2.0)], [("k", 2.5), ("Memset", 0.5), ("k", 2.0)],
        [("late", 3.0)]]
    assert smoke.split_at_marks([], "mark") == [[]]
    # a session opens with uncounted markers, of which one may be missing,
    # and must end with one; its parts are counted from the end
    session = [("mark", 1.0)] * smoke.LEAD_IN + events[1:-1]
    for lead_lost in (0, 1):
        got = smoke.marked_parts(session[lead_lost:], "mark", 2)
        assert got == [[("k", 2.0)], [("k", 2.5), ("Memset", 0.5),
                                      ("k", 2.0)]]
    assert smoke.marked_parts(events, "mark", 2) is None      # after last
    assert smoke.marked_parts(session[:-1], "mark", 2) is None
    assert smoke.marked_parts([("k", 1.0)] + session, "mark", 2) is None
