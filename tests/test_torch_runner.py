"""``CudaRunner`` against the reference package's ``PallasRunner``.

Both runners draw their chase buffers from one numpy RNG in the same order,
so for one model and seed they must hand their kernels the very same
arrays, launch for launch, and keep the same counters.  Every kernel call
is recorded here (the reference's Pallas kernels are replaced by recording
stubs, since only the arrays are compared); the timings themselves differ
and are not compared.

The calibration invariant the timing rests on: within one timed loop,
every calibration launch has the request's launch shape and the request's
per-row chain lengths, and uses other buffers than the request.
"""
from dataclasses import asdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.pchase_probe as ref_pchase
import repro.kernels.stream_probe as ref_stream
from repro.core.probes import PallasRunner, make_pallas_model
from repro_torch.core.probes import CudaRunner, make_cuda_model
from repro_torch.kernels import ops

KIB = 1024
N_SAMPLES = 5
RUNNER_KW = dict(base_steps=256, bandwidth_bytes=1 << 16, seed=11)

# One scripted call per runner capability the discovery path uses.
SCRIPT = [
    ("pchase", ("L1", 8 * KIB, 32, N_SAMPLES)),
    ("pchase_batch", ("L1", [4 * KIB, 8 * KIB, 24 * KIB, 40 * KIB], 32,
                      N_SAMPLES)),
    ("pchase_many", ([("L1", 2 * KIB, 32), ("VMEM", 4 * KIB, 4),
                      ("L2", 300 * KIB, 128)], N_SAMPLES)),
    ("cold_chase_batch", ("L1", [64 * KIB, 64 * KIB], [32, 64], 16)),
    ("eviction_many", ([("amount", "L1", 0, 1, 14 * KIB),
                        ("amount", "L1", 0, 4, 14 * KIB),
                        ("sharing", "L1", "L2", 14 * KIB)], N_SAMPLES)),
    ("bandwidth", ("L2", "read")),
    ("bandwidth", ("L2", "write")),
    ("pchase", ("L1", 8 * KIB, 32, N_SAMPLES)),     # warmed shape, cached perm
]


def _np(t) -> np.ndarray:
    return np.array(t.cpu()) if isinstance(t, torch.Tensor) else np.array(t)


def _record_port(monkeypatch, calls):
    originals = {name: getattr(ops, name) for name in
                 ("pchase_batch", "eviction_batch", "stream_read",
                  "stream_write")}

    def pchase_batch(perms, steps):
        calls.append(("pchase", _np(perms), _np(steps)))
        return originals["pchase_batch"](perms, steps)

    def eviction_batch(perms, evictors, warm, probe):
        calls.append(("evict", _np(perms), _np(evictors), _np(warm),
                      _np(probe)))
        return originals["eviction_batch"](perms, evictors, warm, probe)

    def stream_read(x, *, block):
        calls.append(("read", _np(x), np.array(block)))
        return originals["stream_read"](x, block=block)

    def stream_write(x, *, block):
        calls.append(("write", _np(x), np.array(block)))
        return originals["stream_write"](x, block=block)

    for fn in (pchase_batch, eviction_batch, stream_read, stream_write):
        monkeypatch.setattr(ops, fn.__name__, fn)


def _record_reference(monkeypatch, calls):
    def pchase_kernel_batch(perms, steps, *, interpret=True):
        calls.append(("pchase", _np(perms), _np(steps)))
        return jnp.zeros((perms.shape[0], 2), jnp.int32)

    def eviction_kernel_batch(perms, evictors, warm, probe, *,
                              interpret=True):
        calls.append(("evict", _np(perms), _np(evictors), _np(warm),
                      _np(probe)))
        return jnp.zeros((perms.shape[0], 2), jnp.int32)

    def stream_read_kernel(x, *, block, interpret=True):
        calls.append(("read", _np(x), np.array(block)))
        return jnp.zeros(x.shape[0] // block, jnp.float32)

    def stream_write_kernel(x, *, block, interpret=True):
        calls.append(("write", _np(x), np.array(block)))
        return x

    monkeypatch.setattr(ref_pchase, "pchase_kernel_batch",
                        pchase_kernel_batch)
    monkeypatch.setattr(ref_pchase, "eviction_kernel_batch",
                        eviction_kernel_batch)
    monkeypatch.setattr(ref_stream, "stream_read_kernel", stream_read_kernel)
    monkeypatch.setattr(ref_stream, "stream_write_kernel",
                        stream_write_kernel)


def _run_script(runner, calls) -> list[list]:
    """The recorded kernel calls of each scripted call, in order."""
    per_call = []
    for method, args in SCRIPT:
        start = len(calls)
        out = getattr(runner, method)(*args)
        assert np.all(np.isfinite(out))
        per_call.append(calls[start:])
    return per_call


@pytest.fixture(scope="module")
def recorded():
    mp = pytest.MonkeyPatch()
    try:
        port_calls, ref_calls = [], []
        _record_port(mp, port_calls)
        _record_reference(mp, ref_calls)
        port = CudaRunner(make_cuda_model(), device="cpu", **RUNNER_KW)
        ref = PallasRunner(make_pallas_model(), **RUNNER_KW)
        port_script = _run_script(port, port_calls)
        ref_script = _run_script(ref, ref_calls)
    finally:
        mp.undo()
    return {"port": port, "ref": ref, "port_script": port_script,
            "ref_script": ref_script}


def test_models_share_one_ground_truth():
    port, ref = make_cuda_model(), make_pallas_model()
    assert port.name == "cuda-model"
    assert [asdict(lvl) for lvl in port.levels] == \
        [asdict(lvl) for lvl in ref.levels]
    assert port.seed == ref.seed
    assert port.cores_per_sm == ref.cores_per_sm
    assert port.space_of_level == ref.space_of_level
    assert port.ground_truth() == ref.ground_truth()


@pytest.mark.parametrize("step", range(len(SCRIPT)),
                         ids=[f"{i}-{m}" for i, (m, _) in enumerate(SCRIPT)])
def test_kernels_receive_identical_arrays(recorded, step):
    port = recorded["port_script"][step]
    ref = recorded["ref_script"][step]
    assert len(port) == len(ref) > 0
    for got, want in zip(port, ref):
        assert got[0] == want[0]
        assert len(got) == len(want)
        for a, b in zip(got[1:], want[1:]):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_counters_match(recorded):
    port, ref = recorded["port"], recorded["ref"]
    assert port.kernel_calls == ref.kernel_calls > 0
    assert port.eviction_grid_calls == ref.eviction_grid_calls == 1
    assert port.eviction_grid_rows == ref.eviction_grid_rows == 3


@pytest.mark.parametrize("step", [i for i, (m, _) in enumerate(SCRIPT)
                                  if m != "bandwidth"],
                         ids=[f"{i}-{m}" for i, (m, _) in enumerate(SCRIPT)
                              if m != "bandwidth"])
def test_calibration_matches_request_launch_profile(recorded, step):
    """Rows run at once on the card, so a launch's wall follows its
    longest row: the request/calibration ratio is sound only because every
    launch of one timed loop has one shape and one set of chain lengths."""
    launches = recorded["port_script"][step]
    kind = launches[0][0]
    # every array after the buffers: chain lengths (and warm lengths)
    n_buffers = 2 if kind == "evict" else 1
    shapes = {tuple(a.shape for a in c[1:1 + n_buffers]) for c in launches}
    lengths = {tuple(a.tobytes() for a in c[1 + n_buffers:])
               for c in launches}
    assert len(shapes) == 1 and len(lengths) == 1
    buffers = {}
    for c in launches:
        key = tuple(a.tobytes() for a in c[1:1 + n_buffers])
        buffers[key] = buffers.get(key, 0) + 1
    assert len(buffers) == 2                   # request and calibration
    assert sorted(buffers.values())[0] == 3    # three calibration launches
