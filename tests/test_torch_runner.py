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

``TestHostRunnerProtocol`` is the ``"host"`` row of the reference's
conformance suite (``tests/test_runner_protocol.py``) re-pointed at the
port's ``HostRunner``: the protocol surface, real samples of the right
shape, the capability refusals the engine relies on, and bandwidth.
"""
from dataclasses import asdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.pchase_probe as ref_pchase
import repro.kernels.stream_probe as ref_stream
from repro.core.probes import PallasRunner, make_pallas_model
from repro_torch.core.engine.registry import space_probe_specs
from repro_torch.core.probes import (CudaRunner, HostRunner, ProbeRunner,
                                     make_cuda_model)
from repro_torch.kernels import ops

KIB, MIB = 1024, 1024**2
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


# --------------------------------------------------------------------------
# The host runner under the reference's conformance suite
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def host():
    return HostRunner(max_bytes=8 * MIB, iters=1 << 12)


def _probe_space(runner):
    """A (space, in-capacity array size) pair valid for any backend."""
    info = runner.spaces()[0]
    return info, min(info.max_bytes // 8, 64 * KIB)


class TestHostRunnerProtocol:
    def test_satisfies_probe_runner_protocol(self, host):
        assert isinstance(host, ProbeRunner)

    def test_declares_determinism(self, host):
        assert host.deterministic is False     # real wall-time samples

    def test_spaces_well_formed(self, host):
        infos = host.spaces()
        assert infos
        names = [i.name for i in infos]
        assert len(set(names)) == len(names)
        for i in infos:
            assert i.kind in ("cache", "scratchpad", "memory")
            assert i.max_bytes > 0

    def test_sample_shape_and_domain(self, host):
        info, ab = _probe_space(host)
        out = np.asarray(host.pchase(info.name, ab, 32, 7))
        assert out.shape == (7,)
        assert out.dtype.kind == "f"
        assert np.all(np.isfinite(out)) and np.all(out > 0)

    def test_batch_is_structurally_valid(self, host):
        info, ab = _probe_space(host)
        batch = np.asarray(host.pchase_batch(info.name, [ab, ab * 2, ab * 3],
                                             32, 7))
        assert batch.shape == (3, 7)
        assert np.all(np.isfinite(batch)) and np.all(batch > 0)

    def test_cold_capability_flag_respected(self, host):
        """Spaces without cold-pass support must be refused by measuring
        runners — the engine relies on the flag."""
        uncold = [i for i in host.spaces() if not i.supports_cold]
        assert uncold
        with pytest.raises(NotImplementedError):
            host.cold_chase(uncold[0].name, 64 * KIB, 32, 65)

    def test_amount_probe_refused(self, host):
        assert not [i for i in host.spaces() if i.supports_amount]
        with pytest.raises(NotImplementedError):
            host.amount_probe("anything", 0, 1, 4 * KIB, 7)

    def test_sharing_probe_refused(self, host):
        assert not [i for i in host.spaces() if i.supports_sharing]
        with pytest.raises(NotImplementedError):
            host.sharing_probe("a", "b", 4 * KIB, 7)

    def test_eviction_many_refused(self, host):
        with pytest.raises(NotImplementedError):
            host.eviction_many([("amount", "anything", 0, 1, 4 * KIB)], 7)

    def test_bandwidth_read_write_positive(self, host):
        for mode in ("read", "write"):
            bw = host.bandwidth("DRAM", mode)
            assert isinstance(bw, float) and bw > 0

    def test_registry_gates_cold_families(self, host):
        for info in host.spaces():
            families = {s.family for s in space_probe_specs(info)}
            assert "fetch_granularity" not in families
            assert "line_size" not in families
            assert "amount" not in families
