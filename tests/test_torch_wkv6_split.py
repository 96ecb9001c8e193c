"""The WKV6 kernels' two-pass split, held to the reference.

``csrc/wkv6.cu`` runs WKV6 in two kernels: every chunk's own terms at once,
then the state walked over the chunks.  ``wkv6_split_plain`` is that split
in plain PyTorch; these tests hold it to the plain chunked version, to the
Pallas ``wkv6_chunked_kernel`` in interpret mode and to the sequential
oracle ``ref.wkv6_ref`` on the same seeded numpy inputs, at the model's
strong decays too, and pin the Python side of the kernels' contract (the
scratch size, the shapes they take) to the source.  The CUDA kernels are
held to ``wkv6_plain`` on the card by ``chip_smoke.py``.

Tolerance: 1e-4 absolute and relative, float32 throughout; the forms
associate the decays differently (the reference's own sweep uses 1e-4).  At
the strong decays the absolute part is 1e-4 of the largest value, as on
the card.
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.rwkv6_scan import wkv6_chunked_kernel
from repro_torch.kernels import rwkv6_scan as ws

TOL = 1e-4


def _inputs(b, t, h, kd, vd, seed, strong=False):
    """Decays in (0.05, 0.98), or the model's w = exp(-exp(x)) with
    x ~ U(-6, 2.5) (w from about 5e-6 to 0.9975) when ``strong``."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((b, t, h, kd), dtype=np.float32)
    k = rng.standard_normal((b, t, h, kd), dtype=np.float32)
    v = rng.standard_normal((b, t, h, vd), dtype=np.float32)
    if strong:
        w = np.exp(-np.exp(rng.uniform(-6.0, 2.5, (b, t, h, kd))))
    else:
        w = rng.uniform(0.05, 0.98, (b, t, h, kd))
    u = rng.standard_normal((h, kd), dtype=np.float32)
    return r, k, v, w.astype(np.float32), u


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=atol)


@pytest.mark.parametrize("b,t,h,kd,vd,chunk", [
    (1, 64, 2, 8, 8, 16), (2, 64, 3, 16, 8, 32), (1, 96, 2, 64, 64, 32)])
def test_split_matches_plain_pallas_kernel_and_oracle(b, t, h, kd, vd, chunk):
    arrays = _inputs(b, t, h, kd, vd, seed=t + kd)
    y, s = ws.wkv6_split_plain(*map(torch.from_numpy, arrays), chunk)
    y_p, s_p = ws.wkv6_plain(*map(torch.from_numpy, arrays), chunk)
    jarrays = [jnp.asarray(a) for a in arrays]
    y_k, s_k = wkv6_chunked_kernel(*jarrays, chunk=chunk)
    y_r, s_r = ref.wkv6_ref(*jarrays)
    assert y.shape == (b, t, h, vd) and s.shape == (b, h, kd, vd)
    for want_y, want_s in ((y_p, s_p), (y_k, s_k), (y_r, s_r)):
        _close(y, want_y)
        _close(s, want_s)


@pytest.mark.parametrize("t,chunk", [(50, 16), (7, 32)])
def test_split_on_a_padded_ragged_tail_matches_the_oracle(t, chunk):
    """The wrapper's padding (r = k = v = 0, w = 1 past T) leaves the
    split's y and final state equal to the sequential oracle's."""
    arrays = _inputs(2, t, 2, 8, 8, seed=t)
    tp = -(-t // chunk) * chunk
    padded = [np.pad(a, ((0, 0), (0, tp - t), (0, 0), (0, 0)),
                     constant_values=1.0 if i == 3 else 0.0)
              for i, a in enumerate(arrays[:4])]
    y, s = ws.wkv6_split_plain(*map(torch.from_numpy, padded),
                               torch.from_numpy(arrays[4]), chunk)
    y_r, s_r = ref.wkv6_ref(*(jnp.asarray(a) for a in arrays))
    _close(y[:, :t], y_r)
    _close(s, s_r)


@pytest.mark.parametrize("b,t,h,kd,seed", [(1, 64, 2, 64, 3), (2, 96, 3, 8, 4)])
def test_split_stays_finite_and_exact_at_the_models_strong_decays(b, t, h, kd,
                                                                  seed):
    """-L over a chunk reaches the hundreds here, where e^{-L} would
    overflow; the split's weights are exp2 of differences <= 0 and stay
    finite, equal to the plain version and to the Pallas kernel."""
    arrays = _inputs(b, t, h, kd, kd, seed=seed, strong=True)
    lw = np.log(arrays[3].astype(np.float64)).reshape(b, -1, 32, h, kd)
    assert float((-lw.sum(axis=2)).max()) > 89.0   # e^{-L_C} overflows f32
    y, s = ws.wkv6_split_plain(*map(torch.from_numpy, arrays), 32)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    y_p, s_p = ws.wkv6_plain(*map(torch.from_numpy, arrays), 32)
    y_k, s_k = wkv6_chunked_kernel(*(jnp.asarray(a) for a in arrays),
                                   chunk=32)
    for want_y, want_s in ((y_p, s_p), (y_k, s_k)):
        want_y, want_s = np.asarray(want_y), np.asarray(want_s)
        _close(y, want_y, atol=TOL * float(np.abs(want_y).max()))
        _close(s, want_s, atol=TOL * float(np.abs(want_s).max()))


def _source() -> str:
    return (pathlib.Path(ws.__file__).parent / "csrc" / "wkv6.cu").read_text()


def test_scratch_and_shapes_are_the_ones_the_source_takes():
    """The wrapper sizes the scratch as the source's ``scratch_floats`` does
    (a launch with any other size is refused there), passes
    the chunk the source's lanes stand for, takes the head sizes of its
    switch, and names the two kernels it launches."""
    src = _source()
    assert f"constexpr int kC = {ws.CHUNK};" in src
    assert "(2LL * kd * kC + kd)" in src
    assert ws.scratch_floats(4, 512, 40, 64) == 4 * 40 * 16 * (2 * 64 * 32
                                                               + 64)
    cases = re.findall(r"case (\d+): return launch<(\d+)>", src)
    assert all(a == b for a, b in cases)
    assert tuple(int(a) for a, _ in cases) == ws.HEAD_SIZES
    for name in ws.KERNELS:
        assert re.search(rf"__global__ void __launch_bounds__\([^)]*\)\s+"
                         rf"{name}\(", src), name


@pytest.mark.parametrize("chunk,kd,vd", [(16, 64, 64), (32, 64, 32),
                                         (32, 12, 12)])
def test_kernel_wrapper_refuses_shapes_the_kernels_do_not_take(chunk, kd, vd):
    """Refused before anything is built or launched, so it raises here on
    the CPU as it would on the card."""
    r = torch.zeros(1, 32, 2, kd)
    v = torch.zeros(1, 32, 2, vd)
    with pytest.raises(ValueError, match="wkv6 kernel takes"):
        ws.wkv6_kernel(r, r, v, r, torch.zeros(2, kd), chunk)
