"""Attention past head dim 256 and WKV6 past K or V 128, held to the
reference.

The reference's ``flash_attention`` has no bound on the head dim and its
``wkv6_chunked_kernel`` none on K or V.  The port runs every d in bfloat16
on ``csrc/flash_attention_sm90.cu`` (tensor cores) and every d in float32
on ``csrc/flash_attention.cu`` (CUDA cores) (``flash_attention.kernel_for``):
past 256 each source's second kernel, at the instantiations 320, 384, 448
and 512, and past 512 in column slices of at most 512 that compute the
scores over the whole row (``flash_attention.column_slices``).  Their plain
versions are ``flash_attention_plain`` in float32 and
``flash_attention_sm90_plain`` in bfloat16 (the tensor-core kernels'
numerics: probabilities rounded to bfloat16 for P.V, ``sm90_tile(d)``-key
tiles: 64 up to the d 320 instantiation, 32 past it).  WKV6 past 128 is
split above the route in ``ops.wkv6``: K and V cut into slices of at most
128, y summed over the K slices and the state concatenated; on the CPU
each slice runs ``wkv6_plain``.

Here ``ops.mha``, ``flash_attention_sm90_plain`` and ``ops.wkv6`` on the
CPU are held to the reference's Pallas kernels in interpret mode (and
WKV6 also to the sequential ``wkv6_ref``) on the same seeded numpy inputs.
Tolerances: attention in float32 rtol = atol = 2e-5 (the online and the
dense softmax sum in other orders); in bfloat16 rtol 2**-7 (one ulp of the
output) and atol 2**-8 max|v| (each probability rounded to bfloat16 moves
by at most 2**-9 of itself, so an output by at most 2**-9 max|v|; twice
that); WKV6 rtol 1e-4 plus atol 1e-4 max|want| (the chunked forms and the
split's sum over K slices associate in other orders).
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention
from repro.kernels.rwkv6_scan import wkv6_chunked_kernel
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6_scan as ws

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
WKV_TOL = 1e-4


def _attention_inputs(b, hq, hkv, s, d, dtype, seed):
    t_dtype, j_dtype = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((b, s, h, d), dtype=np.float32)
              for h in (hq, hkv, hkv)]
    torch_in = [torch.from_numpy(a).to(t_dtype) for a in arrays]
    jax_in = [jnp.swapaxes(jnp.asarray(a, j_dtype), 1, 2) for a in arrays]
    return torch_in, jax_in


def _assert_attention_close(got, want, v, dtype):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        atol = 2 ** -8 * float(v.float().abs().max())
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=atol)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [264, 320, 384, 512, 640])
def test_mha_past_head_dim_256_matches_pallas(d, dtype, causal):
    (tq, tk, tv), (jq, jk, jv) = _attention_inputs(1, 4, 2, 128, d, dtype,
                                                   seed=d + causal)
    want = jnp.swapaxes(flash_attention(jq, jk, jv, causal=causal,
                                        block_q=64, block_k=64), 1, 2)
    ops.reset_launches()
    got = ops.mha(tq, tk, tv, causal=causal)
    assert ops.mha.launches == 1
    assert got.dtype == tq.dtype and tuple(got.shape) == (1, 128, 4, d)
    _assert_attention_close(got, want, tv, dtype)
    if dtype == "bfloat16":
        emulated = fa.flash_attention_sm90_plain(tq, tk, tv, causal)
        _assert_attention_close(emulated, want, tv, dtype)


def test_mha_pads_a_ragged_causal_prompt_past_head_dim_256():
    (tq, tk, tv), (jq, jk, jv) = _attention_inputs(1, 4, 1, 100, 300,
                                                   "float32", seed=3)
    want = jnp.swapaxes(ref.attention_ref(jq, jk, jv, causal=True), 1, 2)
    _assert_attention_close(ops.mha(tq, tk, tv), want, tv, "float32")


# head dim -> (instantiation, column slices, row width in bfloat16, in
# float32, the bfloat16 kv tile)
PAST_256 = {257: (320, 1, 264, 260, 64), 264: (320, 1, 264, 264, 64),
            300: (320, 1, 304, 300, 64), 320: (320, 1, 320, 320, 64),
            384: (384, 1, 384, 384, 32), 448: (448, 1, 448, 448, 32),
            512: (512, 1, 512, 512, 32), 640: (320, 2, 640, 640, 64),
            1000: (512, 2, 1000, 1000, 32)}
ENTRIES = {"sm90": ("flash_attention_sm90_fwd", "flash_fwd_sm90_wide_kernel",
                    "WideLayout"),
           "cuda_core": ("flash_attention_fwd", "flash_fwd_wide_kernel",
                         "WideTile")}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_every_head_dim_past_256_routes_to_the_wide_kernel(dtype):
    """Past 256 each dtype keeps its own source and takes that source's
    wide kernel: the smallest of 320, 384, 448 and 512 that holds the row
    (rows of no multiple of 16 bytes padded, as below 256), and past 512
    column slices of a multiple of 64 that the instantiation holds, as few
    as hold the row; the bfloat16 emulation's tile is the wide layout's
    ``kBN`` (64 up to the d 320 instantiation, 32 past it)."""
    route = "sm90" if dtype == torch.bfloat16 else "cuda_core"
    for d, (inst, n, ld_bf16, ld_f32, tile) in PAST_256.items():
        ld = ld_bf16 if dtype == torch.bfloat16 else ld_f32
        assert fa.kernel_for(dtype, d) == route
        assert fa.row_width(dtype, d) == ld
        assert fa.instantiation(dtype, d) == inst
        assert fa.column_slices(dtype, d) == (n, min(ld, inst))
        assert n * inst >= ld > (n - 1) * inst
        assert inst >= d if n == 1 else inst <= fa.MAX_HEAD_DIM
        assert fa.sm90_tile(d) == tile
    assert fa.MAX_HEAD_DIM == max(fa.INSTANTIATIONS[route]) == 512
    entry, kernel, layout = ENTRIES[route]
    text = (pathlib.Path(fa.__file__).parent / fa.SOURCES[route]).read_text()
    assert f'extern "C" int {entry}(' in text
    assert re.search(rf"__global__ void __launch_bounds__\(\w+, 1\)\s+"
                     rf"{kernel}\(", text)
    assert re.search(rf"struct {layout} {{", text)
    if route == "sm90":
        assert "static constexpr int kBN = D > 320 ? 32 : 64;" in text
    assert not (pathlib.Path(fa.__file__).parent
                / "csrc/flash_attention_wide.cu").exists()


def _wkv_inputs(b, t, h, kd, vd, seed):
    rng = np.random.default_rng(seed)
    r, k = (rng.standard_normal((b, t, h, kd), dtype=np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, t, h, vd), dtype=np.float32)
    w = rng.uniform(0.05, 0.98, (b, t, h, kd)).astype(np.float32)
    u = rng.standard_normal((h, kd), dtype=np.float32)
    return r, k, v, w, u


def _assert_wkv_close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g), w, rtol=WKV_TOL,
                                   atol=WKV_TOL * float(np.abs(w).max()))


@pytest.mark.parametrize("kd,vd", [(192, 192), (160, 96), (96, 160)],
                         ids=["K192-V192", "K160-V96", "K96-V160"])
def test_wkv6_past_128_matches_pallas_and_the_oracle(kd, vd):
    arrays = _wkv_inputs(1, 64, 2, kd, vd, seed=kd + vd)
    jx = [jnp.asarray(a) for a in arrays]
    ops.reset_launches()
    got = ops.wkv6(*map(torch.from_numpy, arrays))
    assert ops.wkv6.launches == 1               # one call, however split
    assert tuple(got[0].shape) == (1, 64, 2, vd)
    assert tuple(got[1].shape) == (1, 2, kd, vd)
    _assert_wkv_close(got, wkv6_chunked_kernel(*jx, chunk=32))
    _assert_wkv_close(got, ref.wkv6_ref(*jx))


def test_wkv6_split_pads_a_ragged_tail():
    """K 192 at a T that is no multiple of the chunk, at the reference's
    chunk 64: the split and the tail padding together."""
    arrays = _wkv_inputs(1, 50, 1, 192, 136, seed=5)
    got = ops.wkv6(*map(torch.from_numpy, arrays), chunk=64)
    _assert_wkv_close(got, ref.wkv6_ref(*map(jnp.asarray, arrays)))


def test_wkv6_split_hands_each_slice_at_most_128(monkeypatch):
    """Slices of 128 from the start, K outer and V inner, each contiguous
    (the kernels take contiguous inputs); the last one of each is padded
    by ``pad_wkv`` below, as any K or V up to 128 is."""
    seen = []
    real = ops._wkv6_slice

    def spy(r, k, v, w, u, chunk):
        seen.append((r.shape[-1], v.shape[-1],
                     all(x.is_contiguous() for x in (r, k, v, w, u))))
        return real(r, k, v, w, u, chunk)

    monkeypatch.setattr(ops, "_wkv6_slice", spy)
    ops.wkv6(*map(torch.from_numpy, _wkv_inputs(1, 32, 1, 300, 160, seed=1)))
    assert seen == [(128, 128, True), (128, 32, True), (128, 128, True),
                    (128, 32, True), (44, 128, True), (44, 32, True)]
