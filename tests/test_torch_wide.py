"""Attention past head dim 256 and WKV6 past K or V 128, held to the
reference.

The reference's ``flash_attention`` has no bound on the head dim and its
``wkv6_chunked_kernel`` none on K or V.  The port runs every d > 256 on
``csrc/flash_attention_wide.cu`` (``flash_attention.kernel_for``), whose
plain versions are ``flash_attention_plain`` in float32 and
``flash_attention_sm90_plain`` in bfloat16 (the tensor-core kernel's
numerics: probabilities rounded to bfloat16 for P.V, 64-key tiles past
d 128).  WKV6 past 128 is split above the route in ``ops.wkv6``: K and V
cut into slices of at most 128, y summed over the K slices and the state
concatenated; on the CPU each slice runs ``wkv6_plain``.

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
@pytest.mark.parametrize("d", [264, 320])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_every_head_dim_past_256_routes_to_the_wide_kernel(dtype):
    """Past ``MAX_HEAD_DIM`` both dtypes take the wide kernel, which reads
    rows of any width (no padding copy) and rescales every 64 keys, the
    tile ``sm90_tile`` gives the bfloat16 emulation there."""
    for d in (257, 264, 300, 320, 512, 1000):
        assert fa.kernel_for(dtype, d) == "wide"
        assert fa.row_width(dtype, d) == d
        assert fa.sm90_tile(d) == 64
    assert fa.kernel_for(dtype, fa.MAX_HEAD_DIM) != "wide"
    text = (pathlib.Path(fa.__file__).parent
            / fa.SOURCES["wide"]).read_text()
    assert re.search(r"constexpr int kBN = 64;", text)
    assert 'extern "C" int flash_attention_wide_fwd(' in text


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
