"""Attention and WKV6 at every shape the reference takes, held to it.

The reference's ``flash_attention`` takes any head dim and its
``wkv6_chunked_kernel`` any chunk that divides T and K != V.  The port's
kernels run a fixed set of instantiations: attention runs head dim d on the
smallest instantiation D >= d, columns past d read as zeros
(``flash_attention.instantiation``), and WKV6 runs K = V in ``HEAD_SIZES``
at chunk 32, other shapes padded by ``rwkv6_scan.pad_wkv`` with terms that
add exactly zero.  Here, on the CPU, ``ops.mha`` and ``ops.wkv6`` (their
plain versions) and the padding the card runs are held to the reference's
Pallas kernels in interpret mode on the same seeded numpy inputs, and the
routing rule to the entry points' switches as the sources spell them.

Tolerances, as in ``test_torch_llm_kernels.py``: attention 2e-5 in
float32 and 1.6e-2 in bfloat16 (one bf16 ulp is 2**-7 of the value), the
plain emulation of the tensor-core kernel within the card's rtol 2**-7,
atol 2**-8 max|v| of the float32 plain version; WKV6 1e-4 absolute and
relative (the chunked forms at two chunks associate the decays in other
orders).
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

ATTN_TOL = {"float32": 2e-5, "bfloat16": 1.6e-2}
WKV_TOL = 1e-4
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
ODD_HEAD_DIMS = (8, 24, 48, 72, 96, 100, 112, 160, 192)


def _attention_case(b, hq, hkv, s, d, dtype, causal, seed):
    """The port's ``ops.mha`` and the reference's ``flash_attention`` in
    interpret mode on the same inputs, as float32 numpy arrays; and the
    torch inputs."""
    t_dtype, j_dtype = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((b, s, h, d), dtype=np.float32)
              for h in (hq, hkv, hkv)]
    tq, tk, tv = (torch.from_numpy(a).to(t_dtype) for a in arrays)
    jq, jk, jv = (jnp.swapaxes(jnp.asarray(a, j_dtype), 1, 2) for a in arrays)
    want = jnp.swapaxes(flash_attention(jq, jk, jv, causal=causal,
                                        block_q=64, block_k=64), 1, 2)
    got = ops.mha(tq, tk, tv, causal=causal)
    assert got.dtype == t_dtype and tuple(got.shape) == (b, s, hq, d)
    return (got.float().numpy(), np.asarray(want.astype(jnp.float32)),
            (tq, tk, tv))


@pytest.mark.parametrize("d", ODD_HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_at_a_head_dim_outside_the_instantiations_matches_pallas(dtype,
                                                                     d):
    """Every head dim computes, causal, at 2 query heads a kv head; in
    bf16 the emulation of the tensor-core kernel's numerics at the head
    dim's tile is within the card's tolerance of the plain version too."""
    got, want, (tq, tk, tv) = _attention_case(2, 4, 2, 128, d, dtype, True,
                                              seed=d)
    tol = ATTN_TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    if dtype == "bfloat16":
        emu = fa.flash_attention_sm90_plain(tq, tk, tv, True).float()
        plain = fa.flash_attention_plain(tq, tk, tv, True).float()
        atol = 2 ** -8 * float(tv.float().abs().max())
        assert bool(((emu - plain).abs() <= 2 ** -7 * plain.abs() + atol)
                    .all())


@pytest.mark.parametrize("d,causal", [(80, True), (80, False), (100, False)],
                         ids=["d80-causal", "d80-full", "d100-full"])
def test_mha_float32_at_zamba2s_head_dim_matches_pallas(d, causal):
    """zamba2-2.7b's head dim 80 in float32 (the d 128 instantiation on the
    card), causal and full, and full attention at a head dim that is not a
    multiple of 8."""
    got, want, _ = _attention_case(1, 4, 1, 128, d, "float32", causal,
                                   seed=d + int(causal))
    np.testing.assert_allclose(got, want, rtol=ATTN_TOL["float32"],
                               atol=ATTN_TOL["float32"])


def _switch(source: str) -> dict:
    """Row-width threshold -> the instantiation an entry point's switch
    runs for row widths up to it, read from the source: ``launch<D>`` up to
    256 by the row width, ``launch_wide<D>`` past it by the slice width
    (the row width itself up to 512)."""
    text = (pathlib.Path(fa.__file__).parent / source).read_text()
    return {int(w): int(inst) for w, inst in re.findall(
        r"if \((?:ld|w) <= (\d+)\)\s+return launch(?:_wide)?<(\d+)>", text)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_every_head_dim_routes_to_an_instantiation_its_switch_has(dtype):
    """Each d in 1..512 runs ``instantiation(dtype, d)`` >= d, which is the
    instantiation that the source's switch picks for the row width the
    wrapper hands it (a multiple of ``ROW_ELEMS``, as the entry point's own
    check asks); past 512 the same source runs column slices
    (``column_slices``) at the instantiation that holds their width, and
    ``ops.mha`` takes d 513."""
    route = fa.kernel_for(dtype, fa.MAX_HEAD_DIM)
    source = fa.SOURCES[route]
    text = (pathlib.Path(fa.__file__).parent / source).read_text()
    unit = fa.ROW_ELEMS[route]
    assert f"ld % {unit} != 0" in text
    switch = _switch(source)
    assert sorted(switch.values()) == list(fa.INSTANTIATIONS[route])
    assert all(w == inst for w, inst in switch.items())
    assert max(switch) == fa.MAX_HEAD_DIM
    for d in range(1, fa.MAX_HEAD_DIM + 1):
        ld = fa.row_width(dtype, d)
        assert ld % unit == 0 and d <= ld < d + unit
        picked = switch[min(w for w in switch if w >= ld)]
        assert picked == fa.instantiation(dtype, d) >= d, d
        assert fa.column_slices(dtype, d) == (1, ld)
    with pytest.raises(ValueError, match="at least 1"):
        fa.instantiation(dtype, 0)
    past = fa.MAX_HEAD_DIM + 1
    assert fa.kernel_for(dtype, past) == route
    n, w = fa.column_slices(dtype, past)
    assert (n, w) == (2, 320)
    assert switch[min(x for x in switch if x >= w)] == \
        fa.instantiation(dtype, past) == 320
    q = torch.zeros(1, 64, 2, past, dtype=dtype)
    kv = torch.zeros(1, 64, 1, past, dtype=dtype)
    ops.reset_launches()
    assert tuple(ops.mha(q, kv, kv).shape) == (1, 64, 2, past)
    assert ops.mha.launches == 1


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
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=WKV_TOL, atol=WKV_TOL)


@pytest.mark.parametrize("kd,vd,chunk", [
    (64, 32, 32), (32, 64, 32), (48, 48, 32), (24, 40, 32),
    (64, 64, 16), (64, 64, 64)],
    ids=["K64-V32", "K32-V64", "K48-V48", "K24-V40", "chunk16", "chunk64"])
def test_wkv6_padded_as_the_card_runs_it_matches_pallas(kd, vd, chunk):
    """``pad_wkv`` to the kernels' head size and chunk 32, then
    ``wkv6_plain`` at chunk 32 and sliced back, is the reference's kernel
    at the caller's K, V and chunk; so is ``ops.wkv6`` on the CPU, whose
    plain version takes the caller's K, V and chunk as they are."""
    arrays = _wkv_inputs(2, 64, 2, kd, vd, seed=kd + vd + chunk)
    want = wkv6_chunked_kernel(*map(jnp.asarray, arrays), chunk=chunk)
    size = ws.head_size(kd, vd)
    assert size in ws.HEAD_SIZES and size >= max(kd, vd)
    padded = ws.pad_wkv(*map(torch.from_numpy, arrays), size, ws.CHUNK)
    assert all(x.shape[-1] == size for x in padded)
    y, state = ws.wkv6_plain(*padded, ws.CHUNK)
    _assert_wkv_close((y[..., :vd], state[:, :, :kd, :vd]), want)
    got = ops.wkv6(*map(torch.from_numpy, arrays), chunk=chunk)
    assert tuple(got[0].shape) == (2, 64, 2, vd)
    assert tuple(got[1].shape) == (2, 2, kd, vd)
    _assert_wkv_close(got, want)


@pytest.mark.parametrize("t", [50, 7])
def test_wkv6_pads_heads_and_a_ragged_tail_together(t):
    """K 24 and V 40 at a T that is no multiple of the chunk: both paddings
    at once, against the reference's sequential oracle."""
    arrays = _wkv_inputs(1, t, 2, 24, 40, seed=t)
    want = ref.wkv6_ref(*map(jnp.asarray, arrays))
    padded = ws.pad_wkv(*map(torch.from_numpy, arrays), 64, ws.CHUNK)
    assert padded[0].shape[1] == -(-t // ws.CHUNK) * ws.CHUNK
    y, state = ws.wkv6_plain(*padded, ws.CHUNK)
    _assert_wkv_close((y[:, :t, :, :40], state[:, :, :24, :40]), want)
    _assert_wkv_close(ops.wkv6(*map(torch.from_numpy, arrays)), want)


def test_wkv6_at_the_served_shape_takes_no_padding_copy():
    """rwkv6-3b's K = V = 64 at T 512 and chunk 32: ``pad_wkv`` hands the
    inputs back as they are; K or V past 128 raises, naming the limit."""
    inputs = [torch.zeros(1, 512, 2, 64) for _ in range(4)] + \
        [torch.zeros(2, 64)]
    assert all(a is b for a, b in zip(ws.pad_wkv(*inputs, 64, ws.CHUNK),
                                      inputs))
    assert ws.head_size(64, 64) == 64
    with pytest.raises(ValueError, match="up to 128"):
        ws.head_size(64, 136)
