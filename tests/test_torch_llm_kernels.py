"""The port's model kernels and single-chain chase, held to the reference.

On the CPU ``ops.mha``, ``ops.wkv6`` and ``ops.pchase`` run the kernels'
plain PyTorch versions, so these tests pin those versions (and the
wrappers' padding of ragged lengths) to the Pallas kernels in interpret
mode and to the reference's oracles, on the same seeded numpy inputs.  The
CUDA kernels themselves are held to the same plain versions on the card by
``chip_smoke.py``.

Tolerances:
* attention, float32: 2e-5 absolute and relative.  Both sides compute in
  float32; the Pallas kernel's online softmax and the plain version's dense
  softmax sum in different orders (the reference's own sweep uses 2e-5).
* attention, bfloat16: 1.6e-2 absolute and relative.  Both accumulate in
  float32 and round the output once to bfloat16, whose 8-bit mantissa puts
  one ulp at 2**-7 (0.0078) of the value; two roundings of nearly equal
  float32 values differ by at most one ulp.
* WKV6: 1e-4 absolute and relative, float32 throughout; the chunked and
  sequential forms associate the decays differently (the reference's own
  sweep uses 1e-4).
* the chase: bit-exact, int32 checksum wrap included.
* the tensor-core kernel's bf16 probabilities, emulated here:
  rtol 2**-7, atol 2**-8 max|v| against the float32 plain version, the
  tolerance ``chip_smoke.py`` holds that kernel to on the card (its
  reasoning is beside ``ATTN_TOL`` there); ``flash_attention_sm90_plain``,
  the emulation the card also holds the kernel to, against the one here:
  one bf16 ulp (2**-7) and 2**-10 max|v|.
"""
import math
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention
from repro.kernels.pchase_probe import pchase_kernel
from repro.kernels.rwkv6_scan import wkv6_chunked_kernel
from repro_torch.core.probes.runners import random_cycle
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels.pchase_probe import pchase_reference

ATTN_TOL = {np.float32: 2e-5, "bfloat16": 1.6e-2}
HEAD_DIMS = range(1, fa.MAX_HEAD_DIM + 1)     # every head dim ops.mha takes


def _attn_inputs(b, hq, hkv, sq, sk, d, dtype, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, sk, hkv, d), dtype=np.float32)
    v = rng.standard_normal((b, sk, hkv, d), dtype=np.float32)
    if dtype == "bfloat16":
        jx = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
        tx = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    else:
        jx = [jnp.asarray(a) for a in (q, k, v)]
        tx = [torch.from_numpy(a) for a in (q, k, v)]
    return jx, tx


def _as_np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,dtype", [
    (1, 2, 2, 128, 32, True, np.float32),        # group 1
    (2, 6, 2, 128, 32, True, np.float32),        # group 3
    (1, 6, 2, 128, 16, False, np.float32),
    (1, 6, 2, 128, 32, True, "bfloat16"),
    (2, 2, 2, 64, 64, False, "bfloat16"),
], ids=["g1-causal-f32", "g3-causal-f32", "g3-full-f32", "g3-causal-bf16",
        "g1-full-bf16"])
def test_mha_plain_matches_pallas_flash_attention(b, hq, hkv, s, d, causal,
                                                  dtype):
    (jq, jk, jv), (tq, tk, tv) = _attn_inputs(b, hq, hkv, s, s, d, dtype,
                                              seed=s + d + hq)
    want = jnp.swapaxes(flash_attention(
        jnp.swapaxes(jq, 1, 2), jnp.swapaxes(jk, 1, 2),
        jnp.swapaxes(jv, 1, 2), causal=causal, block_q=64, block_k=64), 1, 2)
    got = ops.mha(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and tuple(got.shape) == tuple(want.shape)
    tol = ATTN_TOL[dtype]
    np.testing.assert_allclose(_as_np(got), _as_np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("sq,sk,dtype", [(50, 50, np.float32),
                                         (100, 100, "bfloat16"),
                                         (40, 70, np.float32)])
def test_mha_pads_a_ragged_causal_prompt_exactly(sq, sk, dtype):
    """A ragged causal call is padded to the block and the padding dropped;
    it equals the dense oracle on the unpadded inputs."""
    (jq, jk, jv), (tq, tk, tv) = _attn_inputs(2, 6, 2, sq, sk, 32, dtype,
                                              seed=sq)
    got = ops.mha(tq, tk, tv, causal=True)
    want = jnp.swapaxes(ref.attention_ref(
        jnp.swapaxes(jq, 1, 2), jnp.swapaxes(jk, 1, 2),
        jnp.swapaxes(jv, 1, 2), causal=True), 1, 2)
    assert tuple(got.shape) == (2, sq, 6, 32)
    tol = ATTN_TOL[dtype]
    np.testing.assert_allclose(_as_np(got), _as_np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 128, "sm90"), (torch.bfloat16, 64, "sm90"),
    (torch.bfloat16, 16, "sm90"), (torch.bfloat16, 32, "sm90"),
    (torch.bfloat16, 256, "sm90"), (torch.float32, 64, "cuda_core"),
    (torch.float32, 128, "cuda_core"), (torch.float32, 256, "cuda_core")])
def test_kernel_for_picks_tensor_cores_for_bf16_at_every_head_dim(dtype, d,
                                                                  want):
    assert fa.kernel_for(dtype, d) == want
    assert fa.instantiation(dtype, d) in fa.INSTANTIATIONS[want]
    assert fa.instantiation(dtype, d) >= d
    assert fa.SOURCES[want].startswith("csrc/")


def _csrc(name: str) -> str:
    return (pathlib.Path(fa.__file__).parent / "csrc" / name).read_text()


def _switch(name: str) -> dict:
    """Row-width threshold -> the ``launch<D>`` (up to 256) or
    ``launch_wide<D>`` (past it, by the slice width, the row width itself up
    to 512) the entry point's switch runs for row widths up to it."""
    return {int(w): int(inst) for w, inst in re.findall(
        r"if \((?:ld|w) <= (\d+)\)\s+return launch(?:_wide)?<(\d+)>",
        _csrc(name))}


def _sm90_instantiations() -> dict:
    """Head dim -> the ``launch<D>`` that the tensor-core entry point's
    switch runs for its row width."""
    switch = _switch("flash_attention_sm90.cu")
    return {d: switch[min(w for w in switch
                          if w >= fa.row_width(torch.bfloat16, d))]
            for d in HEAD_DIMS}


def test_sm90_head_dims_are_the_ones_its_source_instantiates():
    """The dispatch never routes a head dim to the tensor-core entry point
    that its switch would refuse; each head dim runs an instantiation at
    least as wide, the one ``instantiation`` names (16 and 32 on the d 64
    one, zeros past column d), and both tiles agree with ``BLOCK``."""
    src = _csrc("flash_attention_sm90.cu")
    inst = _sm90_instantiations()
    assert sorted(set(_switch("flash_attention_sm90.cu").values())) == \
        list(fa.INSTANTIATIONS["sm90"])
    assert sorted(inst) == list(HEAD_DIMS)
    assert all(inst[d] == fa.instantiation(torch.bfloat16, d) >= d
               for d in HEAD_DIMS)
    assert {d: inst[d] for d in (16, 32)} == {16: 64, 32: 64}
    assert all(inst[d] == d for d in (64, 128, 256, 320, 384, 448, 512))
    assert "sq % 64 != 0 || sk % 64 != 0" in src and fa.BLOCK == 64


def test_sm90_tiles_are_the_ones_its_layout_gives_each_head_dim():
    """The plain emulation rescales where the kernel does: every
    ``sm90_tile(d)`` keys, which is ``Layout<D>::kBN`` in the source for
    the instantiation D that head dim d runs on up to 256, and
    ``WideLayout<D>::kBN`` past it."""
    src = _csrc("flash_attention_sm90.cu")
    layouts = dict(re.findall(
        r"struct (Layout|WideLayout) \{[^}]*?static constexpr int kBN = "
        r"(D > \d+ \? \d+ : \d+);", src))
    assert sorted(layouts) == ["Layout", "WideLayout"]
    inst = _sm90_instantiations()
    for d in HEAD_DIMS:
        above, big, small = map(int, re.findall(
            r"\d+", layouts["Layout" if inst[d] <= 256 else "WideLayout"]))
        assert fa.sm90_tile(d) == (big if inst[d] > above else small), d
    assert [fa.sm90_tile(d) for d in (128, 256, 320, 384, 512)] == \
        [128, 64, 64, 32, 32]


@pytest.mark.parametrize("b,hq,hkv,s,d,causal", [
    (1, 4, 2, 192, 128, True),       # a multiple of 64 that is not of 128
    (2, 2, 1, 128, 64, False),
    (1, 2, 1, 128, 256, True),
    (1, 4, 2, 128, 32, True),
    (2, 2, 1, 128, 16, False),
], ids=["d128-causal-S192", "d64-full", "d256-causal", "d32-causal",
        "d16-full"])
def test_mha_bf16_at_the_tensor_core_head_dims_matches_pallas(b, hq, hkv, s,
                                                              d, causal):
    (jq, jk, jv), (tq, tk, tv) = _attn_inputs(b, hq, hkv, s, s, d, "bfloat16",
                                              seed=s + d)
    want = jnp.swapaxes(flash_attention(
        jnp.swapaxes(jq, 1, 2), jnp.swapaxes(jk, 1, 2),
        jnp.swapaxes(jv, 1, 2), causal=causal, block_q=64, block_k=64), 1, 2)
    got = ops.mha(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16
    tol = ATTN_TOL["bfloat16"]
    np.testing.assert_allclose(_as_np(got), _as_np(want), rtol=tol, atol=tol)


def _tiled_bf16_probabilities(q, k, v, causal, tile=128):
    """The tensor-core kernel's numerics on (B, S, H, d) float32 inputs (one
    kv head per query head): float32 scores, an online softmax over
    ``tile``-key tiles in the log2 domain, the unnormalised probabilities
    rounded to bfloat16 for P.V (their sum taken before rounding), and the
    output rounded to bfloat16."""
    b, s, h, d = q.shape
    c = math.log2(math.e) / math.sqrt(d)
    m = torch.full((b, h, s), -math.inf)
    l = torch.zeros(b, h, s)
    acc = torch.zeros(b, h, s, d)
    rows = torch.arange(s)[:, None]
    for n0 in range(0, s, tile):
        kt, vt = k[:, n0:n0 + tile], v[:, n0:n0 + tile]
        sc = torch.einsum("bqhd,bkhd->bhqk", q, kt)
        if causal:
            cols = n0 + torch.arange(kt.shape[1])[None, :]
            sc = sc.masked_fill(cols > rows, -math.inf)
        m_new = torch.maximum(m, sc.amax(-1) * c)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(sc * c - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.bfloat16().float(), vt)
        m = m_new
    return (acc / l[..., None]).transpose(1, 2).bfloat16()


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_bf16_probability_rounding_stays_within_the_stated_tolerance(causal):
    """Rounding p to bf16 moves an output by at most 2**-9 max|v|, and the
    output's own bf16 rounding by one ulp (2**-7 of it): the emulated kernel
    stays within rtol 2**-7, atol 2**-8 max|v| of the float32 plain
    version, at the serving head dim and length."""
    rng = np.random.default_rng(13)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 512, 8, 128),
                                                    dtype=np.float32))
               .bfloat16().float() for _ in range(3))
    got = _tiled_bf16_probabilities(q, k, v, causal)
    want = fa.flash_attention_plain(q, k, v, causal)
    atol = 2 ** -8 * float(v.abs().max())
    diff = (got.float() - want).abs()
    assert float(diff.max()) > 0          # the rounding does move outputs
    assert bool((diff <= 2 ** -7 * want.abs() + atol).all()), \
        float((diff - 2 ** -7 * want.abs()).max())


@pytest.mark.parametrize("hq,hkv,s,causal,d,tile", [
    (4, 2, 512, True, 128, 128), (4, 2, 448, True, 128, 128),
    (2, 1, 256, False, 128, 128), (4, 1, 320, True, 256, 64)],
    ids=["gqa-causal-S512", "gqa-causal-S448", "gqa-full-S256",
         "d256-causal-S320-tile64"])
def test_sm90_plain_matches_the_tiled_emulation(hq, hkv, s, causal, d, tile):
    """``flash_attention_sm90_plain``, which ``chip_smoke.py`` holds the
    tensor-core kernel to on the card, is the emulation above with the kv
    heads shared by their query groups, a last key tile that may be short
    and, at head dim 256, the kernel's 64-key tiles: within one bf16 ulp
    (2**-7) and 2**-10 max|v|."""
    rng = np.random.default_rng(s + hq)
    q = torch.from_numpy(rng.standard_normal((1, s, hq, d),
                                             dtype=np.float32)).bfloat16()
    k, v = (torch.from_numpy(rng.standard_normal((1, s, hkv, d),
                                                 dtype=np.float32))
            .bfloat16() for _ in range(2))
    got = fa.flash_attention_sm90_plain(q, k, v, causal)
    want = _tiled_bf16_probabilities(
        q.float(), *(x.float().repeat_interleave(hq // hkv, dim=2)
                     for x in (k, v)), causal, tile=tile)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    atol = 2 ** -10 * float(v.float().abs().max())
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= 2 ** -7 * want.float().abs() + atol).all())


@pytest.mark.parametrize("d,causal", [(16, True), (32, True), (32, False)],
                         ids=["d16-causal", "d32-causal", "d32-full"])
def test_sm90_plain_at_the_narrow_head_dims_matches_the_plain_version(d,
                                                                      causal):
    """At head dims 16 and 32 the tensor-core kernel runs its d 64
    instantiation, the columns past d zero, so its numerics are the emulation
    with ``sm90_tile(d)`` = 128-key tiles and 1/sqrt(d) scores: within rtol
    2**-7, atol 2**-8 max|v| of the float32 plain version (the tolerance
    ``chip_smoke.py`` holds the kernel to), at the serving heads' grouping
    and length."""
    rng = np.random.default_rng(d + int(causal))
    q = torch.from_numpy(rng.standard_normal((1, 512, 8, d),
                                             dtype=np.float32)).bfloat16()
    k, v = (torch.from_numpy(rng.standard_normal((1, 512, 2, d),
                                                 dtype=np.float32))
            .bfloat16() for _ in range(2))
    got = fa.flash_attention_sm90_plain(q, k, v, causal)
    want = fa.flash_attention_plain(q, k, v, causal)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    atol = 2 ** -8 * float(v.float().abs().max())
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= 2 ** -7 * want.float().abs() + atol).all())


def test_attention_kernel_counts_rise_only_where_a_kernel_launches():
    """On the CPU ``ops.mha`` counts its calls but launches no kernel, so
    no kernel's own count moves; ``reset_launches`` zeroes them."""
    none = {"sm90": 0, "cuda_core": 0}
    ops.reset_launches()
    assert fa.LAUNCHES == none
    for dtype in ("bfloat16", np.float32):
        for d in (128, 320):
            _, (q, k, v) = _attn_inputs(1, 2, 1, 64, 64, d, dtype, seed=1)
            ops.mha(q, k, v)
    assert ops.mha.launches == 4
    assert fa.LAUNCHES == none
    fa.LAUNCHES.update(sm90=3, cuda_core=1)
    ops.reset_launches()
    assert fa.LAUNCHES == none


def test_tensor_core_counts_by_head_dim_rise_only_where_it_launches():
    """Each kernel's count by head dim (``BY_HEAD_DIM``) holds only the head
    dims it launched at; ``ops.mha`` on the CPU moves none,
    ``reset_launches`` clears them."""
    zeros = {}
    none = {"sm90": zeros, "cuda_core": zeros}
    ops.reset_launches()
    assert fa.BY_HEAD_DIM == none
    dims = (1, 16, 24, 32, 64, 80, 100, 128, 200, 256, 264)
    for d in dims:
        for dtype in ("bfloat16", np.float32):
            _, (q, k, v) = _attn_inputs(1, 2, 1, 64, 64, d, dtype, seed=2)
            ops.mha(q, k, v)
    assert ops.mha.launches == 2 * len(dims)
    assert fa.BY_HEAD_DIM == none
    fa.BY_HEAD_DIM["sm90"].update({128: 80, 256: 2})
    fa.BY_HEAD_DIM["cuda_core"].update({16: 2, 320: 4})
    ops.reset_launches()
    assert fa.BY_HEAD_DIM == none


def _wkv_inputs(b, t, h, kd, vd, seed):
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((b, t, h, kd), dtype=np.float32)
    k = rng.standard_normal((b, t, h, kd), dtype=np.float32)
    v = rng.standard_normal((b, t, h, vd), dtype=np.float32)
    w = rng.uniform(0.05, 0.98, (b, t, h, kd)).astype(np.float32)
    u = rng.standard_normal((h, kd), dtype=np.float32)
    return r, k, v, w, u


@pytest.mark.parametrize("b,t,h,kd,vd,chunk", [
    (1, 64, 2, 8, 8, 16), (2, 64, 3, 16, 8, 32)])
def test_wkv6_plain_matches_pallas_kernel_and_oracle(b, t, h, kd, vd, chunk):
    arrays = _wkv_inputs(b, t, h, kd, vd, seed=t + kd)
    y, s = ops.wkv6(*map(torch.from_numpy, arrays), chunk=chunk)
    jarrays = [jnp.asarray(a) for a in arrays]
    y_k, s_k = wkv6_chunked_kernel(*jarrays, chunk=chunk)
    y_r, s_r = ref.wkv6_ref(*jarrays)
    for want_y, want_s in ((y_k, s_k), (y_r, s_r)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(s.numpy(), np.asarray(want_s),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("t,chunk", [(50, 16), (7, 32)])
def test_wkv6_pads_a_ragged_tail_exactly(t, chunk):
    """r = k = v = 0 and w = 1 on the padded steps leave y and the final
    state of the real steps equal to the sequential oracle's."""
    arrays = _wkv_inputs(2, t, 2, 8, 8, seed=t)
    y, s = ops.wkv6(*map(torch.from_numpy, arrays), chunk=chunk)
    y_r, s_r = ref.wkv6_ref(*(jnp.asarray(a) for a in arrays))
    assert tuple(y.shape) == (2, t, 2, 8)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_r), rtol=1e-4,
                               atol=1e-4)


def _wrapping_cycle(n: int, rng) -> np.ndarray:
    """A single cycle through slot 0 and the top 1024 of n slots: chains of
    a few thousand loads over values near n = 2**19 sum past 2**31."""
    order = np.concatenate([[0], rng.permutation(
        np.arange(n - 1024, n))]).astype(np.int32)
    perm = np.zeros(n, dtype=np.int32)
    perm[order] = np.roll(order, -1)
    return perm


@pytest.mark.parametrize("n,iters,wrap", [(64, 0, False), (64, 200, False),
                                          (1 << 19, 6144, True)])
def test_pchase_matches_reference_oracles(n, iters, wrap):
    rng = np.random.default_rng(n + iters)
    perm = _wrapping_cycle(n, rng) if wrap else random_cycle(n, rng)
    got = tuple(ops.pchase(torch.from_numpy(perm), iters=iters).tolist())
    want = ref.pchase_ref(perm, iters)
    assert got == want == pchase_reference(perm, iters)
    if wrap:
        assert want[1] < 0              # every value is positive: wrapped
    if n <= 64:
        pallas = pchase_kernel(jnp.asarray(perm), iters=iters)
        assert got == tuple(int(x) for x in np.asarray(pallas))


def test_llm_wrappers_count_and_reset():
    ops.reset_launches()
    (_, (q, k, v)) = _attn_inputs(1, 2, 1, 64, 64, 16, np.float32, seed=0)
    ops.mha(q, k, v)
    ops.mha(q, k, v, causal=False)
    ops.wkv6(*map(torch.from_numpy, _wkv_inputs(1, 32, 1, 8, 8, seed=0)))
    ops.pchase(torch.from_numpy(random_cycle(16, np.random.default_rng(0))),
               iters=3)
    assert [fn.launches for fn in ops.LLM_WRAPPERS] == [2, 1, 1]
    assert all(fn.launches == 0 for fn in ops.WRAPPERS)
    ops.reset_launches()
    assert all(fn.launches == 0 for fn in ops.WRAPPERS + ops.LLM_WRAPPERS)


def _bad_calls():
    q = torch.zeros(1, 64, 4, 32)
    kv = torch.zeros(1, 64, 2, 32)
    wide = (torch.zeros(1, 64, 4, 264), torch.zeros(1, 64, 2, 256),
            torch.zeros(1, 64, 2, 256))             # q's d is not k's
    wkv = [torch.zeros(1, 32, 2, 8) for _ in range(4)]
    u = torch.zeros(2, 8)
    broad = [torch.zeros(1, 32, 2, 136) for _ in range(4)]
    perm = torch.zeros(8, dtype=torch.int32)
    return {
        "ragged-full": lambda: ops.mha(q[:, :50], kv[:, :50], kv[:, :50],
                                       causal=False),
        "ragged-longer-q": lambda: ops.mha(q, kv[:, :50], kv[:, :50]),
        "dtype-mix": lambda: ops.mha(q, kv.double(), kv),
        "float16": lambda: ops.mha(q.half(), kv.half(), kv.half()),
        "head-dim": lambda: ops.mha(*wide),
        "head-dim-bf16": lambda: ops.mha(*(t.bfloat16() for t in wide)),
        "groups": lambda: ops.mha(q[:, :, :3], kv, kv),
        "wkv-shape": lambda: ops.wkv6(*wkv[:3], wkv[3][:, :16], u),
        "wkv-dtype": lambda: ops.wkv6(wkv[0].double(), *wkv[1:], u),
        "wkv-u": lambda: ops.wkv6(*wkv, u[:1]),
        "wkv-noncontig": lambda: ops.wkv6(wkv[0].transpose(1, 2), *wkv[1:],
                                          u),
        "wkv-head-size": lambda: ops.wkv6(*broad, torch.zeros(2, 128)),
        "pchase-iters": lambda: ops.pchase(perm, iters=-1),
        "pchase-dtype": lambda: ops.pchase(perm.long(), iters=1),
    }


@pytest.mark.parametrize("case", list(_bad_calls()))
def test_llm_wrappers_reject_what_the_kernels_do_not_take(case):
    ops.reset_launches()
    with pytest.raises((TypeError, ValueError)):
        _bad_calls()[case]()
    assert all(fn.launches == 0 for fn in ops.LLM_WRAPPERS)
