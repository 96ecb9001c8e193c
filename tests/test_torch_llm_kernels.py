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
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention
from repro.kernels.pchase_probe import pchase_kernel
from repro.kernels.rwkv6_scan import wkv6_chunked_kernel
from repro_torch.core.probes.runners import random_cycle
from repro_torch.kernels import ops
from repro_torch.kernels.pchase_probe import pchase_reference

ATTN_TOL = {np.float32: 2e-5, "bfloat16": 1.6e-2}


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
    wkv = [torch.zeros(1, 32, 2, 8) for _ in range(4)]
    u = torch.zeros(2, 8)
    perm = torch.zeros(8, dtype=torch.int32)
    return {
        "ragged-full": lambda: ops.mha(q[:, :50], kv[:, :50], kv[:, :50],
                                       causal=False),
        "ragged-longer-q": lambda: ops.mha(q, kv[:, :50], kv[:, :50]),
        "dtype-mix": lambda: ops.mha(q, kv.double(), kv),
        "float16": lambda: ops.mha(q.half(), kv.half(), kv.half()),
        "head-dim": lambda: ops.mha(q[..., :24], kv[..., :24],
                                    kv[..., :24]),
        "groups": lambda: ops.mha(q[:, :, :3], kv, kv),
        "wkv-shape": lambda: ops.wkv6(*wkv[:3], wkv[3][:, :16], u),
        "wkv-dtype": lambda: ops.wkv6(wkv[0].double(), *wkv[1:], u),
        "wkv-u": lambda: ops.wkv6(*wkv, u[:1]),
        "wkv-noncontig": lambda: ops.wkv6(wkv[0].transpose(1, 2), *wkv[1:],
                                          u),
        "pchase-iters": lambda: ops.pchase(perm, iters=-1),
        "pchase-dtype": lambda: ops.pchase(perm.long(), iters=1),
    }


@pytest.mark.parametrize("case", list(_bad_calls()))
def test_llm_wrappers_reject_what_the_kernels_do_not_take(case):
    ops.reset_launches()
    with pytest.raises((TypeError, ValueError)):
        _bad_calls()[case]()
    assert all(fn.launches == 0 for fn in ops.LLM_WRAPPERS)
