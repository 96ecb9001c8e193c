"""Attention at head dim 80 (zamba2-2.7b's), held to the reference.

On the card ``ops.mha`` runs bf16 at head dim 80 on the d 128 instantiation
of the tensor-core kernel and f32 on the d 128 instantiation of the
CUDA-core one; both load the columns past d as zeros, which add nothing.
Here, on the CPU, the wrapper's plain version and the plain emulation of
the tensor-core kernel's numerics (``flash_attention_sm90_plain``, with the
d 128 instantiation's 128-key tiles) are held to the reference's
``flash_attention`` in interpret mode on the same seeded inputs.

Tolerances: 2e-5 absolute and relative in f32 (the online and the dense
softmax sum in other orders); 1.6e-2 absolute and relative against the
reference, as every bf16 attention test of the port (both sides
accumulate in float32 and round the output once to bfloat16, one ulp
being 2**-7 of the value); the emulation, which also rounds the probabilities to bfloat16, within rtol
2**-7 and atol 2**-8 max|v| of the float32 plain version, the tolerance the
card holds the kernel to (``chip_smoke.py`` ``ATTN_TOL``).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

TOL = 1.6e-2


def _inputs(b, hq, hkv, s, d, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((b, s, h, d), dtype=np.float32)
              for h in (hq, hkv, hkv)]
    return ([jnp.asarray(a, jnp.bfloat16) for a in arrays],
            [torch.from_numpy(a).to(torch.bfloat16) for a in arrays])


def _reference(jq, jk, jv, causal):
    return np.asarray(jnp.swapaxes(flash_attention(
        jnp.swapaxes(jq, 1, 2), jnp.swapaxes(jk, 1, 2),
        jnp.swapaxes(jv, 1, 2), causal=causal, block_q=64, block_k=64), 1, 2)
        .astype(jnp.float32))


@pytest.mark.parametrize("b,hq,hkv,s,causal", [
    (1, 4, 2, 128, True), (2, 2, 1, 192, False), (1, 8, 2, 256, True)],
    ids=["causal-S128", "full-S192", "group4-causal-S256"])
def test_mha_bf16_at_head_dim_80_matches_pallas(b, hq, hkv, s, causal):
    (jq, jk, jv), (tq, tk, tv) = _inputs(b, hq, hkv, s, 80, seed=s + hq)
    got = ops.mha(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, s, hq, 80)
    np.testing.assert_allclose(got.float().numpy(),
                               _reference(jq, jk, jv, causal),
                               rtol=TOL, atol=TOL)


def test_mha_pads_a_ragged_causal_prompt_at_head_dim_80():
    """A ragged causal call at d 80 is padded to the block and the padding
    dropped: it equals the reference's dense oracle on the unpadded
    inputs."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(2, 6, 2, 100, 80, seed=100)
    got = ops.mha(tq, tk, tv, causal=True)
    want = jnp.swapaxes(ref.attention_ref(
        jnp.swapaxes(jq, 1, 2), jnp.swapaxes(jk, 1, 2),
        jnp.swapaxes(jv, 1, 2), causal=True), 1, 2)
    assert tuple(got.shape) == (2, 100, 6, 80)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_sm90_emulation_at_head_dim_80_matches_pallas(causal):
    """The tensor-core kernel's numerics at d 80 (the d 128 instantiation's
    128-key tiles, 1/sqrt(80) scores): within the bf16 tolerance of the
    reference and within the card's tolerance of the plain version."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, 8, 2, 512, 80, seed=80)
    got = fa.flash_attention_sm90_plain(tq, tk, tv, causal)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    np.testing.assert_allclose(got.float().numpy(),
                               _reference(jq, jk, jv, causal),
                               rtol=TOL, atol=TOL)
    want = fa.flash_attention_plain(tq, tk, tv, causal).float()
    diff = (got.float() - want).abs()
    atol = 2 ** -8 * float(tv.float().abs().max())
    assert bool((diff <= 2 ** -7 * want.abs() + atol).all())


def test_head_dim_80_runs_the_tensor_cores_on_the_d128_instantiation():
    """bf16 at d 80 takes the tensor-core kernel, whose switch runs it on
    ``launch<128>`` (128-key tiles); float32 at d 80 takes the CUDA-core
    kernel's d 128 instantiation, and ``ops.mha`` computes it: within the
    float32 tolerance (2e-5) of the reference's ``flash_attention``."""
    assert fa.kernel_for(torch.bfloat16, 80) == "sm90"
    assert fa.instantiation(torch.bfloat16, 80) == 128
    assert fa.sm90_tile(80) == 128
    src = (fa.__file__.rsplit("/", 1)[0] + "/csrc/flash_attention_sm90.cu")
    assert re.search(r"if \(ld <= 128\)\s+return launch<128>",
                     open(src).read())
    assert fa.row_width(torch.bfloat16, 80) == 80
    cuda_core = open(src.replace("_sm90", "")).read()
    assert re.search(r"if \(ld <= 128\)\s+return launch<128>", cuda_core)
    assert fa.kernel_for(torch.float32, 80) == "cuda_core"
    assert fa.instantiation(torch.float32, 80) == 128
    assert fa.row_width(torch.float32, 80) == 80
    rng = np.random.default_rng(81)
    arrays = [rng.standard_normal((1, 64, h, 80), dtype=np.float32)
              for h in (2, 1, 1)]
    ops.reset_launches()
    got = ops.mha(*map(torch.from_numpy, arrays))
    assert ops.mha.launches == 1 and got.dtype == torch.float32
    assert tuple(got.shape) == (1, 64, 2, 80)
    np.testing.assert_allclose(
        got.numpy(), _reference(*map(jnp.asarray, arrays), True),
        rtol=2e-5, atol=2e-5)
