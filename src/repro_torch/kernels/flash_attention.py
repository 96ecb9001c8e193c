"""Flash attention (causal or full, grouped-query) for NVIDIA Hopper.

Two CUDA C++ kernels replace the reference's Pallas ``flash_attention``
(``repro/kernels/flash_attention.py:78``); ``kernel_for`` picks one by dtype
alone:

* ``csrc/flash_attention_sm90.cu`` for bfloat16 at ``SM90_HEAD_DIMS``: the
  tensor cores (``wgmma`` on tiles that TMA loads), with the probabilities
  rounded to bfloat16 for the P.V product, as the reference's f32 dot at
  default precision does on the TPU's matrix unit; head dims 16 and 32 run
  its d 64 instantiation and head dim 80 its d 128 one, zeros past column
  d;
* ``csrc/flash_attention.cu`` for float32 at ``CUDA_CORE_HEAD_DIMS``: the
  CUDA cores, all in float32.

Each source's note says what bounds it and how it is laid out.  This module
launches them and holds their plain PyTorch version.

The kernels and the plain version take the model layout: q (B, Sq, Hq, d),
k and v (B, Sk, Hkv, d), with query head h reading kv head
``h // (Hq // Hkv)``, the causal mask ``row >= col`` counted from position
0, the scores scaled by ``1/sqrt(d)`` and the output in q's dtype.  The
kernels take Sq and Sk in multiples of ``BLOCK`` and d in their head dims,
float32 or bfloat16; the padding of a ragged causal prompt is the
wrapper's (``ops.mha``).  Inputs are validated there; the functions here
assume contiguous tensors of matching shapes on one device.
"""
from __future__ import annotations

import math

import torch

from ._build import check_launch, load_library

__all__ = ["BLOCK", "HEAD_DIMS", "SM90_HEAD_DIMS", "CUDA_CORE_HEAD_DIMS",
           "SM90_TILES", "NEG_INF", "head_dims",
           "SOURCES", "LAUNCHES", "SM90_LAUNCHES", "kernel_for",
           "flash_attention_kernel",
           "flash_attention_plain", "flash_attention_sm90_plain"]

BLOCK = 64                      # kBlock of csrc/flash_attention.cu
SM90_HEAD_DIMS = (16, 32, 64, 80, 128, 256)   # flash_attention_sm90.cu's switch
CUDA_CORE_HEAD_DIMS = (16, 32, 64, 128, 256)  # flash_attention.cu's switch
HEAD_DIMS = SM90_HEAD_DIMS      # every head dim a kernel takes, in some dtype
# keys a tile of the tensor-core kernel, by head dim: Layout<D>::kBN of the
# instantiation the head dim runs on (d 16 and 32 run D = 64, d 80 D = 128)
SM90_TILES = {16: 128, 32: 128, 64: 128, 80: 128, 128: 128, 256: 64}
NEG_INF = -1e30
# kernel_for's answer -> the source of that kernel, under kernels/
SOURCES = {"sm90": "csrc/flash_attention_sm90.cu",
           "cuda_core": "csrc/flash_attention.cu"}
# Launches of each kernel, raised where it is launched (``ops.mha`` counts
# its calls, whichever kernel they take), and of the tensor-core kernel by
# head dim; ``ops.reset_launches`` zeroes them.
LAUNCHES = {name: 0 for name in SOURCES}
SM90_LAUNCHES = {d: 0 for d in SM90_HEAD_DIMS}


def kernel_for(dtype: torch.dtype, d: int) -> str:
    """Which kernel takes inputs of ``dtype`` at head dim ``d``: ``"sm90"``
    (tensor cores) for bfloat16 at ``SM90_HEAD_DIMS``, else ``"cuda_core"``
    (float32).  The choice depends on nothing else."""
    return ("sm90" if dtype == torch.bfloat16 and d in SM90_HEAD_DIMS
            else "cuda_core")


def head_dims(dtype: torch.dtype) -> tuple:
    """The head dims the kernel that takes ``dtype`` runs: bfloat16's
    tensor-core kernel or float32's CUDA-core one."""
    return SM90_HEAD_DIMS if dtype == torch.bfloat16 else CUDA_CORE_HEAD_DIMS


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           causal: bool) -> torch.Tensor:
    """CUDA flash attention by the kernel ``kernel_for(q.dtype, d)`` names:
    each query tile of each head and batch element walks the kv tiles in a
    loop that stops at the diagonal when ``causal``."""
    lib, _ = load_library()
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if kernel_for(q.dtype, d) == "sm90":
        check_launch(lib, "flash_attention_sm90_fwd",
                     lib.flash_attention_sm90_fwd(
                         q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), b, hq, hkv, sq, sk, d, int(causal),
                         stream))
        LAUNCHES["sm90"] += 1
        SM90_LAUNCHES[d] += 1
    else:
        check_launch(lib, "flash_attention_fwd", lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
            hkv, sq, sk, d, int(causal), stream))
        LAUNCHES["cuda_core"] += 1
    return out


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool) -> torch.Tensor:
    """Plain version: dense softmax attention in float32, the same function
    as the kernels (probabilities kept in float32, output in q's dtype; the
    tensor-core kernel's bf16 probabilities are within the tolerance that
    ``chip_smoke.py`` states)."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, hkv, hq // hkv, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * (1.0 / math.sqrt(d))
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


def flash_attention_sm90_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, causal: bool) -> torch.Tensor:
    """The tensor-core kernel's numerics in plain PyTorch: float32 scores, an
    online softmax over ``SM90_TILES[d]``-key tiles in the log2 domain, the
    unnormalised probabilities rounded to bfloat16 for P.V (their sum taken
    before rounding), the output divided by that sum and rounded to q's
    dtype.  The same inputs and layout as ``flash_attention_plain``."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    c = math.log2(math.e) / math.sqrt(d)
    qf = q.float().transpose(1, 2)                            # (B, Hq, Sq, d)
    kf, vf = (x.float().transpose(1, 2).repeat_interleave(hq // hkv, dim=1)
              for x in (k, v))                                # (B, Hq, Sk, d)
    m = torch.full((b, hq, sq, 1), -math.inf, device=q.device)
    l = torch.zeros((b, hq, sq, 1), device=q.device)
    acc = torch.zeros((b, hq, sq, d), device=q.device)
    rows = torch.arange(sq, device=q.device)[:, None]
    tile = SM90_TILES[d]
    for n0 in range(0, sk, tile):
        sc = qf @ kf[:, :, n0:n0 + tile].transpose(-1, -2)
        if causal:
            cols = n0 + torch.arange(sc.shape[-1], device=q.device)[None, :]
            sc = sc.masked_fill(cols > rows, -math.inf)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True) * c)
        mu = m_new.nan_to_num(neginf=0.0)
        alpha = torch.exp2(m - mu)
        p = torch.exp2(sc * c - mu)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.bfloat16().float() @ vf[:, :, n0:n0 + tile]
        m = m_new
    return (acc / l).transpose(1, 2).to(q.dtype).contiguous()
