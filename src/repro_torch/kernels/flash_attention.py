"""Flash attention (causal or full, grouped-query) for NVIDIA Hopper.

The CUDA C++ kernel lives in ``csrc/flash_attention.cu`` (its note says what
bounds it and how it is laid out); this module launches it and holds its
plain PyTorch version.  It replaces the reference's Pallas
``flash_attention`` (``repro/kernels/flash_attention.py:78``).

Both take the model layout: q (B, Sq, Hq, d), k and v (B, Sk, Hkv, d), with
query head h reading kv head ``h // (Hq // Hkv)``, the causal mask
``row >= col`` counted from position 0, the scores scaled by ``1/sqrt(d)``
and the output in q's dtype.  The kernel takes Sq and Sk in multiples of
``BLOCK`` and d in ``HEAD_DIMS``, float32 or bfloat16; the padding of a
ragged causal prompt is the wrapper's (``ops.mha``).  Inputs are validated
there; the functions here assume contiguous tensors of matching shapes on
one device.
"""
from __future__ import annotations

import math

import torch

from ._build import check_launch, load_library

__all__ = ["BLOCK", "HEAD_DIMS", "NEG_INF", "flash_attention_kernel",
           "flash_attention_plain"]

BLOCK = 64                      # kBlock of csrc/flash_attention.cu
HEAD_DIMS = (16, 32, 64, 128, 256)
NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           causal: bool) -> torch.Tensor:
    """CUDA flash attention: one block per (query tile, head, batch), the kv
    tiles in a loop that stops at the diagonal when ``causal``."""
    lib, _ = load_library()
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    check_launch(lib, "flash_attention_fwd", lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv,
        sq, sk, d, int(causal), _DTYPE_CODES[q.dtype], stream))
    return out


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool) -> torch.Tensor:
    """Plain version: dense softmax attention in float32, the same function
    as the kernel (probabilities kept in float32, output in q's dtype)."""
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
