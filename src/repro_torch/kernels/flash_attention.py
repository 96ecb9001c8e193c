"""Flash attention (causal, prefix-LM or full, grouped-query) for NVIDIA
Hopper.

Two CUDA C++ sources replace the reference's Pallas ``flash_attention``
(``repro/kernels/flash_attention.py:78``); ``kernel_for`` picks one by
dtype alone:

* ``csrc/flash_attention_sm90.cu`` for bfloat16: the tensor cores
  (``wgmma`` on tiles that TMA loads), with the probabilities rounded to
  bfloat16 for the P.V product, as the reference's f32 dot at default
  precision does on the TPU's matrix unit;
* ``csrc/flash_attention.cu`` for float32: the CUDA cores, all in float32.

Each holds two kernels: one for head dims up to 256 and one past it, whose
two consumers (bfloat16) or two warps a row (float32) split the output
columns and compute the scores once.  Both take every head dim d by one
rule (``instantiation``): d runs the smallest instantiation D >= d of its
source's ``INSTANTIATIONS``, whose columns past d read as zeros and add
nothing; past the widest, ``MAX_HEAD_DIM``, the output columns are cut into
``column_slices`` of at most that width, each of which computes the scores
over the whole row once.  They read rows whose width in memory is a
multiple of 16 bytes (``row_width``); for a head dim that is not, the
wrapper pads the columns with zeros and drops them from the output.  The
scale is always ``1/sqrt(d)`` of the caller's d.  Each source's note says
what bounds it and how it is laid out.  This module launches them and
holds their plain PyTorch version.

The kernels and the plain version take the model layout: q (B, Sq, Hq, d),
k and v (B, Sk, Hkv, d), with query head h reading kv head
``h // (Hq // Hkv)``, the causal mask ``row >= col`` counted from position
0, the scores scaled by ``1/sqrt(d)`` and the output in q's dtype.  A
``prefix_len`` P > 0 (causal only; head dims up to 256 in the kernels)
makes the mask prefix-LM's, ``row >= col or (row < P and col < P)``, as
the reference's plain ``attention`` computes it for the vlm family; 0
leaves it causal.  The kernels take Sq and Sk in multiples of ``BLOCK``,
float32 or bfloat16; the padding of a ragged causal prompt is the
wrapper's (``ops.mha``).  Inputs are validated there; the functions here
assume contiguous tensors of matching shapes on one device.
"""
from __future__ import annotations

import math
from collections import Counter

import torch
import torch.nn.functional as F

from ._build import check_launch, load_library

__all__ = ["BLOCK", "MAX_HEAD_DIM", "INSTANTIATIONS",
           "ROW_ELEMS", "NEG_INF", "instantiation", "column_slices",
           "row_width", "sm90_tile", "SOURCES", "LAUNCHES", "BY_HEAD_DIM",
           "BY_PREFIX", "kernel_for", "mask",
           "flash_attention_kernel",
           "flash_attention_plain", "flash_attention_sm90_plain"]

BLOCK = 64                      # the kernels' sequence granule
MAX_HEAD_DIM = 512              # the widest instantiation of both sources
NEG_INF = -1e30
# kernel_for's answer -> the source of that kernel, under kernels/
SOURCES = {"sm90": "csrc/flash_attention_sm90.cu",
           "cuda_core": "csrc/flash_attention.cu"}
# kernel_for's answer -> the head dims its entry point instantiates (up to
# 256 the first kernel of the source, past it the second)
INSTANTIATIONS = {"sm90": (64, 128, 256, 320, 384, 448, 512),
                  "cuda_core": (32, 64, 128, 256, 320, 384, 448, 512)}
# kernel_for's answer -> the multiple of elements its rows take in memory
# (16 bytes: TMA's row stride for bfloat16, cp.async's copy for float32)
ROW_ELEMS = {"sm90": 8, "cuda_core": 4}


def kernel_for(dtype: torch.dtype, d: int) -> str:
    """Which kernel takes inputs of ``dtype`` at head dim ``d``: at every d
    ``"sm90"`` (tensor cores) for bfloat16, else ``"cuda_core"``
    (float32)."""
    del d                       # every head dim: the route is the dtype's
    return "sm90" if dtype == torch.bfloat16 else "cuda_core"


def row_width(dtype: torch.dtype, d: int) -> int:
    """The row width in memory that the kernel of ``dtype`` and ``d``
    reads: d rounded up to its ``ROW_ELEMS``."""
    unit = ROW_ELEMS[kernel_for(dtype, d)]
    return -(-d // unit) * unit


def column_slices(dtype: torch.dtype, d: int) -> tuple[int, int]:
    """(n, w): the entry points' ``slice_width`` rule.  Up to
    ``MAX_HEAD_DIM`` one slice of the row width; past it the row width ld
    cut into n = ceil(ld / MAX_HEAD_DIM) slices of w columns, ceil(ld / n)
    rounded up to a multiple of 64 (the last one narrower), each of which
    computes the scores over the whole row."""
    ld = row_width(dtype, d)
    if ld <= MAX_HEAD_DIM:
        return 1, ld
    n = -(-ld // MAX_HEAD_DIM)
    per_slice = -(-ld // n)
    w = -(-per_slice // 64) * 64
    return -(-ld // w), w


def instantiation(dtype: torch.dtype, d: int) -> int:
    """The instantiation that head dim ``d`` runs in ``dtype``'s kernel:
    the smallest of its ``INSTANTIATIONS`` that is at least d; past
    ``MAX_HEAD_DIM`` the one each of its ``column_slices`` runs (>= the
    slice width)."""
    if d < 1:
        raise ValueError(f"head dim {d}: expected at least 1")
    _, w = column_slices(dtype, d)
    return next(D for D in INSTANTIATIONS[kernel_for(dtype, d)] if D >= w)


def sm90_tile(d: int) -> int:
    """The keys a kv tile holds in bfloat16 at head dim ``d``: the
    tensor-core kernels' ``Layout<D>::kBN`` and ``WideLayout<D>::kBN`` of
    the instantiation D that d runs: 128 up to D 128, 64 up to D 320, 32
    past it."""
    inst = instantiation(torch.bfloat16, d)
    return 128 if inst <= 128 else 64 if inst <= 320 else 32


# Launches of each kernel, raised where it is launched (``ops.mha`` counts
# its calls, whichever kernel they take), of each kernel by the caller's
# head dim (``BY_HEAD_DIM``) and by its prefix length, 0 for none
# (``BY_PREFIX``), both keyed as ``SOURCES``; ``ops.reset_launches`` zeroes
# them.
LAUNCHES = {name: 0 for name in SOURCES}
BY_HEAD_DIM = {name: Counter() for name in SOURCES}
BY_PREFIX = {name: Counter() for name in SOURCES}
_ENTRIES = {"sm90": "flash_attention_sm90_fwd",
            "cuda_core": "flash_attention_fwd"}


def mask(sq: int, sk: int, causal: bool, prefix_len: int,
         device) -> torch.Tensor | None:
    """The (Sq, Sk) boolean mask of the keys each query attends to: None
    for full attention, ``row >= col`` when causal, or'd with
    ``row < P and col < P`` for a prefix of P = ``prefix_len`` > 0."""
    if not causal:
        return None
    rows = torch.arange(sq, device=device)[:, None]
    cols = torch.arange(sk, device=device)[None, :]
    keep = rows >= cols
    if prefix_len:
        keep = keep | ((rows < prefix_len) & (cols < prefix_len))
    return keep


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           causal: bool, prefix_len: int = 0) -> torch.Tensor:
    """CUDA flash attention by the kernel ``kernel_for(q.dtype, d)`` names,
    at ``instantiation(q.dtype, d)``: each query tile of each head, batch
    element (and column slice) walks the kv tiles in a loop that stops at
    the diagonal when ``causal`` (for a tile that starts below
    ``prefix_len``, at the later of the diagonal and the prefix's last
    tile).  Columns are padded with zeros to ``row_width`` and dropped from
    the output."""
    lib, _ = load_library()
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    route = kernel_for(q.dtype, d)
    ld = row_width(q.dtype, d)
    if ld != d:
        q, k, v = (F.pad(x, (0, ld - d)) for x in (q, k, v))
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    entry = _ENTRIES[route]
    check_launch(lib, entry, getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
        hkv, sq, sk, d, ld, int(causal), prefix_len, stream))
    LAUNCHES[route] += 1
    BY_HEAD_DIM[route][d] += 1
    BY_PREFIX[route][prefix_len] += 1
    return out if ld == d else out[..., :d]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool, prefix_len: int = 0) -> torch.Tensor:
    """Plain version: dense softmax attention in float32, the same function
    as the kernels (probabilities kept in float32, output in q's dtype; the
    tensor-core kernel's bf16 probabilities are within the tolerance that
    ``chip_smoke.py`` states)."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, hkv, hq // hkv, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * (1.0 / math.sqrt(d))
    keep = mask(sq, sk, causal, prefix_len, q.device)
    if keep is not None:
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


def flash_attention_sm90_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, causal: bool,
                               prefix_len: int = 0) -> torch.Tensor:
    """The tensor-core kernels' numerics in plain PyTorch: float32 scores, an
    online softmax over ``sm90_tile(d)``-key tiles in the log2 domain, the
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
    keep = mask(sq, sk, causal, prefix_len, q.device)
    tile = sm90_tile(d)
    for n0 in range(0, sk, tile):
        sc = qf @ kf[:, :, n0:n0 + tile].transpose(-1, -2)
        if keep is not None:
            sc = sc.masked_fill(~keep[:, n0:n0 + tile], -math.inf)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True) * c)
        mu = m_new.nan_to_num(neginf=0.0)
        alpha = torch.exp2(m - mu)
        p = torch.exp2(sc * c - mu)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.bfloat16().float() @ vf[:, :, n0:n0 + tile]
        m = m_new
    return (acc / l).transpose(1, 2).to(q.dtype).contiguous()
