"""Chunked RWKV6 WKV recurrence for NVIDIA Hopper.

The CUDA C++ kernel lives in ``csrc/wkv6.cu`` (its note says what bounds it
and how it is laid out); this module launches it and holds its plain
PyTorch version.  It replaces the reference's Pallas
``wkv6_chunked_kernel`` (``repro/kernels/rwkv6_scan.py:74``).

Both take r, k, w (B, T, H, K), v (B, T, H, V) and u (H, K) in float32 and
return y (B, T, H, V) and the final state (B, H, K, V) in float32, from a
zero state, with T a multiple of ``chunk``; the padding of a ragged tail is
the wrapper's (``ops.wkv6``).  ``chunked_scan`` is the chunk-parallel math
from any incoming state, which the model's ``wkv_chunked`` also runs.
Inputs are validated by the wrapper; the functions here assume contiguous
tensors of matching shapes on one device.
"""
from __future__ import annotations

import torch

from ._build import check_launch, load_library

__all__ = ["wkv6_kernel", "wkv6_plain", "chunked_scan"]


def wkv6_kernel(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor,
                chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """CUDA WKV6: one block per (batch, head) walks the chunks with the
    state in shared memory."""
    lib, _ = load_library()
    b, t, h, kd = r.shape
    vd = v.shape[-1]
    y = torch.empty((b, t, h, vd), dtype=torch.float32, device=r.device)
    state = torch.empty((b, h, kd, vd), dtype=torch.float32, device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    check_launch(lib, "wkv6_fwd", lib.wkv6_fwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        y.data_ptr(), state.data_ptr(), b, t, h, kd, vd, chunk, stream))
    return y, state


def chunked_scan(r, k, v, w, u, state,
                 chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunk-parallel WKV6 in float32 from ``state`` (B, H, K, V): pairwise
    decays within a chunk, the state carried across chunks; T % chunk == 0.
    """
    b, t, h, kd = r.shape
    r, k, v, w, u = (x.float() for x in (r, k, v, w, u))
    s = state.float()
    tril = torch.ones(chunk, chunk, dtype=torch.bool,
                      device=r.device).tril(-1)
    ys = []
    for t0 in range(0, t, chunk):
        rc, kc, vc, wc = (x[:, t0:t0 + chunk] for x in (r, k, v, w))
        lw = torch.log(wc)                                # (B, C, H, K)
        cs = torch.cumsum(lw, dim=1)                      # L_j inclusive
        lp = cs - lw                                      # L_{j-1}
        y = torch.einsum("bjhk,bhkv->bjhv", rc * torch.exp(lp), s)
        dec = torch.exp(lp[:, :, None] - cs[:, None])     # (B, j, i, H, K)
        att = torch.einsum("bjhk,bihk,bjihk->bjih", rc, kc, dec)
        att = att.masked_fill(~tril[None, :, :, None], 0.0)
        diag = torch.einsum("bjhk,hk,bjhk->bjh", rc, u, kc)
        y = y + torch.einsum("bjih,bihv->bjhv", att, vc)
        y = y + diag[..., None] * vc
        total = cs[:, -1:]                                # (B, 1, H, K)
        kdec = kc * torch.exp(total - cs)
        s = torch.exp(total[:, 0])[..., None] * s + \
            torch.einsum("bihk,bihv->bhkv", kdec, vc)
        ys.append(y)
    y = torch.cat(ys, dim=1) if ys else v.new_zeros(v.shape)
    return y, s


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``wkv6_kernel`` (same contract)."""
    b, _, h, kd = r.shape
    zero = torch.zeros((b, h, kd, v.shape[-1]), dtype=torch.float32,
                       device=r.device)
    return chunked_scan(r, k, v, w, u, zero, chunk)
