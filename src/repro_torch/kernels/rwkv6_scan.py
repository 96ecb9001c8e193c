"""Chunked RWKV6 WKV recurrence for NVIDIA Hopper.

The CUDA C++ kernels live in ``csrc/wkv6.cu`` (its note says what bounds
them and how they are laid out); this module launches them and holds their
plain PyTorch versions.  They replace the reference's Pallas
``wkv6_chunked_kernel`` (``repro/kernels/rwkv6_scan.py:74``) in two passes:
``wkv6_chunk_kernel`` computes, for every chunk at once, what depends on
that chunk alone, and ``wkv6_state_kernel`` walks the chunks in order with
the state.

All take r, k, w (B, T, H, K), v (B, T, H, V) and u (H, K) in float32 and
return y (B, T, H, V) and the final state (B, H, K, V) in float32, from a
zero state, with T a multiple of ``chunk``.  The kernels take chunk
``CHUNK`` and K = V in ``HEAD_SIZES``; ``pad_wkv`` pads other shapes to
theirs (``head_size``) with terms that add exactly zero, and ``ops.wkv6``
slices the result back.  ``chunked_scan`` is the chunk-parallel math
from any incoming state, which the model's ``wkv_chunked`` also runs;
``wkv6_plain`` is it from a zero state, and ``wkv6_split_plain`` the two
kernels' split of the same function.  Inputs are validated by the wrapper;
the functions here assume contiguous tensors of matching shapes on one
device.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ._build import check_launch, load_library

__all__ = ["CHUNK", "HEAD_SIZES", "KERNELS", "scratch_floats", "head_size",
           "pad_wkv", "wkv6_kernel", "wkv6_plain", "wkv6_split_plain",
           "chunked_scan"]

CHUNK = 32                          # kC of csrc/wkv6.cu: one step a lane
HEAD_SIZES = (8, 16, 32, 64, 128)   # K = V, as wkv6_fwd's switch takes them
# the kernels one call launches, in order
KERNELS = ("wkv6_chunk_kernel", "wkv6_state_kernel")


def scratch_floats(b: int, t: int, h: int, kd: int) -> int:
    """Floats of the record the first kernel leaves for the second: per
    (b, h, chunk), r exp(L_{j-1}) and k exp(L_C - L) (C x K each) and
    exp(L_C) (K); ``scratch_floats`` of the source, which checks it."""
    return b * h * (t // CHUNK) * (2 * kd * CHUNK + kd)


def head_size(kd: int, vd: int) -> int:
    """The kernels' head size for K = ``kd`` and V = ``vd``: the smallest of
    ``HEAD_SIZES`` that holds both.  Raises past the largest, 128, which
    the reference's own note sizes its kernel for."""
    for size in HEAD_SIZES:
        if size >= max(kd, vd):
            return size
    raise ValueError(f"wkv6 takes K and V up to {HEAD_SIZES[-1]}, got K "
                     f"{kd}, V {vd}")


def pad_wkv(r, k, v, w, u, size: int, chunk: int) -> tuple:
    """r, k, v, w, u padded to K = V = ``size`` and T a multiple of
    ``chunk``: r = k = 0, w = 1 and u = 0 in the padded K columns, v = 0 in
    the padded V columns, r = k = v = 0 and w = 1 on the padded steps.  A
    padded channel's state stays 0 and a padded step decays it by 1 and adds
    nothing, so every real output and state entry is exact.  The inputs
    come back as they are where nothing is padded."""
    t, kd, vd = r.shape[1], r.shape[3], v.shape[3]
    dt, dk, dv = -t % chunk, size - kd, size - vd
    if dt or dk:
        r, k = (F.pad(x, (0, dk, 0, 0, 0, dt)) for x in (r, k))
        w = F.pad(w, (0, dk, 0, 0, 0, dt), value=1.0)
    if dt or dv:
        v = F.pad(v, (0, dv, 0, 0, 0, dt))
    if dk:
        u = F.pad(u, (0, dk))
    return r, k, v, w, u


def wkv6_kernel(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor,
                chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """CUDA WKV6 in two launches: the chunk-local terms of every chunk at
    once, then the state walked over the chunks by slices of V columns."""
    b, t, h, kd = r.shape
    vd = v.shape[-1]
    if chunk != CHUNK or kd != vd or kd not in HEAD_SIZES:
        raise ValueError(f"wkv6 kernel takes chunk {CHUNK} and K = V in "
                         f"{HEAD_SIZES}, got chunk {chunk}, K {kd}, V {vd}")
    lib, _ = load_library()
    y = torch.empty((b, t, h, vd), dtype=torch.float32, device=r.device)
    state = torch.empty((b, h, kd, vd), dtype=torch.float32, device=r.device)
    n = scratch_floats(b, t, h, kd)
    scratch = torch.empty(n, dtype=torch.float32, device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    check_launch(lib, "wkv6_fwd", lib.wkv6_fwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        y.data_ptr(), state.data_ptr(), scratch.data_ptr(), n, b, t, h, kd,
        vd, chunk, stream))
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
        # L_{j-1} - L_i for i < j, -inf on and above the diagonal, so the
        # exp is 0 there: unmasked, it overflows to inf at strong decays,
        # and a mask after the exp would give NaN gradients (0 * inf)
        gap = (lp[:, :, None] - cs[:, None]).masked_fill(
            ~tril[None, :, :, None, None], -math.inf)     # (B, j, i, H, K)
        att = torch.einsum("bjhk,bihk,bjihk->bjih", rc, kc, torch.exp(gap))
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


def wkv6_split_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor,
                     chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' two passes in plain PyTorch (same contract as
    ``wkv6_plain``), in log2 units as the kernels count.  Pass 1, every
    chunk at once: prefix sums L_j and L_{j-1} and suffix sums L_C - L_j of
    log2 w, the pairwise weights exp2(L_{j-1} - L_i) (i < j, a difference
    <= 0), the diagonal bonus and y_intra, r exp2(L_{j-1}),
    k exp2(L_C - L) and exp2(L_C).  Pass 2, the chunks in order: y_c +=
    (r exp2(L_{j-1})) S, then S <- diag(exp2(L_C)) S + (k exp2(L_C - L))^T v.
    """
    b, t, h, kd = r.shape
    vd = v.shape[-1]
    n = t // chunk

    def by_chunk(x):
        return x.float().reshape(b, n, chunk, h, x.shape[-1])

    rc, kc, vc, wc = map(by_chunk, (r, k, v, w))          # (B, N, C, H, *)
    lw = torch.log2(wc)
    incl = torch.cumsum(lw, dim=2)                        # L_j
    excl = F.pad(incl, (0, 0, 0, 0, 1, 0))[:, :, :-1]     # L_{j-1}
    tail = lw.flip(2).cumsum(2).flip(2)                   # sum over >= j
    after = F.pad(tail, (0, 0, 0, 0, 0, 1))[:, :, 1:]     # L_C - L_j
    rd = rc * torch.exp2(excl)
    kdec = kc * torch.exp2(after)
    el = torch.exp2(tail[:, :, 0])                        # (B, N, H, K)
    dec = torch.exp2((excl[:, :, :, None] - incl[:, :, None]).clamp(max=0))
    att = torch.einsum("bnjhk,bnihk,bnjihk->bnjih", rc, kc, dec)
    below = torch.ones(chunk, chunk, dtype=torch.bool,
                       device=r.device).tril(-1)
    att = att.masked_fill(~below[:, :, None], 0.0)
    diag = torch.einsum("bnjhk,hk,bnjhk->bnjh", rc, u.float(), kc)
    y = torch.einsum("bnjih,bnihv->bnjhv", att, vc) + diag[..., None] * vc
    s = torch.zeros((b, h, kd, vd), dtype=torch.float32, device=r.device)
    for c in range(n):
        y[:, c] += torch.einsum("bjhk,bhkv->bjhv", rd[:, c], s)
        s = el[:, c][..., None] * s + torch.einsum("bihk,bihv->bhkv",
                                                   kdec[:, c], vc[:, c])
    return y.reshape(b, t, h, vd), s
