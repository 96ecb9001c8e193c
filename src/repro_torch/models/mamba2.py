"""Mamba2 (SSD) block, the state-space mixer inside zamba2-2.7b.

The port of ``repro.models.mamba2``.  Scalar-per-head decay
a_t = exp(-softplus(dt_t) * exp(A_log)); state (B, H, P, N) in float32.
``mamba2_seq`` evaluates a sequence in chunks (SSD, decay algebra in
float32), ``mamba2_step`` is the exact recurrence of one decode token; the
tests hold the two to each other and to the reference.  Both are plain
PyTorch, as the reference computes them outside any kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import Initializer

__all__ = ["init_mamba2", "mamba2_seq", "mamba2_step", "dims"]


def dims(cfg) -> tuple[int, int, int, int]:
    """(d_inner, heads, head dim P, state N)."""
    d_in = cfg.ssm_expand * cfg.d_model
    p = cfg.ssm_head_dim
    return d_in, d_in // p, p, cfg.ssm_state


def init_mamba2(ini: Initializer, cfg) -> dict:
    d = cfg.d_model
    d_in, h, _, n = dims(cfg)
    conv_dim = d_in + 2 * n
    # in_proj emits [z (d_in), x (d_in), B (n), C (n), dt (h)]
    return {"ln": ini.ones(d, axes=("embed",)),
            "in_proj": ini.normal(d, 2 * d_in + 2 * n + h,
                                  axes=("embed", "inner")),
            "conv_w": ini.normal(cfg.ssm_conv_width, conv_dim,
                                 axes=("conv", "inner")),
            "conv_b": ini.zeros(conv_dim, axes=("inner",)),
            "a_log": ini.zeros(h, axes=("state_heads",)),
            "d_skip": ini.ones(h, axes=("state_heads",)),
            "dt_bias": ini.zeros(h, axes=("state_heads",)),
            "out_norm": ini.ones(d_in, axes=("inner",)),
            "out_proj": ini.normal(d_in, d, axes=("inner", "embed"))}


def _split(cfg, zxbcdt):
    d_in, _, _, n = dims(cfg)
    return (zxbcdt[..., :d_in], zxbcdt[..., d_in: 2 * d_in + 2 * n],
            zxbcdt[..., 2 * d_in + 2 * n:])


def _rms(x, gamma, eps=1e-6):
    """The reference mixer's own f32 RMS norm."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * gamma.float()).to(x.dtype)


def _ssd_chunk(s, xc, bc, cc, dtc, lac):
    """One chunk of SSD from state s (B, H, P, N); all float32.  Returns
    (the state after the chunk, y (B, C, H, P))."""
    cs = torch.cumsum(lac, dim=1)                    # (B, C, H) inclusive
    # inter-chunk: y_j += exp(L_j) C_j . S
    y_inter = torch.einsum("bjn,bhpn,bjh->bjhp", cc, s, torch.exp(cs))
    # intra-chunk: att[j, i] = C_j . B_i exp(L_j - L_i) for i <= j; above
    # the diagonal L_j - L_i is set to -inf before the exp, which there
    # overflows to inf at strong decays (a mask after the exp would give
    # NaN gradients, 0 * inf)
    c = xc.shape[1]
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=xc.device))
    gap = (cs[:, :, None] - cs[:, None]).masked_fill(
        ~mask[None, :, :, None], -math.inf)           # (B, j, i, H)
    att = torch.einsum("bjn,bin->bji", cc, bc)[..., None] * torch.exp(gap)
    xdt = xc * dtc[..., None]                        # (B, C, H, P)
    y = y_inter + torch.einsum("bjih,bihp->bjhp", att, xdt)
    total = cs[:, -1]                                # (B, H)
    bdec = bc[:, :, None, :] * torch.exp(total[:, None] - cs)[..., None]
    s = torch.exp(total)[..., None, None] * s + \
        torch.einsum("bihn,bihp->bhpn", bdec, xdt)
    return s, y


def mamba2_seq(p_, x, cfg, state=None, conv_state=None, chunk: int = 64):
    """Full-sequence SSD.  x (B, T, d) -> (y (B, T, d), ssm state (B, H, P,
    N) float32, conv state (B, cw-1, conv_dim) in x's dtype)."""
    b, t, _ = x.shape
    d_in, h, pp, n = dims(cfg)
    cw = cfg.ssm_conv_width

    hin = _rms(x, p_["ln"], cfg.norm_eps)
    z, xbc, dt = _split(cfg, hin @ p_["in_proj"])

    # depthwise causal conv over [x; B; C], width cw
    if conv_state is None:
        conv_state = xbc.new_zeros((b, cw - 1, xbc.shape[-1]))
    xbc_pad = torch.cat([conv_state, xbc], dim=1)
    new_conv_state = xbc_pad[:, -(cw - 1):]
    conv = sum(xbc_pad[:, i: i + t] * p_["conv_w"][i] for i in range(cw))
    xbc = F.silu(conv + p_["conv_b"])
    xs = xbc[..., :d_in].reshape(b, t, h, pp)
    bmat = xbc[..., d_in: d_in + n]                  # (B, T, N)
    cmat = xbc[..., d_in + n:]                       # (B, T, N)

    dt = F.softplus(dt.float() + p_["dt_bias"])      # (B, T, H)
    neg_a = -torch.exp(p_["a_log"].float())          # (H,)
    la = dt * neg_a                                  # log decay

    if state is None:
        state = torch.zeros((b, h, pp, n), dtype=torch.float32,
                            device=x.device)
    if t % chunk != 0:
        chunk = t                                    # single-chunk fallback
    xs_f32 = xs.float()
    parts = (xs_f32, bmat.float(), cmat.float(), dt, la)
    ys = []
    for start in range(0, t, chunk):
        state, y = _ssd_chunk(state, *(a[:, start:start + chunk]
                                       for a in parts))
        ys.append(y)
    y = torch.cat(ys, dim=1)                         # (B, T, H, P)

    y = y + xs_f32 * p_["d_skip"].float()[None, None, :, None]
    y = y.reshape(b, t, d_in).to(x.dtype)
    y = _rms(y * F.silu(z), p_["out_norm"], cfg.norm_eps)
    return y @ p_["out_proj"], state, new_conv_state


def mamba2_step(p_, x, cfg, state, conv_state):
    """One-token recurrence.  x (B, d) -> (y (B, d), state', conv_state')."""
    b, _ = x.shape
    d_in, h, pp, n = dims(cfg)

    hin = _rms(x[:, None], p_["ln"], cfg.norm_eps)[:, 0]
    z, xbc, dt = _split(cfg, hin @ p_["in_proj"])
    window = torch.cat([conv_state, xbc[:, None]], dim=1)       # (B, cw, D)
    new_conv_state = window[:, 1:]
    conv = torch.einsum("bwd,wd->bd", window, p_["conv_w"])
    xbc = F.silu(conv + p_["conv_b"])
    xs = xbc[..., :d_in].reshape(b, h, pp).float()
    bvec = xbc[..., d_in: d_in + n].float()
    cvec = xbc[..., d_in + n:].float()

    dt = F.softplus(dt.float() + p_["dt_bias"])                 # (B, H)
    decay = torch.exp(dt * -torch.exp(p_["a_log"].float()))
    xdt = xs * dt[..., None]                                    # (B, H, P)
    state = decay[..., None, None] * state + \
        torch.einsum("bhp,bn->bhpn", xdt, bvec)
    y = torch.einsum("bhpn,bn->bhp", state, cvec)
    y = y + xs * p_["d_skip"].float()[None, :, None]
    y = y.reshape(b, d_in).to(x.dtype)
    y = _rms((y * F.silu(z))[:, None], p_["out_norm"], cfg.norm_eps)[:, 0]
    return y @ p_["out_proj"], state, new_conv_state
