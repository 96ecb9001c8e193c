"""Shared model building blocks in PyTorch (plain tensors, no nn.Module).

Parameters are plain dictionaries of tensors, one dictionary per layer in a
list where the reference stacks layers on a leading axis.  ``Initializer``
draws them from an explicit ``torch.Generator`` on the target device with
the reference's shapes and scales (``1/sqrt(fan_in)`` normals, ones,
zeros); the two packages' random numbers differ, so weights cross from one
to the other only through ``models.convert``.
"""
from __future__ import annotations

import contextvars
import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..sharding.context import is_sharded, on_local_shards

__all__ = ["Initializer", "ShapeInitializer", "AxesInitializer", "rms_norm",
           "rope_angles", "apply_rope", "attention", "swiglu",
           "cross_entropy", "remat_layer", "DTYPES"]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


class Initializer:
    """Draws parameters in a fixed order from ``generator``, on its device,
    in ``dtype``; normals are drawn in float32, scaled, then cast.  Every
    call names the leaf's logical axes (``axes``), as the reference's
    ``ParamBuilder.add`` does; ``ShapeInitializer`` and ``AxesInitializer``
    run the same ``init`` code for the shapes and the axes alone."""

    def __init__(self, generator: torch.Generator, dtype: torch.dtype):
        self.generator = generator
        self.dtype = dtype
        self.device = generator.device

    def normal(self, *shape: int, axes: tuple[str, ...]) -> torch.Tensor:
        _check_axes(shape, axes)
        fan_in = shape[0] if len(shape) > 1 else shape[-1]
        x = torch.randn(shape, generator=self.generator, device=self.device,
                        dtype=torch.float32)
        return x.mul_(1.0 / math.sqrt(max(fan_in, 1))).to(self.dtype)

    def ones(self, *shape: int, axes: tuple[str, ...]) -> torch.Tensor:
        _check_axes(shape, axes)
        return torch.ones(shape, dtype=self.dtype, device=self.device)

    def zeros(self, *shape: int, axes: tuple[str, ...]) -> torch.Tensor:
        _check_axes(shape, axes)
        return torch.zeros(shape, dtype=self.dtype, device=self.device)


def _check_axes(shape: tuple, axes: tuple) -> None:
    if not isinstance(axes, tuple) or len(axes) != len(shape):
        raise ValueError(f"logical axes {axes!r} do not name the "
                         f"{len(shape)} dimensions of {shape}")


class ShapeInitializer(Initializer):
    """Leaves as tensors on the ``meta`` device: shapes and dtypes, no
    storage and no draw (a ``torch.Generator`` has no ``meta`` device)."""

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype
        self.device = torch.device("meta")

    def normal(self, *shape: int, axes: tuple[str, ...]) -> torch.Tensor:
        return self.zeros(*shape, axes=axes)


class AxesInitializer:
    """Leaves as their logical axes (tuples of names)."""

    def normal(self, *shape: int, axes: tuple[str, ...]) -> tuple:
        _check_axes(shape, axes)
        return axes

    ones = zeros = normal


# ------------------------------------------------------------------ layers
def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * gamma.float()).to(dt)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """NeoX-style rotary angles for given absolute positions (any shape)."""
    half = head_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=positions.device) / half
    freqs = torch.pow(theta, exponent)     # no host-to-device copy
    ang = positions.float()[..., None] * freqs              # (..., half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., n_heads, head_dim); cos/sin broadcastable (..., half)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == x.dim() - 1:
        cos, sin = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _attend(q, k, v, mask, scale):
    """q (B,Tq,Hkv,G,hd), k/v (B,Tk,Hkv,hd), mask (Tq,Tk) or None."""
    scores = torch.einsum("btkgh,bskh->bkgts", q, k).float() * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgts,bskh->btkgh", probs, v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, q_offset: int = 0, prefix_len: int | None = None,
              q_chunk: int = 0) -> torch.Tensor:
    """Plain GQA attention. q (B,Tq,Hq,hd), k/v (B,Tk,Hkv,hd) -> (B,Tq,Hq,hd).

    ``q_offset``: absolute position of q[0]; ``prefix_len``: positions below
    it attend bidirectionally (prefix-LM; with ``causal`` only, as the
    reference's); ``q_chunk``: if > 0 and Tq >= 2 * q_chunk, queries are
    taken a chunk at a time so the score matrix never materialises at
    (Tq, Tk).  Training's forward runs this, as the reference's does; the
    serving path's prefill goes through the flash kernel instead
    (``kernels.ops.mha``, which takes the same ``prefix_len`` and refuses
    inputs that require grad).  DTensors run on each rank's shards of
    batch and heads (``on_local_shards``): DTensor has no rule for the
    grouped einsum's reshapes of a tensor split over both at once.
    """
    if is_sharded(q):
        return on_local_shards(functools.partial(
            attention, causal=causal, q_offset=q_offset,
            prefix_len=prefix_len, q_chunk=q_chunk),
            [q, k, v], [(0, 2)] * 3, [(0, 2)])
    b, tq, hq, hd = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, tq, hkv, hq // hkv, hd)
    scale = 1.0 / math.sqrt(hd)
    k_pos = torch.arange(tk, device=q.device)

    def mask_for(q_pos):
        if not causal:
            return None
        m = q_pos[:, None] >= k_pos[None, :]
        if prefix_len is not None:
            m = m | ((q_pos[:, None] < prefix_len)
                     & (k_pos[None, :] < prefix_len))
        return m

    if q_chunk and tq >= 2 * q_chunk and tq % q_chunk == 0:
        outs = []
        for start in range(0, tq, q_chunk):
            q_pos = q_offset + start + torch.arange(q_chunk, device=q.device)
            outs.append(_attend(qg[:, start:start + q_chunk], k, v,
                                mask_for(q_pos), scale))
        return torch.cat(outs, dim=1).reshape(b, tq, hq, hd)
    q_pos = q_offset + torch.arange(tq, device=q.device)
    return _attend(qg, k, v, mask_for(q_pos), scale).reshape(b, tq, hq, hd)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def remat_layer(fn, remat: bool, context_fn=None):
    """``fn`` as it is, or, when ``remat``, ``fn`` whose activations are
    recomputed in the backward pass instead of kept (non-reentrant
    activation checkpointing: gradients reach every tensor ``fn`` reads,
    its arguments' nested dictionaries included); ``context_fn`` makes it
    selective (``torch.utils.checkpoint.checkpoint``'s argument).  The
    recompute runs in the context variables of the forward call
    (``sharding.context``'s mesh among them): on the card the autograd
    engine runs the backward on a thread of its own, where they are
    unset."""
    if not remat:
        return fn
    kw = {} if context_fn is None else {"context_fn": context_fn}

    def layer(*args):
        run = functools.partial(contextvars.copy_context().run, fn)
        return checkpoint(run, *args, use_reentrant=False, **kw)

    return layer


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token CE. logits (..., V) any dtype; targets int (...)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    # the difference is taken before the gathered axis is dropped: on a
    # vocab-sharded DTensor the gather's partial result carries a mask of
    # the gather's own shape
    gold = torch.gather(logits, -1, targets[..., None].long())
    nll = (logz[..., None] - gold)[..., 0]
    if weights is None:
        return nll.mean()
    return (nll * weights).sum() / torch.clamp(weights.sum(), min=1.0)
