"""Mixture-of-Experts FFN (qwen3-moe family: 128 experts, top-8).

The port of ``repro.models.moe``: sorted dispatch with a static capacity,
as plain functions on tensors.

  1. router top-k per token (the lower expert index first on equal
     probabilities, as ``jax.lax.top_k`` orders ties: a stable descending
     sort, since ``torch.topk`` promises no order on ties);
  2. flatten the (token, k) pairs and sort them by expert id (stable);
  3. the rank within an expert gives the dispatch row ``e*C + rank``; pairs
     past the capacity C go to a trash row ``E*C`` (GShard drops);
  4. scatter the tokens into an (E, C, d) buffer, run the batched expert
     SwiGLU, gather back, weight and combine.

The reference combines with a scatter-add over the token ids.  On the card
a scatter-add in bf16 runs on atomics whose order changes from run to run,
so here each pair's row is gathered back to its (token, k) place through
the inverse of the sort and the k rows of a token are summed in a fixed
order: deterministic, and equal to the scatter-add up to the order of the
sum.  The expert matmuls are ``einsum`` (cuBLAS), as the reference computes
them outside any kernel.

On a mesh (DTensor activations) the routing, dispatch and combine run on
every rank's replicated copy of the tokens, whose sorts and scatters
DTensor has no sharding rule for, and the expert SwiGLU runs on the expert
buffer as a DTensor against the expert weights' own placements
(``_moe_ffn_on_mesh``); gradients flow through both.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..sharding.context import constrain, is_sharded
from .common import Initializer

__all__ = ["init_moe", "moe_ffn", "load_balance_loss", "capacity", "route",
           "dispatch", "experts", "combine", "Routing", "recording_drops",
           "record_drops"]

_DROPS: contextvars.ContextVar = contextvars.ContextVar("moe_drops",
                                                        default=None)


@contextlib.contextmanager
def recording_drops():
    """Yields a list that collects, for every moe FFN call run inside
    (``moe_ffn`` and ``moe_ep.moe_ffn_ep``), the (token, expert) pairs
    this rank's call dropped by capacity: 0-d int64 tensors on the device
    (nothing waits for them)."""
    drops = []
    token = _DROPS.set(drops)
    try:
        yield drops
    finally:
        _DROPS.reset(token)


def record_drops(count) -> None:
    """Adds a call's dropped pairs, ``count()``, to the list of
    ``recording_drops``; outside it ``count`` is not called."""
    drops = _DROPS.get()
    if drops is not None:
        drops.append(count().detach())


def init_moe(ini: Initializer, cfg) -> dict:
    """Router and expert weights; ``Initializer.normal`` takes the fan-in
    from the first axis, the expert axis of (E, d, ff), as the reference's
    ``ParamBuilder.add`` does."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.moe_experts
    return {"router": ini.normal(d, e, axes=("embed", "experts")),
            "w1": ini.normal(e, d, ff, axes=("experts", "embed", "ff")),
            "w3": ini.normal(e, d, ff, axes=("experts", "embed", "ff")),
            "w2": ini.normal(e, ff, d, axes=("experts", "ff", "embed"))}


def capacity(tokens: int, cfg) -> int:
    """Rows of each expert's buffer: ``max(int(T k / E * factor), k)``."""
    e, k = cfg.moe_experts, cfg.moe_top_k
    return max(int(tokens * k / e * cfg.moe_capacity_factor), k)


class Routing(NamedTuple):
    probs: torch.Tensor      # (T, E) float32 router probabilities
    top_e: torch.Tensor      # (T, k) chosen experts, best first
    top_w: torch.Tensor      # (T, k) float32 weights, normalised over k
    order: torch.Tensor      # (T*k,) pair indices sorted by expert
    dispatch: torch.Tensor   # (T*k,) buffer row of each sorted pair
    keep: torch.Tensor       # (T*k,) bool: the sorted pair fits its expert
    cap: int


def route(p: dict, xt: torch.Tensor, cfg) -> Routing:
    """Router, top-k and sorted dispatch of the tokens xt (T, d)."""
    t = xt.shape[0]
    e, k = cfg.moe_experts, cfg.moe_top_k
    cap = capacity(t, cfg)
    probs = torch.softmax((xt @ p["router"]).float(), dim=-1)      # (T, E)
    ranked_w, ranked_e = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
    top_w, top_e = ranked_w[:, :k], ranked_e[:, :k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    flat_e = top_e.reshape(t * k)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    group_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_in_e = torch.arange(t * k, device=xt.device) - group_start
    keep = pos_in_e < cap
    slot = torch.where(keep, sorted_e * cap + pos_in_e,
                       torch.full_like(sorted_e, e * cap))
    return Routing(probs, top_e, top_w, order, slot, keep, cap)


def dispatch(r: Routing, xt: torch.Tensor, cfg) -> torch.Tensor:
    """Scatter each kept pair's token into its expert's buffer rows ->
    (E, C, d); dropped pairs land on the trash row, which is cut off."""
    e, k = cfg.moe_experts, cfg.moe_top_k
    d = xt.shape[-1]
    buf = xt.new_zeros((e * r.cap + 1, d))
    buf[r.dispatch] = xt[r.order // k]
    return constrain(buf[: e * r.cap].reshape(e, r.cap, d),
                     ("experts", "moe_cap", "embed_act"))


def experts(p: dict, buf: torch.Tensor) -> torch.Tensor:
    """The batched expert SwiGLU over (E, C, d) -> (E, C, d)."""
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, p["w1"])) \
        * torch.einsum("ecd,edf->ecf", buf, p["w3"])
    h = constrain(h, ("experts", "moe_cap", "ff"))
    return torch.einsum("ecf,efd->ecd", h, p["w2"])


def combine(r: Routing, out_buf: torch.Tensor, cfg) -> torch.Tensor:
    """Gather each pair's expert row back and weight it (0 for a dropped
    pair) in sorted order, put the pairs back at their (token, k) places
    and sum the k rows of a token in a fixed order -> (T, d)."""
    k = cfg.moe_top_k
    e, cap, d = out_buf.shape
    n = r.order.shape[0]
    rows = torch.cat([out_buf.reshape(e * cap, d), out_buf.new_zeros(1, d)])
    w_sorted = (r.top_w.reshape(n)[r.order] * r.keep).to(out_buf.dtype)
    y_sorted = rows[r.dispatch] * w_sorted[:, None]
    inverse = torch.empty_like(r.order)
    inverse[r.order] = torch.arange(n, device=out_buf.device)
    return y_sorted[inverse].reshape(n // k, k, d).sum(dim=1)


def moe_ffn(p: dict, x: torch.Tensor, cfg) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), router probs (T, E))."""
    bsz, seq, d = x.shape
    xt = x.reshape(bsz * seq, d)
    if is_sharded(xt):
        y, probs = _moe_ffn_on_mesh(p, xt, cfg)
        return y.reshape(bsz, seq, d), probs
    r = route(p, xt, cfg)
    record_drops(lambda: (~r.keep).sum())
    y = combine(r, experts(p, dispatch(r, xt, cfg)), cfg)
    return y.reshape(bsz, seq, d), r.probs


def _moe_ffn_on_mesh(p: dict, xt, cfg):
    """``moe_ffn`` on DTensor tokens xt (T, d): routing, dispatch and
    combine on this rank's replicated copy of the tokens and the router,
    the expert SwiGLU as DTensors -> (out (T, d), probs (T, E)), both
    replicated DTensors."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = xt.device_mesh
    whole = [Replicate()] * mesh.ndim
    tokens = xt.redistribute(mesh, whole).to_local()
    router = p["router"].redistribute(mesh, whole).to_local()
    r = route({"router": router}, tokens, cfg)
    record_drops(lambda: (~r.keep).sum())
    buf = DTensor.from_local(dispatch(r, tokens, cfg), mesh, whole)
    buf = constrain(buf, ("experts", "moe_cap", "embed_act"))
    out = experts(p, buf).redistribute(mesh, whole).to_local()
    y = combine(r, out, cfg)
    return (DTensor.from_local(y, mesh, whole),
            DTensor.from_local(r.probs, mesh, whole))


def load_balance_loss(probs: torch.Tensor, top_e, cfg) -> torch.Tensor:
    """Switch-style auxiliary loss: E * sum_e f_e * P_e (f from argmax),
    over every token of ``probs`` (..., E)."""
    del top_e
    e = cfg.moe_experts
    tokens = tuple(range(probs.dim() - 1))
    p_mean = probs.mean(dim=tokens)                               # (E,)
    hard = F.one_hot(torch.argmax(probs, dim=-1), e).float().mean(dim=tokens)
    return e * torch.sum(hard * p_mean)
