"""Expert-parallel MoE FFN: explicit all-to-alls over a device mesh.

The port of ``repro.models.moe_ep``.  The sorted-dispatch MoE
(``models.moe``) on a mesh routes every rank's replicated copy of the
tokens and runs the expert SwiGLU as DTensors, which gathers the whole
(E*C, d) buffer.  This module routes tokens explicitly, as the reference's
``shard_map`` body does, on each rank's local shards:

  1. per rank: top-k routing of its own tokens, destination rank
     ``expert // E_local``;
  2. pack the (token, k) pairs into per-destination slots (static capacity
     ``C_send``);
  3. an all-to-all over the expert axis's group (the expert weights are
     sharded over it);
  4. local capacity dispatch to the rank's E_local experts, batched matmuls
     (ff sharded over "model": partial sums, reduced once at the end);
  5. the reverse all-to-all (rows return to their send slots), weight and
     combine at the source.

Axes are chosen as the reference chooses them: the expert axis is "data"
(else the mesh's last), the tensor axis "model", the batch split over
("pod", "data").  The inputs are laid out as the reference's ``in_specs``
(x by batch, the router replicated, w1/w3 (E over ep, ., ff over tp), w2
(E over ep, ff over tp, .)), by redistributing DTensors (a plain tensor
counts as the same whole value on every rank) and taking their local
shards; the outputs are DTensors with its ``out_specs``.  An exchange is
the functional collective ``all_to_all_single`` and its wait; those of
activations carry autograd (``_Exchange``: the backward is the reverse
exchange, as for ``lax.all_to_all``), and the sum over the tensor axis is
DTensor's ``Partial`` -> ``Replicate`` redistribution, whose backward
passes the replicated gradient through.

``remat="save_a2a"`` (``save_a2a_contexts``) keeps the outputs of the
forward all-to-alls through selective activation checkpointing, so the
layer's recompute in the backward issues none of them again; the reference
names the same tensors "moe_a2a" for its remat policy.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F

from ..sharding.context import is_sharded
from ..sharding.specs import placements
from .moe import record_drops

__all__ = ["moe_ffn_ep", "save_a2a_contexts"]

_IN_A2A: contextvars.ContextVar = contextvars.ContextVar("moe_a2a",
                                                         default=False)


def _positions_within_groups(group_ids: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its group (stable: in index order)."""
    n = group_ids.shape[0]
    order = torch.argsort(group_ids, stable=True)
    sorted_g = group_ids[order]
    start = torch.searchsorted(sorted_g, sorted_g, side="left")
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(n, device=group_ids.device) - start
    return ranks


@contextlib.contextmanager
def _saved_exchange():
    """Marks the ops inside as an exchange whose output ``save_a2a``
    keeps (the reference's ``checkpoint_name(..., "moe_a2a")``)."""
    token = _IN_A2A.set(True)
    try:
        yield
    finally:
        _IN_A2A.reset(token)


def _save_a2a_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if _IN_A2A.get()
            else CheckpointPolicy.PREFER_RECOMPUTE)


def save_a2a_contexts():
    """``context_fn`` of ``torch.utils.checkpoint.checkpoint`` for
    ``remat="save_a2a"``: everything is recomputed in the backward but
    the outputs of the moe's forward all-to-alls, which are kept."""
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return create_selective_checkpoint_contexts(_save_a2a_policy)


def _exchange(t: torch.Tensor, group: str, ranks: int) -> torch.Tensor:
    """Row block i of ``t`` to rank i of the process group named ``group``
    (of ``ranks`` ranks); block j of the result from rank j: the
    reference's ``lax.all_to_all(split_axis=0, concat_axis=0)``.  The
    functional collective and its wait are marked as the exchange
    ``save_a2a`` keeps."""
    t = t.contiguous()
    sizes = [t.shape[0] // ranks] * ranks
    with _saved_exchange():
        out = torch.ops._c10d_functional.all_to_all_single(t, sizes, sizes,
                                                           group)
        return torch.ops._c10d_functional.wait_tensor(out)


class _Exchange(torch.autograd.Function):
    """``_exchange`` with autograd: the backward is the reverse exchange
    (the block a rank sent comes back to it)."""

    @staticmethod
    def forward(ctx, t, group: str, ranks: int):
        ctx.exchange = (group, ranks)
        return _exchange(t, group, ranks)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, *ctx.exchange), None, None


def _ep_axes(mesh) -> tuple[str, str | None, tuple[str, ...]]:
    """(expert axis, tensor axis or None, batch axes) of ``mesh``, as the
    reference picks them."""
    names = tuple(mesh.mesh_dim_names)
    ep_axis = "data" if "data" in names else names[-1]
    tp_axis = "model" if "model" in names else None
    if tp_axis == ep_axis:
        raise ValueError(f"mesh axes {names}: the expert axis and the tensor "
                         f"axis are both {ep_axis!r}")
    dp_axes = tuple(a for a in ("pod", "data") if a in names)
    return ep_axis, tp_axis, dp_axes


def _entry(axes: tuple[str, ...]):
    return (axes if len(axes) > 1 else axes[0]) if axes else None


def _local(t: torch.Tensor, mesh, spec: tuple) -> torch.Tensor:
    """This rank's shard of ``t`` laid out as ``spec`` on ``mesh``: a
    DTensor redistributed there, a plain tensor (the whole value on every
    rank) cut there with no communication.  Its gradient is a partial sum
    over the mesh axes ``spec`` does not split (each rank's tokens add
    their own part), as ``shard_map`` sums an input's cotangent over the
    axes its spec leaves out."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    for dim, entry in enumerate(spec):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        n = math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in axes)
        if t.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                             f"divide over the mesh axes {axes} ({n})")
    if not is_sharded(t):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    places = placements(spec, mesh)
    grads = [Partial() if q.is_replicate() else q for q in places]
    return t.redistribute(mesh, places).to_local(grad_placements=grads)


class _ScaleGrad(torch.autograd.Function):
    """The identity, whose backward scales the gradient."""

    @staticmethod
    def forward(ctx, t, scale: float):
        ctx.scale = scale
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


def _out(t: torch.Tensor, mesh, places: list, copies: int):
    """A DTensor of the local ``t`` in ``places``.  ``copies`` ranks hold
    the same value, each computed from the same inputs, so each passes on
    1/copies of the gradient (``shard_map``'s cotangent of an output its
    spec leaves axes out of)."""
    from torch.distributed.tensor import DTensor

    if copies > 1:
        t = _ScaleGrad.apply(t, 1.0 / copies)
    return DTensor.from_local(t, mesh, places, run_check=False)


def _ep_body(x, router, w1, w3, w2, *, cfg, ep_group: str, dsz: int):
    """The reference's ``shard_map`` body on local shards: x (B_loc, S, d);
    w* with E over ep and ff over tp -> (partial y (B_loc, S, d), probs
    (T_loc, E))."""
    b_loc, s, d = x.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    e_loc = e // dsz
    t = b_loc * s
    cf = cfg.moe_capacity_factor

    xt = x.reshape(t, d)
    probs = torch.softmax((xt @ router).float(), dim=-1)       # (T, E)
    # jax.lax.top_k's order: the lower expert first on equal probabilities
    top_w, top_e = (v[:, :k] for v in torch.sort(probs, dim=-1,
                                                 descending=True,
                                                 stable=True))
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    pairs = t * k
    flat_e = top_e.reshape(pairs)
    flat_w = top_w.reshape(pairs).to(x.dtype)
    token_id = torch.arange(t, device=x.device).repeat_interleave(k)

    # ---- pack into per-destination-rank slots
    dest = flat_e // e_loc
    c_send = max(int(math.ceil(pairs / dsz * cf)), k)
    pos = _positions_within_groups(dest)
    keep = pos < c_send
    slot = torch.where(keep, dest * c_send + pos,
                       torch.full_like(dest, dsz * c_send))
    send_x = xt.new_zeros((dsz * c_send + 1, d)).index_put(
        (slot,), xt[token_id])[:-1]
    send_e = torch.full((dsz * c_send + 1,), e, dtype=flat_e.dtype,
                        device=x.device).index_put((slot,), flat_e % e_loc)
    send_e = send_e[:-1]

    # ---- exchange: row block i goes to rank i
    rx = _Exchange.apply(send_x, ep_group, dsz)            # (dsz*c_send, d)
    re = _exchange(send_e, ep_group, dsz)          # in [0, e_loc]; e: empty
    rows = dsz * c_send

    # ---- local capacity dispatch to this rank's e_loc experts
    c_loc = max(int(math.ceil(rows / e_loc * cf)), 1)
    lpos = _positions_within_groups(re)
    lkeep = (re < e_loc) & (lpos < c_loc)
    lslot = torch.where(lkeep, re * c_loc + lpos,
                        torch.full_like(re, e_loc * c_loc))
    buf = rx.new_zeros((e_loc * c_loc + 1, d)).index_put((lslot,), rx)
    buf = buf[:-1].reshape(e_loc, c_loc, d)
    record_drops(lambda: (~keep).sum() + ((re < e_loc) & ~lkeep).sum())

    h = F.silu(torch.einsum("ecd,edf->ecf", buf, w1)) \
        * torch.einsum("ecd,edf->ecf", buf, w3)
    out = torch.einsum("ecf,efd->ecd", h, w2).reshape(e_loc * c_loc, d)
    out = torch.cat([out, out.new_zeros(1, d)])

    # ---- return rows to their send slots (the exchange is an involution)
    back = out[lslot] * lkeep[:, None].to(x.dtype)
    ret = _Exchange.apply(back, ep_group, dsz)
    ret = torch.cat([ret, ret.new_zeros(1, d)])

    # ---- weight and combine at the source: a token's k pairs are
    # consecutive, so the reference's scatter-add over token ids is a sum
    # over k in a fixed order
    y_pairs = ret[slot] * (flat_w * keep.to(x.dtype))[:, None]
    y = y_pairs.reshape(t, k, d).sum(dim=1)
    return y.reshape(b_loc, s, d), probs


def moe_ffn_ep(p: dict, x: torch.Tensor, cfg, mesh):
    """Drop-in for ``moe.moe_ffn`` with explicit expert-parallel exchanges
    over ``mesh`` (a ``DeviceMesh``) -> (y (B, S, d), router probs (T, E)),
    both DTensors: y split by batch over ("pod", "data"), probs by token
    likewise, each replicated over the other axes."""
    from torch.distributed.tensor import Partial

    ep_axis, tp_axis, dp_axes = _ep_axes(mesh)
    names = tuple(mesh.mesh_dim_names)
    batch = _entry(dp_axes)
    ep_dim = names.index(ep_axis)
    dsz = mesh.size(ep_dim)
    if cfg.moe_experts % dsz:
        raise ValueError(f"{cfg.moe_experts} experts do not divide over the "
                         f"expert axis {ep_axis!r} ({dsz})")

    y, probs = _ep_body(
        _local(x, mesh, (batch, None, None)),
        _local(p["router"], mesh, ()),
        _local(p["w1"], mesh, (ep_axis, None, tp_axis)),
        _local(p["w3"], mesh, (ep_axis, None, tp_axis)),
        _local(p["w2"], mesh, (ep_axis, tp_axis, None)),
        cfg=cfg, ep_group=mesh.get_group(ep_dim).group_name, dsz=dsz)

    # Each output is computed alike on every rank of the axes its spec
    # leaves out; y's partial sums over the tensor axis are reduced there.
    out = list(placements((batch,), mesh))
    sizes = dict(zip(names, mesh.shape))
    copies = math.prod(n for a, n in sizes.items() if a not in dp_axes)
    probs = _out(probs, mesh, out, copies)
    if tp_axis is None:
        return _out(y, mesh, out, copies), probs
    partial = list(out)
    partial[names.index(tp_axis)] = Partial()
    y = _out(y, mesh, partial, copies // sizes[tp_axis])
    return y.redistribute(mesh, out), probs
