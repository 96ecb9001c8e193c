"""Activation-sharding constraints through a context.

The port of ``repro.sharding.context``.  The models call
``constrain(x, logical_axes)`` at block boundaries.  Inside an
``activation_sharding(mesh, rules)`` context a DTensor ``x`` is
redistributed to the placements the rules give its shape on the mesh;
outside the context, for a plain tensor, or for a mismatched rank the call
returns ``x`` as it is, so the same model code runs on one device
unchanged.

The context also lets the models' plain tensors (positions, masks,
constants) meet DTensors: inside it they are taken as replicated over the
DTensor's mesh (``torch.distributed.tensor.experimental
.implicit_replication``).  ``on_mesh`` is that alone, for callers that
want no activation constraints (serving, whose reference runs without
them).
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch

from .specs import Rules, placements, resolve_spec

__all__ = ["activation_sharding", "constrain", "current_mesh", "on_mesh",
           "is_sharded", "replicate_like", "full", "distribute",
           "on_local_shards"]

_CTX: contextvars.ContextVar = contextvars.ContextVar("act_sharding",
                                                      default=None)


@contextlib.contextmanager
def on_mesh():
    """Plain tensors meeting DTensors inside count as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication

    with implicit_replication():
        yield


@contextlib.contextmanager
def activation_sharding(mesh, rules: Rules):
    """Enable activation constraints for everything run inside."""
    token = _CTX.set((mesh, rules))
    try:
        with on_mesh():
            yield
    finally:
        _CTX.reset(token)


def is_sharded(x) -> bool:
    """True for a DTensor."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def replicate_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` as it is, or, when ``like`` is a DTensor, ``t`` (on ``like``'s
    local device, whole on every rank) as a DTensor replicated over
    ``like``'s mesh, sharing ``t``'s storage."""
    if not is_sharded(like):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def full(x):
    """A DTensor's whole value as a plain tensor on every rank (a
    collective); anything else as it is."""
    return x.full_tensor() if is_sharded(x) else x


def distribute(tree, shardings):
    """A tree (dictionaries and lists) of whole tensors, the same on every
    rank, as DTensors on the ``(mesh, placements)`` of ``shardings`` (a
    pair, or a tree of them of ``tree``'s structure); each rank keeps its
    own shards, with no communication."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, dict):
        return {name: distribute(sub, shardings[name] if isinstance(
            shardings, dict) else shardings) for name, sub in tree.items()}
    if isinstance(tree, list):
        return [distribute(sub, shardings[i] if isinstance(shardings, list)
                           else shardings) for i, sub in enumerate(tree)]
    mesh, places = shardings
    return distribute_tensor(tree, mesh, places, src_data_rank=None)


def current_mesh():
    """Mesh of the active activation-sharding context (None outside)."""
    ctx = _CTX.get()
    return ctx[0] if ctx is not None else None


def constrain(x: torch.Tensor, logical: tuple[str, ...]) -> torch.Tensor:
    """Redistribute a DTensor to the active (mesh, rules)' placements for
    its shape; ``x`` itself outside the context, for a plain tensor or for
    a mismatched rank."""
    ctx = _CTX.get()
    if ctx is None or not is_sharded(x) or len(logical) != x.dim():
        return x
    mesh, rules = ctx
    spec = resolve_spec(tuple(x.shape), logical, rules, mesh)
    target = placements(spec, mesh)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(mesh, target)


def on_local_shards(fn, inputs: list, dims: list, out_dims: list):
    """``fn`` over DTensor (or plain) ``inputs`` on each rank's local
    shards -> its outputs as DTensors on the inputs' mesh.

    ``dims[i]`` is (batch dim, head dim) of input i, each None where it has
    none; ``out_dims`` the same of each output.  A mesh dimension along
    which the first input is sharded on its batch (or head) dimension
    shards every input on its batch (head) dimension, provided each such
    dimension divides evenly by all the mesh dimensions that take it; every
    other mesh dimension is replicated.  Heads split evenly alike keep a
    grouped-query mapping local: query head h of a shard reads kv head
    h // G of the same shard.  Where the kv heads cannot split as the
    query heads do (8 query heads to 1 kv head on 2 ranks), the heads are
    replicated, never paired across shards.  Plain inputs count as
    replicated.  Gradients flow through (``to_local``/``from_local``): a
    mesh dimension that splits neither batch nor heads runs ``fn`` alike
    on each of its ranks."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    lead = next(t for t in inputs if is_sharded(t))
    mesh = lead.device_mesh
    inputs = [t if is_sharded(t) else replicate_like(t, lead)
              for t in inputs]
    first_batch, first_head = dims[0]
    kinds = []
    for placement in inputs[0].placements:
        if placement.is_shard(first_batch):
            kinds.append(0)
        elif first_head is not None and placement.is_shard(first_head):
            kinds.append(1)
        else:
            kinds.append(None)
    for kind in (0, 1):
        n = math.prod(mesh.size(j) for j, k in enumerate(kinds) if k == kind)
        if any(d[kind] is not None and t.shape[d[kind]] % n
               for t, d in zip(inputs, dims)):
            kinds = [None if k == kind else k for k in kinds]

    def layout(d):
        return tuple(Shard(d[k]) if k is not None and d[k] is not None
                     else Replicate() for k in kinds)

    local = []
    for t, d in zip(inputs, dims):
        if tuple(t.placements) != layout(d):
            t = t.redistribute(mesh, layout(d))
        local.append(t.to_local().contiguous())
    outs = fn(*local)
    single = not isinstance(outs, tuple)
    wrapped = tuple(DTensor.from_local(o, mesh, layout(d), run_check=False)
                    for o, d in zip((outs,) if single else outs, out_dims))
    return wrapped[0] if single else wrapped
