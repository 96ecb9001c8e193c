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

import torch

from .specs import Rules, placements, resolve_spec

__all__ = ["activation_sharding", "constrain", "current_mesh", "on_mesh",
           "is_sharded", "replicate_like", "full", "distribute"]

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
