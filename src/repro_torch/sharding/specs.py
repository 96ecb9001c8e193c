"""Logical-axis -> mesh-axis sharding rules with divisibility fallbacks.

The port of ``repro.sharding.specs``.  Models name every parameter, cache
and activation dimension with a logical axis (``Model.param_specs``).  This
module maps those names onto the mesh's axes ("pod", "data", "model"): a
rule is applied only if the dimension divides evenly by the mesh axes,
otherwise the next-best subset of axes is used, and replication is the last
resort.  The rule engine is the reference's, in pure Python.

Two rule sets:
  * TRAIN: FSDP-style, "embed" rows over the data axis, tensor-parallel
    columns over "model", experts over "data".
  * SERVE: weights replicated over "data" (except experts), KV-cache
    sequence over "model".

A spec is the tuple a ``PartitionSpec`` holds: one entry per tensor
dimension, each None, a mesh axis name or a tuple of names, with trailing
Nones dropped.  ``placements`` turns it into DTensor placements over a
``DeviceMesh``: mesh dimension j is ``Shard(i)`` where tensor dimension i's
entry names mesh axis j, else ``Replicate()``.  A tensor dimension split
over several mesh axes is split in mesh-dimension order by DTensor and in
the entry's order by JAX, so an entry whose axes are out of the mesh's
order raises instead of being reordered.

``resolve_spec`` takes a ``DeviceMesh`` or any object with ``axis_names``
(or ``mesh_dim_names``) and ``shape`` (sizes in axis order, or a mapping of
name to size), so the rules resolve without a process group.
"""
from __future__ import annotations

import itertools
from collections.abc import Mapping
from dataclasses import dataclass, field

__all__ = ["Rules", "TRAIN_RULES", "SERVE_RULES", "resolve_spec",
           "tree_specs", "tree_shardings", "batch_spec", "placements",
           "axis_sizes"]


@dataclass(frozen=True)
class Rules:
    name: str
    mapping: dict[str, tuple[str, ...]] = field(default_factory=dict)
    # Cross-dim fallback: when no dim of a tensor could take the "model"
    # axis (e.g. 40 heads on a 16-wide axis), allow an "embed" dim to carry
    # it in addition to its own axes (row-parallel attention instead of
    # replicated attention compute).
    model_fallback: bool = False

    def axes_for(self, logical: str) -> tuple[str, ...]:
        return self.mapping.get(logical, ())


TRAIN_RULES = Rules("train", {
    "embed": ("data",),            # FSDP rows
    "embed2": ("data",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "ff": ("model",),
    "vocab": ("model",),
    "inner": ("model",),
    "experts": ("data",),          # EP shares the FSDP axis
    "vision": ("data",),
    "codebooks": (),
    "batch": ("pod", "data"),
    "seq": (),
    "kv_seq": ("model",),
    "state_heads": ("model",),
})

SERVE_RULES = Rules("serve", {
    "embed": ("model",),           # fallback TP when heads/ff can't divide
    "embed2": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "ff": ("model",),
    "vocab": ("model",),
    "inner": ("model",),
    "experts": ("data",),
    "vision": (),
    "codebooks": (),
    "batch": ("pod", "data"),
    "seq": (),
    "kv_seq": ("model",),          # sequence-parallel KV cache
    "state_heads": ("model",),
})


# Lower value = assigned first. Preferred TP dims (heads/ff/vocab/experts)
# claim mesh axes before the "embed" fallback dims, regardless of the order
# the dimensions appear in the tensor.
_PRIORITY = {
    "batch": 0, "experts": 0,
    "heads": 1, "kv_heads": 1, "ff": 1, "vocab": 1, "inner": 1,
    "kv_seq": 1, "state_heads": 1,
    "embed": 3, "embed2": 3, "vision": 3,
}


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of an object with
    ``axis_names`` and ``shape``."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return {name: int(shape[name]) for name in names}
    return dict(zip(names, (int(s) for s in shape)))


def _subsets_by_product(axes: tuple[str, ...], sizes: dict[str, int]):
    """Non-empty ordered subsets of ``axes``, largest shard-product first."""
    out = []
    for r in range(len(axes), 0, -1):
        for comb in itertools.combinations(axes, r):
            prod = 1
            for a in comb:
                prod *= sizes[a]
            out.append((prod, comb))
    out.sort(key=lambda t: -t[0])
    return [c for _, c in out]


def resolve_spec(shape: tuple[int, ...], logical: tuple[str, ...],
                 rules: Rules, mesh) -> tuple:
    """The spec of one tensor, honoring divisibility and axis reuse."""
    assert len(shape) == len(logical), (shape, logical)
    sizes = axis_sizes(mesh)
    used: set[str] = set()
    parts: list = [None] * len(shape)
    order = sorted(range(len(shape)),
                   key=lambda i: (_PRIORITY.get(logical[i], 2), i))
    for i in order:
        dim, name = shape[i], logical[i]
        cand = tuple(a for a in rules.axes_for(name)
                     if a in sizes and a not in used)
        chosen: tuple[str, ...] = ()
        for subset in _subsets_by_product(cand, sizes) if cand else []:
            prod = 1
            for a in subset:
                prod *= sizes[a]
            if prod > 1 and dim % prod == 0:
                chosen = subset
                break
        if chosen:
            used.update(chosen)
            parts[i] = chosen if len(chosen) > 1 else chosen[0]
    if rules.model_fallback and "model" in sizes and "model" not in used:
        msize = sizes["model"]
        for i in order:
            if logical[i] not in ("embed", "embed2"):
                continue
            cur = parts[i]
            cur_axes = (() if cur is None
                        else (cur if isinstance(cur, tuple) else (cur,)))
            prod = msize
            for a in cur_axes:
                prod *= sizes[a]
            if prod > 1 and shape[i] % prod == 0:
                parts[i] = cur_axes + ("model",) if cur_axes else "model"
                used.add("model")
                break
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _map(fn, tree, logical):
    """``fn(leaf, axes)`` over a tree of dictionaries and lists whose
    logical-axes twin has tuples of names at its leaves."""
    if isinstance(tree, dict):
        return {name: _map(fn, sub, logical[name])
                for name, sub in tree.items()}
    if isinstance(tree, list):
        if not isinstance(logical, list) or len(logical) != len(tree):
            raise TypeError(f"logical axes {logical!r} do not match a list "
                            f"of {len(tree)}")
        return [_map(fn, sub, axes) for sub, axes in zip(tree, logical)]
    if not isinstance(logical, tuple):
        raise TypeError(f"bad logical axes {logical!r}")
    return fn(tree, logical)


def tree_specs(shape_tree, logical_tree, rules: Rules, mesh):
    """(tree of tensors or anything with ``.shape``, logical-axes tree) ->
    spec tree of the same structure."""
    return _map(lambda leaf, axes: resolve_spec(tuple(leaf.shape), axes,
                                                rules, mesh),
                shape_tree, logical_tree)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements over ``mesh`` of a spec: mesh dimension j takes
    ``Shard(i)`` where tensor dimension i's entry names axis j, else
    ``Replicate()``.  Raises where an entry of several axes is out of the
    mesh's axis order (DTensor would split it in another order)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(axis_sizes(mesh))
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry!r} of dimension {i} is out "
                             f"of the mesh's axis order {tuple(names)}; "
                             f"DTensor would split it in that order")
        for j in dims:
            out[j] = Shard(i)
    return tuple(out)


def tree_shardings(shape_tree, logical_tree, rules: Rules, mesh):
    """The tree of ``(mesh, placements)`` of every leaf."""
    specs = tree_specs(shape_tree, logical_tree, rules, mesh)
    return _map(lambda spec, _: (mesh, placements(spec, mesh)), specs,
                specs)


def batch_spec(shape: tuple[int, ...], rules: Rules, mesh,
               seq_axes: tuple[str, ...] = ()) -> tuple:
    """Spec for a [batch, seq, ...] input tensor."""
    logical = ("batch",) + seq_axes + ("",) * (len(shape) - 1 - len(seq_axes))
    return resolve_spec(shape, logical[: len(shape)], rules, mesh)
