"""Per-device costs of a step, counted from the ops it runs.

The port has no compiler to ask, so its dry run (``launch/dryrun.py``)
runs the step itself, on ``meta`` tensors over a fake process group, and
counts what it dispatches with ``StepTrace``, a ``TorchDispatchMode``:

* **dot FLOPs**: ``torch.utils.flop_counter``'s formulas (matmuls,
  convolutions, attention), on the shapes each op gets;
* **bytes at op boundaries**: every op that is not a view reads its
  tensor inputs and writes its outputs once.  XLA's ``bytes accessed``
  counts only at fusion boundaries (ops fused into one kernel do not
  touch device memory between them), so this **overcounts** against the
  reference's numbers: every elementwise op of a chain is charged;
* **collectives**: bytes and counts by the reference's op names and byte
  convention (``analysis/hlo.py``: the bytes of the result on one device):
  ``all_gather_into_tensor`` is ``all-gather``, ``all_reduce``
  ``all-reduce``, ``reduce_scatter_tensor`` ``reduce-scatter``,
  ``all_to_all_single`` ``all-to-all``; ``wait_tensor`` is no collective;
* **live bytes**: the storages the step's ops make, from their first op
  to their release (a weak reference on each storage), with their peak:
  the dry run's ``temp_bytes``.

**Which level it sees.** A mode runs before a tensor subclass, so over
DTensors it would see each op once at the DTensor's global shapes.
``StepTrace`` declines wrapper subclasses (DTensor, the asynchronous
collective tensor) and so sees the ops that DTensor runs on each rank's
local shards, and the collectives its redistributions issue: the counts
of the one device whose rank runs the step, as the reference's post-SPMD
HLO is one device's.  Ops on fake tensors are DTensor's own shape
propagation and are not counted.  A redistribution's collectives are
those of the mesh's device type: on a CPU mesh DTensor moves a shard from
one tensor dimension to another by an all-gather and a local chunk, on a
CUDA mesh by an all-to-all.
"""
from __future__ import annotations

import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          is_traceable_wrapper_subclass_type)

from .hlo import CollectiveStats

__all__ = ["StepTrace", "COLLECTIVES", "tensor_bytes"]

# op name (the functional and the autograd variants, and c10d's in-place
# ops) -> the reference's HLO name
COLLECTIVES = {
    "all_gather_into_tensor": "all-gather", "_allgather_base_": "all-gather",
    "allgather_": "all-gather", "all_gather_into_tensor_coalesced":
    "all-gather",
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}
_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d")
_NO_COST = {"wait_tensor", "_wrap_tensor_autograd"}


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in _tensors(sub)]
    if isinstance(tree, dict):
        return [t for sub in tree.values() for t in _tensors(sub)]
    return []


def tensor_bytes(tree) -> int:
    """Bytes of the tensors in ``tree`` (a DTensor's local shard)."""
    total = 0
    for t in _tensors(tree):
        t = getattr(t, "_local_tensor", t)
        total += t.numel() * t.element_size()
    return total


class StepTrace(TorchDispatchMode):
    """Counts the ops run inside it on this rank's local tensors.

    ``dot_flops``, ``bytes_accessed`` (with ``bytes_by_op``),
    ``collectives`` (a ``CollectiveStats``), ``live_bytes`` and
    ``peak_live_bytes``; ``to_json()`` gives them as a record."""

    def __init__(self):
        super().__init__()
        self.dot_flops = 0.0
        self.bytes_accessed = 0.0
        self.bytes_by_op: dict[str, float] = {}
        self.collectives = CollectiveStats()
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._live: set[int] = set()
        self._kinds: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(is_traceable_wrapper_subclass_type(t) for t in types):
            return NotImplemented       # let the subclass unwrap first
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if FakeTensor not in types and not isinstance(out, FakeTensor):
            self._count(func, args, kwargs, out)
        return out

    def _kind(self, func) -> tuple:
        """(collective name or None, no cost, view, mutable, FLOP formula
        or None) of an op, worked out once."""
        kind = self._kinds.get(func)
        if kind is None:
            from torch.utils.flop_counter import flop_registry

            ours = func.namespace in _NAMESPACES
            kind = (COLLECTIVES.get(func._opname) if ours else None,
                    ours and func._opname in _NO_COST, func.is_view,
                    func._schema.is_mutable,
                    flop_registry.get(func.overloadpacket))
            self._kinds[func] = kind
        return kind

    def _count(self, func, args, kwargs, out) -> None:
        collective, no_cost, view, mutable, flops = self._kind(func)
        if no_cost:
            return
        if collective is not None:
            # the result on this device: the functional ops return it,
            # c10d's in-place ops write it into their first argument
            result = out if func.namespace != "c10d" else args[0]
            nbytes = tensor_bytes(result)
            stats = self.collectives
            stats.bytes_by_op[collective] = \
                stats.bytes_by_op.get(collective, 0) + nbytes
            stats.count_by_op[collective] = \
                stats.count_by_op.get(collective, 0) + 1
        if flops is not None:
            self.dot_flops += float(flops(*args, **kwargs, out_val=out))
        if view:
            return
        nbytes = tensor_bytes([args, kwargs, out])
        key = str(func.overloadpacket)
        self.bytes_accessed += nbytes
        self.bytes_by_op[key] = self.bytes_by_op.get(key, 0) + nbytes
        if not mutable:
            for t in _tensors(out):
                self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        """Counts ``t``'s storage as live until it is released."""
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self._live:
            return
        nbytes = storage.nbytes()
        self._live.add(key)
        self.live_bytes += nbytes
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        weakref.finalize(storage, self._release, key, nbytes)

    def _release(self, key: int, nbytes: int) -> None:
        if key in self._live:
            self._live.discard(key)
            self.live_bytes -= nbytes

    def to_json(self) -> dict:
        return {"dot_flops": self.dot_flops,
                "bytes_accessed": self.bytes_accessed,
                "bytes_by_op": {k: round(v) for k, v in sorted(
                    self.bytes_by_op.items(), key=lambda kv: -kv[1])},
                "collectives": self.collectives.to_json(),
                "peak_live_bytes": self.peak_live_bytes}
