"""Checkpointing: npz shards and a JSON manifest, asynchronous save, restore
into a template.

The port of ``repro.checkpoint.checkpointer``, in its file format:

* step ``N`` is the directory ``step_<N:08d>``, written as ``.tmp`` and
  moved into place by ``os.replace``; it holds ``proc_<rank>.npz`` (key
  path -> array) and ``manifest.json`` (``step``, ``time``,
  ``n_processes``, ``keys`` with each array's shape and dtype, ``extra``);
* a key path joins dictionary keys and list indices with ``::``; dictionary
  keys are taken in sorted order, as JAX flattens them, so the npz entries
  and the manifest come in the reference's order;
* rank and process count are ``torch.distributed``'s when it is
  initialised, else 0 and 1.

On a mesh (the state's leaves are DTensors) ``save`` and ``save_async``
gather each leaf's whole array (a collective every rank makes), and rank 0
alone writes them, after a barrier, into ``proc_0.npz``; ``n_processes``
is the world size.  ``restore(template, shardings=...)`` puts each array
onto the mesh and placements that ``shardings`` gives its leaf (the tree
of ``(mesh, placements)`` that ``sharding.tree_shardings`` makes), from
whatever mesh saved it: an elastic resize restores onto a smaller mesh.
Without ``shardings`` a DTensor leaf of the template keeps its own mesh and
placements.

bfloat16, which numpy has no type for, goes to disk as the reference's
``ml_dtypes`` arrays go: a two-byte void (``V2``) payload, with the dtype
``"bfloat16"`` in the manifest.  Restore reads each array's dtype from the
manifest, views ``V2`` payloads as bfloat16 and only then casts to the
template's dtype (the reference casts the void bytes directly and raises).

The port updates training state in place, so ``save`` and ``save_async``
take a copy on the host before they return (``np.asarray`` of a CPU tensor
would be a view that the next step overwrites).  ``restore`` returns new
tensors on each template leaf's device and in its dtype, reads only the
template's keys (each lazily from its npz) and leaves the template as it
was.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import struct
import threading
import time
import zipfile
import zlib

import numpy as np
import torch

from ..sharding.context import full, is_sharded

__all__ = ["Checkpointer"]

_SEP = "::"
_BF16 = "bfloat16"


def _process() -> tuple[int, int]:
    """(rank, process count): ``torch.distributed``'s once initialised."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier() -> None:
    """Wait for every rank, when there is more than one."""
    if _process()[1] > 1:
        torch.distributed.barrier()


def _mesh_device(mesh) -> torch.device:
    """The device this rank holds of ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _shardings(tree, prefix: tuple = ()):
    """(key path, (mesh, placements)) of every leaf of a shardings tree
    (dictionaries and lists with ``(mesh, placements)`` pairs at the
    leaves), keyed as ``_paths`` keys the state."""
    if isinstance(tree, dict):
        for name in sorted(tree):
            yield from _shardings(tree[name], prefix + (name,))
    elif isinstance(tree, list):
        for i, sub in enumerate(tree):
            yield from _shardings(sub, prefix + (i,))
    else:
        key = _SEP.join(str(p) for p in prefix)
        if not (isinstance(tree, tuple) and len(tree) == 2
                and hasattr(tree[0], "device_type")):
            raise TypeError(f"shardings '{key}': expected a (mesh, "
                            f"placements) pair as sharding.tree_shardings "
                            f"gives it, got {tree!r}")
        yield key, tree


def _paths(tree, prefix: tuple = ()):
    """(key path, tensor) of every leaf of a tree of dictionaries, lists and
    tuples, in JAX's order (dictionary keys sorted); None is an empty
    subtree, as in JAX."""
    if isinstance(tree, dict):
        for name in sorted(tree):
            yield from _paths(tree[name], prefix + (name,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _paths(sub, prefix + (i,))
    elif tree is not None:
        key = _SEP.join(str(p) for p in prefix)
        if not isinstance(tree, torch.Tensor):
            raise TypeError(f"'{key}': a leaf of type {type(tree).__name__}, "
                            f"not a tensor")
        yield key, tree


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(tree, dict):
        out = {name: None for name in tree}
        for name in sorted(tree):
            out[name] = _rebuild(tree[name], leaves)
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(sub, leaves) for sub in tree)
    return None if tree is None else next(leaves)


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host tensor -> (the array to store, its manifest dtype); bfloat16
    as its two-byte payload viewed as ``V2``."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2"), _BF16
    arr = t.numpy()
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored array and its manifest dtype -> a CPU tensor of that dtype
    (``V2`` payloads of ``"bfloat16"`` viewed, not cast)."""
    arr = np.asarray(arr, order="C")        # keeps 0-d arrays 0-d
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr.astype(dtype, copy=False))


class _Npz:
    """The arrays of an npz file, each read when asked for.  A member that
    is stored uncompressed in C order (as ``np.savez`` writes it) is read
    straight into a new array and its CRC-32 checked; numpy's own reader
    takes 256 KiB a call, which a remote file system serves slowly.  Any
    other member goes through ``np.load``."""

    _HEADERS = {(1, 0): np.lib.format.read_array_header_1_0,
                (2, 0): np.lib.format.read_array_header_2_0}

    def __init__(self, path: str):
        self.path = path
        with zipfile.ZipFile(path) as zf:
            self.members = {info.filename[:-4]: info
                            for info in zf.infolist()
                            if info.filename.endswith(".npy")}
        self._raw = open(path, "rb", buffering=0)

    def close(self) -> None:
        self._raw.close()

    def _numpy(self, key: str) -> np.ndarray:
        with np.load(self.path) as z:
            return z[key]

    def read(self, key: str) -> np.ndarray:
        info, f = self.members[key], self._raw
        if info.compress_type != zipfile.ZIP_STORED:
            return self._numpy(key)
        f.seek(info.header_offset + 26)       # the local header's lengths
        name_len, extra_len = struct.unpack("<2H", f.read(4))
        start = info.header_offset + 30 + name_len + extra_len
        f.seek(start)
        read_header = self._HEADERS.get(np.lib.format.read_magic(f))
        if read_header is None:
            return self._numpy(key)
        shape, fortran, dtype = read_header(f)
        if fortran or dtype.hasobject:
            return self._numpy(key)
        header_len = f.tell() - start
        f.seek(start)
        crc = zlib.crc32(f.read(header_len))
        arr = np.empty(shape, dtype)
        buf = arr.reshape(-1).view(np.uint8)
        done = 0
        while done < buf.size:
            n = f.readinto(buf[done:])
            if not n:
                raise ValueError(f"{self.path}: '{key}' ends early")
            done += n
        if zlib.crc32(buf, crc) != info.CRC:
            raise ValueError(f"{self.path}: '{key}' fails its CRC-32")
        return arr


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        # the latest save's step, seconds of its host snapshot and of its
        # write, and the bytes of its npz
        self.last_save: dict | None = None

    # ----------------------------------------------------------------- io
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    # --------------------------------------------------------------- save
    def _snapshot(self, step: int, tree) -> list[tuple[str, object]]:
        """(key path, host copy) of every leaf of ``tree`` (whole arrays,
        gathered on every rank; kept by rank 0 alone); starts
        ``last_save``."""
        t0 = time.perf_counter()
        keep = _process()[0] == 0
        # a copy, also on the CPU: the port's train step writes its state
        # in place while a background write may still be reading
        flat = []
        for key, leaf in _paths(tree):
            whole = full(leaf.detach())
            if keep:
                flat.append((key, whole.to("cpu", copy=True)))
            del whole
        self.last_save = {"step": step,
                          "snapshot_s": time.perf_counter() - t0,
                          "write_s": None}
        return flat

    def save(self, step: int, tree, extra: dict | None = None) -> str:
        """Write ``tree`` as step ``step`` (rank 0 writes; every rank
        returns once it is in place)."""
        flat = self._snapshot(step, tree)
        _barrier()
        if _process()[0] == 0:
            self._write(step, flat, extra or {})
        _barrier()
        return self._step_dir(step)

    def save_async(self, step: int, tree, extra: dict | None = None) -> None:
        """Snapshot ``tree`` to the host now; write it in a background
        thread on rank 0 (one writer at a time)."""
        self.wait()
        flat = self._snapshot(step, tree)
        _barrier()
        if _process()[0] != 0:
            return
        self._thread = threading.Thread(
            target=self._write, args=(step, flat, extra or {}), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the background write; on a mesh, every rank returns once
        it is in place."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        _barrier()

    def _write(self, step: int, flat: list, extra: dict) -> str:
        t0 = time.perf_counter()
        d = self._step_dir(step)
        tmp = d + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        arrays, dtypes = {}, {}
        for key, leaf in flat:
            arrays[key], dtypes[key] = _to_numpy(leaf)
        proc, n_processes = _process()
        np.savez(os.path.join(tmp, f"proc_{proc}.npz"), **arrays)
        manifest = {
            "step": step,
            "time": time.time(),
            "n_processes": n_processes,
            "keys": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                     for k, v in arrays.items()},
            "extra": extra,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(d):
            shutil.rmtree(d)
        os.replace(tmp, d)
        self._gc()
        self.last_save.update(
            write_s=time.perf_counter() - t0,
            bytes=os.path.getsize(os.path.join(d, f"proc_{proc}.npz")))
        return d

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------ restore
    def restore(self, template, step: int | None = None,
                shardings=None) -> tuple:
        """New tensors in the structure of ``template``, each in its leaf's
        dtype: a DTensor on the ``(mesh, placements)`` that ``shardings``
        gives its key, or else on the template leaf's own mesh and
        placements where it is a DTensor, or else a tensor on its device;
        the latest step unless ``step`` is given.  Returns (tree, manifest
        extra)."""
        from torch.distributed.tensor import distribute_tensor

        onto = dict(_shardings(shardings)) if shardings is not None else {}
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        dtypes = {k: v["dtype"] for k, v in manifest["keys"].items()}
        files = [_Npz(os.path.join(d, name))
                 for name in sorted(os.listdir(d)) if name.endswith(".npz")]
        try:
            where = {k: z for z in files for k in z.members}
            leaves = []
            for key, leaf in _paths(template):
                if key not in where:
                    raise KeyError(f"checkpoint missing '{key}'")
                arr = where[key].read(key)
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(
                        f"shape mismatch for '{key}': ckpt {arr.shape} vs "
                        f"template {tuple(leaf.shape)}")
                t = _to_tensor(arr, dtypes.get(key, str(arr.dtype)))
                target = onto.get(key)
                if target is None and is_sharded(leaf):
                    target = (leaf.device_mesh, leaf.placements)
                if target is None:
                    leaves.append(t.to(device=leaf.device, dtype=leaf.dtype))
                    continue
                mesh, places = target
                t = t.to(device=_mesh_device(mesh), dtype=leaf.dtype)
                # every rank read the same array: each keeps its own shard
                leaves.append(distribute_tensor(t, mesh, places,
                                                src_data_rank=None))
        finally:
            for z in files:
                z.close()
        return _rebuild(template, iter(leaves)), manifest.get("extra", {})
