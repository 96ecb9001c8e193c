"""Device meshes of the port: ``torch.distributed`` ``DeviceMesh``es with
the reference's axis names.

The port of ``repro.launch.mesh``.  The "pod" axis is the data-parallel
dimension across pods; "data" the FSDP/DP axis within one; "model" the
tensor/expert-parallel axis.  ``make_subslice_mesh`` is the elastic-resize
path: it rebuilds a mesh after losing ``drop_data_rows`` rows of the data
axis, keeping the first ranks, and the checkpointer restores state onto it.

A mesh's ranks are processes of the default ``torch.distributed`` group;
``init_process_group`` starts that group from ``torchrun``'s environment
(``gloo`` on the CPU, ``nccl`` on the card), or as a group of one when
there is no such environment and the mesh holds one device.  Meshes are on
``device_type="cuda"`` unless the caller asks for ``"cpu"``.
"""
from __future__ import annotations

import math
import os
import socket

import torch
import torch.distributed as dist

__all__ = ["make_production_mesh", "make_subslice_mesh", "make_debug_mesh",
           "make_mesh", "init_process_group", "parse_mesh"]


def parse_mesh(text: str) -> tuple[int, int]:
    """``"DxM"`` -> (D, M), both positive."""
    try:
        d, m = (int(x) for x in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {text!r}: expected DxM, e.g. 2x2") from None
    if d < 1 or m < 1:
        raise ValueError(f"--mesh {text!r}: both sizes must be positive")
    return d, m


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_process_group(device_type: str = "cuda", size: int = 1) -> None:
    """Start the default process group for a mesh of ``size`` devices, if
    none is running: from ``torchrun``'s environment (``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), or, with no such
    environment and ``size`` 1, as a group of one on a free local port.
    ``nccl`` on the card (each rank on the card of its ``LOCAL_RANK``),
    ``gloo`` on the CPU."""
    if dist.is_initialized():
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda mesh, but no CUDA device is available "
                               "(pass device 'cpu' for the CPU)")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    elif size == 1:
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{_free_port()}",
            rank=0, world_size=1)
    else:
        raise ValueError(f"a mesh of {size} devices needs {size} processes "
                         f"(ranks): launch with torchrun --nproc_per_node "
                         f"{size}")


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over ranks 0 .. n - 1 of
    the default group, which must hold exactly n = prod(shape) ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    n = math.prod(shape)
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"a mesh of shape {tuple(shape)} holds {n} devices, "
                         f"but the process group has {world} ranks")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_debug_mesh(shape=(2, 4), axes=("data", "model"),
                    device_type: str = "cuda"):
    """Small mesh for multi-process tests."""
    return make_mesh(shape, axes, device_type)


def make_subslice_mesh(base_shape=(16, 16), drop_data_rows: int = 8,
                       axes=("data", "model"), device_type: str = "cuda"):
    """Elastic resize: the mesh left after losing ``drop_data_rows`` rows
    of the data axis, over the first ranks of the default group."""
    from torch.distributed.device_mesh import DeviceMesh

    new_shape = (base_shape[0] - drop_data_rows, base_shape[1])
    n = math.prod(new_shape)
    if n < 1 or n > dist.get_world_size():
        raise ValueError(f"sub-slice {new_shape} of {tuple(base_shape)} does "
                         f"not fit the {dist.get_world_size()} ranks")
    ranks = torch.arange(n).reshape(new_shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axes))
