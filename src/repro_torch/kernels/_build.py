"""Build and load the CUDA C++ kernels.

``kernels/csrc/*.cu`` compile with ``nvcc`` for ``sm_90a``, one compiler
process per source, all started together, and link into one shared library
with a plain C interface, which is loaded with ``ctypes``.  The build runs
at first use, never at import, and lands in ``build/kernels/`` at the root
of the checkout under a name keyed by a hash of the sources and flags, so
an edited source builds anew and an unchanged one is loaded as it is.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["BuildInfo", "load_library", "check_launch"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signature of each entry point: (argtypes, restype).
_SIGNATURES = {
    "pchase_batch": ((_P, _P, _P, _I, _I, _P), _I),
    "eviction_batch": ((_P, _P, _P, _P, _P, _I, _I, _I, _P), _I),
    "chase_floor": ((_P, _I, _I, _I, _I, _P, _P), _I),
    "flash_attention_fwd": ((_P,) * 4 + (_I,) * 9 + (_P,), _I),
    "flash_attention_sm90_fwd": ((_P,) * 4 + (_I,) * 9 + (_P,), _I),
    "stream_read_fwd": ((_P,) * 4 + (_L, _L, _P), _I),
    "stream_write_fwd": ((_P, _P, _L, _P), _I),
    "wkv6_fwd": ((_P,) * 8 + (_L,) + (_I,) * 6 + (_P,), _I),
    "probe_error_string": ((_I,), ctypes.c_char_p),
}


@dataclass(frozen=True)
class BuildInfo:
    """Where the library came from: its path, the wall seconds the build
    took (0.0 when an earlier build was loaded), each source's compile
    seconds (taken while all compiled at once) and the compiler's output."""

    path: Path
    seconds: float
    log: str
    per_source: dict = field(default_factory=dict)


_lock = threading.Lock()
_loaded: tuple[ctypes.CDLL, BuildInfo] | None = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _run(cmd: list[str]) -> tuple[subprocess.CompletedProcess, float]:
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    return proc, time.perf_counter() - t0


def _build() -> BuildInfo:
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib = BUILD_DIR / f"libport_kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return BuildInfo(lib, 0.0, "")
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [os.path.join(work, f"{src.stem}.o") for src in sources]
        with ThreadPoolExecutor(len(sources)) as pool:
            done = list(pool.map(_run, (
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                for src, obj in zip(sources, objs))))
        log = "".join(f"== {src.name}\n{proc.stdout}"
                      for src, (proc, _) in zip(sources, done))
        failed = [f"{src.name} ({proc.returncode})"
                  for src, (proc, _) in zip(sources, done) if proc.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{log}")
        tmp = os.path.join(work, lib.name)
        proc, _ = _run([nvcc, "-shared", "-o", tmp, *objs])
        if proc.returncode:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}")
        os.replace(tmp, lib)      # atomic: a concurrent build loses nothing
    return BuildInfo(lib, time.perf_counter() - t0, log,
                     {src.name: sec for src, (_, sec) in zip(sources, done)})


def load_library() -> tuple[ctypes.CDLL, BuildInfo]:
    """The kernel library, built on first use; thread-safe."""
    global _loaded
    with _lock:
        if _loaded is None:
            info = _build()
            lib = ctypes.CDLL(str(info.path))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _loaded = (lib, info)
        return _loaded


def check_launch(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if the C entry point ``name`` returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err} ({lib.probe_error_string(err).decode()})")
