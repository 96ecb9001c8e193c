"""Build and load the host runner's compiled chase.

The chase must be a native loop of dependent loads: a step through the
Python interpreter, ``torch.jit`` or tensor indexing costs hundreds of
nanoseconds, which would swamp every cache level of the host.  So
``csrc/host_chase.c`` compiles with the host C compiler (``$CC``, else
``cc``, ``gcc`` or ``clang`` on the ``PATH``) at first use into
``build/host/`` at the root of the checkout, under a name keyed by a hash
of the source, the compiler and the flags, and is loaded with ``ctypes``.
A missing compiler or a failed build raises; there is no slower stand-in.
Numpy and the standard library only: pool workers load it without
importing ``torch``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

__all__ = ["HostBuildInfo", "CFLAGS", "build_host_chase", "load_host_chase",
           "host_chase"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "host_chase.c"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "host"
CFLAGS = ("-O2", "-fPIC", "-shared")
_COMPILERS = ("cc", "gcc", "clang")


@dataclass(frozen=True)
class HostBuildInfo:
    """Where the library came from: its path, the compiler and flags that
    built it, and the wall seconds the build took (0.0 when an earlier
    build was loaded)."""

    path: Path
    compiler: str
    flags: tuple
    seconds: float


def _compiler() -> str:
    cc = os.environ.get("CC") or next(
        (found for name in _COMPILERS if (found := shutil.which(name))), None)
    if not cc:
        raise RuntimeError("no host C compiler found: set CC or put one of "
                           f"{', '.join(_COMPILERS)} on the PATH")
    return cc


def build_host_chase(build_dir: Path | None = None) -> HostBuildInfo:
    """Compile ``csrc/host_chase.c`` into ``build_dir`` (``build/host/``)
    unless this source, compiler and flags were built there before; raise
    if no compiler is found or it fails."""
    cc = _compiler()
    digest = hashlib.sha256(" ".join((cc,) + CFLAGS).encode())
    digest.update(SOURCE.read_bytes())
    name = f"libhost_chase_{digest.hexdigest()[:16]}.so"
    lib = Path(build_dir or BUILD_DIR) / name
    if lib.exists():
        return HostBuildInfo(lib, cc, CFLAGS, 0.0)
    lib.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=lib.parent) as work:
        tmp = os.path.join(work, lib.name)
        try:
            proc = subprocess.run([cc, *CFLAGS, "-o", tmp, str(SOURCE)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
        except OSError as exc:
            raise RuntimeError(f"host C compiler {cc!r} did not run: "
                               f"{exc}") from exc
        if proc.returncode or not os.path.exists(tmp):
            raise RuntimeError(f"host chase build failed ({cc}, exit "
                               f"{proc.returncode}):\n{proc.stdout}")
        os.replace(tmp, lib)      # atomic: a concurrent build loses nothing
    return HostBuildInfo(lib, cc, CFLAGS, time.perf_counter() - t0)


_lock = threading.Lock()
_loaded: tuple | None = None


def load_host_chase():
    """``(fn, HostBuildInfo)``, built on first use; thread-safe.

    ``fn(perm_address, iters)`` is the raw C entry point: it walks the
    int32 buffer at ``perm_address`` and trusts every value in it to be a
    slot of that buffer (``host_chase`` checks a numpy buffer first)."""
    global _loaded
    with _lock:
        if _loaded is None:
            info = build_host_chase()
            fn = ctypes.CDLL(str(info.path)).host_chase
            fn.argtypes = (ctypes.c_void_p, ctypes.c_int64)
            fn.restype = ctypes.c_int32
            _loaded = (fn, info)
        return _loaded


def host_chase(perm: np.ndarray, iters: int) -> int:
    """The slot reached after ``iters`` steps of ``x = perm[x]`` from 0."""
    perm = np.ascontiguousarray(perm, dtype=np.int32)
    if perm.ndim != 1 or not perm.size:
        raise ValueError("perm must be a non-empty 1-D array")
    if perm.min() < 0 or perm.max() >= perm.size:
        raise ValueError("perm holds a slot outside the buffer")
    fn, _ = load_host_chase()
    return int(fn(perm.ctypes.data, int(iters)))
