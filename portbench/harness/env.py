"""Where a run reads and writes, and what it may not load.

``prepare()`` runs before torch is imported: every cache the program or
PyTorch may write goes to a fixed directory inside the checkout, so only
the first run of a cell in a checkout builds; the host's thread pools
take one thread, as serving processes commonly do (the run is one
process whose host work is one thread of launches, and idle pool threads
only contend for the cores it shares); and the port's ``src/`` goes on
``sys.path``.  ``forbidden_modules()`` names the loaded modules whose
top-level name is the JAX package's, JAX's or Flax's: the names are
compared whole, since the port's own name begins with the JAX package's.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]          # portbench/
ROOT = BENCH.parent                                  # the checkout
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def prepare() -> None:
    """Fixed cache directories inside the checkout, one host thread a
    pool, and ``src/`` importable.  The port's own kernel build lands in
    ``build/kernels`` there."""
    cache = ROOT / "build" / "portbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(cache / sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules (``sys.modules`` unless given) whose top-level
    name is one of ``FORBIDDEN``, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(name for name in names
                  if name.split(".", 1)[0] in FORBIDDEN)
