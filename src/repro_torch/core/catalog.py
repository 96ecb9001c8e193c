"""Known-hardware catalog.

MT4G consults vendor APIs/datasheets where information is programmatically
available and benchmarks the rest (paper §III).  This catalog holds the
reference package's datasheet records as data (two TPU generations and a
placeholder for the host CPU); the port adds no GPU entry.  The roofline
analyzer and the perf model consume ``HardwareSpec`` records;
``core.discover`` emits the same record shape, so a *discovered* topology
can replace a catalog entry on real hardware — exactly the paper's
substitution of benchmarks for datasheets.  A name with no entry (a
simulated device, or ``cuda-model``) is answered from a store's discovered
topology overlaid on ``HOST_CPU``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["HardwareSpec", "TPU_V5E", "TPU_V4", "HOST_CPU", "get_spec",
           "spec_from_store", "CATALOG"]


@dataclass(frozen=True)
class HardwareSpec:
    """Per-chip performance constants used by roofline + perf model."""

    name: str
    peak_bf16_flops: float        # FLOP/s per chip
    hbm_bandwidth: float          # bytes/s per chip
    hbm_bytes: int                # capacity per chip
    ici_link_bandwidth: float     # bytes/s per ICI link (one direction)
    ici_links_per_chip: int       # usable links per chip in a 2-D torus
    dcn_bandwidth: float          # bytes/s per host across pods
    vmem_bytes: int               # on-chip vector memory per core
    smem_bytes: int               # scalar memory per core
    mxu_shape: tuple[int, int] = (128, 128)
    notes: str = ""


# Google TPU v5e (the production target mesh: 16x16 per pod).
# Constants per the assignment: 197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link.
TPU_V5E = HardwareSpec(
    name="tpu-v5e",
    peak_bf16_flops=197e12,
    hbm_bandwidth=819e9,
    hbm_bytes=16 * 1024**3,
    ici_link_bandwidth=50e9,
    ici_links_per_chip=4,
    dcn_bandwidth=25e9,
    vmem_bytes=128 * 1024**2 // 8,   # ~16 MiB VMEM per core
    smem_bytes=1024 * 1024 // 8,
    notes="v5e: 1 TensorCore/chip, 4 ICI links, 2D torus",
)

TPU_V4 = HardwareSpec(
    name="tpu-v4",
    peak_bf16_flops=275e12,
    hbm_bandwidth=1228e9,
    hbm_bytes=32 * 1024**3,
    ici_link_bandwidth=50e9,
    ici_links_per_chip=6,
    dcn_bandwidth=25e9,
    vmem_bytes=16 * 1024**2,
    smem_bytes=128 * 1024,
    notes="v4: 2 TensorCores/chip, 3D torus",
)

# The CPU this container runs on — filled conservatively; the discovery
# pipeline measures the real values and overrides these.
HOST_CPU = HardwareSpec(
    name="host-cpu",
    peak_bf16_flops=5e10,
    hbm_bandwidth=10e9,
    hbm_bytes=32 * 1024**3,
    ici_link_bandwidth=10e9,
    ici_links_per_chip=1,
    dcn_bandwidth=1e9,
    vmem_bytes=1 * 1024**2,
    smem_bytes=64 * 1024,
    mxu_shape=(1, 1),
    notes="placeholder — discovery overrides",
)

CATALOG: dict[str, HardwareSpec] = {
    s.name: s for s in (TPU_V5E, TPU_V4, HOST_CPU)
}


def get_spec(name: str, store=None) -> HardwareSpec:
    """Resolve a hardware spec, preferring *discovered* values.

    With a ``TopologyStore``, a stored discovered topology for ``name``
    (matched on model or spec name, newest first) overlays its measured
    values onto the static record — the paper's substitution of benchmarks
    for datasheets, made durable.  Without a store (or a stored entry) the
    static datasheet record answers as before.
    """
    if store is not None:
        spec = spec_from_store(name, store)
        if spec is not None:
            return spec
    try:
        return CATALOG[name]
    except KeyError as e:
        raise KeyError(f"unknown hardware '{name}'; known: {sorted(CATALOG)}") from e


def spec_from_store(name: str, store) -> HardwareSpec | None:
    """Newest stored discovered topology for ``name`` overlaid onto the
    static base record (``HOST_CPU`` when the name has no datasheet entry)."""
    from .discover import spec_from_topology  # late: discover imports catalog

    entries = store.find(model=name)
    if not entries:
        return None
    base = CATALOG.get(name, HOST_CPU)
    spec = spec_from_topology(entries[0].topology, base)
    if spec is base:
        return None                     # nothing measured worth overlaying
    import dataclasses
    return dataclasses.replace(spec, name=name,
                               notes=f"{base.notes} [overlaid from discovered "
                                     f"topology {entries[0].key}]".strip())
