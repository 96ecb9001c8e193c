"""Three-term roofline from the compiled dry-run (assignment §Roofline).

The port of ``repro.analysis.roofline``.  The port's dry-run records
(``launch/dryrun.py``) carry no ``hlo_cost``: their ``cost`` and
``collectives`` come from ``analysis.trace`` counting the step per device,
every microbatch included, so ``roofline_from_cell`` reads them through
its fallback branch.

    compute    = HLO_FLOPs_per_device   / peak_FLOP/s_per_chip
    memory     = HLO_bytes_per_device   / HBM_bw_per_chip
    collective = coll_bytes_per_device  / (ici_links_per_chip * link_bw)

``cost_analysis``/HLO text are per-device (post-SPMD) so per-chip constants
divide directly — equivalent to the assignment's total/(chips x bw) form.
Hardware constants come from ``core.catalog`` (or a discovered topology via
``spec_from_topology`` — the MT4G integration point, paper §VI-B).

Also reported per cell: MODEL_FLOPS = 6*N*D (dense; 6*N_active*D for MoE;
x3 only for training — fwd 2ND + bwd 4ND), the MODEL/HLO flops ratio
(remat/redundancy waste detector), the dominant term, and the roofline
fraction = dominant / sum(terms proxy).
"""
from __future__ import annotations

from dataclasses import dataclass

from ..core.catalog import HardwareSpec

__all__ = ["RooflineTerms", "roofline_from_cell", "model_flops"]


@dataclass(frozen=True)
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops_per_device: float
    useful_ratio: float        # MODEL_FLOPS / (HLO_FLOPs * chips)
    bound: str                 # compute | memory | collective
    step_time_s: float         # max of the three terms (overlap-optimistic)
    roofline_fraction: float   # compute_s / step_time_s ("MFU-at-roofline")

    def to_json(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "model_flops": self.model_flops,
            "hlo_flops_per_device": self.hlo_flops_per_device,
            "useful_ratio": self.useful_ratio, "bound": self.bound,
            "step_time_s": self.step_time_s,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(cfg, shape) -> float:
    """6*N*D with D = processed tokens; decode processes B tokens/step."""
    n = cfg.param_count(active_only=cfg.family == "moe")
    d = shape.tokens
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * d


def roofline_from_cell(cell: dict, cfg, shape, hw: HardwareSpec,
                       chips: int) -> RooflineTerms:
    """``cell`` is one dry-run artifact (see launch/dryrun.py).

    Prefers the trip-count-aware ``hlo_cost`` record (scan bodies x trips);
    raw ``cost_analysis`` numbers (which count loop bodies once) are the
    fallback for artifacts produced before hlo_cost existed."""
    hc = cell.get("hlo_cost")
    if hc:
        flops_dev = float(hc["dot_flops"])
        bytes_dev = float(hc["bytes_accessed"])
        coll_dev = float(hc["total_collective_bytes"])
    else:
        flops_dev = float(cell["cost"].get("flops", 0.0))
        bytes_dev = float(cell["cost"].get("bytes accessed", 0.0))
        coll_dev = float(cell["collectives"]["total_bytes"])

    compute_s = flops_dev / hw.peak_bf16_flops
    memory_s = bytes_dev / hw.hbm_bandwidth
    collective_s = coll_dev / (hw.ici_links_per_chip * hw.ici_link_bandwidth)

    mf = model_flops(cfg, shape)
    total_hlo = flops_dev * chips
    useful = mf / total_hlo if total_hlo else 0.0

    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bound = max(terms, key=terms.get)
    step = max(terms.values()) or 1e-30
    return RooflineTerms(
        arch=cell["arch"], shape=cell["shape"], mesh=cell["mesh"],
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        model_flops=mf, hlo_flops_per_device=flops_dev, useful_ratio=useful,
        bound=bound, step_time_s=step,
        roofline_fraction=compute_s / step,
    )
