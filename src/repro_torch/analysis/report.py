"""Roofline report generation from dry-run artifacts (EXPERIMENTS.md §Roofline).

The port of ``repro.analysis.report``: it reads either package's
artifacts (``<art_dir>/<mesh>/<arch>__<shape>.json``)."""
from __future__ import annotations

import glob
import json
import os

from ..configs import get_config, shape_for
from ..core.catalog import TPU_V5E, HardwareSpec
from .roofline import RooflineTerms, roofline_from_cell

__all__ = ["load_cells", "roofline_table", "markdown_table"]


def load_cells(art_dir: str = "artifacts/dryrun", mesh: str = "single"):
    cells = []
    for f in sorted(glob.glob(os.path.join(art_dir, mesh, "*.json"))):
        d = json.load(open(f))
        if d.get("ok") and "cost" in d:
            cells.append(d)
    return cells


def roofline_table(art_dir: str = "artifacts/dryrun", mesh: str = "single",
                   hw: HardwareSpec = TPU_V5E) -> list[RooflineTerms]:
    out = []
    for cell in load_cells(art_dir, mesh):
        cfg = get_config(cell["arch"])
        shape = shape_for(cell["shape"])
        out.append(roofline_from_cell(cell, cfg, shape, hw,
                                      chips=cell["devices"]))
    return out


def _advice(t: RooflineTerms) -> str:
    if t.bound == "collective":
        return "cut collective bytes (sharding/overlap/compression)"
    if t.bound == "memory":
        if t.shape.startswith("decode") or t.shape.startswith("long"):
            return "decode is cache-read bound: shrink KV bytes (quant/GQA)"
        return "reduce HBM traffic (fusion/remat policy/dtype)"
    return "compute-bound: raise MFU via larger per-chip tiles"


def markdown_table(terms: list[RooflineTerms]) -> str:
    lines = [
        "| arch | shape | compute_s | memory_s | collective_s | bound | "
        "MODEL_FLOPS | useful | roofline_frac | next lever |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for t in sorted(terms, key=lambda t: (t.arch, t.shape)):
        lines.append(
            f"| {t.arch} | {t.shape} | {t.compute_s:.3e} | {t.memory_s:.3e} "
            f"| {t.collective_s:.3e} | **{t.bound}** | {t.model_flops:.2e} "
            f"| {t.useful_ratio:.2f} | {t.roofline_fraction:.2%} "
            f"| {_advice(t)} |")
    return "\n".join(lines)


if __name__ == "__main__":
    terms = roofline_table()
    print(markdown_table(terms))
    print()
    worst = sorted(terms, key=lambda t: t.roofline_fraction)[:5]
    print("worst roofline fractions:")
    for t in worst:
        print(f"  {t.arch}/{t.shape}: {t.roofline_fraction:.2%} ({t.bound})")
    coll = sorted(terms, key=lambda t: -(t.collective_s / t.step_time_s))[:5]
    print("most collective-bound:")
    for t in coll:
        print(f"  {t.arch}/{t.shape}: coll {t.collective_s:.3e}s vs step "
              f"{t.step_time_s:.3e}s")
