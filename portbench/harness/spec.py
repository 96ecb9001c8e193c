"""A cell's data: ``BENCHMARK.json``'s entries and the files they name.

A configuration file keeps the published ``config.json``'s key names
(``num_hidden_layers``, ``hidden_size``, ...); ``Shape`` is the part of it
the harness, the operation counts and the plain reference read, and
``port_config`` turns it into the port's ``ModelConfig``.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path

from .env import BENCH, ROOT

__all__ = ["Cell", "Shape", "load_cell", "port_config"]


@dataclass(frozen=True)
class Shape:
    """A dense decoder's sizes and numerics, as its configuration states."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    qk_norm: bool
    rope_theta: float
    norm_eps: float
    dtype: str

    @classmethod
    def from_config(cls, name: str, c: dict) -> "Shape":
        if c.get("tie_word_embeddings"):
            raise ValueError(f"{name}: tied embeddings are not a dense "
                             f"decoder this harness builds")
        return cls(name=name, n_layers=c["num_hidden_layers"],
                   d_model=c["hidden_size"],
                   n_heads=c["num_attention_heads"],
                   n_kv_heads=c["num_key_value_heads"],
                   head_dim=c.get("head_dim") or
                   c["hidden_size"] // c["num_attention_heads"],
                   d_ff=c["intermediate_size"], vocab=c["vocab_size"],
                   qk_norm=bool(c.get("qk_norm", False)),
                   rope_theta=float(c["rope_theta"]),
                   norm_eps=float(c["rms_norm_eps"]),
                   dtype=c["torch_dtype"])

    def replace(self, **kw) -> "Shape":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    shape: Shape
    traffic: dict
    limits: dict
    end_to_end: list          # the cell's end-to-end metric entries
    per_layer: list           # the cell's per-layer metric entries


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _mine(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def load_cell(workload: str, bench: dict | None = None) -> Cell:
    """The cell named ``workload``, from ``BENCHMARK.json`` at the root of
    the checkout unless ``bench`` is given."""
    bench = bench if bench is not None else _read(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: "
                       f"{sorted(cells)}")
    w = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[w["config"]]
    shape = Shape.from_config(config["name"], _read(ROOT / config["file"]))
    return Cell(name=workload, chips=int(w["chips"]), shape=shape,
                traffic=_read(BENCH / "traffic" / f"{w['traffic']}.json"),
                limits=_read(BENCH / "limits" / f"{workload}.json"),
                end_to_end=[m for m in bench["end_to_end"]
                            if _mine(m, workload)],
                per_layer=[m for m in bench["per_layer"]
                           if _mine(m, workload)])


def port_config(shape: Shape):
    """The port's ``ModelConfig`` for ``shape`` (a dense decoder)."""
    from repro_torch.configs.base import ModelConfig

    return ModelConfig(name=shape.name, family="dense",
                       n_layers=shape.n_layers, d_model=shape.d_model,
                       n_heads=shape.n_heads, n_kv_heads=shape.n_kv_heads,
                       head_dim=shape.head_dim, d_ff=shape.d_ff,
                       vocab_size=shape.vocab, qk_norm=shape.qk_norm,
                       rope_theta=shape.rope_theta, norm_eps=shape.norm_eps,
                       dtype=shape.dtype)
