"""What the per-layer metrics' readers (``portbench/metrics/<name>.py``)
share: a run's view and the reductions over its traced units of work.

A reader is a module with ``read(run) -> float | None``; it returns None
when the run holds nothing it reads (no trace, no unit of its kind), and
the harness then leaves the metric out of the line.
"""
from __future__ import annotations

from dataclasses import dataclass

from .work import PEAKS

__all__ = ["RunView", "units", "mfu_percent", "idle_percent"]


@dataclass
class RunView:
    """What a reader sees: the cell, its shape, the traced window (or
    None) and the window's result (``ServeResult`` or ``TrainResult``)."""

    cell: object
    shape: object
    trace: object
    result: object


def units(run: RunView, kind: str) -> list:
    """The traced units of work of one kind (``prefill``, ``decode``,
    ``train``) that ran something on the device."""
    if run.trace is None:
        return []
    return [p for p in run.trace.parts
            if p.info.get("kind") == kind and p.events]


def mfu_percent(run: RunView, kind: str, flops_of) -> float | None:
    """The units' operations (``flops_of(shape, part.info)``) over the time
    they held the device (first kernel's start to last kernel's end, each),
    as a share of the bf16 peak."""
    parts = units(run, kind)
    seconds = sum(p.span_s for p in parts)
    if not parts or seconds <= 0:
        return None
    flops = sum(flops_of(run.shape, p.info) for p in parts)
    return 100.0 * flops / seconds / PEAKS["bf16_flops"]


def idle_percent(run: RunView) -> float | None:
    """The share of the traced window in which no kernel, copy or set ran
    on the device."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
