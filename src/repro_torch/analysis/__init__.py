"""Dry-run analysis of the port: the reference's HLO parsers, roofline and
report, and ``trace``, which counts a step's ops on each device's local
shards."""
from .hlo import CollectiveStats, parse_collectives
from .roofline import RooflineTerms, model_flops, roofline_from_cell
from .trace import StepTrace

__all__ = ["CollectiveStats", "parse_collectives", "RooflineTerms",
           "model_flops", "roofline_from_cell", "StepTrace"]
