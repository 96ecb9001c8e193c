"""Deterministic data pipelines of the port (``repro.data``'s)."""
from .pipeline import ByteCorpus, DataConfig, SyntheticLM

__all__ = ["ByteCorpus", "DataConfig", "SyntheticLM"]
