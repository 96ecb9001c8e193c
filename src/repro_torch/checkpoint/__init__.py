"""Checkpointing of the port (``repro.checkpoint``'s file format)."""
from .checkpointer import Checkpointer

__all__ = ["Checkpointer"]
