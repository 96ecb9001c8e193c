"""Fault tolerance of the port (``repro.ft``'s)."""
from .supervisor import (FailureInjector, RestartExhausted, StragglerDetector,
                         Supervisor)

__all__ = ["FailureInjector", "RestartExhausted", "StragglerDetector",
           "Supervisor"]
