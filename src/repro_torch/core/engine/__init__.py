"""Batched, schedulable probe engine (discovery fast path).

Decomposes MT4G-style discovery into a declarative probe registry, a
dependency-aware concurrent scheduler, a keyed sample cache, batched
runner calls, the adaptive sweep planner, cross-family fusion, the
content-addressed topology store and the worker-process pool
(``engine.parallel``, imported on use).  See ``engine.run_probes`` for the
entry point and ``discover.discover`` for the entry point that assembles a
``Topology`` from it.
"""
from .cache import CachingRunner, SampleCache
from .engine import DEVICE_KEY, EngineResult, run_probes
from .fusion import FusionDispatcher, run_fused
from .planner import SweepBudget
from .registry import (DEVICE_FAMILIES, SPACE_FAMILIES, ProbeContext,
                       ProbeSpec, device_probe_specs, space_probe_specs)
from .scheduler import ScheduleResult, WorkItem, run_work_items
from .store import (GcPolicy, StoredTopology, StoreLock, TopologyStore,
                    request_key)

__all__ = [
    "CachingRunner", "SampleCache",
    "DEVICE_KEY", "EngineResult", "run_probes",
    "FusionDispatcher", "run_fused", "SweepBudget",
    "DEVICE_FAMILIES", "SPACE_FAMILIES", "ProbeContext", "ProbeSpec",
    "device_probe_specs", "space_probe_specs",
    "ScheduleResult", "WorkItem", "run_work_items",
    "GcPolicy", "StoredTopology", "StoreLock", "TopologyStore",
    "request_key",
]
