"""Serving layer of the port: topology query service, HTTP front end +
client, the remote-discovery job engine (``"sim"`` and ``"cuda"``
backends), and the token-serving engine."""
from .client import TopologyClient, TopologyHTTPError
from .engine import Engine, ServeConfig
from .http import HttpError, ServerMetrics, TopologyHTTPServer
from .jobs import (Job, JobEngine, QueueFullError, TransientRunnerError,
                   resolve_discovery)
from .topology_service import (AttrDelta, QueryResult, TopologyDiff,
                               TopologyService)

__all__ = ["Engine", "ServeConfig",
           "AttrDelta", "QueryResult", "TopologyDiff", "TopologyService",
           "HttpError", "ServerMetrics", "TopologyHTTPServer",
           "TopologyClient", "TopologyHTTPError",
           "Job", "JobEngine", "QueueFullError", "TransientRunnerError",
           "resolve_discovery"]
