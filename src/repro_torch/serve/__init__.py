"""Serving layer of the port: the token-serving engine.  The topology query
service, the HTTP front end and the job engine are not ported yet."""
from .engine import Engine, ServeConfig

__all__ = ["Engine", "ServeConfig"]
