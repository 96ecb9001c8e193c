"""Model zoo of the port: the dense transformer and rwkv6 families."""
from .model import Model, Runtime, get_model

__all__ = ["Model", "Runtime", "get_model"]
