"""Unified model API + registry.

``get_model(cfg)`` returns a ``Model`` facade over the family's backend:
``dense``, ``moe``, ``audio`` and ``vlm`` -> ``transformer``, ``ssm`` ->
``rwkv6``, ``hybrid`` -> ``zamba2``.  Parameters are plain dictionaries of
tensors passed explicitly to every entry point; batches take the layouts
of the reference's ``Model.input_specs`` (audio's (B, K, T) codebook ids,
vlm's ``patches`` beside its ``tokens``).  ``param_specs`` and
``input_specs`` belong to the sharding and dry-run slice and are not here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from . import rwkv6, transformer, zamba2
from .transformer import Runtime

__all__ = ["Model", "Runtime", "get_model"]

_BACKENDS = {
    "dense": transformer, "moe": transformer, "audio": transformer,
    "vlm": transformer,
    "ssm": rwkv6,
    "hybrid": zamba2,
}


@dataclass(frozen=True)
class Model:
    cfg: Any
    backend: Any

    def init(self, seed: int = 0, device: str = "cuda") -> dict:
        """Parameters drawn from a ``torch.Generator`` seeded with ``seed``
        on ``device``; the card unless the caller asks for the CPU."""
        if torch.device(device).type == "cuda" and \
                not torch.cuda.is_available():
            raise RuntimeError(f"Model.init: device={device!r} but no CUDA "
                               f"device is available (pass device='cpu' "
                               f"for the CPU)")
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        return self.backend.init(self.cfg, generator)

    def train_loss(self, params, batch, rt: Runtime = Runtime()):
        return self.backend.train_loss(self.cfg, params, batch, rt)

    def forward(self, params, batch, rt: Runtime = Runtime()):
        return self.backend.forward(self.cfg, params, batch, rt)

    def prefill(self, params, batch, max_len: int):
        return self.backend.prefill(self.cfg, params, batch, max_len)

    def decode_step(self, params, batch, cache):
        return self.backend.decode_step(self.cfg, params, batch, cache)

    def init_cache(self, batch_size: int, max_len: int,
                   device: str = "cuda") -> dict:
        return self.backend.init_cache(self.cfg, batch_size, max_len,
                                       device=device)

    def cache_specs(self) -> dict:
        return self.backend.cache_specs(self.cfg)


def get_model(cfg) -> Model:
    try:
        backend = _BACKENDS[cfg.family]
    except KeyError as e:
        raise KeyError(f"no backend for family '{cfg.family}'") from e
    return Model(cfg, backend)
