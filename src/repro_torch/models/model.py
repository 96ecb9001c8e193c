"""Unified model API + registry.

``get_model(cfg)`` returns a ``Model`` facade over the family's backend:
``dense``, ``moe``, ``audio`` and ``vlm`` -> ``transformer``, ``ssm`` ->
``rwkv6``, ``hybrid`` -> ``zamba2``.  Parameters are plain dictionaries of
tensors passed explicitly to every entry point; batches take the layouts
of the reference's ``Model.input_specs`` (audio's (B, K, T) codebook ids,
vlm's ``patches`` beside its ``tokens``).  ``param_specs`` gives each
parameter's logical axes (the tree of ``init`` with tuples of axis names at
its leaves; a layer's leaves carry no leading ``"layers"`` entry, since the
port's layers are a list), and ``param_shapes``, ``input_specs`` and
``cache_input_specs`` give tensors on the ``meta`` device: shapes and
dtypes with no storage, as the reference's ``ShapeDtypeStruct`` stand-ins.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from . import rwkv6, transformer, zamba2
from .common import DTYPES, AxesInitializer, Initializer, ShapeInitializer
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
        return self.backend.init(self.cfg,
                                 Initializer(generator, DTYPES[self.cfg.dtype]))

    def param_specs(self) -> dict:
        """The logical-axis tree of the parameters, allocating nothing."""
        return self.backend.init(self.cfg, AxesInitializer())

    def param_shapes(self) -> dict:
        """The parameters as ``meta`` tensors (no storage, no draw)."""
        return self.backend.init(self.cfg,
                                 ShapeInitializer(DTYPES[self.cfg.dtype]))

    def train_loss(self, params, batch, rt: Runtime = Runtime()):
        return self.backend.train_loss(self.cfg, params, batch, rt)

    def forward(self, params, batch, rt: Runtime = Runtime()):
        return self.backend.forward(self.cfg, params, batch, rt)

    def prefill(self, params, batch, max_len: int, rt: Runtime = Runtime()):
        return self.backend.prefill(self.cfg, params, batch, max_len, rt=rt)

    def decode_step(self, params, batch, cache, rt: Runtime = Runtime()):
        return self.backend.decode_step(self.cfg, params, batch, cache,
                                        rt=rt)

    def init_cache(self, batch_size: int, max_len: int,
                   device: str = "cuda") -> dict:
        return self.backend.init_cache(self.cfg, batch_size, max_len,
                                       device=device)

    def cache_specs(self) -> dict:
        return self.backend.cache_specs(self.cfg)

    # ------------------------------------------------------- shape specs
    def input_specs(self, shape) -> dict:
        """``meta`` tensors for the batch of ``shape`` (``configs.SHAPES``)."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len

        def sds(dims, dtype=torch.int32):
            return torch.empty(dims, dtype=dtype, device="meta")

        if cfg.family == "audio":
            k = cfg.n_codebooks
            if shape.kind == "decode":
                return {"tokens": sds((b, k, 1))}
            d = {"tokens": sds((b, k, s))}
            if shape.kind == "train":
                d["targets"] = sds((b, k, s))
            return d
        if cfg.family == "vlm":
            p, vd = cfg.n_patches, cfg.vision_embed_dim
            text = s - p
            if text <= 0:
                raise ValueError("vlm sequence must exceed the patch prefix")
            if shape.kind == "decode":
                return {"tokens": sds((b, 1))}
            d = {"patches": sds((b, p, vd), DTYPES[cfg.dtype]),
                 "tokens": sds((b, text))}
            if shape.kind == "train":
                d["targets"] = sds((b, text))
            return d
        if shape.kind == "decode":
            return {"tokens": sds((b, 1))}
        d = {"tokens": sds((b, s))}
        if shape.kind == "train":
            d["targets"] = sds((b, s))
        return d

    def cache_input_specs(self, shape) -> dict:
        """``meta`` tensors for a filled cache at ``shape`` (decode only);
        ``len`` is a 0-d int32, as the reference's."""
        cache = self.init_cache(shape.global_batch, shape.seq_len,
                                device="meta")
        cache["len"] = torch.empty((), dtype=torch.int32, device="meta")
        return cache


def get_model(cfg) -> Model:
    try:
        backend = _BACKENDS[cfg.family]
    except KeyError as e:
        raise KeyError(f"no backend for family '{cfg.family}'") from e
    return Model(cfg, backend)
