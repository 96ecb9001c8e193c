"""Cross the reference's parameters over to the port.

The two packages draw different random numbers, so a test that holds the
port to the reference initialises the reference, turns its parameter
pytree into numpy arrays and hands them to ``params_from_numpy``; both then
compute on the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_numpy"]

_FAMILIES = ("dense", "ssm")


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes: no numpy kind
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(cfg, tree: dict, device: str = "cuda") -> dict:
    """The reference's parameter tree as numpy arrays, with layers stacked
    on a leading axis under ``"layers"`` -> the port's parameters (one
    dictionary per layer), on ``device``, dtypes kept."""
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r}: only "
                                  f"{_FAMILIES} are ported")
    params = {name: _tensor(a, device) for name, a in tree.items()
              if name != "layers"}
    layers = tree["layers"]
    for name, a in layers.items():
        if np.shape(a)[0] != cfg.n_layers:
            raise ValueError(f"layers/{name}: leading axis {np.shape(a)[0]}, "
                             f"expected {cfg.n_layers} layers")
    params["layers"] = [{name: _tensor(a[i], device)
                         for name, a in layers.items()}
                        for i in range(cfg.n_layers)]
    return params
