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

_FAMILIES = ("dense", "moe", "audio", "vlm", "ssm", "hybrid")


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes: no numpy kind
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _tree(tree, device, pick=lambda a: a):
    """A nested dictionary of arrays -> the same of tensors, each leaf
    passed through ``pick`` first."""
    if isinstance(tree, dict):
        return {name: _tree(sub, device, pick) for name, sub in tree.items()}
    return _tensor(pick(tree), device)


def _leaves(tree, prefix: str = "layers"):
    if isinstance(tree, dict):
        for name, sub in tree.items():
            yield from _leaves(sub, f"{prefix}/{name}")
    else:
        yield prefix, tree


def params_from_numpy(cfg, tree: dict, device: str = "cuda") -> dict:
    """The reference's parameter tree as numpy arrays, with layers stacked
    on a leading axis under ``"layers"`` -> the port's parameters (one
    dictionary per layer, nested dictionaries such as a layer's ``moe`` or
    zamba2's ``shared`` kept nested), on ``device``, dtypes kept; the
    top-level arrays (audio's (K, V, d) ``embed`` and (K, d, V) ``head``,
    vlm's ``vis_proj``) cross as they are."""
    if cfg.family not in _FAMILIES:
        raise ValueError(f"family {cfg.family!r}: not one of {_FAMILIES}")
    params = {name: _tree(sub, device) for name, sub in tree.items()
              if name != "layers"}
    layers = tree["layers"]
    for name, a in _leaves(layers):
        if np.shape(a)[0] != cfg.n_layers:
            raise ValueError(f"{name}: leading axis {np.shape(a)[0]}, "
                             f"expected {cfg.n_layers} layers")
    params["layers"] = [_tree(layers, device, lambda a, i=i: a[i])
                        for i in range(cfg.n_layers)]
    return params
