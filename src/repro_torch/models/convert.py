"""Cross parameters between the reference's layout and the port's.

The two packages draw different random numbers, so a test that holds the
port to the reference initialises the reference, turns its parameter
pytree into numpy arrays and hands them to ``params_from_numpy``; both then
compute on the same weights.  ``params_to_numpy`` is its inverse: the
port's parameters (or gradients, or optimizer moments, which share their
layout) back in the reference's, so trees of the two packages compare leaf
by leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from ..sharding.context import full

__all__ = ["params_from_numpy", "params_to_numpy"]

_FAMILIES = ("dense", "moe", "audio", "vlm", "ssm", "hybrid")


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)                          # a copy: the port may write
    if a.dtype.name == "bfloat16":           # ml_dtypes: no numpy kind
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


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


def _array(t: torch.Tensor) -> np.ndarray:
    """A tensor (a DTensor's whole value) -> a numpy array of its own;
    bfloat16 bit for bit as ``ml_dtypes.bfloat16`` (the reference's numpy
    bfloat16), imported only for such a leaf."""
    t = full(t.detach()).cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().copy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {name: _numpy_tree(sub) for name, sub in tree.items()}
    return _array(tree)


def _stacked(trees: list):
    """Equal-structured dictionaries of arrays -> one dictionary of the
    arrays stacked on a new leading axis."""
    if isinstance(trees[0], dict):
        return {name: _stacked([t[name] for t in trees]) for name in trees[0]}
    return np.stack(trees)


def params_to_numpy(cfg, params: dict) -> dict:
    """The inverse of ``params_from_numpy``: the port's parameters (one
    dictionary per layer) -> the reference's tree of numpy arrays, each
    layer leaf stacked on a leading ``n_layers`` axis under ``"layers"``,
    the rest as it is; dtypes kept (bfloat16 bit for bit)."""
    if cfg.family not in _FAMILIES:
        raise ValueError(f"family {cfg.family!r}: not one of {_FAMILIES}")
    layers = params["layers"]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers, expected {cfg.n_layers}")
    tree = {name: _numpy_tree(sub) for name, sub in params.items()
            if name != "layers"}
    tree["layers"] = _stacked([_numpy_tree(p) for p in layers])
    return tree
