"""Weights made from the seed on the device, the same for both sides.

Each layer is one ``torch.randn`` call of all its matrices' entries from a
``torch.Generator`` on the device seeded by (seed, layer), in the type the
configuration serves in; the embedding and the head are a call each.  So
the plain reference can make any one layer again, alone and bit for bit,
without holding the others.  Matrices are scaled by one over the square
root of their fan-in; norm scales are ones.  The leaves are laid out as the
port's parameter tree names them.
"""
from __future__ import annotations

import math

import torch

from .spec import Shape

__all__ = ["layer_weights", "embed_weights", "head_weights",
           "final_norm_weights", "make_params", "named_initial",
           "stream_seed"]

_MASK = (1 << 63) - 1


def stream_seed(seed: int, stream: int) -> int:
    """A generator seed for ``stream`` of run ``seed`` (any whole number)."""
    return (int(seed) * 0x9E3779B97F4A7C15 + 1_000_003 * (stream + 1)) & _MASK


def _normals(n: int, seed: int, stream: int, dtype, device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return torch.randn(n, generator=g, dtype=dtype, device=device)


def _matrices(s: Shape) -> list[tuple[str, tuple, int]]:
    """(name, shape, fan-in) of a layer's matrices, in drawing order."""
    d, hd, nq, nkv, ff = s.d_model, s.head_dim, s.n_heads, s.n_kv_heads, \
        s.d_ff
    return [("wq", (d, nq, hd), d), ("wk", (d, nkv, hd), d),
            ("wv", (d, nkv, hd), d), ("wo", (nq, hd, d), nq * hd),
            ("w1", (d, ff), d), ("w3", (d, ff), d), ("w2", (ff, d), ff)]


def layer_weights(s: Shape, seed: int, layer: int, device,
                  dtype=torch.bfloat16) -> dict:
    """Layer ``layer``'s parameters as the port names them."""
    mats = _matrices(s)
    flat = _normals(sum(math.prod(shape) for _, shape, _ in mats), seed,
                    layer, dtype, device)
    out, at = {}, 0
    for name, shape, fan_in in mats:
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape).mul_(
            1.0 / math.sqrt(fan_in)).clone()
        at += n
    del flat
    ones = lambda n: torch.ones(n, dtype=dtype, device=device)  # noqa: E731
    out["ln1"], out["ln2"] = ones(s.d_model), ones(s.d_model)
    if s.qk_norm:
        out["q_norm"], out["k_norm"] = ones(s.head_dim), ones(s.head_dim)
    return out


def embed_weights(s: Shape, seed: int, device,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """The embedding (vocab, d): unit normals."""
    return _normals(s.vocab * s.d_model, seed, s.n_layers, dtype,
                    device).view(s.vocab, s.d_model)


def head_weights(s: Shape, seed: int, device,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """The output head (d, vocab), scaled by one over sqrt(d)."""
    return _normals(s.vocab * s.d_model, seed, s.n_layers + 1, dtype,
                    device).view(s.d_model, s.vocab).mul_(
                        1.0 / math.sqrt(s.d_model))


def final_norm_weights(s: Shape, seed: int, device,
                       dtype=torch.bfloat16) -> torch.Tensor:
    """The final norm's scale (d,): ones, as every norm scale here."""
    return torch.ones(s.d_model, dtype=dtype, device=device)


def make_params(s: Shape, seed: int, device,
                dtype=torch.bfloat16) -> dict:
    """The whole parameter tree in the port's layout."""
    return {"embed": embed_weights(s, seed, device, dtype),
            "head": head_weights(s, seed, device, dtype),
            "final_norm": final_norm_weights(s, seed, device, dtype),
            "layers": [layer_weights(s, seed, i, device, dtype)
                       for i in range(s.n_layers)]}


def named_initial(s: Shape, seed: int, device,
                  dtype=torch.bfloat16) -> dict:
    """The parameters by name (``embed``, ``head``, ``final_norm``,
    ``layers.<i>.<name>``), as made from the seed."""
    out = {"embed": embed_weights(s, seed, device, dtype),
           "head": head_weights(s, seed, device, dtype),
           "final_norm": final_norm_weights(s, seed, device, dtype)}
    for i in range(s.n_layers):
        out.update({f"layers.{i}.{n}": t for n, t in
                    layer_weights(s, seed, i, device, dtype).items()})
    return out
