"""Operations and bytes from shapes alone, and the chip's published peaks.

Counts are what the algorithm needs, whatever a kernel does beyond it: a
matrix product of (m, k) by (k, n) is 2 m k n operations, causal attention
over T positions takes T (T + 1) / 2 query-key pairs, each 4 x head_dim
operations (the scores and the weighted values), and a tensor is read or
written once.
"""
from __future__ import annotations

from .spec import Shape

__all__ = ["PEAKS", "nonembed_params", "prefill_flops", "decode_flops",
           "train_flops", "attention_ops", "attention_bytes",
           "roofline_seconds"]

# One NVIDIA H100 SXM (data sheet; dense, no sparsity; 700 W).
PEAKS = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}


def nonembed_params(s: Shape) -> int:
    """Every layer's matrices (norm scales left out); not the embedding or
    the head."""
    attn = s.d_model * s.head_dim * (2 * s.n_heads + 2 * s.n_kv_heads)
    return s.n_layers * (attn + 3 * s.d_model * s.d_ff)


def _pairs_causal(t: int) -> int:
    return t * (t + 1) // 2


def attention_ops(s: Shape, batch: int, seq: int) -> int:
    """Causal self-attention of one layer over ``seq`` positions."""
    return 4 * batch * s.n_heads * s.head_dim * _pairs_causal(seq)


def attention_bytes(s: Shape, batch: int, seq: int, elem: int = 2) -> int:
    """q, k and v read once and the output written once, one layer."""
    return elem * batch * seq * s.head_dim * (2 * s.n_heads
                                              + 2 * s.n_kv_heads)


def prefill_flops(s: Shape, batch: int, seq: int) -> int:
    """A prefill of ``batch`` prompts of ``seq``: the layers' matrices on
    every position, causal attention, and the head on the last position."""
    return (2 * nonembed_params(s) * batch * seq
            + s.n_layers * attention_ops(s, batch, seq)
            + 2 * batch * s.d_model * s.vocab)


def decode_flops(s: Shape, batch: int, valid: int) -> int:
    """One decode step of ``batch`` sequences, each attending to ``valid``
    positions (the cache's filled ones and its own)."""
    return (2 * nonembed_params(s) * batch
            + s.n_layers * 4 * batch * s.n_heads * s.head_dim * valid
            + 2 * batch * s.d_model * s.vocab)


def train_flops(s: Shape, batch: int, seq: int) -> int:
    """Model operations of one training step: three times the forward's
    (forward, and the backward's two products), recomputation not
    counted."""
    fwd = (2 * nonembed_params(s) * batch * seq
           + s.n_layers * attention_ops(s, batch, seq)
           + 2 * batch * seq * s.d_model * s.vocab)
    return 3 * fwd


def roofline_seconds(ops: float, nbytes: float) -> tuple[float, str]:
    """The least time the chip could take, and which peak bounds it."""
    t_ops = ops / PEAKS["bf16_flops"]
    t_bytes = nbytes / PEAKS["hbm_bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
