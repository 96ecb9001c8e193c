"""Gradient compression with error feedback for data-parallel training.

The port of ``repro.train.grad_compress``.  int8 (or int16) quantization
with a per-tensor max-abs scale cuts a gradient's bytes on the wire by 2x
against bf16 and 4x against float32; the quantization error is carried
into the next step's gradient (error feedback).  ``compressed_psum`` is
the all-reduce of such a gradient over a ``torch.distributed`` process
group, or over a single rank when no group is given.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["quantize", "dequantize", "compress_with_feedback",
           "compressed_psum"]

_INT = {8: torch.int8, 16: torch.int16}


def _qmax(bits: int) -> float:
    if bits not in _INT:
        raise ValueError(f"bits must be 8 or 16, got {bits}")
    return float(2 ** (bits - 1) - 1)


def quantize(x: torch.Tensor, bits: int = 8):
    """Symmetric per-tensor quantization -> (q int8/int16, scale float32)."""
    qmax = _qmax(bits)
    xf = x.float()
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / qmax
    q = torch.clamp(torch.round(xf / scale), -qmax, qmax)
    return q.to(_INT[bits]), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_with_feedback(grad: torch.Tensor, error: torch.Tensor,
                           bits: int = 8):
    """Quantize (grad + carried error) -> (q, scale, new error)."""
    target = grad.float() + error
    q, scale = quantize(target, bits)
    return q, scale, target - dequantize(q, scale)


def compressed_psum(grad: torch.Tensor, error: torch.Tensor, group=None,
                    bits: int = 8):
    """All-reduce a gradient in int8/16 -> (the mean-reduced float32
    gradient, the new error-feedback buffer).  The ranks agree on one
    scale (``all_reduce(MAX)`` of their max |g|, so the integer sum cannot
    overflow), then sum their integers in int32 (``all_reduce(SUM)``).
    ``group=None`` is a single rank: no collective runs."""
    qmax = _qmax(bits)
    target = grad.float() + error
    peak = torch.clamp(torch.max(torch.abs(target)), min=1e-12)
    n = 1
    if group is not None:
        n = dist.get_world_size(group)
        dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=group)
    scale = peak / qmax
    q = torch.clamp(torch.round(target / scale), -qmax, qmax)
    new_error = target - q * scale
    q_sum = q.to(torch.int32)
    if group is not None:
        dist.all_reduce(q_sum, op=dist.ReduceOp.SUM, group=group)
    return q_sum.float() * scale / n, new_error
