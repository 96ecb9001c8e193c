"""Stream bandwidth probe kernels (paper §IV-I) for NVIDIA Hopper.

Replace the Pallas kernels of the reference package
(``repro/kernels/stream_probe.py``), both in CUDA C++
(``csrc/stream_probe.cu``, whose note gives their design):

* ``stream_read_kernel``  — f32 sum of each ``block`` of ``x`` (bytes in,
  ~0 out): each block is cut into slices of ``READ_SLICE`` elements, one
  CTA each, so a 2 MiB read spans every SM; the last CTA of a block sums
  the block's partials in a fixed order, so a call is one launch and its
  result is the same from run to run.
* ``stream_write_kernel`` — ``y = x + 1`` in float32 (bytes in == bytes
  out): slices of ``WRITE_SLICE`` elements, one CTA each, 16-byte loads
  and stores.

What bounds them: bytes.  Each element is read once (and, for the write,
written once) with one add per element, far below the card's arithmetic
rate, so the least time is the bytes moved over the memory rate.  At the
probe's own size (2 MiB) the data sits in the 50 MB L2 and a launch lasts
microseconds, so the wall time of a call is mostly the host's launch path:
that is what the probe reports, not HBM bandwidth.  So the two share one
short path: the C entry points are bound once, the stream is taken as a
raw handle, a call makes one allocation (its output; the read's partial
sums and block counters are scratch kept per stream), and the checks are
``ops``'s alone.

The CUDA library is built when a kernel is first launched, never at
import, so the module imports where there is no compiler.  The plain
PyTorch versions sit beside the kernels.
"""
import torch

from ._build import check_launch, load_library

__all__ = ["stream_read_kernel", "stream_write_kernel", "stream_read_plain",
           "stream_write_plain", "READ_SLICE", "WRITE_SLICE"]

READ_SLICE = 2048       # kSlice of csrc/stream_probe.cu: elements per CTA
WRITE_SLICE = 2048      # kWriteSlice of csrc/stream_probe.cu

_entry = None           # (stream_read_fwd, stream_write_fwd), bound once

# Per (device index, stream): the read's scratch, the partial sums and the
# zeroed block counters (which the kernel leaves zeroed), grown when a call
# needs more.  Launches on one stream run in order, so they never share
# scratch at the same time.
_scratch: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _entry_points():
    global _entry
    if _entry is None:
        lib, _ = load_library()
        _entry = (lib.stream_read_fwd, lib.stream_write_fwd)
    return _entry


def _raise_if_failed(name: str, err: int) -> None:
    if err:
        check_launch(load_library()[0], name, err)


def _read_scratch(x: torch.Tensor, device: int, stream: int, partials: int,
                  blocks: int) -> tuple[torch.Tensor, torch.Tensor]:
    scratch = _scratch.get((device, stream))
    if (scratch is None or scratch[0].numel() < partials
            or scratch[1].numel() < blocks):
        scratch = (x.new_empty(max(partials, 1 << 15)),
                   torch.zeros(max(blocks, 1024), dtype=torch.int32,
                               device=x.device))
        _scratch[(device, stream)] = scratch
    return scratch


def stream_read_kernel(x: torch.Tensor, block: int) -> torch.Tensor:
    """x (N,) -> per-block f32 sums (N // block,); N % block == 0.  One
    launch on the current stream."""
    read, _ = _entry_points()
    n = x.shape[0]
    blocks = n // block
    device = x.get_device()
    stream = torch._C._cuda_getCurrentRawStream(device)
    partial, counters = _read_scratch(x, device, stream,
                                      blocks * -(-block // READ_SLICE), blocks)
    sums = x.new_empty(blocks)
    _raise_if_failed("stream_read_fwd", read(
        x.data_ptr(), sums.data_ptr(), partial.data_ptr(),
        counters.data_ptr(), n, block, stream))
    return sums


def stream_write_kernel(x: torch.Tensor) -> torch.Tensor:
    """x (N,) float32 -> x + 1.  One launch on the current stream."""
    _, write = _entry_points()
    y = torch.empty_like(x)
    _raise_if_failed("stream_write_fwd", write(
        x.data_ptr(), y.data_ptr(), x.shape[0],
        torch._C._cuda_getCurrentRawStream(x.get_device())))
    return y


def stream_read_plain(x: torch.Tensor, block: int) -> torch.Tensor:
    """Plain version of ``stream_read_kernel``."""
    return x.view(-1, block).sum(1, dtype=torch.float32)


def stream_write_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``stream_write_kernel``."""
    return x + 1
