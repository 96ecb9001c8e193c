"""Stream bandwidth probe kernels (paper §IV-I) for NVIDIA Hopper.

Replace the Pallas kernels of the reference package
(``repro/kernels/stream_probe.py``):

* ``stream_read_kernel``  — f32 sum of each ``block`` of ``x`` (bytes in,
  ~0 out), in CUDA C++ (``csrc/stream_probe.cu``, whose note gives its
  design): each block is cut into slices of ``READ_SLICE`` elements, one CTA
  each, so a 2 MiB read spans every SM; the last CTA of a block sums the
  block's partials in a fixed order, so a call is one launch and its result
  is the same from run to run.
* ``stream_write_kernel`` — ``y = x + 1`` in x's dtype (bytes in == bytes
  out), in Triton: a 1-D grid of masked tiles.

What bounds them: bytes.  Each element is read once (and, for the write,
written once) with one add per element, far below the card's arithmetic
rate, so the least time is the bytes moved over the memory rate.  Both keep
every load wide and contiguous and add nothing to the bytes.  At the
probe's own size (2 MiB) the data sits in the 50 MB L2 and a launch lasts
microseconds, so the wall time of a call is mostly launch overhead: that is
what the probe reports, not HBM bandwidth.

The CUDA library is built and ``triton`` imported when a kernel is first
launched, never at import, so the module imports where there is neither.
The plain PyTorch versions sit beside the kernels.
"""
import functools

import torch

from ._build import check_launch, load_library

__all__ = ["stream_read_kernel", "stream_write_kernel", "stream_read_plain",
           "stream_write_plain", "READ_SLICE", "WRITE_TILE"]

READ_SLICE = 2048       # kSlice of csrc/stream_probe.cu: elements per CTA
WRITE_TILE = 4096       # elements per program of the write grid

tl = None               # triton.language, bound by _write_kernel()

# Per (device, stream): zeroed block counters of the read kernel, which
# leaves them zeroed; grown when a call has more blocks.  Launches on one
# stream run in order, so they never share counters at the same time.
_counters: dict[tuple[torch.device, int], torch.Tensor] = {}


@functools.cache
def _write_kernel():
    """Compile-on-first-use Triton write kernel."""
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def write_kernel(x_ptr, y_ptr, n, TILE: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid.to(tl.int64) * TILE + tl.arange(0, TILE)
        mask = offs < n
        x = tl.load(x_ptr + offs, mask=mask)
        tl.store(y_ptr + offs, x + 1, mask=mask)

    return write_kernel


def _block_counters(device: torch.device, stream: int,
                    blocks: int) -> torch.Tensor:
    counters = _counters.get((device, stream))
    if counters is None or counters.numel() < blocks:
        counters = torch.zeros(max(blocks, 1024), dtype=torch.int32,
                               device=device)
        _counters[(device, stream)] = counters
    return counters


def stream_read_kernel(x: torch.Tensor, block: int) -> torch.Tensor:
    """x (N,) -> per-block f32 sums (N // block,); N % block == 0.  One
    launch on the current stream."""
    lib, _ = load_library()
    n = x.shape[0]
    blocks = n // block
    # one allocation: the block sums, then each slice's partial sum
    buf = torch.empty(blocks * (1 + -(-block // READ_SLICE)),
                      dtype=torch.float32, device=x.device)
    sums = buf.data_ptr()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    check_launch(lib, "stream_read_fwd", lib.stream_read_fwd(
        x.data_ptr(), sums, sums + 4 * blocks,
        _block_counters(x.device, stream, blocks).data_ptr(), n, block,
        stream))
    return buf[:blocks]


def stream_write_kernel(x: torch.Tensor) -> torch.Tensor:
    """x (N,) -> x + 1 in x's dtype."""
    write_kernel = _write_kernel()
    y = torch.empty_like(x)
    n = x.shape[0]
    write_kernel[((n + WRITE_TILE - 1) // WRITE_TILE,)](x, y, n,
                                                        TILE=WRITE_TILE,
                                                        num_warps=8)
    return y


def stream_read_plain(x: torch.Tensor, block: int) -> torch.Tensor:
    """Plain version of ``stream_read_kernel``."""
    return x.view(-1, block).sum(1, dtype=torch.float32)


def stream_write_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``stream_write_kernel``."""
    return x + 1
