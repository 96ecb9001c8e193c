"""Public wrappers around the hand-written kernels.

Each wrapper checks device, dtype, shape and contiguity, then runs the
hand-written kernel for a CUDA tensor and the kernel's plain PyTorch
version for a CPU tensor (the tests' path); there is no fallback between
the two.  Each carries a plain integer ``launches`` count, one per call,
which shows that a run went through the wrapper; ``reset_launches`` zeroes
them all.  The kernels have no backward: ``mha`` and ``wkv6`` refuse an
input that requires grad while grad mode is on (on the CPU too, which runs
what the card runs), since the card's output would carry no gradient;
training takes the reference's plain path instead.  ``mha`` and ``wkv6``
also take DTensors (a model served on a mesh): the kernel runs on each
rank's local shards where only the batch and head dimensions are sharded,
and the inputs are redistributed to that layout first otherwise
(``sharding.context.on_local_shards``); the call counts once.
``WRAPPERS`` are the four probe wrappers discovery runs;
``LLM_WRAPPERS`` are the model kernels' (``mha``, ``wkv6``) and the
single-chain chase (``pchase``), which no discovery path calls.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from .flash_attention import (BLOCK, BY_HEAD_DIM, BY_PREFIX, LAUNCHES,
                              MAX_HEAD_DIM, SOURCES, flash_attention_kernel,
                              flash_attention_plain, instantiation)
from .pchase_probe import (eviction_batch_plain, eviction_kernel_batch,
                           pchase_batch_plain, pchase_kernel,
                           pchase_kernel_batch, pchase_plain)
from .rwkv6_scan import (CHUNK, HEAD_SIZES, head_size, pad_wkv, wkv6_kernel,
                         wkv6_plain)
from .stream_probe import (stream_read_kernel, stream_read_plain,
                           stream_write_kernel, stream_write_plain)
from ..sharding.context import is_sharded, on_local_shards

__all__ = ["pchase_batch", "eviction_batch", "stream_read", "stream_write",
           "mha", "wkv6", "pchase", "WRAPPERS", "LLM_WRAPPERS",
           "reset_launches"]

_INT_MAX = 2**31 - 1


def _check(name: str, t, dtype, ndim: int, device: torch.device) -> None:
    """``dtype`` is one torch.dtype or a tuple of those allowed."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)!r}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if any(s > _INT_MAX for s in t.shape):
        raise ValueError(f"{name}: dimension beyond int32 range")


def _counted(fn):
    """Give ``fn`` a ``launches`` count, raised by one per completed call."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        wrapper.launches += 1
        return out

    wrapper.launches = 0
    return wrapper


def _refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise when grad mode is on and an input requires grad: the kernel
    writes its output through ``ctypes``, so a loss through it would lose
    the gradient of every input silently."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and the kernel has no backward "
            f"(its output would carry no gradient); call it under "
            f"torch.no_grad(), or train through the plain path the model's "
            f"forward takes (models.common.attention, "
            f"models.rwkv6.wkv_chunked)")


def _route(device: torch.device, kernel, plain, meta: bool = False):
    """The kernel on the card; the plain version on the CPU and, where
    ``meta`` (the model kernels, whose shapes the dry run traces:
    ``launch/dryrun.py``), on the ``meta`` device."""
    if device.type == "cuda":
        return kernel
    if device.type == "cpu" or (meta and device.type == "meta"):
        return plain
    raise ValueError(f"no kernel for device type {device.type!r}")


@_counted
def pchase_batch(perms: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """Grid-batched p-chase: (R, N) int32 zero-padded single-cycle rows +
    (R,) int32 per-row chain lengths -> (R, 2) int32 ``[cursor, checksum]``
    rows, in one launch."""
    _check("perms", perms, torch.int32, 2, perms.device)
    _check("steps", steps, torch.int32, 1, perms.device)
    if steps.shape[0] != perms.shape[0]:
        raise ValueError("steps must have one entry per perms row")
    fn = _route(perms.device, pchase_kernel_batch, pchase_batch_plain)
    return fn(perms, steps)


@_counted
def eviction_batch(perms: torch.Tensor, evictors: torch.Tensor,
                   warm: torch.Tensor, probe: torch.Tensor) -> torch.Tensor:
    """Grid-batched eviction probe (Fig. 3 warm-B / probe-A): (R, N) probe
    rows, (R, M) evictor rows, (R,) warm and probe chain lengths -> (R, 2)
    int32 rows, in one launch."""
    dev = perms.device
    _check("perms", perms, torch.int32, 2, dev)
    _check("evictors", evictors, torch.int32, 2, dev)
    _check("warm", warm, torch.int32, 1, dev)
    _check("probe", probe, torch.int32, 1, dev)
    rows = perms.shape[0]
    if not (evictors.shape[0] == warm.shape[0] == probe.shape[0] == rows):
        raise ValueError("perms, evictors, warm and probe need equal rows")
    fn = _route(dev, eviction_kernel_batch, eviction_batch_plain)
    return fn(perms, evictors, warm, probe)


def _check_stream(x, block: int) -> None:
    """The stream probes' contract: x (N,) float32 in whole ``block``s, as
    the reference asserts."""
    _check("x", x, torch.float32, 1, x.device)
    if block <= 0 or x.shape[0] % block:
        raise ValueError(f"length {x.shape[0]} is not a multiple of block "
                         f"{block}")


@_counted
def stream_read(x: torch.Tensor, *, block: int = 64 * 1024) -> torch.Tensor:
    """x (N,) float32 -> per-block float32 sums (N // block,)."""
    _check_stream(x, block)
    fn = _route(x.device, stream_read_kernel, stream_read_plain)
    return fn(x, block)


@_counted
def stream_write(x: torch.Tensor, *, block: int = 64 * 1024) -> torch.Tensor:
    """x (N,) float32 -> x + 1, in whole ``block``s as the reference's tile
    copy takes them (the kernel's own slices are finer)."""
    _check_stream(x, block)
    fn = _route(x.device, stream_write_kernel, stream_write_plain)
    return fn(x)


def _pad_seq(x: torch.Tensor, length: int, value: float = 0.0):
    """Pad dim 1 of a (B, S, ...) tensor with ``value`` up to ``length``."""
    extra = length - x.shape[1]
    if extra == 0:
        return x
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, extra), value=value)


@_counted
def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, prefix_len: int = 0) -> torch.Tensor:
    """Flash attention over model-layout activations: q (B, Sq, Hq, d),
    k and v (B, Sk, Hkv, d), float32 or bfloat16, any head dim d >= 1 ->
    (B, Sq, Hq, d) in q's dtype; ``flash_attention.kernel_for`` names the
    kernel of each dtype and d.

    ``prefix_len`` P (0 <= P <= Sq; 0 for none) makes the causal mask
    prefix-LM's: rows and keys both below P also attend to each other, as
    the reference's ``attention(causal=True, prefix_len=P)`` computes it.
    A P > 0 is refused without ``causal`` (the reference's mask ignores it
    there) and past head dim 256, whose wide kernels take no prefix (on
    the CPU too, which runs what the card runs).

    The kernel takes sequence lengths in multiples of ``BLOCK``.  A ragged
    causal call with Sq <= Sk is padded at the tail and the padded rows
    dropped: every padded key lies at or after Sk >= Sq >= P, so it is never
    in the prefix, and the causal mask hides it from every real query; the
    result is exact.  A ragged non-causal call would attend to the padding,
    so it raises.

    DTensor inputs run on their local shards
    (``sharding.context.on_local_shards``): batch and heads as they are
    sharded, where the heads of q, k and v split alike, and everything
    else replicated first.
    """
    if any(is_sharded(t) for t in (q, k, v)):
        return on_local_shards(
            functools.partial(_mha, causal=causal, prefix_len=prefix_len),
            [q, k, v], [(0, 2)] * 3, [(0, 2)])
    return _mha(q, k, v, causal=causal, prefix_len=prefix_len)


def _mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool = True, prefix_len: int = 0) -> torch.Tensor:
    """``mha`` on plain tensors."""
    dev = q.device
    _check("q", q, (torch.float32, torch.bfloat16), 4, dev)
    _check("k", k, q.dtype, 4, dev)
    _check("v", v, q.dtype, 4, dev)
    _refuse_grad("mha", q, k, v)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if v.shape != k.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"{hq} query heads are not a multiple of {hkv} kv "
                         f"heads")
    if d < 1:
        raise ValueError(f"head dim {d}: expected at least 1")
    prefix = int(prefix_len)
    if prefix and not causal:
        raise ValueError(f"prefix_len={prefix} needs causal=True: the "
                         f"prefix-LM mask is the causal one widened")
    if not 0 <= prefix <= sq:
        raise ValueError(f"prefix_len={prefix} outside [0, Sq={sq}]")
    ragged = sq % BLOCK or sk % BLOCK
    if ragged and not (causal and sq <= sk):
        raise ValueError(f"lengths {sq}, {sk} are not multiples of {BLOCK}; "
                         f"only causal attention with Sq <= Sk is padded")
    if prefix and instantiation(q.dtype, d) > 256:
        raise NotImplementedError(
            f"prefix_len at head dim {d} (instantiation "
            f"{instantiation(q.dtype, d)}): the wide kernels past 256 "
            f"(flash_fwd_sm90_wide_kernel in {SOURCES['sm90']}, "
            f"flash_fwd_wide_kernel in {SOURCES['cuda_core']}) take no "
            f"prefix; up to {MAX_HEAD_DIM} they take causal and full only")
    fn = _route(dev, flash_attention_kernel, flash_attention_plain,
                meta=True)
    if not ragged:
        return fn(q, k, v, causal, prefix)
    pq, pk = -(-sq // BLOCK) * BLOCK, -(-sk // BLOCK) * BLOCK
    out = fn(_pad_seq(q, pq), _pad_seq(k, pk), _pad_seq(v, pk), causal,
             prefix)
    return out[:, :sq]


@_counted
def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, *,
         chunk: int = 32) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV6 from a zero state over model-layout float32 activations:
    r, k, w (B, T, H, K), v (B, T, H, V), u (H, K), any K and V ->
    (y (B, T, H, V), state (B, H, K, V)), both float32.

    Past K or V 128 (the kernels' largest head size) the call is split
    above the route: each of the state's K rows evolves alone and each V
    column of y and of the state is independent, while y sums over K.  So
    K and V are cut into slices of at most 128, each (K slice, V slice)
    runs as its own call below, y is summed over the K slices and the state
    concatenated.  This counts as one call.

    The kernels take K = V in ``HEAD_SIZES`` and T in whole chunks of their
    own ``CHUNK``, which they run whatever ``chunk`` says: the chunked form
    computes the same function at every chunk.  ``pad_wkv`` pads K, V and
    a ragged tail for them with terms that add exactly zero, and the
    padding is sliced off the result.  The plain version on the CPU takes
    any K and V and ``chunk`` as it is; only a ragged tail is padded for
    it, the same way.  There is no incoming state: the kernel starts from
    zero, as prefill does.

    DTensor inputs run on their local shards
    (``sharding.context.on_local_shards``): batch and heads as they are
    sharded (u's heads with them), everything else replicated first.
    """
    if any(is_sharded(t) for t in (r, k, v, w, u)):
        return on_local_shards(functools.partial(_wkv6, chunk=chunk),
                               [r, k, v, w, u], [(0, 2)] * 4 + [(None, 0)],
                               [(0, 2), (0, 1)])
    return _wkv6(r, k, v, w, u, chunk=chunk)


def _wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
          u: torch.Tensor, *,
          chunk: int = 32) -> tuple[torch.Tensor, torch.Tensor]:
    """``wkv6`` on plain tensors."""
    dev = r.device
    _check("r", r, torch.float32, 4, dev)
    for name, t in (("k", k), ("w", w), ("v", v)):
        _check(name, t, torch.float32, 4, dev)
    _check("u", u, torch.float32, 2, dev)
    _refuse_grad("wkv6", r, k, v, w, u)
    b, t, h, kd = r.shape
    vd = v.shape[-1]
    if k.shape != r.shape or w.shape != r.shape or v.shape[:3] != (b, t, h) \
            or tuple(u.shape) != (h, kd):
        raise ValueError(f"shapes r {tuple(r.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, w {tuple(w.shape)}, "
                         f"u {tuple(u.shape)} do not match")
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    widest = HEAD_SIZES[-1]
    if kd <= widest and vd <= widest:
        return _wkv6_slice(r, k, v, w, u, chunk)
    y, states = None, []
    for k0 in range(0, kd, widest):
        ks = slice(k0, k0 + widest)
        rk, kk, wk = (x[..., ks].contiguous() for x in (r, k, w))
        uk = u[:, ks].contiguous()
        parts = [_wkv6_slice(rk, kk, v[..., v0:v0 + widest].contiguous(), wk,
                             uk, chunk) for v0 in range(0, vd, widest)]
        yk = torch.cat([part[0] for part in parts], dim=-1)
        y = yk if y is None else y + yk
        states.append(torch.cat([part[1] for part in parts], dim=-1))
    return y, torch.cat(states, dim=2)


def _wkv6_slice(r, k, v, w, u,
                chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``wkv6`` at K and V up to 128 on validated inputs: the kernels or,
    on the CPU, the plain version."""
    b, t, h, kd = r.shape
    vd = v.shape[-1]
    size = head_size(kd, vd)
    fn = _route(r.device, wkv6_kernel, wkv6_plain, meta=True)
    if fn is wkv6_plain:
        tp = -(-t // chunk) * chunk
        y, state = fn(_pad_seq(r, tp), _pad_seq(k, tp), _pad_seq(v, tp),
                      _pad_seq(w, tp, 1.0), u, chunk)
        return y[:, :t], state
    y, state = fn(*pad_wkv(r, k, v, w, u, size, CHUNK), CHUNK)
    if y.shape[1] != t or size != vd:
        y = y[:, :t, :, :vd]
    if size != kd or size != vd:
        state = state[:, :, :kd, :vd]
    return y, state


@_counted
def pchase(perm: torch.Tensor, *, iters: int) -> torch.Tensor:
    """Single-chain p-chase: perm (N,) int32 single-cycle permutation ->
    (2,) int32 ``[final_cursor, checksum]`` after ``iters`` loads."""
    _check("perm", perm, torch.int32, 1, perm.device)
    if not 0 <= iters <= _INT_MAX:
        raise ValueError(f"iters {iters} outside [0, 2**31)")
    fn = _route(perm.device, pchase_kernel, pchase_plain)
    return fn(perm, iters)


WRAPPERS = (pchase_batch, eviction_batch, stream_read, stream_write)
LLM_WRAPPERS = (mha, wkv6, pchase)


def reset_launches() -> None:
    """Zero every wrapper's ``launches`` count and the attention kernels'
    own counts (``flash_attention.LAUNCHES``, ``BY_HEAD_DIM`` and
    ``BY_PREFIX``)."""
    for fn in WRAPPERS + LLM_WRAPPERS:
        fn.launches = 0
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    for counts in (*BY_HEAD_DIM.values(), *BY_PREFIX.values()):
        counts.clear()
