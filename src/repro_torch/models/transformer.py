"""Decoder-only transformer for the dense family (qwen3, codeqwen1.5,
internlm2), the moe family (qwen3-moe), the audio family (musicgen: the sum
of K codebook embeddings in, K heads out) and the vlm family (paligemma: a
projected patch prefix, the prefix-LM mask, the sqrt(d) embedding scale and
soft-capped logits): GQA with optional qk_norm, RoPE, a SwiGLU or
mixture-of-experts FFN (``models.moe``), a KV cache.

The port of ``repro.models.transformer``.  Layers are a Python loop over
per-layer parameter dictionaries where the reference scans a stacked axis.
Activations are pinned by ``sharding.constrain`` at the reference's places
(block boundaries, logits), which does nothing outside an
``activation_sharding`` context.

* Serving: prefill attention, causal from position 0 (prefix-LM over the
  patches for vlm), goes through the flash-attention kernel
  (``kernels.ops.mha``); decode attention over the cache is plain PyTorch
  and causal, as the reference leaves it outside any kernel.
* Training: ``forward`` and ``train_loss`` take the reference's own path,
  the plain ``common.attention`` (query-chunked past ``Runtime.q_chunk``),
  never a kernel: the kernels have no backward and refuse inputs that
  require grad.  ``Runtime.remat`` recomputes each layer in the backward.
* Every entry point takes a ``Runtime``, as the reference's: with
  ``moe_impl="ep"`` under a mesh (``sharding.context.current_mesh()``)
  the moe FFN is expert-parallel (``models.moe_ep``), else the sorted
  dispatch (``models.moe``).

Batches take the reference's layouts (``Model.input_specs``): ``tokens``
(B, T) for dense, moe and vlm, (B, K, T) for audio, and for vlm also
``patches`` (B, n_patches, vision_embed_dim); a decode step takes (B, 1),
or (B, K, 1) for audio; ``targets`` are shaped as ``tokens`` (vlm: the
text's alone).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from ..kernels import ops
from ..sharding.context import (constrain, current_mesh, is_sharded,
                                on_local_shards, replicate_like)
from .common import (DTYPES, Initializer, apply_rope, attention,
                     cross_entropy, remat_layer, rms_norm, rope_angles,
                     swiglu)
from .moe import init_moe, load_balance_loss, moe_ffn
from .moe_ep import moe_ffn_ep, save_a2a_contexts

__all__ = ["Runtime", "init", "forward", "train_loss", "prefill",
           "decode_step", "init_cache", "cache_specs"]


@dataclass(frozen=True)
class Runtime:
    """Execution knobs of the entry points.

    ``q_chunk``: training's attention takes the queries a chunk at a time
    once T >= 2 * q_chunk (0: never).  ``remat``: ``"none"`` keeps every
    layer's activations for the backward pass; ``"full"`` recomputes each
    layer there; ``"save_a2a"`` recomputes each layer but keeps the
    outputs of the expert-parallel moe's forward all-to-alls
    (``moe_ep.save_a2a_contexts``), so the backward exchanges only the
    gradients.  ``moe_impl``: ``"gspmd"`` is the sorted dispatch
    (``models/moe.py``); ``"ep"`` is expert parallelism with explicit
    all-to-alls (``models/moe_ep.py``) under a mesh
    (``sharding.context.current_mesh()``), and the sorted dispatch with
    none, as in the reference."""

    q_chunk: int = 1024          # query-chunked attention threshold
    remat: str = "none"          # none | full | save_a2a
    moe_aux_weight: float = 0.01
    moe_impl: str = "gspmd"      # gspmd (sorted dispatch) | ep

    def __post_init__(self):
        if self.moe_impl not in ("gspmd", "ep"):
            raise ValueError(f"moe_impl={self.moe_impl!r}: expected 'gspmd' "
                             f"(models/moe.py) or 'ep' (models/moe_ep.py)")
        if self.remat not in ("none", "full", "save_a2a"):
            raise ValueError(f"remat={self.remat!r}: expected 'none', "
                             f"'full' or 'save_a2a'")


# ------------------------------------------------------------------- init
def init_layer(ini: Initializer, cfg) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    p = {"ln1": ini.ones(d, axes=("embed",)),
         "wq": ini.normal(d, nq, hd, axes=("embed", "heads", "head_dim")),
         "wk": ini.normal(d, nkv, hd,
                          axes=("embed", "kv_heads", "head_dim")),
         "wv": ini.normal(d, nkv, hd,
                          axes=("embed", "kv_heads", "head_dim")),
         "wo": ini.normal(nq, hd, d, axes=("heads", "head_dim", "embed"))}
    if cfg.qk_norm:
        p["q_norm"] = ini.ones(hd, axes=("head_dim",))
        p["k_norm"] = ini.ones(hd, axes=("head_dim",))
    p["ln2"] = ini.ones(d, axes=("embed",))
    if cfg.family == "moe":
        p["moe"] = init_moe(ini, cfg)
    else:
        p["w1"] = ini.normal(d, cfg.d_ff, axes=("embed", "ff"))
        p["w3"] = ini.normal(d, cfg.d_ff, axes=("embed", "ff"))
        p["w2"] = ini.normal(cfg.d_ff, d, axes=("ff", "embed"))
    return p


def init(cfg, ini: Initializer) -> dict:
    """Parameters drawn by ``ini`` (or their shapes or logical axes), with
    the reference's names, shapes and axes."""
    d, v = cfg.d_model, cfg.vocab_size
    if cfg.family == "audio":
        params = {"embed": ini.normal(cfg.n_codebooks, v, d,
                                      axes=("codebooks", "vocab", "embed")),
                  "head": ini.normal(cfg.n_codebooks, d, v,
                                     axes=("codebooks", "embed", "vocab"))}
    else:
        params = {"embed": ini.normal(v, d, axes=("vocab", "embed"))}
        if not cfg.tie_embeddings:
            params["head"] = ini.normal(d, v, axes=("embed", "vocab"))
    if cfg.family == "vlm":
        params["vis_proj"] = ini.normal(cfg.vision_embed_dim, d,
                                        axes=("vision", "embed"))
    params["final_norm"] = ini.ones(d, axes=("embed",))
    params["layers"] = [init_layer(ini, cfg) for _ in range(cfg.n_layers)]
    return params


# ------------------------------------------------------------------ layers
def _qkv(cfg, p, x, pos):
    """Normed, projected and rotated q, k, v of x (B, T, d) at ``pos``."""
    b, t, d = x.shape
    hd = cfg.resolved_head_dim
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q = (h @ p["wq"].reshape(d, -1)).view(b, t, cfg.n_heads, hd)
    k = (h @ p["wk"].reshape(d, -1)).view(b, t, cfg.n_kv_heads, hd)
    v = (h @ p["wv"].reshape(d, -1)).view(b, t, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = rope_angles(pos, hd, cfg.rope_theta)
    return (apply_rope(q, cos[None], sin[None]),
            apply_rope(k, cos[None], sin[None]), v)


def _out_proj(p, out, x):
    b, t = out.shape[:2]
    return (out.reshape(b, t, -1) @ p["wo"].reshape(-1, x.shape[-1])
            ).to(x.dtype)


def _ffn(cfg, p, x, rt: Runtime):
    """x plus the FFN of its norm -> (out, the moe router's probabilities
    (T, E), or None for a SwiGLU FFN); the moe FFN is expert-parallel
    under a mesh when ``rt.moe_impl`` is ``"ep"``."""
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        mesh = current_mesh()
        if rt.moe_impl == "ep" and mesh is not None:
            y, probs = moe_ffn_ep(p["moe"], h, cfg, mesh)
        else:
            y, probs = moe_ffn(p["moe"], h, cfg)
        return x + y, probs
    return x + swiglu(h, p["w1"], p["w3"], p["w2"]), None


def block(cfg, p, x, attend, rt: Runtime = Runtime()):
    """One layer over a whole sequence from position 0; ``attend(q, k, v)``
    is its attention: the kernel's wrapper when serving, the plain
    evaluator when training.  Returns (out, router probabilities or None,
    k, v)."""
    x = constrain(x, ("batch", "seq", "embed_act"))
    pos = torch.arange(x.shape[1], device=x.device)
    q, k, v = _qkv(cfg, p, x, pos)
    out, probs = _ffn(cfg, p, x + _out_proj(p, attend(q, k, v), x), rt)
    return constrain(out, ("batch", "seq", "embed_act")), probs, k, v


def plain_attend(prefix_len: int, q_chunk: int):
    """Training's ``attend``: the plain attention, causal with the first
    ``prefix_len`` positions attending to each other both ways (0: none)."""
    return functools.partial(attention, causal=True,
                             prefix_len=prefix_len or None, q_chunk=q_chunk)


def kernel_attend(prefix_len: int = 0):
    """Serving's ``attend``: the flash-attention kernel, with the same
    mask."""
    return functools.partial(ops.mha, causal=True, prefix_len=prefix_len)


def decode_attend(q, ck, cv, cur_len: int):
    """A step's queries q (B, Tq, Hq, hd) over the cache's first
    ``cur_len + Tq`` positions (B, Smax, Hkv, hd), causal, in the cache's
    dtype; DTensors on each rank's shards of batch and heads."""
    if is_sharded(q):
        return on_local_shards(functools.partial(decode_attend,
                                                 cur_len=cur_len),
                               [q, ck, cv], [(0, 2)] * 3, [(0, 2)])
    bsz, tq, hq, hd = q.shape
    hkv = ck.shape[2]
    qg = q.reshape(bsz, tq, hkv, hq // hkv, hd)
    scores = torch.einsum("btkgh,bskh->bkgts", qg, ck).float()
    scores = scores / math.sqrt(hd)
    valid = torch.arange(ck.shape[1], device=q.device) <= cur_len
    scores = scores.masked_fill(~valid, -1e30)
    probs = torch.softmax(scores, dim=-1).to(cv.dtype)
    out = torch.einsum("bkgts,bskh->btkgh", probs, cv)
    return out.reshape(bsz, tq, hq, hd)


def block_decode(cfg, p, x, ck, cv, cur_len: int, rt: Runtime = Runtime()):
    """One layer, one token; writes its k and v into the cache in place."""
    x = constrain(x, ("batch", "seq", "embed_act"))
    tq = x.shape[1]
    pos = torch.arange(cur_len, cur_len + tq, device=x.device)
    q, k, v = _qkv(cfg, p, x, pos)
    ck[:, cur_len:cur_len + tq] = k.to(ck.dtype)
    cv[:, cur_len:cur_len + tq] = v.to(cv.dtype)
    out = decode_attend(q, ck, cv, cur_len).to(x.dtype)
    return constrain(_ffn(cfg, p, x + _out_proj(p, out, x), rt)[0],
                     ("batch", "seq", "embed_act"))


def _scaled(cfg, x):
    """x times sqrt(d) rounded to x's dtype, where the config scales."""
    if cfg.embed_scale:
        x = x * torch.tensor(float(cfg.d_model)).sqrt().to(x.dtype)
    return x


def _embed(cfg, params, tokens):
    """Token ids -> embeddings: (B, T) ids, or audio's (B, K, T) codebook
    ids summed over the K codebooks in the reference's order and dtype
    (``((e0 + e1) + e2) + ...``, no scale)."""
    if cfg.family == "audio":
        return sum(params["embed"][kb][tokens[:, kb]]
                   for kb in range(cfg.n_codebooks))
    return _scaled(cfg, params["embed"][tokens])


def _embed_prompt(cfg, params, batch):
    """A prefill batch -> (embeddings, prefix length): vlm's projected
    patches ahead of its text, scaled together after the join, with the
    patches as the prefix; 0 for the other families."""
    if cfg.family != "vlm":
        return _embed(cfg, params, batch["tokens"]), 0
    proj = params["vis_proj"]
    img = batch["patches"].to(proj.dtype) @ proj
    txt = params["embed"][batch["tokens"]]
    return _scaled(cfg, torch.cat([img, txt], dim=1)), cfg.n_patches


def _logits(cfg, params, x):
    if cfg.family == "audio":
        out = torch.einsum("btd,kdv->btkv", x, params["head"])
    elif cfg.tie_embeddings:
        out = x @ params["embed"].T
    else:
        out = x @ params["head"]
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        out = torch.tanh(out.float() / c) * c
    if cfg.family == "audio":
        return constrain(out, ("batch", "seq", "codebooks", "vocab"))
    return constrain(out, ("batch", "seq", "vocab"))


# -------------------------------------------------------------- entry pts
def _run_layers(cfg, layers, x, prefix_len: int, rt: Runtime):
    """Every layer over the sequence, each recomputed in the backward pass
    unless ``rt.remat`` is ``"none"`` (``"save_a2a"`` keeps the moe's
    exchanged activations); returns (x, router probabilities stacked
    (L, T, E) for moe, else zeros (L, 1, 1) as the reference's)."""
    layer = remat_layer(functools.partial(
        block, cfg, attend=plain_attend(prefix_len, rt.q_chunk), rt=rt),
        rt.remat != "none",
        save_a2a_contexts if rt.remat == "save_a2a" else None)
    probs = []
    for p in layers:
        x, pr = layer(p, x)[:2]
        probs.append(pr if pr is not None
                     else x.new_zeros((1, 1), dtype=torch.float32))
    return x, torch.stack(probs)


def forward(cfg, params, batch, rt: Runtime = Runtime()):
    """Full-sequence forward -> (logits (B, T, V), or (B, T, K, V) for
    audio; router probabilities): vlm's logits are its text positions'."""
    x, prefix_len = _embed_prompt(cfg, params, batch)
    x = constrain(x, ("batch", "seq", "embed_act"))
    x, probs = _run_layers(cfg, params["layers"], x, prefix_len, rt)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.family == "vlm":
        x = x[:, cfg.n_patches:]            # loss only on text positions
    return _logits(cfg, params, x), probs


def train_loss(cfg, params, batch, rt: Runtime = Runtime()):
    """Mean next-token cross entropy against ``batch["targets"]`` (audio's
    (B, K, T)), plus ``rt.moe_aux_weight`` times the load-balance loss of
    every layer's routing for moe."""
    logits, probs = forward(cfg, params, batch, rt)
    if cfg.family == "audio":
        loss = cross_entropy(logits.transpose(1, 2), batch["targets"])
    else:
        loss = cross_entropy(logits, batch["targets"])
    if cfg.family == "moe":
        # over (L, T, E) as it is: the reference flattens it first, which
        # a DTensor split over tokens cannot take (a strided shard)
        aux = load_balance_loss(probs, None, cfg)
        loss = loss + rt.moe_aux_weight * aux
    return loss


def init_cache(cfg, batch_size: int, max_len: int, dtype=None,
               device="cuda") -> dict:
    dtype = dtype or DTYPES[cfg.dtype]
    shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": 0}


def cache_specs(cfg) -> dict:
    """Logical axes of the cache (the reference's names; no sharding here)."""
    kv = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    return {"k": kv, "v": kv, "len": ()}


def prefill(cfg, params, batch, max_len: int, rt: Runtime = Runtime()):
    """Run the prompt, fill a KV cache, return (last-token logits, cache):
    logits (B, V), or (B, K, V) for audio; vlm's cache holds its patches'
    positions ahead of the text's."""
    x, prefix_len = _embed_prompt(cfg, params, batch)
    x = constrain(x, ("batch", "seq", "embed_act"))
    bsz, seq = x.shape[:2]
    if seq > max_len:
        raise ValueError(f"prompt of {seq} positions exceeds max_len "
                         f"{max_len}")
    cache = cache_like(init_cache(cfg, bsz, max_len, dtype=x.dtype,
                                   device=x.device), x)
    attend = kernel_attend(prefix_len)
    for layer, p in enumerate(params["layers"]):
        x, _, k, v = block(cfg, p, x, attend, rt)
        cache["k"][layer, :, :seq] = k
        cache["v"][layer, :, :seq] = v
    cache["len"] = seq
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params, x[:, -1:])[:, 0], cache


def cache_like(cache: dict, x) -> dict:
    """A new cache on x's device; on x's mesh, replicated, when x is a
    DTensor (a decode step writes one position of it in place, which a
    sequence-sharded layout could not take locally)."""
    return {name: t if name == "len" else replicate_like(t, x)
            for name, t in cache.items()}


def decode_step(cfg, params, batch, cache, rt: Runtime = Runtime()):
    """One-token step against a filled KV cache: tokens (B, 1), or (B, K, 1)
    for audio.  Writes the new k and v into ``cache`` in place (no copy of
    the whole cache per step) and returns (logits, cache)."""
    cur = cache["len"]
    if cur >= cache["k"].shape[2]:
        raise ValueError(f"cache full: {cur} positions of "
                         f"{cache['k'].shape[2]}")
    x = _embed(cfg, params, batch["tokens"])          # (B, 1, d)
    for layer, p in enumerate(params["layers"]):
        x = block_decode(cfg, p, x, cache["k"][layer], cache["v"][layer],
                         cur, rt)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    cache["len"] = cur + 1
    return _logits(cfg, params, x)[:, 0], cache
