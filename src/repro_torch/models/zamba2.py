"""Zamba2 hybrid: a Mamba2 backbone and one *shared* attention block
(zamba2-2.7b: 54 mamba2 layers, the shared block applied every 6).

The port of ``repro.models.zamba2`` for serving.  The shared transformer
block has one set of attention and MLP weights; each of its sites
concatenates the hidden state with the token embeddings ([h; emb], 2d) and
maps it through the site's own projector (``site_proj``, stacked
(sites, 2d, d)).  The block is the dense transformer's layer
(``transformer.block``/``block_decode``) on that projection.  As
in the reference, the site's whole block output, its own residual over
the projection included, is added to the residual stream.  KV caches exist
only at the sites.

Layers are a Python loop of ``sites`` outer by ``shared_attn_every`` inner
iterations over per-layer dictionaries, where the reference scans a
stacked axis.  Prefill attention, causal from position 0, goes through the
flash-attention kernel (``kernels.ops.mha``); decode attention over the
cache and the Mamba2 mixer are plain PyTorch, as in the reference.
Training's ``forward`` runs the shared block on the plain attention
(``transformer.block`` with ``plain_attend``), as the reference does, and
recomputes each Mamba2 layer (not the shared block) in the backward pass
unless ``remat`` is ``"none"``.
"""
from __future__ import annotations

import torch

from ..sharding.context import constrain
from .common import DTYPES, Initializer, cross_entropy, remat_layer, rms_norm
from .mamba2 import dims, init_mamba2, mamba2_seq, mamba2_step
from .transformer import (block, block_decode, cache_like, init_layer,
                          kernel_attend, plain_attend)

__all__ = ["init", "forward", "train_loss", "prefill", "decode_step",
           "init_cache", "cache_specs", "n_sites"]


def n_sites(cfg) -> int:
    """Applications of the shared block: one every ``shared_attn_every``
    layers."""
    every = cfg.shared_attn_every
    if cfg.n_layers % every:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                         f"shared_attn_every {every}")
    return cfg.n_layers // every


def init(cfg, ini: Initializer) -> dict:
    """Parameters drawn by ``ini`` (or their shapes or logical axes): the
    shared block is a dense transformer layer; ``site_proj`` (sites, 2d,
    d) takes its fan-in from the sites axis, as the reference's does."""
    d = cfg.d_model
    return {"embed": ini.normal(cfg.vocab_size, d, axes=("vocab", "embed")),
            "head": ini.normal(d, cfg.vocab_size, axes=("embed", "vocab")),
            "final_norm": ini.ones(d, axes=("embed",)),
            "shared": init_layer(ini, cfg),
            "site_proj": ini.normal(n_sites(cfg), 2 * d, d,
                                    axes=("sites", "embed2", "embed")),
            "layers": [init_mamba2(ini, cfg) for _ in range(cfg.n_layers)]}


def _site_input(params, site: int, h, emb):
    """The shared block's input at ``site``: [h; emb] through the site's
    projector."""
    return torch.cat([h, emb], dim=-1) @ params["site_proj"][site]


# -------------------------------------------------------------- entry pts
def _mamba_layer(p, h, cfg):
    """h plus one Mamba2 layer over the whole sequence from a zero state."""
    return constrain(h + mamba2_seq(p, h, cfg)[0],
                     ("batch", "seq", "embed_act"))


def forward(cfg, params, batch, rt=None):
    """Full-sequence forward -> (logits (B, T, V), None)."""
    remat = (getattr(rt, "remat", "none") != "none") if rt else False
    q_chunk = getattr(rt, "q_chunk", 1024) if rt else 1024
    layer = remat_layer(_mamba_layer, remat)
    attend = plain_attend(0, q_chunk)
    h = emb = constrain(params["embed"][batch["tokens"]],
                        ("batch", "seq", "embed_act"))
    every = cfg.shared_attn_every
    for site in range(n_sites(cfg)):
        h = constrain(h, ("batch", "seq", "embed_act"))
        h = h + block(cfg, params["shared"],
                      _site_input(params, site, h, emb), attend)[0]
        for p in params["layers"][site * every:(site + 1) * every]:
            h = layer(p, h, cfg)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return constrain(h @ params["head"], ("batch", "seq", "vocab")), None


def train_loss(cfg, params, batch, rt=None):
    logits, _ = forward(cfg, params, batch, rt)
    return cross_entropy(logits, batch["targets"])


def init_cache(cfg, batch_size: int, max_len: int, dtype=None,
               device="cuda") -> dict:
    dtype = dtype or DTYPES[cfg.dtype]
    d_in, h, pp, n = dims(cfg)
    kv = (n_sites(cfg), batch_size, max_len, cfg.n_kv_heads,
          cfg.resolved_head_dim)
    return {
        "kv_k": torch.zeros(kv, dtype=dtype, device=device),
        "kv_v": torch.zeros(kv, dtype=dtype, device=device),
        "ssm": torch.zeros((cfg.n_layers, batch_size, h, pp, n),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((cfg.n_layers, batch_size,
                             cfg.ssm_conv_width - 1, d_in + 2 * n),
                            dtype=dtype, device=device),
        "len": 0,
    }


def cache_specs(cfg) -> dict:
    """Logical axes of the cache (the reference's names; no sharding here)."""
    kv = ("sites", "batch", "kv_seq", "kv_heads", "head_dim")
    return {"kv_k": kv, "kv_v": kv,
            "ssm": ("layers", "batch", "state_heads", "head_dim", "state"),
            "conv": ("layers", "batch", "conv", "inner"),
            "len": ()}


def prefill(cfg, params, batch, max_len: int, rt=None):
    """Run the prompt, fill the caches, return (last-token logits,
    cache).  ``rt`` is unused, as in the reference."""
    tokens = batch["tokens"]
    bsz, seq = tokens.shape
    if seq > max_len:
        raise ValueError(f"prompt of {seq} tokens exceeds max_len {max_len}")
    h = emb = params["embed"][tokens]
    cache = cache_like(init_cache(cfg, bsz, max_len, dtype=h.dtype,
                                   device=h.device), h)
    every = cfg.shared_attn_every
    attend = kernel_attend()
    for site in range(n_sites(cfg)):
        shared_out, _, k, v = block(cfg, params["shared"],
                                    _site_input(params, site, h, emb), attend)
        cache["kv_k"][site, :, :seq] = k
        cache["kv_v"][site, :, :seq] = v
        h = h + shared_out
        for layer in range(site * every, (site + 1) * every):
            y, ssm, conv = mamba2_seq(params["layers"][layer], h, cfg)
            cache["ssm"][layer] = ssm
            cache["conv"][layer] = conv
            h = h + y
    cache["len"] = seq
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return h[:, -1] @ params["head"], cache


def decode_step(cfg, params, batch, cache, rt=None):
    """One-token step (``rt`` unused, as in the reference).  Updates
    ``cache`` in place and returns (logits, cache)."""
    cur = cache["len"]
    if cur >= cache["kv_k"].shape[2]:
        raise ValueError(f"cache full: {cur} positions of "
                         f"{cache['kv_k'].shape[2]}")
    h = emb = params["embed"][batch["tokens"]][:, 0]        # (B, d)
    every = cfg.shared_attn_every
    for site in range(n_sites(cfg)):
        h2 = block_decode(cfg, params["shared"],
                          _site_input(params, site, h[:, None], emb[:, None]),
                          cache["kv_k"][site], cache["kv_v"][site], cur)
        h = h + h2[:, 0]
        for layer in range(site * every, (site + 1) * every):
            y, ssm, conv = mamba2_step(params["layers"][layer], h, cfg,
                                       cache["ssm"][layer],
                                       cache["conv"][layer])
            cache["ssm"][layer] = ssm
            cache["conv"][layer] = conv
            h = h + y
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    cache["len"] = cur + 1
    return h @ params["head"], cache
