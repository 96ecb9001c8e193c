"""RWKV6 "Finch": attention-free LM with data-dependent decay (rwkv6-3b).

The port of ``repro.models.rwkv6``: token shift, the LoRA-parameterised
decay w_t = exp(-exp(w0 + tanh(x W_a) W_b)), the bonus ``u``, squared-ReLU
channel mixing.  Layers are a Python loop over per-layer parameter
dictionaries.  Prefill runs the WKV recurrence from a zero state through
the WKV6 kernel (``kernels.ops.wkv6``, which pads a ragged prompt instead
of giving way to the sequential scan); a decode step runs ``wkv_scan`` over
its one token in plain PyTorch, as the reference does.  Training's
``forward`` takes the reference's plain path, ``wkv_chunked`` (or
``wkv_scan`` where the runtime's ``rwkv_chunked`` is false), never the
kernel, each layer recomputed in the backward pass unless ``remat`` is
``"none"``.

Two plain WKV evaluators with identical semantics:
  * ``wkv_scan``    — O(T) sequential recurrence (the decode path);
  * ``wkv_chunked`` — chunk-parallel form from any state (the math of the
                      kernel; falls back to the scan when T % chunk != 0,
                      as the reference's does).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.rwkv6_scan import chunked_scan
from ..sharding.context import constrain
from .common import DTYPES, Initializer, cross_entropy, remat_layer, rms_norm

__all__ = ["init", "forward", "train_loss", "prefill", "decode_step",
           "init_cache", "cache_specs", "wkv_scan", "wkv_chunked"]


# ---------------------------------------------------------------- wkv core
def wkv_scan(r, k, v, w, u, state):
    """Sequential recurrence in float32.

    r,k,w: (B,T,H,K); v: (B,T,H,V); u: (H,K); state: (B,H,K,V).
    Returns (y (B,T,H,V), final state).
      y_t  = (S_{t-1} + diag(u) k_t v_t^T)^T r_t
      S_t  = diag(w_t) S_{t-1} + k_t v_t^T
    """
    r, k, v, w, u = (x.float() for x in (r, k, v, w, u))
    s = state.float()
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]       # (B,H,K,V)
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               s + u[None, :, :, None] * kv))
        s = w[:, t, :, :, None] * s + kv
    y = torch.stack(ys, dim=1) if ys else v.new_zeros(v.shape)
    return y, s


def wkv_chunked(r, k, v, w, u, state, chunk: int = 64):
    """Chunk-parallel evaluation (identical math, another schedule); y in
    v's dtype."""
    if r.shape[1] % chunk != 0:
        return wkv_scan(r, k, v, w, u, state)
    y, state = chunked_scan(r, k, v, w, u, state, chunk)
    return y.to(v.dtype), state


# -------------------------------------------------------------------- init
_MIXES = ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "mu_ffn_k", "mu_ffn_r")


def _init_layer(ini: Initializer, cfg) -> dict:
    d, ff, lora = cfg.d_model, cfg.d_ff, cfg.rwkv_decay_lora
    embed = ("embed",)
    p = {"ln1": ini.ones(d, axes=embed), "ln2": ini.ones(d, axes=embed)}
    for mu in _MIXES:
        p[mu] = ini.zeros(d, axes=embed)
    p["w0"] = ini.zeros(d, axes=embed)
    p["w_lora_a"] = ini.normal(d, lora, axes=("embed", "lora"))
    p["w_lora_b"] = ini.normal(lora, d, axes=("lora", "embed"))
    p["u"] = ini.zeros(d, axes=embed)
    for name in ("wr", "wk", "wv", "wg"):
        p[name] = ini.normal(d, d, axes=("embed", "inner"))
    p["wo"] = ini.normal(d, d, axes=("inner", "embed"))
    p["ln_x"] = ini.ones(d, axes=embed)
    p["ffn_k"] = ini.normal(d, ff, axes=("embed", "ff"))
    p["ffn_v"] = ini.normal(ff, d, axes=("ff", "embed"))
    p["ffn_r"] = ini.normal(d, d, axes=("embed", "inner"))
    return p


def init(cfg, ini: Initializer) -> dict:
    """Parameters drawn by ``ini`` (or their shapes or logical axes)."""
    params = {"embed": ini.normal(cfg.vocab_size, cfg.d_model,
                                  axes=("vocab", "embed")),
              "head": ini.normal(cfg.d_model, cfg.vocab_size,
                                 axes=("embed", "vocab")),
              "final_norm": ini.ones(cfg.d_model, axes=("embed",))}
    params["layers"] = [_init_layer(ini, cfg) for _ in range(cfg.n_layers)]
    return params


# ------------------------------------------------------------------ layers
def _heads(cfg):
    hd = cfg.ssm_head_dim
    return cfg.d_model // hd, hd


def _time_mix(cfg, p, x, shifted, wkv):
    """x, shifted: (B,T,d); ``wkv(r, k, v, w, u) -> (y, state)`` in float32.
    Returns (out, new wkv state)."""
    b, t, d = x.shape
    h, hd = _heads(cfg)

    def lerp(mu):
        return x + (shifted - x) * p[mu]

    r = (lerp("mu_r") @ p["wr"]).view(b, t, h, hd)
    k = (lerp("mu_k") @ p["wk"]).view(b, t, h, hd)
    v = (lerp("mu_v") @ p["wv"]).view(b, t, h, hd)
    g = F.silu(lerp("mu_g") @ p["wg"])
    dd = p["w0"] + torch.tanh(lerp("mu_w") @ p["w_lora_a"]) @ p["w_lora_b"]
    w = torch.exp(-torch.exp(dd.float())).view(b, t, h, hd)
    u = p["u"].view(h, hd)
    y, new_state = wkv(r.float(), k.float(), v.float(), w, u.float())
    y = y.reshape(b, t, d).to(x.dtype)
    y = rms_norm(y, p["ln_x"], cfg.norm_eps)      # per-channel out-norm
    return (y * g) @ p["wo"], new_state


def _channel_mix(p, x, shifted):
    def lerp(mu):
        return x + (shifted - x) * p[mu]

    kk = torch.square(torch.relu(lerp("mu_ffn_k") @ p["ffn_k"]))
    return (kk @ p["ffn_v"]) * torch.sigmoid(lerp("mu_ffn_r") @ p["ffn_r"])


def _shift_seq(x):
    """Token shift for full sequences: x_{t-1}, zeros at t=0."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


# -------------------------------------------------------------- entry pts
def _block(cfg, p, x, wkv):
    """One layer over a whole sequence; ``wkv(r, k, v, w, u) -> (y, state)``
    evaluates it from a zero state: the kernel's wrapper when serving, a
    plain evaluator when training.  Returns (out, wkv state, the last rows
    of the two token shifts' inputs)."""
    x = constrain(x, ("batch", "seq", "embed_act"))
    h1 = rms_norm(x, p["ln1"], cfg.norm_eps)
    att, state = _time_mix(cfg, p, h1, _shift_seq(h1), wkv)
    x = x + att
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    x = constrain(x + _channel_mix(p, h2, _shift_seq(h2)),
                  ("batch", "seq", "embed_act"))
    return x, state, h1[:, -1], h2[:, -1]


def _from_zero(evaluate, r, k, v, w, u):
    """``evaluate`` (``wkv_chunked`` or ``wkv_scan``) from a zero state."""
    b, _, h, hd = r.shape
    return evaluate(r, k, v, w, u, r.new_zeros((b, h, hd, v.shape[-1])))


def forward(cfg, params, batch, rt=None):
    """Full-sequence forward -> (logits (B, T, V), None), on the plain
    evaluators (training's path)."""
    use_chunked = getattr(rt, "rwkv_chunked", True) if rt else True
    remat = (getattr(rt, "remat", "none") != "none") if rt else False
    wkv = functools.partial(_from_zero,
                            wkv_chunked if use_chunked else wkv_scan)
    layer = remat_layer(functools.partial(_block, cfg, wkv=wkv), remat)
    x = constrain(params["embed"][batch["tokens"]],
                  ("batch", "seq", "embed_act"))
    for p in params["layers"]:
        x = layer(p, x)[0]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return constrain(x @ params["head"], ("batch", "seq", "vocab")), None


def train_loss(cfg, params, batch, rt=None):
    logits, _ = forward(cfg, params, batch, rt)
    return cross_entropy(logits, batch["targets"])


def init_cache(cfg, batch_size: int, max_len: int, dtype=None,
               device="cuda") -> dict:
    """The decode state is O(1) in sequence length: per layer the wkv state
    and the two token-shift rows (``max_len`` is not used)."""
    del max_len
    h, hd = _heads(cfg)
    n, d = cfg.n_layers, cfg.d_model
    dtype = dtype or DTYPES[cfg.dtype]
    return {
        "wkv": torch.zeros((n, batch_size, h, hd, hd), dtype=torch.float32,
                           device=device),
        "att_shift": torch.zeros((n, batch_size, d), dtype=dtype,
                                 device=device),
        "ffn_shift": torch.zeros((n, batch_size, d), dtype=dtype,
                                 device=device),
        "len": 0,
    }


def cache_specs(cfg) -> dict:
    """Logical axes of the cache (the reference's names; no sharding here)."""
    return {
        "wkv": ("layers", "batch", "state_heads", "head_dim", "head_dim2"),
        "att_shift": ("layers", "batch", "embed"),
        "ffn_shift": ("layers", "batch", "embed"),
        "len": (),
    }


def prefill(cfg, params, batch, max_len: int, rt=None):
    """Run the prompt from a zero state; return (last-token logits,
    cache).  ``rt`` is unused, as in the reference."""
    x = params["embed"][batch["tokens"]]
    states, att_shift, ffn_shift = [], [], []
    for p in params["layers"]:
        x, state, h1_last, h2_last = _block(cfg, p, x, ops.wkv6)
        states.append(state)
        att_shift.append(h1_last)
        ffn_shift.append(h2_last)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    cache = {"wkv": torch.stack(states), "att_shift": torch.stack(att_shift),
             "ffn_shift": torch.stack(ffn_shift), "len": x.shape[1]}
    return x[:, -1] @ params["head"], cache


def decode_step(cfg, params, batch, cache, rt=None):
    """One-token step (``rt`` unused, as in the reference).  Updates
    ``cache`` in place and returns (logits, cache)."""
    x = params["embed"][batch["tokens"]][:, 0]      # (B, d)
    for layer, p in enumerate(params["layers"]):
        scan = functools.partial(_scan_from, cache["wkv"][layer])
        h1 = rms_norm(x[:, None], p["ln1"], cfg.norm_eps)
        att, state = _time_mix(cfg, p, h1, cache["att_shift"][layer][:, None],
                               scan)
        x = x + att[:, 0]
        h2 = rms_norm(x[:, None], p["ln2"], cfg.norm_eps)
        x = x + _channel_mix(p, h2, cache["ffn_shift"][layer][:, None])[:, 0]
        cache["wkv"][layer] = state
        cache["att_shift"][layer] = h1[:, 0]
        cache["ffn_shift"][layer] = h2[:, 0]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    cache["len"] += 1
    return x @ params["head"], cache


def _scan_from(state, r, k, v, w, u):
    return wkv_scan(r, k, v, w, u, state)
