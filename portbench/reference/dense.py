"""Plain reference of a dense decoder (Qwen3, InternLM2): pre-norm RMSNorm
blocks of grouped-query attention with NeoX rotary embeddings (and, where
the configuration has it, RMSNorm of each head's queries and keys) and a
SwiGLU feed-forward, a final RMSNorm and an untied head.

Two entry points, each on weights made again from the seed
(``harness.weights``), never on the program's:

* ``serve_logits``: the logits a served sequence predicts, in float32 with
  TF32 off, one layer at a time over all the sequences, attention a block
  of queries at a time, so it fits beside nothing else on the card.
* ``train_readings``: the first steps of training as the configuration
  states it (bfloat16 products, float32 master, moments and gradient
  sums, AdamW with global-norm clipping), each layer recomputed in the
  backward pass: the losses, each leaf's first gradient as the optimizer
  takes it, and each leaf's change after the last step.

``fp8=True`` is the control: every matrix product's operands rounded to
float8 e4m3 (a scale a row of activations and a column of weights), the
precision below bfloat16.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from harness.weights import (embed_weights, final_norm_weights,
                             head_weights, layer_weights, named_initial)

__all__ = ["serve_logits", "train_readings", "fp8_round"]

_MATS = ("wq", "wk", "wv", "wo", "w1", "w3", "w2")


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``
    (the slice's largest magnitude maps to e4m3's largest, 448)."""
    scale = x.detach().abs().amax(dim, keepdim=True).float().clamp(
        min=1e-30) / 448.0
    q = (x.float() / scale).to(torch.float8_e4m3fn).float() * scale
    return q.to(x.dtype)


def _rms(x, g, eps):
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
            * g.float()).to(x.dtype)


def _rope(x, pos, theta):
    """NeoX rotary embedding of x (T, H, hd) at positions ``pos`` (T,)."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = pos.float()[:, None] * inv[None]
    cos, sin = ang.cos()[:, None], ang.sin()[:, None]
    a, b = x[..., :half].float(), x[..., half:].float()
    return torch.cat([a * cos - b * sin, b * cos + a * sin], -1).to(x.dtype)


class _Ops:
    """Matrix products in the reference's precision; the control rounds
    their operands to float8 (straight through for the backward)."""

    def __init__(self, fp8: bool):
        self.fp8 = fp8

    def act(self, x):
        if not self.fp8:
            return x
        return x + (fp8_round(x, -1) - x).detach()

    def weight(self, w):
        if not self.fp8:
            return w
        return w + (fp8_round(w, 0) - w).detach()

    def mm(self, x, w):
        return self.act(x) @ self.weight(w)


def _attend(s, q, k, v, ops: _Ops, block: int = 512):
    """Causal attention of q (T, Hq, hd) over k, v (T, Hkv, hd), a block of
    queries at a time; scores and softmax in float32."""
    t, hq, hd = q.shape
    g = hq // s.n_kv_heads
    q, k, v = ops.act(q), ops.act(k), ops.act(v)
    kk = k.permute(1, 2, 0)                          # (Hkv, hd, T)
    vv = v.permute(1, 0, 2)                          # (Hkv, T, hd)
    outs = []
    for a in range(0, t, block):
        qb = q[a:a + block]                          # (c, Hq, hd)
        c = qb.shape[0]
        n = a + c                                    # keys up to the last
        qg = qb.reshape(c, s.n_kv_heads, g, hd).permute(1, 2, 0, 3)
        scores = (qg @ kk[:, None, :, :n]).float() / math.sqrt(hd)
        qpos = torch.arange(a, n, device=q.device)
        kpos = torch.arange(n, device=q.device)
        scores = scores.masked_fill(kpos[None] > qpos[:, None],
                                    float("-inf"))
        p = ops.act(torch.softmax(scores, -1).to(v.dtype))
        o = p @ vv[:, None, :n]                      # (Hkv, g, c, hd)
        outs.append(o.permute(2, 0, 1, 3).reshape(c, hq, hd))
    return torch.cat(outs, 0)


def _block(s, w, x, ops: _Ops):
    """One layer over one sequence x (T, d) from position 0."""
    t, d = x.shape
    hd = s.head_dim
    pos = torch.arange(t, device=x.device)
    h = _rms(x, w["ln1"], s.norm_eps)
    q = ops.mm(h, w["wq"].reshape(d, -1)).view(t, s.n_heads, hd)
    k = ops.mm(h, w["wk"].reshape(d, -1)).view(t, s.n_kv_heads, hd)
    v = ops.mm(h, w["wv"].reshape(d, -1)).view(t, s.n_kv_heads, hd)
    if s.qk_norm:
        q = _rms(q, w["q_norm"], s.norm_eps)
        k = _rms(k, w["k_norm"], s.norm_eps)
    q, k = _rope(q, pos, s.rope_theta), _rope(k, pos, s.rope_theta)
    o = _attend(s, q, k, v, ops).reshape(t, -1)
    x = x + ops.mm(o, w["wo"].reshape(-1, d)).to(x.dtype)
    h = _rms(x, w["ln2"], s.norm_eps)
    f = F.silu(ops.mm(h, w["w1"])) * ops.mm(h, w["w3"])
    return x + ops.mm(f, w["w2"]).to(x.dtype)


@torch.no_grad()
def serve_logits(s, seed: int, seqs: list, starts: list, device,
                 fp8: bool = False) -> list:
    """For each sequence of ids (T_i,), the float32 logits (T_i - start_i,
    vocab) of its positions from ``starts[i] - 1``: those that predict its
    ids from ``starts[i]`` on (a served sequence: its prompt, then the
    served ids but the last, with the first served id at start_i = the
    prompt's length)."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        ops = _Ops(fp8)
        emb = embed_weights(s, seed, device)
        xs = [emb[ids.to(device)].float() for ids in seqs]
        del emb
        for layer in range(s.n_layers):
            w = {n: t.float() for n, t in
                 layer_weights(s, seed, layer, device).items()}
            if fp8:
                w.update({n: ops.weight(w[n]) for n in _MATS})
            xs = [_block(s, w, x, ops) for x in xs]
            del w
        head = ops.weight(head_weights(s, seed, device).float())
        g = final_norm_weights(s, seed, device).float()
        return [ops.mm(_rms(x[st - 1:], g, s.norm_eps), head)
                for x, st in zip(xs, starts)]
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32


# ------------------------------------------------------------- training
def _layer_names(s) -> list[str]:
    names = list(_MATS) + ["ln1", "ln2"]
    return names + (["q_norm", "k_norm"] if s.qk_norm else [])


def _loss(s, p: dict, tokens, targets, ops: _Ops, remat: bool):
    """Mean next-token cross entropy of rows ``tokens`` (b, T)."""
    layers = [{n: p[f"layers.{i}.{n}"] for n in _layer_names(s)}
              for i in range(s.n_layers)]
    total = 0.0
    for row in range(tokens.shape[0]):
        x = p["embed"][tokens[row]]
        for w in layers:
            if remat:
                x = checkpoint(_block, s, w, x, ops, use_reentrant=False)
            else:
                x = _block(s, w, x, ops)
        logits = ops.mm(_rms(x, p["final_norm"], s.norm_eps), p["head"])
        total = total + F.cross_entropy(logits.float(),
                                        targets[row].long(),
                                        reduction="sum")
    return total / targets.numel()


def _lr(opt: dict, step: int) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    t = min(max((step - opt["warmup_steps"])
                / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
            1.0)
    r = opt["min_lr_ratio"]
    return opt["lr"] * warm * (r + (1 - r) * 0.5 * (1 + math.cos(math.pi * t)))


def train_readings(s, seed: int, batches: list, opt: dict, device,
                   microbatch: int, fp8: bool = False,
                   remat: bool = True) -> dict:
    """Train from the seed's weights over ``batches`` (one dict of
    ``tokens``/``targets`` (B, T) a step) -> ``loss`` a step, each leaf's
    first gradient norm as the optimizer takes it (clipped) and each
    leaf's change norm after the last step, by name."""
    ops = _Ops(fp8)
    master = {n: t.float()
              for n, t in named_initial(s, seed, device).items()}
    names = list(master)
    m = {n: torch.zeros_like(t) for n, t in master.items()}
    v = {n: torch.zeros_like(t) for n, t in master.items()}
    losses, first = [], None
    b1, b2 = opt["b1"], opt["b2"]
    for step, batch in enumerate(batches, start=1):
        p = {n: master[n].to(torch.bfloat16).requires_grad_(True)
             for n in names}
        tokens = torch.as_tensor(batch["tokens"], device=device)
        targets = torch.as_tensor(batch["targets"], device=device)
        acc = {n: torch.zeros_like(master[n]) for n in names}
        loss_sum, n_mb = 0.0, 0
        for a in range(0, tokens.shape[0], microbatch):
            with torch.enable_grad():
                loss = _loss(s, p, tokens[a:a + microbatch],
                             targets[a:a + microbatch], ops, remat)
                grads = torch.autograd.grad(loss, [p[n] for n in names])
            for n, g in zip(names, grads):
                acc[n].add_(g.float())
            del grads
            loss_sum += float(loss.detach())
            n_mb += 1
        del p
        losses.append(loss_sum / n_mb)
        with torch.no_grad():
            g = {n: acc[n].div_(n_mb) for n in names}
            gnorm = torch.sqrt(sum(torch.sum(t.square()) for t in g.values()))
            scale = min(opt["clip_norm"] / max(float(gnorm), 1e-9), 1.0)
            if first is None:
                first = {n: float(g[n].norm()) * scale for n in names}
            lr = _lr(opt, step)
            for n in names:
                gs = g[n] * scale
                m[n].mul_(b1).add_((1 - b1) * gs)
                v[n].mul_(b2).add_((1 - b2) * gs.square())
                upd = (m[n] / (1 - b1 ** step)) / (
                    torch.sqrt(v[n] / (1 - b2 ** step)) + opt["eps"])
                upd.add_(opt["weight_decay"] * master[n])
                master[n].sub_(lr * upd)
        del acc, g
    del m, v
    init = named_initial(s, seed, device)
    change = {n: float((master[n] - init[n].float()).norm()) for n in names}
    return {"loss": losses, "grad": first, "change": change}
