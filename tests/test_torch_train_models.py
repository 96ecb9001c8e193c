"""The port's training forward on every architecture, at smoke size.

The reference's ``tests/test_models_smoke.py`` re-pointed at
``repro_torch``: a reduced float32 config of each architecture runs
``forward`` and ``train_loss`` (finite, positive loss) and a backward pass
(finite gradients, one for every parameter); ``prefill`` then one
``decode_step`` equal ``forward``'s logits at the same positions (the
serving path through ``ops.mha``/``ops.wkv6``'s plain versions against
training's plain attention and WKV; moe at capacity factor 16, as there,
so the two paths drop no pair); and eight SGD steps on one batch cut the
dense loss below 0.9 of its start.  The tolerances are the reference's.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.models import Runtime, get_model
from repro_torch.train.optimizer import tree_leaves

ALL_ARCHS = sorted(ARCHS)


def _smoke_batch(cfg, rng, b=2, s=16):
    r = np.random.default_rng(rng)
    if cfg.family == "audio":
        toks = torch.from_numpy(r.integers(0, cfg.vocab_size,
                                           (b, cfg.n_codebooks, s)))
        return {"tokens": toks, "targets": toks}
    toks = torch.from_numpy(r.integers(0, cfg.vocab_size, (b, s)))
    batch = {"tokens": toks, "targets": toks}
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy(r.normal(
            size=(b, cfg.n_patches, cfg.vision_embed_dim)).astype(np.float32))
    return batch


def _model(arch, seed):
    cfg = get_config(arch).smoke().replace(dtype="float32")
    model = get_model(cfg)
    return cfg, model, model.init(seed, device="cpu")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_smoke_forward_and_loss(arch):
    cfg, model, params = _model(arch, 0)
    batch = _smoke_batch(cfg, rng=0)
    logits, _ = model.forward(params, batch)
    width = (cfg.n_codebooks,) if cfg.family == "audio" else ()
    assert tuple(logits.shape) == (2, 16, *width, cfg.vocab_size)
    loss = model.train_loss(params, batch)
    assert np.isfinite(float(loss)), f"{arch}: loss is not finite"
    assert float(loss) > 0


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_smoke_grads_finite(arch):
    cfg, model, params = _model(arch, 1)
    batch = _smoke_batch(cfg, rng=1)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    grads = torch.autograd.grad(model.train_loss(params, batch), leaves,
                                allow_unused=True)
    assert grads
    missing = [i for i, g in enumerate(grads) if g is None]
    assert not missing, f"{arch}: no gradient for leaves {missing}"
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_smoke_prefill_decode_consistency(arch):
    """prefill(t tokens) then decode_step must equal forward(t+1 tokens) on
    the next-token logits: the cache and state contract."""
    cfg = get_config(arch).smoke().replace(dtype="float32")
    if cfg.family == "moe":
        # with a tiny decode batch against an 18-token forward, a tight
        # capacity drops different (token, expert) pairs in the two paths
        cfg = cfg.replace(moe_capacity_factor=16.0)
    model = get_model(cfg)
    params = model.init(2, device="cpu")
    b, s = 2, 8
    batch = _smoke_batch(cfg, rng=2, b=b, s=s + 1)
    full = batch["tokens"]
    if cfg.family == "audio":
        pre = {"tokens": full[:, :, :s]}
        nxt = {"tokens": full[:, :, s:s + 1]}
    else:
        pre = {k: v for k, v in batch.items() if k != "targets"}
        pre["tokens"] = full[:, :s]
        nxt = {"tokens": full[:, s:s + 1]}
    whole = {k: v for k, v in batch.items() if k != "targets"}

    max_len = s + 4 + (cfg.n_patches if cfg.family == "vlm" else 0)
    with torch.no_grad():
        logits_pre, cache = model.prefill(params, pre, max_len)
        logits_dec, cache = model.decode_step(params, nxt, cache)
        logits_full, _ = model.forward(params, whole, Runtime(q_chunk=0))
    torch.testing.assert_close(logits_pre, logits_full[:, s - 1],
                               rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(logits_dec, logits_full[:, s],
                               rtol=2e-2, atol=2e-2)


def test_loss_decreases_tiny_overfit():
    """A few SGD steps on one batch must reduce the loss (dense family)."""
    cfg, model, params = _model("internlm2-1.8b", 3)
    batch = _smoke_batch(cfg, rng=3)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    losses = []
    for _ in range(8):
        loss = model.train_loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for p, g in zip(leaves, grads):
                p.sub_(0.5 * g)
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0] * 0.9, losses
