"""The audio family (musicgen) and the vlm family (paligemma), held to the
reference on the same seeded inputs and weights.

* Prefix-LM attention: ``ops.mha(causal=True, prefix_len=P)`` and
  ``flash_attention_plain`` against the reference's plain
  ``repro.models.common.attention(causal=True, prefix_len=P)`` in float32,
  within 1e-5, at P on and beside the kernels' tile edges (1, 8, 63, 64,
  70, 256 and S), GQA groups 1, 4 and 8, head dims 16, 64 and 256, S a
  multiple of 64 and ragged; ``flash_attention_sm90_plain`` (the
  tensor-core kernel's numerics, bf16 probabilities on its kv tiles) with
  the prefix against the float32 plain version, within the tolerance that
  ``chip_smoke.py`` holds the card's bf16 kernel to (``ATTN_TOL``).
* ``musicgen-large-smoke`` and ``paligemma-3b-smoke`` in float32: the
  reference's ``init`` crosses through ``params_from_numpy``, then the
  port's ``prefill`` and two ``decode_step``s against the reference's,
  logits and caches within 1e-4 as for the other families, greedy tokens
  equal; the vlm logits with the prefix differ from a causal-only run by
  more than that.
* ``Engine.serve`` and ``launch/serve.py --device cpu`` against a greedy
  loop of the reference's ``prefill`` and ``decode_step`` on the same
  weights, with the batch layouts of the reference's ``Model.input_specs``
  (audio steps (B, K, 1)); outputs (new,) for vlm and (new, K) for audio.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jmodels
import repro_torch.configs as tconfigs
from repro.models.common import attention as ref_attention
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import get_model, transformer
from repro_torch.models.convert import _FAMILIES, params_from_numpy
from repro_torch.serve import Engine, ServeConfig
from repro_torch.sharding.context import full

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("musicgen-large-smoke", "paligemma-3b-smoke")
TEXT, MAX_LEN, BATCH, STEPS = 20, 40, 2, 2


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _qkv(b, hq, hkv, s, d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d), dtype=np.float32).astype(dtype)
            for h in (hq, hkv, hkv)]


# (query heads, kv heads, head dim, S): GQA groups 1, 4 and 8 at head dims
# 16, 64 and 256; S 320 a multiple of 64, 300 and 260 ragged
SHAPES = {"g1-d16-S320": (2, 2, 16, 320), "g4-d64-S300": (4, 1, 64, 300),
          "g8-d256-S260": (8, 1, 256, 260)}
PREFIXES = (1, 8, 63, 64, 70, 256, "S")


@pytest.mark.parametrize("prefix", PREFIXES, ids=lambda p: f"P{p}")
@pytest.mark.parametrize("shape", list(SHAPES))
def test_prefix_attention_matches_the_reference(shape, prefix):
    hq, hkv, d, s = SHAPES[shape]
    p = s if prefix == "S" else prefix
    q, k, v = _qkv(1, hq, hkv, s, d, seed=s + d + p)
    want = np.asarray(ref_attention(q, k, v, causal=True, prefix_len=p))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    ops.reset_launches()
    got = ops.mha(tq, tk, tv, causal=True, prefix_len=p)
    assert ops.mha.launches == 1 and got.shape == tq.shape
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)
    plain = fa.flash_attention_plain(tq, tk, tv, True, p)
    np.testing.assert_allclose(plain.numpy(), want, **ATTN_TOL)
    # the prefix's rows but its last see keys past the diagonal; later
    # rows see what the causal mask gives them
    causal = ops.mha(tq, tk, tv, causal=True).numpy()
    np.testing.assert_allclose(got.numpy()[:, p:], causal[:, p:], rtol=0,
                               atol=1e-6)
    if p > 1:
        assert np.abs(got.numpy()[:, :p - 1] - causal[:, :p - 1]).max() > 1e-3


def test_prefix_zero_is_causal():
    q, k, v = map(torch.from_numpy, _qkv(1, 4, 2, 128, 64, seed=5))
    causal = ops.mha(q, k, v, causal=True)
    assert torch.equal(ops.mha(q, k, v, causal=True, prefix_len=0), causal)
    assert torch.equal(ops.mha(q, k, v, causal=False, prefix_len=0),
                       ops.mha(q, k, v, causal=False))
    assert torch.equal(fa.flash_attention_plain(q, k, v, True, 0),
                       fa.flash_attention_plain(q, k, v, True))


@pytest.mark.parametrize("prefix", (1, 8, 63, 64, 70, 128, 256, "S"),
                         ids=lambda p: f"P{p}")
@pytest.mark.parametrize("d", (64, 256))
def test_sm90_plain_prefix_within_the_card_tolerance(smoke, d, prefix):
    """The tensor-core kernel's numerics with a prefix that ends inside a
    kv tile, on a tile edge (64 at d 256, 128 at d 64) and at S."""
    s, hq, hkv = 320, 8, 1
    p = s if prefix == "S" else prefix
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _qkv(1, hq, hkv, s, d, seed=d + p))
    rtol, atol = smoke.ATTN_TOL[("sm90", torch.bfloat16)]
    atol *= float(v.float().abs().max())
    want = fa.flash_attention_plain(q.float(), k.float(), v.float(), True, p)
    got = fa.flash_attention_sm90_plain(q, k, v, True, p)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)
    if p > 1:
        causal = fa.flash_attention_sm90_plain(q, k, v, True)
        assert float((got.float() - causal.float())[:, :p - 1].abs().max()) \
            > 10 * atol


@pytest.mark.parametrize("call,match", [
    (dict(causal=False, prefix_len=8), "causal=True"),
    (dict(causal=True, prefix_len=-1), "outside"),
    (dict(causal=True, prefix_len=129), "outside")],
    ids=["full", "negative", "past-Sq"])
def test_mha_refuses_a_prefix_it_cannot_take(call, match):
    q, k, v = map(torch.from_numpy, _qkv(1, 2, 1, 128, 16, seed=1))
    ops.reset_launches()
    with pytest.raises(ValueError, match=match):
        ops.mha(q, k, v, **call)
    assert ops.mha.launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_mha_refuses_a_prefix_past_head_dim_256(dtype):
    """The wide kernels take no prefix; the CPU refuses what the card
    would."""
    q, k, v = (x.to(dtype) for x in map(torch.from_numpy,
                                         _qkv(1, 2, 1, 64, 320, seed=2)))
    with pytest.raises(NotImplementedError, match="wide_kernel"):
        ops.mha(q, k, v, causal=True, prefix_len=8)
    assert ops.mha(q, k, v, causal=True).shape == q.shape


def test_both_sources_take_the_prefix():
    """Each entry point declares ``prefix_len`` after ``causal``, and each
    d <= 256 kernel masks and bounds its kv loop by it."""
    for route, entry in (("sm90", "flash_attention_sm90_fwd"),
                         ("cuda_core", "flash_attention_fwd")):
        path = os.path.join(os.path.dirname(fa.__file__), fa.SOURCES[route])
        with open(path) as f:
            src = f.read()
        decl = src[src.index(f'extern "C" int {entry}('):]
        decl = decl[:decl.index(")")]
        assert "int causal, int prefix_len" in " ".join(decl.split())
        assert "prefix - 1)" in src          # col > max(row, P - 1)
        assert "(prefix + " in src


# ------------------------------------------------------------------ models
def _configs(arch):
    return (jconfigs.get_config(arch).replace(dtype="float32"),
            tconfigs.get_config(arch).replace(dtype="float32"))


def _np(x):
    return np.array(x.numpy() if isinstance(x, torch.Tensor) else x)


def _prompt(cfg, rng, b=BATCH, text=TEXT):
    """A prefill batch in the reference's layout, as numpy arrays."""
    if cfg.family == "audio":
        return {"tokens": rng.integers(0, cfg.vocab_size,
                                       (b, cfg.n_codebooks, text),
                                       dtype=np.int32)}
    return {"patches": rng.standard_normal(
                (b, cfg.n_patches, cfg.vision_embed_dim), dtype=np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (b, text),
                                   dtype=np.int32)}


def _torch_batch(batch):
    return {name: torch.from_numpy(a).long() if a.dtype.kind == "i"
            else torch.from_numpy(a) for name, a in batch.items()}


def _step(cfg, tokens):
    """Sampled ids (B,) or audio's (B, K) -> a decode step's (B, 1) or
    (B, K, 1), the layout of the reference's ``Model.input_specs``."""
    return {"tokens": np.asarray(tokens, np.int32)[..., None]}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """Reference and port on one converted parameter set: prefill, then
    two decode steps on the reference's greedy tokens."""
    jcfg, tcfg = _configs(request.param)
    jmodel, tmodel = jmodels.get_model(jcfg), get_model(tcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    batch = _prompt(tcfg, np.random.default_rng(1))
    runs = {"ref": [], "port": []}
    jl, jc = jmodel.prefill(jparams, batch, MAX_LEN)
    calls = []
    mha = ops.mha

    def spy(*args, **kwargs):
        calls.append(kwargs.get("prefix_len"))
        return mha(*args, **kwargs)

    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(transformer.ops, "mha", spy)
        tl, tc = tmodel.prefill(tparams, _torch_batch(batch), MAX_LEN)
        runs["ref"].append((_np(jl), jc))
        runs["port"].append((_np(tl), {k: _np(v) for k, v in tc.items()
                                       if k != "len"}))
        for _ in range(STEPS):
            step = _step(tcfg, np.argmax(runs["ref"][-1][0], axis=-1))
            jl, jc = jmodel.decode_step(jparams, step, jc)
            tl, tc = tmodel.decode_step(tparams, _torch_batch(step), tc)
            runs["ref"].append((_np(jl), jc))
            runs["port"].append((_np(tl), {k: _np(v) for k, v in tc.items()
                                           if k != "len"}))
    return {"cfg": tcfg, "runs": runs, "calls": calls, "batch": batch,
            "tparams": tparams, "jparams": jparams, "jmodel": jmodel,
            "tmodel": tmodel, "len": tc["len"]}


@pytest.mark.parametrize("step", range(STEPS + 1))
def test_logits_and_cache_match_reference(pair, step):
    cfg = pair["cfg"]
    (jl, jc), (tl, tc) = pair["runs"]["ref"][step], \
        pair["runs"]["port"][step]
    want = (BATCH, cfg.n_codebooks, cfg.vocab_size) \
        if cfg.family == "audio" else (BATCH, cfg.vocab_size)
    assert tl.shape == jl.shape == want
    np.testing.assert_allclose(tl, jl, **TOL)
    np.testing.assert_array_equal(np.argmax(tl, -1), np.argmax(jl, -1))
    for name in ("k", "v"):
        assert tc[name].shape == jc[name].shape
        np.testing.assert_allclose(tc[name], np.asarray(jc[name]), **TOL,
                                   err_msg=name)


def test_prefill_passes_the_patches_as_the_prefix(pair):
    """One ``mha`` a layer, with ``prefix_len`` the patch count for vlm and
    0 for audio; the cache holds the patches' positions too."""
    cfg = pair["cfg"]
    want = cfg.n_patches if cfg.family == "vlm" else 0
    assert pair["calls"] == [want] * cfg.n_layers
    assert pair["len"] == cfg.n_patches + TEXT + STEPS


def test_vlm_prefix_changes_the_logits():
    """A check with teeth: the same vlm prefill with the prefix dropped
    (causal only) gives logits beyond the tolerance the reference holds."""
    jcfg, tcfg = _configs("paligemma-3b-smoke")
    jparams, _ = jmodels.get_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    batch = _torch_batch(_prompt(tcfg, np.random.default_rng(1)))
    model = get_model(tcfg)
    mha = ops.mha
    with torch.no_grad():
        with_prefix, _ = model.prefill(tparams, batch, MAX_LEN)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(transformer.ops, "mha",
                       lambda q, k, v, causal, prefix_len: mha(
                           q, k, v, causal=causal))
            causal, _ = model.prefill(tparams, batch, MAX_LEN)
    want, _ = jmodels.get_model(jcfg).prefill(
        jparams, {name: t.numpy() for name, t in batch.items()}, MAX_LEN)
    np.testing.assert_allclose(with_prefix.numpy(), np.asarray(want), **TOL)
    assert float((with_prefix - causal).abs().max()) > 100 * TOL["atol"]


def test_audio_embedding_sums_codebooks_in_bf16_in_order():
    """The codebook sum in the parameter dtype, left to right, as the
    reference's Python ``sum`` takes it; a sum in float32 rounded once
    differs."""
    cfg = tconfigs.get_config("musicgen-large-smoke")
    params = get_model(cfg).init(seed=3, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, cfg.n_codebooks, 16)))
    got = transformer._embed(cfg, params, tokens)
    parts = [params["embed"][kb][tokens[:, kb]]
             for kb in range(cfg.n_codebooks)]
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    once = sum(part.float() for part in parts).to(torch.bfloat16)
    assert not torch.equal(got, once)
    jcfg = jconfigs.get_config("musicgen-large-smoke")
    jembed = jnp.asarray(params["embed"].float().numpy(), jnp.bfloat16)
    jtoks = tokens.numpy()
    jsum = sum(jembed[kb][jtoks[:, kb]] for kb in range(jcfg.n_codebooks))
    np.testing.assert_array_equal(np.asarray(jsum, np.float32),
                                  got.float().numpy())


def test_params_from_numpy_takes_every_family():
    families = {jconfigs.get_config(a).family for a in jconfigs.ARCHS}
    assert families <= set(_FAMILIES) and len(_FAMILIES) == 6


# ----------------------------------------------------------------- serving
def _reference_greedy(jmodel, jparams, cfg, wave: dict, max_new: int,
                      max_len: int) -> np.ndarray:
    """The reference's model entry points in a greedy loop over one wave:
    (B, new) or (B, new, K)."""
    logits, cache = jmodel.prefill(jparams, wave, max_len)
    outs = [np.argmax(np.asarray(logits), -1)]
    while len(outs) < max_new:
        logits, cache = jmodel.decode_step(jparams, _step(cfg, outs[-1]),
                                           cache)
        outs.append(np.argmax(np.asarray(logits), -1))
    return np.stack(outs, axis=1)


def _wave(cfg, requests: list) -> dict:
    if cfg.family == "vlm":
        return {"patches": np.stack([r["patches"] for r in requests]),
                "tokens": np.stack([r["tokens"] for r in requests])}
    return {"tokens": np.stack(requests)}


def _reference_serve(jmodel, jparams, cfg, requests, slots, max_new,
                     max_len) -> list:
    out = []
    for w0 in range(0, len(requests), slots):
        gen = _reference_greedy(jmodel, jparams, cfg,
                                _wave(cfg, requests[w0:w0 + slots]),
                                max_new, max_len)
        out.extend(gen)
    return out


def _shape(cfg, new: int) -> tuple:
    return (new, cfg.n_codebooks) if cfg.family == "audio" else (new,)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_serve_equals_the_reference_greedy_loop(arch):
    jcfg, tcfg = _configs(arch)
    jmodel = jmodels.get_model(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    reqs = launch_serve.requests(tcfg, 6, 12)
    eng = Engine(get_model(tcfg), tparams,
                 ServeConfig(max_len=32, slots=4, device="cpu"))
    got = eng.serve(reqs, max_new=5)
    want = _reference_serve(jmodel, jparams, tcfg, reqs, 4, 5, 32)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.shape == _shape(tcfg, 5)
        np.testing.assert_array_equal(g, w)
    assert eng.stats["prefills"] == 2 and eng.stats["decode_steps"] == 8


def _reference_params(params: dict) -> dict:
    """The port's parameters -> the reference's tree: layers stacked (the
    launcher's DTensors by their whole values)."""
    tree = {name: jnp.asarray(full(t).numpy()) for name, t in params.items()
            if name != "layers"}
    tree["layers"] = {name: jnp.asarray(np.stack(
        [full(layer[name]).numpy() for layer in params["layers"]]))
        for name in params["layers"][0]}
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_the_family_and_counts(arch, capsys):
    ops.reset_launches()
    res = launch_serve.main(["--arch", arch, "--device", "cpu",
                             "--requests", "5", "--prompt-len", "10",
                             "--max-new", "4", "--max-len", "24",
                             "--slots", "4"])
    cfg = tconfigs.get_config(arch).replace(dtype="float32")
    assert res["launches"] == {"mha": 2 * cfg.n_layers, "wkv6": 0,
                               "pchase": 0}
    per = cfg.n_codebooks if cfg.family == "audio" else 1
    assert res["frames"] == 5 * 4 and res["new_tokens"] == 5 * 4 * per
    assert all(o.shape == _shape(cfg, 4) for o in res["outputs"])
    out = capsys.readouterr().out
    assert f"new_tokens={5 * 4 * per} frames=20" in out
    if cfg.family == "vlm":
        patches = res["requests"][0]["patches"]
        assert patches.shape == (cfg.n_patches, cfg.vision_embed_dim)
    want = _reference_serve(
        jmodels.get_model(jconfigs.get_config(arch).replace(dtype="float32")),
        _reference_params(res["engine"].params), cfg, res["requests"], 4, 4,
        24)
    for g, w in zip(res["outputs"], want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("arch,max_len", [("paligemma-3b-smoke", 21),
                                          ("musicgen-large-smoke", 13)])
def test_launcher_refuses_a_max_len_that_cannot_hold_the_run(arch, max_len):
    ops.reset_launches()
    with pytest.raises(ValueError, match="--max-len"):
        launch_serve.main(["--arch", arch, "--device", "cpu",
                           "--prompt-len", "10", "--max-new", "4",
                           "--max-len", str(max_len)])
    assert ops.mha.launches == 0
