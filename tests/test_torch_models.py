"""The port's models, held to the reference's on the same weights.

The reference initialises each smoke config in float32 (with a GQA group
of 3 for the dense family), its parameters cross to the port through
``params_from_numpy``, and both run the same prompt through ``prefill``
and three ``decode_step``s.  The port's prefill goes through ``ops.mha`` /
``ops.wkv6`` (their plain versions on the CPU, with the ragged prompt
padded); the reference's through its plain attention and its sequential
scan.  The moe family (``models.moe``) and the hybrid family
(``models.zamba2`` over ``models.mamba2``, the shared block's attention
through ``ops.mha``) are held the same way, and every family's
prefill-then-decode to the reference's full-sequence ``forward``.

Tolerance: 1e-4 absolute and relative on logits and caches.  Everything is
float32; the two packages associate sums differently (dense vs blockwise
attention, sequential vs chunked WKV, XLA vs ATen reductions), which moves
values of order 1 by about 1e-6.
"""
import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jmodels
import repro.models.rwkv6 as jrwkv6
import repro_torch.configs as tconfigs
import repro_torch.models.rwkv6 as trwkv6
from repro_torch.kernels import ops
from repro_torch.models import get_model, zamba2
from repro_torch.models.convert import params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
# a GQA group of 3 for the dense family; the other smoke configs as they are
OVERRIDES = {"qwen3-14b-smoke": dict(n_heads=6, n_kv_heads=2),
             "rwkv6-3b-smoke": {},
             "qwen3-moe-30b-a3b-smoke": {},
             "zamba2-2.7b-smoke": {}}
PROMPT, MAX_LEN, BATCH = 40, 48, 2


def _configs(arch):
    kw = dict(OVERRIDES[arch], dtype="float32")
    return (jconfigs.get_config(arch).replace(**kw),
            tconfigs.get_config(arch).replace(**kw))


def _np(x):
    """A copy: the port updates its cache in place."""
    return np.array(x.numpy() if isinstance(x, torch.Tensor) else x)


def _cache_arrays(cache):
    return {k: _np(v) for k, v in cache.items() if k != "len"}


@pytest.fixture(scope="module", params=list(OVERRIDES))
def pair(request):
    """Reference and port run side by side on one converted parameter set:
    prefill, then three decode steps on the same tokens."""
    jcfg, tcfg = _configs(request.param)
    jmodel, tmodel = jmodels.get_model(jcfg), get_model(tcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, tcfg.vocab_size, (BATCH, PROMPT), dtype=np.int32)
    steps = rng.integers(0, tcfg.vocab_size, (3, BATCH, 1), dtype=np.int32)

    ops.reset_launches()
    runs = {"ref": [], "port": []}
    jl, jc = jmodel.prefill(jparams, {"tokens": prompt}, MAX_LEN)
    runs["ref"].append((_np(jl), _cache_arrays(jc), int(jc["len"])))
    with torch.no_grad():
        tl, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(prompt)},
                                MAX_LEN)
        runs["port"].append((_np(tl), _cache_arrays(tc), tc["len"]))
        launches = {fn.__name__: fn.launches for fn in ops.LLM_WRAPPERS}
        for tok in steps:
            jl, jc = jmodel.decode_step(jparams, {"tokens": tok}, jc)
            runs["ref"].append((_np(jl), _cache_arrays(jc), int(jc["len"])))
            tl, tc = tmodel.decode_step(
                tparams, {"tokens": torch.from_numpy(tok).long()}, tc)
            runs["port"].append((_np(tl), _cache_arrays(tc), tc["len"]))
    return {"cfg": tcfg, "runs": runs, "launches": launches}


def test_prefill_logits_and_cache_match_reference(pair):
    (jl, jc, jn), (tl, tc, tn) = pair["runs"]["ref"][0], \
        pair["runs"]["port"][0]
    assert tl.shape == jl.shape == (BATCH, pair["cfg"].vocab_size)
    np.testing.assert_allclose(tl, jl, **TOL)
    assert tn == jn == PROMPT and set(tc) == set(jc)
    for name in jc:
        assert tc[name].shape == jc[name].shape, name
        np.testing.assert_allclose(tc[name], jc[name], **TOL, err_msg=name)


@pytest.mark.parametrize("step", [1, 2, 3])
def test_decode_steps_match_reference(pair, step):
    (jl, jc, jn), (tl, tc, tn) = pair["runs"]["ref"][step], \
        pair["runs"]["port"][step]
    np.testing.assert_allclose(tl, jl, **TOL)
    assert tn == jn == PROMPT + step
    for name in jc:
        np.testing.assert_allclose(tc[name], jc[name], **TOL, err_msg=name)


def test_prefill_runs_each_layer_through_its_kernel(pair):
    """One ``mha`` a layer for dense and moe, one a site of the shared
    block for hybrid, one ``wkv6`` a layer for ssm."""
    cfg = pair["cfg"]
    attention = {"dense": cfg.n_layers, "moe": cfg.n_layers,
                 "hybrid": zamba2.n_sites(cfg) if cfg.family == "hybrid"
                 else 0}
    want = {"mha": attention.get(cfg.family, 0),
            "wkv6": cfg.n_layers if cfg.family == "ssm" else 0, "pchase": 0}
    assert pair["launches"] == want


@pytest.mark.parametrize("arch", list(OVERRIDES))
def test_prefill_then_decode_equals_reference_forward(arch):
    """The reference's prefill/decode consistency contract, with the
    reference's ``forward`` over t + 1 tokens on one side and the port's
    prefill of t tokens and one decode step on the other: the logits at
    positions t - 1 and t.  The moe config runs at capacity factor 16, as
    the reference's case does, so no pair is dropped in either path."""
    kw = dict(OVERRIDES[arch], dtype="float32")
    if arch.startswith("qwen3-moe"):
        kw["moe_capacity_factor"] = 16.0
    jcfg = jconfigs.get_config(arch).replace(**kw)
    tcfg = tconfigs.get_config(arch).replace(**kw)
    jmodel = jmodels.get_model(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(2))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    b, s = 2, 8
    rng = np.random.default_rng(2)
    full = rng.integers(0, tcfg.vocab_size, (b, s + 1), dtype=np.int32)
    want, _ = jmodel.forward(jparams, {"tokens": full},
                             jmodels.Runtime(q_chunk=0))
    want = np.asarray(want)
    model = get_model(tcfg)
    with torch.no_grad():
        pre, cache = model.prefill(
            tparams, {"tokens": torch.from_numpy(full[:, :s]).long()}, s + 4)
        nxt, _ = model.decode_step(
            tparams, {"tokens": torch.from_numpy(full[:, s:]).long()}, cache)
    np.testing.assert_allclose(pre.numpy(), want[:, s - 1], **TOL)
    np.testing.assert_allclose(nxt.numpy(), want[:, s], **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", list(OVERRIDES))
def test_convert_keeps_every_leaf(arch, dtype):
    """``params_from_numpy`` on a reference ``init``: every leaf of the
    reference tree, nested ones (a layer's ``moe``, zamba2's ``shared``)
    included, lands at the same path with the same shape and dtype, each
    layer's slice of the stacked axis in its own dictionary."""
    kw = dict(OVERRIDES[arch], dtype=dtype)
    jcfg = jconfigs.get_config(arch).replace(**kw)
    tcfg = tconfigs.get_config(arch).replace(**kw)
    jparams, _ = jmodels.get_model(jcfg).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    got = params_from_numpy(tcfg, tree, device="cpu")
    want_dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]

    def walk(ref, port, path, layer=None):
        if isinstance(ref, dict):
            assert isinstance(port, dict) and set(port) == set(ref), path
            for name in ref:
                walk(ref[name], port[name], f"{path}/{name}", layer)
            return
        want = ref if layer is None else ref[layer]
        assert tuple(port.shape) == want.shape, path
        assert port.dtype == want_dtype, path
        np.testing.assert_array_equal(port.float().numpy(),
                                      want.astype(np.float32), err_msg=path)

    assert set(got) == set(tree)
    for name in tree:
        if name != "layers":
            walk(tree[name], got[name], name)
    assert len(got["layers"]) == tcfg.n_layers
    for i, port_layer in enumerate(got["layers"]):
        walk(tree["layers"], port_layer, f"layers[{i}]", layer=i)
    # a leaf with the wrong number of layers is refused, a nested one (the
    # moe family's router) too
    bad = jax.tree.map(lambda a: a, tree)
    group = bad["layers"].get("moe", bad["layers"])
    name = next(iter(group))
    group[name] = group[name][:1]
    with pytest.raises(ValueError, match=f"/{name}: .* expected 2 layers"):
        params_from_numpy(tcfg, bad, device="cpu")


@pytest.mark.parametrize("t,chunk", [(64, 32), (40, 32)])
def test_wkv_evaluators_match_reference_from_a_state(t, chunk):
    """``wkv_chunked`` (and ``wkv_scan``, its fallback on a ragged length)
    from a non-zero state, against the reference's."""
    rng = np.random.default_rng(t)
    b, h, kd = 2, 3, 8
    arrays = [rng.standard_normal((b, t, h, kd), dtype=np.float32)
              for _ in range(3)]
    w = rng.uniform(0.05, 0.98, (b, t, h, kd)).astype(np.float32)
    u = rng.standard_normal((h, kd), dtype=np.float32)
    s0 = rng.standard_normal((b, h, kd, kd), dtype=np.float32)
    args = [*arrays, w, u, s0]
    for name in ("wkv_chunked", "wkv_scan"):
        kw = {"chunk": chunk} if name == "wkv_chunked" else {}
        y, s = getattr(trwkv6, name)(*map(torch.from_numpy, args), **kw)
        jy, js = getattr(jrwkv6, name)(*args, **kw)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)


def test_plain_attention_matches_reference():
    """``common.attention`` with an offset, a prefix and query chunks."""
    from repro.models.common import attention as jattention
    from repro_torch.models.common import attention

    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 16, 6, 8), dtype=np.float32)
    k = rng.standard_normal((2, 16, 2, 8), dtype=np.float32)
    v = rng.standard_normal((2, 16, 2, 8), dtype=np.float32)
    for kw in (dict(causal=True), dict(causal=False),
               dict(causal=True, q_offset=4),
               dict(causal=True, prefix_len=5, q_chunk=4)):
        got = attention(*map(torch.from_numpy, (q, k, v)), **kw)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jattention(q, k, v, **kw)),
                                   **TOL)
