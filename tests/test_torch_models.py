"""The port's models, held to the reference's on the same weights.

The reference initialises each smoke config in float32 (with a GQA group
of 3 for the dense family), its parameters cross to the port through
``params_from_numpy``, and both run the same prompt through ``prefill``
and three ``decode_step``s.  The port's prefill goes through ``ops.mha`` /
``ops.wkv6`` (their plain versions on the CPU, with the ragged prompt
padded); the reference's through its plain attention and its sequential
scan.

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
from repro_torch.models import get_model
from repro_torch.models.convert import params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
# a GQA group of 3 for the dense family; the rwkv smoke config as it is
OVERRIDES = {"qwen3-14b-smoke": dict(n_heads=6, n_kv_heads=2),
             "rwkv6-3b-smoke": {}}
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
    cfg = pair["cfg"]
    want = {"mha": cfg.n_layers if cfg.family == "dense" else 0,
            "wkv6": cfg.n_layers if cfg.family == "ssm" else 0, "pchase": 0}
    assert pair["launches"] == want


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
