"""The port's mixture-of-experts FFN, held to ``repro.models.moe``.

The reference initialises the router and expert weights of the moe smoke
config (4 experts, top 2, d 64) in float32; the same arrays go through both
packages' ``moe_ffn`` on the same seeded input.  At capacity factor 1.0
pairs are dropped and both packages must drop the same (token, expert)
pairs; at 16.0 none is.

Tolerance, float32 throughout: router probabilities within 1e-6 (absolute
and relative); outputs within 1e-5 relative and 1e-5 of the largest output
absolute.  The expert weights take their fan-in from the expert axis
(scale 1/sqrt(E)), so the smoke outputs are of order 100, where one
float32 ulp is 7.6e-6 and the two packages' other orders of summation move
an output by a few ulps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.moe as jmoe
import repro_torch.configs as tconfigs
from repro.models.common import ParamBuilder
from repro_torch.models import moe

ARCH = "qwen3-moe-30b-a3b-smoke"
OUT_RTOL = 1e-5
PROB_TOL = dict(rtol=1e-6, atol=1e-6)
BATCH, SEQ = 2, 40


def _assert_outputs_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=OUT_RTOL,
                               atol=OUT_RTOL * float(np.abs(want).max()))


def _configs(**kw):
    kw = dict(kw, dtype="float32")
    return (jconfigs.get_config(ARCH).replace(**kw),
            tconfigs.get_config(ARCH).replace(**kw))


def _weights(jcfg, seed=0):
    b = ParamBuilder(jax.random.PRNGKey(seed), jnp.float32)
    jmoe.init_moe(b, jcfg)
    params, _ = b.build()
    return {name: np.array(a) for name, a in params.items()}


def _torch(arrays):
    return {name: torch.from_numpy(np.array(a)) for name, a in arrays.items()}


def _input(cfg, seed=1, b=BATCH, s=SEQ):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, s, cfg.d_model), dtype=np.float32)


def _dropped(top_e, cap):
    """(token, expert) pairs past ``cap`` in each expert's queue, the
    queue in (token, k) order: the semantics of a stable sort by expert."""
    seen, dropped = {}, set()
    for token, row in enumerate(np.asarray(top_e)):
        for e in row:
            seen[int(e)] = seen.get(int(e), 0) + 1
            if seen[int(e)] > cap:
                dropped.add((token, int(e)))
    return dropped


def _port_dropped(r, k):
    sorted_e = r.top_e.reshape(-1)[r.order]
    return {(int(i) // k, int(e))
            for i, e, kept in zip(r.order, sorted_e, r.keep) if not kept}


@pytest.mark.parametrize("factor,drops", [(1.25, None), (1.0, True),
                                          (16.0, False)])
def test_moe_ffn_matches_reference(factor, drops):
    jcfg, tcfg = _configs(moe_capacity_factor=factor)
    w = _weights(jcfg)
    x = _input(tcfg)
    jy, jprobs = jmoe.moe_ffn(w, x, jcfg)
    with torch.no_grad():
        y, probs = moe.moe_ffn(_torch(w), torch.from_numpy(x), tcfg)
    _assert_outputs_close(y.numpy(), jy)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), **PROB_TOL)

    k = tcfg.moe_top_k
    r = moe.route(_torch(w), torch.from_numpy(x).reshape(-1, tcfg.d_model),
                  tcfg)
    assert r.cap == max(int(BATCH * SEQ * k / tcfg.moe_experts * factor), k)
    _, jtop_e = jax.lax.top_k(jprobs, k)
    np.testing.assert_array_equal(r.top_e.numpy(), np.asarray(jtop_e))
    want = _dropped(jtop_e, r.cap)
    assert _port_dropped(r, k) == want
    if drops is not None:
        assert bool(want) == drops


def test_planted_ties_pick_the_lower_expert_first():
    """Equal router probabilities: a zero token (every expert ties) and
    experts whose router columns are copies of another's; the lower index
    wins in both packages, and the outputs agree."""
    jcfg, tcfg = _configs(moe_experts=8, moe_top_k=3)
    w = _weights(jcfg, seed=3)
    for copy in (5, 7):
        w["router"][:, copy] = w["router"][:, 2]
    x = _input(tcfg, seed=4, b=1, s=12)
    x[0, 0] = 0.0
    jy, jprobs = jmoe.moe_ffn(w, x, jcfg)
    _, jtop_e = jax.lax.top_k(jprobs, tcfg.moe_top_k)
    with torch.no_grad():
        y, _ = moe.moe_ffn(_torch(w), torch.from_numpy(x), tcfg)
        r = moe.route(_torch(w), torch.from_numpy(x[0]), tcfg)
    top_e = r.top_e.numpy()
    assert top_e[0].tolist() == [0, 1, 2]
    assert torch.equal(r.probs[:, 2], r.probs[:, 5]) and \
        torch.equal(r.probs[:, 2], r.probs[:, 7])
    tied = [row for row in top_e[1:] if 2 in row and 5 in row]
    assert tied, "no token chose two of the tied experts"
    for row in tied:
        assert 5 not in row or row.tolist().index(2) < row.tolist().index(5)
        assert 7 not in row or row.tolist().index(5) < row.tolist().index(7)
    np.testing.assert_array_equal(top_e, np.asarray(jtop_e))
    _assert_outputs_close(y.numpy(), jy)


def test_load_balance_loss_matches_reference():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((64, 8)).astype(np.float32)
    probs = np.array(jax.nn.softmax(logits, axis=-1))
    jcfg, tcfg = _configs(moe_experts=8, moe_top_k=2)
    want = float(jmoe.load_balance_loss(probs, None, jcfg))
    got = float(moe.load_balance_loss(torch.from_numpy(probs), None, tcfg))
    np.testing.assert_allclose(got, want, **PROB_TOL)


def test_combine_is_deterministic():
    """The combine gathers each pair back and sums a token's k rows in a
    fixed order: two runs give the same bits."""
    _, tcfg = _configs(moe_capacity_factor=1.0)
    w = _torch(_weights(_configs()[0]))
    x = torch.from_numpy(_input(tcfg, seed=6))
    with torch.no_grad():
        a, _ = moe.moe_ffn(w, x, tcfg)
        b, _ = moe.moe_ffn(w, x, tcfg)
    assert torch.equal(a, b)


@pytest.mark.parametrize("tokens,cap", [(4 * 512, 160), (4, 8)])
def test_capacity_of_the_served_shapes(tokens, cap):
    """qwen3-moe-30b-a3b's wave of 4 x 512 tokens and its decode step of 4,
    by the reference's formula."""
    cfg = tconfigs.get_config("qwen3-moe-30b-a3b")
    jcfg = jconfigs.get_config("qwen3-moe-30b-a3b")
    k = jcfg.moe_top_k
    assert moe.capacity(tokens, cfg) == cap == max(
        int(tokens * k / jcfg.moe_experts * jcfg.moe_capacity_factor), k)


def test_init_moe_shapes_and_fan_in():
    """Expert tensors (E, d, ff) take their fan-in from the expert axis, as
    the reference's ``ParamBuilder.add`` does."""
    from repro_torch.models.common import Initializer

    cfg = tconfigs.get_config(ARCH).replace(moe_experts=16, d_model=32,
                                            d_ff=24)
    g = torch.Generator().manual_seed(0)
    p = moe.init_moe(Initializer(g, torch.float32), cfg)
    want = _weights(jconfigs.get_config(ARCH).replace(
        moe_experts=16, d_model=32, d_ff=24, dtype="float32"))
    assert {n: tuple(t.shape) for n, t in p.items()} == \
        {n: a.shape for n, a in want.items()}
    np.testing.assert_allclose(float(p["w1"].std()), 16 ** -0.5, rtol=0.05)
    np.testing.assert_allclose(float(p["router"].std()), 32 ** -0.5,
                               rtol=0.1)
