"""The port's Mamba2 mixer, held to ``repro.models.mamba2``.

The reference initialises one mamba2 layer of the zamba2 smoke config in
float32; its decay, skip and bias vectors are then redrawn from a seeded
numpy generator (the reference initialises them to constants, which would
leave the per-head decay untested).  The same arrays go through both
packages' ``mamba2_seq`` (chunk 64 over whole chunks, a ragged length that
takes the single-chunk fallback, and chunk 4) and ``mamba2_step``, from
zero and from non-zero states.

Tolerance: 1e-4 absolute and relative on outputs, SSM states and conv
states, float32 throughout; the two packages sum in other orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.mamba2 as jmamba2
import repro_torch.configs as tconfigs
from repro.models.common import ParamBuilder
from repro_torch.models import mamba2

ARCH = "zamba2-2.7b-smoke"
TOL = dict(rtol=1e-4, atol=1e-4)
BATCH = 2


def _configs():
    return (jconfigs.get_config(ARCH).replace(dtype="float32"),
            tconfigs.get_config(ARCH).replace(dtype="float32"))


@pytest.fixture(scope="module")
def layer():
    jcfg, tcfg = _configs()
    b = ParamBuilder(jax.random.PRNGKey(0), jnp.float32)
    jmamba2.init_mamba2(b, jcfg)
    params, _ = b.build()
    w = {name: np.array(a) for name, a in params.items()}
    rng = np.random.default_rng(7)
    h = w["a_log"].shape[0]
    w["a_log"] = rng.uniform(-1.0, 1.0, h).astype(np.float32)
    w["dt_bias"] = rng.uniform(-2.0, 0.5, h).astype(np.float32)
    w["d_skip"] = rng.uniform(0.5, 1.5, h).astype(np.float32)
    w["conv_b"] = 0.1 * rng.standard_normal(w["conv_b"].shape,
                                            dtype=np.float32)
    return {"jcfg": jcfg, "tcfg": tcfg, "w": w,
            "t": {name: torch.from_numpy(a) for name, a in w.items()}}


def _states(cfg, seed, zero):
    d_in, h, pp, n = mamba2.dims(cfg)
    shape_s = (BATCH, h, pp, n)
    shape_c = (BATCH, cfg.ssm_conv_width - 1, d_in + 2 * n)
    if zero:
        return (np.zeros(shape_s, np.float32), np.zeros(shape_c, np.float32))
    rng = np.random.default_rng(seed)
    return (0.5 * rng.standard_normal(shape_s, dtype=np.float32),
            0.5 * rng.standard_normal(shape_c, dtype=np.float32))


def _x(cfg, t, seed):
    rng = np.random.default_rng(seed)
    return 0.5 * rng.standard_normal((BATCH, t, cfg.d_model),
                                     dtype=np.float32)


@pytest.mark.parametrize("t,chunk,zero", [(128, 64, True), (128, 64, False),
                                          (40, 64, True), (40, 64, False),
                                          (12, 4, True), (12, 4, False)])
def test_mamba2_seq_matches_reference(layer, t, chunk, zero):
    """Chunk 64 over two whole chunks, a 40-token prompt (the single-chunk
    fallback the CPU serving tests take) and chunk 4, from zero states and
    from drawn ones."""
    tcfg = layer["tcfg"]
    x = _x(tcfg, t, seed=t)
    s0, c0 = _states(tcfg, seed=t + 1, zero=zero)
    kw = {} if zero else dict(state=s0, conv_state=c0)
    jy, js, jc = jmamba2.mamba2_seq(layer["w"], x, layer["jcfg"], chunk=chunk,
                                    **kw)
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    y, s, c = mamba2.mamba2_seq(layer["t"], torch.from_numpy(x), tcfg,
                                chunk=chunk, **tkw)
    assert s.dtype == torch.float32
    for got, want, name in ((y, jy, "y"), (s, js, "ssm"), (c, jc, "conv")):
        assert tuple(got.shape) == np.shape(want), name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("zero", [True, False])
def test_mamba2_step_matches_reference(layer, zero):
    """Five decode steps, each from the state the last one left."""
    tcfg = layer["tcfg"]
    s, c = _states(tcfg, seed=11, zero=zero)
    ts, tc = torch.from_numpy(s), torch.from_numpy(c)
    x = _x(tcfg, 5, seed=12)
    for i in range(5):
        jy, s, c = jmamba2.mamba2_step(layer["w"], x[:, i], layer["jcfg"], s,
                                       c)
        y, ts, tc = mamba2.mamba2_step(layer["t"], torch.from_numpy(x[:, i]),
                                       tcfg, ts, tc)
        for got, want, name in ((y, jy, "y"), (ts, s, "ssm"),
                                (tc, c, "conv")):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                       err_msg=f"step {i} {name}")


def test_mamba2_seq_matches_stepwise():
    """The reference's own contract, re-pointed at the port: full-sequence
    SSD equals the token-by-token recurrence, conv state included (the
    reference's tolerance, 3e-4)."""
    _, cfg = _configs()
    from repro_torch.models.common import Initializer

    g = torch.Generator().manual_seed(0)
    p = mamba2.init_mamba2(Initializer(g, torch.float32), cfg)
    bsz, t = 2, 12
    x = torch.randn((bsz, t, cfg.d_model), generator=g) * 0.3
    y_seq, s_seq, conv_seq = mamba2.mamba2_seq(p, x, cfg, chunk=4)

    d_in, h, pp, n = mamba2.dims(cfg)
    s = torch.zeros((bsz, h, pp, n))
    cs = torch.zeros((bsz, cfg.ssm_conv_width - 1, d_in + 2 * n))
    ys = []
    for i in range(t):
        y, s, cs = mamba2.mamba2_step(p, x[:, i], cfg, s, cs)
        ys.append(y)
    y_step = torch.stack(ys, dim=1)
    for got, want in ((y_seq, y_step), (s_seq, s), (conv_seq, cs)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=3e-4,
                                   atol=3e-4)


def test_init_matches_reference_shapes():
    jcfg, tcfg = _configs()
    b = ParamBuilder(jax.random.PRNGKey(0), jnp.float32)
    jmamba2.init_mamba2(b, jcfg)
    want, _ = b.build()
    from repro_torch.models.common import Initializer

    got = mamba2.init_mamba2(
        Initializer(torch.Generator().manual_seed(0), torch.float32), tcfg)
    assert {n: tuple(t.shape) for n, t in got.items()} == \
        {n: a.shape for n, a in want.items()}
    for name in ("ln", "conv_b", "a_log", "d_skip", "dt_bias", "out_norm"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]),
                                      err_msg=name)
