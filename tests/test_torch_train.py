"""The port's optimizer, train loop, data and gradient compression.

The reference's ``tests/test_substrate.py`` cases for these re-pointed at
``repro_torch`` (``TestOptimizer``, ``TestData``, ``TestCompression``;
``compressed_psum`` on a single rank), then held to the reference on the
same inputs:

* ``SyntheticLM`` (plain, audio and vlm layouts) and ``ByteCorpus``
  batches bit-equal to ``repro.data``'s at several steps and hosts;
* ``quantize`` and ``compress_with_feedback`` bit-equal, and one-rank
  ``compressed_psum`` equal to the reference's inside a one-device
  ``shard_map``;
* ``lr_at`` within one float32 ulp over the warmup and within four over
  the cosine: XLA's and ATen's float32 ``cos`` are each within an ulp of
  the rounded cosine but part at some arguments, and
  ``1 + cos(pi t)`` loses the leading digits towards the end;
* three ``train_loop`` steps of the internlm2 smoke config from the same
  weights (drawn by the port's seeded ``init``; the reference's own
  ``init`` salts its keys with ``hash``) and the same ``ByteCorpus``
  batches.  Float32, one and two microbatches: per-step loss within 1e-5
  relative, ``grad_norm`` within 1e-4 relative, and each parameter leaf
  within 1e-4 of its largest absolute value plus 1e-6 (per leaf, as the
  gradients are held: AdamW's first steps move an element by about
  lr * g / (|g| + eps) whatever its |g|, so an element whose gradient is
  within the roundoff of 0 moves by an amount set by that roundoff).
  bfloat16 parameters with a float32 master: loss within 1e-3 and
  ``grad_norm`` within 5e-3 relative; each master leaf's change over the
  three steps within 0.1 of the reference's change in the 2-norm (both
  packages round activations to bfloat16 at other points, so the sign of
  a near-zero gradient can flip between them and move that element the
  other way: the norms part by 0.04 at most on this model, while a step
  left out parts them by 0.3 or more); and the bfloat16 parameters
  bit-equal to the port's master rounded to bfloat16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.data as jdata
import repro.models as jmodels
import repro.train as jtrain
from repro.compat import shard_map
from repro.train import grad_compress as jgrad_compress
from repro.train import optimizer as joptimizer
import repro_torch.configs as tconfigs
from repro_torch.data import ByteCorpus, DataConfig, SyntheticLM
from repro_torch.models import get_model
from repro_torch.models.convert import params_to_numpy
from repro_torch.train import (OptConfig, TrainConfig, compress_with_feedback,
                               compressed_psum, dequantize, init_train_state,
                               lr_at, make_train_step, quantize, train_loop)
from repro_torch.train.optimizer import (apply_updates, init_opt_state,
                                         opt_state_specs,
                                         tree_leaves, tree_map)


def _tiny_setup(microbatches=1, steps_total=64):
    cfg = tconfigs.get_config("internlm2-1.8b").smoke().replace(
        dtype="float32")
    model = get_model(cfg)
    tc = TrainConfig(
        opt=OptConfig(lr=3e-3, warmup_steps=4, total_steps=steps_total,
                      master_f32=True),
        microbatches=microbatches, ckpt_every=4)
    data = ByteCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                 global_batch=8))
    return cfg, model, tc, data


def _clone(state):
    return tree_map(lambda t: t.detach().clone(), state)


class TestOptimizer:
    def test_lr_schedule(self):
        oc = OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                       min_lr_ratio=0.1)
        assert float(lr_at(oc, 0)) == 0.0
        assert float(lr_at(oc, 10)) == pytest.approx(1.0, rel=1e-5)
        assert float(lr_at(oc, torch.tensor(100, dtype=torch.int32))) \
            == pytest.approx(0.1, rel=1e-4)

    def test_training_reduces_loss(self):
        cfg, model, tc, data = _tiny_setup()
        state = init_train_state(model, 0, tc, device="cpu")
        state, hist = train_loop(model, tc, data, steps=30, state=state)
        first = np.mean([m["loss"] for _, m in hist[:3]])
        last = np.mean([m["loss"] for _, m in hist[-3:]])
        assert last < first * 0.8, (first, last)
        assert [s for s, _ in hist] == list(range(30))
        assert all(set(m) == {"loss", "lr", "grad_norm", "step_time_s"}
                   for _, m in hist)

    def test_grad_accum_equivalence(self):
        """microbatches=4 must match microbatches=1 numerically (f32)."""
        cfg, model, tc1, data = _tiny_setup(microbatches=1)
        tc4 = TrainConfig(opt=tc1.opt, microbatches=4)
        s1 = init_train_state(model, 1, tc1, device="cpu")
        s4 = _clone(s1)
        batch = data.batch_at(0)
        s1, m1 = make_train_step(model, tc1)(s1, batch)
        s4, m4 = make_train_step(model, tc4)(s4, batch)
        np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                                   rtol=1e-5)
        for a, b in zip(tree_leaves(s1["params"]),
                        tree_leaves(s4["params"])):
            np.testing.assert_allclose(a.detach().numpy(),
                                       b.detach().numpy(),
                                       rtol=2e-4, atol=2e-5)


class TestData:
    def test_determinism_and_restartability(self):
        d = SyntheticLM(DataConfig(vocab_size=100, seq_len=16, global_batch=4))
        b1, b2 = d.batch_at(7), d.batch_at(7)
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
        assert not np.array_equal(d.batch_at(8)["tokens"], b1["tokens"])

    def test_host_sharding_disjoint(self):
        def mk(h):
            return SyntheticLM(DataConfig(vocab_size=1000, seq_len=8,
                                          global_batch=8, n_hosts=2,
                                          host_id=h))
        a, b = mk(0).batch_at(3), mk(1).batch_at(3)
        assert a["tokens"].shape == (4, 8)
        assert not np.array_equal(a["tokens"], b["tokens"])

    def test_targets_are_shifted_tokens(self):
        d = ByteCorpus(DataConfig(vocab_size=256, seq_len=16, global_batch=2))
        b = d.batch_at(0)
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["targets"][:, :-1])


class TestCompression:
    def test_quantize_roundtrip_error_bound(self):
        x = np.random.default_rng(0).normal(size=(256,)).astype(np.float32)
        q, s = quantize(torch.from_numpy(x), bits=8)
        err = np.abs(dequantize(q, s).numpy() - x)
        assert err.max() <= float(s) * 0.5 + 1e-7

    def test_error_feedback_reduces_bias(self):
        """Accumulated error feedback keeps the long-run mean unbiased."""
        rng = np.random.default_rng(1)
        true_sum = np.zeros(64, np.float32)
        fed_sum = np.zeros(64, np.float32)
        err = torch.zeros(64)
        for _ in range(200):
            g = rng.normal(size=64).astype(np.float32) * 1e-3
            true_sum += g
            q, s, err = compress_with_feedback(torch.from_numpy(g), err,
                                               bits=8)
            fed_sum += dequantize(q, s).numpy()
        resid = np.abs(fed_sum + err.numpy() - true_sum).max()
        assert resid < 1e-4

    def test_compressed_psum_single_device(self):
        g = torch.linspace(-1, 1, 32)
        out, err = compressed_psum(g, torch.zeros(32))
        np.testing.assert_allclose(out.numpy(), g.numpy(), atol=1e-2)
        np.testing.assert_allclose((out + err).numpy(), g.numpy(),
                                   atol=1e-6)


# ------------------------------------------------------------ cross-checks
def _data_configs():
    return {
        "plain": dict(vocab_size=1000, seq_len=24, global_batch=8),
        "audio": dict(vocab_size=64, seq_len=16, global_batch=4,
                      n_codebooks=4),
        "vlm": dict(vocab_size=256, seq_len=12, global_batch=4, n_patches=8,
                    vision_embed_dim=24),
    }


@pytest.mark.parametrize("layout", ["plain", "audio", "vlm"])
def test_synthetic_batches_equal_reference(layout):
    for seed, n_hosts in ((0, 1), (5, 2), (11, 4)):
        for host in range(n_hosts):
            kw = dict(_data_configs()[layout], seed=seed, n_hosts=n_hosts,
                      host_id=host)
            port = SyntheticLM(DataConfig(**kw))
            ref = jdata.SyntheticLM(jdata.DataConfig(**kw))
            for step in (0, 1, 7, 123):
                got, want = port.batch_at(step), ref.batch_at(step)
                assert set(got) == set(want)
                for name in want:
                    assert got[name].dtype == want[name].dtype, name
                    np.testing.assert_array_equal(got[name], want[name])


def test_byte_corpus_batches_equal_reference():
    for seq, batch, n_hosts in ((16, 2, 1), (32, 8, 2), (512, 8, 1)):
        for host in range(n_hosts):
            kw = dict(vocab_size=256, seq_len=seq, global_batch=batch,
                      seed=3, n_hosts=n_hosts, host_id=host)
            port = ByteCorpus(DataConfig(**kw))
            ref = jdata.ByteCorpus(jdata.DataConfig(**kw))
            np.testing.assert_array_equal(port.data, ref.data)
            for step in (0, 4, 99):
                got, want = port.batch_at(step), ref.batch_at(step)
                for name in ("tokens", "targets"):
                    assert got[name].dtype == want[name].dtype
                    np.testing.assert_array_equal(got[name], want[name])


@pytest.mark.parametrize("bits", [8, 16])
def test_quantize_and_feedback_bit_equal_reference(bits):
    rng = np.random.default_rng(bits)
    x = (rng.normal(size=(3, 257)) * 5).astype(np.float32)
    e = (rng.normal(size=(3, 257)) * 0.01).astype(np.float32)
    q, s = quantize(torch.from_numpy(x), bits)
    jq, js = jgrad_compress.quantize(jnp.asarray(x), bits)
    assert q.numpy().dtype == np.asarray(jq).dtype
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    q, s, err = compress_with_feedback(torch.from_numpy(x),
                                       torch.from_numpy(e), bits)
    jq, js, jerr = jgrad_compress.compress_with_feedback(
        jnp.asarray(x), jnp.asarray(e), bits)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(err.numpy(), np.asarray(jerr))
    with pytest.raises(ValueError, match="bits"):
        quantize(torch.from_numpy(x), 4)


def test_compressed_psum_one_rank_equals_reference():
    g = np.linspace(-1, 1, 32, dtype=np.float32)
    e = np.random.default_rng(4).normal(size=32).astype(np.float32) * 1e-3
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("d",))
    spec = jax.sharding.PartitionSpec()
    fn = jax.jit(shard_map(
        lambda gg, ee: jgrad_compress.compressed_psum(gg, ee, "d"),
        mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec)))
    want, want_err = fn(jnp.asarray(g), jnp.asarray(e))
    got, got_err = compressed_psum(torch.from_numpy(g), torch.from_numpy(e))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(got_err.numpy(), np.asarray(want_err),
                               rtol=1e-6, atol=1e-7)


def test_lr_at_within_one_ulp_of_reference():
    for oc in (OptConfig(lr=3e-4, warmup_steps=10, total_steps=100),
               OptConfig(lr=1e-3, warmup_steps=2, total_steps=8,
                         min_lr_ratio=0.0)):
        steps = np.arange(0, oc.total_steps + 12, dtype=np.int32)
        got = np.array([float(lr_at(oc, int(s))) for s in steps], np.float32)
        want = np.array([float(joptimizer.lr_at(oc, jnp.int32(s)))
                         for s in steps], np.float32)
        ulps = np.abs(got - want) / np.spacing(np.abs(want))
        warmup = steps <= oc.warmup_steps
        assert (ulps[warmup] <= 1).all(), ulps
        assert (ulps <= 4).all(), ulps


def test_opt_state_specs_mirror_params():
    specs = {"embed": ("vocab", "embed"), "layers": [{"wq": ("embed",)}]}
    out = opt_state_specs(specs, OptConfig())
    assert out == {"m": specs, "v": specs, "step": (), "master": specs}
    assert "master" not in opt_state_specs(specs, OptConfig(master_f32=False))


def _train_pair(dtype: str, microbatches: int, steps: int = 3):
    """Three train_loop steps in each package from the same weights and
    ByteCorpus batches -> (reference history, port history, reference
    state, port state, initial params), each state ``{"params", "master"}``
    in numpy in the reference's layout (``master`` None where the
    optimizer keeps none)."""
    arch = "internlm2-1.8b"
    tcfg = tconfigs.get_config(arch).smoke().replace(dtype=dtype)
    jcfg = jconfigs.get_config(arch).smoke().replace(dtype=dtype)
    model = get_model(tcfg)
    params = model.init(7, device="cpu")
    tree = params_to_numpy(tcfg, params)
    opt = dict(lr=3e-3, warmup_steps=2, total_steps=16)
    tc = TrainConfig(opt=OptConfig(**opt), microbatches=microbatches)
    jtc = jtrain.TrainConfig(opt=jtrain.OptConfig(**opt),
                             microbatches=microbatches)
    dkw = dict(vocab_size=tcfg.vocab_size, seq_len=32, global_batch=4)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = {"params": jparams,
              "opt": joptimizer.init_opt_state(jparams, jtc.opt)}
    jdata_src = jdata.ByteCorpus(jdata.DataConfig(**dkw))
    jstate, jhist = jtrain.train_loop(jmodels.get_model(jcfg), jtc, jdata_src,
                                      steps=steps, state=jstate)
    state = {"params": params, "opt": init_opt_state(params, tc.opt)}
    assert ("master" in state["opt"]) == (dtype != "float32")
    state, hist = train_loop(model, tc, ByteCorpus(DataConfig(**dkw)),
                             steps=steps, state=state)
    want = {"params": jax.tree.map(np.asarray, jstate["params"]),
            "master": jax.tree.map(np.asarray,
                                   jstate["opt"].get("master"))}
    got = {"params": params_to_numpy(tcfg, state["params"]),
           "master": (params_to_numpy(tcfg, state["opt"]["master"])
                      if "master" in state["opt"] else None)}
    return jhist, hist, want, got, tree


def _leaves(ref, port, path=""):
    if isinstance(ref, dict):
        assert set(ref) == set(port), path
        for name in ref:
            yield from _leaves(ref[name], port[name], f"{path}/{name}")
    else:
        yield path, ref, port


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_loop_matches_reference_float32(microbatches):
    jhist, hist, want, got, _ = _train_pair("float32", microbatches)
    assert want["master"] is None and got["master"] is None
    assert [s for s, _ in hist] == [s for s, _ in jhist] == [0, 1, 2]
    for (_, jm), (_, m) in zip(jhist, hist):
        assert m["loss"] == pytest.approx(jm["loss"], rel=1e-5)
        assert m["grad_norm"] == pytest.approx(jm["grad_norm"], rel=1e-4)
        assert m["lr"] == pytest.approx(jm["lr"], rel=1e-6)
    for path, w, g in _leaves(want["params"], got["params"]):
        assert g.dtype == w.dtype == np.float32, path
        err, tol = np.abs(g - w).max(), 1e-4 * np.abs(w).max() + 1e-6
        assert err <= tol, f"{path}: {err:g} > {tol:g}"


def test_train_loop_matches_reference_bfloat16_master():
    jhist, hist, want, got, init = _train_pair("bfloat16", 2)
    for (_, jm), (_, m) in zip(jhist, hist):
        assert m["loss"] == pytest.approx(jm["loss"], rel=1e-3)
        assert m["grad_norm"] == pytest.approx(jm["grad_norm"], rel=5e-3)
    starts = {path: a for path, a, _ in _leaves(init, init)}
    for path, w, g in _leaves(want["master"], got["master"]):
        assert g.dtype == w.dtype == np.float32, path
        moved, ref_moved = g - starts[path], w - starts[path]
        err = np.linalg.norm(moved - ref_moved)
        tol = 0.1 * np.linalg.norm(ref_moved)
        assert err <= tol, f"{path}: {err:g} > {tol:g}"
    for path, m, p in _leaves(got["master"], got["params"]):
        assert p.dtype.name == "bfloat16", path
        np.testing.assert_array_equal(
            p.view(np.uint16), m.astype(p.dtype).view(np.uint16), path)


def test_train_entry_points_default_to_the_card():
    """``init_train_state`` and ``train_loop`` run on the card unless asked
    for the CPU; without one they raise, never fall back."""
    import inspect
    assert inspect.signature(init_train_state).parameters[
        "device"].default == "cuda"
    assert inspect.signature(train_loop).parameters[
        "device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg, model, tc, data = _tiny_setup()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(model, 0, tc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_loop(model, tc, data, steps=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_updates_equals_reference(dtype):
    """Two AdamW steps on given gradients (clipped: their norm is above
    ``clip_norm``) in both packages: the arithmetic in the reference's
    order gives the gradient norm within 1e-5 relative (XLA and ATen sum
    the squares in other orders, so the clip scale parts by about that),
    moments and the master within 2e-6 relative plus 2e-6 of the leaf's
    largest absolute value (the second step's moments cancel in places),
    and bfloat16 parameters within one bfloat16 ulp (a master an ulp apart
    can round the other way)."""
    tcfg = tconfigs.get_config("internlm2-1.8b").smoke().replace(dtype=dtype)
    params = get_model(tcfg).init(5, device="cpu")
    oc = OptConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    state = init_opt_state(params, oc)
    jparams = jax.tree.map(jnp.asarray, params_to_numpy(tcfg, params))
    jstate = joptimizer.init_opt_state(jparams, oc)
    assert ("master" in state) == ("master" in jstate) == (dtype != "float32")
    rng = np.random.default_rng(6)
    for _ in range(2):
        grads = tree_map(lambda p: torch.from_numpy(rng.normal(
            size=tuple(p.shape)).astype(np.float32)).to(p.dtype), params)
        jgrads = jax.tree.map(jnp.asarray, params_to_numpy(tcfg, grads))
        params, state, m = apply_updates(params, grads, state, oc)
        jparams, jstate, jm = joptimizer.apply_updates(jparams, jgrads,
                                                       jstate, oc)
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-5)
        assert float(m["grad_norm"]) > oc.clip_norm
    assert int(state["step"]) == int(jstate["step"]) == 2
    for name in ("m", "v", "master"):
        if name not in jstate:
            continue
        got = params_to_numpy(tcfg, state[name])
        want = jax.tree.map(np.asarray, jstate[name])
        for path, w, g in _leaves(want, got):
            np.testing.assert_allclose(g, w, rtol=2e-6,
                                       atol=2e-6 * np.abs(w).max(),
                                       err_msg=f"{name}{path}")
    got = params_to_numpy(tcfg, params)
    for path, w, g in _leaves(jax.tree.map(np.asarray, jparams), got):
        assert g.dtype == w.dtype, path
        w, g = w.astype(np.float32), g.astype(np.float32)
        ulp = 2.0 ** -7 if dtype == "bfloat16" else 2e-6
        np.testing.assert_allclose(g, w, rtol=ulp, atol=ulp * np.abs(w).max(),
                                   err_msg=path)
