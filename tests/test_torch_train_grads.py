"""The port's training forward held to the reference's loss and gradients.

The six smoke configs that the serving tests hold (a GQA group of 3 for the
dense one) run in float32 on one ``SyntheticLM`` batch of 2 x 64 tokens
(vlm: 8 patches ahead of them), so rwkv6's WKV takes ``wkv_chunked`` and
zamba2's Mamba2 one whole chunk.  The weights are drawn by the port's
seeded ``init`` and cross to the reference through ``params_to_numpy``:
the reference's own ``init`` folds ``hash(name)`` into its keys, which
Python salts in every process, so its weights differ from run to run.

* ``train_loss`` within 1e-5 relative of ``jax.value_and_grad``'s loss;
* every gradient leaf, brought back to the reference's layout by
  ``params_to_numpy``, within 1e-4 times that leaf's largest absolute
  value, plus 1e-7, of ``jax.grad``'s.  For rwkv6 the yardstick is the
  reference's gradient through its ``wkv_scan`` (the same function);
* where the reference's chunked forms overflow: its ``wkv_chunked`` and
  Mamba2 chunk take the exp of the pairwise decay sums above the diagonal
  too and mask after it, so at strong decays a 64-token chunk holds inf
  there and the gradient is NaN (0 * inf).  The port's masks the exponent
  first (the forward is the same to the bit): its gradients stay finite
  and equal an evaluation that takes no such exp (the reference's
  ``wkv_scan``; the port's Mamba2 one token at a time, ``mamba2_step``);
* ``remat="full"`` gives the same loss and gradients as ``"none"`` (equal
  to the bit: the recomputation runs the same operations on the same
  inputs);
* attention taken a query chunk at a time (``q_chunk`` 16, T >= 2 chunks)
  equals the whole-sequence attention within 1e-6, and the reference's
  loss with the same chunk within 1e-5;
* rwkv6 through ``wkv_scan`` (a runtime whose ``rwkv_chunked`` is false,
  read as the reference reads it) against the reference's scan;
* ``forward`` and its backward launch no kernel (the ``ops`` counters stay
  at 0), and ``ops.mha`` and ``ops.wkv6`` refuse inputs that require grad;
* ``params_to_numpy`` after ``params_from_numpy`` gives the reference's
  tree back bit for bit, bfloat16 included.

The two packages sum in other orders (XLA and ATen reductions, the moe
combine's gather against the reference's scatter-add), which moves float32
values by about 1e-6 of their scale.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jmodels
import repro_torch.configs as tconfigs
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels import ops
from repro_torch.models import Runtime, get_model, mamba2, zamba2
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.train.optimizer import tree_leaves, tree_map

OVERRIDES = {"qwen3-14b-smoke": dict(n_heads=6, n_kv_heads=2),
             "rwkv6-3b-smoke": {},
             "qwen3-moe-30b-a3b-smoke": {},
             "zamba2-2.7b-smoke": {},
             "musicgen-large-smoke": {},
             "paligemma-3b-smoke": {}}
ATTENTION = [arch for arch in OVERRIDES if not arch.startswith("rwkv6")]
BATCH, SEQ = 2, 64
LOSS_RTOL = 1e-5
# a runtime whose ``rwkv_chunked`` is false, read by both packages' rwkv6
SCAN = types.SimpleNamespace(rwkv_chunked=False, remat="none")
GRAD_REL, GRAD_ATOL = 1e-4, 1e-7


def _configs(arch, dtype="float32"):
    kw = dict(OVERRIDES[arch], dtype=dtype)
    return (jconfigs.get_config(arch).replace(**kw),
            tconfigs.get_config(arch).replace(**kw))


def _weights(tcfg, seed: int):
    """Seeded weights from the port's ``init``, as the reference's numpy
    tree and as its jax arrays."""
    tree = params_to_numpy(tcfg, get_model(tcfg).init(seed, device="cpu"))
    return tree, jax.tree.map(jnp.asarray, tree)


def _batch(cfg) -> dict:
    """One SyntheticLM batch in the family's layout (numpy)."""
    audio, vlm = cfg.family == "audio", cfg.family == "vlm"
    return SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH, seed=3,
        n_codebooks=cfg.n_codebooks if audio else 0,
        n_patches=cfg.n_patches if vlm else 0,
        vision_embed_dim=cfg.vision_embed_dim if vlm else 0)).batch_at(0)


def _port_loss_and_grads(tcfg, tree, batch, rt):
    """The port's loss and gradients (in the reference's layout) on the
    reference's numpy parameter tree."""
    params = params_from_numpy(tcfg, tree, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    loss = get_model(tcfg).train_loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()}, rt)
    loss.backward()
    grads = tree_map(lambda p: p.grad, params)
    return float(loss.detach()), params_to_numpy(tcfg, grads)


def _ref_loss_and_grads(jcfg, jparams, batch, rt):
    jmodel = jmodels.get_model(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.train_loss(p, jb, rt)))(jparams)
    return float(loss), jax.tree.map(np.asarray, grads)


def _pairs(ref, port, path=""):
    """(path, reference leaf, port leaf) over two trees of dictionaries."""
    assert isinstance(port, dict) == isinstance(ref, dict), path
    if not isinstance(ref, dict):
        yield path, ref, port
        return
    assert set(port) == set(ref), (path, sorted(port), sorted(ref))
    for name in ref:
        yield from _pairs(ref[name], port[name], f"{path}/{name}")


def _assert_grads_close(want, got):
    for path, w, g in _pairs(want, got):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        tol = GRAD_REL * float(np.abs(w).max()) + GRAD_ATOL
        err = float(np.abs(g - w).max())
        assert err <= tol, f"{path}: |port - ref| {err:g} > {tol:g}"


@pytest.fixture(scope="module", params=list(OVERRIDES))
def run(request):
    """The reference's and the port's loss and gradients at the default
    runtime, on one converted parameter set and batch."""
    jcfg, tcfg = _configs(request.param)
    tree, jparams = _weights(tcfg, 0)
    batch = _batch(tcfg)
    ref_rt = SCAN if tcfg.family == "ssm" else jmodels.Runtime()
    return {"arch": request.param, "tcfg": tcfg, "jcfg": jcfg,
            "jparams": jparams, "tree": tree, "batch": batch,
            "ref": _ref_loss_and_grads(jcfg, jparams, batch, ref_rt),
            "port": _port_loss_and_grads(tcfg, tree, batch, Runtime())}


def test_loss_equals_reference(run):
    (want, _), (got, _) = run["ref"], run["port"]
    assert np.isfinite(got) and got > 0
    assert abs(got - want) <= LOSS_RTOL * abs(want), (got, want)


def test_grads_equal_reference(run):
    _assert_grads_close(run["ref"][1], run["port"][1])


def test_remat_full_equals_none(run):
    loss, grads = _port_loss_and_grads(run["tcfg"], run["tree"],
                                       run["batch"], Runtime(remat="full"))
    assert loss == run["port"][0]
    for path, want, got in _pairs(run["port"][1], grads):
        np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("arch", ATTENTION)
def test_q_chunk_taken_equals_not_taken(arch):
    jcfg, tcfg = _configs(arch)
    tree, jparams = _weights(tcfg, 1)
    batch = _batch(tcfg)
    chunk = 16 if tcfg.family != "vlm" else 8     # 72 positions: 9 chunks
    whole = _port_loss_and_grads(tcfg, tree, batch, Runtime(q_chunk=0))
    chunked = _port_loss_and_grads(tcfg, tree, batch, Runtime(q_chunk=chunk))
    assert abs(chunked[0] - whole[0]) <= 1e-6 * abs(whole[0])
    for path, want, got in _pairs(whole[1], chunked[1]):
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(want).max()),
                                   err_msg=path)
    ref, _ = _ref_loss_and_grads(jcfg, jparams, batch,
                                 jmodels.Runtime(q_chunk=chunk))
    assert abs(chunked[0] - ref) <= LOSS_RTOL * abs(ref), (chunked[0], ref)


def test_rwkv_scan_path_equals_reference():
    """A runtime whose ``rwkv_chunked`` is false sends both packages through
    the sequential ``wkv_scan``."""
    jcfg, tcfg = _configs("rwkv6-3b-smoke")
    tree, jparams = _weights(tcfg, 2)
    batch = _batch(tcfg)
    want_loss, want = _ref_loss_and_grads(jcfg, jparams, batch, SCAN)
    got_loss, got = _port_loss_and_grads(tcfg, tree, batch, SCAN)
    assert abs(got_loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    _assert_grads_close(want, got)


def _mamba2_by_steps(p, x, cfg):
    """``mamba2_seq`` from a zero state as the exact recurrence, one
    ``mamba2_step`` a token: no exp of a positive decay sum."""
    b, t, _ = x.shape
    d_in, h, pp, n = mamba2.dims(cfg)
    state = x.new_zeros((b, h, pp, n), dtype=torch.float32)
    conv = x.new_zeros((b, cfg.ssm_conv_width - 1, d_in + 2 * n))
    ys = []
    for i in range(t):
        y, state, conv = mamba2.mamba2_step(p, x[:, i], cfg, state, conv)
        ys.append(y)
    return torch.stack(ys, dim=1), state, conv


@pytest.mark.parametrize("arch,seed", [("rwkv6-3b-smoke", 0),
                                       ("zamba2-2.7b-smoke", 1)])
def test_chunked_grads_finite_where_reference_overflows(arch, seed,
                                                        monkeypatch):
    jcfg, tcfg = _configs(arch)
    tree, jparams = _weights(tcfg, seed)
    batch = _batch(tcfg)
    _, ref = _ref_loss_and_grads(jcfg, jparams, batch, jmodels.Runtime())
    assert not all(np.isfinite(g).all() for _, g, _ in _pairs(ref, ref))
    loss, got = _port_loss_and_grads(tcfg, tree, batch, Runtime())
    assert all(np.isfinite(g).all() for _, g, _ in _pairs(got, got))
    if tcfg.family == "ssm":
        want_loss, want = _ref_loss_and_grads(jcfg, jparams, batch, SCAN)
    else:
        monkeypatch.setattr(zamba2, "mamba2_seq", _mamba2_by_steps)
        want_loss, want = _port_loss_and_grads(tcfg, tree, batch, Runtime())
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    _assert_grads_close(want, got)


@pytest.mark.parametrize("arch", list(OVERRIDES))
def test_forward_launches_no_kernel(arch):
    _, tcfg = _configs(arch)
    model = get_model(tcfg)
    params = model.init(0, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
    ops.reset_launches()
    model.train_loss(params, batch, Runtime(remat="full")).backward()
    assert all(p.grad is not None for p in tree_leaves(params))
    assert {fn.__name__: fn.launches
            for fn in ops.WRAPPERS + ops.LLM_WRAPPERS} == dict.fromkeys(
        ("pchase_batch", "eviction_batch", "stream_read", "stream_write",
         "mha", "wkv6", "pchase"), 0)


def _attention_inputs():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 32, 4, 16, generator=g)
    kv = [torch.randn(1, 32, 2, 16, generator=g) for _ in range(2)]
    return q, *kv


def _wkv_inputs():
    g = torch.Generator().manual_seed(1)
    r, k, v = (torch.randn(1, 32, 2, 8, generator=g) for _ in range(3))
    w = torch.rand(1, 32, 2, 8, generator=g) * 0.5 + 0.4
    return r, k, v, w, torch.randn(2, 8, generator=g)


@pytest.mark.parametrize("kernel,which", [("mha", 0), ("mha", 2),
                                          ("wkv6", 0), ("wkv6", 3),
                                          ("wkv6", 4)])
def test_kernels_refuse_inputs_that_require_grad(kernel, which):
    """The kernels have no backward: an input that requires grad is refused
    while grad mode is on, and nothing is counted; under ``no_grad`` the
    same call runs."""
    fn = getattr(ops, kernel)
    args = list(_attention_inputs() if kernel == "mha" else _wkv_inputs())
    args[which].requires_grad_(True)
    ops.reset_launches()
    with pytest.raises(RuntimeError, match="requires grad"):
        fn(*args)
    assert fn.launches == 0
    with torch.no_grad():
        out = fn(*args)
    assert fn.launches == 1
    first = out[0] if isinstance(out, tuple) else out
    assert first.grad_fn is None and bool(torch.isfinite(first).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", list(OVERRIDES))
def test_params_round_trip_bit_exact(arch, dtype):
    jcfg, tcfg = _configs(arch, dtype)
    jparams, _ = jmodels.get_model(jcfg).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.array, jparams)
    back = params_to_numpy(tcfg, params_from_numpy(tcfg, tree, device="cpu"))
    for path, want, got in _pairs(tree, back):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path
