"""Expert-parallel MoE of the port (``repro_torch.models.moe_ep``) on
``gloo`` ranks on the CPU.

The reference's three ``tests/test_moe_ep.py`` cases re-pointed at the port:
``moe_ffn_ep`` equals the port's ``moe_ffn`` on meshes (1,), (4,) and
(2, 2) at capacity factor 8 (outputs within rtol/atol 2e-5, router
probabilities within 1e-6), its gradients are finite and non-zero on 2
ranks, and at factor 1.0, where pairs drop, its output stays finite.
Beyond them:

* at factor 1.0 the port's EP on 2 ranks against the reference's
  ``moe_ffn_ep`` on a (2,) mesh of host devices (a subprocess with
  ``--xla_force_host_platform_device_count=2``), on the same numpy
  weights and inputs, within 2e-5: both drop the same pairs;
* ``remat="save_a2a"`` gives the gradients of ``remat="full"`` with
  fewer all-to-alls in the backward (the forward's three a layer are not
  issued again: 2 against 5);
* the qwen3-moe smoke config's ``train_loss`` with ``moe_impl="ep"`` on a
  2x2 mesh equals the sorted dispatch's at factor 8, gradients too;
* with no mesh, ``Runtime(moe_impl="ep")`` and the default ``Runtime``
  leave ``prefill`` and ``decode_step`` bit for bit as they are without
  one.

The weights are drawn by numpy from a seed, so both packages and every
rank read the same ones.  Each multi-rank case runs its ranks as
``subprocess``es on a free local port, with a timeout, as
``tests/test_torch_elastic.py`` does, and reads rank 0's last line.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen3-moe-30b-a3b"
MESHES = {"1": ((1,), ("data",)), "4": ((4,), ("data",)),
          "2x2": ((2, 2), ("data", "model"))}
RANK_MESHES = {**MESHES, "2": ((2,), ("data",))}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(code: str, ranks: int, args=(), env_extra=None,
         timeout: float = 240) -> dict:
    """Run ``code`` as ``ranks`` processes of one ``gloo`` group
    (``torchrun``'s environment) -> rank 0's last line of output, parsed;
    kills them all if one fails or the time runs out."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", **(env_extra or {}))
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT"):
        env.pop(name, None)
    port = _free_port()
    procs = []
    for rank in range(ranks):
        env.update(RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(ranks), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(code), *map(str, args)],
            cwd=ROOT, env=dict(env), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {rank} exited {rc}:\n{err[-3000:]}"
    return json.loads(outs[0][1].strip().splitlines()[-1])


def _weights(path, cf: float, experts=8, top_k=2, seed=0) -> None:
    """The moe weights and input of the reference's ``_setup`` shapes,
    drawn by numpy (fan-in scaled normals) and saved to ``path``."""
    from repro_torch.configs import get_config

    cfg = get_config(ARCH).smoke()
    d, ff = cfg.d_model, cfg.d_ff
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[0])
                ).astype(np.float32)

    np.savez(path, router=normal(d, experts), w1=normal(experts, d, ff),
             w3=normal(experts, d, ff), w2=normal(experts, ff, d),
             x=(rng.standard_normal((4, 16, d)) * 0.3).astype(np.float32),
             cf=np.float32(cf), experts=experts, top_k=top_k)


# Each rank: the weights of _weights() from the file argv[1], the port's
# moe_ffn and moe_ffn_ep on each mesh named in argv[2:]; on the (2,) mesh
# also its output (saved beside the weights) and its gradients under full
# remat and save_a2a, with the all-to-alls each backward issues
_RANK = """
    import json, sys
    import numpy as np
    import torch, torch.distributed as dist
    from repro_torch.analysis.trace import StepTrace
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_process_group
    from repro_torch.models.moe import moe_ffn
    from repro_torch.models.moe_ep import moe_ffn_ep, save_a2a_contexts
    from torch.distributed.device_mesh import init_device_mesh
    from torch.utils.checkpoint import checkpoint

    MESHES = {meshes!r}
    w = np.load(sys.argv[1])
    cfg = get_config("{arch}").smoke().replace(
        dtype="float32", moe_experts=int(w["experts"]),
        moe_top_k=int(w["top_k"]), moe_capacity_factor=float(w["cf"]))
    p = {{k: torch.from_numpy(w[k]) for k in ("router", "w1", "w3", "w2")}}
    x = torch.from_numpy(w["x"])
    init_process_group("cpu", dist.get_world_size()
                       if dist.is_initialized() else 1)
    out = {{}}
    y0, p0 = moe_ffn(p, x, cfg)
    for name in sys.argv[2:]:
        shape, axes = MESHES[name]
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
        y1, p1 = moe_ffn_ep(p, x, cfg, mesh)
        y1, p1 = y1.full_tensor(), p1.full_tensor()
        out[name] = {{
            "y": float((y1 - y0).abs().max()), "y_max": float(y0.abs().max()),
            "probs": float((p1 - p0).abs().max()),
            "finite": bool(torch.isfinite(y1).all()),
            "placements": [str(q) for q in
                           moe_ffn_ep(p, x, cfg, mesh)[0].placements]}}
        if name == "2":
            np.save(sys.argv[1] + ".port.npy", y1.numpy())

            def grads(context_fn):
                pp = {{k: v.clone().requires_grad_(True)
                      for k, v in p.items()}}
                xx = x.clone().requires_grad_(True)
                f = lambda pp, xx: moe_ffn_ep(pp, xx, cfg, mesh)[0]
                kw = {{}} if context_fn is None else \\
                    {{"context_fn": context_fn}}
                y = checkpoint(f, pp, xx, use_reentrant=False, **kw)
                loss = y.square().sum()
                with StepTrace() as tr:
                    g = torch.autograd.grad(loss, [*pp.values(), xx])
                g = [t.full_tensor() if hasattr(t, "full_tensor") else t
                     for t in g]
                return g, tr.collectives.count_by_op.get("all-to-all", 0)

            full, n_full = grads(None)
            saved, n_saved = grads(save_a2a_contexts)
            out["grads"] = {{
                "finite": all(bool(torch.isfinite(t).all()) for t in full),
                "nonzero": any(float(t.abs().max()) > 0 for t in full),
                "save_a2a_diff": max(float((a - b).abs().max())
                                     for a, b in zip(full, saved)),
                "a2a_full": n_full, "a2a_save": n_saved}}
    print(json.dumps(out))
"""

# The reference's moe_ffn_ep on a (2,) mesh of host devices
_REFERENCE = """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.compat import make_mesh
    from repro.configs import get_config
    from repro.models.moe_ep import moe_ffn_ep

    w = np.load(sys.argv[1])
    cfg = get_config("{arch}").smoke().replace(
        dtype="float32", moe_experts=int(w["experts"]),
        moe_top_k=int(w["top_k"]), moe_capacity_factor=float(w["cf"]))
    p = {{k: jnp.asarray(w[k]) for k in ("router", "w1", "w3", "w2")}}
    mesh = make_mesh((2,), ("data",))
    y, _ = jax.jit(lambda pp, xx: moe_ffn_ep(pp, xx, cfg, mesh))(
        p, jnp.asarray(w["x"]))
    np.save(sys.argv[1] + ".reference.npy", np.asarray(y))
    print("{{}}")
"""


def _rank_code() -> str:
    return _RANK.format(meshes=RANK_MESHES, arch=ARCH)


@pytest.fixture(scope="module")
def cf8(tmp_path_factory):
    """EP against moe_ffn at factor 8 on every mesh, and the gradients on
    2 ranks: {mesh name: errors}."""
    path = str(tmp_path_factory.mktemp("moe_ep") / "cf8.npz")
    _weights(path, 8.0)
    out = _run(_rank_code(), 1, [path, "1"])
    out.update(_run(_rank_code(), 4, [path, "4", "2x2"]))
    out.update(_run(_rank_code(), 2, [path, "2"]))
    return out


@pytest.fixture(scope="module")
def cf1(tmp_path_factory):
    """The port's and the reference's EP at factor 1.0 on 2 devices."""
    path = str(tmp_path_factory.mktemp("moe_ep") / "cf1.npz")
    _weights(path, 1.0)
    out = _run(_rank_code(), 2, [path, "2"])
    _run(_REFERENCE.format(arch=ARCH), 1,
         [path], env_extra={"JAX_PLATFORMS": "cpu"}, timeout=300)
    out["port"] = np.load(path + ".port.npy")
    out["reference"] = np.load(path + ".reference.npy")
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
def test_ep_matches_gspmd(cf8, mesh):
    got = cf8[mesh]
    assert got["y"] <= 2e-5 + 2e-5 * got["y_max"], got
    assert got["probs"] <= 1e-6, got
    batch = "S(0)" if MESHES[mesh][1][0] == "data" else "R"
    assert got["placements"][0] == batch


def test_ep_gradients_flow(cf8):
    assert cf8["grads"]["finite"] and cf8["grads"]["nonzero"], cf8["grads"]


def test_ep_capacity_drops_are_bounded(cf1):
    assert cf1["2"]["finite"]
    assert np.all(np.isfinite(cf1["port"]))


def test_ep_drops_as_the_reference_at_cf1(cf1):
    """Pairs drop at factor 1.0 (the output leaves moe_ffn's) and the port
    drops the reference's: the two EP outputs agree within 2e-5."""
    assert cf1["2"]["y"] > 1e-3, "no pair dropped at factor 1.0"
    np.testing.assert_allclose(cf1["port"], cf1["reference"], rtol=2e-5,
                               atol=2e-5)


def test_save_a2a_replays_no_forward_exchange(cf8):
    """save_a2a's gradients are full remat's; its backward issues only the
    two activation exchanges' reverse all-to-alls, where full remat also
    replays the forward's three."""
    got = cf8["grads"]
    assert got["save_a2a_diff"] == 0.0, got
    assert (got["a2a_full"], got["a2a_save"]) == (5, 2), got


_TRAIN = """
    import json
    import numpy as np
    import torch, torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_process_group, make_debug_mesh
    from repro_torch.models import Runtime, get_model
    from repro_torch.sharding import TRAIN_RULES, tree_shardings
    from repro_torch.sharding.context import activation_sharding, distribute
    from repro_torch.train.optimizer import tree_leaves

    init_process_group("cpu", 4)
    mesh = make_debug_mesh((2, 2), device_type="cpu")
    cfg = get_config("{arch}").smoke().replace(dtype="float32",
                                               moe_capacity_factor=8.0)
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    params = distribute(params, tree_shardings(
        params, model.param_specs(), TRAIN_RULES, mesh))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (4, 17))
    batch = {{"tokens": torch.from_numpy(toks[:, :-1]),
              "targets": torch.from_numpy(toks[:, 1:])}}
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    got = {{}}
    for impl in ("ep", "gspmd"):
        with activation_sharding(mesh, TRAIN_RULES):
            loss = model.train_loss(params, batch,
                                    Runtime(moe_impl=impl, remat="full"))
            grads = torch.autograd.grad(loss, leaves)
        got[impl] = (float(loss.full_tensor()),
                     [g.full_tensor() for g in grads])
    (a, ga), (b, gb) = got["ep"], got["gspmd"]
    print(json.dumps({{"ep": a, "gspmd": b, "grad": max(
        float((x - y).abs().max() / y.abs().max().clamp(min=1e-30))
        for x, y in zip(ga, gb))}}))
"""


def test_qwen3_moe_smoke_train_loss_ep_matches_gspmd_on_2x2():
    out = _run(_TRAIN.format(arch=ARCH), 4)
    assert out["ep"] == pytest.approx(out["gspmd"], rel=1e-5, abs=1e-6), out
    assert out["grad"] <= 1e-4, out


def test_default_runtime_leaves_serve_bit_for_bit():
    """With no mesh, prefill and decode_step give the same logits and
    cache bit for bit with no runtime, the default one and moe_impl="ep"
    (which takes the sorted dispatch without a mesh)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Runtime, get_model

    cfg = get_config(ARCH).smoke().replace(dtype="float32")
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 12)))
    runs = []
    for rt in (None, Runtime(), Runtime(moe_impl="ep")):
        kw = {} if rt is None else {"rt": rt}
        with torch.no_grad():
            logits, cache = model.prefill(params, {"tokens": toks}, 16, **kw)
            step, cache = model.decode_step(
                params, {"tokens": torch.argmax(logits, -1)[:, None]},
                cache, **kw)
        runs.append((logits, step, cache["k"], cache["v"]))
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))


def test_remat_recompute_keeps_the_sharding_context():
    """On the card the autograd engine recomputes a checkpointed layer on
    a thread of its own; the recompute runs in the forward call's context
    variables, so under a mesh it takes the same moe path (``moe_ffn_ep``)
    and saves the same tensors."""
    import threading
    from types import SimpleNamespace

    from repro_torch.models.common import remat_layer
    from repro_torch.sharding import TRAIN_RULES
    from repro_torch.sharding.context import (activation_sharding,
                                              current_mesh)

    mesh, seen = SimpleNamespace(), []

    def fn(x):
        seen.append(current_mesh())
        return x * x

    x = torch.ones(3, requires_grad=True)
    with activation_sharding(mesh, TRAIN_RULES):
        y = remat_layer(fn, True)(x).sum()
    worker = threading.Thread(target=y.backward)
    worker.start()
    worker.join()
    assert seen == [mesh, mesh]
    assert torch.equal(x.grad, 2 * x.detach())
