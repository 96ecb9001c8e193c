"""The port on device meshes of several ranks: ``gloo`` processes on the CPU.

The reference's three ``tests/test_elastic.py`` cases, at 2x2 (4 ranks)
where the reference takes 4x2 and 2x4, to keep the CPU's cost down:

* elastic restore: a state laid out by ``TRAIN_RULES`` on a 2x2 mesh is
  saved on 4 ranks and restored on 2, onto the 1x2 mesh that
  ``make_subslice_mesh((2, 2), drop_data_rows=1)`` leaves, every leaf bit
  for bit, ``wq`` on the (1, 2) mesh;
* ``launch.train --mesh 2x2`` on the float32 smoke config: its losses
  within 1e-5 relative of the 1x1 run's on the same seed and batches, and
  within 1e-4 of the reference's ``train_loop`` on the same weights
  (crossed by ``convert.params_to_numpy``);
* ``launch.serve --mesh 2x2``: the greedy tokens of the 1x1 run, and a
  prefill's and a decode step's logits within 1e-4 of its.

Also ``ops.mha`` and ``ops.wkv6`` on DTensors (4 query heads to 1 kv
head on a 1x2 mesh, the heads split alike, the batch split) within 1e-5
of the plain versions on the whole tensors, with one launch a call, and
``constrain`` redistributing a DTensor; and ``compressed_psum`` on 2 ranks
against the reference's under ``shard_map`` on 2 of the host devices that
``tests/conftest.py`` forces: the reduced gradient bit for bit, the error
buffer within an ulp of the largest |gradient + error| (XLA fuses
the reference's ``target - q * scale`` into one rounding).

Every case runs its ranks as ``subprocess``es on a free local port, with a
timeout, and reads rank 0's last line of output (JSON).
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.configs as jconfigs
import repro.data as jdata
import repro.models as jmodels
import repro.train as jtrain
from repro.compat import shard_map
from repro.train import grad_compress as jgrad_compress
from repro.train import optimizer as joptimizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "internlm2-1.8b-smoke"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(code: str, ranks: int) -> list:
    """Start ``code`` as ``ranks`` processes of one ``gloo`` group
    (``torchrun``'s environment; one rank alone gets none)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT"):
        env.pop(name, None)
    port = _free_port()
    procs = []
    for rank in range(ranks):
        if ranks > 1:
            env.update(RANK=str(rank), LOCAL_RANK=str(rank),
                       WORLD_SIZE=str(ranks), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(code)], cwd=ROOT,
            env=dict(env), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    return procs


def _finish(procs: list, timeout: float = 240) -> dict:
    """Wait for every rank -> rank 0's last line of output, parsed; kills
    them all if one fails or the time runs out."""
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


def _run(code: str, ranks: int, timeout: float = 240) -> dict:
    return _finish(_start(code, ranks), timeout)


def test_elastic_restore_onto_smaller_mesh(tmp_path):
    setup = f"""
        import json
        import torch, torch.distributed as dist
        from repro_torch.checkpoint import Checkpointer
        from repro_torch.checkpoint.checkpointer import _paths, _shardings
        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import (init_process_group,
                                             make_debug_mesh,
                                             make_subslice_mesh)
        from repro_torch.sharding.context import distribute
        from repro_torch.models import get_model
        from repro_torch.sharding import TRAIN_RULES, tree_shardings
        from repro_torch.train import TrainConfig, init_train_state
        from repro_torch.train.optimizer import opt_state_specs, tree_leaves

        cfg = get_config("internlm2-1.8b").smoke().replace(dtype="float32")
        model = get_model(cfg)
        tc = TrainConfig()
        pspecs = model.param_specs()

        def state_and_shardings(seed, mesh):
            state = init_train_state(model, seed, tc, device="cpu")
            logical = {{"params": pspecs, "opt": opt_state_specs(
                pspecs, tc.opt, has_master="master" in state["opt"])}}
            return state, tree_shardings(state, logical, TRAIN_RULES, mesh)

        ck = Checkpointer({str(tmp_path)!r})
    """
    save = setup + """
        init_process_group("cpu", 4)
        mesh_big = make_debug_mesh((2, 2), device_type="cpu")
        state, sh_big = state_and_shardings(0, mesh_big)
        state = distribute(state, sh_big)
        wq = state["params"]["layers"][0]["wq"]
        assert wq.to_local().numel() * 4 == wq.numel()
        ck.save(3, state)
        print(json.dumps({"n": len(tree_leaves(state))}))
    """
    restore = setup + """
        init_process_group("cpu", 2)
        # half the data axis lost: the (1, 2) sub-slice of the first ranks
        mesh_small = make_subslice_mesh((2, 2), drop_data_rows=1,
                                        device_type="cpu")
        want, _ = state_and_shardings(0, mesh_small)
        template, sh_small = state_and_shardings(1, mesh_small)
        restored, _ = ck.restore(template, step=3, shardings=sh_small)
        wq = restored["params"]["layers"][0]["wq"]
        sharded = 0
        onto = dict(_shardings(sh_small))
        for (key, a), (key_b, b) in zip(_paths(want), _paths(restored)):
            assert key == key_b
            mesh, places = onto[key]
            assert b.device_mesh is mesh is mesh_small
            assert tuple(b.placements) == tuple(places)
            sharded += b.to_local().numel() < b.numel()
            assert torch.equal(a, b.full_tensor())
        print(json.dumps({"mesh": list(wq.device_mesh.shape),
                          "placements": [str(p) for p in wq.placements],
                          "n": len(tree_leaves(restored)),
                          "sharded": sharded}))
    """
    saved = _run(save, 4)
    manifest = json.load(open(tmp_path / "step_00000003" / "manifest.json"))
    assert manifest["n_processes"] == 4
    assert sorted(os.listdir(tmp_path / "step_00000003")) == [
        "manifest.json", "proc_0.npz"]
    out = _run(restore, 2)
    assert out["mesh"] == [1, 2]
    assert out["placements"] == ["R", "S(1)"]
    assert out["n"] == saved["n"] and out["sharded"] > 0


_TRAIN = """
    import json, sys
    import repro_torch.launch.train as launch_train
    # the float32 smoke config, which the reference's losses are held to
    get_config = launch_train.get_config
    launch_train.get_config = \
        lambda arch: get_config(arch).replace(dtype="float32")
    res = launch_train.main(["--arch", "internlm2-1.8b-smoke",
                "--steps", "4", "--mesh", sys.argv[1], "--global-batch", "8",
                "--seq", "32", "--device", "cpu", "--ckpt-dir", sys.argv[2]])
    print(json.dumps({"losses": res["losses"],
                      "mesh": list(res["mesh"].shape)}))
"""


def _reference_losses(steps: int) -> list:
    """The reference's ``train_loop`` from the port's seed-0 weights with
    the launcher's configuration and batches."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.models.convert import params_to_numpy

    tcfg = get_config(ARCH).replace(dtype="float32")
    tree = params_to_numpy(tcfg, get_model(tcfg).init(0, device="cpu"))
    jcfg = jconfigs.get_config(ARCH).replace(dtype="float32")
    jtc = jtrain.TrainConfig(opt=jtrain.OptConfig(lr=1e-3, warmup_steps=10,
                                                  total_steps=steps))
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = {"params": jparams,
              "opt": joptimizer.init_opt_state(jparams, jtc.opt)}
    data = jdata.ByteCorpus(jdata.DataConfig(
        vocab_size=jcfg.vocab_size, seq_len=32, global_batch=8))
    _, hist = jtrain.train_loop(jmodels.get_model(jcfg), jtc, data,
                                steps=steps, state=jstate)
    return [float(m["loss"]) for _, m in hist]


def test_train_driver_multidevice(tmp_path):
    def code(mesh):
        return _TRAIN.replace("sys.argv[1]", repr(mesh)).replace(
            "sys.argv[2]", repr(str(tmp_path / mesh)))

    big, one = _start(code("2x2"), 4), _start(code("1x1"), 1)
    want = _reference_losses(4)
    got, base = _finish(big), _finish(one)
    assert got["mesh"] == [2, 2] and base["mesh"] == [1, 1]
    np.testing.assert_allclose(got["losses"], base["losses"], rtol=1e-5)
    np.testing.assert_allclose(base["losses"], want, rtol=1e-4)
    np.testing.assert_allclose(got["losses"], want, rtol=1e-4)
    assert got["losses"][-1] < got["losses"][0]


_SERVE = """
    import json, sys
    import numpy as np, torch
    from repro_torch.launch.serve import main, requests
    from repro_torch.sharding.context import full, on_mesh
    res = main(["--arch", "internlm2-1.8b-smoke", "--mesh", sys.argv[1],
                "--requests", "4", "--max-new", "4", "--prompt-len", "4",
                "--max-len", "16", "--device", "cpu"])
    eng = res["engine"]
    with torch.no_grad(), on_mesh():
        batch = {"tokens": eng._tokens(np.stack(res["requests"]))}
        logits, cache = eng.model.prefill(eng.params, batch, 16)
        step = {"tokens": eng._tokens(np.argmax(full(logits).numpy(), -1)
                                      [:, None])}
        logits2, _ = eng.model.decode_step(eng.params, step, cache)
    print(json.dumps({"tokens": [o.tolist() for o in res["outputs"]],
                      "launches": res["launches"],
                      "mesh": list(res["mesh"].shape),
                      "sharded": type(eng.params["embed"]).__name__,
                      "prefill": full(logits).tolist(),
                      "decode": full(logits2).tolist()}))
"""


def test_serve_driver_multidevice():
    big = _start(_SERVE.replace("sys.argv[1]", "'2x2'"), 4)
    one = _start(_SERVE.replace("sys.argv[1]", "'1x1'"), 1)
    got, base = _finish(big), _finish(one)
    assert got["mesh"] == [2, 2] and got["sharded"] == "DTensor"
    assert got["tokens"] == base["tokens"]
    assert got["launches"] == base["launches"] == {"mha": 2, "wkv6": 0,
                                                   "pchase": 0}
    for name in ("prefill", "decode"):
        np.testing.assert_allclose(got[name], base[name], atol=1e-4,
                                   rtol=0)


_KERNELS = """
    import json
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import init_process_group, make_debug_mesh
    from repro_torch.models.common import attention
    from repro_torch.models.rwkv6 import wkv_chunked
    from repro_torch.sharding import TRAIN_RULES, activation_sharding, constrain

    init_process_group("cpu", 2)
    mesh = make_debug_mesh((1, 2), device_type="cpu")
    g = torch.Generator().manual_seed(0)
    R = Replicate()

    def put(t, *places):
        return distribute_tensor(t, mesh, places, src_data_rank=None)

    out = {}
    for name, hq, hkv, qp, kp in (
            ("gqa_4_1", 4, 1, (R, Shard(2)), (R, R)),
            ("heads_4_2", 4, 2, (R, Shard(2)), (R, Shard(2))),
            ("heads_kv_replicated", 4, 2, (R, Shard(2)), (R, R)),
            ("batch", 4, 1, (R, Shard(0)), (R, R))):
        q = torch.randn(2, 40, hq, 16, generator=g)
        k = torch.randn(2, 40, hkv, 16, generator=g)
        v = torch.randn(2, 40, hkv, 16, generator=g)
        want = attention(q, k, v, causal=True, prefix_len=8)
        before = ops.mha.launches
        got = ops.mha(put(q, *qp), put(k, *kp), put(v, *kp), causal=True,
                      prefix_len=8)
        out[name] = {"err": float((got.full_tensor() - want).abs().max()),
                     "launches": ops.mha.launches - before,
                     "placements": [str(p) for p in got.placements]}

    r, k, w = (torch.randn(2, 40, 4, 8, generator=g) for _ in range(3))
    w = torch.sigmoid(w) * 0.5 + 0.45
    v = torch.randn(2, 40, 4, 8, generator=g)
    u = torch.randn(4, 8, generator=g)
    want_y, want_s = wkv_chunked(r, k, v, w, u, r.new_zeros(2, 4, 8, 8), 8)
    hp = (R, Shard(2))
    y, s = ops.wkv6(put(r, *hp), put(k, *hp), put(v, *hp), put(w, *hp),
                    put(u, R, Shard(0)), chunk=8)
    out["wkv6"] = {"err": max(float((y.full_tensor() - want_y).abs().max()),
                              float((s.full_tensor() - want_s).abs().max())),
                   "placements": [str(p) for p in s.placements]}

    x = put(torch.randn(4, 6, 8, generator=g), R, Shard(2))
    with activation_sharding(mesh, TRAIN_RULES):
        c = constrain(x, ("batch", "seq", "embed_act"))
    out["constrain"] = {"placements": [str(p) for p in c.placements],
                        "equal": bool(torch.equal(c.full_tensor(),
                                                  x.full_tensor()))}
    print(json.dumps(out))
"""


def test_kernels_on_sharded_heads():
    out = _run(_KERNELS, 2)
    for name in ("gqa_4_1", "heads_4_2", "heads_kv_replicated", "batch"):
        assert out[name]["err"] <= 1e-5, (name, out[name])
        assert out[name]["launches"] == 1, name
    # 4 query heads to 1 kv head: q is gathered, never paired across shards
    assert out["gqa_4_1"]["placements"] == ["R", "R"]
    assert out["heads_4_2"]["placements"] == ["R", "S(2)"]
    assert out["heads_kv_replicated"]["placements"] == ["R", "S(2)"]
    assert out["batch"]["placements"] == ["R", "S(0)"]
    assert out["wkv6"]["err"] <= 1e-5
    assert out["wkv6"]["placements"] == ["R", "S(1)"]
    # the batch takes the data axis, of size 1 here: replicated
    assert out["constrain"] == {"placements": ["R", "R"], "equal": True}


_PSUM = """
    import json
    import numpy as np, torch, torch.distributed as dist
    from repro_torch.launch.mesh import init_process_group
    from repro_torch.train import compressed_psum

    init_process_group("cpu", 2)
    rank = dist.get_rank()
    rng = np.random.default_rng(10 + rank)
    g = torch.from_numpy(rng.normal(size=64).astype(np.float32))
    e = torch.from_numpy(rng.normal(size=64).astype(np.float32) * 1e-3)
    out, err = compressed_psum(g, e, group=dist.group.WORLD)
    errs = [torch.empty_like(err) for _ in range(2)]
    dist.all_gather(errs, err)
    print(json.dumps({"out": out.tolist(),
                      "err": torch.cat(errs).tolist()}))
"""


def test_compressed_psum_two_ranks_equals_reference():
    got = _run(_PSUM, 2)
    pairs = []
    for rng in (np.random.default_rng(10 + r) for r in range(2)):
        gr = rng.normal(size=64).astype(np.float32)
        er = rng.normal(size=64).astype(np.float32) * 1e-3
        pairs.append((gr, er))
    g = np.concatenate([p[0] for p in pairs])
    e = np.concatenate([p[1] for p in pairs])
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("d",))
    spec = jax.sharding.PartitionSpec("d")
    fn = jax.jit(shard_map(
        lambda gg, ee: jgrad_compress.compressed_psum(gg, ee, "d"),
        mesh=mesh, in_specs=(spec, spec),
        out_specs=(jax.sharding.PartitionSpec(), spec), check_vma=False))
    want, want_err = fn(jnp.asarray(g), jnp.asarray(e))
    np.testing.assert_array_equal(np.asarray(got["out"], np.float32),
                                  np.asarray(want))
    # XLA contracts the reference's ``target - q * scale`` into one fused
    # multiply-add, so the error buffers part by the rounding of q * scale
    # (half an ulp of the largest |target|) and that of the difference
    peak = np.abs(g + e).max()
    np.testing.assert_allclose(np.asarray(got["err"], np.float32),
                               np.asarray(want_err), rtol=0,
                               atol=np.spacing(np.float32(peak)))
