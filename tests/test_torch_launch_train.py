"""The port's training launcher, and the serve launcher's ``--ckpt-dir``.

* ``launch.train.main`` on ``internlm2-1.8b-smoke`` (bfloat16 with a
  float32 master) on the CPU over 50 steps writes step 50, which holds its
  final state (DTensors on its 1x1 mesh, compared by their whole values)
  bit for bit.
* ``--resume --steps 52`` restores step 50 and trains steps 50-51, bit for
  bit as ``train_loop`` from the restored state does with the launcher's
  configuration (its schedule runs to 52).
* a ``--mesh`` of more devices than the process group has ranks raises
  ``ValueError`` before it writes anything (meshes of several ranks run in
  ``test_torch_elastic.py``); without ``--device`` the launcher runs on
  the card and, with none, raises.
* ``launch.serve.main --ckpt-dir`` on that checkpoint serves the trained
  weights in float32: its greedy tokens equal the reference ``Engine``'s on
  the same weights (crossed by ``convert.params_to_numpy``) and the same
  requests, and differ from the seed-0 weights' tokens.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jmodels
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
import repro_torch.configs as tconfigs
from repro_torch.checkpoint import Checkpointer
from repro_torch.data import ByteCorpus, DataConfig
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import Runtime, get_model
from repro_torch.models.convert import params_to_numpy
from repro_torch.sharding.context import full
from repro_torch.train import (OptConfig, TrainConfig, init_train_state,
                               train_loop)
from repro_torch.train.optimizer import tree_leaves

ARCH = "internlm2-1.8b-smoke"
ARGV = ["--arch", ARCH, "--device", "cpu"]
SERVE = ["--requests", "6", "--prompt-len", "10", "--max-new", "6",
         "--max-len", "20", "--slots", "4"]


def _assert_bitwise(a_tree, b_tree):
    # the launcher's state is DTensors on its 1x1 mesh: their whole values
    a = [full(x) for x in tree_leaves(a_tree)]
    b = [full(y) for y in tree_leaves(b_tree)]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("train_ckpt")
    res = launch_train.main(ARGV + ["--steps", "50", "--ckpt-dir",
                                    str(ckpt)])
    return res, ckpt


def _copy(ckpt, tmp_path):
    dst = tmp_path / "ckpt"
    shutil.copytree(ckpt, dst)
    return str(dst)


def test_train_writes_step_50(trained):
    res, ckpt = trained
    assert res["arch"] == ARCH and res["start"] == 0
    assert res["steps"] == 50 and res["ckpt_steps"] == [50]
    assert res["restarts"] == 0 and res["supervisor"].log == []
    assert sorted(os.listdir(ckpt)) == ["step_00000050"]
    assert all(np.isfinite(res["losses"]))
    assert np.mean(res["losses"][-5:]) < np.mean(res["losses"][:5])
    state = res["state"]
    assert state["params"]["embed"].dtype == torch.bfloat16
    assert state["opt"]["master"]["embed"].dtype == torch.float32
    assert int(state["opt"]["step"]) == 50
    save = res["checkpointer"].last_save
    assert save["step"] == 50 and save["bytes"] > 0
    assert save["snapshot_s"] >= 0 and save["write_s"] >= 0


def test_step_50_holds_the_final_state(trained):
    res, ckpt = trained
    model = get_model(tconfigs.get_config(ARCH))
    template = init_train_state(model, 1, TrainConfig(), device="cpu")
    got, extra = Checkpointer(str(ckpt)).restore(template)
    assert extra == {}
    _assert_bitwise(got, res["state"])


def test_resume_continues_bit_exact(trained, tmp_path, capsys):
    _, ckpt = trained
    ckpt = _copy(ckpt, tmp_path)
    res = launch_train.main(ARGV + ["--steps", "52", "--resume",
                                    "--ckpt-dir", ckpt])
    assert "resumed from step 50" in capsys.readouterr().out
    assert res["start"] == 50 and res["steps"] == 2
    assert res["ckpt_steps"] == [50] and res["restarts"] == 0

    cfg = tconfigs.get_config(ARCH)
    model = get_model(cfg)
    tc = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=10,
                                   total_steps=52),
                     runtime=Runtime(remat="none"), ckpt_every=50)
    data = ByteCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                 global_batch=8))
    state, _ = Checkpointer(ckpt).restore(
        init_train_state(model, 0, tc, device="cpu"))
    want, hist = train_loop(model, tc, data, 52, state=state, start_step=50)
    assert [s for s, _ in hist] == [50, 51]
    assert res["losses"] == [m["loss"] for _, m in hist]
    _assert_bitwise(res["state"], want)


def test_train_line_and_no_kernel(tmp_path, capsys):
    ops.reset_launches()
    res = launch_train.main(ARGV + ["--steps", "3", "--ckpt-dir",
                                    str(tmp_path)])
    out = capsys.readouterr().out
    assert (f"[train] arch={ARCH} mesh=1x1 steps=3 loss "
            f"{res['losses'][0]:.3f} -> {res['losses'][-1]:.3f} restarts=0 "
            f"stragglers=0") in out
    assert res["ckpt_steps"] == []            # ckpt_every=50
    assert all(fn.launches == 0 for fn in ops.WRAPPERS + ops.LLM_WRAPPERS)


def test_mesh_other_than_1x1_raises(tmp_path):
    with pytest.raises(ValueError, match="2 devices"):
        launch_train.main(ARGV + ["--mesh", "2x1", "--ckpt-dir",
                                  str(tmp_path)])
    assert os.listdir(tmp_path) == []


def test_train_launcher_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", ARCH, "--steps", "1", "--ckpt-dir",
                           str(tmp_path)])


def test_serve_from_checkpoint_equals_reference_engine(trained):
    res, ckpt = trained
    got = launch_serve.main(ARGV + SERVE + ["--ckpt-dir", str(ckpt)])
    again = launch_serve.main(ARGV + SERVE + ["--ckpt-dir", str(ckpt)])
    seed0 = launch_serve.main(ARGV + SERVE)
    params = got["engine"].params
    assert params["embed"].dtype == torch.float32
    # the trained bfloat16 weights (a DTensor of the training mesh), served
    # in float32 with no mesh
    assert torch.equal(params["embed"],
                       full(res["state"]["params"]["embed"]).float())

    jcfg = jconfigs.get_config(ARCH).replace(dtype="float32")
    jmodel = jmodels.get_model(jcfg)
    jparams = jax.tree.map(jnp.asarray,
                           params_to_numpy(tconfigs.get_config(ARCH), params))
    jeng = JEngine(jmodel, jparams, JServeConfig(max_len=20, slots=4))
    want = jeng.serve(got["requests"], max_new=6)
    assert len(want) == len(got["outputs"]) == 6
    for w, g, a in zip(want, got["outputs"], again["outputs"]):
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(a, g)
    assert any(not np.array_equal(g, s)
               for g, s in zip(got["outputs"], seed0["outputs"]))
    assert got["launches"]["mha"] == tconfigs.get_config(ARCH).n_layers * 2
