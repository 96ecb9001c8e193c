"""The port's checkpointer, held to the reference's file format.

* The reference's ``TestCheckpoint`` cases (``tests/test_substrate.py``)
  re-pointed at ``repro_torch``, each in float32 as there and again with
  bfloat16 parameters and a float32 master (the reference's own restore
  cannot read bfloat16 back; its test forces float32).
* On the same seeded numpy trees (float32, int32, a 0-d int32 step,
  bfloat16 and all of them nested in dictionaries and lists), both
  packages save, and their npz files hold the same keys in the same order,
  with the same dtypes (bfloat16 as a two-byte void, ``V2``), shapes and
  bytes, beside manifests that are equal but for ``time``.  (The npy
  header of a bfloat16 entry names ``|V2`` in the port's file and ``<V2``
  in the reference's, which ``ml_dtypes`` writes; numpy reads both as
  ``V2``.)  The reference restores the port's float32 and int32 files bit
  for bit; the port restores the reference's files bit for bit, bfloat16
  too, where the reference's own restore raises ``ValueError``.
* A missing key raises ``KeyError`` and a wrong shape ``ValueError``;
  a ``shardings`` leaf that is not a (mesh, placements) pair raises
  ``TypeError`` naming ``sharding.tree_shardings`` (restoring onto meshes
  runs on several ranks in ``test_torch_elastic.py``);
  restore returns new tensors, reads only the template's keys and casts a
  bfloat16 payload exactly.
* ``save_async`` takes its snapshot before it returns: an in-place change
  made before ``wait()``, while the writer is held back, is not saved.
"""
import json
import os
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
import repro_torch.configs as tconfigs
from repro_torch.checkpoint import Checkpointer, checkpointer
from repro_torch.data import ByteCorpus, DataConfig
from repro_torch.models import get_model
from repro_torch.train import (OptConfig, TrainConfig, init_train_state,
                               make_train_step, train_loop)
from repro_torch.train.optimizer import tree_leaves, tree_map

DTYPES = ["float32", "bfloat16"]


def _tiny_setup(dtype="float32", steps_total=64):
    cfg = tconfigs.get_config("internlm2-1.8b").smoke().replace(dtype=dtype)
    model = get_model(cfg)
    tc = TrainConfig(
        opt=OptConfig(lr=3e-3, warmup_steps=4, total_steps=steps_total,
                      master_f32=True), ckpt_every=4)
    data = ByteCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                 global_batch=8))
    return cfg, model, tc, data


def _clone(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


def _assert_bitwise(a_tree, b_tree):
    a, b = tree_leaves(a_tree), tree_leaves(b_tree)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


class TestCheckpoint:
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_roundtrip_bitwise(self, tmp_path, dtype):
        cfg, model, tc, data = _tiny_setup(dtype)
        state = init_train_state(model, 2, tc, device="cpu")
        assert ("master" in state["opt"]) == (dtype == "bfloat16")
        ck = Checkpointer(str(tmp_path))
        ck.save(5, state, extra={"note": "hi"})
        restored, extra = ck.restore(state, step=5)
        assert extra["note"] == "hi"
        _assert_bitwise(state, restored)
        # new tensors: the template is not written and not aliased
        for a, b in zip(tree_leaves(state), tree_leaves(restored)):
            assert a.data_ptr() != b.data_ptr()

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_async_save_and_gc(self, tmp_path, dtype):
        ck = Checkpointer(str(tmp_path), keep=2)
        tree = {"w": torch.arange(10.0).to(getattr(torch, dtype))}
        for s in (1, 2, 3, 4):
            ck.save_async(s, tree)
        ck.wait()
        assert ck.steps() == [3, 4]          # keep=2
        restored, _ = ck.restore(tree)
        _assert_bitwise(tree, restored)

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_resume_bitwise_equals_uninterrupted(self, tmp_path, dtype):
        """Checkpoint/restart at step 4 must reproduce the 8-step run
        exactly (deterministic pipeline + pure step)."""
        cfg, model, tc, data = _tiny_setup(dtype)
        s0 = init_train_state(model, 3, tc, device="cpu")
        step_fn = make_train_step(model, tc)

        # Uninterrupted 8 steps.
        sa, _ = train_loop(model, tc, data, steps=8, state=_clone(s0),
                           step_fn=step_fn)

        # 4 steps -> checkpoint -> restore -> 4 more.
        ck = Checkpointer(str(tmp_path))
        sb, _ = train_loop(model, tc, data, steps=4, state=_clone(s0),
                           step_fn=step_fn)
        ck.save(4, sb)
        sb_restored, _ = ck.restore(sb, step=4)
        sb2, _ = train_loop(model, tc, data, steps=8, state=sb_restored,
                            start_step=4, step_fn=step_fn)
        _assert_bitwise(sa, sb2)


# ----------------------------------------------------------------------------
# the two packages on the same trees
# ----------------------------------------------------------------------------
def _numpy_tree(kind: str, seed: int = 0) -> dict:
    """A seeded tree of numpy arrays (bfloat16 as ``ml_dtypes``)."""
    rng = np.random.default_rng(seed)

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def i32(*shape):
        return rng.integers(-2**31, 2**31 - 1, shape, dtype=np.int64
                            ).astype(np.int32)

    def bf16(*shape):
        return (rng.standard_normal(shape) * 3).astype(ml_dtypes.bfloat16)

    if kind == "float32":
        return {"w": f32(3, 5), "b": f32(7)}
    if kind == "int32":
        return {"ids": i32(4, 6), "n": i32(2)}
    if kind == "step":
        return {"step": np.asarray(rng.integers(0, 1000), np.int32)}
    if kind == "bfloat16":
        return {"w": bf16(5, 3), "v": bf16(8)}
    return {"params": {"embed": bf16(6, 4),
                       "layers": [{"wq": bf16(4, 4), "ln": f32(4)}
                                  for _ in range(2)]},
            "opt": {"m": [f32(4, 4), f32(4)], "step": np.asarray(7, np.int32),
                    "counts": i32(3)}}


KINDS = ["float32", "int32", "step", "bfloat16", "nested"]


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch_tree(tree):
    def leaf(a):
        a = np.array(a)
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(a)
    return jax.tree.map(leaf, tree)


def _bits(a):
    """An array or tensor -> (dtype name, shape, bytes)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return "bfloat16", tuple(a.shape), \
                a.view(torch.int16).numpy().tobytes()
        a = a.numpy()
    a = np.asarray(a)
    return a.dtype.name, a.shape, a.tobytes()


def _flat(tree):
    return [_bits(leaf) for leaf in jax.tree.leaves(tree)]


def _has_bf16(tree):
    return any(np.asarray(a).dtype == ml_dtypes.bfloat16
               for a in jax.tree.leaves(tree))


def _save_both(tmp_path, kind):
    tree = _numpy_tree(kind, seed=KINDS.index(kind))
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    Checkpointer(str(port_dir)).save(3, _torch_tree(tree),
                                     extra={"note": kind})
    JCheckpointer(str(ref_dir)).save(3, _jax_tree(tree),
                                     extra={"note": kind})
    return tree, port_dir / "step_00000003", ref_dir / "step_00000003"


@pytest.mark.parametrize("kind", KINDS)
def test_files_equal_reference(tmp_path, kind):
    _, port, ref = _save_both(tmp_path, kind)
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref)) \
        == ["manifest.json", "proc_0.npz"]
    with np.load(port / "proc_0.npz") as zp, np.load(ref / "proc_0.npz") as zr:
        assert zp.files == zr.files
        for key in zr.files:
            a, b = zp[key], zr[key]
            assert a.dtype == b.dtype and a.shape == b.shape, key
            assert a.tobytes() == b.tobytes(), key
    manifests = []
    for d in (port, ref):
        with open(d / "manifest.json") as f:
            m = json.load(f)
        assert isinstance(m.pop("time"), float)
        manifests.append(m)
    assert manifests[0] == manifests[1]
    assert list(manifests[0]["keys"]) == list(manifests[1]["keys"])
    dtypes = {v["dtype"] for v in manifests[0]["keys"].values()}
    assert ("bfloat16" in dtypes) == (kind in ("bfloat16", "nested"))


@pytest.mark.parametrize("kind", KINDS)
def test_reference_restores_port_files(tmp_path, kind):
    """Bit for bit for float32 and int32; a bfloat16 leaf is left out of
    the template (the reference cannot cast its payload; see below)."""
    tree, _, _ = _save_both(tmp_path, kind)
    keep = {k: v for k, v in tree.items() if not _has_bf16(v)} \
        if kind == "nested" else tree
    if kind == "nested":
        keep["params"] = {"layers": [{"ln": layer["ln"]} for layer in
                                     tree["params"]["layers"]]}
    if _has_bf16(keep):
        pytest.raises(ValueError, JCheckpointer(str(tmp_path / "port"))
                      .restore, _jax_tree(keep))
        return
    got, extra = JCheckpointer(str(tmp_path / "port")).restore(
        _jax_tree(keep))
    assert extra == {"note": kind}
    assert _flat(got) == _flat(keep)


@pytest.mark.parametrize("kind", KINDS)
def test_port_restores_reference_files(tmp_path, kind):
    tree, _, _ = _save_both(tmp_path, kind)
    template = tree_map(torch.zeros_like, _torch_tree(tree))
    got, extra = Checkpointer(str(tmp_path / "ref")).restore(template)
    assert extra == {"note": kind}
    assert _flat(got) == _flat(tree)
    if _has_bf16(tree):
        # the reference's own restore of its own file raises
        with pytest.raises(ValueError, match="cast"):
            JCheckpointer(str(tmp_path / "ref")).restore(_jax_tree(tree))


# ----------------------------------------------------------------------------
# errors and restore semantics
# ----------------------------------------------------------------------------
def test_missing_key_raises_key_error(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"a": torch.zeros(3)})
    with pytest.raises(KeyError, match="missing 'b'"):
        ck.restore({"a": torch.zeros(3), "b": torch.zeros(2)})


def test_wrong_shape_raises_value_error(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"layers": [{"w": torch.zeros(2, 3)}]})
    with pytest.raises(ValueError, match="shape mismatch for 'layers::0::w'"):
        ck.restore({"layers": [{"w": torch.zeros(3, 2)}]})


def test_no_checkpoint_raises_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path)).restore({"a": torch.zeros(1)})


def test_shardings_raise_naming_sharding(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"a": torch.zeros(1)})
    with pytest.raises(TypeError, match="sharding.tree_shardings"):
        ck.restore({"a": torch.zeros(1)}, shardings={"a": None})


def test_bfloat16_restores_into_float32_template_exactly(tmp_path):
    w = (torch.randn(64, generator=torch.Generator().manual_seed(0)) * 5
         ).to(torch.bfloat16)
    ck = Checkpointer(str(tmp_path))
    ck.save(2, {"w": w, "step": torch.tensor(9, dtype=torch.int32)})
    got, _ = ck.restore({"w": torch.zeros(64),
                         "step": torch.tensor(0, dtype=torch.int64)})
    assert got["w"].dtype == torch.float32 and torch.equal(got["w"], w.float())
    assert got["step"].dtype == torch.int64 and int(got["step"]) == 9


def test_restore_reads_only_the_template_keys(tmp_path, monkeypatch):
    """A serve-style restore of ``{"params": ...}`` from a training state
    reads no optimizer array."""
    cfg, model, tc, data = _tiny_setup("bfloat16")
    state = init_train_state(model, 0, tc, device="cpu")
    ck = Checkpointer(str(tmp_path))
    ck.save(1, state)
    read = []
    member = checkpointer._Npz.read

    def recording(self, key):
        read.append(key)
        return member(self, key)

    monkeypatch.setattr(checkpointer._Npz, "read", recording)
    template = {"params": model.init(5, device="cpu")}
    got, _ = ck.restore(template)
    assert read and all(k.startswith("params::") for k in read)
    assert len(read) == len(tree_leaves(state["params"]))
    _assert_bitwise(got["params"], state["params"])


def test_key_paths_follow_the_reference(tmp_path):
    """Dictionary keys sorted, list indices as numbers, joined by '::'."""
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"z": torch.zeros(1), "a": [torch.zeros(1), {"y": torch.ones(1),
                                                            "b": None}]})
    with np.load(tmp_path / "step_00000001" / "proc_0.npz") as z:
        assert z.files == ["a::0", "a::1::y", "z"]


def test_leftover_tmp_is_not_a_step(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(2, {"a": torch.zeros(1)})
    os.makedirs(tmp_path / "step_00000009.tmp")
    os.makedirs(tmp_path / "step_00000010")          # no manifest
    assert ck.steps() == [2] and ck.latest_step() == 2


@pytest.mark.parametrize("dtype", DTYPES)
def test_save_async_snapshots_before_returning(tmp_path, monkeypatch, dtype):
    """The writer is held back until the tree has been changed in place:
    the checkpoint still holds the values at ``save_async``."""
    release = threading.Event()
    savez = np.savez

    def held(*args, **kwargs):
        assert release.wait(30)
        return savez(*args, **kwargs)

    monkeypatch.setattr(np, "savez", held)
    tree = {"w": torch.arange(16.0).to(getattr(torch, dtype)),
            "step": torch.tensor(3, dtype=torch.int32)}
    before = _clone(tree)
    ck = Checkpointer(str(tmp_path))
    ck.save_async(1, tree)
    with torch.no_grad():
        tree["w"].add_(100)
        tree["step"].add_(1)
    release.set()
    ck.wait()
    got, _ = ck.restore(tree)
    _assert_bitwise(got, before)
    assert not torch.equal(tree["w"], before["w"])


def test_save_async_of_a_train_step_saves_the_pre_step_state(tmp_path,
                                                             monkeypatch):
    """``train_loop``'s own pattern: a save at step 4, then in-place steps
    before the writer runs."""
    cfg, model, tc, data = _tiny_setup("bfloat16")
    state = init_train_state(model, 1, tc, device="cpu")
    step_fn = make_train_step(model, tc)
    state, _ = train_loop(model, tc, data, steps=4, state=state,
                          step_fn=step_fn)
    before = _clone(state)
    release = threading.Event()
    savez = np.savez

    def held(*args, **kwargs):
        assert release.wait(30)
        return savez(*args, **kwargs)

    monkeypatch.setattr(np, "savez", held)
    ck = Checkpointer(str(tmp_path))
    ck.save_async(4, state)
    state, _ = step_fn(state, data.batch_at(4))
    release.set()
    ck.wait()
    got, _ = ck.restore(state)
    _assert_bitwise(got, before)
    assert not torch.equal(got["opt"]["m"]["embed"],
                           state["opt"]["m"]["embed"])


def test_a_corrupted_array_fails_its_crc(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.arange(1000.0)})
    path = tmp_path / "step_00000001" / "proc_0.npz"
    with open(path, "r+b") as f:
        data = f.read()
        at = data.index(np.float32(500.0).tobytes())
        f.seek(at)
        f.write(np.float32(-1.0).tobytes())
    with pytest.raises(ValueError, match="CRC-32"):
        ck.restore({"w": torch.zeros(1000)})


@pytest.mark.parametrize("layout", ["compressed", "fortran"])
def test_other_npz_members_read_through_numpy(tmp_path, layout):
    """Members that ``np.savez`` does not write (deflated, Fortran order)
    are read by numpy's own reader, to the same values."""
    w = np.asfortranarray(np.arange(12, dtype=np.float32).reshape(3, 4))
    d = tmp_path / "step_00000002"
    d.mkdir()
    save = np.savez_compressed if layout == "compressed" else np.savez
    save(d / "proc_0.npz", w=w, n=np.int32(4))
    with open(d / "manifest.json", "w") as f:
        json.dump({"step": 2, "time": 0.0, "n_processes": 1, "keys": {
            "w": {"shape": [3, 4], "dtype": "float32"},
            "n": {"shape": [], "dtype": "int32"}}, "extra": {}}, f)
    got, _ = Checkpointer(str(tmp_path)).restore(
        {"w": torch.zeros(3, 4), "n": torch.tensor(0, dtype=torch.int32)})
    assert torch.equal(got["w"], torch.from_numpy(np.ascontiguousarray(w)))
    assert int(got["n"]) == 4 and got["n"].shape == ()


def test_a_leaf_that_is_no_tensor_raises(tmp_path):
    with pytest.raises(TypeError, match="'opt::step': a leaf of type int"):
        Checkpointer(str(tmp_path)).save(1, {"opt": {"step": 3}})
