"""The port's sharding rule engine, held to the reference's, in process.

* The reference's cases of ``tests/test_sharding.py`` re-pointed at
  ``repro_torch``: the six ``TestResolve`` cases, every architecture's
  parameter specs under both rule sets on the production (16, 16) mesh
  (each sharded dimension divisible), the moe expert weights and the serve
  KV cache at ``decode_32k``.  A mesh is any object with axis names and a
  shape, so no process group runs here; the multi-rank drivers are in
  ``test_torch_elastic.py``.
* Cross-checks, bit for bit: ``resolve_spec`` on seeded shapes, logical
  names, meshes (``("pod", "data", "model")`` too) and rule sets (with
  ``model_fallback`` too) equals the reference's; every architecture's
  logical axes, meta shapes and resolved specs under both rule sets at
  (2, 2) and (16, 16) equal the reference's, a layer leaf's being the
  reference's stacked one without its leading ``"layers"`` entry; the
  batch and cache stand-ins equal the reference's ``ShapeDtypeStruct``s.
* ``placements`` turns a spec into DTensor placements and refuses an entry
  whose axes are out of the mesh's order; ``constrain`` passes a plain
  tensor through, inside a context or not.
"""
import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

import repro.configs as jconfigs
import repro.models as jmodels
import repro.sharding as jsharding
import repro_torch.configs as tconfigs
from repro_torch.models import Runtime, get_model
from repro_torch.sharding import (SERVE_RULES, TRAIN_RULES, Rules,
                                  activation_sharding, batch_spec, constrain,
                                  resolve_spec, tree_shardings, tree_specs)
from repro_torch.sharding.context import current_mesh
from repro_torch.sharding.specs import placements

ARCHS = sorted(tconfigs.ARCHS)


def _mesh(shape=(2, 2), names=("data", "model")):
    return SimpleNamespace(axis_names=names, shape=tuple(shape))


def _jmesh(shape=(2, 2), names=("data", "model")):
    devs = np.array(jax.devices()[:1] * int(np.prod(shape))).reshape(shape)
    return Mesh(devs, names)


MESH = _mesh()


class TestResolve:
    def test_basic_two_dim(self):
        s = resolve_spec((64, 128), ("embed", "ff"), TRAIN_RULES, MESH)
        assert s == ("data", "model")

    def test_non_divisible_falls_back_to_replication(self):
        s = resolve_spec((63, 128), ("embed", "ff"), TRAIN_RULES, MESH)
        assert s == (None, "model")

    def test_axis_reuse_forbidden(self):
        s = resolve_spec((4, 64, 128), ("experts", "embed", "ff"),
                         TRAIN_RULES, MESH)
        assert s == ("data", None, "model")

    def test_multi_axis_batch(self):
        mesh = _mesh((2, 4, 2), ("pod", "data", "model"))
        s = resolve_spec((16, 128), ("batch", "seq"), TRAIN_RULES, mesh)
        assert s == (("pod", "data"),)

    def test_multi_axis_partial_fallback(self):
        mesh = _mesh((2, 4, 2), ("pod", "data", "model"))
        s = resolve_spec((2, 128), ("batch", "seq"), TRAIN_RULES, mesh)
        assert s == ("pod",)

    def test_unknown_axis_replicates(self):
        s = resolve_spec((10, 10), ("mystery", "layers"), TRAIN_RULES, MESH)
        assert s == ()


def _leaves(tree, path=""):
    """(path, leaf) of a tree of dicts and lists (tuples are leaves)."""
    if isinstance(tree, dict):
        for name in sorted(tree):
            yield from _leaves(tree[name], f"{path}/{name}")
    elif isinstance(tree, list):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("rules", [TRAIN_RULES, SERVE_RULES],
                         ids=["train", "serve"])
def test_full_zoo_param_specs_resolve(arch, rules):
    """Every parameter of every arch gets a valid spec on the production
    mesh shape (16, 16): each sharded dimension divides evenly."""
    mesh = _mesh((16, 16))
    model = get_model(tconfigs.get_config(arch))
    shapes = model.param_shapes()
    specs = tree_specs(shapes, model.param_specs(), rules, mesh)
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    checked = 0
    for (path, t), (_, spec) in zip(_leaves(shapes), _leaves(specs)):
        assert t.device.type == "meta", path
        for dim, entry in zip(t.shape, spec + (None,) * 10):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            assert dim % int(np.prod([sizes[a] for a in axes])) == 0, \
                (arch, path, tuple(t.shape), spec)
            checked += 1
    assert checked > 0, f"{arch}: nothing sharded at all"


def test_moe_expert_weights_sharded_over_data_and_ff():
    mesh = _mesh((16, 16))
    model = get_model(tconfigs.get_config("qwen3-moe-235b-a22b"))
    shapes = model.param_shapes()
    pspecs = tree_specs(shapes, model.param_specs(), TRAIN_RULES, mesh)
    assert len(pspecs["layers"]) == 94
    for layer in pspecs["layers"]:                       # (E, d, ff)
        assert layer["moe"]["w1"] == ("data", None, "model")
    w1 = shapes["layers"][0]["moe"]["w1"]
    assert w1.device.type == "meta" and tuple(w1.shape) == (128, 4096, 1536)


def test_kv_cache_sequence_sharded_for_serve():
    mesh = _mesh((16, 16))
    model = get_model(tconfigs.get_config("qwen3-14b"))
    cache_shapes = model.cache_input_specs(tconfigs.shape_for("decode_32k"))
    pspecs = tree_specs(cache_shapes, model.cache_specs(), SERVE_RULES, mesh)
    # (L, B, S, kv, hd): batch over data, seq over model (kv=8 not div 16)
    assert pspecs["k"] == (None, "data", "model")
    assert pspecs["len"] == ()


# ------------------------------------------------------------ cross-checks
_NAMES = sorted(set(TRAIN_RULES.mapping) | set(SERVE_RULES.mapping)
                | {"head_dim", "layers", "lora", "sites", "mystery", ""})
_MESHES = [((2, 2), ("data", "model")), ((16, 16), ("data", "model")),
           ((4, 1), ("data", "model")), ((2, 4, 2), ("pod", "data", "model")),
           ((2, 16, 16), ("pod", "data", "model")), ((8,), ("model",))]


def _rule_pairs():
    for name in ("train", "serve"):
        port = {"train": TRAIN_RULES, "serve": SERVE_RULES}[name]
        ref = {"train": jsharding.TRAIN_RULES,
               "serve": jsharding.SERVE_RULES}[name]
        for fallback in (False, True):
            yield (f"{name}{'-fallback' if fallback else ''}",
                   Rules(port.name, dict(port.mapping), fallback),
                   jsharding.Rules(ref.name, dict(ref.mapping), fallback))


@pytest.mark.parametrize("mesh_shape,names", _MESHES,
                         ids=["x".join(map(str, s)) for s, _ in _MESHES])
def test_resolve_spec_equals_reference_on_seeded_cases(mesh_shape, names):
    rng = np.random.default_rng(hash(mesh_shape) % 2**32)
    mesh, jmesh = _mesh(mesh_shape, names), _jmesh(mesh_shape, names)
    dims = [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 40, 48, 64, 96, 128, 256, 320]
    cases = 0
    for label, rules, jrules in _rule_pairs():
        for _ in range(150):
            rank = int(rng.integers(1, 6))
            shape = tuple(int(rng.choice(dims)) for _ in range(rank))
            logical = tuple(str(rng.choice(_NAMES)) for _ in range(rank))
            want = tuple(jsharding.resolve_spec(shape, logical, jrules, jmesh))
            got = resolve_spec(shape, logical, rules, mesh)
            assert got == want, (label, shape, logical)
            cases += 1
        for shape in ((8, 32), (2, 7), (16, 4, 3)):
            want = tuple(jsharding.batch_spec(shape, jrules, jmesh))
            assert batch_spec(shape, rules, mesh) == want, (label, shape)
    assert cases == 600


@functools.lru_cache(maxsize=None)
def _reference_model(arch):
    """The reference's logical axes and ShapeDtypeStructs of ``arch``."""
    model = jmodels.get_model(jconfigs.get_config(arch))
    return model.param_specs(), model.param_shapes()


def _unstacked(ref_tree, port_tree, strip):
    """(path, reference leaf, port leaf) pairs of the two trees; a port
    layer list meets the reference's stacked dict, whose leaves lose their
    leading entry by ``strip``."""
    if isinstance(port_tree, dict):
        assert set(port_tree) == set(ref_tree)
        for name in sorted(port_tree):
            yield from ((f"/{name}{p}", r, t) for p, r, t in _unstacked(
                ref_tree[name], port_tree[name], strip))
    elif isinstance(port_tree, list):
        for i, layer in enumerate(port_tree):
            stacked = jax.tree.map(strip, ref_tree, is_leaf=_is_spec_leaf)
            yield from ((f"/{i}{p}", r, t) for p, r, t in _unstacked(
                stacked, layer, strip))
    else:
        yield "", ref_tree, port_tree


def _is_spec_leaf(x):
    return isinstance(x, (tuple, P)) or hasattr(x, "shape")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_and_shapes_equal_reference(arch):
    jlogical, jshapes = _reference_model(arch)
    model = get_model(tconfigs.get_config(arch))
    leaves = list(_unstacked(jlogical, model.param_specs(),
                             lambda axes: axes[1:]))
    assert leaves and all(ref == got for _, ref, got in leaves), \
        [(p, r, g) for p, r, g in leaves if r != g][:3]
    n = 0
    for path, ref, got in _unstacked(
            jshapes, model.param_shapes(),
            lambda s: jax.ShapeDtypeStruct(s.shape[1:], s.dtype)):
        assert tuple(got.shape) == tuple(ref.shape), path
        assert str(got.dtype).split(".")[-1] == str(ref.dtype), path
        assert got.device.type == "meta", path
        n += got.numel()
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(jshapes))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh_shape", [(2, 2), (16, 16)],
                         ids=["2x2", "16x16"])
def test_param_specs_equal_reference(arch, mesh_shape):
    """Both rule sets: the port's spec of every leaf is the reference's (a
    layer's without the stacked ``"layers"`` entry, which never takes an
    axis)."""
    jlogical, jshapes = _reference_model(arch)
    model = get_model(tconfigs.get_config(arch))
    shapes, logical = model.param_shapes(), model.param_specs()
    mesh, jmesh = _mesh(mesh_shape), _jmesh(mesh_shape)
    for rules, jrules in ((TRAIN_RULES, jsharding.TRAIN_RULES),
                          (SERVE_RULES, jsharding.SERVE_RULES)):
        want = jax.tree.map(tuple, jsharding.tree_specs(
            jshapes, jlogical, jrules, jmesh),
            is_leaf=lambda x: isinstance(x, P))
        got = tree_specs(shapes, logical, rules, mesh)
        leaves = list(_unstacked(want, got, lambda s: s[1:]))
        assert leaves
        bad = [(p, r, g) for p, r, g in leaves if r != g]
        assert not bad, (rules.name, bad[:3])


@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_cache_specs_equal_reference(arch):
    model = get_model(tconfigs.get_config(arch))
    jmodel = jmodels.get_model(jconfigs.get_config(arch))
    mesh, jmesh = _mesh((16, 16)), _jmesh((16, 16))
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        shape = tconfigs.shape_for(name)
        want = jmodel.input_specs(jconfigs.shape_for(name))
        got = model.input_specs(shape)
        assert set(got) == set(want)
        for field, t in got.items():
            assert tuple(t.shape) == tuple(want[field].shape), (name, field)
            assert str(t.dtype).split(".")[-1] == str(want[field].dtype)
            assert t.device.type == "meta"
    shape = tconfigs.shape_for("decode_32k")
    jcache = jmodel.cache_input_specs(jconfigs.shape_for("decode_32k"))
    cache = model.cache_input_specs(shape)
    assert set(cache) == set(jcache)
    for field, t in cache.items():
        assert tuple(t.shape) == tuple(jcache[field].shape), field
    want = jax.tree.map(tuple, jsharding.tree_specs(
        jcache, jmodel.cache_specs(), jsharding.SERVE_RULES, jmesh),
        is_leaf=lambda x: isinstance(x, P))
    assert tree_specs(cache, model.cache_specs(), SERVE_RULES, mesh) == want


# --------------------------------------------------------------- placements
def test_placements_of_specs():
    mesh = _mesh((2, 4, 2), ("pod", "data", "model"))
    assert placements((), mesh) == (Replicate(),) * 3
    assert placements(("data", "model"), mesh) == \
        (Replicate(), Shard(0), Shard(1))
    assert placements((None, "model"), mesh) == \
        (Replicate(), Replicate(), Shard(1))
    assert placements((("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    with pytest.raises(ValueError, match="axis order"):
        placements((("data", "pod"),), mesh)
    with pytest.raises(ValueError, match="axis order"):
        placements((("model", "data"),), _mesh((2, 2)))


def test_tree_shardings_pairs_mesh_and_placements():
    mesh = _mesh((2, 2))
    model = get_model(tconfigs.get_config("internlm2-1.8b").smoke())
    shapes = model.param_shapes()
    sh = tree_shardings(shapes, model.param_specs(), TRAIN_RULES, mesh)
    assert len(sh["layers"]) == len(shapes["layers"])
    m, wq = sh["layers"][0]["wq"]                # (embed, heads, head_dim)
    assert m is mesh and wq == (Shard(0), Shard(1))
    assert sh["layers"][0]["ln1"][1] == (Shard(0), Replicate())
    with pytest.raises(TypeError, match="logical axes"):
        tree_specs({"a": torch.empty(2, 2)}, {"a": ["embed", "ff"]},
                   TRAIN_RULES, mesh)


def test_constrain_passes_plain_tensors_through():
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert constrain(x, ("batch", "seq", "embed_act")) is x
    assert current_mesh() is None
    mesh = _mesh((2, 2))
    with activation_sharding(mesh, TRAIN_RULES):
        assert current_mesh() is mesh
        assert constrain(x, ("batch", "seq", "embed_act")) is x
        assert constrain(x, ("batch",)) is x
    assert current_mesh() is None


def test_moe_ep_still_refused_naming_its_module():
    """``moe_impl="ep"`` is accepted since ``models/moe_ep.py`` is ported:
    the moe FFN takes that module's ``moe_ffn_ep`` under a mesh and the
    sorted dispatch with none (``tests/test_torch_moe_ep.py`` runs it)."""
    from repro_torch.models import transformer

    assert Runtime(moe_impl="ep").moe_impl == "ep"
    assert transformer.moe_ffn_ep.__module__ == "repro_torch.models.moe_ep"
    assert current_mesh() is None
