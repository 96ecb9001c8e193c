"""The port's dry run (``repro_torch.launch.dryrun``) on a fake process
group of 8 ranks, (2, 4) mesh, in a subprocess.

The reference's ``tests/test_dryrun_small.py`` cells (internlm2-1.8b
``train_4k`` and ``decode_32k``, rwkv6-3b ``long_500k``) and its assertions
re-pointed at the port, plus qwen3-moe-30b-a3b ``train_4k`` with
``moe_impl="ep"`` (in one microbatch, to hold the test's time; the
internlm2 cell's 32 are extrapolated from two and three), whose
collectives must show the expert-parallel all-to-alls.  Each cell's
``argument_bytes`` must equal the bytes of its inputs' local shards worked
out from ``resolve_spec`` and the shapes alone.  The subprocess imports no
JAX, and ``main`` writes one record a cell at the reference's path.
"""
import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import pytest
import torch

from repro_torch.configs import get_config, shape_for
from repro_torch.models import get_model
from repro_torch.sharding import SERVE_RULES, TRAIN_RULES, resolve_spec
from repro_torch.train.optimizer import (OptConfig, init_opt_state,
                                         opt_state_specs)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = SimpleNamespace(axis_names=("data", "model"),
                       shape={"data": 2, "model": 4})
CELLS = [("internlm2-1.8b", "train_4k", None),
         ("internlm2-1.8b", "decode_32k", None),
         ("rwkv6-3b", "long_500k", None),
         ("qwen3-moe-30b-a3b", "train_4k", "ep")]


def _run(code: str, timeout: float = 600) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               REPRO_DRYRUN_DEVICES="8", OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, timeout=timeout,
                          env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.split("===JSON===")[1])


@pytest.fixture(scope="module")
def ci_cells():
    return _run(f"""
        import json, sys
        from repro_torch.launch import dryrun
        from repro_torch.models import Runtime
        mesh = dryrun.make_mesh((2, 4), ("data", "model"))
        out = []
        for arch, shape, impl in {CELLS!r}:
            overrides = None if impl is None else {{
                "microbatches": 1,
                "runtime": Runtime(q_chunk=1024, remat="full",
                                   moe_impl=impl)}}
            out.append(dryrun.run_cell(arch, shape, mesh, "ci",
                                       overrides=overrides))
        print("===JSON===")
        print(json.dumps({{"cells": out, "jax": "jax" in sys.modules}}))
    """)


def test_all_ci_cells_compile(ci_cells):
    assert not ci_cells["jax"]
    for rec in ci_cells["cells"]:
        assert rec["ok"], f"{rec['arch']}/{rec['shape']}: {rec.get('error')}"
        assert rec["devices"] == 8 and rec["device_type"] == "cpu"


def test_cost_and_memory_recorded(ci_cells):
    for rec in ci_cells["cells"]:
        assert rec["cost"].get("flops", 0) > 0
        assert rec["memory"]["argument_bytes"] > 0
        mem = rec["memory"]
        assert mem["peak_estimate_bytes"] == (
            mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
            - mem["alias_bytes"])


def test_train_cell_has_collectives(ci_cells):
    train = ci_cells["cells"][0]
    assert train["collectives"]["total_bytes"] > 0
    assert "all-reduce" in train["collectives"]["bytes_by_op"]
    assert train["microbatches"] == 32
    assert train["traced_microbatches"] == [2, 3]


def test_roofline_terms_from_ci_cells(ci_cells):
    from repro_torch.analysis.roofline import roofline_from_cell
    from repro_torch.core.catalog import TPU_V5E

    train = ci_cells["cells"][0]
    terms = roofline_from_cell(train, get_config("internlm2-1.8b"),
                               shape_for("train_4k"), TPU_V5E, chips=8)
    assert terms.compute_s > 0 and terms.memory_s > 0
    assert terms.bound in ("compute", "memory", "collective")
    assert 0 < terms.roofline_fraction <= 1.0
    assert terms.useful_ratio > 0.1, "traced flops wildly above model flops"


def test_long500k_rwkv_state_bound(ci_cells):
    long = ci_cells["cells"][2]
    assert long["ok"]
    # attention-free decode: the cache is O(1); arguments stay modest.
    assert long["memory"]["argument_bytes"] < 20e9


def test_ep_cell_exchanges_all_to_all(ci_cells):
    ep = ci_cells["cells"][3]
    assert ep["microbatches"] == 1
    coll = ep["collectives"]
    assert coll["bytes_by_op"]["all-to-all"] > 0
    # three exchanges a layer forward, two more in the backward and three
    # again in the full remat's recompute
    layers = get_config("qwen3-moe-30b-a3b").n_layers
    assert coll["count_by_op"]["all-to-all"] == 8 * layers


def _local_bytes(tree, logical, rules) -> int:
    """Bytes of a tree's local shards on one device of ``MESH``."""
    if isinstance(tree, dict):
        return sum(_local_bytes(tree[k], logical[k], rules) for k in tree)
    if isinstance(tree, list):
        return sum(_local_bytes(t, a, rules) for t, a in zip(tree, logical))
    spec = resolve_spec(tuple(tree.shape), logical, rules, MESH)
    split = 1
    for entry in spec:
        for axis in (() if entry is None else
                     entry if isinstance(entry, tuple) else (entry,)):
            split *= MESH.shape[axis]
    return tree.numel() * tree.element_size() // split


def _expected_arguments(arch: str, shape_name: str) -> int:
    model = get_model(get_config(arch))
    shape = shape_for(shape_name)
    batch = model.input_specs(shape)
    batch_logical = {k: ("batch",) + ("",) * (t.dim() - 1)
                     for k, t in batch.items()}
    pshapes, plogical = model.param_shapes(), model.param_specs()
    if shape.kind == "train":
        oc = OptConfig(master_f32=True)
        opt = init_opt_state(pshapes, oc)
        state = {"params": pshapes, "opt": opt}
        logical = {"params": plogical, "opt": opt_state_specs(
            plogical, oc, has_master="master" in opt)}
        return (_local_bytes(state, logical, TRAIN_RULES)
                + _local_bytes(batch, batch_logical, TRAIN_RULES))
    cache = model.cache_input_specs(shape)
    cache.pop("len")
    cache_rules = type(SERVE_RULES)("cache", {**SERVE_RULES.mapping,
                                              "kv_seq": ()})
    cache_logical = {k: v for k, v in model.cache_specs().items()
                     if k in cache}
    return (_local_bytes(pshapes, plogical, SERVE_RULES)
            + _local_bytes(batch, batch_logical, SERVE_RULES)
            + _local_bytes(cache, cache_logical, cache_rules))


@pytest.mark.parametrize("i", range(len(CELLS)))
def test_argument_bytes_are_the_local_shards(ci_cells, i):
    rec = ci_cells["cells"][i]
    with torch.device("meta"):
        want = _expected_arguments(rec["arch"], rec["shape"])
    assert rec["memory"]["argument_bytes"] == want


def test_main_writes_one_record_a_cell(tmp_path):
    out = _run(f"""
        import json, os
        from repro_torch.launch import dryrun
        from repro_torch.launch.dryrun import make_mesh
        # the CLI's production mesh would need 256 ranks: a (2, 4) one
        dryrun.make_production_mesh = \\
            lambda multi_pod=False: make_mesh((2, 4), ("data", "model"))
        rc = dryrun.main(["--arch", "rwkv6-3b", "--arch", "qwen3-14b",
                          "--shape", "long_500k", "--out", {str(tmp_path)!r}])
        rc2 = dryrun.main(["--arch", "rwkv6-3b", "--shape", "long_500k",
                           "--out", {str(tmp_path)!r}, "--skip-existing"])
        print("===JSON===")
        print(json.dumps({{"rc": [rc, rc2], "files": sorted(os.listdir(
            os.path.join({str(tmp_path)!r}, "single")))}}))
    """)
    assert out["rc"] == [0, 0]
    assert out["files"] == ["qwen3-14b__long_500k.json",
                            "rwkv6-3b__long_500k.json"]
    rec = json.load(open(tmp_path / "single" / "rwkv6-3b__long_500k.json"))
    assert rec["ok"] and rec["mesh"] == "single" and "collectives" in rec
    skipped = json.load(open(tmp_path / "single" /
                             "qwen3-14b__long_500k.json"))
    assert skipped["ok"] and "skipped" in skipped
