"""The port's ``analysis/`` against the reference's.

* ``tests/test_dryrun_small.py::TestHloParser`` re-pointed at the port's
  ``parse_collectives``;
* HLO text that ``jax.jit(...).compile().as_text()`` makes here (the
  cases of ``tests/test_hlo_cost.py``, and collectives under
  ``shard_map`` on the host devices ``tests/conftest.py`` forces) fed to
  both packages' ``analyze_hlo`` and ``parse_collectives``: equal records,
  and the reference's FLOP assertions on the port's;
* ``roofline_from_cell`` and ``markdown_table`` equal to the reference's
  on canned cells, with and without ``hlo_cost``;
* ``analysis.trace.StepTrace`` counts per device: one matmul sharded over
  a fake (2, 4) mesh counts its global FLOPs / 8, and the result bytes of
  DTensor's collectives by the reference's names (in a subprocess: the
  fake process group is the process's).
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import PartitionSpec as P

from repro.analysis import hlo as jhlo
from repro.analysis import hlo_cost as jhlo_cost
from repro.analysis import report as jreport
from repro.analysis import roofline as jroofline
from repro.compat import make_mesh, shard_map
from repro.configs import get_config as jget_config
from repro.configs import shape_for as jshape_for
from repro.core.catalog import TPU_V5E as J_TPU_V5E
from repro_torch.analysis import hlo, hlo_cost, report, roofline
from repro_torch.configs import get_config, shape_for
from repro_torch.core.catalog import TPU_V5E

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _hlo(f, *args):
    return jax.jit(f).lower(*args).compile().as_text()


class TestHloParser:
    def test_parse_canned_hlo(self):
        text = """
          %ag = f32[256,128]{1,0} all-gather(%x), replica_groups=...
          %ar = bf16[1024]{0} all-reduce(%y), to_apply=%add
          %ars = (f32[8]{0}, f32[16]{0}) all-reduce-start(%a, %b)
          %ard = (f32[8]{0}, f32[16]{0}) all-reduce-done(%ars)
          %cp = u32[64]{0} collective-permute(%z)
          %nothing = f32[2]{0} add(%p, %q)
        """
        st = hlo.parse_collectives(text)
        assert st.bytes_by_op["all-gather"] == 256 * 128 * 4
        assert st.bytes_by_op["all-reduce"] == 1024 * 2 + (8 + 16) * 4
        assert st.bytes_by_op["collective-permute"] == 64 * 4
        assert st.count_by_op["all-reduce"] == 2    # start counted, done not
        assert st.to_json() == jhlo.parse_collectives(text).to_json()


def _scan(n):
    return lambda x: jax.lax.scan(lambda c, _: (c @ c, None), x, None,
                                  length=n)[0]


def _nested(x):
    def inner(c, _):
        return c @ c, None

    def outer(c, _):
        return jax.lax.scan(inner, c, None, length=4)[0], None
    return jax.lax.scan(outer, x, None, length=3)[0]


def _psum_in_scan():
    mesh = make_mesh((2,), ("d",))

    def body(x):
        return jax.lax.scan(
            lambda c, _: ((jax.lax.psum(c, "d") @ c.T) @ c, None), x, None,
            length=3)[0]
    return shard_map(body, mesh=mesh, in_specs=P("d", None),
                     out_specs=P("d", None), check_vma=False)


def _all_gather():
    mesh = make_mesh((2,), ("d",))
    return shard_map(lambda x: jax.lax.all_gather(x, "d", tiled=True) * 2,
                     mesh=mesh, in_specs=P("d", None),
                     out_specs=P(None, None), check_vma=False)


CASES = {
    "single_matmul": (lambda a, b: a @ b,
                      (jnp.zeros((64, 128), jnp.float32),
                       jnp.zeros((128, 32), jnp.float32)),
                      2 * 64 * 128 * 32),
    "scan5": (_scan(5), (jnp.zeros((128, 128), jnp.float32),),
              5 * 2 * 128 ** 3),
    "nested": (_nested, (jnp.zeros((64, 64), jnp.float32),),
               12 * 2 * 64 ** 3),
    "scan8": (_scan(8), (jnp.zeros((128, 128), jnp.float32),), None),
    "scan16": (_scan(16), (jnp.zeros((128, 128), jnp.float32),), None),
    "psum_in_scan": (None, (jnp.zeros((16, 16), jnp.float32),), None),
    "all_gather": (None, (jnp.zeros((16, 8), jnp.float32),), None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_hlo_records_equal_reference(case):
    fn, args, flops = CASES[case]
    if fn is None:
        if jax.device_count() < 2:
            pytest.skip("needs 2 host devices (tests/conftest.py)")
        fn = {"psum_in_scan": _psum_in_scan,
              "all_gather": _all_gather}[case]()
    text = _hlo(fn, *args)
    port = hlo_cost.analyze_hlo(text)
    assert port.to_json() == jhlo_cost.analyze_hlo(text).to_json()
    assert hlo.parse_collectives(text).to_json() == \
        jhlo.parse_collectives(text).to_json()
    if flops is not None:
        assert port.dot_flops == pytest.approx(flops, rel=0.01)
        assert port.unknown_trip_loops == 0
    if case == "psum_in_scan":
        assert port.collective_counts.get("all-reduce") == 3
    if case == "all_gather":
        assert hlo.parse_collectives(text).bytes_by_op["all-gather"] == \
            16 * 8 * 4


def test_bytes_scale_with_trips():
    c8 = hlo_cost.analyze_hlo(_hlo(_scan(8), *CASES["scan8"][1]))
    c16 = hlo_cost.analyze_hlo(_hlo(_scan(16), *CASES["scan16"][1]))
    assert c16.bytes_accessed > 1.5 * c8.bytes_accessed


def _cells():
    """Canned dry-run records: one with ``hlo_cost``, and the port's form
    (``cost`` and ``collectives`` only)."""
    coll = {"bytes_by_op": {"all-reduce": 3.0e9, "all-to-all": 1.0e9},
            "count_by_op": {"all-reduce": 10, "all-to-all": 4},
            "total_bytes": 4.0e9, "total_count": 14}
    return [
        {"arch": "internlm2-1.8b", "shape": "train_4k", "mesh": "single",
         "devices": 256, "ok": True,
         "cost": {"flops": 1.0e14, "bytes accessed": 2.0e12},
         "collectives": coll,
         "hlo_cost": {"dot_flops": 3.0e15, "bytes_accessed": 4.0e12,
                      "total_collective_bytes": 5.0e10}},
        {"arch": "qwen3-moe-30b-a3b", "shape": "train_4k", "mesh": "single",
         "devices": 8, "ok": True,
         "cost": {"flops": 5.9e15, "bytes accessed": 2.9e14},
         "collectives": coll},
        {"arch": "internlm2-1.8b", "shape": "decode_32k", "mesh": "single",
         "devices": 8, "ok": True,
         "cost": {"flops": 1.6e11, "bytes accessed": 2.8e11},
         "collectives": coll},
        {"arch": "rwkv6-3b", "shape": "long_500k", "mesh": "single",
         "devices": 8, "ok": True,
         "cost": {"flops": 1.5e9, "bytes accessed": 2.0e9},
         "collectives": {**coll, "total_bytes": 3.4e8}},
    ]


def test_roofline_and_table_equal_reference():
    port, ref = [], []
    for cell in _cells():
        port.append(roofline.roofline_from_cell(
            cell, get_config(cell["arch"]), shape_for(cell["shape"]),
            TPU_V5E, chips=cell["devices"]))
        ref.append(jroofline.roofline_from_cell(
            cell, jget_config(cell["arch"]), jshape_for(cell["shape"]),
            J_TPU_V5E, chips=cell["devices"]))
        assert port[-1].to_json() == ref[-1].to_json()
        assert roofline.model_flops(get_config(cell["arch"]),
                                    shape_for(cell["shape"])) == \
            jroofline.model_flops(jget_config(cell["arch"]),
                                  jshape_for(cell["shape"]))
    assert report.markdown_table(port) == jreport.markdown_table(ref)


def test_report_reads_artifact_directory(tmp_path):
    (tmp_path / "single").mkdir()
    for cell in _cells():
        with open(tmp_path / "single" /
                  f"{cell['arch']}__{cell['shape']}.json", "w") as f:
            json.dump(cell, f)
    with open(tmp_path / "single" / "failed.json", "w") as f:
        json.dump({"arch": "x", "ok": False}, f)
    port = report.roofline_table(str(tmp_path), "single")
    ref = jreport.roofline_table(str(tmp_path), "single")
    assert len(port) == len(_cells())
    assert [t.to_json() for t in port] == [t.to_json() for t in ref]


_PER_DEVICE = """
    import json
    import torch, torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.analysis.trace import StepTrace
    from repro_torch.launch.dryrun import make_mesh

    mesh = make_mesh((2, 4), ("data", "model"))
    m, k, n = 64, 96, 128
    a = distribute_tensor(torch.empty(m, k, device="meta"), mesh,
                          [Shard(0), Replicate()], src_data_rank=None)
    b = distribute_tensor(torch.empty(k, n, device="meta"), mesh,
                          [Replicate(), Shard(1)], src_data_rank=None)
    with StepTrace() as mm:
        c = a @ b
    with StepTrace() as gather:
        full = c.redistribute(mesh, [Replicate(), Replicate()])
    with StepTrace() as reduce:
        s = (a @ b).sum()
        s.redistribute(mesh, [Replicate(), Replicate()])
    print(json.dumps({
        "flops": mm.dot_flops, "global": 2 * m * k * n,
        "placements": [str(p) for p in c.placements],
        "local": list(c.to_local().shape),
        "gather": gather.collectives.to_json(),
        "reduce": reduce.collectives.to_json(),
        "world": dist.get_world_size()}))
"""


def test_step_trace_counts_one_device():
    """A (64, 96) x (96, 128) matmul, rows over "data" (2) and columns over
    "model" (4): each device multiplies (32, 96) x (96, 32), 1/8 of the
    FLOPs; gathering the result counts the gathered bytes as all-gather."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               REPRO_DRYRUN_DEVICES="8")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_PER_DEVICE)],
                          capture_output=True, text=True, timeout=240,
                          env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["world"] == 8
    assert out["placements"] == ["S(0)", "S(1)"]
    assert out["local"] == [32, 32]
    assert out["flops"] == out["global"] / 8
    gathered = out["gather"]
    assert set(gathered["count_by_op"]) == {"all-gather"}
    # the last all-gather's result is the whole (64, 128) float32 matrix
    assert 64 * 128 * 4 in (gathered["bytes_by_op"]["all-gather"],
                            gathered["bytes_by_op"]["all-gather"]
                            - 32 * 128 * 4)
    assert out["reduce"]["count_by_op"].get("all-reduce", 0) >= 1
