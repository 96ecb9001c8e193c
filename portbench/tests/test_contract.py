"""``BENCHMARK.json`` against the benchmark's contract, and every file its
entries name."""
import json
import math
import os
import re

import pytest

from harness.env import BENCH, ROOT

B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_keys_and_sizes():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(ROOT / "BENCHMARK.json") <= 64 * 1024
    assert B["command"] == ["python3", "portbench/run.py"]
    assert B["paths"] == ["portbench"]
    assert 1 <= B["run_seconds"] <= 51
    cells = len(B["workloads"])
    assert 1 <= cells <= 24 and 1 <= len(B["configs"]) <= 24


def test_a_full_check_fits():
    # 2 + 14 runs a cell of run_seconds + 60, 180 s a cell to compile,
    # 1200 s spare, within 43200 s at the full 24 cells
    rs = B["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_lines():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in B[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert entry["name"] not in seen
            seen.add(entry["name"])
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for entry in B["configs"] + B["workloads"]:
        assert _line(entry["why"])
    for m in B["per_layer"]:
        assert _line(m["layer"])


def test_configs():
    used = {w["config"] for w in B["workloads"]}
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"])
        assert c["file"].startswith("portbench/")
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert c["reduced"] == []            # full size, nothing cut


def test_workloads():
    configs = {c["name"] for c in B["configs"]}
    pairs = set()
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert (BENCH / "limits" / f"{w['name']}.json").exists()
    assert sum(w["chips"] == 4 for w in B["workloads"]) <= max(
        1, math.floor(0.25 * len(B["workloads"])))


def _reports(metric, workload):
    return workload in metric.get("workloads", [workload])


def test_metrics():
    names = {w["name"] for w in B["workloads"]}
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for m in B["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        moved = e2e[m["moves"]]
        for w in m.get("workloads", names):
            assert w in names and _reports(moved, w)
    for w in names:
        mine = [m for m in B["end_to_end"] if _reports(m, w)]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert any(_reports(m, w) for m in B["per_layer"])


@pytest.mark.parametrize("name", ["gen_tok_s"])
def test_decode_throughput_only_in_longgen(name):
    m = {m["name"]: m for m in B["end_to_end"]}[name]
    assert m["workloads"] == ["qwen3-14b.longgen"]
    assert not any(p["name"].startswith(name) for p in B["per_layer"])


def test_every_file_is_named_from_name_characters():
    for path in BENCH.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
