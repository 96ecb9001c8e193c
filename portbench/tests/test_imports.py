"""What a run and the reference load, by whole top-level module names: no
``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` in a run (the
port's own name, ``repro_torch``, begins with ``repro``), and nothing of
the port in the reference."""
import json
import os
import subprocess
import sys

from harness.env import forbidden_modules

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = """
import dataclasses, json, sys
sys.path.insert(0, {bench!r})
import run as R
from harness.env import forbidden_modules
from harness.spec import load_cell
cell = load_cell({workload!r})
s = cell.shape.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       head_dim=16, d_ff=128, vocab=256)
t = dict(cell.traffic)
t.update({traffic})
cell = dataclasses.replace(cell, shape=s, traffic=t)
out = R.run_cell(cell, 2**31 + 7, 0.3, False, device="cpu")
print(json.dumps({{"forbidden": forbidden_modules(),
                  "port": "repro_torch" in sys.modules,
                  "attempted": out["attempted"]}}))
"""

REFERENCE = """
import json, sys
import torch
sys.path.insert(0, {bench!r})
from harness.checks import serve_gaps, train_numbers
from harness.spec import load_cell
from harness.env import forbidden_modules
from reference.dense import serve_logits, train_readings
s = load_cell("qwen3-14b.docqa").shape.replace(
    n_layers=1, d_model=32, n_heads=2, n_kv_heads=1, head_dim=16, d_ff=64,
    vocab=64)
serve_logits(s, 3, [torch.arange(8)], [4], "cpu", fp8=True)
opt = dict(lr=1e-3, warmup_steps=1, total_steps=10, min_lr_ratio=0.1,
           b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=1.0)
rows = {{"tokens": torch.zeros(2, 8, dtype=torch.int32),
        "targets": torch.ones(2, 8, dtype=torch.int32)}}
train_readings(s, 3, [rows], opt, "cpu", microbatch=1)
top = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"forbidden": forbidden_modules(), "loaded": top}}))
"""


def _child(code: str) -> dict:
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_names_compared_whole():
    assert forbidden_modules({"repro_torch": 1, "repro_torch.models": 1,
                              "reprox": 1}) == []
    assert forbidden_modules({"repro": 1, "repro.models": 1, "jax": 1,
                              "jaxlib.xla": 1, "flax": 1}) == [
        "flax", "jax", "jaxlib.xla", "repro", "repro.models"]


def test_a_serving_run_loads_no_jax():
    got = _child(TINY.format(bench=BENCH, workload="qwen3-14b.docqa",
                             traffic=dict(prompt_lengths=[64],
                                          rate_per_s=10.0, new_tokens=2,
                                          slots=2, max_len=80,
                                          check_requests=2)))
    assert got["forbidden"] == [] and got["port"] and got["attempted"] > 0


def test_a_training_run_loads_no_jax():
    got = _child(TINY.format(bench=BENCH,
                             workload="internlm2-1.8b.pretrain-4k",
                             traffic=dict(global_batch=2, seq_len=32,
                                          microbatches=2, checked_steps=1)))
    assert got["forbidden"] == [] and got["port"] and got["attempted"] > 0


def test_the_reference_loads_nothing_of_the_program():
    got = _child(REFERENCE.format(bench=BENCH))
    assert got["forbidden"] == []
    assert "repro_torch" not in got["loaded"]
