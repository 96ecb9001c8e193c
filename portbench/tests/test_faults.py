"""A run with its timed path broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run is driven on
the CPU at a smoke size, once for each fault the cell can have, held to
the cell's own limits.  The serving runs unbroken come out correct (a
training run at this size reads its loss a little differently from the
full size's, which the limits were set at, so only the faults are held
there)."""
import dataclasses

import pytest

import run as R
from harness.spec import load_cell

SMOKE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             d_ff=128, vocab=256)
# ``check_requests`` covers every request a smoke window finishes, so a
# token altered in any slot (the planted one is each wave's last) is read
TRAFFIC = {
    "qwen3-14b.docqa": dict(prompt_lengths=[64, 128], rate_per_s=20.0,
                            new_tokens=4, slots=4, max_len=160,
                            check_requests=64),
    "qwen3-14b.longgen": dict(wave_size=4, prompt_lengths=[64],
                              new_tokens=8, max_len=96, check_requests=64),
    "internlm2-1.8b.pretrain-4k": dict(global_batch=4, seq_len=64,
                                       microbatches=2),
}
FAULTS = [("qwen3-14b.docqa", "token"), ("qwen3-14b.docqa", "unchanged"),
          ("qwen3-14b.longgen", "token"),
          ("qwen3-14b.longgen", "unchanged"),
          ("internlm2-1.8b.pretrain-4k", "unchanged"),
          ("internlm2-1.8b.pretrain-4k", "half_batch")]


def smoke(workload):
    cell = load_cell(workload)
    traffic = dict(cell.traffic)
    traffic.update(TRAFFIC[workload])
    return dataclasses.replace(cell, shape=cell.shape.replace(**SMOKE),
                               traffic=traffic)


def _run(workload, fault):
    cell = smoke(workload)
    assert all(v is not None for v in cell.limits.values()) and cell.limits
    return R.run_cell(cell, 2**31 + 4242, 0.5, False, device="cpu",
                      fault=fault)


@pytest.mark.parametrize("workload", ["qwen3-14b.docqa",
                                      "qwen3-14b.longgen"])
def test_unbroken_run_is_correct(workload):
    out = _run(workload, None)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_fault_is_caught(workload, fault):
    out = _run(workload, fault)
    assert not out["correct"], out["checks"]
    assert out["failed"] == 0               # caught by a number, not a crash
