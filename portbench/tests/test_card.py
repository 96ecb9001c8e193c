"""On the card, at each cell's own size: the program comes out correct and
the control (the reference in float8 put in the program's place) does not;
for training, half of the batch left out does not either.  Each case is a
short window on one seed; ``tools/control.py`` reads the same numbers
over several seeds."""
import pytest

import run as R
from harness.spec import load_cell

SEED = 2**31 + 101


def _over(checks: dict, limits: dict, prefix: str) -> list:
    return [k for k, v in checks.items()
            if k.startswith(prefix) and v["value"] > limits[k[len(prefix):]]]


@pytest.mark.card
@pytest.mark.parametrize("workload", ["qwen3-14b.docqa",
                                      "qwen3-14b.longgen",
                                      "internlm2-1.8b.pretrain-4k"])
def test_program_passes_and_control_fails(card, workload):
    cell = load_cell(workload)
    out = R.run_cell(cell, SEED, 5.0, False, device=card, control=True)
    assert out["correct"], out["checks"]
    assert _over(out["checks"], cell.limits, "control_"), out["checks"]


@pytest.mark.card
def test_half_batch_fails(card):
    cell = load_cell("internlm2-1.8b.pretrain-4k")
    out = R.run_cell(cell, SEED, 5.0, False, device=card,
                     fault="half_batch")
    assert not out["correct"], out["checks"]
