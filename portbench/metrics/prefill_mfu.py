"""The prefills' share of the bf16 peak: their operations from shapes
(2 x non-embedding parameters x tokens, causal attention, the head on the
last position) over the time each held the device."""
from harness.readers import mfu_percent
from harness.work import prefill_flops


def read(run):
    return mfu_percent(run, "prefill",
                       lambda s, i: prefill_flops(s, i["batch"], i["seq"]))
