"""The train steps' share of the bf16 peak: model operations from shapes
(three times the forward's: 2 x non-embedding parameters x tokens, causal
attention, the head; recomputation not counted) over the time each step
held the device."""
from harness.readers import mfu_percent
from harness.work import train_flops


def read(run):
    return mfu_percent(run, "train",
                       lambda s, i: train_flops(s, i["batch"], i["seq"]))
