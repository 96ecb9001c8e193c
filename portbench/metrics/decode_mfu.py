"""The decode steps' share of the bf16 peak: their operations from shapes
(2 x non-embedding parameters a token, attention over the valid positions,
the head) over the time each held the device."""
from harness.readers import mfu_percent
from harness.work import decode_flops


def read(run):
    return mfu_percent(run, "decode",
                       lambda s, i: decode_flops(s, i["batch"], i["valid"]))
