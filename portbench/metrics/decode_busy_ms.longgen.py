"""The device's busy time a decode step, in milliseconds: the kernels,
copies and sets each traced decode step ran, from ``torch.profiler``,
averaged over the window's steps.  It leaves out the host's gaps between
launches, so it moves with the step's device work alone and stands as the
steadier statistic beside ``gen_tok_s``, whose run-to-run spread is the
host's pace."""
from harness.readers import units


def read(run):
    steps = units(run, "decode")
    if not steps:
        return None
    return 1e3 * sum(p.busy_s for p in steps) / len(steps)
