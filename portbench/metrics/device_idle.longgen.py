"""The device's idle share over the traced window: 1 - (the union of its
kernel, copy and set intervals) / the window, from ``torch.profiler``."""
from harness.readers import idle_percent


def read(run):
    return idle_percent(run)
