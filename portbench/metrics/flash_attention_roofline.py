"""The prefill attention kernels' share of their roofline: causal
attention's operations and bytes from each prefill's shapes (every layer's
q, k and v read once, its output written once) over the device time of the
kernels named below in that prefill.  The work is counted the same
whatever implements it."""
from harness.readers import units
from harness.work import attention_bytes, attention_ops, roofline_seconds

# the port's attention kernels (kernels/csrc/flash_attention*.cu)
KERNELS = ("flash_fwd_sm90_kernel", "flash_fwd_sm90_wide_kernel",
           "flash_fwd_kernel", "flash_fwd_wide_kernel")


def read(run):
    bound = took = 0.0
    for part in units(run, "prefill"):
        ns = sum(e - s for name, s, e in part.events
                 if any(k in name for k in KERNELS))
        if not ns:
            continue
        b, t, layers = part.info["batch"], part.info["seq"], \
            run.shape.n_layers
        bound += roofline_seconds(layers * attention_ops(run.shape, b, t),
                                  layers * attention_bytes(run.shape, b, t))[0]
        took += ns / 1e9
    return 100.0 * bound / took if took else None
