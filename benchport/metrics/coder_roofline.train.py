"""The fixed-sweep coder kernel's share of its roofline in training:
``peaks.coder_fixed_bound`` at the step's (r, n) and sweeps, per call,
over the device time of a call of the kernels named below. The bound is
set by operations at these shapes (2 r² n sweeps against 4 (r² + 3 r n)
bytes). Only where the coder runs fixed sweeps."""

from benchport import peaks, tracing

KERNELS = ("coder_lanes_kernel", "coder_wide_kernel")


def read(ctx):
    t, c = ctx.trace, ctx.counts
    if t is None or ctx.unit != "round" or not c["fixed"]:
        return None
    secs, calls = tracing.device_time(t, KERNELS)
    if not calls:
        return None
    least, _ = peaks.coder_fixed_bound(c["r"], c["n"], c["sub_iter"])
    return 100.0 * least * calls / secs
