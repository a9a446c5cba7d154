"""The fixed-sweep coder kernel's share of its roofline in a
reconstruction: ``peaks.coder_fixed_bound`` at the job's (r, n) and
sweeps, per call, over the device time of a call of the kernels named
below. At these shapes operations bound it."""

from benchport import peaks, tracing

KERNELS = ("coder_lanes_kernel", "coder_wide_kernel")


def read(ctx):
    t, c = ctx.trace, ctx.counts
    if t is None or ctx.unit != "job":
        return None
    secs, calls = tracing.device_time(t, KERNELS)
    if not calls:
        return None
    least, _ = peaks.coder_fixed_bound(c["r"], c["n"], c["sub_iter"])
    return 100.0 * least * calls / secs
