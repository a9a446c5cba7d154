"""The dictionary kernel's share of its roofline in training:
``peaks.dict_bound(d, r)`` per call (W, A and B read and W written once;
bytes bound it at these shapes) over the device time of a call of the
kernels named below."""

from benchport import peaks, tracing

KERNELS = ("dict_update_kernel", "dict_update_single_kernel")


def read(ctx):
    t, c = ctx.trace, ctx.counts
    if t is None or ctx.unit != "round":
        return None
    secs, calls = tracing.device_time(t, KERNELS)
    if not calls:
        return None
    least, _ = peaks.dict_bound(c["d"], c["r"])
    return 100.0 * least * calls / secs
