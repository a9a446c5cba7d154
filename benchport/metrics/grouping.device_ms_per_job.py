"""The grouping's device time a reconstruction: the pair keys' radix
sort, the run-length count of equal keys (``unique_consecutive``) and the
per-pair segment sums (the cub kernels named below), in milliseconds over
the traced jobs."""

from benchport import tracing

KERNELS = ("RadixSort", "ReduceByKey", "SegmentedReduce")


def read(ctx):
    t = ctx.trace
    if t is None or ctx.unit != "job" or not t.units:
        return None
    secs, calls = tracing.device_time(t, KERNELS)
    if not calls:
        return None
    return 1e3 * secs / t.units
