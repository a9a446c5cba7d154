"""Device idle time a reconstruction: the gaps between the traced device
operations while the host was inside a ``recon.job`` span of the port's
own record, summed over the traced jobs, over their number, in
milliseconds."""

from benchport import spans


def read(ctx):
    if ctx.unit != "job":
        return None
    return spans.idle_ms_per_call(ctx, "recon.job")
