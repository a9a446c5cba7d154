"""The early-stop coder kernel's share of its roofline in training: the
least time of the column sweeps it ran, ``peaks.coder_fixed_bound`` at
the step's r over the traced calls' columns (``coder_es.columns``) and
their mean sweeps (``coder_es.column_sweeps`` over the columns: n times
sweeps is the counted column sweeps), over the device time of the kernels
named below. The counts are the kernels' own, read from the port's record
as the last snapshot less the first over the traced calls."""

from benchport import peaks, spans, tracing

KERNELS = ("coder_es_lanes_kernel", "coder_wide_kernel")


def read(ctx):
    t, c = ctx.trace, ctx.counts
    if t is None or ctx.unit != "round":
        return None
    rec = spans.record()
    if rec is None:
        return None
    cols = rec[1].get("coder_es.columns", 0)
    secs, calls = tracing.device_time(t, KERNELS)
    if cols <= 0 or not calls:
        return None
    least, _ = peaks.coder_fixed_bound(
        c["r"], cols, rec[1]["coder_es.column_sweeps"] / cols)
    return 100.0 * least / secs
