"""FISTA's share of its roofline in a reconstruction: the least time of
the work the kernels counted themselves over the traced jobs
(``peaks_fista.fista_bound`` at the cell's r from ``fista.columns``,
``fista.column_iters`` and the calls' runs ``fista_sweeps``), over the
device time of FISTA's kernels named below. The counts are read from the
port's record as the last snapshot less the first; None where the port
keeps no such count (a version before FISTA's own counters) or ran no
FISTA."""

from benchport import peaks_fista, spans, tracing

KERNELS = ("fista_tiled_kernel", "fista_wide_kernel",
           "fista_step_size_kernel", "fista_prep_kernel")


def read(ctx):
    t = ctx.trace
    if t is None or ctx.unit != "job":
        return None
    rec = spans.record()
    if rec is None:
        return None
    counts = rec[1]
    cols = counts.get("fista.columns", 0)
    secs, launches = tracing.device_time(t, KERNELS)
    if cols <= 0 or not launches:
        return None
    least, _ = peaks_fista.fista_bound(
        ctx.counts["r"], cols, counts["fista.column_iters"],
        counts["fista_sweeps"])
    return 100.0 * least / secs
