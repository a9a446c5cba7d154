"""The checkerboard sampler's share of its roofline in training:
``peaks_ising.checkerboard_bound`` of one sampler call (the cell's
lattice side and sweeps a round) times the calls the traced window made
(the port's count ``ising.site_updates`` over n^2 times the sweeps a
call), over the device time of the sampler's kernels named below (the
resident kernel, on one CTA or a cluster, and the device-memory one)."""

from benchport import peaks_ising, spans, tracing

KERNELS = ("checkerboard_resident_kernel", "checkerboard_half_kernel")


def read(ctx):
    t, c = ctx.trace, ctx.counts
    if t is None or ctx.unit != "round" or "lattice" not in c:
        return None
    rec = spans.record()
    if rec is None:
        return None
    sites = rec[1].get("ising.site_updates", 0)
    secs, launches = tracing.device_time(t, KERNELS)
    if sites <= 0 or not launches:
        return None
    n, sweeps = c["lattice"], c["sweeps"]
    least, _ = peaks_ising.checkerboard_bound(n, sweeps)
    return 100.0 * least * sites / (n * n * sweeps) / secs
