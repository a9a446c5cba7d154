"""The reconstruction's share of the card's float32 peak: per patch the
projection Wᵀ X (2dr), the fixed sweeps (2r² each) and W H (2dr), times
the patches of the traced jobs, over the traced window, in percent of
67e12/s."""

from benchport import peaks


def read(ctx):
    t, c = ctx.trace, ctx.counts
    if t is None or ctx.unit != "job" or not t.units:
        return None
    ops = peaks.recon_flops_per_patch(c["d"], c["r"], c["sub_iter"]) \
        * c["n"] * t.units
    return 100.0 * ops / t.window_s / peaks.PEAK_OPS
