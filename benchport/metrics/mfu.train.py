"""The training step's share of the card's float32 peak: the model
operations of the traced rounds (``peaks.flops_per_patch`` per patch
column and step: projection, fixed sweeps, H Hᵀ and H Xᵀ) over the traced
window, in percent of 67e12/s. Only where the coder runs fixed sweeps: an
early stop's sweeps are not counted on the device, so such a cell has
nothing to read."""

from benchport import peaks


def read(ctx):
    t, c = ctx.trace, ctx.counts
    if t is None or ctx.unit != "round" or not c["fixed"] or not t.units:
        return None
    ops = peaks.flops_per_patch(c["d"], c["r"], c["sub_iter"]) \
        * ctx.patches_per_unit * t.units
    return 100.0 * ops / t.window_s / peaks.PEAK_OPS
