"""Reconstruction time: the window's host-clock milliseconds over the
jobs completed in it (each job ends at a synchronise)."""


def read(ctx):
    if ctx.unit != "job":
        return None
    return 1e3 * ctx.window_s / ctx.units
