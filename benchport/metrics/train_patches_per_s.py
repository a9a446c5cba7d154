"""Training throughput: the patch columns coded and folded into the
dictionary (a round's patches times its inner steps, over every round
completed in the window), over the window's host-clock seconds."""


def read(ctx):
    if ctx.unit != "round":
        return None
    return ctx.units * ctx.patches_per_unit / ctx.window_s
