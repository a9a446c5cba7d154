"""The device's idle share in training: 100 less the union of the device
operations' intervals over the traced window, in percent."""


def read(ctx):
    t = ctx.trace
    if t is None or ctx.unit != "round":
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
