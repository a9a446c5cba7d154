"""Device idle time a training call: the gaps between the traced device
operations while the host was inside a ``train.call`` span of the port's
own record (one ``train_dict`` call of an app), summed over the traced
calls, over their number, in milliseconds."""

from benchport import spans


def read(ctx):
    if ctx.unit != "round":
        return None
    return spans.idle_ms_per_call(ctx, "train.call")
