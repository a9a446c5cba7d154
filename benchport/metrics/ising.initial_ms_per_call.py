"""The Ising learner's initial round a call: the device milliseconds
between the CUDA events of the port's ``ising.initial`` spans (the round
on the per-round route, with its host reads, before the call's captured
rounds: its own work and the device's idle inside it), summed over the
traced calls, over the number of ``train.call`` spans. Not the span's
host length: the round's first blocking copy waits there for the last
call's replays, which the host queued ahead of it."""

from benchport import spans


def read(ctx):
    if ctx.trace is None or ctx.unit != "round":
        return None
    rec = spans.record()
    if rec is None:
        return None
    timed = [s.device_ms for s in spans.named(rec[0], "ising.initial")
             if s.device_ms is not None]
    calls = spans.named(rec[0], "train.call")
    if not timed or not calls:
        return None
    return sum(timed) / len(calls)
