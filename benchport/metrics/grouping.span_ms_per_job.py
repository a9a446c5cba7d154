"""The grouping's device time a reconstruction, read from the port's own
record: the device milliseconds between the CUDA events of each
``recon.group`` span (``apps/network.py::_group_painted``: the pair keys'
sort, their run lengths and the segment sums, and whatever the card
waits for in between), summed over the traced jobs, over the number of
``recon.job`` spans."""

from benchport import spans


def read(ctx):
    if ctx.trace is None or ctx.unit != "job":
        return None
    rec = spans.record()
    if rec is None:
        return None
    jobs = spans.named(rec[0], "recon.job")
    timed = [s.device_ms for s in spans.named(rec[0], "recon.group")
             if s.device_ms is not None and s.call is not None]
    if not jobs or not timed:
        return None
    return sum(timed) / len(jobs)
