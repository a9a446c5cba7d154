"""The early-stop coder's sweeps a column in training: the kernels' own
count of each tile's sweeps times its columns (``coder_es.column_sweeps``)
over the columns they coded (``coder_es.columns``), both read from the
port's record as the last snapshot less the first over the traced calls.
Between 1 and the configuration's ``sub_iter``."""

from benchport import spans


def read(ctx):
    if ctx.trace is None or ctx.unit != "round":
        return None
    rec = spans.record()
    if rec is None:
        return None
    counts = rec[1]
    cols = counts.get("coder_es.columns", 0)
    if cols <= 0:
        return None
    return counts["coder_es.column_sweeps"] / cols
