"""The share of the early-stop coder's columns in training that its
cluster form coded (a tile on a thread block cluster of CTAs, where the
tiles are too few to fill the card): the kernels' own count of those
columns (``coder_es.cluster_columns``) over the columns coded
(``coder_es.columns``), in %, both read from the port's record as the
last snapshot less the first over the traced calls. None where the port
keeps no such count (a version before the cluster form)."""

from benchport import spans


def read(ctx):
    if ctx.trace is None or ctx.unit != "round":
        return None
    rec = spans.record()
    if rec is None:
        return None
    counts = rec[1]
    cols = counts.get("coder_es.columns", 0)
    if cols <= 0 or "coder_es.cluster_columns" not in counts:
        return None
    return 100.0 * counts["coder_es.cluster_columns"] / cols
