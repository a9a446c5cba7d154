"""Tail latency: the nearest-rank 95th percentile of every job's
host-clock latency in the window, in milliseconds."""

import math


def read(ctx):
    if ctx.unit != "job" or not ctx.latencies:
        return None
    s = sorted(ctx.latencies)
    return 1e3 * s[max(0, math.ceil(0.95 * len(s)) - 1)]
