"""The port's own trace record, read beside the profiler's trace: the
spans and counts that ``onmf_ontf_ndl_tpu_torch/utils/profiling.py``
records while a profiler session is active (the traced window), and the
device's idle time inside spans of a name.

A program without that record (a version before it) reads as None, and
so does a record with nothing in it: the metrics that read it then
report nothing."""

from __future__ import annotations

import numpy as np


def record():
    """``(spans, counters)`` of the port's record of the traced window, or
    None where the port keeps none or it holds no span."""
    try:
        from onmf_ontf_ndl_tpu_torch.utils import profiling
    except ImportError:
        return None
    spans = getattr(profiling, "spans", None)
    counters = getattr(profiling, "counters", None)
    if spans is None or counters is None:
        return None
    done = [s for s in spans() if s.end_ns is not None]
    return (done, counters()) if done else None


def named(spans, name: str) -> list:
    """The spans called ``name``."""
    return [s for s in spans if s.name == name]


def busy(device) -> np.ndarray:
    """The union of the device operations' ``(name, start, end)``
    intervals, as sorted disjoint (start, end) rows."""
    rows = []
    for s, e in sorted((s, e) for _, s, e in device):
        if rows and s <= rows[-1][1]:
            rows[-1][1] = max(rows[-1][1], e)
        else:
            rows.append([s, e])
    return np.array(rows, np.int64).reshape(-1, 2)


def idle_ns(union: np.ndarray, start: int, end: int) -> int:
    """Nanoseconds of ``[start, end]`` during which no device operation
    ran (``union`` from :func:`busy`)."""
    over = np.minimum(union[:, 1], end) - np.maximum(union[:, 0], start)
    return int(end - start - np.clip(over, 0, None).sum())


def idle_ms_per_call(ctx, name: str):
    """The device's idle milliseconds while the host was inside a span
    ``name`` of the record, over the number of such spans; None without
    a traced device or such spans."""
    t = ctx.trace
    if t is None or not t.device:
        return None
    rec = record()
    if rec is None:
        return None
    calls = named(rec[0], name)
    if not calls:
        return None
    union = busy(t.device)
    idle = sum(idle_ns(union, s.start_ns, s.end_ns) for s in calls)
    return idle / 1e6 / len(calls)
