"""Reduction of a ``torch.profiler`` trace of the window's first part to
what the per-layer metrics read: the traced window's length, the device's
busy time (the union of the device operations' intervals inside it, so
overlapping operations count once), each device operation's interval,
the host's CUDA API calls by name, and the breakdown the result line
carries (the device operations with the most time, the longest idle gaps
by the host operation running across each)."""

from __future__ import annotations

from collections import Counter
from types import SimpleNamespace

import numpy as np

MARK = "benchport.traced_window"


def _is_device(ev) -> bool:
    return str(ev.device_type()).endswith("CUDA")


def reduce(prof, units: int, calls: int) -> SimpleNamespace:
    evs = list(prof.profiler.kineto_results.events())
    marks = [e for e in evs if e.name() == MARK and not _is_device(e)]
    mark = max(marks, key=lambda e: e.duration_ns())
    ws, we = mark.start_ns(), mark.start_ns() + mark.duration_ns()
    device, host = [], []
    for e in evs:
        if e.name() == MARK:
            continue
        s, d = e.start_ns(), e.duration_ns()
        if _is_device(e):
            if d > 0 and s < we and s + d > ws:
                device.append((e.name(), max(s, ws), min(s + d, we)))
        elif ws <= s <= we:
            host.append((e.name(), s, s + d))
    device.sort(key=lambda x: x[1])
    busy, gaps, cur_s, cur_e = 0, [], None, ws
    for _, s, e in device:
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            if s > cur_e:
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    if we > cur_e:
        gaps.append((cur_e, we))
    ops = Counter()
    for name, s, e in device:
        ops[name] += e - s
    calls_by_name = Counter(name for name, _, _ in host)
    return SimpleNamespace(
        window_s=(we - ws) / 1e9, busy_s=busy / 1e9, device=device,
        host=calls_by_name, units=units, calls=calls,
        breakdown={
            "device_ops": [[n, t / 1e9] for n, t in ops.most_common(10)],
            "idle_gaps": _label(gaps, host)})


def _label(gaps: list, host: list) -> list:
    """The ten longest gaps, each named by the innermost host operation
    running across its middle."""
    top = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    if not host:
        return [["host: no traced operation", (e - s) / 1e9]
                for s, e in top]
    names = [h[0] for h in host]
    hs = np.array([h[1] for h in host], np.int64)
    he = np.array([h[2] for h in host], np.int64)
    out = []
    for s, e in top:
        mid = (s + e) // 2
        inside = np.flatnonzero((hs <= mid) & (he >= mid))
        name = ("host: no traced operation" if inside.size == 0 else
                "host: " + names[inside[np.argmin(he[inside]
                                                 - hs[inside])]])
        out.append([name, (e - s) / 1e9])
    return out


def launches(trace, prefixes=("cudaGraphLaunch", "cudaLaunchKernel",
                              "cuLaunchKernel", "cuGraphLaunch")) -> int:
    """Graphs and kernels the host launched in the traced window."""
    return sum(c for name, c in trace.host.items()
               if name.startswith(prefixes))


def device_time(trace, names) -> tuple:
    """(seconds, operations) of the device operations whose name holds
    one of ``names``."""
    hit = [(s, e) for n, s, e in trace.device
           if any(k in n for k in names)]
    return sum(e - s for s, e in hit) / 1e9, len(hit)
