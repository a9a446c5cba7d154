"""Profiling / tracing helpers.

Counterpart of ``onmf_ontf_ndl_tpu/utils/profiling.py``:

- :func:`trace`: a ``torch.profiler`` capture of the enclosed block, CPU
  activity and, where a CUDA device is present, the card's kernels, written
  as a Chrome trace into ``log_dir`` (open it in ``chrome://tracing`` or
  Perfetto);
- :class:`Throughput`: items per second of a block, fenced by a device
  synchronisation (PyTorch returns before the card finishes).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch

__all__ = ["trace", "Throughput"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the enclosed block; yields the
    profiler (``key_averages()`` gives the sums by kernel) and writes
    ``log_dir/trace_<pid>.json`` when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}.json"))


def _leaves(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _leaves(getattr(x, f.name))
    elif isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)


class Throughput:
    """Items per second of a block, fenced by a device sync.

    >>> tp = Throughput()
    >>> with tp.measure(items=iters * batch):
    ...     st, code = train_dict(st, X, ...)
    ...     tp.fence((st, code))
    >>> tp.items_per_sec
    """

    def __init__(self):
        self.items_per_sec = None
        self.elapsed = None

    @contextlib.contextmanager
    def measure(self, items: int):
        # reset first: a raising block must not leave a previous run's
        # numbers behind for error-handling callers to misreport
        self.items_per_sec = None
        self.elapsed = None
        t0 = time.perf_counter()
        yield self
        self.elapsed = time.perf_counter() - t0
        self.items_per_sec = items / self.elapsed

    @staticmethod
    def fence(x):
        """Synchronise the device of every tensor leaf of ``x`` (tensors,
        dataclasses such as ``OnmfState``, dicts, lists, tuples); CPU
        tensors need none. Returns ``x``."""
        devices = {t.device for t in _leaves(x) if t.device.type == "cuda"}
        for dev in devices:
            torch.cuda.synchronize(dev)
        return x
