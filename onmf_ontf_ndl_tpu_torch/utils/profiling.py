"""Profiling / tracing helpers.

Counterpart of ``onmf_ontf_ndl_tpu/utils/profiling.py``:

- :func:`trace`: a ``torch.profiler`` capture of the enclosed block, CPU
  activity and, where a CUDA device is present, the card's kernels, written
  as a Chrome trace into ``log_dir`` (open it in ``chrome://tracing`` or
  Perfetto), with the program's spans and counts on a track of their own;
- :func:`span`, :func:`count`, :func:`spans`, :func:`counters`: the
  program's own record of its phases (see below);
- :class:`Throughput`: items per second of a block, fenced by a device
  synchronisation (PyTorch returns before the card finishes).

The record. The program marks its phases with ``with span(name):``: a
training call (``train.call``, one ``train_dict`` call of an app) and a
reconstruction job (``recon.job``) are *calls*, the spans within them
their phases. Each span keeps its name, its start and end on the clock of
the profiler's own events (``time.time_ns``: the profiler's host and
device events are on the Unix clock, so a span and the device operations
it launched can be set side by side), its parent and the id of its call;
a span given a CUDA tensor or device (``on``) also the device time
between two CUDA events on that device's current stream. At the start and
end of each call a copy of the kernels' counts on the card
(``ops/kernels/_lib.py::SNAPSHOT_COUNTS``) is queued into pinned host memory
with no synchronise, beside a copy of the host's launch counts
(``_lib.LAUNCHES``); graph captures and replays are counted by cache
(:func:`count`, from ``utils/capture.py``). The record is read by
:func:`spans` and :func:`counters`, and kept until a session starts one
afresh: :func:`trace` always does, any other session where a span was
opened or the record read since the last one ended.

On and off: the record is taken exactly while a ``torch.profiler``
session is active in the process (torch's own flag). Off, :func:`span`
checks that flag, marks the record as the last session's and returns a
shared no-op: no allocation, no CUDA call. Spans are not ``record_function`` ranges, which the profiler
would return as device annotations.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import time
from collections import Counter

import torch
import torch.autograd.profiler as _torch_profiler

from onmf_ontf_ndl_tpu_torch.ops.kernels import _lib

__all__ = ["trace", "Throughput", "span", "spanned", "count", "spans",
           "counters", "CALLS", "Span"]

# The spans that open a call (a training call, a reconstruction job).
CALLS = ("train.call", "recon.job")
# The clock of the profiler's own events (``_KinetoEvent.start_ns``).
_now = time.time_ns
_SNAP_ROWS = 1024           # counter snapshots in one pinned block


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the enclosed block; yields the
    profiler (``key_averages()`` gives the sums by kernel) and writes
    ``log_dir/trace_<pid>.json`` when the block ends, the program's spans
    (:func:`spans`, with their calls' counts) on a track of their own and
    the counts over the block (:func:`counters`) as a last instant event."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        _REC.reset()
        yield prof
    path = os.path.join(log_dir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"] += _chrome_events(doc.get("baseTimeNanoseconds", 0))
    with open(path, "w") as f:
        json.dump(doc, f)


# ------------------------------------------------------------ the record
@dataclasses.dataclass
class Span:
    """One span of the record: ``start_ns`` and ``end_ns`` on the
    profiler's clock, ``parent`` the index of the enclosing span in
    :func:`spans` (None at the top), ``call`` the id of its call (None
    outside any), ``device_ms`` the device time between its CUDA events
    (None without them) and, for a call, ``counts``: what the card and
    the host counted in it (:func:`counters`' names)."""

    name: str
    start_ns: int
    end_ns: int | None = None
    parent: int | None = None
    call: int | None = None
    device_ms: float | None = None
    counts: dict | None = None


class _Record:
    """The spans and counts of one session, and the pinned blocks that the
    counter snapshots are copied into (kept across sessions: a copy may
    still be in flight when a session ends unread)."""

    def __init__(self):
        self.blocks = []
        self.reset()
        self.stale = True

    def reset(self) -> None:
        self.spans, self.open, self.calls = [], [], 0
        self.events = {}            # span index: (device, start, end)
        self.snaps = []             # (row, launches) of each snapshot
        self.call_snaps = {}        # a call's span index: its two snapshots
        self.counts = Counter()
        self.stale = False

    def snapshot(self, device, stream) -> int:
        """Queue a copy of the device's counts on ``stream`` into the next
        pinned row (zeros without the kernel library) and take one of the
        host's launch counts; returns its index. No tensor operation: under
        the profiler each would cost the host what the card then waits
        for."""
        i = len(self.snaps)
        row = None
        if device is not None:
            b, row = divmod(i, _SNAP_ROWS)
            if b == len(self.blocks):
                block = torch.zeros((_SNAP_ROWS, len(_lib.SNAPSHOT_COUNTS)),
                                    dtype=torch.int64, pin_memory=True)
                self.blocks.append((block, block.numpy()))
            block, rows = self.blocks[b]
            if not _lib.snapshot_runs(
                    device, block.data_ptr() + row * rows.strides[0],
                    stream.cuda_stream):
                rows[row] = 0
            row = rows[row]
        self.snaps.append((row, dict(_lib.LAUNCHES)))
        return i


_REC = _Record()
_STREAMS = {}               # raw cudaStream_t: its torch.cuda.Stream


_OFF = contextlib.nullcontext()     # every span with no session active


def _stream(device: torch.device):
    """The current stream of ``device``: a ``torch.cuda.current_stream``
    call builds a new object, microseconds of host under the profiler, so
    each is built once (torch's streams outlive the process's use)."""
    raw = torch._C._cuda_getCurrentRawStream(device.index)
    s = _STREAMS.get(raw)
    if s is None:
        s = _STREAMS[raw] = torch.cuda.current_stream(device)
    return s


def _cuda_device(on):
    """The CUDA device of ``on`` (a tensor or a device), None for any
    other."""
    if on is None:
        return None
    dev = on.device if isinstance(on, torch.Tensor) else torch.device(on)
    if dev.type != "cuda":
        return None
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class _On:
    """A span being recorded (see :func:`span`)."""

    __slots__ = ("name", "device", "index", "snap")

    def __init__(self, name: str, on):
        self.name, self.device = name, _cuda_device(on)

    def __enter__(self):
        rec = _REC
        parent = rec.open[-1] if rec.open else None
        s = Span(self.name, _now(), parent=parent)
        stream = None if self.device is None else _stream(self.device)
        if self.name in CALLS:
            rec.calls += 1
            s.call = rec.calls
            self.snap = rec.snapshot(self.device, stream)
        elif parent is not None:
            s.call = rec.spans[parent].call
        self.index = len(rec.spans)
        rec.spans.append(s)
        rec.open.append(self.index)
        if stream is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            rec.events[self.index] = (self.device, start, None)
        return s

    def __exit__(self, *exc):
        rec = _REC
        s = rec.spans[self.index]
        stream = None if self.device is None else _stream(self.device)
        if stream is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(stream)
            rec.events[self.index] = rec.events[self.index][:2] + (end,)
        if self.name in CALLS:
            rec.call_snaps[self.index] = (self.snap,
                                          rec.snapshot(self.device, stream))
        rec.open.pop()
        s.end_ns = _now()
        return False


def span(name: str, on=None):
    """A context manager that records the span ``name`` while a profiler
    session is active (a shared no-op otherwise). ``on``: a tensor or a
    device; on a CUDA device the span also takes the device time between
    CUDA events put on that device's current stream at its start and end,
    and a call (:data:`CALLS`) the card's counts at both."""
    if not _torch_profiler._is_profiler_enabled:
        _REC.stale = True
        return _OFF
    if _REC.stale:
        _REC.reset()
    return _On(name, on)


def spanned(name: str):
    """Decorate a method of an object with a ``device`` so that each call
    runs inside ``span(name, on=self.device)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def method(self, *args, **kwargs):
            with span(name, on=self.device):
                return fn(self, *args, **kwargs)

        return method

    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the host count ``name`` of the record (while a profiler
    session is active; nothing otherwise)."""
    if _torch_profiler._is_profiler_enabled:
        if _REC.stale:
            _REC.reset()
        _REC.counts[name] += n


def _settle() -> None:
    """Wait for the record's CUDA events and counter copies. Read with no
    session active, the record is the last session's: the next session
    starts one afresh."""
    if not _torch_profiler._is_profiler_enabled:
        _REC.stale = True
    devices = {ev[0] for ev in _REC.events.values()}
    if any(row is not None for row, _ in _REC.snaps):
        devices.add(None)
    for dev in devices:
        torch.cuda.synchronize(dev)


def _delta(first, last) -> dict:
    """The counts between two snapshots, by name: the card's
    (``_lib.SNAPSHOT_COUNTS``), then ``launches.<kernel>`` from the
    host."""
    out = {}
    if first[0] is not None and last[0] is not None:
        out = dict(zip(_lib.SNAPSHOT_COUNTS, (last[0] - first[0]).tolist()))
    for k, v in last[1].items():
        out[f"launches.{k}"] = v - first[1].get(k, 0)
    return out


def spans() -> list:
    """The record's spans in the order they began (``end_ns`` None where
    one is still open), their device times and their calls' counts filled
    in (waits for the card)."""
    _settle()
    out = []
    for i, s in enumerate(_REC.spans):
        ev = _REC.events.get(i)
        device_ms = None if ev is None or ev[2] is None \
            else ev[1].elapsed_time(ev[2])
        snaps = _REC.call_snaps.get(i)
        counts = None if snaps is None else _delta(
            _REC.snaps[snaps[0]], _REC.snaps[snaps[1]])
        out.append(dataclasses.replace(s, device_ms=device_ms,
                                       counts=counts))
    return out


def counters() -> dict:
    """The counts over the record: each of the card's and the host's
    launch counts, its last snapshot less its first (nothing where no
    call was recorded), and the graph captures and replays by cache
    (``graph.<cache>.captures``, ``graph.<cache>.replays``)."""
    _settle()
    out = {}
    if len(_REC.snaps) >= 2:
        out = _delta(_REC.snaps[0], _REC.snaps[-1])
    out.update(_REC.counts)
    return out


def _chrome_events(base_ns: int) -> list:
    """The record as Chrome trace events on a trace whose timestamps are
    microseconds from ``base_ns``."""
    pid = "program spans"
    evs = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": "onmf_ontf_ndl_tpu_torch spans"}}]
    end = base_ns
    for s in spans():
        if s.end_ns is None:
            continue
        args = {"call": s.call}
        if s.device_ms is not None:
            args["device_ms"] = s.device_ms
        args.update(s.counts or {})
        evs.append({"ph": "X", "cat": "program", "name": s.name, "pid": pid,
                    "tid": 0, "ts": (s.start_ns - base_ns) / 1e3,
                    "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
        end = max(end, s.end_ns)
    evs.append({"ph": "i", "s": "p", "cat": "program",
                "name": "program.counters", "pid": pid, "tid": 0,
                "ts": (end - base_ns) / 1e3, "args": counters()})
    return evs


# ------------------------------------------------------------ throughput
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
